"""Training cells: ``BERT4RecTrainer.train()`` over a synthetic corpus.

Set-up makes the corpus and the weights from the seed, builds one trainer
and drives it through its first steps by ``train()`` itself (the window's
own call and feed), recording what the comparison needs: the batches of
steps 1-3, each step's loss, the optimizer's first moment after step 1
and the parameters' change after step 3. The same trainer then trains
for the window: ``train()`` over whole epochs of fresh masks until the
deadline, ended by the last ``torch.cuda.synchronize()``. With
``--trace 1`` a second window of the same length follows under the CUDA
profiler: the host's metrics come from the first, the device's from the
second. Then the program is freed and the reference follows steps 1-3.
The window's own steps are not compared (PERF.md §2).
"""

import gc
import importlib
import sys
import threading
import time
import types

import torch

from benchmark import harness, roofline, traffic_gen, weights
from benchmark.reference import check, judge

CHECK_STEPS = 3     # steps the reference follows
WARM_STEPS = 2      # more set-up steps, so nothing is first in the window


class Feed:
    """The dataset as ``train()`` sees it, each masked batch a span; past
    the deadline an epoch yields nothing more."""

    def __init__(self, dataset, spans, deadline=None):
        self.dataset, self.spans, self.deadline = dataset, spans, deadline

    def batches(self, *args, **kwargs):
        for batch in self.spans.iterate("bench.pipeline",
                                        self.dataset.batches(*args,
                                                             **kwargs)):
            if self.deadline is not None \
                    and time.perf_counter() >= self.deadline:
                return
            yield batch


class StopAtDeadline:
    """A ``train()`` callback that ends the loop after the deadline."""

    def __init__(self, deadline):
        self.deadline, self.stop_training = deadline, False

    def on_train_begin(self, trainer):
        pass

    def on_epoch_end(self, trainer, epoch, logs):
        self.stop_training = time.perf_counter() >= self.deadline

    def on_train_end(self, trainer):
        pass


class Recorder:
    """Wraps the trainer's ``train_step``: a span per call; during set-up
    it also keeps what the comparison reads."""

    def __init__(self, trainer, spans, init, b1):
        self.trainer, self.init, self.b1 = trainer, init, b1
        self.timed = spans.timed("bench.train_step", trainer.train_step)
        self.recording = True
        self.batches, self.losses = [], []
        self.grad = self.change = None

    def __call__(self, batch):
        if not self.recording:
            return self.timed(batch)
        n = len(self.losses)
        if n < CHECK_STEPS:
            self.batches.append({k: v.detach().cpu().clone()
                                 for k, v in batch.items()})
        logs = self.timed(batch)
        self.losses.append(float(logs["loss"]))
        state = self.trainer.state
        if n == 0:
            mu = check.flatten(state["opt_state"]["mu"])
            self.grad = {k: float(v.norm()) / (1.0 - self.b1)
                         for k, v in mu.items()}
        if n == CHECK_STEPS - 1:
            params = check.flatten(state["params"])
            self.change = {k: float((params[k].detach() - self.init[k])
                                    .norm()) for k in params}
        return logs


def _counters():
    ops = "bert4rec_tpu_torch.ops."
    fa = importlib.import_module(ops + "flash_attention")
    fel = importlib.import_module(ops + "fused_encoder_layer")
    fml = importlib.import_module(ops + "fused_mlm_loss")
    return {
        "layer_fwd": fel.fused_encoder_layer.launches,
        "layer_bwd": fel.fused_encoder_layer.backward_launches,
        "loss_tiled_fwd": fml.fused_mlm_loss_tiled.launches,
        "loss_merged_bwd": fml.fused_mlm_loss_tiled.merged_launches,
        "loss_two_sweep_bwd": fml.fused_mlm_loss_tiled.two_sweep_launches,
        "loss_fwd": fml.fused_mlm_loss.launches,
        "flash_fwd": fa.flash_attention.launches,
        "flash_bwd": fa.flash_attention.backward_launches,
    }


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def route_problems(cfg: dict, counts: dict, steps: int, cuda: bool) -> list:
    """Where the program did not run the paths the configuration states."""
    if not cuda:
        return []
    out = []
    layers = cfg["num_layers"] * steps
    if cfg.get("use_fused_layer") and counts["layer_bwd"] != layers:
        out.append(f"fused layer backward ran {counts['layer_bwd']} "
                   f"times, not {layers}")
    if cfg.get("use_flash_attention") and not cfg.get("use_fused_layer") \
            and counts["flash_bwd"] != layers:
        out.append(f"flash attention backward ran {counts['flash_bwd']} "
                   f"times, not {layers}")
    if cfg.get("use_fused_loss") and counts["loss_tiled_fwd"] \
            + counts["loss_fwd"] != steps:
        out.append("the fused loss did not run once a step")
    return out


def run(ctx) -> dict:
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset)
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers

    conf, traffic, device = ctx.config, ctx.traffic, ctx.device
    cfg, opt, train = conf["model"], conf["optimizer"], conf["training"]
    batch_size = int(train["batch_size"])
    cuda = device.type == "cuda"
    phases = harness.Phases(ctx.t_start)
    phases.mark("imports")
    seqs = traffic_gen.corpus(traffic, ctx.seed, device)
    phases.mark("corpus")
    masking = dict(max_seq_len=cfg["max_sequence_length"],
                   max_predictions_per_seq=cfg["max_predictions_per_seq"],
                   mask_token_id=1, pad_token_id=0, unk_token_id=2,
                   masked_lm_rate=train["masked_lm_rate"],
                   mask_token_rate=train["mask_token_rate"],
                   random_token_rate=train["random_token_rate"])
    dataset = ProcessedDataset(seqs, MaskingConfig(**masking),
                               lambda: cfg["vocab_size"])
    policy = (DTypePolicy.bf16() if conf["compute_dtype"] == "bfloat16"
              else DTypePolicy.f32())
    trainer = BERT4RecTrainer(BERT4RecModel(
        config=BERT4RecConfig.from_dict(cfg), dtype_policy=policy))
    init = weights.make(cfg, ctx.seed, device)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=opt["lr"], num_train_steps=opt["train_steps"],
            num_warmup_steps=opt["warmup"],
            weight_decay_rate=opt["weight_decay"], beta_1=opt["b1"],
            beta_2=opt["b2"], epsilon=opt["eps"],
            exclude_from_weight_decay=opt["exclude"],
            global_clipnorm=opt["clip"]),
        params=check.unflatten(init), seed=ctx.seed, device=device)

    phases.mark("dataset, trainer and weights")
    spans = harness.Spans()
    recorder = Recorder(trainer, spans, init, opt["b1"])
    trainer.train_step = recorder
    before = _counters()
    trainer.train(Feed(dataset, spans), epochs=1, batch_size=batch_size,
                  steps_per_epoch=CHECK_STEPS + WARM_STEPS,
                  seed=ctx.seed, verbose=False)
    problems = route_problems(cfg, _delta(before, _counters()),
                              CHECK_STEPS + WARM_STEPS, cuda)
    recorder.recording = False
    init_host = {k: v.cpu() for k, v in init.items()}
    del init
    program = {"losses": recorder.losses[:CHECK_STEPS],
               "grad": recorder.grad, "change": recorder.change}

    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    phases.mark("set-up steps")
    print(phases.text(), file=sys.stderr)
    base = list(trainer.callbacks)

    def run_window(traced, seed):
        return _window(trainer, base, Feed(dataset, spans), spans,
                       ctx.seconds, batch_size, seed, traced and cuda, cuda)
    host = run_window(False, ctx.seed + 1)
    problems += route_problems(cfg, host.counts, host.steps, cuda)
    memory = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {"train_examples_per_s": {
        "value": host.steps * batch_size / host.window_s,
        "unit": "examples/s"},
        "setup_s": {"value": setup_s, "unit": "s"}}
    extra, traced = {}, None
    if ctx.trace:
        # the host's numbers from the untraced window; the device's from a
        # second window of the same length under the profiler
        traced = run_window(True, ctx.seed + 2)
        problems += route_problems(cfg, traced.counts, traced.steps, cuda)
        obs = types.SimpleNamespace(
            spans=host.spans, steps=host.steps, window_s=host.window_s,
            counts=traced.counts, trace=traced.trace, cuda=cuda,
            batch=batch_size, model=cfg, dtype=conf["compute_dtype"],
            roofline=roofline)
        metrics = harness.per_layer(ctx.workload, {"train_examples_per_s"},
                                    obs)
        if traced.trace is not None:
            extra["breakdown"] = harness.breakdown(traced.trace)
            extra["trace"] = traced.trace
    batches = recorder.batches
    del trainer, recorder, traced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, correct = _reference(conf, program, batches, seqs, init_host,
                                 device, masking, ctx.seed, problems)
    return {"correct": correct, "attempted": host.steps, "failed": 0,
            "metrics": metrics, "memory": memory, "checks": checks,
            "extra": extra}


def _window(trainer, callbacks, feed, spans, seconds, batch_size, seed,
            traced, cuda):
    """One measured window: ``train()`` over whole epochs of fresh masks
    from ``seed`` until ``seconds`` have passed, ended by the last
    ``torch.cuda.synchronize()``; under the CUDA profiler when ``traced``.
    Its steps, seconds, launch counts, host spans (a copy) and trace."""
    spans.clear()
    before = _counters()
    profiler = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        profiler = profile(activities=[ProfilerActivity.CUDA])
        profiler.__enter__()
    pauses = harness.GcPauses()
    t0, w0 = time.perf_counter(), time.time_ns()
    feed.deadline = t0 + seconds
    trainer.callbacks = callbacks + [StopAtDeadline(feed.deadline)]
    trainer.train(feed, epochs=10 ** 6, batch_size=batch_size, seed=seed,
                  verbose=False)
    if cuda:
        torch.cuda.synchronize()
    window_s, w1 = time.perf_counter() - t0, time.time_ns()
    pauses.stop()
    if profiler is not None:
        profiler.__exit__(None, None, None)
    trainer.callbacks = callbacks
    feed.deadline = None
    steps = len(spans.durations["bench.train_step"])
    print(harness.window_report("traced" if traced else "untraced", spans,
                                "bench.train_step", w0, w1, pauses),
          file=sys.stderr)
    trace = (harness.reduce_trace(profiler, spans, w0, w1,
                                  threading.get_ident(),
                                  "train() outside train_step")
             if profiler is not None else None)
    return types.SimpleNamespace(
        steps=steps, window_s=window_s, counts=_delta(before, _counters()),
        spans=spans.copy(), trace=trace)


def _reference(conf, program, batches, seqs, init, device, masking, seed,
               problems) -> tuple:
    """Judge the recorded batches, follow them with the reference and hold
    each number to its limit; ``(checks, correct)``."""
    corpus = judge.Corpus(seqs, device)
    users = []
    for batch in batches:
        found, rows = judge.judge_batch(
            corpus, {k: v.numpy() for k, v in batch.items()}, masking)
        problems = problems + found
        users += rows
    if len(set(users)) != len(users):
        problems.append("the checked steps' rows repeat a user")
    del corpus
    ref = check.follow(init, batches, conf["model"], conf["optimizer"],
                       seed, device)
    numbers = check.compare(program, ref)
    limits = conf["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    checks["unsound"] = {"value": len(problems), "limit": 0}
    for line in problems[:20]:
        print(f"unsound: {line}", file=sys.stderr)
    correct = not problems and all(v <= limits[k] for k, v in numbers.items())
    return checks, correct
