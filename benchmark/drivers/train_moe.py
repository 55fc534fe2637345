"""Training cells of the ``mla_moe`` block: ``BERT4RecTrainer.train()`` of
a ``SASRecModel`` on the traffic's task (``next_item``) over a synthetic
corpus.

Set-up makes the corpus and the weights from the seed (the routers'
selection bias from it too), builds one trainer and drives it through its
first steps by ``train()`` itself: steps 1-3 are checked (their batches,
losses, each MoE layer's expert selection, the optimizer's first moment
after step 1 and the parameters' change after step 3 are kept), two more
warm the shapes. Then the untraced window, and with ``--trace 1`` a traced
window of the same length that records the program's spans
(``utils.profiling.record_spans``) under the CUDA profiler and labels each
device operation by the span that launched it (``launch_spans``). Then the
program is freed; the batches are judged against the corpus
(``reference/judge_next.py``) and the reference (``reference/mla_moe.py``)
follows steps 1-3 in row blocks, judging every expert the program selected
and then following the program's selection.
"""

import gc
import importlib
import sys
import threading
import time
import types
from collections import Counter

import torch

from benchmark import harness, launch_spans, roofline_mla_moe, traffic_gen
from benchmark.drivers.train import Feed, StopAtDeadline
from benchmark.reference import check, judge, judge_next
from benchmark.reference import mla_moe as reference

CHECK_STEPS = 3     # steps the reference follows
WARM_STEPS = 2      # more set-up steps, so nothing is first in the window


def _program():
    """The program's modules this driver reads or wraps."""
    ops = "bert4rec_tpu_torch.ops."
    return types.SimpleNamespace(
        fa=importlib.import_module(ops + "flash_attention"),
        eg=importlib.import_module(ops + "expert_gemm"),
        moe=importlib.import_module(
            "bert4rec_tpu_torch.models.components.mla_moe"))


def _counters(prog) -> dict:
    fa, em = prog.fa.flash_attention, prog.eg.expert_mlp
    out = {"flash_fwd": fa.launches + fa.causal_launches,
           "flash_bwd": fa.backward_launches + fa.causal_backward_launches,
           "expert_fwd": em.launches, "expert_bwd": em.backward_launches}
    out.update(prog.moe.routing_counts.read())
    return out


def _delta(before: dict, after: dict) -> dict:
    out = {k: after[k] - before[k] for k in after}
    out["max_expert_rows"] = after["max_expert_rows"]
    return out


def route_problems(cfg: dict, counts: dict, steps: int, cuda: bool) -> list:
    """Where the program did not run the paths the configuration states:
    K11 once a MoE layer a step each way, flash attention once a layer a
    step each way, and no row dropped."""
    out = []
    if counts["dropped_rows"]:
        out.append(f"{counts['dropped_rows']} routed rows were dropped")
    if not cuda:
        return out
    moe = cfg["num_layers"] - min(cfg["first_k_dense_replace"],
                                  cfg["num_layers"])
    for key, want in (("expert_fwd", moe), ("expert_bwd", moe),
                      ("flash_fwd", cfg["num_layers"]),
                      ("flash_bwd", cfg["num_layers"])):
        if counts[key] != want * steps:
            out.append(f"{key} ran {counts[key]} times, not "
                       f"{want * steps}")
    return out


class Recorder:
    """Wraps the trainer's ``train_step``: a span per call; during set-up
    it also keeps what the comparison reads, the routers' selections
    among it (by wrapping the program's ``route``)."""

    def __init__(self, trainer, spans, init, b1, prog, shape):
        self.trainer, self.init, self.b1 = trainer, init, b1
        self.timed = spans.timed("bench.train_step", trainer.train_step)
        self.recording, self.collecting = True, False
        self.batches, self.losses, self.selections = [], [], []
        self.grad = self.change = None
        self.prog, self.shape, self._route = prog, shape, prog.moe.route
        prog.moe.route = self._recorded_route

    def _recorded_route(self, *args, **kwargs):
        out = self._route(*args, **kwargs)
        if self.collecting:
            self.selections[-1].append(
                out[0].detach().to("cpu", torch.int16).view(*self.shape,
                                                             -1))
        return out

    def stop(self) -> None:
        self.recording = False
        self.prog.moe.route = self._route

    def __call__(self, batch):
        if not self.recording:
            return self.timed(batch)
        n = len(self.losses)
        if n < CHECK_STEPS:
            self.batches.append({k: v.detach().cpu().clone()
                                 for k, v in batch.items()})
            self.selections.append([])
        self.collecting = n < CHECK_STEPS
        try:
            logs = self.timed(batch)
        finally:
            self.collecting = False
        self.losses.append(float(logs["loss"]))
        state = self.trainer.state
        if n == 0:
            mu = check.flatten(state["opt_state"]["mu"])
            self.grad = {k: float(v.norm()) / (1.0 - self.b1)
                         for k, v in mu.items()}
        if n == CHECK_STEPS - 1:
            params = check.flatten(state["params"])
            self.change = {k: float((params[k].detach().cpu()
                                     - self.init[k]).norm())
                           for k in params}
        return logs


def run(ctx) -> dict:
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset)
    from bert4rec_tpu_torch.models import BERT4RecConfig, SASRecModel
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers

    conf, traffic, device = ctx.config, ctx.traffic, ctx.device
    cfg = dict(conf["model"], router_bias_seed=ctx.seed)
    opt, train = conf["optimizer"], conf["training"]
    batch_size = int(train["batch_size"])
    cuda = device.type == "cuda"
    prog = _program()
    phases = harness.Phases(ctx.t_start)
    phases.mark("imports")
    seqs = traffic_gen.corpus(traffic, ctx.seed, device)
    phases.mark("corpus")
    masking = dict(max_seq_len=cfg["max_sequence_length"],
                   max_predictions_per_seq=cfg["max_predictions_per_seq"],
                   mask_token_id=1, pad_token_id=0, unk_token_id=2)
    dataset = ProcessedDataset(seqs, MaskingConfig(**masking),
                               lambda: cfg["vocab_size"],
                               task=traffic["task"])
    policy = (DTypePolicy.bf16() if conf["compute_dtype"] == "bfloat16"
              else DTypePolicy.f32())
    trainer = BERT4RecTrainer(SASRecModel(
        config=BERT4RecConfig.from_dict(cfg), dtype_policy=policy))
    init = reference.make_weights(cfg, ctx.seed, device)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=opt["lr"], num_train_steps=opt["train_steps"],
            num_warmup_steps=opt["warmup"],
            weight_decay_rate=opt["weight_decay"], beta_1=opt["b1"],
            beta_2=opt["b2"], epsilon=opt["eps"],
            exclude_from_weight_decay=opt["exclude"],
            global_clipnorm=opt["clip"]),
        params=check.unflatten(init), seed=ctx.seed, device=device)
    init = {k: v.cpu() for k, v in init.items()}

    phases.mark("dataset, trainer and weights")
    spans = harness.Spans()
    recorder = Recorder(trainer, spans, init, opt["b1"], prog,
                        (batch_size, cfg["max_sequence_length"]))
    trainer.train_step = recorder
    before = _counters(prog)
    try:
        trainer.train(Feed(dataset, spans), epochs=1, batch_size=batch_size,
                      steps_per_epoch=CHECK_STEPS + WARM_STEPS,
                      seed=ctx.seed, verbose=False)
    finally:
        recorder.stop()
    problems = route_problems(cfg, _delta(before, _counters(prog)),
                              CHECK_STEPS + WARM_STEPS, cuda)
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
                       ctx.seconds, batch_size, seed, traced and cuda, cuda,
                       prog)
    host = run_window(False, ctx.seed + 1)
    problems += route_problems(cfg, host.counts, host.steps, cuda)
    memory = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {"train_examples_per_s": {
        "value": host.steps * batch_size / host.window_s,
        "unit": "examples/s"},
        "setup_s": {"value": setup_s, "unit": "s"}}
    extra, traced = {"routing": host.counts}, None
    if ctx.trace:
        traced = run_window(True, ctx.seed + 2)
        problems += route_problems(cfg, traced.counts, traced.steps, cuda)
        obs = types.SimpleNamespace(
            spans=host.spans, steps=host.steps, window_s=host.window_s,
            counts=traced.counts,
            trace=traced.trace, cuda=cuda, batch=batch_size, model=cfg,
            dtype=conf["compute_dtype"], roofline=roofline_mla_moe,
            program_traced=traced.log, device_by_span=traced.device,
            traced_steps=traced.steps)
        metrics = harness.per_layer(ctx.workload, {"train_examples_per_s"},
                                    obs)
        if traced.trace is not None:
            extra["breakdown"] = harness.breakdown(traced.trace)
            extra["device_s_by_span"] = traced.device
            extra["other_threads"] = traced.other
            extra["trace"] = traced.trace
    batches, selections = recorder.batches, recorder.selections
    del trainer, recorder, traced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, correct = _reference(conf, cfg, program, batches, selections,
                                 seqs, init, device, masking, problems)
    return {"correct": correct, "attempted": host.steps, "failed": 0,
            "metrics": metrics, "memory": memory, "checks": checks,
            "extra": extra}


def _window(trainer, callbacks, feed, spans, seconds, batch_size, seed,
            traced, cuda, prog):
    """One measured window: ``train()`` over whole epochs from ``seed``
    until ``seconds`` have passed, ended by the last
    ``torch.cuda.synchronize()``. When ``traced``: under the CUDA profiler
    with the program's spans recorded, each device operation labelled by
    the span that launched it. Its steps, seconds, counts, host spans (a
    copy), trace, span log and device seconds by span."""
    from bert4rec_tpu_torch.utils import profiling
    spans.clear()
    prog.moe.routing_counts.reset()
    before = _counters(prog)
    profiler = log = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        profiler = profile(activities=[ProfilerActivity.CUDA])
        profiler.__enter__()
    pauses = harness.GcPauses()
    recording = profiling.record_spans() if traced else None
    if recording is not None:
        log = recording.__enter__()
    t0, w0 = time.perf_counter(), time.time_ns()
    feed.deadline = t0 + seconds
    trainer.callbacks = callbacks + [StopAtDeadline(feed.deadline)]
    try:
        trainer.train(feed, epochs=10 ** 6, batch_size=batch_size,
                      seed=seed, verbose=False)
        if cuda:
            torch.cuda.synchronize()
        window_s, w1 = time.perf_counter() - t0, time.time_ns()
    finally:
        if recording is not None:
            recording.__exit__(None, None, None)
        pauses.stop()
        if profiler is not None:
            profiler.__exit__(None, None, None)
        trainer.callbacks = callbacks
        feed.deadline = None
    steps = len(spans.durations["bench.train_step"])
    print(harness.window_report("traced" if traced else "untraced", spans,
                                "bench.train_step", w0, w1, pauses),
          file=sys.stderr)
    trace = device = other = None
    if profiler is not None:
        main = threading.get_ident()
        merged = spans.copy()
        merged.intervals += [(s.start_ns, s.end_ns, s.name, s.thread)
                             for s in log]
        ops, launches = launch_spans.events(profiler)
        device = launch_spans.attribute(ops, launches, log, main, w0, w1)
        other = other_threads(ops, launches, log, main, w0, w1)
        trace = harness.reduce_trace(profiler, merged, w0, w1, main,
                                     "train() outside train_step")
    return types.SimpleNamespace(
        steps=steps, window_s=window_s,
        counts=_delta(before, _counters(prog)), spans=spans.copy(),
        trace=trace, log=log, device=device, other=other)


def other_threads(ops, launches, log, main, w0, w1, top=6) -> dict:
    """What ``launch_spans.attribute`` files under its "other threads":
    the acting threads it found, and the device seconds of the other
    threads' operations by launching thread and by operation (the
    costliest ``top``)."""
    acting = launch_spans.acting_threads(
        launches, launch_spans._Innermost(log, main))
    by_thread, by_op = Counter(), Counter()
    for s, e, name, corr in ops:
        if e <= w0 or s >= w1 or name.startswith("Memcpy HtoD") \
                or corr not in launches or launches[corr][1] in acting:
            continue
        seconds = (min(e, w1) - max(s, w0)) / 1e9
        by_thread[str(launches[corr][1])] += seconds
        by_op[name[:100]] += seconds
    return {"acting": sorted(str(t) for t in acting),
            "by_thread": dict(by_thread.most_common(top)),
            "by_op": dict(by_op.most_common(top))}


def _reference(conf, cfg, program, batches, selections, seqs, init, device,
               masking, problems) -> tuple:
    """Judge the recorded batches, follow them with the reference and hold
    each number to its limit; ``(checks, correct)``."""
    corpus = judge.Corpus(seqs, device)
    users = []
    for batch in batches:
        found, rows = judge_next.judge_batch(
            corpus, {k: v.numpy() for k, v in batch.items()}, masking)
        problems = problems + found
        users += rows
    if len(set(users)) != len(users):
        problems.append("the checked steps' rows repeat a user")
    del corpus
    ref = reference.follow(init, batches, selections, cfg,
                           conf["optimizer"], device,
                           block_rows=conf["training"].get(
                               "reference_block_rows"))
    print(f"routing judge (units past which selections fell below the "
          f"k-th best; epsilon {reference.EPS_UNITS}): {ref['judge']}",
          file=sys.stderr)
    if ref["unsound"]:
        problems.append(f"the routing judge rejected {ref['unsound']} of "
                        f"the program's expert selections")
    numbers = check.compare(program, ref)
    limits = conf["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    checks["unsound"] = {"value": len(problems), "limit": 0}
    for line in problems[:20]:
        print(f"unsound: {line}", file=sys.stderr)
    correct = not problems and all(v <= limits[k] for k, v in numbers.items())
    return checks, correct
