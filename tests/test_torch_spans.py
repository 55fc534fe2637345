"""The program's spans (``utils.profiling.span`` / ``record_spans``): off,
``span`` is one shared no-op and ``train()`` records nothing; on, a train
step is ``trainer.step`` over its forward, backward, optimizer and sync,
``train()`` adds a ``pipeline.wait`` per batch and a ``trainer.epoch_end``
per epoch, threads nest apart, ``trace`` writes the spans into its Chrome
trace and a span closed after recording stops is dropped. The tool that
reads the spans in the benchmark's runs (``benchmark/run_spans.py``)
still fits the benchmark functions it wraps.

Imports neither JAX nor ``bert4rec_tpu``; the ``cuda`` test (every
synchronising call of a step on the card is a ``trainer.sync`` span) runs
on a card with

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import json
import pathlib
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from bert4rec_tpu_torch.core.dtypes import DTypePolicy
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    MaskingConfig, ProcessedDataset)
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.trainers import BERT4RecTrainer
from bert4rec_tpu_torch.utils import profiling

V, SEQ, PRED, BATCH = 40, 16, 4, 8
STEP_PARTS = ["trainer.forward", "trainer.backward", "trainer.optimizer",
              "trainer.sync"]


def config(**over) -> dict:
    kw = dict(vocab_size=V, hidden_size=32, num_layers=2,
              num_attention_heads=4, inner_dim=64, max_sequence_length=SEQ,
              max_predictions_per_seq=PRED, attention_dropout=0.0,
              output_dropout=0.0, use_fused_layer=True, use_fused_loss=True)
    kw.update(over)
    return kw


def dataset(n: int, vocab: int = V, seq: int = SEQ, pred: int = PRED,
            seed: int = 0) -> ProcessedDataset:
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(3, vocab, size=rng.integers(4, seq + 1))
            .astype(np.int32) for _ in range(n)]
    return ProcessedDataset(seqs, MaskingConfig(
        max_seq_len=seq, max_predictions_per_seq=pred, mask_token_id=1,
        pad_token_id=0, unk_token_id=2, masked_lm_rate=0.3),
        lambda: vocab)


def trainer(device="cpu", policy=None, **kw) -> BERT4RecTrainer:
    model_kw = {k: v for k, v in kw.items() if k != "grad_accum_steps"}
    t = BERT4RecTrainer(
        BERT4RecModel(config=BERT4RecConfig(**config(**model_kw)),
                      dtype_policy=policy or DTypePolicy.f32()),
        grad_accum_steps=kw.get("grad_accum_steps", 1))
    t.initialize_model(seed=0, device=device)
    return t


def placed(t: BERT4RecTrainer, n: int, batch: int = BATCH, **data) -> list:
    raw = dataset(n * batch, **data).batches(batch, seed=1,
                                             drop_remainder=True)
    return [t._put_batch(b) for b, _ in zip(raw, range(n))]


def names(log: list) -> list:
    return [s.name for s in log]


class TestOff:

    def test_span_is_one_shared_no_op(self):
        assert profiling.span("a") is profiling.span("b")
        with profiling.span("a") as opened:
            assert opened is None
            assert profiling.open_spans() == ()

    def test_train_records_nothing(self, monkeypatch):
        def refused(*args, **kwargs):
            raise AssertionError("a span or range was made while off")
        monkeypatch.setattr(profiling, "Span", refused)
        monkeypatch.setattr(torch.profiler, "record_function", refused)
        t = trainer()
        t.train(dataset(32), epochs=2, batch_size=BATCH, verbose=False)
        assert t.state["step"] == 8

    def test_recording_alone_opens_no_profiler_range(self, monkeypatch):
        def refused(*args, **kwargs):
            raise AssertionError("record_function outside trace()")
        monkeypatch.setattr(torch.profiler, "record_function", refused)
        with profiling.record_spans() as log:
            with profiling.span("a"):
                pass
        assert names(log) == ["a"]


class TestStep:

    @pytest.mark.parametrize("accum,parts", [
        (1, STEP_PARTS),
        (2, STEP_PARTS[:2] + STEP_PARTS[3:] + STEP_PARTS[:2]
         + STEP_PARTS[3:] + STEP_PARTS[2:3]),
    ], ids=["train_step", "accum_step"])
    def test_step_and_its_parts_in_order(self, accum, parts):
        t = trainer(grad_accum_steps=accum)
        batches = placed(t, accum)
        t0 = time.time_ns()
        with profiling.record_spans() as log:
            if accum == 1:
                t.train_step(batches[0])
            else:
                t.accum_step(batches)
        t1 = time.time_ns()
        assert names(log) == parts + ["trainer.step"]
        step, children = log[-1], log[:-1]
        assert step.parent is None
        assert all(c.parent is step for c in children)
        assert t0 <= step.start_ns and step.end_ns <= t1
        bounds = [step.start_ns] + [x for c in children
                                    for x in (c.start_ns, c.end_ns)] \
            + [step.end_ns]
        assert bounds == sorted(bounds)
        assert {s.thread for s in log} == {threading.get_ident()}


class TestTrain:

    @pytest.mark.parametrize("steps_per_epoch,validate", [
        (None, False), (2, False), (None, True)],
        ids=["whole_epochs", "steps_per_epoch", "validated"])
    def test_waits_steps_and_epoch_ends(self, steps_per_epoch, validate):
        t = trainer()
        ds = dataset(5 * BATCH)
        with profiling.record_spans() as log:
            t.train(ds, val_ds=ds if validate else None, epochs=2,
                    batch_size=BATCH, steps_per_epoch=steps_per_epoch,
                    verbose=False)
        steps = steps_per_epoch or 5
        top = [s for s in log if s.parent is None]
        # a wait per batch, and one for the end of an epoch read to its end
        per_epoch = ["pipeline.wait", "trainer.step"] * steps \
            + ["pipeline.wait"] * (steps_per_epoch is None) \
            + ["trainer.epoch_end"]
        assert names(sorted(top, key=lambda s: s.start_ns)) == per_epoch * 2
        assert names(log).count("trainer.step") == 2 * steps
        ends = [s for s in log if s.name == "trainer.epoch_end"]
        inside = [s for s in log if s.parent in ends]
        if validate:   # the validation's batches and its position counts
            assert set(names(inside)) == {"pipeline.wait", "trainer.sync"}
        else:
            assert inside == []


class TestThreads:

    def test_two_threads_nest_apart(self):
        barrier, seen = threading.Barrier(2, timeout=30), {}

        def run(i):
            with profiling.span(f"outer{i}"):
                barrier.wait()
                with profiling.span(f"inner{i}"):
                    barrier.wait()
                    seen[i] = profiling.open_spans()
                    barrier.wait()

        with profiling.record_spans() as log:
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        assert seen == {0: ("outer0", "inner0"), 1: ("outer1", "inner1")}
        by = {s.name: s for s in log}
        for i in range(2):
            assert by[f"inner{i}"].parent is by[f"outer{i}"]
            assert by[f"outer{i}"].parent is None
            assert by[f"inner{i}"].thread == by[f"outer{i}"].thread
        assert by["outer0"].thread != by["outer1"].thread


def test_run_spans_fits_the_benchmark():
    # in its own process: importing the benchmark sets its cache paths
    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", "from benchmark import run_spans; "
         "print(run_spans.seam_faults())"], cwd=root, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def _trace_names(directory) -> set:
    files = list(directory.glob("trace_*.json"))
    assert len(files) == 1
    return {e.get("name") for e in
            json.loads(files[0].read_text())["traceEvents"]}


class TestTrace:

    def test_trace_holds_the_spans(self, tmp_path):
        with profiling.trace(tmp_path):
            with profiling.span("outer.a"), profiling.span("inner.b"):
                torch.ones(8, 8) @ torch.ones(8, 8)
        assert {"outer.a", "inner.b"} <= _trace_names(tmp_path)
        assert profiling.span("after") is profiling.span("again")

    def test_train_profile_dir_holds_the_step_spans(self, tmp_path):
        trainer().train(dataset(4 * BATCH), epochs=1, batch_size=BATCH,
                        verbose=False, profile_dir=str(tmp_path),
                        profile_steps=2)
        assert {"trainer.step", "pipeline.wait", *STEP_PARTS} \
            <= _trace_names(tmp_path)


class TestDropped:

    @pytest.mark.parametrize("closed", ["after", "in_a_later_recording"])
    def test_span_closed_after_recording_stops(self, closed):
        with profiling.record_spans() as log:
            late = profiling.span("late")
            late.__enter__()
            with profiling.span("early"):
                pass
        if closed == "after":
            late.__exit__(None, None, None)
        else:
            with profiling.record_spans() as later:
                late.__exit__(None, None, None)
            assert later == []
        assert names(log) == ["early"]
        assert log[0].parent is late
        assert profiling.open_spans() == ()

    def test_nested_recording_shares_the_log(self):
        with profiling.record_spans() as outer:
            with profiling.record_spans() as inner:
                with profiling.span("a"):
                    pass
            with profiling.span("b"):
                pass
        assert inner is outer and names(outer) == ["a", "b"]
        assert profiling.span("c") is profiling.span("d")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


# the benchmark cells' routes at two layers: the bf16 fused layer with the
# vocab-tiled loss (ml-20m_128), the unfused block on flash attention with
# the logits loss (bert_base_512); dropout on, as they train
ROUTES = {
    "fused_layer": dict(hidden_size=128, num_attention_heads=4,
                        inner_dim=512, seq=200, pred=40, batch=32),
    "flash_attention": dict(hidden_size=768, num_attention_heads=12,
                            inner_dim=3072, seq=512, pred=76, batch=4,
                            use_fused_layer=False, use_fused_loss=False,
                            use_flash_attention=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_sync_of_a_step_is_a_sync_span(cuda_device, route):
    """Under ``set_sync_debug_mode("warn")`` each synchronising call that
    a train step makes is reported while ``trainer.sync`` is the
    innermost open span."""
    kw = dict(ROUTES[route])
    seq, pred, batch = kw.pop("seq"), kw.pop("pred"), kw.pop("batch")
    t = trainer(cuda_device, DTypePolicy.bf16(), vocab_size=515,
                max_sequence_length=seq, max_predictions_per_seq=pred,
                attention_dropout=0.1, output_dropout=0.1, **kw)
    batches = placed(t, 3, batch, vocab=515, seq=seq, pred=pred)
    t.train_step(batches[0])          # builds and loads the kernels
    torch.cuda.synchronize()
    reported = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            reported.append(profiling.open_spans())

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.record_spans() as log:
                for b in batches[1:]:
                    t.train_step(b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert len(reported) >= 2
    assert all(spans[-1:] == ("trainer.sync",) for spans in reported), \
        reported
    assert names(log).count("trainer.sync") == 2
