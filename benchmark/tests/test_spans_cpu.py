"""CPU tests of the readings of the program's spans: a tiny traced run of
``run_spans.py`` reports the host metrics, a ``--trace 0`` run of
``run.py`` never switches the program's recording on while one of
``run_spans.py`` records its window, the benchmark functions run_spans
wraps fit and come back, the per-step arithmetic on a hand-made log, and
``launch_spans`` puts every operation of a synthetic event list into
exactly one label, by the thread that launched it."""

import contextlib
import io
import json

import pytest

from benchmark import launch_spans, program_spans, run, run_spans
from benchmark.tests import tiny

HOST = ["step_sync_ms.train", "model_dispatch_ms.train",
        "optimizer_dispatch_ms.train", "pipeline_wait_ms.train"]


def run_cell(main, workload, *extra, trace=0):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(["--workload", workload, "--seed", str(2 ** 31 + 9),
                     "--seconds", "1", "--trace", str(trace), *extra],
                    require_cuda=False, adjust=tiny.adjust)
    lines = out.getvalue().strip().splitlines()
    return code, json.loads(lines[-1]), err.getvalue()


def test_traced_tiny_run_reports_the_program_span_metrics():
    code, line, err = run_cell(run_spans.main, "bert_base_512.train",
                               trace=1)
    assert code == 0 and line["correct"] is True, err[-2000:]
    assert set(HOST) <= set(line["metrics"])
    assert all(line["metrics"][m]["unit"] == "ms" for m in HOST)
    # no device trace on the CPU: nothing to attribute
    assert "optimizer_device_ms.train" not in line["metrics"]
    reports = [json.loads(x.split(": ", 1)[1]) for x in err.splitlines()
               if x.startswith("program spans: ")]
    assert [r["steps"] for r in reports] == [line["attempted"],
                                             reports[1]["steps"]]
    host = reports[0]
    assert host["step_ms"] == pytest.approx(host["bench_step_ms"], rel=0.05)
    assert 0.5 < host["children_cover"] <= 1.0


def test_untraced_run_never_records(monkeypatch):
    from bert4rec_tpu_torch.utils import profiling

    def refused(*args, **kwargs):
        raise AssertionError("program recording switched on")
    monkeypatch.setattr(profiling, "record_spans", refused)
    monkeypatch.setattr(profiling, "Span", refused)
    code, line, err = run_cell(run.main, "ml20m_128.train")
    assert code == 0 and line["correct"] is True, err[-2000:]
    assert not set(HOST) & set(line["metrics"])


def test_untraced_run_spans_records_its_window():
    code, line, err = run_cell(run_spans.main, "ml20m_128.train")
    assert code == 0 and line["correct"] is True, err[-2000:]
    reports = [json.loads(x.split(": ", 1)[1]) for x in err.splitlines()
               if x.startswith("program spans: ")]
    assert [(r["window"], r["steps"]) for r in reports] == [
        ("untraced", line["attempted"])]
    # --trace 0 reads no per-layer metric, as run.py's line
    assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}


def test_seams_fit_and_are_restored():
    from benchmark import harness
    from benchmark.drivers import train
    assert run_spans.seam_faults() == []
    before = train._window, harness.reduce_trace, harness.per_layer
    with pytest.raises(RuntimeError):
        with run_spans._replaced({"_window": None, "reduce_trace": None,
                                  "per_layer": None}):
            assert train._window is None
            raise RuntimeError
    assert (train._window, harness.reduce_trace,
            harness.per_layer) == before


class FakeSpan:
    def __init__(self, name, start, end, parent=None, thread=1):
        self.name, self.start_ns, self.end_ns = name, start, end
        self.parent, self.thread = parent, thread


def hand_log():
    """Two steps of 100 ns: forward 10-40 (a sync 30-35 inside), backward
    40-70, optimizer 70-80, sync 80-95; waits before each step."""
    log = []
    for base in (0, 1000):
        step = FakeSpan("trainer.step", base, base + 100)
        fwd = FakeSpan("trainer.forward", base + 10, base + 40, step)
        log += [FakeSpan("trainer.sync", base + 30, base + 35, fwd), fwd,
                FakeSpan("trainer.backward", base + 40, base + 70, step),
                FakeSpan("trainer.optimizer", base + 70, base + 80, step),
                FakeSpan("trainer.sync", base + 80, base + 95, step), step,
                FakeSpan("pipeline.wait", base - 20, base)]
    # another thread's top-level wait does not count
    return log + [FakeSpan("pipeline.wait", 0, 500, thread=2)]


@pytest.mark.parametrize("names,self_time,within,ns", [
    (("trainer.sync",), False, program_spans.STEP, 20),
    (("trainer.forward", "trainer.backward"), True, program_spans.STEP,
     25 + 30),
    (("trainer.optimizer",), True, program_spans.STEP, 10),
    (("pipeline.wait",), False, None, 20),
], ids=["sync", "model_dispatch", "optimizer_dispatch", "pipeline_wait"])
def test_per_step_readings(names, self_time, within, ns):
    got = program_spans.per_step_ms(hand_log(), names, self_time, within)
    assert got == pytest.approx(ns / 1e6)


def test_coverage_and_no_steps():
    assert program_spans.coverage(hand_log()) == pytest.approx(0.85)
    assert program_spans.per_step_ms([], ("trainer.sync",)) is None
    assert program_spans.coverage([]) is None


def test_launch_spans_puts_every_operation_in_one_label():
    main = 7
    step = FakeSpan("trainer.step", 100, 900, thread=main)
    spans = [step,
             FakeSpan("trainer.backward", 200, 500, step, main),
             FakeSpan("trainer.optimizer", 500, 700, step, main),
             FakeSpan("trainer.sync", 700, 800, step, main),
             FakeSpan("trainer.optimizer", 0, 1000, thread=8)]
    # launching threads, by the profiler's ids: "m" the main thread, "a"
    # autograd's, "p" the prefetch thread
    launches = {1: (150, "m"), 2: (250, "a"), 3: (600, "m"),
                4: (750, "m"), 5: (950, "m"), 6: (260, "p"), 8: (40, "m"),
                10: (210, "a"), 11: (220, "m"), 12: (550, "p"),
                13: (560, "m"), 14: (160, "m")}
    ops = [(160, 300, "fwd_kernel", 1),          # launched in the step
           (300, 650, "bwd_kernel", 2),          # autograd's, in backward
           (650, 760, "adam_kernel", 3),         # in the optimizer
           (760, 770, "Memcpy HtoD (Pageable -> Device)", 4),
           (255, 262, "Memcpy HtoD (Pinned -> Device)", 6),
           (600, 640, "cast_kernel", 12),        # the prefetch thread's
           (960, 1100, "after_kernel", 5),       # past every span, clipped
           (20, 60, "early_kernel", 8),          # clipped at the window
           (990, 1010, "no_launch_kernel", 9),   # its launch not traced
           (1200, 1300, "outside_kernel", 2)]    # outside the window
    w0, w1 = 50, 1050
    got = launch_spans.attribute(ops, launches, spans, main, w0, w1)
    assert got == pytest.approx({
        "trainer.step": 140e-9, "trainer.backward": 350e-9,
        "trainer.optimizer": 110e-9,
        launch_spans.COPIES: 17e-9, launch_spans.OTHER_THREADS: 40e-9,
        launch_spans.UNLABELLED: (90 + 10 + 20) * 1e-9})
    total = sum(min(e, w1) - max(s, w0) for s, e, _, _ in ops
                if e > w0 and s < w1) / 1e9
    assert sum(got.values()) == pytest.approx(total, rel=1e-12)


@pytest.mark.parametrize("launches,acting", [
    ({1: (150, "m"), 2: (250, "a"), 3: (260, "p"), 4: (270, "a"),
      5: (600, "m"), 6: (610, "p")}, {"m", "a"}),
    # the main thread launches in backward too, and no other thread does
    ({1: (150, "m"), 2: (250, "m"), 3: (600, "p"), 4: (610, "m")},
     {"m"}),
    ({1: (40, "m")}, set()),                     # nothing inside a span
], ids=["autograd_thread", "main_alone", "outside_spans"])
def test_acting_threads(launches, acting):
    step = FakeSpan("trainer.step", 100, 900)
    label = launch_spans._Innermost(
        [step, FakeSpan("trainer.backward", 200, 500, step)], 1)
    assert launch_spans.acting_threads(launches, label) == acting
