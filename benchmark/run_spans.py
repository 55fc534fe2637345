"""Run one training cell as ``benchmark/run.py`` does, with the program's
own spans (``bert4rec_tpu_torch.utils.profiling.record_spans``) recorded
in each measured window, and print the same result line. Under
``--trace 1`` it also holds the per-layer metrics that read those spans
(``METRICS``, readers in ``metrics/``), and each idle gap of ``breakdown``
carries the innermost program span the main thread was in.

    python3 benchmark/run_spans.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

``run.py`` with the same flags is the run without recording, the other
side of recording's cost. Standard error gets one ``program spans:`` line
per window: the mean ``trainer.step`` against the benchmark's
``bench.train_step``, the share of the step its children cover (and where
the rest falls) and, in the traced window, the device seconds by launching
span (``launch_spans.py``) against the trace's total.

``drivers/train.py`` records none of the program's spans: changing it
changes what every cell already measures, a change to the benchmark of
its own. Until then this tool replaces three of the benchmark's functions
(``SEAMS``) by wrappers that call them, for the length of one run.
``seam_faults()`` names each that no longer has the parameters the
wrappers pass on, and the tool refuses to run then. Once
``drivers/train.py`` records the spans itself and BENCHMARK.json lists
``METRICS``, this file goes.
"""

import time

T_START = time.perf_counter()

import contextlib  # noqa: E402
import importlib  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

run.T_START = T_START

METRICS = {"step_sync_ms.train": "ms", "model_dispatch_ms.train": "ms",
           "optimizer_dispatch_ms.train": "ms",
           "pipeline_wait_ms.train": "ms", "optimizer_device_ms.train": "ms"}

# (module, function, its parameters): what the wrappers replace and call
SEAMS = (
    ("benchmark.drivers.train", "_window",
     ("trainer", "callbacks", "feed", "spans", "seconds", "batch_size",
      "seed", "traced", "cuda")),
    ("benchmark.harness", "reduce_trace",
     ("prof", "spans", "w0", "w1", "main", "default")),
    ("benchmark.harness", "per_layer", ("workload", "end_to_end", "obs")),
)


def seam_faults() -> list:
    """Each seam of ``SEAMS`` the benchmark lacks or has with other
    parameters."""
    out = []
    for module, name, params in SEAMS:
        fn = getattr(importlib.import_module(module), name, None)
        got = (tuple(inspect.signature(fn).parameters) if callable(fn)
               else None)
        if got != params:
            out.append(f"{module}.{name}: {got} is not {params}")
    return out


def report(label: str, log: list, out, device, threads) -> str:
    from benchmark import program_spans
    steps = program_spans.steps(log)
    line = {"window": label, "steps": len(steps),
            "step_ms": program_spans.per_step_ms(log, ("trainer.step",),
                                                 within=None),
            "bench_step_ms": out.spans.mean_ms("bench.train_step"),
            "children_cover": program_spans.coverage(log),
            "uncovered_ms": program_spans.uncovered_ms(log)}
    if device is not None:
        line["device_s_by_span"] = device
        line["device_s_attributed"] = sum(device.values())
        line["device_s_in_trace"] = sum(s for _, s in out.trace.kernels)
        line["launching_threads"] = threads
    return "program spans: " + json.dumps(line)


@contextlib.contextmanager
def _replaced(wrappers: dict):
    """``wrappers`` ({function name: wrapper}) in place of the ``SEAMS``
    of those names while the block runs."""
    saved = []
    try:
        for module, name, _ in SEAMS:
            owner = importlib.import_module(module)
            saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, wrappers[name])
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def main(argv=None, require_cuda: bool = True, adjust=None) -> int:
    faults = seam_faults()
    if faults:
        return run.fail("run_spans no longer fits the benchmark: "
                        + "; ".join(faults))
    from bert4rec_tpu_torch.utils import profiling

    from benchmark import harness, launch_spans
    original = {name: getattr(importlib.import_module(module), name)
                for module, name, _ in SEAMS}
    windows = []

    def window(*args, **kwargs):
        w = types.SimpleNamespace(log=None, device=None, threads=None)
        windows.append(w)
        with profiling.record_spans() as w.log:
            out = original["_window"](*args, **kwargs)
        label = "traced" if out.trace is not None else "untraced"
        print(report(label, w.log, out, w.device, w.threads),
              file=sys.stderr)
        return out

    def reduce_trace(prof, spans, w0, w1, main, default):
        w = windows[-1]
        merged = spans.copy()
        merged.intervals += [(s.start_ns, s.end_ns, s.name, s.thread)
                             for s in w.log]
        ops, launches = launch_spans.events(prof)
        w.device = launch_spans.attribute(ops, launches, w.log, main, w0,
                                          w1)
        w.threads = len({thread for _, thread in launches.values()})
        return original["reduce_trace"](prof, merged, w0, w1, main, default)

    def per_layer(workload, end_to_end, obs):
        out = original["per_layer"](workload, end_to_end, obs)
        obs.program, obs.program_traced = windows[0].log, windows[-1].log
        obs.device_by_span = windows[-1].device
        for name, unit in METRICS.items():
            value = harness.reader(name)(obs)
            if value is not None:
                out[name] = {"value": value, "unit": unit}
        return out

    with _replaced({"_window": window, "reduce_trace": reduce_trace,
                    "per_layer": per_layer}):
        return run.main(argv, require_cuda, adjust)


if __name__ == "__main__":
    sys.exit(main())
