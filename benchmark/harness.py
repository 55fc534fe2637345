"""What every driver shares: the manifest, the run's context, host spans,
the profiler's trace reduced to busy time, kernels and idle gaps, the
per-layer metric readers, and the result line."""

import bisect
import dataclasses
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import threading
import time
from collections import defaultdict
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "bert4rec_tpu")


def load_json(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> tuple:
    """(workload, config entry, config file, traffic file) of a cell."""
    man = manifest()
    work = next((w for w in man["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == work["config"])
    return (work, conf, load_json(ROOT / conf["file"]),
            load_json(BENCH / "traffic" / f"{work['traffic']}.json"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Phases:
    """Set-up's phases, seconds from process start, for standard error."""

    def __init__(self, t_start: float):
        self.t_start, self.marks = t_start, []

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter() - self.t_start))

    def text(self) -> str:
        return "set-up phases (s from start): " + ", ".join(
            f"{n} {t:.2f}" for n, t in self.marks)


class Spans:
    """Host spans recorded by the benchmark around calls into the
    program's layers: durations by name, and (start, end, name, thread) on
    the wall clock the profiler's trace uses (``time.time_ns``), which
    label the device's idle gaps."""

    def __init__(self):
        self.durations = defaultdict(list)
        self.intervals = []

    def record(self, name: str, t0: int, t1: int) -> None:
        self.durations[name].append((t1 - t0) / 1e9)
        self.intervals.append((t0, t1, name, threading.get_ident()))

    def clear(self) -> None:
        self.durations.clear()
        self.intervals.clear()

    def copy(self) -> "Spans":
        out = Spans()
        for name, d in self.durations.items():
            out.durations[name] = list(d)
        out.intervals = list(self.intervals)
        return out

    def timed(self, name: str, fn):
        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.record(name, t0, time.time_ns())
        return wrapped

    def iterate(self, name: str, iterable):
        """Yield from ``iterable``, timing each ``next`` as one span."""
        it = iter(iterable)
        while True:
            t0 = time.time_ns()
            try:
                item = next(it)
            except StopIteration:
                return
            self.record(name, t0, time.time_ns())
            yield item

    def mean_ms(self, name: str) -> Optional[float]:
        d = self.durations.get(name)
        return sum(d) / len(d) * 1e3 if d else None


class GcPauses:
    """The garbage collector's pauses from construction to ``stop()``:
    (generation, seconds) each."""

    def __init__(self):
        self.pauses, self._t0 = [], None
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t0))

    def stop(self) -> None:
        gc.callbacks.remove(self._on)


def window_report(label: str, spans: Spans, step: str, w0: int, w1: int,
                  pauses: GcPauses) -> str:
    """One line for standard error on where a window's time went: steps
    completed per fifth of the window, the step span's median and slowest
    calls, the waits between steps over 5x the median (an epoch's end and
    restart), and the collector's pauses."""
    ends = sorted(t1 for t0, t1, name, _ in spans.intervals if name == step)
    starts = sorted(t0 for t0, t1, name, _ in spans.intervals
                    if name == step)
    fifth = (w1 - w0) / 5
    slices = [sum(1 for t in ends if w0 + i * fifth <= t < w0 + (i + 1)
                  * fifth) for i in range(5)]
    d = sorted(spans.durations.get(step, [])) or [0.0]
    waits = [(b - a) / 1e9 for a, b in zip(ends, starts[1:])]
    wmed = sorted(waits)[len(waits) // 2] if waits else 0.0
    long = [w for w in waits if w > 5 * max(wmed, d[len(d) // 2])]
    gen2 = [s for g, s in pauses.pauses if g == 2]
    return (f"window {label}: {(w1 - w0) / 1e9:.3f} s, steps per fifth "
            f"{slices}, step ms median {1e3 * d[len(d) // 2]:.2f} p99 "
            f"{1e3 * d[int(0.99 * (len(d) - 1))]:.2f} max {1e3 * d[-1]:.2f}"
            f", long waits {len(long)} = {sum(long):.3f} s, gc "
            f"{len(pauses.pauses)} pauses = "
            f"{sum(s for _, s in pauses.pauses):.3f} s (gen-2 {len(gen2)} "
            f"= {sum(gen2):.3f} s)")


@dataclasses.dataclass
class Trace:
    """The profiler's view of the traced window."""
    window_s: float
    busy_s: float
    kernels: list          # (name, seconds) per device operation
    gaps: list             # (host label, seconds) per idle gap


def _union(intervals: list) -> float:
    total, start, end = 0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


SHORT_GAP_NS = 10_000


def _label(spans: list, starts: list, t: int, default: str) -> str:
    """The latest-starting span of ``spans`` (one thread's, nested, sorted
    by start) that runs at ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 65, -1), -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return default


def reduce_trace(prof, spans: Spans, w0: int, w1: int, main: int,
                 default: str) -> Trace:
    """Device operations of the CUDA trace inside the window ``[w0, w1]``
    (wall-clock ns), their union, and the idle gaps, each labelled by the
    benchmark span the main thread was in at the gap's middle (``default``
    outside every span) and whether the input pipeline was masking."""
    dev = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA") \
                or e.is_user_annotation():
            continue
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if t > w0 and s < w1:
            dev.append((max(s, w0), min(t, w1), e.name()))
    busy = _union([(s, e) for s, e, _ in dev])
    kernels = [(n, (e - s) / 1e9) for s, e, n in dev]
    mine = sorted(sp for sp in spans.intervals if sp[3] == main)
    other = sorted(sp for sp in spans.intervals if sp[3] != main)
    mine_starts = [sp[0] for sp in mine]
    other_starts = [sp[0] for sp in other]
    gaps, last = [], w0
    for s, e, _ in sorted(dev) + [(w1, w1, "")]:
        if s - last >= SHORT_GAP_NS:
            mid = (last + s) // 2
            label = _label(mine, mine_starts, mid, default)
            side = _label(other, other_starts, mid, "")
            gaps.append((f"{label} + {side}" if side else label,
                         (s - last) / 1e9))
        elif s > last:
            gaps.append(("gaps under 10 us", (s - last) / 1e9))
        last = max(last, e)
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 kernels=kernels, gaps=gaps)


def breakdown(trace: Trace) -> dict:
    ops, idle = defaultdict(float), defaultdict(float)
    for name, sec in trace.kernels:
        ops[name[:120]] += sec
    for label, sec in trace.gaps:
        idle[label[:120]] += sec
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def reader(name: str):
    """The ``read(obs)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer(workload: str, end_to_end: set, obs) -> dict:
    """Every per-layer metric this cell reports, read from ``obs``; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in manifest()["per_layer"]:
        cells = m.get("workloads")
        if (workload not in cells) if cells is not None \
                else m["moves"] not in end_to_end:
            continue
        value = reader(m["name"])(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, extra: Optional[dict] = None
                ) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    line.update(extra or {})
    line["checks"] = checks
    return json.dumps(line)
