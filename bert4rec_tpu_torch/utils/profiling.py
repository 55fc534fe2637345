"""Tracing and throughput counters (port of
``bert4rec_tpu/utils/profiling.py``).

``trace`` wraps ``torch.profiler`` so any region (train steps, an eval
sweep, a served batch) can be captured as a Chrome trace in a directory;
``StepTimer`` gives streaming step-time / examples-per-second statistics
(JAX's summary keys); ``hard_sync`` waits for a tensor's device, since
CUDA launches return before the card finishes.

``span(name)`` marks a region of the program (the trainer's step and its
parts, the prefetch queue's wait). While ``record_spans()`` is open each
span is kept in memory with its wall-clock start and end
(``time.time_ns``, the clock of the CUDA profiler's events), the span
that encloses it on its thread and the thread; inside ``trace`` they are
also ``record_function`` ranges of the Chrome trace. Otherwise ``span``
returns a shared no-op context.
"""

import contextlib
import os
import pathlib
import threading
import time
from typing import Optional

import numpy as np
import torch


# the log of the open ``record_spans`` (None: spans are not recorded), and
# whether spans also open ``record_function`` ranges (inside ``trace``)
_log: Optional[list] = None
_annotate = False
_local = threading.local()


class Span:
    """One span: ``start_ns`` / ``end_ns`` on ``time.time_ns``, its
    ``name``, the ``parent`` span open on the same thread when it began
    (None at the top) and its ``thread`` (``threading.get_ident``)."""

    __slots__ = ("start_ns", "end_ns", "name", "parent", "thread", "_log",
                 "_range")

    def __init__(self, name: str, log: list):
        self.name, self._log = name, log
        self.start_ns = self.end_ns = self.parent = self._range = None
        self.thread = threading.get_ident()

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if _annotate:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        if _log is self._log:       # closed after recording stopped: dropped
            self._log.append(self)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context manager marking ``name``: a ``Span`` recorded into the
    open ``record_spans`` log when it closes, or the shared no-op context
    while nothing records."""
    if _log is None:
        return _NO_SPAN
    return Span(name, _log)


def open_spans() -> tuple:
    """The names of the spans open on the calling thread, outermost
    first."""
    return tuple(s.name for s in _stack())


@contextlib.contextmanager
def record_spans():
    """Record every span closed inside the region; yields the log, a list
    of ``Span`` in the order they closed. Nothing is written anywhere.
    Inside an open recording it yields that recording's log."""
    global _log
    outer = _log
    _log = outer if outer is not None else []
    try:
        yield _log
    finally:
        _log = outer


@contextlib.contextmanager
def trace(log_dir: Optional[str], enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` as ``trace_<pid>_<ns>.json`` (a Chrome trace; a no-op when
    disabled or ``log_dir`` is None). The card's kernels are traced when
    CUDA is available; the card is synchronised before the trace stops, so
    kernels still in flight are in it. The program's spans are recorded in
    the region and are ranges of the trace, beside the kernels."""
    global _annotate
    if not enabled or log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    outer = _annotate
    with torch.profiler.profile(activities=acts) as prof, record_spans():
        _annotate = True
        try:
            yield
        finally:
            _annotate = outer
            if cuda:
                torch.cuda.synchronize()
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def hard_sync(x) -> None:
    """Wait until the work producing ``x`` (a tensor, or a dict, list or
    tuple of them) is done on its device: the current stream of each CUDA
    tensor's device is synchronised (a CPU tensor is already done)."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            hard_sync(item)
        return
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


class StepTimer:
    """Streaming step-time statistics.

    >>> timer = StepTimer(batch_size=256)
    >>> for batch in batches:
    ...     with timer.step():
    ...         logs = trainer.train_step(batch)
    ...         hard_sync(logs)
    >>> timer.summary()   # {'steps', 'mean_step_ms', 'p50', 'p99', 'examples_per_second'}
    """

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.durations = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.durations.append(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self.durations.append(seconds)

    def summary(self, skip_warmup: int = 1) -> dict:
        d = np.asarray(self.durations[skip_warmup:] or self.durations)
        if d.size == 0:
            return {"steps": 0}
        return {
            "steps": int(d.size),
            "mean_step_ms": float(d.mean() * 1e3),
            "p50_step_ms": float(np.percentile(d, 50) * 1e3),
            "p99_step_ms": float(np.percentile(d, 99) * 1e3),
            "examples_per_second": float(self.batch_size / d.mean()),
        }

    def reset(self) -> None:
        self.durations = []
