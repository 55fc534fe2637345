"""Tracing and throughput counters (port of
``bert4rec_tpu/utils/profiling.py``).

``trace`` wraps ``torch.profiler`` so any region (train steps, an eval
sweep, a served batch) can be captured as a Chrome trace in a directory;
``StepTimer`` gives streaming step-time / examples-per-second statistics
(JAX's summary keys); ``hard_sync`` waits for a tensor's device, since
CUDA launches return before the card finishes.
"""

import contextlib
import os
import pathlib
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` as ``trace_<pid>_<ns>.json`` (a Chrome trace; a no-op when
    disabled or ``log_dir`` is None). The card's kernels are traced when
    CUDA is available; the card is synchronised before the trace stops, so
    kernels still in flight are in it."""
    if not enabled or log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield
        finally:
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
