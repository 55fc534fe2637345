"""Device time by the program span that launched it.

Each device operation of the CUDA profiler's trace is traced back to its
launch, the CUDA runtime call with the same correlation id, and goes to the
innermost program span (``bert4rec_tpu_torch.utils.profiling``) open on
the main thread at the launch's host time. Two launching threads act for
the main thread: the main thread itself, and autograd's device thread,
which launches the backward while the main thread waits in
``trainer.backward``. An operation launched by any other thread (the
prefetch thread's casts, say) goes to ``OTHER_THREADS``, whatever the main
thread was doing. Host-to-device copies are the prefetch thread's batches
(and the step's scalar), not kernels: they go to ``COPIES``. An operation
launched outside every span, or whose launch the trace lacks, goes to
``UNLABELLED``.

The profiler names a launching thread by ids whose meaning differs
between its event kinds, so the two threads are found from the launches
themselves (``acting_threads``): the main thread is the one that launches
most inside the main thread's spans outside ``trainer.backward``, and
autograd's the other one that launches most inside ``trainer.backward``.
"""

import bisect
from collections import Counter, defaultdict

BACKWARD = "trainer.backward"
COPIES = "host to device copies"
OTHER_THREADS = "other threads"
UNLABELLED = "unlabelled"


def events(prof) -> tuple:
    """From a ``torch.profiler.profile``: the device operations
    ``(start_ns, end_ns, name, correlation id)`` and each correlation id's
    launch, ``{id: (start_ns, thread)}`` of the runtime calls, ``thread``
    the ids the profiler gives the launching thread."""
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if str(e.device_type()).endswith("CUDA"):
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name(), e.correlation_id()))
        elif e.correlation_id():
            launches[e.correlation_id()] = (
                e.start_ns(), (e.start_thread_id(), e.device_resource_id()))
    return ops, launches


class _Innermost:
    """The innermost of one thread's nested spans open at a time, looked
    for among the ``DEPTH`` spans that began last before it (a step opens
    a handful)."""

    DEPTH = 64

    def __init__(self, spans: list, main: int):
        self.spans = sorted((s.start_ns, s.end_ns, s.name) for s in spans
                            if s.thread == main)
        self.starts = [s[0] for s in self.spans]

    def __call__(self, t: int):
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(i - 1 - self.DEPTH, -1), -1):
            if self.spans[j][1] >= t:
                return self.spans[j][2]
        return None


def acting_threads(launches: dict, label) -> set:
    """The launching threads that act for the main thread: the main
    thread and autograd's (module docstring). ``label(t)`` is the main
    thread's innermost span at ``t``."""
    outside, backward = Counter(), Counter()
    for t, thread in launches.values():
        name = label(t)
        if name == BACKWARD:
            backward[thread] += 1
        elif name is not None:
            outside[thread] += 1
    if not outside:
        return set()
    main = outside.most_common(1)[0][0]
    backward.pop(main, None)
    return {main} | {t for t, _ in backward.most_common(1)}


def attribute(ops: list, launches: dict, spans: list, main: int, w0: int,
              w1: int) -> dict:
    """Seconds of device time inside ``[w0, w1]`` (wall-clock ns, each
    operation clipped to it as ``harness.reduce_trace`` clips) by label:
    a span's name, ``COPIES``, ``OTHER_THREADS`` or ``UNLABELLED``.
    ``spans`` are the program's (``profiling.Span``); only the thread
    ``main``'s label."""
    label = _Innermost(spans, main)
    acting = acting_threads(launches, label)
    out = defaultdict(float)
    for s, e, name, corr in ops:
        if e <= w0 or s >= w1:
            continue
        if name.startswith("Memcpy HtoD"):
            tag = COPIES
        elif corr not in launches:
            tag = UNLABELLED
        elif launches[corr][1] not in acting:
            tag = OTHER_THREADS
        else:
            tag = label(launches[corr][0]) or UNLABELLED
        out[tag] += (min(e, w1) - max(s, w0)) / 1e9
    return dict(out)
