"""Host/device pipelining (port of ``bert4rec_tpu/utils/prefetch.py``).

The trainer's step k should not wait on host work for batch k+1: a daemon
thread runs the batch iterator (slicing and masking) and the device
placement ahead of consumption, keeping at most ``depth`` placed batches
in a bounded queue. On the card, placement (:func:`device_put`) stages each
array in pinned host memory and copies it with a non-blocking copy on a
side stream, so the copy of batch k+1 overlaps step k's kernels on the
compute stream.
"""

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from bert4rec_tpu_torch.utils import profiling

_END = object()


def prefetch(iterator: Iterable, put_fn: Optional[Callable] = None,
             depth: int = 2) -> Iterator:
    """Iterate ``iterator`` in a daemon thread, applying ``put_fn`` (e.g.
    the trainer's device placement) in that thread, yielding the results in
    order. At most ``depth`` items are in flight. An exception of the
    producer re-raises at the consuming ``next()``; closing the generator
    early (a ``break``, ``steps_per_epoch``) retires the thread. The
    consumer's wait for each item (the end of the items too) is a
    ``pipeline.wait`` span."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def produce():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                q.put(put_fn(item) if put_fn is not None else item)
            q.put(_END)
        except BaseException as exc:  # noqa: BLE001 — re-raised at consumer
            q.put(exc)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            with profiling.span("pipeline.wait"):
                item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # the consumer stopped early: unblock and retire the producer
        stop.set()
        while thread.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.1)


def device_put(device: torch.device, keys: Iterable[str],
               optional: Iterable[str] = ()) -> Callable:
    """A ``put_fn`` for :func:`prefetch`: host numpy batch -> the tensors at
    ``keys``, and at those of ``optional`` the batch holds, on ``device``.

    On the card each array is staged in pinned host memory and sent with a
    non-blocking copy on a side stream. The tensors are marked as used by
    the stream that is current where this function is called (the compute
    stream, ``record_stream``), so the caching allocator does not hand their
    memory to a later batch while a step may still read them; and ``put``
    returns only after the copy's event has completed, so a batch is whole
    before the step sees it. On the CPU the arrays are wrapped, not copied.
    """
    keys, optional = tuple(keys), tuple(optional)

    def present(batch: dict) -> tuple:
        return keys + tuple(k for k in optional if k in batch)

    if device.type != "cuda":
        return lambda batch: {k: torch.from_numpy(np.ascontiguousarray(
            batch[k])) for k in present(batch)}
    side = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)

    def put(batch: dict) -> dict:
        with torch.cuda.device(device), torch.cuda.stream(side):
            out = {k: torch.from_numpy(np.ascontiguousarray(batch[k]))
                   .pin_memory().to(device, non_blocking=True)
                   for k in present(batch)}
            done = torch.cuda.Event()
            done.record(side)
        for t in out.values():
            t.record_stream(compute)
        done.synchronize()
        return out

    return put


def fetch_pipelined(items: Iterable, dispatch: Callable, fetch: Callable,
                    workers: int = 2) -> Iterator:
    """``dispatch(item)`` runs on the calling thread (launch order stays
    deterministic) while ``fetch(token)`` — the device->host copy that
    waits for the device — runs on ``workers`` threads. Yields fetch
    results in dispatch order; ``workers=0`` is strictly sequential."""
    if workers <= 0:
        for item in items:
            yield fetch(dispatch(item))
        return
    import concurrent.futures as cf
    pending = []
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        for item in items:
            token = dispatch(item)
            pending.append(ex.submit(fetch, token))
            while pending and pending[0].done():
                yield pending.pop(0).result()
        for f in pending:
            yield f.result()
