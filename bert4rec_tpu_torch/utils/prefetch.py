"""Dispatch/fetch pipelining (port of ``fetch_pipelined`` in
``bert4rec_tpu/utils/prefetch.py``)."""

from typing import Callable, Iterable, Iterator


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
