"""Online serving runtime: cross-request micro-batching + HTTP front end
(the port's own copy of ``bert4rec_tpu/apps/serving.py``, which imports no
JAX; unchanged but for a listen backlog that holds a burst of clients).

Many concurrent small requests are folded into ONE fixed-size device
dispatch, because

- a fixed batch capacity (requests padded with a dummy history) gives the
  kernels one shape for every traffic pattern, and
- per-dispatch overhead dominates tiny batches on an accelerator; batching
  across requests amortizes it.

Three layers, separable:

``MicroBatcher``
    Generic request coalescing: ``submit(item)`` returns a
    ``concurrent.futures.Future``; a worker thread drains the queue into
    batches of at most ``max_batch_size``, waiting at most ``max_wait_ms``
    after the first request of a batch, and hands each batch to a
    user ``handler(items) -> results``. Handler errors propagate to every
    future of that batch; later batches are unaffected.

``RecommenderService``
    A :class:`~bert4rec_tpu_torch.apps.recommender.Recommender` behind a
    ``MicroBatcher``: requests are padded to the fixed ``batch_capacity``
    and scored via ``recommend_batch`` (device-side top-k: the ``[B, V]``
    logits never reach the host).
    Per-request ``k`` is served by slicing one ``max_k`` ranking.

``ServingServer``
    A stdlib ``ThreadingHTTPServer`` JSON API over the service —
    ``POST /v1/recommend {"history": [...], "k": 3}`` and ``GET /healthz``
    with live batching stats. Thread-per-connection is exactly right here:
    threads block on futures while the single device worker batches.
"""

import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["MicroBatcher", "RecommenderService", "ServingServer"]

_SHUTDOWN = object()


class MicroBatcher:
    """Coalesce concurrent requests into bounded batches for one handler.

    :param handler: ``handler(items: list) -> list`` of equally many
        results, called on the worker thread with 1..max_batch_size items.
    :param max_batch_size: hard cap per handler call.
    :param max_wait_ms: how long the worker waits for more requests after
        the first one of a batch arrives. 0 means "whatever is already
        queued" — no artificial latency.
    :param finalize: optional second phase. When given, ``handler`` is the
        DISPATCH phase (fast, returns an opaque token — e.g. an
        un-fetched device array) and ``finalize(token) -> list`` runs on a
        small fetch pool, so the batching thread starts the NEXT device
        dispatch while the previous batch's results are still in flight.
        On high-latency links (device->host round trip >> scoring time)
        this roughly matches the pipelining win of
        ``Recommender.recommend_stream``.
    """

    def __init__(self, handler: Callable[[list], list],
                 max_batch_size: int = 32,
                 max_wait_ms: float = 2.0,
                 finalize: Optional[Callable[[Any], list]] = None):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, "
                             f"got {max_batch_size}")
        self._handler = handler
        self._finalize = finalize
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = False
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "max_batch_observed": 0}
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="micro-batcher")
        self._worker.start()

    def submit(self, item: Any) -> Future:
        """Enqueue one request; resolve via ``future.result(timeout)``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            fut: Future = Future()
            self._queue.put((item, fut))
        return fut

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Stop accepting requests, flush the queue, join the worker.

        If the worker fails to join (a wedged handler — e.g. a hung device
        dispatch), every still-queued future gets a RuntimeError instead of
        leaving its caller blocked until its own result() timeout."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(_SHUTDOWN)
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is _SHUTDOWN:
                    continue
                _, fut = item
                if not fut.done():
                    fut.set_exception(RuntimeError(
                        "MicroBatcher shut down while the worker was "
                        "wedged; request was never dispatched"))

    # ------------------------------------------------------------------ #

    def _collect(self):
        """One batch: block for the first item, then fill until
        max_batch_size or the wait budget runs out. Returns (batch, done)."""
        first = self._queue.get()
        if first is _SHUTDOWN:
            return [], True
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch_size:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._queue.get_nowait() if remaining <= 0
                       else self._queue.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                return batch, True
            batch.append(nxt)
        return batch, False

    def _resolve(self, batch, results_or_token, finalize):
        """Resolve one batch's futures; ``finalize`` (if any) runs here —
        on the fetch pool in two-phase mode, inline otherwise."""
        try:
            results = (finalize(results_or_token) if finalize is not None
                       else results_or_token)
            if len(results) != len(batch):
                raise RuntimeError(
                    f"batch handler returned {len(results)} results "
                    f"for {len(batch)} requests")
        except BaseException as exc:  # noqa: BLE001 — forward to callers
            with self._lock:  # fetch-pool threads race on this counter
                self.stats["errors"] += 1
            for _, fut in batch:
                fut.set_exception(exc)
            return
        for (_, fut), res in zip(batch, results):
            fut.set_result(res)

    def _loop(self):
        fetch_pool = None
        if self._finalize is not None:
            import concurrent.futures as cf
            fetch_pool = cf.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="micro-batcher-fetch")
        done = False
        try:
            while not done:
                batch, done = self._collect()
                if not batch:
                    continue
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["max_batch_observed"] = max(
                    self.stats["max_batch_observed"], len(batch))
                try:
                    token = self._handler([item for item, _ in batch])
                except BaseException as exc:  # noqa: BLE001 — to callers
                    with self._lock:
                        self.stats["errors"] += 1
                    for _, fut in batch:
                        fut.set_exception(exc)
                    continue
                if fetch_pool is None:
                    self._resolve(batch, token, None)
                else:
                    fetch_pool.submit(self._resolve, batch, token,
                                      self._finalize)
        finally:
            if fetch_pool is not None:
                # drain in-flight fetches so close() never strands futures
                fetch_pool.shutdown(wait=True)


class RecommenderService:
    """A :class:`Recommender` behind cross-request micro-batching.

    Every device dispatch scores exactly ``batch_capacity`` histories (the
    tail padded with a dummy history, results dropped) at a fixed
    ``max_k`` — one kernel shape for the life of the service. A
    request's smaller ``k`` slices the ``max_k`` ranking.

    :param recommender: a live :class:`Recommender` (model + params +
        dataloader).
    :param max_k: largest ``k`` a request may ask for.
    :param batch_capacity: fixed device batch (compile-time shape).
    :param max_wait_ms: batching window after the first queued request.
    """

    def __init__(self, recommender, max_k: int = 10,
                 batch_capacity: int = 32, max_wait_ms: float = 2.0):
        if max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {max_k}")
        # fail at construction, not per batch: an AOT-artifact backend has
        # a baked-in k every dispatch uses
        exported_k = getattr(recommender, "exported_k", None)
        if exported_k is not None and max_k > exported_k:
            raise ValueError(
                f"max_k={max_k} exceeds the artifact backend's exported "
                f"k={exported_k}; re-export with a larger k")
        self.recommender = recommender
        self.max_k = int(max_k)
        self.batch_capacity = int(batch_capacity)
        tok = recommender.dataloader.tokenizer
        # any real catalog item works as padding: its row is scored and
        # discarded. Id 3 is the first non-special id by construction
        # ([PAD]=0, [MASK]=1, [UNK]=2 — reference special-token order).
        self._pad_history = [tok.detokenize(3)]
        if hasattr(recommender, "_dispatch_topk"):
            # two-phase: the batching thread only preps+dispatches; the
            # device->host fetch + detokenize run on the fetch pool, so
            # the next batch dispatches while this one's ids are in flight
            self._batcher = MicroBatcher(self._dispatch,
                                         max_batch_size=batch_capacity,
                                         max_wait_ms=max_wait_ms,
                                         finalize=self._finalize)
        else:  # duck-typed backends (e.g. AOT artifacts): single phase
            self._batcher = MicroBatcher(self._handle,
                                         max_batch_size=batch_capacity,
                                         max_wait_ms=max_wait_ms)

    @property
    def stats(self) -> dict:
        return dict(self._batcher.stats)

    def submit(self, history: Sequence[str], k: int = 1) -> Future:
        """Non-blocking: a Future resolving to a list of <= k items.

        Everything decidable per request is validated HERE: an invalid
        request must fail its own caller, never the innocent requests it
        would be coalesced with in the shared batch handler."""
        if not 1 <= k <= self.max_k:
            raise ValueError(f"k must be in [1, {self.max_k}], got {k}")
        if not history:
            raise ValueError("history must contain at least one item")
        limit = getattr(self.recommender, "max_history_items", None)
        if limit is not None and len(history) > limit:
            raise ValueError(
                f"history of {len(history)} items exceeds the artifact "
                f"backend's exclusion capacity of {limit}; re-export with "
                f"a larger num_exclude")
        return self._batcher.submit((list(history), int(k)))

    def recommend(self, history: Sequence[str], k: int = 1,
                  timeout: Optional[float] = 30.0) -> List[str]:
        """Blocking top-k recommendation for one history."""
        return self.submit(history, k).result(timeout=timeout)

    def close(self) -> None:
        self._batcher.close()

    # ------------------------------------------------------------------ #

    def _handle(self, items):
        histories = [h for h, _ in items]
        n_pad = self.batch_capacity - len(histories)
        histories = histories + [self._pad_history] * n_pad
        rankings = self.recommender.recommend_batch(histories,
                                                    top_k=self.max_k)
        return [rankings[i][:k] for i, (_, k) in enumerate(items)]

    def _dispatch(self, items):
        """Phase 1 (batching thread): pad + dispatch, NO host sync."""
        histories = [h for h, _ in items]
        n_pad = self.batch_capacity - len(histories)
        histories = histories + [self._pad_history] * n_pad
        ids = self.recommender._dispatch_topk(histories, self.max_k)
        return (ids, items)

    def _finalize(self, token):
        """Phase 2 (fetch pool): fetch ids, detokenize, slice per-k."""
        ids, items = token
        # decode at most max_k columns (artifact backends rank exported_k)
        rankings = self.recommender._decode_topk(ids, self.max_k)
        return [rankings[i][:k] for i, (_, k) in enumerate(items)]


class _Handler(BaseHTTPRequestHandler):
    # the service is attached to the server object by ServingServer
    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path == "/healthz":
            self._reply(200, {"status": "ok",
                              **self.server.service.stats})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 — http.server API
        # ALWAYS drain the body first: on an HTTP/1.1 keep-alive
        # connection, replying without reading Content-Length bytes leaves
        # them in the socket to be parsed as the next request line,
        # desynchronizing every subsequent request on the connection
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            length = 0
        body = self.rfile.read(length)
        if self.path != "/v1/recommend":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            req = json.loads(body or b"{}")
            history = req.get("history")
            if not isinstance(history, list) or not history or \
                    not all(isinstance(x, str) for x in history):
                raise ValueError(
                    "'history' must be a non-empty list of item strings")
            items = self.server.service.recommend(
                history, k=int(req.get("k", 1)),
                timeout=self.server.request_timeout_s)
        except (ValueError, TypeError, json.JSONDecodeError) as exc:
            self._reply(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 — surface as 500, keep serving
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
        else:
            self._reply(200, {"items": items})

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class _HTTPServer(ThreadingHTTPServer):
    # the stdlib default listen backlog (5) resets connections when a few
    # dozen clients connect at once — the burst micro-batching exists for
    request_queue_size = 128


class ServingServer:
    """JSON-over-HTTP front end for a :class:`RecommenderService`.

    ``ThreadingHTTPServer``: each connection's thread blocks on its
    request future while the micro-batcher's single worker talks to the
    device — concurrency at the edge, one dispatcher at the accelerator.

    >>> server = ServingServer(service, port=0)   # 0 = ephemeral
    >>> server.start()
    >>> server.port
    43127
    >>> ... POST http://127.0.0.1:43127/v1/recommend ...
    >>> server.stop()
    """

    def __init__(self, service: RecommenderService,
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 30.0):
        self.service = service
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.service = service
        self._httpd.request_timeout_s = request_timeout_s
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ServingServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="serving-http")
        self._thread.start()
        return self

    def stop(self, close_service: bool = True) -> None:
        # shutdown() blocks on serve_forever()'s exit event — calling it
        # when start() never ran would hang forever
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if close_service:
            self.service.close()
