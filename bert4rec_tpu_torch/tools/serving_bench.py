"""Online serving latency and throughput of the port through its
micro-batched HTTP stack: the counterpart of ``tools/serving_bench.py``,
with its names, flags and output keys.

    python -m bert4rec_tpu_torch.tools.serving_bench [--clients 16]
        [--requests 400] [--capacity 32] [--wait-ms 2] [--k 10]
        [--device cpu] [--smoke]

It builds ``tools/serving_bench.py:32-80``'s ML-1M-shaped model (3,706
items, vocab 3,709, hidden 128, 2 layers, 4 heads, inner 512, S=200,
random weights from seed 0), bf16 with the fused layer on the card (K1 on
``wgmma``, as JAX's is bf16 and fused on its chip), fp32 and unfused with
``--device cpu``. It serves it through ``Recommender`` ->
``RecommenderService`` -> ``ServingServer`` on localhost and drives it
with ``--clients`` closed-loop HTTP clients (each sends its next request
when the last is answered) over 64 histories of 20 items (seed 0), after
one warm request. The last line printed is one JSON object with
``histories_per_sec``, ``p50_ms``, ``p99_ms``, ``batches`` and
``mean_batch_fill`` (JAX's keys; every request is answered or the tool
raises).

``--smoke`` cuts the load to 4 clients x 24 requests (with ``--device
cpu``: the CPU test). The device's default is the card, and the tool
raises without one unless ``--device cpu`` asks for the CPU. JAX's
``--cpu`` is ``--device cpu``.
"""

import argparse
import http.client
import json
import sys
import threading
import time

VOCAB_ITEMS = 3706   # ML-1M catalog (golden vocab size)
SEQ = 200
HISTORY_LEN = 20
N_HISTORIES = 64
SMOKE_LOAD = dict(clients=4, requests=24)


def build_server(device, capacity, wait_ms, k):
    """(server, service, items) over the ML-1M-shaped model on
    ``device``."""
    import torch

    from bert4rec_tpu_torch.apps import (
        Recommender, RecommenderService, ServingServer,
    )
    from bert4rec_tpu_torch.core import resolve_device
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel

    device = resolve_device(device)
    on_card = device.type == "cuda"
    dataloader = BERT4RecDataloader(max_seq_len=SEQ,
                                    max_predictions_per_seq=40)
    items = [f"movie {i}" for i in range(VOCAB_ITEMS)]
    dataloader.generate_vocab(items, progress_bar=False)
    config = BERT4RecConfig(
        vocab_size=dataloader.tokenizer.get_vocab_size(), hidden_size=128,
        num_layers=2, num_attention_heads=4, inner_dim=512,
        max_sequence_length=SEQ, max_predictions_per_seq=40,
        use_fused_layer=on_card)
    model = BERT4RecModel(config=config, dtype_policy=(
        DTypePolicy.bf16() if on_card else DTypePolicy.f32()))
    params = model.init(torch.Generator().manual_seed(0), device=device)
    recommender = Recommender(model, params, dataloader, device=device)
    service = RecommenderService(recommender, max_k=k,
                                 batch_capacity=capacity,
                                 max_wait_ms=wait_ms)
    return ServingServer(service, port=0).start(), service, items


def post(port, history, k):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/recommend",
                     body=json.dumps({"history": history, "k": k}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        if resp.status != 200 or len(body["items"]) != k:
            raise RuntimeError(f"request failed ({resp.status}): {body}")
        return body
    finally:
        conn.close()


def run(clients=16, requests=400, capacity=32, wait_ms=2.0, k=10,
        device="cuda") -> dict:
    """The closed-loop load against a fresh server; the JSON line's
    dict."""
    import numpy as np
    import torch

    from bert4rec_tpu_torch.core import resolve_device
    if requests < 1 or clients < 1:
        raise ValueError("--requests and --clients must be >= 1")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    server, service, items = build_server(device, capacity, wait_ms, k)
    try:
        rng = np.random.default_rng(0)
        histories = [[items[j] for j in rng.choice(
            VOCAB_ITEMS, HISTORY_LEN, replace=False)]
            for _ in range(N_HISTORIES)]
        post(server.port, histories[0], k)   # warm
        # the remainder spread so every requested request is sent
        base, rem = divmod(requests, clients)
        counts = [base + (1 if i < rem else 0) for i in range(clients)]
        latencies, errors = [], []
        lock = threading.Lock()

        def client(idx):
            mine = []
            try:
                for r in range(counts[idx]):
                    h = histories[(idx * max(base, 1) + r) % N_HISTORIES]
                    t0 = time.perf_counter()
                    post(server.port, h, k)
                    mine.append((time.perf_counter() - t0) * 1e3)
            except Exception as e:   # reported below, after the join
                with lock:
                    errors.append(f"client {idx}: {type(e).__name__}: {e}")
            with lock:
                latencies.extend(mine)

        stats0 = service.stats
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        dt = time.perf_counter() - t0
        stats = service.stats
    finally:
        server.stop()
    if errors or len(latencies) != requests:
        raise RuntimeError(f"{len(latencies)} of {requests} requests "
                           f"answered: {errors[:3]}")
    served = stats["requests"] - stats0["requests"]
    batches = stats["batches"] - stats0["batches"]
    lat = np.sort(np.asarray(latencies))
    return {
        "platform": "gpu" if on_card else "cpu",
        "device": (torch.cuda.get_device_name(device) if on_card
                   else "cpu"),
        "histories_per_sec": round(len(lat) / dt, 1),
        "p50_ms": round(float(lat[len(lat) // 2]), 3),
        "p99_ms": round(float(lat[int(len(lat) * 0.99)]), 3),
        "clients": clients, "requests": requests,
        "batches": batches,
        "mean_batch_fill": round(served / max(batches, 1), 2),
        "capacity": capacity,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests", type=int, default=400)
    p.add_argument("--capacity", type=int, default=32)
    p.add_argument("--wait-ms", type=float, default=2.0)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--smoke", action="store_true",
                   help="4 clients x 24 requests")
    args = p.parse_args(argv)
    load = (SMOKE_LOAD if args.smoke
            else dict(clients=args.clients, requests=args.requests))
    print(json.dumps(run(capacity=args.capacity, wait_ms=args.wait_ms,
                         k=args.k, device=args.device, **load)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
