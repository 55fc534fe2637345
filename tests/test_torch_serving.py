"""The port's serving runtime on the CPU device: micro-batching, the
service's padding and per-request k, and the HTTP API under a burst of
concurrent clients."""

import http.client
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from bert4rec_tpu_torch.apps import (
    MicroBatcher, Recommender, RecommenderService, ServingServer,
)
from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
from tests import test_utils

SEQ_LEN = 12


@pytest.fixture(scope="module")
def recommender():
    dataloader = BERT4RecDataloader(max_seq_len=SEQ_LEN,
                                    max_predictions_per_seq=3)
    vocab = test_utils.generate_random_word_list(n_words=30, seed=0)
    dataloader.generate_vocab(vocab)
    cfg = BERT4RecConfig(vocab_size=dataloader.tokenizer.get_vocab_size(),
                         hidden_size=16, num_layers=1,
                         num_attention_heads=2, inner_dim=32,
                         max_sequence_length=SEQ_LEN,
                         max_predictions_per_seq=3, use_fused_layer=True)
    model = BERT4RecModel(config=cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return Recommender(model, params, dataloader, device="cpu"), vocab


def request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_micro_batcher_coalesces_and_isolates_errors():
    entered, release = threading.Event(), threading.Event()
    sizes = []

    def handler(items):
        entered.set()
        release.wait(timeout=5)
        sizes.append(len(items))
        if -1 in items:
            raise RuntimeError("bad batch")
        return [x * 10 for x in items]

    mb = MicroBatcher(handler, max_batch_size=8, max_wait_ms=50)
    try:
        futs = [mb.submit(0)]
        assert entered.wait(timeout=5)
        futs += [mb.submit(i) for i in range(1, 6)]
        release.set()
        assert [f.result(timeout=5) for f in futs] == [0, 10, 20, 30, 40, 50]
        assert sizes == [1, 5]
        with pytest.raises(RuntimeError):
            mb.submit(-1).result(timeout=5)
        assert mb.submit(7).result(timeout=5) == 70
        assert mb.stats["errors"] == 1
    finally:
        mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(1)


def test_service_pads_to_capacity_and_slices_k(recommender):
    rec, vocab = recommender
    service = RecommenderService(rec, max_k=5, batch_capacity=4,
                                 max_wait_ms=20)
    try:
        history = vocab[:3]
        futs = [service.submit(history, k=k) for k in (1, 3, 5)]
        got = [f.result(timeout=30) for f in futs]
        full = rec.recommend_batch([history], top_k=5)[0]
        assert got == [full[:1], full[:3], full]
        assert not set(full) & set(history)
        with pytest.raises(ValueError):
            service.submit(history, k=6)
        with pytest.raises(ValueError):
            service.submit([], k=1)
    finally:
        service.close()


def test_http_server_answers_a_burst_of_clients(recommender):
    rec, vocab = recommender
    service = RecommenderService(rec, max_k=4, batch_capacity=8,
                                 max_wait_ms=5)
    server = ServingServer(service, port=0).start()
    try:
        histories = [vocab[i:i + 1 + i % 5] for i in range(24)]
        before = fel.fused_encoder_layer.launches
        with ThreadPoolExecutor(max_workers=24) as pool:
            replies = list(pool.map(
                lambda h: request(server.port, "POST", "/v1/recommend",
                                  {"history": h, "k": 2}), histories))
        assert fel.fused_encoder_layer.launches == before  # CPU: plain path
        want = rec.recommend_batch(histories, top_k=2)
        assert [r for r in replies] == [(200, {"items": w}) for w in want]
        status, health = request(server.port, "GET", "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["requests"] == 24 and health["errors"] == 0
        assert 3 <= health["batches"] <= 24
        assert request(server.port, "POST", "/v1/recommend",
                       {"history": "x"})[0] == 400
        assert request(server.port, "POST", "/v1/recommend",
                       {"history": vocab[:2], "k": 9})[0] == 400
        assert request(server.port, "GET", "/nope")[0] == 404
    finally:
        server.stop()
