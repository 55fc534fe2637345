"""Online serving: a saved model behind micro-batched HTTP (port of
``examples/serving_server_example.py``; no reference counterpart — the
reference serves one history per Python call, reference
apps/recommender.py:6-63).

Loads a saved artifact, starts the JSON API, and demonstrates a client
request::

    python -m bert4rec_tpu_torch.examples.serving_server_example \\
        bert4rec_ml-1m_128 8080 [--device cpu]

POST /v1/recommend {"history": ["Toy Story (1995)", ...], "k": 5}
GET  /healthz                      -> batching stats

``mode=demo`` (third argument) starts the server on an ephemeral port,
issues one client request + a health check, and exits — the self-test
flow the tests and chip_smoke execute.

Concurrent requests are coalesced into fixed-capacity device batches (one
top-k shape serves all traffic; see bert4rec_tpu_torch/apps/serving.py).
"""

import json
import pathlib
import urllib.request

from bert4rec_tpu_torch.apps import Recommender, RecommenderService, ServingServer
from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
from bert4rec_tpu_torch.examples._common import command_line
from bert4rec_tpu_torch.models import BERT4RecModelWrapper


def main(save_path: str = "bert4rec_ml-1m_128", port: int = 8080,
         mode: str = "serve", device="cuda") -> dict:
    wrapper, extras = BERT4RecModelWrapper.load(pathlib.Path(save_path),
                                                device=device)
    dataloader = get_dataloader_factory("bert4rec").create_ml_1m_dataloader(
        tokenizer=extras.get("tokenizer"))

    recommender = Recommender(wrapper.model, wrapper.params, dataloader,
                              device=device)
    service = RecommenderService(recommender, max_k=10, batch_capacity=32,
                                 max_wait_ms=2.0)
    if mode == "demo":
        port = 0  # ephemeral
    server = ServingServer(service, host="127.0.0.1", port=int(port)).start()
    print(f"serving on http://127.0.0.1:{server.port}/v1/recommend "
          f"(GET /healthz for stats); Ctrl-C to stop")
    out = {}
    try:
        if mode == "demo":
            # NOT inside a swallowing except: any failure here (API drift,
            # bad response) must fail the caller's chain loudly
            vocab = extras["tokenizer"].get_vocab()
            history = sorted(set(vocab) - {"[PAD]", "[MASK]", "[UNK]"})[:3]
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/recommend",
                data=json.dumps({"history": history, "k": 5}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                body = json.loads(resp.read())
            print("demo request:", history, "->", body)
            if len(body["items"]) != 5:
                raise RuntimeError(f"expected 5 items, got {body}")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/healthz",
                    timeout=30) as resp:
                health = json.loads(resp.read())
            print("healthz:", health)
            out = {"history": history, "response": body, "healthz": health}
        else:
            try:
                import signal
                signal.pause()  # AttributeError on platforms without it
            except (KeyboardInterrupt, AttributeError):
                pass
    finally:
        server.stop()
    return out


if __name__ == "__main__":
    main(**command_line(__doc__, save_path="bert4rec_ml-1m_128", port=8080,
                        mode="serve"))
