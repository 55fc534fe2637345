"""Time the port's eager serving call on one CUDA card, for one checkout:

    python bert4rec_tpu_torch/tools/time_serving.py [--root DIR] \\
        [--reps 3] [--calls 100]

``DIR`` is the root of a checkout (by default the one holding this file):
its ``bert4rec_tpu_torch`` is imported and its kernels are built from its
own sources. The model is ml-1m_128 (V=3,709, hidden 128, 2 layers, 4
heads, F=512, S=200, P=40), fp32, on the fused layer, with random weights
from seed 0; the request is 32 histories of random length (1-199 items,
seed 1). Per rep it takes the median host wall (ms) of ``--calls``
``Recommender.recommend_batch(histories, top_k=10)`` calls (each ends in
a device-to-host copy) and of ``--calls`` synchronised inference calls of
``fused_encoder_layer`` at [32, 200, 128]. Where the checkout registers
the layer's inference launch as an operator (``fused_layer_forward``), it
also times that operator called directly and the launch it wraps
(``_launch_forward`` without saves) in the same way: their difference is
the operator's dispatch cost per call. To compare two commits, run it for
both checkouts in one session on one card, in the order A, B, B, A.
Prints one JSON line.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

V, H, L, N, F, S, P, B = 3709, 128, 2, 4, 512, 200, 40, 32


def wall_ms(torch, fn, calls, warmup=5):
    """The median host wall of ``calls`` calls of ``fn``, each followed by
    a synchronisation."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[2]))
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--calls", type=int, default=100)
    args = parser.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_serving: no CUDA device", file=sys.stderr)
        return 1
    from bert4rec_tpu_torch.apps import Recommender
    from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    if not fel.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {fel.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]

    model = BERT4RecModel(config=BERT4RecConfig(
        vocab_size=V, hidden_size=H, num_layers=L, num_attention_heads=N,
        inner_dim=F, max_sequence_length=S, max_predictions_per_seq=P,
        use_fused_layer=True))
    params = model.init(torch.Generator().manual_seed(0), device=device)
    items = [f"movie_{i:04d}" for i in range(V - 3)]
    dataloader = BERT4RecDataloader(S, P)
    dataloader.generate_vocab(items)
    rec = Recommender(model, params, dataloader, device=device)
    rng = np.random.default_rng(1)
    histories = [[items[j] for j in rng.choice(len(items), size=int(n),
                                               replace=False)]
                 for n in rng.integers(1, S, size=B)]

    layer = params["encoder"]["layers"]["layer_0"]
    flat = fel.flat_weights(layer)
    x = torch.from_numpy(rng.normal(size=(B, S, H)).astype(np.float32)) \
        .to(device)
    lengths = rng.integers(1, S + 1, size=B)
    mask = torch.from_numpy((np.arange(S)[None, :] < lengths[:, None])
                            .astype(np.int32)).to(device)
    cases = {
        "recommend_batch": lambda: rec.recommend_batch(histories, top_k=10),
        "fused_encoder_layer": lambda: fel.fused_encoder_layer(
            layer, x, mask, num_heads=N),
    }
    if hasattr(fel, "fused_layer_forward"):
        weights = [flat[k] for k in fel._W_ORDER]
        cases["operator"] = lambda: fel.fused_layer_forward(
            x, mask, weights, None, N, False, 0, 0.0, 0.0)
        cases["launch"] = lambda: fel._launch_forward(
            flat, x, mask, N, 0, 0.0, 0.0, False)
    out = dict(root=str(root), card=card, batch=B,
               **{name: [] for name in cases})
    with torch.inference_mode():
        for _ in range(args.reps):
            for name, fn in cases.items():
                out[name].append(wall_ms(torch, fn, args.calls))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
