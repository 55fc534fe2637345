"""Time the loss kernels (K3 forward, K4 backward; the vocab-tiled
forward K5 and backwards K6 and K7) and the ml-1m_128 train step of the
port in one checkout, on one CUDA card:

    python bert4rec_tpu_torch/tools/time_loss_step.py [--root DIR] [--reps 5]

``DIR`` is the root of a checkout (by default the one holding this file):
its ``bert4rec_tpu_torch`` is imported and its kernels are built from its
own sources. To compare two commits, run it for both checkouts in one
session on one card, in the order A, B, B, A. Prints one JSON line:
per-rep times of K3 and K4 at chip_smoke's shape (R=10,240 rows, V=3,709,
W=128, bf16; CUDA events over 50 launches) and of the same K3 and K4 in
fp32 (``k3_fp32``, ``k4_fp32``: the quality harness's fp32 ml1m path), the
device ms of each kernel inside one launch of K4 and of fp32 K3 and K4
(torch.profiler), per-rep medians of the host wall of 20 synchronised
train steps at B=256 on batches of ``bench.py``'s law, ml-1m_128 in bf16
(``step``) and the harness's fp32 ml1m preset (``step_fp32``: the
encoder's default dropout 0.1 / 0.1, no dtype policy), K5 at (R, V, W) =
(10,240, 26,732, 128), (10,240, 26,732, 256) and (2,048, 335,424, 128),
K6 at (10,240, 26,732, 128) and K7 at (10,240, 26,732, 256), bf16, the
same K5 shapes and (10,240, 335,424, 128), the Reddit preset's batch, in
fp32 (``k5_fp32_*``: the loss entry), and the same K6 and K7 in fp32
(``k6_fp32``, ``k7_fp32``), each as (median, lowest, highest) ms per call
over 7 blocks of 10 calls after 5 warm-up calls, with the device ms of
each kernel inside one launch."""

import argparse
import json
import pathlib
import subprocess
import sys
import time

VOCAB, ROWS, WIDTH = 3709, 256 * 40, 128
SEQ, BATCH, NPRED = 200, 256, 40
ML20M_VOCAB = 26732
# (width, merged, operand dtype name)
TILED = {"k6": (128, True, "bfloat16"), "k7": (256, False, "bfloat16"),
         "k6_fp32": (128, True, "float32"), "k7_fp32": (256, False, "float32")}
# K5: (rows, vocabulary, width, operand dtype name)
TILED_FWD = {"k5_w128": (ROWS, ML20M_VOCAB, 128, "bfloat16"),
             "k5_w256": (ROWS, ML20M_VOCAB, 256, "bfloat16"),
             "k5_reddit": (2048, 335424, 128, "bfloat16"),
             "k5_fp32_w128": (ROWS, ML20M_VOCAB, 128, "float32"),
             "k5_fp32_w256": (ROWS, ML20M_VOCAB, 256, "float32"),
             "k5_fp32_reddit": (2048, 335424, 128, "float32"),
             "k5_fp32_reddit_r10240": (ROWS, 335424, 128, "float32")}


def events_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def blocks_ms(torch, fn, blocks=7, iters=10, warmup=5):
    """``(median, lowest, highest)`` ms per call over ``blocks`` blocks."""
    import statistics
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return [statistics.median(times), min(times), max(times)]


def tiled_operands(torch, np, device, rows, vocab, width,
                   dtype_name="bfloat16"):
    """hidden and table in ``dtype_name`` (bf16 by default), the bias and
    labels (every 9th row 0)."""
    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.normal(size=(rows, width)).astype(np.float32)) \
        .to(device, dtype)
    t = torch.from_numpy((rng.normal(size=(vocab, width)) * 0.1)
                         .astype(np.float32)).to(device, dtype)
    b = torch.from_numpy(rng.normal(size=vocab).astype(np.float32)) \
        .to(device)
    lab = rng.integers(3, vocab, size=rows).astype(np.int32)
    lab[::9] = 0
    return h, t, b, torch.from_numpy(lab).to(device)


def tiled_forward(torch, np, fml, device, rows, vocab, width, dtype_name):
    """K5 (the loss entry) in ``dtype_name``, as a callable."""
    h, t, b, lab = tiled_operands(torch, np, device, rows, vocab, width,
                                  dtype_name)
    return lambda: fml._launch_forward_tiled(h, t, b, lab)


def tiled_backward(torch, np, fml, device, width, merged, dtype_name):
    """K6 (``merged``) or K7 at the ML-20M train batch in ``dtype_name``,
    as a callable."""
    h, t, b, lab = tiled_operands(torch, np, device, ROWS, ML20M_VOCAB,
                                  width, dtype_name)
    lse, sums = fml._launch_forward_tiled(h, t, b, lab)
    g = torch.ones((), device=device)
    return lambda: fml._launch_backward_tiled(h, t, b, lab, lse, g,
                                              sums[3:4], merged)


def kernel_ms(torch, fn, calls=5):
    """Device ms per call of each CUDA kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    def name(key):
        key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
        return key.split("(")[0][:70]

    return {name(e.key): e.self_device_time_total / calls / 1e3
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0}


def make_batch(np, seed):
    """``bench.py``'s batch law: random ids, no padding, 40 distinct sorted
    masked positions per sequence."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    pos = np.stack([np.sort(rng.choice(SEQ, size=NPRED, replace=False))
                    for _ in range(BATCH)]).astype(np.int32)
    return {"input_word_ids": ids,
            "input_mask": np.ones((BATCH, SEQ), np.int32),
            "masked_lm_positions": pos,
            "masked_lm_ids": np.take_along_axis(ids, pos, axis=1),
            "masked_lm_weights": np.ones((BATCH, NPRED), np.int32)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[2]))
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_loss_step: no CUDA device", file=sys.stderr)
        return 1
    from bert4rec_tpu_torch.config import load_train_config
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
    if not fml.__file__.startswith(str(pathlib.Path(args.root).resolve())):
        raise RuntimeError(f"imported {fml.__file__}, not from {args.root}")
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]

    rng = np.random.default_rng(0)
    hidden32 = torch.from_numpy(rng.normal(size=(ROWS, WIDTH))
                                .astype(np.float32)).to(device)
    table32 = torch.from_numpy((rng.normal(size=(VOCAB, WIDTH)) * 0.1)
                               .astype(np.float32)).to(device)
    hidden, table = hidden32.to(torch.bfloat16), table32.to(torch.bfloat16)
    bias = fml._mask_bias(torch.from_numpy(
        rng.normal(size=VOCAB).astype(np.float32)).to(device), VOCAB)
    lab = rng.integers(3, VOCAB, size=ROWS).astype(np.int32)
    lab[::9] = 0
    labels = torch.from_numpy(lab).to(device)
    g = torch.ones((), device=device)
    fwd = lambda: fml._launch_forward(hidden, table, bias, labels)  # noqa
    lse, sums = fwd()
    bwd = lambda: fml._launch_backward(  # noqa: E731
        hidden, table, bias, labels, lse, g, sums[3:4])
    fwd32 = lambda: fml._launch_forward(  # noqa: E731
        hidden32, table32, bias, labels)
    lse32, sums32 = fwd32()
    bwd32 = lambda: fml._launch_backward(  # noqa: E731
        hidden32, table32, bias, labels, lse32, g, sums32[3:4])

    config = load_train_config("ml-1m_128", vocab_size=VOCAB,
                               use_fused_layer=True, use_fused_loss=True)
    trainer = BERT4RecTrainer(BERT4RecModel(config=config,
                                            dtype_policy=DTypePolicy.bf16()))
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=1e-4, num_warmup_steps=100), seed=0, device=device)
    batches = [trainer._put_batch(make_batch(np, 100 + i)) for i in range(4)]
    # the quality harness's fp32 ml1m preset, built as the harness builds it
    trainer32 = BERT4RecTrainer(BERT4RecModel(config=BERT4RecConfig(
        vocab_size=VOCAB, max_sequence_length=SEQ,
        max_predictions_per_seq=NPRED, hidden_size=WIDTH, num_layers=2,
        num_attention_heads=4, inner_dim=512, use_fused_layer=True,
        use_fused_loss=True)))
    trainer32.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=1e-4, num_warmup_steps=100), seed=0, device=device)
    for b in batches:
        trainer.train_step(b)
        trainer32.train_step(b)

    def step_wall(tr):
        walls = []
        for i in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(batches[i % len(batches)])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return sorted(walls)[len(walls) // 2]

    out = dict(root=args.root, card=card, k3_ms=[], k4_ms=[], step_ms=[],
               k3_fp32_ms=[], k4_fp32_ms=[], step_fp32_ms=[])
    for _ in range(args.reps):
        out["k3_ms"].append(events_ms(torch, fwd))
        out["k4_ms"].append(events_ms(torch, bwd))
        out["step_ms"].append(step_wall(trainer))
        out["k3_fp32_ms"].append(events_ms(torch, fwd32))
        out["k4_fp32_ms"].append(events_ms(torch, bwd32))
        out["step_fp32_ms"].append(step_wall(trainer32))
    out["k4_kernels_ms"] = kernel_ms(torch, bwd)
    out["k3_fp32_kernels_ms"] = kernel_ms(torch, fwd32)
    out["k4_fp32_kernels_ms"] = kernel_ms(torch, bwd32)
    out["step_fp32_kernels_ms"] = kernel_ms(
        torch, lambda: trainer32.train_step(batches[0]), calls=3)
    del trainer32
    out["k5_kernels_ms"] = {}
    for key, shape in TILED_FWD.items():
        fn = tiled_forward(torch, np, fml, device, *shape)
        out[f"{key}_ms"] = blocks_ms(torch, fn)
        out["k5_kernels_ms"][key] = kernel_ms(torch, fn)
        del fn
        torch.cuda.empty_cache()
    for key, (width, merged, dtype_name) in TILED.items():
        fn = tiled_backward(torch, np, fml, device, width, merged, dtype_name)
        out[f"{key}_ms"] = blocks_ms(torch, fn)
        out[f"{key}_kernels_ms"] = kernel_ms(torch, fn)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
