"""Time the fused layer kernels of the port in one checkout, on one CUDA
card: K1' (forward with dropout) and K2 (backward), and their causal and
relative-bias variants (K1'' causal, K1'' rel_bias / K2 dRel) where the
checkout has them, and flash attention's K8 / K9 (which run the same
attention tiles) where it has ``ops/flash_attention.py``:

    python bert4rec_tpu_torch/tools/time_layer.py [--root DIR] [--reps 5] \
        [--hidden 128 256]

``DIR`` is the root of a checkout (by default the one holding this file):
its ``bert4rec_tpu_torch`` is imported and its kernels are built from its
own sources. To compare two commits, run it for both checkouts in one
session on one card, in the order A, B, B, A. Prints one JSON line: per-rep
times (CUDA events over 50 launches) at the train shape, B=256, S=200,
H=128, 4 heads, F=512, bf16, right-padded rows of random length, dropout
0.2 / 0.5 (ml-1m_128's) and 0.1 / 0.1 (ml-20m_128's); the relative bias
(~ N(0, 1), fp32 [B, N, S, S]) at 0.1 / 0.1, the temporal ml-20m_128's;
with ``--hidden 256`` also ml-20m_256's width (H=256, 8 heads, F=1024,
dropout 0.1 / 0.1); K8 / K9 at bert_base_512's attention shape, B=32,
N=12, S=512, D=64, bf16, dropout 0.2, right-padded rows; and the serving
forward, fp32, nothing saved, no dropout, at B=32 and B=256 (and H=256
with ``--hidden 256``): whatever route the checkout's ``kernel_route``
gives it (the SIMT kernels before the 3xTF32 ones existed). fp32 training
(the JAX package's default precision): K1' and K2 at ml-1m's and ml-20m's
rates and at rate 0 (so that the dropout hash's cost shows), causal and
with the relative bias at ml-20m's, and at ml-20m_256's width with
``--hidden 256``, by the checkout's route (the SIMT kernels before the
3xTF32 training kernels existed). fp32 K8 / K9 at bert_base_512's
attention shape, at rate 0 and 0.2, bidirectional and causal, by the
checkout's route (the SIMT tiles before the 3xTF32 flash kernels existed);
with ``--base-step`` also the fp32 bert_base_512 train step (hidden 768,
12 layers, S=512, P=76, B=32, no dtype policy, flash attention, the logits
loss, dropout 0.2 / 0.5): the median of ``--reps`` x 5 synchronised
``train_step`` calls on the host clock."""

import argparse
import importlib
import inspect
import json
import pathlib
import subprocess
import sys

B, S, H, N, F = 256, 200, 128, 4, 512
WIDE = (256, 8, 1024, (0.1, 0.1))   # ml-20m_256's H, N, F and dropout
FLASH_DIMS, FLASH_RATE = (32, 12, 512, 64), 0.2
BASE_VOCAB, BASE_PRED = 3709, 76   # bert_base_512's V and P (B, S: FLASH_DIMS)
RATES = {"ml-1m": (0.2, 0.5), "ml-20m": (0.1, 0.1)}


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


def layer_params(np, rng, device, H=H, N=N, F=F):
    from bert4rec_tpu_torch.utils.checkpoint import params_from_numpy
    d = H // N

    def w(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return params_from_numpy({
        "attention/qkv/kernel": w(H, 3, N, d, scale=0.1),
        "attention/qkv/bias": w(3, N, d, scale=0.02),
        "attention/output/kernel": w(N, d, H),
        "attention/output/bias": w(H, scale=0.02),
        "attention_norm/scale": 1.0 + w(H, scale=0.1),
        "attention_norm/bias": w(H, scale=0.02),
        "intermediate/kernel": w(H, F),
        "intermediate/bias": w(F, scale=0.02),
        "output/kernel": w(F, H),
        "output/bias": w(H, scale=0.02),
        "output_norm/scale": 1.0 + w(H, scale=0.1),
        "output_norm/bias": w(H, scale=0.02),
    }, device)


def base_step(np, torch, device, reps):
    """Per-rep medians of 5 synchronised fp32 bert_base_512 train steps
    (ms), after 2 warm-up steps; the batches follow chip_smoke's
    ``make_batch`` law (random ids, no padding, P sorted masked
    positions)."""
    import time
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
    b, _, s, _ = FLASH_DIMS
    config = BERT4RecConfig(
        vocab_size=BASE_VOCAB, hidden_size=768, num_layers=12,
        num_attention_heads=12, inner_dim=3072, max_sequence_length=s,
        max_predictions_per_seq=BASE_PRED, attention_dropout=0.2,
        output_dropout=0.5, use_fused_layer=False, use_fused_loss=False,
        use_flash_attention=True)
    trainer = BERT4RecTrainer(BERT4RecModel(config=config))
    trainer.initialize_model(optimizer=optimizers.create_adam_w_optimizer(
        init_lr=1e-4, num_warmup_steps=100), seed=0, device=device)

    def batch(seed):
        rng = np.random.default_rng(seed)
        ids = rng.integers(3, BASE_VOCAB, size=(b, s)).astype(np.int32)
        pos = np.stack([np.sort(rng.choice(s, size=BASE_PRED, replace=False))
                        for _ in range(b)]).astype(np.int32)
        return trainer._put_batch({
            "input_word_ids": ids, "input_mask": np.ones((b, s), np.int32),
            "masked_lm_positions": pos,
            "masked_lm_ids": np.take_along_axis(ids, pos, axis=1),
            "masked_lm_weights": np.ones((b, BASE_PRED), np.int32)})

    batches = [batch(100 + i) for i in range(4)]
    for i in range(2):
        trainer.train_step(batches[i])
    out = []
    for _ in range(reps):
        ms = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batches[i % len(batches)])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out.append(sorted(ms)[2])
    del trainer
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[2]))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--hidden", type=int, nargs="+", default=[H],
                        choices=[H, WIDE[0]],
                        help="layer widths to time (256: ml-20m_256's)")
    parser.add_argument("--base-step", action="store_true",
                        help="also time the fp32 bert_base_512 train step")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_layer: no CUDA device", file=sys.stderr)
        return 1
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    if not fel.__file__.startswith(str(pathlib.Path(args.root).resolve())):
        raise RuntimeError(f"imported {fel.__file__}, not from {args.root}")
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    launch_params = inspect.signature(fel._launch_forward).parameters
    has_causal, has_rel = "causal" in launch_params, "rel" in launch_params

    rng = np.random.default_rng(0)
    flat = fel.flat_weights(layer_params(np, rng, device))
    x, dy = (torch.from_numpy(rng.normal(size=(B, S, H)).astype(np.float32))
             .to(device, torch.bfloat16) for _ in range(2))
    lengths = rng.integers(1, S + 1, size=B)
    mask = torch.from_numpy((np.arange(S)[None, :] < lengths[:, None])
                            .astype(np.int32)).to(device)
    cases = {}
    for name, rates in RATES.items():
        for causal in ((False, True) if has_causal else (False,)):
            kw = {"causal": True} if causal else {}
            y, saved = fel._launch_forward(flat, x, mask, N, 7, *rates, True,
                                           **kw)
            cases[f"{'causal' if causal else 'bidirectional'} {name}"] = (
                lambda r=rates, k=kw: fel._launch_forward(
                    flat, x, mask, N, 7, *r, True, **k),
                lambda r=rates, k=kw, s=saved: fel._launch_backward(
                    flat, x, mask, dy, s, N, 7, *r, **k))
    if has_rel:
        rates = RATES["ml-20m"]
        rel = torch.from_numpy(np.random.default_rng(1).normal(
            size=(B, N, S, S)).astype(np.float32)).to(device)
        y, saved = fel._launch_forward(flat, x, mask, N, 7, *rates, True,
                                       rel=rel)
        cases["rel ml-20m"] = (
            lambda r=rates: fel._launch_forward(flat, x, mask, N, 7, *r,
                                                True, rel=rel),
            lambda r=rates, s=saved: fel._launch_backward(
                flat, x, mask, dy, s, N, 7, *r, rel=rel))
    # fp32 training: the same layer and inputs, widened
    flat32 = {k: v.float() for k, v in flat.items()}
    x32, dy32 = x.float(), dy.float()
    fp32_cases = [(f"fp32 {name}", rates, {}) for name, rates in
                  {**RATES, "rate0": (0.0, 0.0)}.items()]
    if has_causal:
        fp32_cases.append(("fp32 causal ml-20m", RATES["ml-20m"],
                           {"causal": True}))
    if has_rel:
        fp32_cases.append(("fp32 rel ml-20m", RATES["ml-20m"], {"rel": rel}))
    for name, r32, kw32 in fp32_cases:
        y, s32 = fel._launch_forward(flat32, x32, mask, N, 7, *r32, True,
                                     **kw32)
        cases[name] = (
            lambda r=r32, k=kw32: fel._launch_forward(
                flat32, x32, mask, N, 7, *r, True, **k),
            lambda r=r32, k=kw32, s=s32: fel._launch_backward(
                flat32, x32, mask, dy32, s, N, 7, *r, **k))
    if WIDE[0] in args.hidden:
        wh, wn, wf, rates = WIDE
        wflat = fel.flat_weights(layer_params(np, np.random.default_rng(3),
                                              device, wh, wn, wf))
        wx, wdy = (torch.from_numpy(np.random.default_rng(4 + i).normal(
            size=(B, S, wh)).astype(np.float32)).to(device, torch.bfloat16)
            for i in range(2))
        y, wsaved = fel._launch_forward(wflat, wx, mask, wn, 7, *rates, True)
        cases["bidirectional ml-20m_256"] = (
            lambda: fel._launch_forward(wflat, wx, mask, wn, 7, *rates, True),
            lambda: fel._launch_backward(wflat, wx, mask, wdy, wsaved, wn, 7,
                                         *rates))
        wflat32 = {k: v.float() for k, v in wflat.items()}
        wx32, wdy32 = wx.float(), wdy.float()
        y, wsaved32 = fel._launch_forward(wflat32, wx32, mask, wn, 7, *rates,
                                          True)
        cases["fp32 ml-20m_256"] = (
            lambda: fel._launch_forward(wflat32, wx32, mask, wn, 7, *rates,
                                        True),
            lambda: fel._launch_backward(wflat32, wx32, mask, wdy32, wsaved32,
                                         wn, 7, *rates))
    serving = {}
    for wh in args.hidden:
        sn, sf = (N, F) if wh == H else WIDE[1:3]
        sflat = flat if wh == H else wflat
        sflat = {k: v.float() for k, v in sflat.items()}
        sx = torch.from_numpy(np.random.default_rng(5).normal(
            size=(B, S, wh)).astype(np.float32)).to(device)
        for sb in (32, B):
            serving[f"serving fp32 H={wh} B={sb}"] = (
                lambda sflat=sflat, sx=sx, sb=sb, sn=sn: fel._launch_forward(
                    sflat, sx[:sb], mask[:sb], sn, 0, 0.0, 0.0, False))
    if (pathlib.Path(fel.__file__).parent / "flash_attention.py").is_file():
        fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
        frng = np.random.default_rng(2)   # the same inputs in every tree
        fb, _, fs, _ = FLASH_DIMS
        q, k, v, do = (torch.from_numpy(frng.normal(size=FLASH_DIMS)
                                        .astype(np.float32))
                       .to(device, torch.bfloat16) for _ in range(4))
        flens = frng.integers(1, fs + 1, size=fb)
        fmask = torch.from_numpy((np.arange(fs)[None, :] < flens[:, None])
                                 .astype(np.int32)).to(device)
        _, fsaved = fa._launch_forward(q, k, v, fmask, 7, FLASH_RATE, False,
                                       True)
        cases["flash bert_base_512"] = (
            lambda: fa._launch_forward(q, k, v, fmask, 7, FLASH_RATE, False,
                                       True),
            lambda: fa._launch_backward(q, k, v, fmask, do, fsaved, 7,
                                        FLASH_RATE, False))
        # fp32 (the JAX package's default precision) by the checkout's route
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        for rate in (0.0, FLASH_RATE):
            for causal in (False, True):
                _, s32 = fa._launch_forward(q32, k32, v32, fmask, 7, rate,
                                            causal, True)
                cases[f"flash fp32 bert_base_512 rate {rate} "
                      f"{'causal' if causal else 'bidirectional'}"] = (
                    lambda r=rate, c=causal: fa._launch_forward(
                        q32, k32, v32, fmask, 7, r, c, True),
                    lambda r=rate, c=causal, sv=s32: fa._launch_backward(
                        q32, k32, v32, fmask, do32, sv, 7, r, c))
    out = dict(root=args.root, card=card, shape=[B, S, H, N, F],
               flash_shape=list(FLASH_DIMS))
    if WIDE[0] in args.hidden:
        out["wide_shape"] = [B, S, *WIDE[:3]]
    for name in cases:
        out[name] = {"fwd_ms": [], "bwd_ms": []}
    for name in serving:
        out[name] = {"fwd_ms": []}
    for _ in range(args.reps):
        for name, (fwd, bwd) in cases.items():
            out[name]["fwd_ms"].append(events_ms(torch, fwd))
            out[name]["bwd_ms"].append(events_ms(torch, bwd))
        for name, fwd in serving.items():
            out[name]["fwd_ms"].append(events_ms(torch, fwd))
    if args.base_step:
        del cases, serving
        torch.cuda.empty_cache()
        out["fp32 bert_base_512 step"] = {
            "step_ms": base_step(np, torch, device, args.reps)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
