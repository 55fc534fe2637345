#!/usr/bin/env python3
"""The card checks of the PyTorch/CUDA port (``bert4rec_tpu_torch``) that
no other home holds, on one NVIDIA GPU: each kernel's time beside its
plain version, its library yardstick and its bound at the main path's
shapes (PERF.md's kernel table; the ``kernels`` record), with its distance
from the plain version on the inputs it times; and the flows only the
card runs, each counted ``train()`` with its route, launch counts and
step parity. A kernel's values at every shape and edge are the card
tests' (``tests/test_torch_cuda_kernels.py``), ``train()``'s throughput at
a benchmark cell's configuration ``benchmark/``'s, and operations and
bytes ``benchmark/roofline.py``'s. Times are device ms, medians of blocks
queued behind a sleeping kernel (``time_device_ms``).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit (nvidia-smi);
2. build: every ``csrc/`` source for sm_90a, each kernel's registers and
   spills;
3. K1 at ml-1m_128's shape, fp32 (3xTF32) and bf16, B=32 and 256;
4. serving: an ml-1m_128 artifact in the JAX package's format over HTTP
   and ``recommend_stream``, every answer against the plain path;
5. K1' / K2 at B=256 (fp32 and bf16), K3 / K4 at R=10,240, V=3,709;
6. ``train()`` of ml-1m_128 in bf16: step parity, launches, step time,
   idle share, breakdown, the loss falling, an exact resume; K1' / K2 at
   ml-20m_256's width;
7. pipeline: an ML-20M-format corpus through ``prepare_training``;
8. tiled loss: K5 (both entries), K6, K7 at V=26,732, W=128 and 256; K5
   and K6 at Reddit's V=335,424;
9. ``train()`` of ml-20m_128 (K6) and ml-20m_256 (K7): step parity,
   launches, ``validate()``, the loss falling; ml-20m_256's step times;
10. K1'' causal / K2 at B=256, dropout 0 and 0.1, the bidirectional
    kernels beside;
11. SASRec: the ``"sasrec"`` pipeline, then phase 9's checks and times;
12. evaluation: device negatives, host negatives and the full catalog,
    the ranks against the plain path;
13. K8 / K9 at (32, 12, 512, 64), (3, 4, 130, 64), (3, 2, 1100, 64), fp32
    and bf16, dropout 0 and 0.2, causal or not;
14. bert_base_512 ``train()`` in bf16: step parity, flash launches, a
    remat step (the same gradients, a lower peak), the loss falling;
15. K1'' rel_bias / K2 dRel at B=256, causal or not;
16. temporal training: phase 9 for the ``"bert4rec_temporal"``
    pipeline, the tables' gradient bits, the bucket laws, evaluation;
17. temporal gate: the quality harness's ``run_smoke_temporal``;
18. fp32 ML-20M: phase 9 for the harness's ml20m preset;
19. fp32 ml-1m: phase 6 for the harness's ml1m preset;
20. fp32 bert_base_512: step parity, 3xTF32 flash launches, step time,
    idle share, breakdown, peak memory, an eval forward against plain;
21. oracle gate: ``run_oracle`` at the ml1m preset with ``--int8``;
22. deployment: a JAX-layout checkpoint resumed bit for bit, a profiled
    ``train()``, fp32 and int8 artifacts at B = 1, 32 and 256, the
    Ranker, the example scripts, a bf16 bert_base_512 artifact;
23. mesh: two ranks at reddit_128 width through ``tools/mesh_run.py``
    against one process; the shard's K5 stats and K6 timed;
24. tools: bench, config_sweep over the 13 configs, serving_bench,
    perf_guard; the bf16 kernels at the shapes only those reach;
25. examples: the synthetic corpora, the training examples, the ML-1M
    chain, the self-contained flows, SASRec's SIMT causal layer, ``run_real``;
26. (after phase 4) K10 at ml-20m_128's and bert_base_512's batches, each
    backward's device operations;
27. (after phase 25) K11 and K8 / K9 at (DK, DV) = (192, 128), then a
    counted ``train()`` of moonlight-16b-a3b_5L: launches, router load;
28. (inside phases 14 and 27) K12, three launches a step in every
    counted ``train()``; its times, host ms and device operations.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, the script fails before printing either.
"""

import importlib
import itertools
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

from benchmark import roofline, roofline_mla_moe
from bert4rec_tpu_torch.tools.plain_kernels import plain_kernels

SEED = 0
VOCAB = 3709          # ML-1M items + [PAD], [MASK], [UNK]
N_ITEMS = VOCAB - 3
SEQ, HIDDEN, HEADS, INNER = 200, 128, 4, 512
N_REQUESTS = 48
STREAM_BATCH, STREAM_BATCHES = 256, 2
TOL = {"float32": 1e-4, "bfloat16": 8e-2}  # kernel vs plain, max abs
LOGIT_TOL = 1e-3      # served path vs plain path, masked-slot logits
# a bf16 served path vs its plain version: top-k scores, relative to the
# largest plain score. Over bert_base_512's 12 layers the rounding spreads:
# phase 22 prints, beside the kernels' distance, that of a second valid
# rounding of the plain version (p not rounded to bf16 before p.v)
BF16_LOGIT_TOL = 2e-2
# the sleeping kernel a timed block is queued behind: cycles of the card's
# clock a second (an H100's boost clock; a slower clock sleeps longer), and
# the longest sleep, for calls that wait on the card themselves
CLOCK_HZ = 2e9
SLEEP_MAX_S = 0.05


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_device_ms(fn, iters=5, blocks=7, warmup=2) -> tuple:
    """``(median, lowest, highest, host_gaps)`` ms a call over ``blocks``
    blocks of ``iters`` calls after ``warmup`` calls: each block is queued
    behind a kernel that sleeps half as long again as the host took to
    queue as many calls (the last warm-up call's), so the events time the
    device, not the host's launches. ``host_gaps``: that sleep was past
    ``SLEEP_MAX_S`` and cut to it, so the blocks may hold the host's gaps
    between launches."""
    import statistics
    import torch
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    host_gaps = 1.5 * iters * host_s > SLEEP_MAX_S
    cycles = int(min(1.5 * iters * host_s, SLEEP_MAX_S) * CLOCK_HZ)
    times = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times), min(times), max(times), host_gaps


def timed(fn, key="", **kw) -> dict:
    """``{key}_ms`` (time_device_ms's median), ``{key}_range`` (lowest,
    highest) and, where its sleep was cut, ``{key}_host_gaps``; no
    ``key``: the kernel's ``ms``, ``range`` and ``host_gaps``."""
    med, lo, hi, gaps = time_device_ms(fn, **kw)
    prefix = f"{key}_" if key else ""
    return {f"{prefix}ms": med, f"{prefix}range": (lo, hi),
            **({f"{prefix}host_gaps": True} if gaps else {})}


# the plain versions: fewer, shorter blocks (they run 10-100x the kernels)
PLAIN = dict(iters=2, blocks=3, warmup=1)


def bound(fn, *args, peak=None, extra_flops=0, extra_bytes=0) -> dict:
    """``bound_ms`` and ``bound_by``: the least time ``fn`` of
    ``benchmark/roofline.py`` or ``roofline_mla_moe.py`` gives at ``args``,
    its operations and bytes read off its call of ``_bound``, with
    ``extra_flops`` and ``extra_bytes`` added (a causal pair count, a
    relative bias) and ``peak`` FLOP/s in place of its own (fp32's 3xTF32
    or 67 TFLOP/s line)."""
    seen = []
    with mock.patch.object(sys.modules[fn.__module__], "_bound",
                           lambda *a: seen.append(a) or 0.0):
        fn(*args)
    (flops, nbytes, own), = seen
    f, b, p = flops + extra_flops, nbytes + extra_bytes, peak or own
    return {"bound_ms": roofline._bound(f, b, p) * 1e3,
            "bound_by": "operations" if f / p >= b / roofline.HBM_BYTES_S
            else "bytes"}


def unpaired(b, s, width, causal) -> int:
    """(query, key) pairs times ``b`` and ``width`` the causal triangle
    skips: roofline.py counts all S^2 of them."""
    return b * width * (s * s - s * (s + 1) // 2) if causal else 0


def timing_text(r) -> str:
    """A row's distance from its plain version, and its times: the
    kernel's, the plain version's and the library yardstick's as medians
    of blocks with their ranges (those whose blocks may hold the host's
    gaps named), and the bound."""
    gaps = [k for k in ("kernel", "plain", "library")
            if r.get("host_gaps" if k == "kernel" else f"{k}_host_gaps")]
    lib = r["library_ms"] is not None and r["library_range"]
    return (f"max_abs_err={r['max_abs_err']:.3g} "
            f"kernel_ms={r['ms']:.4f} ({r['range'][0]:.4f}-"
            f"{r['range'][1]:.4f}) plain_ms={r['plain_ms']:.4f} library_ms="
            + (f"{r['library_ms']:.4f} ({lib[0]:.4f}-{lib[1]:.4f})" if lib
               else "None") + f" bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}); device time, medians of blocks"
            + (f" (host gaps included: {', '.join(gaps)})" if gaps else ""))


# --------------------------------------------------------------------------- #
# phase 3: the served layer's kernel times
# --------------------------------------------------------------------------- #

def random_layer(rng, device, h=HIDDEN, n=HEADS, f=INNER):
    """One encoder layer in the JAX param layout (ml-1m_128's by
    default)."""
    import numpy as np
    from bert4rec_tpu_torch.utils.checkpoint import params_from_numpy
    d = h // n

    def w(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return params_from_numpy({
        "attention/qkv/kernel": w(h, 3, n, d, scale=0.1),
        "attention/qkv/bias": w(3, n, d, scale=0.02),
        "attention/output/kernel": w(n, d, h),
        "attention/output/bias": w(h, scale=0.02),
        "attention_norm/scale": 1.0 + w(h, scale=0.1),
        "attention_norm/bias": w(h, scale=0.02),
        "intermediate/kernel": w(h, f),
        "intermediate/bias": w(f, scale=0.02),
        "output/kernel": w(f, h),
        "output/bias": w(h, scale=0.02),
        "output_norm/scale": 1.0 + w(h, scale=0.1),
        "output_norm/bias": w(h, scale=0.02),
    }, device)


# The SIMT fp32 layer kernels (csrc/fused_encoder_layer.cu's GEMM, LayerNorm
# GEMM, LayerNorm backward, FFN and weight-gradient tiles, csrc/attention.cuh's
# tiles): no fp32 layer launch at chip_smoke's shapes may reach them, forward
# or backward, since the route law (fused_encoder_layer.kernel_route) sends
# those to csrc/layer_tf32.cu's 3xTF32 kernels, which it must run
SIMT_FP32_LAYER = re.compile(
    r"^(gemm_kernel<float|gemm_residual_ln_kernel<float"
    r"|b4r::attention_kernel<float|b4r::attn_bwd_dq_kernel<float"
    r"|b4r::attn_bwd_dkv_kernel<float|ln_bwd_kernel<float"
    r"|gelu_grad_gemm_kernel<float|wgrad_kernel<float)")
TF32_LAYER = (re.compile(r"^(wt_split_kernel|gemm_tf32_kernel<"
                         r"|ln_tf32_kernel<|attn_tf32_kernel<)"),
              "attn_tf32_kernel<")
TF32_LAYER_BWD = (re.compile(
    r"^(w_split_kernel|wt_split_kernel|gemm_tf32_kernel<|ln_tf32_kernel<"
    r"|ln_rows_bwd_kernel<|attn_dq_tf32_kernel<|attn_dkv_tf32_kernel<"
    r"|wgrad_tf32_kernel|colsum_kernel|b4r::reduce_rows_kernel)"),
    "attn_dkv_tf32_kernel<")


# The earlier bf16 layer kernels (csrc/fused_encoder_layer.cu's GEMM, LayerNorm
# GEMM, FFN and weight-gradient tiles and csrc/attention.cuh's tiles): no bf16
# launch at the main paths' shapes may reach them, since the shape law
# (fused_encoder_layer.kernel_route) sends those to csrc/layer_hopper.cuh
LEGACY_BF16_LAYER = re.compile(
    r"^(gemm_kernel<__nv_bfloat16|gemm_residual_ln_kernel<__nv_bfloat16"
    r"|ln_bwd_kernel<__nv_bfloat16, \d+, true>|gelu_grad_gemm_kernel<"
    r"|wgrad_kernel<__nv_bfloat16|b4r::attention_kernel<|b4r::attn_bwd_)")


# The kernels a bf16 K4 and K5 launch may run (csrc/loss_hopper.cuh's
# wgmma sweeps, K5's ordered merge and row sums), each with the one it must
# run: the guard against a route back to the earlier mma.sync loss tiles
BF16_LOSS_KERNELS = {
    "K3": (re.compile(r"^(b4r::loss_hopper::loss_fwd_sweep_kernel<"
                      r"|loss_tiled_merge_kernel|b4r::reduce_rows_kernel)"),
           "loss_fwd_sweep_kernel<"),
    "K4": (re.compile(r"^b4r::loss_hopper::loss_sweep_kernel<"),
           "loss_sweep_kernel<"),
}
BF16_LOSS_KERNELS["K5"] = BF16_LOSS_KERNELS["K3"]


# The kernels an fp32 K3-K7 launch may run (csrc/loss_tf32.cuh's 3xTF32
# sweeps, K3's and K5's ordered merge and row sums, K6's ordered dh
# reduction), each with the one it must run, and the SIMT kernels they
# replaced, which no fp32 training step may reach
FP32_FWD_KERNELS = (re.compile(r"^(b4r::loss_tf32::loss_tf32_fwd_sweep_kernel<"
                               r"|loss_tiled_merge_kernel|b4r::reduce_rows_kernel)"),
                    "loss_tf32_fwd_sweep_kernel<")
FP32_LOSS_KERNELS = {
    "K3": FP32_FWD_KERNELS,
    "K5": FP32_FWD_KERNELS,
    "K4": (re.compile(r"^b4r::loss_tf32::loss_tf32_sweep_kernel<"),
           "loss_tf32_sweep_kernel<"),
    "K6": (re.compile(r"^(b4r::loss_tf32::loss_tf32_merged_kernel<"
                      r"|reduce_rows_cast_kernel<float>)"),
           "loss_tf32_merged_kernel<"),
    "K7": (re.compile(r"^b4r::loss_tf32::loss_tf32_sweep_kernel<"),
           "loss_tf32_sweep_kernel<"),
}
# every SIMT loss kernel the port had
SIMT_FP32_LOSS = re.compile(r"loss_fwd_kernel|loss_tiled_fwd_kernel"
                            r"|loss_bwd_(vt|dh|dt)_kernel")
# what an fp32 train step (phases 18 and 19) may not reach: the SIMT loss
# and layer kernels
SIMT_FP32_STEP = re.compile(f"{SIMT_FP32_LOSS.pattern}|{SIMT_FP32_LAYER.pattern}")


def _kernel_name(key: str) -> str:
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0][:60]


def device_breakdown(torch, fn, calls=5, top=6, groups=None,
                     forbid=None, only=None) -> tuple:
    """``(total, text)``: device ms per call of ``fn`` in all (None if the
    trace holds no device time) and a line naming its ``top`` costliest
    CUDA kernels, from torch.profiler (CUPTI); with ``groups`` ({label:
    name substrings}) also the device time of each group of kernels. A
    trace without device time is taken once more. With ``forbid`` (a
    compiled pattern) a kernel whose name it matches raises; with ``only``
    ((pattern, required name)) a kernel whose name the pattern does not
    match raises, and so does a trace without the required kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3 if only else 2):   # the profiler can drop records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((_kernel_name(e.key), e.self_device_time_total
                        / calls / 1e3) for e in prof.key_averages()
                       if getattr(e, "self_device_time_total", 0) > 0),
                      key=lambda r: -r[1])
        if rows and (not only or any(only[1] in n for n, _ in rows)):
            break
    if not rows:
        if only:
            raise AssertionError("no device time in three traces: the "
                                 "launch's kernels could not be named")
        return None, "device time not measured"
    hits = [name for name, _ in rows if forbid and forbid.search(name)]
    if hits:
        raise AssertionError(f"launch reached kernels it must not run "
                             f"({forbid.pattern}): {hits}")
    if only and (any(not only[0].search(name) for name, _ in rows)
                 or not any(only[1] in name for name, _ in rows)):
        raise AssertionError(f"launch ran other kernels than {only[0].pattern}"
                             f" (or not {only[1]}): {[n for n, _ in rows]}")
    total = sum(ms for _, ms in rows)
    rest = sum(ms for _, ms in rows[top:])
    parts = [f"{name} {ms:.4f}" for name, ms in rows[:top]]
    if rest:
        parts.append(f"{len(rows) - top} others {rest:.4f}")
    text = f"device {total:.4f} ms = " + ", ".join(parts)
    if groups:
        sums = dict.fromkeys(list(groups) + ["other"], 0.0)
        for name, ms in rows:
            label = next((g for g, keys in groups.items()
                          if any(k in name for k in keys)), "other")
            sums[label] += ms
        text += "; by group: " + ", ".join(f"{g} {ms:.4f}"
                                           for g, ms in sums.items())
    return total, text


def check_fused_layer(torch, rng, device):
    """K1 at the serving path's shape, fp32 and bf16, B=32 and B=256: the
    kernel's, plain version's and library composition's times, the bound
    (fp32's at 3xTF32's 165 TFLOP/s, 67 without tensor cores beside it),
    and each launch's kernels (fp32's the 3xTF32 ones only)."""
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    import numpy as np
    params = random_layer(rng, device)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        fp32 = dtype == torch.float32
        peak = roofline.TF32X3_FLOPS if fp32 else None
        for b in (32, STREAM_BATCH):
            x = torch.from_numpy(rng.normal(size=(b, SEQ, HIDDEN))
                                 .astype(np.float32)).to(device, dtype)
            lengths = rng.integers(1, SEQ + 1, size=b)
            mask = torch.from_numpy(
                (np.arange(SEQ)[None, :] < lengths[:, None])
                .astype(np.int32)).to(device)
            kernel, plain = (lambda f=f: f(params, x, mask, num_heads=HEADS)
                             for f in (fel.fused_encoder_layer,
                                       fel.fused_encoder_layer_plain))
            row = dict(
                max_abs_err=held(f"K1 {name} B={b}", [kernel()], [plain()],
                                 TOL[name], False),
                **timed(kernel), **timed(plain, "plain", **PLAIN),
                **timed(lambda: library_layer(params, x, mask, HEADS,
                                              (0.0, 0.0)), "library"),
                **bound(roofline.layer_forward_s, b, SEQ, HIDDEN, INNER,
                        name, peak=peak))
            rows[(name, b)] = row
            simt = bound(roofline.layer_forward_s, b, SEQ, HIDDEN, INNER,
                         name, peak=roofline.PEAK_FLOPS[name])["bound_ms"]
            print(f"fused_encoder_layer {name} B={b} S={SEQ} H={HIDDEN} "
                  f"N={HEADS} F={INNER}: {timing_text(row)}"
                  + (f"; bound at 165 TFLOP/s, 3xTF32; {simt:.5f} at 67 "
                     f"TFLOP/s without tensor cores" if fp32 else ""),
                  flush=True)
            print("  per launch of the kernel: " + device_breakdown(
                torch, kernel, only=TF32_LAYER if fp32 else None,
                forbid=SIMT_FP32_LAYER if fp32 else LEGACY_BF16_LAYER)[1],
                flush=True)
    return rows


# --------------------------------------------------------------------------- #
# phase 4: serving
# --------------------------------------------------------------------------- #

def write_artifact(path, rng):
    """An ml-1m_128 artifact in the JAX package's on-disk format: seeded
    numpy weights under the JAX npz keys and a synthetic vocab."""
    import numpy as np
    from bert4rec_tpu_torch.config import load_train_config
    from bert4rec_tpu_torch.models import BERT4RecModel, BERT4RecModelWrapper
    from bert4rec_tpu_torch.tokenizers import SimpleTokenizer
    from bert4rec_tpu_torch.utils import checkpoint

    config = load_train_config("ml-1m_128", vocab_size=VOCAB,
                               use_fused_layer=True)
    model = BERT4RecModel(config=config)
    flat = {}
    for key, leaf in checkpoint.flatten(model.init(device="meta")).items():
        noise = rng.normal(size=tuple(leaf.shape)).astype(np.float32)
        if key.endswith("/scale"):
            flat[key] = 1.0 + 0.1 * noise
        elif key == "mlm/output_bias":
            flat[key] = 0.5 * noise      # spreads the logits: no ties
        elif key.endswith("/bias"):
            flat[key] = 0.02 * noise
        else:
            flat[key] = 0.05 * noise
    tokenizer = SimpleTokenizer()
    tokenizer.tokenize(["[PAD]", "[MASK]", "[UNK]"])
    items = [f"movie_{i:04d}" for i in range(N_ITEMS)]
    tokenizer.tokenize(items)
    BERT4RecModelWrapper(model, checkpoint.unflatten(flat)).save(
        path, tokenizer=tokenizer, mode=2)
    return items


def plain_logits(model, params, batch):
    """The serving forward with every fused layer replaced by its plain
    version: the reference the served answers are held against."""
    from bert4rec_tpu_torch.models.components import layers as L
    from bert4rec_tpu_torch.ops.fused_encoder_layer import (
        fused_encoder_layer_plain,
    )
    cfg, enc = model.config, params["encoder"]
    x = L.embedding_lookup(enc["item_embeddings"], batch["input_word_ids"])
    x = x + L.position_embedding(enc["position_embeddings"],
                                 batch["input_word_ids"].shape[1])
    x = L.layer_norm(enc["embedding_norm"], x)
    for i in range(cfg.num_layers):
        x = fused_encoder_layer_plain(enc["layers"][f"layer_{i}"], x,
                                      batch["input_mask"],
                                      num_heads=cfg.num_attention_heads)
    return model.mlm_logits(params, x, batch["masked_lm_positions"])


def check_answers(torch, rec, histories, ks, answers, label):
    """Each answer against the plain path on the card: the masked-slot
    logits of the kernel path agree within LOGIT_TOL; a served id whose
    plain score is further than LOGIT_TOL from both neighbours equals the
    plain id at that rank, and every served id scores within LOGIT_TOL of
    the plain k-th best."""
    from bert4rec_tpu_torch.apps.recommender import build_exclusion_rows
    from bert4rec_tpu_torch.ops.sharded_topk import exclusion_bias
    tok = rec.dataloader.tokenizer
    with torch.inference_mode():
        feats = rec.dataloader.prepare_inference_batch(
            [list(h) for h in histories])
        batch = rec._batch(feats)
        kernel = rec.model.apply(rec.params, batch)["mlm_logits"][:, 0]
        plain = plain_logits(rec.model, rec.params, batch)[:, 0]
        if kernel.shape != (len(histories), VOCAB) \
                or not bool(torch.isfinite(kernel).all()):
            raise AssertionError(f"{label}: malformed logits")
        logit_err = float((kernel - plain).abs().max())
        if not logit_err <= LOGIT_TOL:
            raise AssertionError(f"{label}: masked-slot logits differ from "
                                 f"the plain path by {logit_err}")
        exclude = build_exclusion_rows(histories, tok,
                                       rec.model.special_token_ids)
        scored = plain + exclusion_bias(
            torch.from_numpy(exclude).to(plain.device), VOCAB)
        vals, ids = torch.topk(scored, max(ks) + 1, dim=-1)
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        scored = scored.cpu().numpy()
    exact = 0
    for i, (hist, k, got) in enumerate(zip(histories, ks, answers)):
        if len(got) != k:
            raise AssertionError(f"{label}: request {i} asked for {k} items,"
                                 f" got {len(got)}")
        got_ids = tok.tokenize(list(got))
        if set(got) & set(hist) or min(got_ids) < 3:
            raise AssertionError(f"{label}: request {i} was served a seen "
                                 f"item or a special token")
        for r in range(k):
            gap_before = math.inf if r == 0 else vals[i, r - 1] - vals[i, r]
            gap_after = vals[i, r] - vals[i, r + 1]
            if min(gap_before, gap_after) > LOGIT_TOL:
                if got_ids[r] != ids[i, r]:
                    raise AssertionError(
                        f"{label}: request {i} rank {r}: served "
                        f"{got_ids[r]}, plain path {ids[i, r]}")
                exact += 1
            if scored[i, got_ids[r]] < vals[i, k - 1] - LOGIT_TOL:
                raise AssertionError(f"{label}: request {i} rank {r} is not "
                                     f"in the plain top {k}")
    print(f"{label}: {len(histories)} answers agree with the plain path "
          f"(masked-slot logits max abs err {logit_err:.3g}, tol "
          f"{LOGIT_TOL}; {exact} ranks checked id for id)", flush=True)


def post(port, history, k):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/recommend",
        data=json.dumps({"history": history, "k": k}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}")
        return json.loads(resp.read())["items"]


def check_serving(torch, rng, device):
    from bert4rec_tpu_torch.apps import (
        Recommender, RecommenderService, ServingServer,
    )
    from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
    from bert4rec_tpu_torch.models import BERT4RecModelWrapper
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        items = write_artifact(tmp, rng)
        wrapper, extras = BERT4RecModelWrapper.load(tmp, mode=2,
                                                    device=device)
    cfg = wrapper.model.config
    dataloader = BERT4RecDataloader(
        max_seq_len=cfg.max_sequence_length,
        max_predictions_per_seq=cfg.max_predictions_per_seq,
        tokenizer=extras["tokenizer"])
    rec = Recommender(wrapper.model, wrapper.params, dataloader,
                      device=device)
    if not rec.model.encoder.fused_layer_routed(32, SEQ):
        raise AssertionError("ml-1m_128 is not routed to the fused layer")

    def history():
        n = int(rng.integers(1, 300))   # past 199 exercises the tail trim
        return [items[j] for j in rng.choice(N_ITEMS, size=n, replace=False)]

    histories = [history() for _ in range(N_REQUESTS)]
    ks = [int(k) for k in rng.integers(1, 11, size=N_REQUESTS)]

    service = RecommenderService(rec, max_k=10, batch_capacity=32,
                                 max_wait_ms=2.0)
    server = ServingServer(service, port=0).start()
    try:
        # one request first, so one-time library set-up on the card stays
        # out of the timed burst
        post(server.port, histories[0], ks[0])
        warm = service.stats
        fel.fused_encoder_layer.launches = 0
        fel.fused_encoder_layer.tf32_launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=N_REQUESTS) as pool:
            answers = list(pool.map(lambda a: post(server.port, *a),
                                    zip(histories, ks)))
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        launches = fel.fused_encoder_layer.launches
        tf32 = fel.fused_encoder_layer.tf32_launches
    finally:
        server.stop()
    batches = health["batches"] - warm["batches"]
    if health["requests"] - warm["requests"] != N_REQUESTS \
            or health["errors"] != 0:
        raise AssertionError(f"healthz: {health}")
    if not launches == tf32 == cfg.num_layers * batches:
        raise AssertionError(
            f"fused layer launched {launches} times ({tf32} on the 3xTF32 "
            f"kernels) for {batches} batches of {cfg.num_layers} layers")
    print(f"serving: {N_REQUESTS} concurrent HTTP requests in "
          f"{wall * 1e3:.1f} ms, {batches} batches (largest "
          f"{health['max_batch_observed']}), fused_encoder_layer launches "
          f"{launches} = {cfg.num_layers} layers x {batches} batches, all "
          f"on the 3xTF32 kernels",
          flush=True)
    check_answers(torch, rec, histories, ks, answers, "serving")

    # where one full serving batch spends its time: host clock around a
    # synchronised recommend_batch, beside the device time of its kernels
    batch = histories[:32]
    wall_ms = []
    for _ in range(6):
        t0 = time.perf_counter()
        rec.recommend_batch(batch, top_k=10)   # ends in a device->host copy
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"recommend_batch B=32: host wall {sorted(wall_ms)[3]:.3f} ms "
          f"(median of 6); " + device_breakdown(
              torch, lambda: rec.recommend_batch(batch, top_k=10))[1],
          flush=True)

    # the bulk path: recommend_stream over full 256-history batches
    stream = [[history() for _ in range(STREAM_BATCH)]
              for _ in range(STREAM_BATCHES)]
    fel.fused_encoder_layer.launches = 0
    fel.fused_encoder_layer.tf32_launches = 0
    results = list(rec.recommend_stream(stream, top_k=10))
    stream_launches = fel.fused_encoder_layer.launches
    if not stream_launches == fel.fused_encoder_layer.tf32_launches \
            == cfg.num_layers * STREAM_BATCHES:
        raise AssertionError(f"recommend_stream launched the fused layer "
                             f"{stream_launches} times ("
                             f"{fel.fused_encoder_layer.tf32_launches} on "
                             f"the 3xTF32 kernels)")
    print(f"recommend_stream: {STREAM_BATCHES} batches of {STREAM_BATCH}, "
          f"fused_encoder_layer launches {stream_launches}", flush=True)
    flat_hist = [h for b in stream for h in b]
    flat_ans = [a for r in results for a in r]
    check_answers(torch, rec, flat_hist, [10] * len(flat_hist), flat_ans,
                  "recommend_stream")
    return launches, stream_launches


# --------------------------------------------------------------------------- #
# phase 5: the training kernels' times
# --------------------------------------------------------------------------- #

RATES = (0.2, 0.5)        # ml-1m_128's attention / output dropout
N_ROWS = 256 * 40         # B x P masked rows of one train batch


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


# a row's kernel against its plain version on the inputs it times, at the
# card tests' limits: gradients relative to their scale (a bf16 sum-order
# difference flips a rounding of ds, dhpre or dattn); the loss (K3-K7) the
# same measure, its forwards (lse, the loss sum, per-row stats) only summed
# in another order; K11's outputs (bf16 roundings of g, u, dg, du flip)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_FWD_TOL = 1e-4
EXPERT_TOL = 1e-2


def held(label, got, want, tol, rel=True) -> float:
    """The kernel's outputs ``got`` against the plain version's ``want``
    (sequences of tensors), each within ``tol`` of its scale (``rel_err``)
    or, without ``rel``, in absolute terms; raises past it, or at a value
    that is not finite. Returns the largest absolute difference, the row's
    ``max_abs_err``."""
    errs = [(float((a.float() - c.float()).abs().max()), rel_err(a, c))
            for a, c in zip(got, want, strict=True)]
    if not all((r if rel else a) <= tol for a, r in errs):
        raise AssertionError(f"{label}: kernel against plain, (abs, rel) "
                             f"errs {errs}, tol {tol} "
                             f"{'relative' if rel else 'absolute'}")
    return max(a for a, _ in errs)


def library_loss(torch, h, t, b, lab) -> tuple:
    """``(forward, backward)``: the tied-softmax loss from library calls,
    the [R, V] logits by matmul then cross_entropy, and its autograd (a
    yardstick: it materialises the logits the kernels avoid; a negative
    label, the sharded loss's none or remote, counts as padding)."""
    import torch.nn.functional as F
    hl, tl, bl = (x.detach().requires_grad_(True) for x in (h, t, b))
    lab = lab.long().clamp(min=0)

    def forward():
        logits = torch.matmul(hl, tl.T).float() + bl
        return F.cross_entropy(logits, lab, ignore_index=0)

    loss = forward()
    return forward, lambda: torch.autograd.grad(loss, (hl, tl, bl),
                                                retain_graph=True)


def library_layer(params, x, mask, num_heads, rates, causal=False,
                  rel=None):
    """The layer from PyTorch library calls (torch.matmul,
    scaled_dot_product_attention with its own dropout on the
    probabilities, F.dropout on both outputs, layer_norm): a speed
    yardstick only; the port never calls it. With ``causal`` SDPA reads
    the pad mask plus the triangle as one additive mask ``[B, 1, S, S]``;
    a relative bias ``rel`` ``[B, N, S, S]`` joins that mask (which then
    requires grad where ``rel`` does)."""
    import torch
    import torch.nn.functional as F
    from bert4rec_tpu_torch.ops.fused_encoder_layer import (
        causal_bias, flat_weights,
    )
    flat = {k: v.to(x.dtype) for k, v in flat_weights(params).items()}
    b, s, h = x.shape
    qkv = torch.matmul(x, flat["wqkv"]) + flat["bqkv"]
    q, k, v = (t.view(b, s, num_heads, h // num_heads).transpose(1, 2)
               for t in qkv.split(h, dim=-1))
    bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    if causal:
        bias = bias + causal_bias(s, x.device)
    if rel is not None:
        bias = bias + rel
    bias = bias.to(x.dtype)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                         dropout_p=rates[0])
    ctx = ctx.transpose(1, 2).reshape(b, s, h)
    attn = F.dropout(torch.matmul(ctx, flat["wo"]) + flat["bo"], rates[1])
    x1 = F.layer_norm(x + attn, (h,), flat["g1"][0], flat["b1ln"][0],
                      eps=1e-12)
    hact = F.gelu(torch.matmul(x1, flat["w1"]) + flat["bf1"],
                  approximate="tanh")
    f = F.dropout(torch.matmul(hact, flat["w2"]) + flat["bf2"], rates[1])
    return F.layer_norm(x1 + f, (h,), flat["g2"][0], flat["b2ln"][0],
                        eps=1e-12)


def layer_rows(torch, flat, params, x, mask, dy, n, rates, seed, causal=False,
               rel=None, bare=False):
    """K1 with dropout (K1'' causal; with ``rel`` K1'' rel_bias) and its K2
    by the route the shape law gives: ``({"fwd": row, "bwd": row}, fwd,
    bwd)``, each row the kernel's, plain version's and library's times and
    the bound (fp32's at 3xTF32's 165 TFLOP/s); with ``bare``, ``bare_ms``
    too: the kernel without the triangle, or without the bias."""
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    from bert4rec_tpu_torch.utils.checkpoint import flatten, unflatten
    b, s, h = x.shape
    f = flat["w1"].shape[1]
    name = str(x.dtype).removeprefix("torch.")
    kw = dict(num_heads=n, attention_dropout=rates[0],
              output_dropout=rates[1], seed=seed, causal=causal)

    def fwd(causal=causal, rel=rel):
        return fel._launch_forward(flat, x, mask, n, seed, *rates, True,
                                   causal=causal, rel=rel)

    saved = {True: fwd()[1]}
    if bare:
        saved[False] = (fwd(False) if rel is None else fwd(rel=None))[1]

    def bwd(full=True):
        args = dict(causal=causal, rel=rel) if full else (
            dict(causal=False, rel=None) if rel is None
            else dict(causal=causal, rel=None))
        return fel._launch_backward(flat, x, mask, dy, saved[full], n, seed,
                                    *rates, **args)

    lflat = {k: v.detach().clone().requires_grad_(True)
             for k, v in flatten(params).items()}
    xl = x.detach().requires_grad_(True)
    rl = None if rel is None else rel.detach().clone().requires_grad_(True)
    y_lib = library_layer(unflatten(lflat), xl, mask, n, rates, causal, rl)
    leaves = [xl, *([] if rl is None else [rl]), *lflat.values()]
    peak = roofline.TF32X3_FLOPS if name == "float32" else None
    lost = unpaired(b, s, h, causal)
    extra = 0 if rel is None else rel.numel() * 4
    label = f"layer {name} B={b} S={s} H={h} F={f} causal={causal} rates " \
        f"{rates} rel={rel is not None}"
    ref_dx, ref_g = fel.fused_encoder_layer_plain_backward(
        flat, x, mask, dy, rel_bias=rel, **kw)
    dx, grads = bwd()
    errs = dict(fwd=held(label, [fwd()[0]], [fel.fused_encoder_layer_plain(
                    params, x, mask, rel_bias=rel, **kw)], TOL[name], False),
                bwd=held(label, [dx, *grads.values()],
                         [ref_dx, *(ref_g[k] for k in grads)],
                         GRAD_TOL[name]))
    del ref_dx, ref_g, dx, grads
    rows = dict(
        fwd=dict(max_abs_err=errs["fwd"], **timed(fwd),
                 **timed(lambda: fel.fused_encoder_layer_plain(
                     params, x, mask, rel_bias=rel, **kw), "plain", **PLAIN),
                 **timed(lambda: library_layer(
                     params, x, mask, n, rates, causal, rel), "library"),
                 **bound(roofline.layer_forward_s, b, s, h, f, name,
                         peak=peak, extra_flops=-4 * lost,
                         extra_bytes=extra)),
        bwd=dict(max_abs_err=errs["bwd"], **timed(bwd),
                 **timed(lambda: fel.fused_encoder_layer_plain_backward(
                     flat, x, mask, dy, rel_bias=rel, **kw), "plain",
                     **PLAIN),
                 **timed(lambda: torch.autograd.grad(
                     y_lib, leaves, dy, retain_graph=True), "library"),
                 **bound(roofline.layer_backward_s, b, s, h, f, name,
                         peak=peak, extra_flops=-8 * lost,
                         extra_bytes=2 * extra)))
    if bare:
        rows["fwd"]["bare_ms"] = time_device_ms(
            lambda: fwd(False) if rel is None else fwd(rel=None))[0]
        rows["bwd"]["bare_ms"] = time_device_ms(lambda: bwd(False))[0]
    del y_lib, leaves, lflat, xl, rl
    return rows, fwd, bwd


def check_layer_training(torch, rng, device, h=HIDDEN, n=HEADS, f=INNER,
                         rates=RATES, cases=None, seq=SEQ, trace=True,
                         causal=False):
    """``layer_rows`` at width ``h`` (``n`` heads, inner ``f``), length
    ``seq``, for each (dtype, batch) of ``cases`` (default fp32 and bf16 at
    B=256), fp32's bound at 67 TFLOP/s beside; at B=256 each launch's
    kernels by device time (``trace``), none off the route."""
    import numpy as np
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    params = random_layer(rng, device, h, n, f)
    flat = fel.flat_weights(params)
    rows = {}
    cases = cases or [(dt, STREAM_BATCH)
                      for dt in (torch.float32, torch.bfloat16)]
    for dtype, b in cases:
        name = str(dtype).removeprefix("torch.")
        x, dy = (torch.from_numpy(rng.normal(size=(b, seq, h))
                                  .astype(np.float32)).to(device, dtype)
                 for _ in range(2))
        lengths = rng.integers(1, seq + 1, size=b)
        mask = torch.from_numpy(
            (np.arange(seq)[None, :] < lengths[:, None])
            .astype(np.int32)).to(device)
        row, fwd, bwd = layer_rows(torch, flat, params, x, mask, dy, n,
                                   rates, 4242, causal)
        rows[(name, b)] = row
        lost = unpaired(b, seq, h, causal)
        simt = dict(fwd=bound(roofline.layer_forward_s, b, seq, h, f, name,
                              peak=roofline.PEAK_FLOPS[name],
                              extra_flops=-4 * lost),
                    bwd=bound(roofline.layer_backward_s, b, seq, h, f, name,
                              peak=roofline.PEAK_FLOPS[name],
                              extra_flops=-8 * lost))
        for part, r in row.items():
            print(f"fused_encoder_layer {part} dropout {rates} {name} "
                  + ("causal " if causal else "")
                  + f"route {fel.kernel_route(dtype, b, h, n, f)} "
                  f"B={b} S={seq} H={h} N={n} F={f}: {timing_text(r)}"
                  + (f"; bound at 3xTF32's 165 TFLOP/s, "
                     f"{simt[part]['bound_ms']:.5f} at 67 without tensor "
                     f"cores" if name == "float32" else ""), flush=True)
        if b == STREAM_BATCH and trace:
            fp32 = name == "float32"
            forbid = SIMT_FP32_LAYER if fp32 else LEGACY_BF16_LAYER
            print("  per forward launch: " + device_breakdown(
                torch, fwd, top=8, forbid=forbid,
                only=TF32_LAYER if fp32 else None)[1], flush=True)
            print("  per backward launch: " + device_breakdown(
                torch, bwd, top=10, forbid=forbid,
                only=TF32_LAYER_BWD if fp32 else None)[1], flush=True)
    return rows


CAUSAL_RATES = (0.1, 0.1)  # ml-20m_128's attention / output dropout


def causal_inputs(torch, rng, device, dtype, b=STREAM_BATCH):
    """x, an int32 mask with row 0 unpadded, row 1 of length 1 and row 2
    all padding (the rest random right-padded lengths), and dy."""
    import numpy as np
    lengths = rng.integers(1, SEQ + 1, size=b)
    lengths[:3] = [SEQ, 1, 0]
    mask = torch.from_numpy((np.arange(SEQ)[None, :] < lengths[:, None])
                            .astype(np.int32)).to(device)
    x, dy = (torch.from_numpy(rng.normal(size=(b, SEQ, HIDDEN))
                              .astype(np.float32)).to(device, dtype)
             for _ in range(2))
    return x, mask, dy


def check_masked_layer(torch, rng, device, rel=False):
    """``layer_rows`` for K1'' causal at the SASRec train shape (B=256,
    S=200, H=128), dropout off and at ml-20m_128's rates, the bidirectional
    kernels beside; with ``rel`` K1'' rel_bias and K2 dRel at the temporal
    one (a relative bias ~ N(0, 1), counted as bytes in the bound), at
    those rates, causal or not, the bias-free kernels beside. fp32 and
    bf16, an all-pad and a length-1 row; bf16's launches at ml-20m_128's
    rates (rel_bias: bidirectional) by device time, none on the earlier
    kernels. Rows by (dtype, rates), with ``rel`` by (dtype, causal)."""
    import numpy as np
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    params = random_layer(rng, device)
    flat = fel.flat_weights(params)
    cases = ([(CAUSAL_RATES, False), (CAUSAL_RATES, True)] if rel
             else [((0.0, 0.0), True), (CAUSAL_RATES, True)])
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for rates, causal in cases:
            x, mask, dy = causal_inputs(torch, rng, device, dtype)
            bias = torch.from_numpy(
                rng.normal(size=(STREAM_BATCH, HEADS, SEQ, SEQ)).astype(
                    np.float32)).to(device) if rel else None
            row, fwd, bwd = layer_rows(torch, flat, params, x, mask, dy,
                                       HEADS, rates, 4243 if rel else 4242,
                                       causal, bias, bare=True)
            rows[(name, causal if rel else rates)] = row
            kind = f"rel_bias causal={causal}" if rel else "causal"
            for part, r in row.items():
                print(f"fused_encoder_layer {kind} {part} dropout {rates} "
                      f"{name} B={STREAM_BATCH} S={SEQ} H={HIDDEN} (all-pad "
                      f"row, length-1 row): {timing_text(r)}; "
                      f"{'bias_free' if rel else 'bidirectional'}_ms="
                      f"{r['bare_ms']:.4f}", flush=True)
            if name == "bfloat16" and rates == CAUSAL_RATES \
                    and not (rel and causal):
                for part, fn in (("forward", fwd), ("backward", bwd)):
                    print(f"  per {kind} {part} launch: " + device_breakdown(
                        torch, fn, forbid=LEGACY_BF16_LAYER)[1], flush=True)
            del bias, fwd, bwd
            torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------- #
# phase 6: training through BERT4RecTrainer.train()
# --------------------------------------------------------------------------- #

TRAIN_STEPS = 24
STEP_TOL = {"loss": 2e-3, "metric": 0.0, "grad": 5e-2}


def make_batch(seed, batch=STREAM_BATCH, npred=40, seq=SEQ, vocab=None):
    """One ML-1M-shaped train batch (``bench.py``'s ``make_batch`` law):
    random item ids (of ``vocab``, default ML-1M's), no padding, ``npred``
    distinct sorted masked positions."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab or VOCAB, size=(batch, seq)).astype(np.int32)
    positions = np.stack([np.sort(rng.choice(seq, size=npred, replace=False))
                          for _ in range(batch)]).astype(np.int32)
    return {"input_word_ids": ids,
            "input_mask": np.ones((batch, seq), np.int32),
            "masked_lm_positions": positions,
            "masked_lm_ids": np.take_along_axis(ids, positions, axis=1),
            "masked_lm_weights": np.ones((batch, npred), np.int32)}


class SyntheticDataset:
    """In-memory batches with the dataset contract ``train()`` reads."""

    def __init__(self, n_batches, seed=0, repeat=False, **shape):
        self.n_batches, self.seed, self.repeat = n_batches, seed, repeat
        self.shape = shape   # make_batch's npred and seq

    def batches(self, batch_size, shuffle=True, seed=None,
                drop_remainder=False, pad_final_batch=False):
        base = self.seed + 1000 * (seed or 0)
        for i in range(self.n_batches):
            yield make_batch(self.seed if self.repeat else base + i,
                             batch_size, **self.shape)


# the temporal family's switches (recency embeddings, relative-time bias)
TEMPORAL_FLAGS = dict(use_temporal_embeddings=True,
                      use_temporal_attention=True)


def new_trainer(torch, device, params=None, lr=1e-4, warmup=100,
                config_name="ml-1m_128", vocab=VOCAB, family="bert4rec",
                fp32=False):
    """A trainer of the ``family`` model (``bert4rec``, ``sasrec`` or
    ``temporal``: BERT4Rec with both temporal flags) on ``config_name``
    with the fused layer and loss, bf16 compute (``fp32``: fp32, JAX's
    default policy)."""
    from bert4rec_tpu_torch.config import load_train_config
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.models import BERT4RecModel, SASRecModel
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
    config = load_train_config(
        config_name, vocab_size=vocab, use_fused_layer=True,
        use_fused_loss=True,
        **(TEMPORAL_FLAGS if family == "temporal" else {}))
    model_cls = {"bert4rec": BERT4RecModel, "sasrec": SASRecModel,
                 "temporal": BERT4RecModel}[family]
    policy = DTypePolicy.f32() if fp32 else DTypePolicy.bf16()
    model = model_cls(config=config, dtype_policy=policy)
    trainer = BERT4RecTrainer(model)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=lr, num_warmup_steps=warmup), params=params, seed=SEED,
        device=device)
    return trainer


def train_counts(reset=False) -> dict:
    """The launch counters a counted ``train()`` is held to, by kernel:
    the layer's by route and variant, K3 / K4 (the whole-table loss), K5,
    K6, K7 (the tiled one), K10 and K12; ``reset`` sets them to 0 first."""
    from bert4rec_tpu_torch.ops import adamw
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    from bert4rec_tpu_torch.ops import table_gradient as tg
    layer, loss = fel.fused_encoder_layer, fml.fused_mlm_loss
    tiled = fml.fused_mlm_loss_tiled
    names = {f"{kind}_{part}": (layer, f"{prefix}{attr}")
             for kind, prefix in (("layer", ""), ("causal", "causal_"),
                                  ("rel", "rel_"), ("mma_sync", "mma_sync_"),
                                  ("tf32", "tf32_"))
             for part, attr in (("fwd", "launches"),
                                ("bwd", "backward_launches"))}
    names.update(K3=(loss, "launches"), K4=(loss, "backward_launches"),
                 K5=(tiled, "launches"), K6=(tiled, "merged_launches"),
                 K7=(tiled, "two_sweep_launches"),
                 K10=(tg.table_gradient, "launches"),
                 K12=(adamw.adamw_update, "launches"))
    if reset:
        for owner, attr in names.values():
            setattr(owner, attr, 0)
    return {k: getattr(owner, attr) for k, (owner, attr) in names.items()}


def check_step_parity(torch, trainer, batch, label):
    """One train step on the kernels against the same step on the plain
    versions (dropout on, the same seeds), under PERF.md's train-step
    rule: loss within 2e-3 relative, both metrics within one hit, every
    gradient within 5e-2 of its own scale."""
    from contextlib import ExitStack
    loss_k, logs_k, grads_k = trainer._grads(batch, 99)
    with ExitStack() as stack:
        for patch in plain_kernels():
            stack.enter_context(patch)
        loss_p, logs_p, grads_p = trainer._grads(batch, 99)
    torch.cuda.synchronize()
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    metric_err = max(abs(float(logs_k[k]) - float(logs_p[k]))
                     for k in logs_k)
    grad_err = {k: rel_err(grads_k[k], grads_p[k]) for k in grads_k
                if float(grads_p[k].abs().max()) > 0}
    worst = max(grad_err, key=grad_err.get)
    dtype = trainer.model.dtype_policy.compute_dtype
    print(f"train step, kernels vs plain ({label}, "
          f"{str(dtype).removeprefix('torch.')}): loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f} (rel {loss_err:.3g},"
          f" tol {STEP_TOL['loss']}), metrics max diff {metric_err:.3g}, "
          f"{len(grad_err)} grads max rel err {grad_err[worst]:.3g} at "
          f"{worst} (tol {STEP_TOL['grad']})", flush=True)
    if not (loss_err <= STEP_TOL["loss"] and grad_err[worst]
            <= STEP_TOL["grad"]
            and metric_err <= 2.0 / float(trainer._counts(batch)["_n_valid"])):
        raise AssertionError(f"the kernel step disagrees with the plain step "
                             f"({label})")


def harness_ml1m_trainer(torch, device, params=None, lr=1e-4, warmup=100):
    """A trainer of the quality harness's ml1m preset, the model built as
    the harness builds it: ``BERT4RecConfig`` at hidden 128, 2 layers, 4
    heads, inner 512, S=200, P=40, V=3,709 with the fused layer and loss,
    and no dtype policy (fp32, JAX's default; dropout the config's 0.1 /
    0.1)."""
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
    model = BERT4RecModel(config=BERT4RecConfig(
        vocab_size=VOCAB, max_sequence_length=SEQ, max_predictions_per_seq=40,
        hidden_size=HIDDEN, num_layers=2, num_attention_heads=HEADS,
        inner_dim=INNER, use_fused_layer=True, use_fused_loss=True))
    trainer = BERT4RecTrainer(model)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=lr, num_warmup_steps=warmup), params=params, seed=SEED,
        device=device)
    return trainer


def check_training(torch, device, new=None, label="ml-1m_128"):
    """Phase 6's checks on the trainers ``new(params=..., lr=...,
    warmup=...)`` makes (default: ml-1m_128 in bf16): the kernel step
    against the plain step, the launch counts of a ``train()`` run, the
    step time, ``train()``'s idle share and a device breakdown, the loss
    falling on a repeated batch, and an exact resume."""
    from bert4rec_tpu_torch.utils.checkpoint import flatten

    new = new or (lambda **kw: new_trainer(torch, device, **kw))
    trainer = new()
    fp32 = trainer.model.dtype_policy.compute_dtype == torch.float32
    cfg = trainer.model.config
    if not trainer.model.encoder.fused_layer_routed(
            STREAM_BATCH, SEQ, dropout_active=True, device=device):
        raise AssertionError("training is not routed to the fused layer")
    init = {k: v.detach().clone() for k, v in
            flatten(trainer.state["params"]).items()}

    # 2. one step on the kernels against the same step on the plain
    #    versions, dropout on, the same seeds
    batch = trainer._put_batch(make_batch(7))
    check_step_parity(torch, trainer, batch,
                      f"{label}, dropout "
                      f"{(cfg.attention_dropout, cfg.output_dropout)}")

    # the main path: BERT4RecTrainer.train() for TRAIN_STEPS steps
    train_counts(reset=True)
    t0 = time.perf_counter()
    hist = trainer.train(SyntheticDataset(TRAIN_STEPS, seed=1), epochs=1,
                         batch_size=STREAM_BATCH, seed=SEED, verbose=False)
    wall = time.perf_counter() - t0
    counts = train_counts()
    # fp32: every layer launch, forward and backward, on the 3xTF32 route
    layer_steps = cfg.num_layers * TRAIN_STEPS
    want = dict.fromkeys(counts, 0)
    want.update(layer_fwd=layer_steps, layer_bwd=layer_steps, K3=TRAIN_STEPS,
                K4=TRAIN_STEPS, K10=TRAIN_STEPS, K12=3 * TRAIN_STEPS,
                tf32_fwd=layer_steps if fp32 else 0,
                tf32_bwd=layer_steps if fp32 else 0)
    loss = hist.history["loss"][0]
    print(f"{label} train(): {TRAIN_STEPS} steps of B={STREAM_BATCH} in "
          f"{wall:.2f} s (first step included), epoch loss {loss:.4f}, "
          f"masked_accuracy {hist.history['masked_accuracy'][0]:.4f}; "
          f"launches {nonzero(counts)}", flush=True)
    if counts != want or trainer.state["step"] != TRAIN_STEPS \
            or not math.isfinite(loss):
        raise AssertionError(f"launches {counts}, expected {want}; step "
                             f"{trainer.state['step']}")
    moved = max(float((v.detach() - init[k]).abs().max())
                for k, v in flatten(trainer.state["params"]).items())
    if not moved > 0:
        raise AssertionError("train() did not move the params")

    # step time on the card: host clock around synchronised steps
    step_ms = []
    for i in range(10):
        b = trainer._put_batch(make_batch(100 + i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    median = sorted(step_ms)[len(step_ms) // 2]
    # train() again, warm: its wall per step against one step's device time
    t0 = time.perf_counter()
    trainer.train(SyntheticDataset(TRAIN_STEPS, seed=2), epochs=1,
                  batch_size=STREAM_BATCH, seed=SEED + 1, verbose=False)
    train_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    device_ms, breakdown = device_breakdown(
        torch, lambda: trainer.train_step(batch), calls=3, top=8,
        forbid=SIMT_FP32_STEP if fp32 else LEGACY_BF16_LAYER)
    idle = None if device_ms is None else 1 - device_ms / train_ms
    print(f"{label} train step B={STREAM_BATCH}: median {median:.3f} ms of "
          f"10 (min {min(step_ms):.3f}), {STREAM_BATCH / median * 1e3:.1f} "
          f"examples/s; train() {train_ms:.3f} ms per step over "
          f"{TRAIN_STEPS}; device idle share of train() "
          + ("not measured" if idle is None else f"{idle:.3f}"), flush=True)
    print(f"  one {label} train step: " + breakdown, flush=True)

    # 3. the loss falls on one repeated batch at a raised learning rate
    probe = make_batch(3)
    start = new(params=init)
    before = float(start.eval_step(start._put_batch(probe))["loss"])
    fast = new(params=init, lr=1e-3, warmup=0)
    fast.train(SyntheticDataset(12, seed=3, repeat=True), epochs=1,
               batch_size=STREAM_BATCH, seed=SEED, verbose=False)
    after = float(fast.eval_step(fast._put_batch(probe))["loss"])
    print(f"{label} repeated batch, lr 1e-3, 12 steps: eval loss "
          f"{before:.4f} -> {after:.4f}", flush=True)
    if not after < 0.99 * before:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{before} -> {after}")

    # 4. train() with a checkpoint, then a new trainer that auto-resumes
    #    from it and continues, equals the uninterrupted run
    ds, val = SyntheticDataset(3, seed=5), SyntheticDataset(1, seed=6)
    whole = new(params=init)
    whole.train(ds, epochs=2, batch_size=STREAM_BATCH, seed=SEED,
                verbose=False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        path = f"{tmp}/state.npz"
        first = new(params=init)
        first.train(ds, val, checkpoint_path=path, epochs=1,
                    batch_size=STREAM_BATCH, seed=SEED, verbose=False)
        resumed = new(params=init)
        resumed.train(ds, val, checkpoint_path=path, epochs=2,
                      batch_size=STREAM_BATCH, seed=SEED, verbose=False)
    fa = flatten(whole.state["params"])
    fb = flatten(resumed.state["params"])
    if not (all(torch.equal(fa[k], fb[k]) for k in fa)
            and whole.state["step"] == resumed.state["step"] == 6):
        diff = max(float((fa[k] - fb[k]).abs().max()) for k in fa)
        raise AssertionError(f"resume is not exact: steps "
                             f"{whole.state['step']} / "
                             f"{resumed.state['step']}, max param diff {diff}")
    print(f"{label} resume: checkpoint after epoch 1 (step 3), a new "
          f"trainer resumed and ran epoch 2: params after step "
          f"{resumed.state['step']} equal the uninterrupted run's bit for "
          f"bit", flush=True)
    return dict(counts=counts, step_ms=median, train_ms=train_ms,
                device_ms=device_ms, idle=idle)


# --------------------------------------------------------------------------- #
# phase 7: the ML-20M host pipeline
# --------------------------------------------------------------------------- #

ML20M_USERS = 20_000      # a cut in users only: the catalog stays whole
ML20M_VOCAB = 26_732      # 26,729 movies + [PAD], [MASK], [UNK]
PIPELINE_BATCHES = 200


def check_pipeline(home):
    """Write the corpus into ``home`` (the ``BERT4REC_TPU_HOME`` set before
    the port was imported) and load it as a user would:
    ``create_ml_20m_dataloader(input_duplication_factor=5)
    .prepare_training(finetuning_split=0.1)`` under a record cap that
    covers every rating (the size gate's existence-only mode). The cap
    stays set for every later load of the corpus (the SASRec pipeline, the
    evaluator's item list): without it the size gate would not accept the
    synthetic corpus."""
    import pathlib
    import numpy as np
    from bert4rec_tpu_torch import datasets
    from bert4rec_tpu_torch.dataloaders import (
        get_dataloader_factory, processed_dataset,
    )
    from bert4rec_tpu_torch.datasets.synthetic import write_ml20m_corpus
    if pathlib.Path(datasets.ML20M.dest) != \
            pathlib.Path(home) / "data" / "ml-20m":
        raise AssertionError(f"ML20M reads {datasets.ML20M.dest}, not the "
                             f"corpus home {home}")
    t0 = time.perf_counter()
    n_ratings = write_ml20m_corpus(home, seed=SEED, n_users=ML20M_USERS)
    write_s = time.perf_counter() - t0
    os.environ["BERT4REC_TPU_LOAD_N_RECORDS"] = str(n_ratings)
    t0 = time.perf_counter()
    loader = get_dataloader_factory().create_ml_20m_dataloader(
        input_duplication_factor=5)
    splits = loader.prepare_training(finetuning_split=0.1)
    prep_s = time.perf_counter() - t0
    vocab = loader.tokenizer.get_vocab_size()
    native_on = processed_dataset._use_native()
    t0 = time.perf_counter()
    n = 0
    for batch in splits[0].batches(STREAM_BATCH, seed=0,
                                   drop_remainder=True):
        if n == 0:
            first = batch
        n += 1
        if n == PIPELINE_BATCHES:
            break
    rate = n / (time.perf_counter() - t0)
    print(f"pipeline: ML-20M-format corpus, {ML20M_USERS} users, {n_ratings} "
          f"ratings over the 26,729-movie catalog, written in {write_s:.2f} "
          f"s; prepare_training(finetuning_split=0.1) at "
          f"input_duplication_factor=5: {prep_s:.2f} s of host time; vocab "
          f"{vocab}; sequences train {len(splits[0])} / val {len(splits[1])}"
          f" / test {len(splits[2])}; native masking engine in use: "
          f"{native_on}; batches({STREAM_BATCH}): {rate:.1f} batches/s "
          f"({rate * STREAM_BATCH:.0f} examples/s, {n} batches)", flush=True)
    if vocab != ML20M_VOCAB or not native_on:
        raise AssertionError(f"vocab {vocab} (expected {ML20M_VOCAB}), "
                             f"native engine {native_on}")
    shapes = {k: (v.shape, v.dtype) for k, v in first.items()}
    if shapes["input_word_ids"] != ((STREAM_BATCH, SEQ), np.int32) or \
            shapes["masked_lm_ids"] != ((STREAM_BATCH, 40), np.int32) or \
            int(first["masked_lm_ids"].max()) >= vocab:
        raise AssertionError(f"malformed batch: {shapes}")
    return loader, splits, dict(prepare_s=prep_s, batches_per_s=rate)


# --------------------------------------------------------------------------- #
# phase 8: the vocab-tiled loss kernels K5, K6, K7
# --------------------------------------------------------------------------- #

REDDIT_VOCAB, REDDIT_ROWS = 335_424, 2048   # rows cut so the plain fits
# the plain versions run in row chunks where [R, V] is larger than this
PLAIN_ELEMS = REDDIT_ROWS * REDDIT_VOCAB


def plain_tiled(torch, fml, h, t, b, lab):
    """Callables of the plain versions over row chunks whose [rows, V]
    logits hold at most PLAIN_ELEMS elements: ``forward()`` -> ``(lse,
    sums)``, ``stats()`` -> ``(m, s, ll)`` and ``backward(lse, g, n_valid,
    **kw)`` -> ``(dh, dt, db)``; per-row outputs concatenated, the sums, dt
    and db summed over the chunks (one chunk: the plain versions as they
    are)."""
    step = max(1, PLAIN_ELEMS // t.shape[0])
    chunks = [slice(i, i + step) for i in range(0, h.shape[0], step)]

    def forward():
        parts = [fml.fused_mlm_loss_plain_forward(h[c], t, b, lab[c])
                 for c in chunks]
        return (torch.cat([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]).sum(dim=0))

    def stats():
        parts = [fml.fused_mlm_loss_plain_stats(h[c], t, b, lab[c])
                 for c in chunks]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))

    def backward(lse, g, n_valid, **kw):
        parts = [fml.fused_mlm_loss_plain_backward(
            h[c], t, b, lab[c], lse[c], g, n_valid, **kw) for c in chunks]
        return (torch.cat([p[0] for p in parts]),
                sum(p[1] for p in parts), sum(p[2] for p in parts))

    return forward, stats, backward


def tiled_operands(torch, rng, device, rows, v, w, dtype):
    """hidden [rows, w], the table at the hidden dtype, the masked bias and
    int32 labels (every 9th row 0)."""
    import numpy as np
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    hidden = torch.from_numpy(rng.normal(size=(rows, w)).astype(np.float32)) \
        .to(device, dtype)
    table = torch.from_numpy((rng.normal(size=(v, w)) * 0.1)
                             .astype(np.float32)).to(device, dtype)
    bias = torch.from_numpy(rng.normal(size=v).astype(np.float32)).to(device)
    lab = rng.integers(3, v, size=rows).astype(np.int32)
    lab[::9] = 0
    return hidden, table, fml._mask_bias(bias, v), \
        torch.from_numpy(lab).to(device)


def check_loss_case(torch, rng, device, r, v, w, dtype, kernels,
                    trace=True):
    """The loss kernels at R=``r``, V=``v``, W=``w`` in ``dtype``: K3 and
    K4 (``kernels`` {"K4": None}), or K5 (loss and stats entries) and the
    backward ``kernels`` ({name: merged}: K6 True, K7 False). Kernel, plain
    and library times and the bound (fp32's at 3xTF32's 165 TFLOP/s, 67
    beside it), and each launch's kernels by device time (``trace``), only
    those of its route. Returns {kernel: row}."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    name = str(dtype).removeprefix("torch.")
    reddit = v == REDDIT_VOCAB
    whole = "K4" in kernels
    h, t, b, lab = tiled_operands(torch, rng, device, r, v, w, dtype)
    g = torch.ones((), device=device)
    if whole:
        fwd = lambda: fml._launch_forward(h, t, b, lab)  # noqa: E731
    else:
        fwd = lambda: fml._launch_forward_tiled(h, t, b, lab)  # noqa: E731
    lse, sums = fwd()
    stats_fn = lambda: fml._launch_forward_tiled_stats(  # noqa: E731
        h, t, b, lab)
    bwd = {k: (lambda m=m: fml._launch_backward(
        h, t, b, lab, lse, g, sums[3:4]) if whole
        else fml._launch_backward_tiled(h, t, b, lab, lse, g, sums[3:4], m))
        for k, m in kernels.items()}
    plain_fwd, plain_stats, plain_bwd_fn = plain_tiled(torch, fml, h, t,
                                                       b, lab)
    label = f"loss {name} R={r} V={v} W={w}"
    fk = "K3" if whole else "K5"
    rlse, rsums = plain_fwd()
    held(label + " counts", [sums[1:]], [rsums[1:]], 0.0, False)
    errs = {fk: held(label, [lse, sums[:1]] + ([] if whole else [
        *stats_fn()]), [rlse, rsums[:1]] + ([] if whole else [
            *plain_stats()]), LOSS_FWD_TOL)}
    del rlse, rsums
    ref = plain_bwd_fn(lse, g, sums[3])
    errs.update({k: held(f"{label} {k}", f(), ref, LOSS_TOL[name])
                 for k, f in bwd.items()})
    del ref
    lib_fwd, lib_bwd_fn = library_loss(torch, h, t, b, lab)
    # K5-K7 in blocks of 3 calls for fp32, 5 otherwise
    heavy = dtype == torch.float32
    it = dict(iters=3, warmup=1) if heavy and not whole else {}
    # fp32 runs 3xTF32: the bound at its rate, and at fp32's without
    # tensor cores beside it
    peak = roofline.TF32X3_FLOPS if heavy else None
    row = {fk: dict(max_abs_err=errs[fk], **timed(fwd, **it),
                    **timed(plain_fwd, "plain", **PLAIN),
                    **timed(lib_fwd, "library", **it),
                    **bound(roofline.loss_s, r, v, w, False, name,
                            peak=peak))}
    plain_bwd = timed(lambda: plain_bwd_fn(lse, g, sums[3]), "plain",
                      **PLAIN)
    lib_bwd = timed(lib_bwd_fn, "library", **it)
    for k, f in bwd.items():
        row[k] = dict(max_abs_err=errs[k], **timed(f, **it), **plain_bwd,
                      **lib_bwd,
                      **bound(roofline.loss_s, r, v, w, True, name,
                              peak=peak))
    for k, x in row.items():
        fp32_bound = bound(roofline.loss_s, r, v, w, k != fk,
                           name)["bound_ms"]
        print(f"{'' if whole else 'tiled '}loss {k} {name} R={r} V={v} "
              f"W={w}: {timing_text(x)}"
              + (f"; bound at 67 TFLOP/s {fp32_bound:.5f}" if heavy else "")
              + f"; {x['bound_ms'] / x['ms']:.1%} of the bound, "
              f"{x['ms'] / x['library_ms']:.3f}x the library", flush=True)
    # each launch's kernels: K4's and K7's two sweeps apart, at each W; K3's
    # and K5's (both entries) only its sweep, merge and row sums; fp32's
    # only loss_tf32.cuh's
    launches = [(fk, fwd)] + ([] if whole else [("K5 stats", stats_fn)])
    if not trace:
        launches = []
    elif not (reddit and not heavy):
        launches += list(bwd.items())
    for k, f in launches:
        only = (FP32_LOSS_KERNELS if heavy
                else BF16_LOSS_KERNELS).get(k[:2])
        print(f"  per {k} launch: " + device_breakdown(
            torch, f, only=only)[1], flush=True)
    del lib_fwd, lib_bwd_fn, h, t, b
    torch.cuda.empty_cache()
    return row


def check_tiled_loss_kernels(torch, rng, device):
    """K5 (loss and stats entries), K6 and K7 at one ML-20M train batch
    (R=10,240, V=26,732; W=128 and 256; fp32 and bf16), K5 + K6 at
    Reddit's vocabulary (V=335,424, W=128) at R=2,048 (fp32 and bf16) and
    at the Reddit preset's R=10,240 (fp32; the plain versions in row
    chunks)."""
    cases = [(N_ROWS, ML20M_VOCAB, w, dt) for w in (128, 256)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(REDDIT_ROWS, REDDIT_VOCAB, 128, dt)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(N_ROWS, REDDIT_VOCAB, 128, torch.float32)]
    rows = {}
    for r, v, w, dtype in cases:
        name = str(dtype).removeprefix("torch.")
        kernels = ({"K6": True} if v == REDDIT_VOCAB
                   else {"K6": True, "K7": False})
        rows[(name, r, v, w)] = check_loss_case(torch, rng, device, r, v, w,
                                                 dtype, kernels)
    return rows


# --------------------------------------------------------------------------- #
# phase 9: ML-20M training through BERT4RecTrainer.train()
# --------------------------------------------------------------------------- #

ML20M_STEPS = 12
# train() timed warm over enough steps that the epoch's first masking chunk
# (64 batches masked before the first is yielded) is a small share
ML20M_TIMED_STEPS = 48
TEMPORAL_TIMED_STEPS = 24   # phase 16: fewer, to keep the run's time


class FixedBatches:
    """The dataset contract ``train()`` reads, over given host batches."""

    def __init__(self, batches):
        self.host = list(batches)

    def batches(self, batch_size, shuffle=True, seed=None,
                drop_remainder=False, pad_final_batch=False):
        yield from self.host


def check_ml20m_training(torch, device, loader, splits, config_name,
                         family="bert4rec", timed_steps=ML20M_TIMED_STEPS,
                         fp32=False):
    """``train()`` on ml-20m_128 (backward K6) or ml-20m_256 (K7) from the
    pipeline's datasets: B=256, bf16 (``fp32``: fp32), fused layer and
    loss, full width and depth; ``family="sasrec"`` trains SASRecModel (the
    causal layer kernels) from the ``"sasrec"`` preprocessor's datasets,
    and ``family="temporal"`` the temporal BERT4Rec (the relative-bias
    layer kernels) from the ``"bert4rec_temporal"`` preprocessor's. Returns
    the launch counts of the counted run, the trainer and the host batches
    it drew; with ``timed_steps`` (none at bf16 ml-20m_128, which the
    benchmark times) the step times, idle share and breakdown print."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    from bert4rec_tpu_torch.utils.checkpoint import flatten
    train_ds, val_ds, _ = splits
    vocab = loader.tokenizer.get_vocab_size()
    trainer = new_trainer(torch, device, config_name=config_name, vocab=vocab,
                          family=family, fp32=fp32)
    label = config_name if family == "bert4rec" else \
        f"{family} {config_name}"
    if fp32:
        label = f"fp32 {label}"
    causal = family == "sasrec"
    cfg = trainer.model.config
    if cfg.causal_attention != causal or train_ds.task != (
            "next_item" if causal else "mlm"):
        raise AssertionError(f"{label}: causal {cfg.causal_attention}, task "
                             f"{train_ds.task}")
    rows = STREAM_BATCH * cfg.max_predictions_per_seq
    kernel = "K6" if fml.merged_backward(rows, cfg.table_width) else "K7"
    if not (trainer.model.encoder.fused_layer_routed(
            STREAM_BATCH, SEQ, dropout_active=True, device=device)
            and not fml.fused_loss_supported(cfg.padded_vocab_size,
                                             cfg.table_width)
            and kernel == {"ml-20m_128": "K6", "ml-20m_256": "K7"}[
                config_name]):
        raise AssertionError(f"{label} is not routed to the fused "
                             f"layer, K5 and the expected backward")
    init = {k: v.detach().clone() for k, v in
            flatten(trainer.state["params"]).items()}
    host = list(itertools.islice(train_ds.batches(
        STREAM_BATCH, seed=11, drop_remainder=True), 14))
    batch = trainer._put_batch(host[0])
    check_step_parity(torch, trainer, batch,
                      f"{label}, dropout "
                      f"{(cfg.attention_dropout, cfg.output_dropout)}")

    # the main path: train() for ML20M_STEPS steps, counts from 0
    train_counts(reset=True)
    t0 = time.perf_counter()
    hist = trainer.train(train_ds, epochs=1, batch_size=STREAM_BATCH,
                         steps_per_epoch=ML20M_STEPS, seed=SEED,
                         verbose=False)
    wall = time.perf_counter() - t0
    counts = train_counts()
    layer_steps = cfg.num_layers * ML20M_STEPS
    variant = {"sasrec": "causal", "temporal": "rel"}.get(family, "layer")
    want = dict.fromkeys(counts, 0)
    want.update({"K5": ML20M_STEPS, kernel: ML20M_STEPS, "K10": ML20M_STEPS,
                 "K12": 3 * ML20M_STEPS, f"{variant}_fwd": layer_steps,
                 f"{variant}_bwd": layer_steps})
    if fp32:   # every layer launch, forward and backward, on 3xTF32
        want.update(tf32_fwd=layer_steps, tf32_bwd=layer_steps)
    loss = hist.history["loss"][0]
    print(f"{label} train(): {ML20M_STEPS} steps of B={STREAM_BATCH}"
          f" from the ML-20M pipeline in {wall:.2f} s (first step "
          f"included), epoch loss {loss:.4f}; launches {nonzero(counts)}",
          flush=True)
    if counts != want or not math.isfinite(loss):
        raise AssertionError(f"launches {counts}, expected {want}")
    moved = max(float((v.detach() - init[k]).abs().max())
                for k, v in flatten(trainer.state["params"]).items())
    val = trainer.validate(val_ds, batch_size=STREAM_BATCH,
                           validation_steps=4)
    print(f"{label} validate(): 4 batches, loss {val['loss']:.4f}, "
          f"masked_accuracy {val['masked_accuracy']:.4f}", flush=True)
    if not (moved > 0 and math.isfinite(val["loss"])):
        raise AssertionError("train() did not move the params")

    # train() again, warm: its wall time per step with the prefetch thread
    # feeding the card, against the device time of one step
    if timed_steps:
        t0 = time.perf_counter()
        trainer.train(train_ds, epochs=1, batch_size=STREAM_BATCH,
                      steps_per_epoch=timed_steps, seed=SEED + 1,
                      verbose=False)
        train_ms = (time.perf_counter() - t0) * 1e3 / timed_steps
        step_ms = []
        for b in host[1:11]:
            placed = trainer._put_batch(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(placed)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        median = sorted(step_ms)[len(step_ms) // 2]
        device_ms, breakdown = device_breakdown(
            torch, lambda: trainer.train_step(batch), calls=3, top=10,
            forbid=SIMT_FP32_STEP if fp32 else LEGACY_BF16_LAYER,
            groups={"K5": ("fwd_sweep_kernel", "loss_tiled_merge_kernel")})
        idle = None if device_ms is None else 1 - device_ms / train_ms
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{label} train step B={STREAM_BATCH}: median {median:.3f} "
              f"ms of 10 synchronised steps (min {min(step_ms):.3f}), "
              f"{STREAM_BATCH / median * 1e3:.1f} examples/s; train() with "
              f"prefetch {train_ms:.3f} ms per step over {timed_steps}, "
              f"{STREAM_BATCH / train_ms * 1e3:.1f} examples/s; device idle "
              f"share of train() "
              + ("not measured" if idle is None else f"{idle:.3f}")
              + f"; peak device memory of one step {peak_gib:.3f} GiB",
              flush=True)
        print(f"  one {label} train step: " + breakdown, flush=True)

    # the eval loss of a repeated batch falls at a raised learning rate
    start = new_trainer(torch, device, params=init, config_name=config_name,
                        vocab=vocab, family=family, fp32=fp32)
    probe = start._put_batch(host[12])
    before = float(start.eval_step(probe)["loss"])
    fast = new_trainer(torch, device, params=init, lr=1e-3, warmup=0,
                       config_name=config_name, vocab=vocab, family=family,
                       fp32=fp32)
    fast.train(FixedBatches([host[12]] * 12), epochs=1,
               batch_size=STREAM_BATCH, seed=SEED, verbose=False)
    after = float(fast.eval_step(probe)["loss"])
    print(f"{label} repeated batch, lr 1e-3, 12 steps: eval loss "
          f"{before:.4f} -> {after:.4f}", flush=True)
    if not after < 0.99 * before:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{before} -> {after}")
    return dict(counts=counts, kernel=kernel, trainer=trainer, host=host)


# --------------------------------------------------------------------------- #
# phase 11: SASRec from the ML-20M pipeline; phase 12: evaluation
# --------------------------------------------------------------------------- #

def check_sasrec_pipeline():
    """The same corpus through ``create_ml_20m_dataloader(preprocessor=
    "sasrec").prepare_training(finetuning_split=0.1)``: next-item datasets
    over the vocab of the BERT4Rec pipeline."""
    from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
    t0 = time.perf_counter()
    loader = get_dataloader_factory().create_ml_20m_dataloader(
        preprocessor="sasrec")
    splits = loader.prepare_training(finetuning_split=0.1)
    prep_s = time.perf_counter() - t0
    vocab = loader.tokenizer.get_vocab_size()
    tasks = [ds.task for ds in splits]
    print(f"sasrec pipeline: prepare_training(finetuning_split=0.1) "
          f"{prep_s:.2f} s of host time; vocab {vocab}; sequences train "
          f"{len(splits[0])} / val {len(splits[1])} / test {len(splits[2])}"
          f"; tasks {tasks}", flush=True)
    if vocab != ML20M_VOCAB or tasks != ["next_item"] * 3:
        raise AssertionError(f"sasrec pipeline: vocab {vocab}, tasks {tasks}")
    return loader, splits


EVAL_SEED = 7
HOST_EVAL_ROWS = 4096     # the host sampler's slice of the test split
RANK_TIE = 1e-3           # kernel vs plain ranks may differ only at ties


def valid_rows(ds) -> int:
    """Rows of ``ds`` with a valid prediction slot."""
    w = ds.materialize(0)["masked_lm_weights"]
    return int((w.sum(axis=1) > 0).sum())


def check_rank_parity(torch, device, model, params, sampler, test, label):
    """One test batch's 101-candidate ranks on the kernels against the
    plain versions (fp32 compute, the same params and candidates): ranks
    may differ only where a negative's plain logit lies within RANK_TIE of
    the ground truth's."""
    from contextlib import ExitStack
    import numpy as np
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    fp32 = type(model)(config=model.config, dtype_policy=DTypePolicy.f32())
    batch = next(test.batches(STREAM_BATCH, shuffle=False, seed=0))
    labels, gt = batch["labels"], batch["masked_lm_ids"][:, :1]
    rows = np.nonzero(batch["masked_lm_weights"][:, 0] > 0)[0]
    without = [np.concatenate([labels[i][labels[i] != 0], gt[i]])
               for i in rows]
    vocab = np.asarray(sampler.vocab)
    cand = np.zeros((len(labels), 1, 101), np.int32)
    cand[rows, 0, :-1] = vocab[sampler.sample_batch(without, 100,
                                                    seed=EVAL_SEED)]
    cand[:, 0, -1] = gt[:, 0]
    feats = {k: torch.from_numpy(np.ascontiguousarray(
        v[:, :1] if k.startswith("masked_lm") else v)).to(device)
        for k, v in batch.items() if k != "labels"}
    cand_t = torch.from_numpy(cand).to(device)
    with torch.no_grad():
        kern = fp32.score_candidates(params, feats, cand_t)
        with ExitStack() as stack:
            for patch in plain_kernels():
                stack.enter_context(patch)
            plain = fp32.score_candidates(params, feats, cand_t)
        rk = ((kern[..., :-1] >= kern[..., -1:]).sum(-1) + 1).cpu().numpy()
        rp = ((plain[..., :-1] >= plain[..., -1:]).sum(-1) + 1).cpu().numpy()
        tie = ((plain[..., :-1] - plain[..., -1:]).abs() < RANK_TIE) \
            .any(-1).cpu().numpy()
    logit_err = float((kern - plain).abs().max())
    differ = rk != rp
    print(f"{label} ranks, kernels vs plain (fp32, one batch of "
          f"{STREAM_BATCH}, 101 candidates): candidate logits max abs diff "
          f"{logit_err:.3g}; {int(differ.sum())} of {differ.size} ranks "
          f"differ, {int(tie.sum())} positions hold a tie within "
          f"{RANK_TIE}", flush=True)
    if (differ & ~tie).any() or not np.isfinite(logit_err):
        raise AssertionError(f"{label}: kernel ranks differ from the plain "
                             f"ranks away from ties")


def check_evaluation(torch, device, loader, splits, trainer, label,
                     protocols=("device negatives", "host negatives",
                                "full catalog")):
    """``BERT4RecEvaluator(dataloader=loader, seed=...).evaluate`` of a
    trained model on its test split, by each of ``protocols``: device
    negatives (the default), host negatives (a slice of HOST_EVAL_ROWS
    rows) and the full catalog.
    Checks Valid Ranks, the metrics' range and HR@k >= NDCG@k, the layer
    launches per batch, and the kernel ranks against the plain ranks.
    Returns per protocol the metrics, batches/s and examples/s."""
    import numpy as np
    from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    test = splits[2]
    model, params = trainer.model, trainer.params
    counter = ("rel_launches" if model.config.use_temporal_attention
               else "causal_launches" if model.config.causal_attention
               else "launches")
    device_ev = BERT4RecEvaluator(dataloader=loader, seed=EVAL_SEED)
    t0 = time.perf_counter()
    device_ev._prepare_sampler()
    print(f"{label} evaluation: sampler from the dataloader's item list "
          f"({len(device_ev.sampler.source)} ratings, "
          f"{len(device_ev.sampler.vocab)} items) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    host_ds = test.select(np.arange(min(HOST_EVAL_ROWS, len(test))))
    runs = [("device negatives", device_ev, test),
            ("host negatives", BERT4RecEvaluator(
                sampler=device_ev.sampler, seed=EVAL_SEED,
                device_negatives=False), host_ds),
            ("full catalog", BERT4RecEvaluator(full_ranking=True), test)]
    runs = [r for r in runs if r[0] in protocols]
    out = {}
    for name, ev, ds in runs:
        setattr(fel.fused_encoder_layer, counter, 0)
        t0 = time.perf_counter()
        res = ev.evaluate(model, params, ds, batch_size=STREAM_BATCH,
                          progress_bar=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_batches = -(-len(ds) // STREAM_BATCH)
        launches = getattr(fel.fused_encoder_layer, counter)
        want = valid_rows(ds)
        metrics = {k: v for k, v in res.items() if k != "Valid Ranks"}
        print(f"{label} evaluate ({name}): {len(ds)} rows in {n_batches} "
              f"batches of {STREAM_BATCH}, {wall:.2f} s, "
              f"{n_batches / wall:.2f} batches/s, {len(ds) / wall:.1f} "
              f"examples/s; fused layer {counter} {launches}; "
              + json.dumps({k: round(float(v), 5) for k, v in res.items()}),
              flush=True)
        if res["Valid Ranks"] != want or not all(
                0.0 <= v <= 1.0 for v in metrics.values()) or not all(
                res[f"HR@{k}"] >= res[f"NDCG@{k}"] for k in (1, 5, 10)):
            raise AssertionError(f"{label} {name}: {res}, expected "
                                 f"{want} valid ranks")
        if launches != model.config.num_layers * n_batches:
            raise AssertionError(f"{label} {name}: {launches} layer "
                                 f"launches for {n_batches} batches")
        out[name] = dict(metrics=res, batches_per_s=n_batches / wall,
                         examples_per_s=len(ds) / wall)
    check_rank_parity(torch, device, model, params, device_ev.sampler, test,
                      label)
    return out


# --------------------------------------------------------------------------- #
# phase 13: flash attention K8 / K9; phase 14: bert_base_512 training
# --------------------------------------------------------------------------- #

# the reference-default encoder's attention (B, N, S, D), a ragged shape,
# and one past JAX's MAX_FUSED_SEQ_LEN (1,024), where a CUDA tensor still
# runs the kernels
FLASH_SHAPES = ((32, 12, 512, 64), (3, 4, 130, 64), (3, 2, 1100, 64))
FLASH_RATE = 0.2          # bert_base_512's attention dropout (bench.py:75)
# K8's forward, max abs against the plain version. Attention context is a
# weighted mean of values: over a full row of unit-variance scores its
# entries are ~0.07, not of order 1 as a layer's output, for which JAX's
# 8e-2 was set. The bf16 limit sits under a tenth of rms(o).
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def flash_inputs(torch, rng, device, dims, dtype):
    """q, k, v as strided views of one [B, S, 3, N, D] projection (what the
    unfused block hands the kernels), an int32 mask with a full row, a row
    of length 1, an all-pad row and (B > 3) a front-padded row, the rest
    random right-padded lengths, and dO."""
    import numpy as np
    b, n, s, d = dims
    proj = torch.from_numpy(rng.normal(size=(b, s, 3, n, d))
                            .astype(np.float32)).to(device, dtype)
    q, k, v = (proj[:, :, i].transpose(1, 2) for i in range(3))
    lengths = rng.integers(1, s + 1, size=b)
    lengths[:3] = [s, 1, 0]
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    if b > 3:
        mask[3] = (np.arange(s) >= s // 3).astype(np.int32)
    do = torch.from_numpy(rng.normal(size=(b, n, s, d)).astype(np.float32)) \
        .to(device, dtype)
    return q, k, v, torch.from_numpy(mask).to(device), do


def check_flash_kernels(torch, rng, device):
    """K8 and K9 on strided views at FLASH_SHAPES, fp32 (on the 3xTF32
    route) and bf16, bidirectional and causal: kernel times at dropout 0
    and, at FLASH_RATE, plain and library (SDPA) times and the bound; at
    the main shape each launch's kernels by device time."""
    import torch.nn.functional as F
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    rows, rate0 = {}, {}
    for dims in FLASH_SHAPES:
        b, n, s, d = dims
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q, k, v, mask, do = flash_inputs(torch, rng, device, dims, dtype)
            route = fa.flash_route(dtype, d)
            if dtype == torch.float32 and route != "tf32":
                raise AssertionError(f"fp32 flash attention at {dims} is "
                                     f"routed to {route}, not tf32")
            for causal, rate in itertools.product((False, True),
                                                  (0.0, FLASH_RATE)):
                fwd = lambda: fa._launch_forward(  # noqa: E731
                    q, k, v, mask, 77, rate, causal, True)
                saved = fwd()[1]
                bwd = lambda: fa._launch_backward(  # noqa: E731
                    q, k, v, mask, do, saved, 77, rate, causal)
                label = (f"flash attention {name} (B, N, S, D)={dims} "
                         f"dropout {rate} {'causal' if causal else 'bidir'}"
                         f" [{route}]")
                kernel = {"fwd": timed(fwd), "bwd": timed(bwd)}
                if rate == 0.0:
                    rate0[(dims, name, causal)] = kernel
                    print(f"{label}: " + "; ".join(
                        f"{part}: kernel_ms={t['ms']:.4f} ("
                        f"{t['range'][0]:.4f}-{t['range'][1]:.4f})"
                        for part, t in kernel.items()), flush=True)
                    continue
                # yardstick: SDPA with the pad mask (and the triangle) as one
                # additive mask, its own dropout, and its autograd
                bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
                if causal:
                    bias = bias + fa.causal_bias(s, device)
                bias = bias.to(dtype)
                ql, kl, vl = (t.detach().requires_grad_(True)
                              for t in (q, k, v))

                def lib_fwd():
                    return F.scaled_dot_product_attention(
                        ql, kl, vl, attn_mask=bias, dropout_p=rate)

                lib_out = lib_fwd()
                lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
                    lib_out, (ql, kl, vl), do, retain_graph=True)
                lib = {"fwd": timed(lib_fwd, "library"),
                       "bwd": timed(lib_bwd, "library")}
                backend = sdpa_backend(torch, lib_bwd)
                plain = {"fwd": lambda: fa.mha_reference(
                             q, k, v, mask, rate, 77, causal),
                         "bwd": lambda: fa.flash_attention_plain_backward(
                             q, k, v, mask, do, dropout_rate=rate, seed=77,
                             causal=causal)}
                errs = dict(
                    fwd=held(label, [fwd()[0]], [plain["fwd"]()],
                             FLASH_TOL[name], False),
                    bwd=held(label, bwd(), plain["bwd"](), GRAD_TOL[name]))
                row = {part: dict(
                    max_abs_err=errs[part], **kernel[part], **lib[part],
                    rate0_ms=rate0[(dims, name, causal)][part]["ms"],
                    **timed(plain[part], "plain", **PLAIN),
                    **bound(roofline.flash_s, b, n, s, d, part == "bwd",
                            name, peak=roofline.TF32X3_FLOPS
                            if route == "tf32" else None,
                            extra_flops=-(8 if part == "bwd" else 4)
                            * unpaired(b * n, s, d, causal)))
                    for part in ("fwd", "bwd")}
                rows[(dims, name, causal)] = row
                print(f"{label}: " + "; ".join(
                    f"{part}: {timing_text(r)}; rate 0 {r['rate0_ms']:.4f}"
                    for part, r in row.items())
                    + f" (SDPA backend {backend})", flush=True)
                if dims == FLASH_SHAPES[0] and not causal:
                    forbid = SIMT_FP32_LAYER if route == "tf32" else None
                    print(f"  per {name} K8 launch: " + device_breakdown(
                        torch, fwd, forbid=forbid)[1], flush=True)
                    print(f"  per {name} K9 launch: " + device_breakdown(
                        torch, bwd, forbid=forbid)[1], flush=True)
                del lib_out, lib_bwd, ql, kl, vl, bias
            del q, k, v, mask, do
            torch.cuda.empty_cache()
    return rows


# bert_base_512 (tools/perf_guard.py:185-199): the encoder's defaults
BASE_MODEL = dict(hidden_size=768, num_layers=12, num_attention_heads=12,
                  inner_dim=3072)
BASE_BATCH, BASE_SEQ, BASE_PRED = 32, 512, 76
BASE_STEPS = 3
BASE_TIMED_STEPS = 8


def bert_base_trainer(torch, device, params=None, remat=False, lr=1e-4,
                      warmup=100, fp32=False):
    """The bert_base_512 path (tools/perf_guard.py:185-191): the reference-
    default encoder on flash attention, logits loss, bf16 compute (with
    ``fp32`` no dtype policy: fp32 compute, the JAX package's default), fp32
    params, ``create_adam_w_optimizer()``'s defaults, seed 0."""
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
    config = BERT4RecConfig(
        vocab_size=VOCAB, **BASE_MODEL,
        max_sequence_length=BASE_SEQ, max_predictions_per_seq=BASE_PRED,
        attention_dropout=0.2, output_dropout=0.5, use_fused_layer=False,
        use_fused_loss=False, use_flash_attention=True, remat=remat)
    trainer = BERT4RecTrainer(BERT4RecModel(
        config=config, dtype_policy=None if fp32 else DTypePolicy.bf16()))
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=lr, num_warmup_steps=warmup), params=params, seed=SEED,
        device=device)
    return trainer


def base_batch(seed):
    return make_batch(seed, BASE_BATCH, BASE_PRED, BASE_SEQ)


FLASH_COUNTERS = ("launches", "backward_launches", "causal_launches",
                  "causal_backward_launches", "tf32_launches",
                  "tf32_backward_launches", "simt_launches",
                  "simt_backward_launches")


def base_train_counts(torch, trainer, want, label) -> dict:
    """The main path: the flash attention kernels' launch counters and
    ``train_counts``' set to 0, ``train()`` for BASE_STEPS steps, then the
    counts, held to ``want`` (0 for every counter it does not name, but
    K10: one a step, and K12: three a step)."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    for attr in FLASH_COUNTERS:
        setattr(fa.flash_attention, attr, 0)
    train_counts(reset=True)
    t0 = time.perf_counter()
    hist = trainer.train(SyntheticDataset(BASE_STEPS, seed=1,
                                          npred=BASE_PRED, seq=BASE_SEQ),
                         epochs=1, batch_size=BASE_BATCH, seed=SEED,
                         verbose=False)
    wall = time.perf_counter() - t0
    counts = {**{f"flash.{a}": getattr(fa.flash_attention, a)
                 for a in FLASH_COUNTERS}, **train_counts()}
    want = {**dict.fromkeys(counts, 0), **want, "K10": BASE_STEPS,
            "K12": 3 * BASE_STEPS}
    loss = hist.history["loss"][0]
    print(f"{label} train(): {BASE_STEPS} steps of B={BASE_BATCH} S="
          f"{BASE_SEQ} in {wall:.2f} s (first step included), epoch loss "
          f"{loss:.4f}; launches {nonzero(counts)}", flush=True)
    if counts != want or not math.isfinite(loss):
        raise AssertionError(f"launches {counts}, expected {want}")
    return counts


def base_step_times(torch, trainer, batch, label, groups, forbid=None):
    """The step time (the host clock around 10 synchronised steps; the
    peak device memory of the first), ``train()``'s time per step over
    BASE_TIMED_STEPS (warm, with its prefetch thread), and the device time
    of one step by kernel (``forbid`` as in ``device_breakdown``)."""
    step_ms = []
    for i in range(10):
        b = trainer._put_batch(base_batch(100 + i))
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train_step(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
    median = sorted(step_ms)[len(step_ms) // 2]
    t0 = time.perf_counter()
    trainer.train(SyntheticDataset(BASE_TIMED_STEPS, seed=2, npred=BASE_PRED,
                                   seq=BASE_SEQ),
                  epochs=1, batch_size=BASE_BATCH, seed=SEED + 1,
                  verbose=False)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3 / BASE_TIMED_STEPS
    device_ms, breakdown = device_breakdown(
        torch, lambda: trainer.train_step(batch), calls=3, top=10,
        groups=groups, forbid=forbid)
    idle = None if device_ms is None else 1 - device_ms / train_ms
    print(f"{label} train step B={BASE_BATCH}: median {median:.3f} ms of 10 "
          f"synchronised steps (min {min(step_ms):.3f}), "
          f"{BASE_BATCH / median * 1e3:.1f} examples/s; train() "
          f"{train_ms:.3f} ms per step over {BASE_TIMED_STEPS}, "
          f"{BASE_BATCH / train_ms * 1e3:.1f} examples/s; device idle share "
          f"of train() " + ("not measured" if idle is None
                            else f"{idle:.3f}")
          + f"; peak device memory of a step {peak:.2f} GiB", flush=True)
    print(f"  one {label} train step: " + breakdown, flush=True)
    return dict(step_ms=median, train_ms=train_ms, device_ms=device_ms,
                idle=idle, peak=peak)


def check_bert_base_training(torch, device):
    """``train()`` on bert_base_512: the kernel step against the plain
    step, the launch counts of a BASE_STEPS-step run, K12 on its trained
    leaves, a remat step, and the loss falling (the benchmark times the
    step)."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    from bert4rec_tpu_torch.utils.checkpoint import flatten
    trainer = bert_base_trainer(torch, device)
    cfg = trainer.model.config
    if trainer.model.encoder.fused_layer_routed(
            BASE_BATCH, BASE_SEQ, dropout_active=True, device=device) \
            or not cfg.use_flash_attention or cfg.use_fused_loss:
        raise AssertionError("bert_base_512 is not routed to flash attention "
                             "and the logits loss")
    init = {k: v.detach().clone() for k, v in
            flatten(trainer.state["params"]).items()}
    batch = trainer._put_batch(base_batch(7))
    rates = (cfg.attention_dropout, cfg.output_dropout)
    check_step_parity(torch, trainer, batch, f"bert_base_512, dropout {rates}")
    torch.cuda.empty_cache()

    # the main path: train() for BASE_STEPS steps, counts from 0
    want = {"flash.launches": cfg.num_layers * BASE_STEPS,
            "flash.backward_launches": cfg.num_layers * BASE_STEPS}
    counts = base_train_counts(torch, trainer, want, "bert_base_512")
    # phase 28: K12 on the trained leaves (the last use of this trainer)
    update = check_adamw_leaves(torch, device, "bert_base_512", trainer)
    del trainer
    torch.cuda.empty_cache()

    # remat: the same gradients from the same params, K8 twice per layer,
    # a lower peak of device memory
    peaks, grads, fwd_launches = {}, {}, {}
    for remat in (False, True):
        t = bert_base_trainer(torch, device, params=init, remat=remat)
        b = t._put_batch(base_batch(7))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = fa.flash_attention.launches
        _, _, grads[remat] = t._grads(b, 99)
        torch.cuda.synchronize()
        fwd_launches[remat] = fa.flash_attention.launches - before
        peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 30
        del t, b
        torch.cuda.empty_cache()
    diff = max(float((grads[True][k] - grads[False][k]).abs().max())
               for k in grads[False])
    print(f"bert_base_512 remat=True: gradients equal the remat=False "
          f"step's (max abs diff {diff:.3g}); K8 launches per step "
          f"{fwd_launches[True]} (remat=False {fwd_launches[False]}); peak "
          f"device memory {peaks[True]:.2f} GiB against {peaks[False]:.2f}",
          flush=True)
    if not (diff == 0.0 and fwd_launches[True] == 2 * cfg.num_layers
            and fwd_launches[False] == cfg.num_layers
            and peaks[True] < peaks[False]):
        raise AssertionError("remat changed the gradients, the K8 launches "
                             "or did not lower the peak memory")
    del grads

    # the eval loss of a repeated batch falls
    probe = base_batch(3)
    fast = bert_base_trainer(torch, device, params=init, warmup=0)
    before = float(fast.eval_step(fast._put_batch(probe))["loss"])
    fast.train(SyntheticDataset(BASE_TIMED_STEPS, seed=3, repeat=True,
                                npred=BASE_PRED, seq=BASE_SEQ),
               epochs=1, batch_size=BASE_BATCH, seed=SEED, verbose=False)
    after = float(fast.eval_step(fast._put_batch(probe))["loss"])
    print(f"bert_base_512 repeated batch, lr 1e-4, {BASE_TIMED_STEPS} steps: "
          f"eval loss {before:.4f} -> {after:.4f}", flush=True)
    if not after < 0.99 * before:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{before} -> {after}")
    del fast
    torch.cuda.empty_cache()
    return dict(counts=counts, peaks=peaks, adamw=update)


def check_bert_base_fp32(torch, device):
    """Phase 20: ``train()`` on bert_base_512 in fp32 (no dtype policy):
    the kernel step against the plain step, the launch counts of a
    BASE_STEPS-step run (12 K8 and 12 K9 a step, all on the 3xTF32 route),
    the step time, device idle share, breakdown and peak memory, and one
    eval-mode forward (K8's inference entry) against the plain path."""
    from contextlib import ExitStack
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    trainer = bert_base_trainer(torch, device, fp32=True)
    cfg = trainer.model.config
    dtype = trainer.model.dtype_policy.compute_dtype
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    if dtype != torch.float32 or fa.flash_route(dtype, head_dim) != "tf32" \
            or trainer.model.encoder.fused_layer_routed(
                BASE_BATCH, BASE_SEQ, dropout_active=True, device=device) \
            or not cfg.use_flash_attention or cfg.use_fused_loss:
        raise AssertionError("fp32 bert_base_512 is not routed to the 3xTF32 "
                             "flash attention kernels and the logits loss")
    batch = trainer._put_batch(base_batch(7))
    rates = (cfg.attention_dropout, cfg.output_dropout)
    check_step_parity(torch, trainer, batch,
                      f"fp32 bert_base_512, dropout {rates}")
    torch.cuda.empty_cache()

    # the main path: train() for BASE_STEPS steps, counts from 0
    want = {f"flash.{attr}": cfg.num_layers * BASE_STEPS for attr in (
        "launches", "backward_launches", "tf32_launches",
        "tf32_backward_launches")}
    counts = base_train_counts(torch, trainer, want, "fp32 bert_base_512")
    step = base_step_times(
        torch, trainer, batch, "fp32 bert_base_512", forbid=SIMT_FP32_LAYER,
        groups={"K8": ("flash_fwd_tf32",),
                "K9": ("flash_dq_tf32", "flash_dkv_tf32"),
                "GEMMs": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
                "optimizer": ("multi_tensor", "foreach")})

    # K8's inference entry: an eval-mode forward of the trained model, no
    # dropout and nothing saved, against the plain path
    before = {a: getattr(fa.flash_attention, a) for a in FLASH_COUNTERS}
    loss_k = float(trainer.eval_step(batch)["loss"])
    torch.cuda.synchronize()
    moved = {a: getattr(fa.flash_attention, a) - before[a]
             for a in FLASH_COUNTERS}
    with ExitStack() as stack:
        for patch in plain_kernels():
            stack.enter_context(patch)
        loss_p = float(trainer.eval_step(batch)["loss"])
    eval_err = abs(loss_k - loss_p) / abs(loss_p)
    want_eval = dict.fromkeys(FLASH_COUNTERS, 0)
    want_eval.update(launches=cfg.num_layers, tf32_launches=cfg.num_layers)
    print(f"fp32 bert_base_512 eval_step (K8 inference entry): loss "
          f"{loss_k:.6f} vs plain {loss_p:.6f} (rel {eval_err:.3g}, tol "
          f"{STEP_TOL['loss']}); launches {moved}", flush=True)
    if moved != want_eval or not eval_err <= STEP_TOL["loss"]:
        raise AssertionError(f"fp32 eval forward: launches {moved} (expected "
                             f"{want_eval}), loss rel err {eval_err}")
    del trainer
    torch.cuda.empty_cache()
    return dict(counts=counts, **step)


# --------------------------------------------------------------------------- #
# phase 15: K1'' rel_bias / K2 dRel (check_masked_layer); phase 16:
# temporal training; phase 17: the temporal learning gate
# --------------------------------------------------------------------------- #

def sdpa_backend(torch, fn) -> str:
    """Which SDPA backend ``fn`` ran, read from its kernels' names (the
    runtime's own records, memsets and copies set aside; a trace that
    holds no kernel is taken once more)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted(
            (e for e in prof.key_averages()
             if getattr(e, "self_device_time_total", 0) > 0
             and not e.key.startswith("cuda")
             and not any(w in e.key.lower() for w in ("memset", "memcpy"))),
            key=lambda e: -e.self_device_time_total)
        if kernels:
            break
    names = " ".join(e.key.lower() for e in kernels)
    for label, keys in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                        ("efficient", ("fmha", "efficient", "mem_eff"))):
        if any(k in names for k in keys):
            return label
    # no known backend's name: say which kernels took the most time
    return ("unnamed: " + ", ".join(_kernel_name(e.key) for e in kernels[:3])
            if kernels else "not measured (no kernel in the trace)")


# phase 26: K10, the item table's gradient. (R, V, H, [PAD] ids, [MASK]
# ids): ml-20m_128's batch (B=256, S=200) as PERF.md counts it, and
# bert_base_512's (B=32, S=512, ML-1M users: ~73% padding, P=76)
TABLE_GRAD_SHAPES = {"ml-20m_128": (51_200, 26_732, 128, 27_623, 4_630),
                     "bert_base_512": (16_384, 3_709, 768, 11_900, 2_432)}


def table_grad_ids(torch, rng, device, r, v, pad, mask):
    """int32 ids of a batch: ``pad`` zeros, ``mask`` [MASK] ids (v - 1),
    the rest items log-uniform over [1, v - 2] (a rank-frequency curve of
    slope -1)."""
    import numpy as np
    items = np.exp(rng.uniform(0.0, np.log(max(v - 2, 1)), r)).astype(
        np.int32)
    ids = np.minimum(items, v - 1) % v
    at = rng.permutation(r)
    ids[at[:pad]] = 0
    ids[at[pad:pad + mask]] = v - 1
    return torch.from_numpy(ids.astype(np.int32)).to(device)


def device_ops(torch, fn, need=()) -> dict:
    """The device operations (kernels, memsets, copies) of one call of
    ``fn`` by name, ``[count, device us]``, from torch.profiler, taken again
    if it dropped them: none, or (up to five traces, then the last is
    returned as it is, ``{}`` if none recorded any: not measured) one
    named by a part in ``need``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    ops = {}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = {_kernel_name(e.key): [e.count, round(
            e.self_device_time_total, 2)] for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0}
        if ops and all(any(k in name for name in ops) for k in need):
            return ops
    return ops


def op_count(ops):
    """The operations a ``device_ops`` trace counts; "not measured" where
    the profiler recorded none."""
    return sum(n for n, _ in ops.values()) if ops else "not measured"


def check_table_gradient(torch, rng, device) -> dict:
    """Phase 26: K10 at the two cells' shapes beside today's ``table[ids]``
    backward (plain) and ``F.embedding``'s (library), and each backward's
    device operations (ours ``b4r::table_grad``'s, no more than today's)."""
    import torch.nn.functional as F
    from bert4rec_tpu_torch.ops import table_gradient as tg
    rows = {}
    for name, (r, v, h, pad, mask) in TABLE_GRAD_SHAPES.items():
        ids = table_grad_ids(torch, rng, device, r, v, pad, mask)
        g = torch.randn((r, h), device=device).to(torch.bfloat16)
        table = torch.randn((v, h), device=device, requires_grad=True)
        today = table[ids.long()].to(torch.bfloat16)
        library = F.embedding(ids.long(), table).to(torch.bfloat16)
        ours = tg.table_gather(table, ids, torch.bfloat16)

        def backward(y):
            return lambda: torch.autograd.grad(y, table, g, retain_graph=True)

        row = {"max_abs_err": held(
                   f"K10 {name}", [tg.table_gradient(g, ids, v)],
                   backward(today)(), GRAD_TOL["float32"]),
               **timed(lambda: tg.table_gradient(g, ids, v)),
               **timed(backward(today), "plain", **PLAIN),
               **timed(backward(library), "library"),
               "bound_ms": roofline._bound(0, r * h * 2 + r * 4 + v * h * 4,
                                           1.0) * 1e3, "bound_by": "bytes",
               "ops": device_ops(torch, backward(ours),
                                 need=("b4r::table_grad",)),
               "plain_ops": device_ops(torch, backward(today),
                                       need=("indexing_backward",))}
        n_ops, n_plain = op_count(row["ops"]), op_count(row["plain_ops"])
        if any("indexing_backward" in k for k in row["ops"]) or not any(
                "b4r::table_grad" in k for k in row["ops"]):
            raise AssertionError(f"K10 {name}: backward ops {row['ops']}")
        print(f"K10 {name} (R={r}, V={v}, H={h}, bf16): {timing_text(row)};"
              f" backward ops {n_ops} {row['ops']} vs plain "
              f"{n_plain} {row['plain_ops']}", flush=True)
        if row["plain_ops"] and n_ops > n_plain:
            raise AssertionError(f"K10 {name}: {n_ops} device operations "
                                 f"a backward, today's {n_plain}")
        rows[name] = row
    return rows


def check_temporal_pipeline():
    """The corpus through ``create_ml_20m_dataloader(preprocessor=
    "bert4rec_temporal").prepare_training(extract_data=["movie_name",
    "timestamp"], finetuning_split=0.1)``: masked-LM datasets whose batches
    carry ``input_timestamps`` aligned with the items."""
    from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
    t0 = time.perf_counter()
    loader = get_dataloader_factory().create_ml_20m_dataloader(
        preprocessor="bert4rec_temporal")
    splits = loader.prepare_training(
        extract_data=["movie_name", "timestamp"], finetuning_split=0.1)
    prep_s = time.perf_counter() - t0
    vocab = loader.tokenizer.get_vocab_size()
    batch = next(splits[0].batches(STREAM_BATCH, seed=0))
    real = batch["input_mask"] > 0
    ts = batch.get("input_timestamps")
    print(f"temporal pipeline: prepare_training(extract_data=[movie_name, "
          f"timestamp], finetuning_split=0.1) {prep_s:.2f} s of host time; "
          f"vocab {vocab}; sequences train {len(splits[0])} / val "
          f"{len(splits[1])} / test {len(splits[2])}; batch keys "
          f"{sorted(batch)}", flush=True)
    if vocab != ML20M_VOCAB or ts is None or ts.shape != real.shape \
            or not (ts[real] > 0).all() or (ts[~real] != 0).any():
        raise AssertionError("temporal pipeline: no aligned timestamps")
    return loader, splits


def table_grad_onehot(torch, bucket, g, n_buckets, chunk_elems=1 << 26):
    """JAX's law for the relative bias's table gradient, a yardstick for
    the port's sorted reduction (never called by the port): the one-hot
    contraction ``dtable[k, h] = sum of g[b, h, q, key] over bucket[b, q,
    key] == k``, in chunks of sequences so the indicator never exceeds
    ``chunk_elems`` values (the whole one would be 2.6 GB at B=256, S=200,
    64 buckets); batched GEMMs over fixed chunks summed in order."""
    b, n, s, _ = g.shape
    per = max(1, chunk_elems // (s * s * n_buckets))
    ar = torch.arange(n_buckets, device=g.device, dtype=bucket.dtype)
    dtable = torch.zeros((n, n_buckets), dtype=torch.float32, device=g.device)
    for i in range(0, b, per):
        bk = bucket[i:i + per].reshape(-1, s * s)
        oh = (bk[..., None] == ar).to(torch.float32)            # [c, SS, nb]
        dtable += torch.bmm(g[i:i + per].reshape(-1, n, s * s), oh).sum(0)
    return dtable.T.contiguous()


def check_temporal_extras(torch, device, trainer, host_batch):
    """Two identical steps give the same bits of both temporal tables'
    gradients; the bucket laws on the card equal the CPU's at float32's
    log2 edges and across int32 wraparound; the port's sorted table
    gradient against JAX's one-hot law on this batch's bucket matrix, both
    timed, each repeating its bits, and agreeing with each other."""
    import numpy as np
    from bert4rec_tpu_torch.models.components.networks import (
        bert4rec_encoder as enc_mod,
    )
    Enc = enc_mod.Bert4RecEncoder
    batch = trainer._put_batch(host_batch)
    grads = [trainer._grads(batch, 99)[2] for _ in range(2)]
    for path in ("encoder/temporal_attention_bias/embedding",
                 "encoder/temporal_embeddings/embedding"):
        if not torch.equal(grads[0][path], grads[1][path]):
            raise AssertionError(f"{path}: two identical steps differ")
    print(f"temporal tables: two identical steps give the same gradient "
          f"bits (bias table grad max |.| "
          f"{float(grads[0]['encoder/temporal_attention_bias/embedding'].abs().max()):.4g})",
          flush=True)
    del grads

    base = [2 ** k + o for k in range(1, 31) for o in (-2, -1, 0)]
    deltas = np.asarray(sorted(set([0] + base + [-d for d in base])),
                        np.int64)
    ts = np.stack([np.zeros_like(deltas), deltas], axis=1)
    wrap = np.array([[2 ** 31 - 10, 2 ** 31 + 5, 2 ** 31 - 1, 2 ** 31, 0,
                      -2 ** 31]], np.int64)
    for stamps in (ts, wrap, 1_700_000_000 - ts):
        mask = np.ones(stamps.shape, np.int32)
        for law, n in ((Enc._time_bucket_matrix, 64),
                       (Enc._recency_buckets, 32)):
            cpu = law(torch.from_numpy(stamps), torch.from_numpy(mask), n)
            card = law(torch.from_numpy(stamps).to(device),
                       torch.from_numpy(mask).to(device), n)
            if not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"{law.__name__}: the card's buckets "
                                     f"differ from the CPU's")
    print(f"bucket laws: the card equals the CPU at {len(deltas)} deltas "
          f"2^k - 2 .. 2^k (k = 1..30, both signs) and across int32 "
          f"wraparound", flush=True)

    cfg = trainer.model.config
    bucket = Enc._time_bucket_matrix(batch["input_timestamps"],
                                     batch["input_mask"],
                                     cfg.temporal_attention_buckets)
    g = torch.randn((STREAM_BATCH, cfg.num_attention_heads, SEQ, SEQ),
                    device=device)
    out, ms = {}, {}
    for name, fn in (("onehot", lambda *a: table_grad_onehot(torch, *a)),
                     ("sorted", enc_mod.table_grad_sorted)):
        out[name] = fn(bucket, g, cfg.temporal_attention_buckets)
        if not torch.equal(out[name], fn(bucket, g,
                                         cfg.temporal_attention_buckets)):
            raise AssertionError(f"table gradient {name} does not repeat "
                                 f"its bits")
        ms[name] = time_device_ms(lambda: fn(
            bucket, g, cfg.temporal_attention_buckets))[0]
    agree = rel_err(out["sorted"], out["onehot"])
    print(f"table gradient A/B (B={STREAM_BATCH}, N={cfg.num_attention_heads}"
          f", S={SEQ}, {cfg.temporal_attention_buckets} buckets, bits "
          f"repeat): " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f" (onehot: JAX's law, a yardstick; sorted: the port's); they "
          f"agree within {agree:.3g} of the scale", flush=True)
    if not agree <= 1e-4:
        raise AssertionError(f"the sorted table gradient differs from "
                             f"JAX's one-hot law: {agree}")
    return ms


def check_temporal_gate(torch, device):
    """The quality harness's temporal gate on the card: the temporal model
    against its time-blind ablation on the planted copy-by-time-delta
    world (JAX's generator, seeds, model, optimizer and 30 epochs), with
    JAX's three checks."""
    import types
    from bert4rec_tpu_torch.evaluation import quality_harness
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        t0 = time.perf_counter()
        rc = quality_harness.run_smoke_temporal(
            types.SimpleNamespace(seed=42, out=tmp), device=device)
        wall = time.perf_counter() - t0
        with open(f"{tmp}/eval_results.json") as f:
            payload = json.load(f)
    print(f"temporal gate ({wall:.1f} s): temporal model "
          f"{payload['results']}, time-blind ablation "
          f"{payload['results_time_blind_ablation']}, checks "
          f"{payload['checks']}", flush=True)
    if rc != 0 or not all(payload["checks"].values()):
        raise AssertionError(f"the temporal gate failed: {payload['checks']}")
    return payload


# --------------------------------------------------------------------------- #
# phase 21: the quality harness's Markov-oracle gate at the ml1m preset
# --------------------------------------------------------------------------- #

ORACLE_SCALE = "ml1m"


class TrainCalls:
    """While entered, ``BERT4RecTrainer.train`` records each call: the
    trainer, its train dataset, the synchronised seconds and the steps."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from unittest import mock
        from bert4rec_tpu_torch.trainers import BERT4RecTrainer
        train = BERT4RecTrainer.train

        def recorded(trainer, train_ds, *args, **kwargs):
            step0 = trainer.state["step"] if trainer.state else 0
            t0 = time.perf_counter()
            history = train(trainer, train_ds, *args, **kwargs)
            self.torch.cuda.synchronize()
            self.calls.append((trainer, train_ds, time.perf_counter() - t0,
                               trainer.state["step"] - step0))
            return history

        self._patch = mock.patch.object(BERT4RecTrainer, "train", recorded)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def check_oracle_gate(torch, device):
    """``quality_harness.run_oracle`` at the ml1m preset (family bert4rec,
    80 epochs, JAX's gates unchanged) on the card: every check must hold.
    The layer and loss launches of the run are counted by route, and each
    ``train()`` call is timed; one step of the last trained model is
    traced for its device time."""
    from bert4rec_tpu_torch.evaluation import quality_harness

    with tempfile.TemporaryDirectory(prefix="chip_smoke_oracle_") as tmp:
        args = quality_harness.build_argparser().parse_args(
            ["--oracle", "--oracle-scale", ORACLE_SCALE, "--int8", "--out",
             tmp])
        train_counts(reset=True)
        t0 = time.perf_counter()
        with TrainCalls(torch) as recorded:
            rc = quality_harness.run_oracle(args, device=device)
        wall = time.perf_counter() - t0
        trains = [(t, w, n) for t, _, w, n in recorded.calls]
        counts = train_counts()
        with open(f"{tmp}/eval_results.json") as f:
            payload = json.load(f)
    steps = sum(n for _, _, n in trains)
    train_s = sum(w for _, w, _ in trains)
    train_ms = train_s * 1e3 / max(steps, 1)
    trainer = trains[-1][0]
    cfg = trainer.model.config
    batch = trainer._put_batch(make_batch(
        7, npred=cfg.max_predictions_per_seq, seq=cfg.max_sequence_length))
    device_ms, breakdown = device_breakdown(
        torch, lambda: trainer.train_step(batch), calls=3, top=8,
        forbid=SIMT_FP32_STEP)
    idle = None if device_ms is None else 1 - device_ms / train_ms
    layers = cfg.num_layers
    print(f"oracle gate ({ORACLE_SCALE}, bert4rec, "
          f"{payload['generator']['epochs']} epochs): {wall:.1f} s, of "
          f"which train() {train_s:.1f} s for {steps} steps in "
          f"{len(trains)} runs ({train_ms:.3f} ms a step); ratios "
          f"{payload['oracle_gap']} against gates {payload['gates']}; "
          f"model {payload['results']}; bayes oracle "
          f"{payload['results_bayes_oracle']}; floor "
          f"{payload['results_popularity_floor']}; broken masking rate "
          f"{payload['results_broken_masking_rate']}", flush=True)
    print(f"oracle gate launches {nonzero(counts)} (layers x steps = "
          f"{layers * steps}, steps {steps}); one step: device "
          + ("not measured" if idle is None else
             f"{device_ms:.3f} ms, idle share of train() {idle:.3f}")
          + f"; {breakdown}", flush=True)
    int8 = payload["results_int8"]
    print(f"oracle gate int8 table: {int8['table_bytes_fp32']} -> "
          f"{int8['table_bytes_int8']} bytes; NDCG@10 drop "
          f"{int8['ndcg10_drop_vs_fp32']}, HR@10 drop "
          f"{int8['hr10_drop_vs_fp32']} (gate {int8['gate_ndcg10_drop']}); "
          f"int8 model {int8['results']}", flush=True)
    print(f"oracle gate checks {payload['checks']}", flush=True)
    if ORACLE_SCALE == "ml1m" and (int8["table_bytes_fp32"],
                                   int8["table_bytes_int8"]) \
            != (1_899_008, 489_588):
        raise AssertionError(f"the ml1m int8 table's bytes: {int8}")
    check = f"int8_ndcg10_drop_within_{int8['gate_ndcg10_drop']}"
    if payload["checks"].get(check) is not True:
        raise AssertionError(f"the int8 check failed: {int8}")
    if not (counts["tf32_fwd"] == counts["layer_fwd"] > 0
            and counts["tf32_bwd"] == counts["layer_bwd"] > 0
            and counts["mma_sync_fwd"] == counts["mma_sync_bwd"] == 0
            and counts["K4"] > 0):
        raise AssertionError(f"the oracle run's layer launches are not all "
                             f"on the 3xTF32 route: {counts}")
    if rc != 0 or not all(payload["checks"].values()):
        raise AssertionError(f"the oracle gate failed: {payload['checks']}")
    return dict(counts=counts, wall=wall, train_ms=train_ms,
                device_ms=device_ms, idle=idle, payload=payload)


# --------------------------------------------------------------------------- #
# phase 22: the deployment surface at ml-1m_128 (train, checkpoint in the JAX
# layout and resume, profile, export, serve the artifact, rank)
# --------------------------------------------------------------------------- #

DEPLOY_BATCHES = (1, 32, 256)
DEPLOY_EXCLUDE = 256          # the exported exclusion width
DEPLOY_CANDIDATES = 101       # the sampled protocol's 1 + 100 negatives


def layer_kernels_of(names) -> list:
    """The fused layer's kernels among ``names``: the 3xTF32 ones must be
    there, and no SIMT or earlier bf16 layer kernel may be."""
    bad = [n for n in names if SIMT_FP32_LAYER.search(n)
           or LEGACY_BF16_LAYER.search(n)]
    tf32 = [n for n in names if TF32_LAYER[0].search(n)]
    if bad or not any(TF32_LAYER[1] in n for n in tf32):
        raise AssertionError(f"fp32 layer launches ran {bad or 'no'} "
                             f"off-route kernels and 3xTF32 kernels {tf32}")
    return tf32


def check_topk_close(torch, got, want, label, k=10, tol=LOGIT_TOL):
    """An artifact's (ids, scores) against the eager model's: scores within
    ``tol``; ids equal at every rank whose neighbours' eager scores are
    further apart than ``tol`` (the last rank's lower neighbour lies
    outside the top k, so its id is held by its score alone). Returns the
    count of ranks held id for id and the scores' largest difference."""
    ids, vals = (t.float().cpu() for t in got)
    wids, wvals = (t.float().cpu() for t in want)
    err = float((vals - wvals).abs().max())
    gaps = wvals[..., :-1] - wvals[..., 1:]
    inf = torch.full_like(gaps[..., :1], math.inf)
    margin = torch.minimum(torch.cat([inf, gaps], -1),
                           torch.cat([gaps, torch.zeros_like(inf)], -1)) > tol
    wrong = int((margin & (ids != wids)).sum())
    if not (err <= tol and wrong == 0 and ids.shape[-1] == k):
        raise AssertionError(f"{label}: scores differ by {err}, {wrong} ids "
                             f"differ at ranks with a margin")
    return int(margin.sum()), err


def check_deployment(torch, device):
    """Phase 22: the port's deployment flow at ml-1m_128 full width (the
    harness's ml1m preset, fp32): a few train steps saved in the JAX
    trainer's layout, reloaded and resumed bit for bit; ``train(
    profile_dir=...)``'s trace; top-k and candidate-scoring artifacts, fp32
    and int8, at a symbolic batch, saved and loaded; ``ArtifactRecommender``
    and ``ServingServer`` over the fp32 one at B = 1, 32 and 256 against
    the eager ``Recommender`` and the plain path, only 3xTF32 layer kernels
    launched; one ``Ranker`` call; the three example flows; one bf16
    bert_base_512 artifact (K8 on ``wgmma``) at B=4 against eager."""
    from contextlib import ExitStack
    from unittest import mock

    import numpy as np
    from bert4rec_tpu_torch.apps import (
        ArtifactRecommender, Ranker, Recommender, RecommenderService,
        ServingServer,
    )
    from bert4rec_tpu_torch.apps.recommender import build_exclusion_rows
    from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
    from bert4rec_tpu_torch.models import export, quantization
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    from bert4rec_tpu_torch.utils.checkpoint import flatten, load_npz
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 22)
    new = lambda **kw: harness_ml1m_trainer(torch, device, **kw)  # noqa: E731
    init = {k: v.detach().clone()
            for k, v in flatten(new().state["params"]).items()}
    ds = SyntheticDataset(3, seed=11)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        # 1. train, save in the JAX layout, reload and resume
        whole = new(params=init)
        whole.train(ds, epochs=2, batch_size=STREAM_BATCH, seed=SEED,
                    verbose=False)
        first = new(params=init)
        first.train(ds, epochs=1, batch_size=STREAM_BATCH, seed=SEED,
                    verbose=False)
        first.save_checkpoint(f"{tmp}/state.npz")
        stored = load_npz(f"{tmp}/state.npz")
        layout = {k: (str(stored[k].dtype), stored[k].shape) for k in
                  ("step", "rng", "opt_state/1/0/count",
                   "opt_state/1/2/count")}
        if layout != {"step": ("int32", ()), "rng": ("uint32", (2,)),
                      "opt_state/1/0/count": ("int32", ()),
                      "opt_state/1/2/count": ("int32", ())} \
                or any(k.startswith("opt_state/mu") for k in stored):
            raise AssertionError(f"the checkpoint is not in the JAX "
                                 f"trainer's layout: {layout}")
        resumed = new(params=init)
        resumed.train(ds, checkpoint_path=f"{tmp}/state.npz", epochs=2,
                      batch_size=STREAM_BATCH, seed=SEED, verbose=False)
        fw, fr = flatten(whole.state["params"]), \
            flatten(resumed.state["params"])
        if not (resumed.state["step"] == whole.state["step"] == 6
                and all(torch.equal(fw[k], fr[k]) for k in fw)):
            raise AssertionError("the resume from the JAX-layout checkpoint "
                                 "does not repeat the uninterrupted bits")
        print(f"deployment: train 3 steps, checkpoint in the JAX layout "
              f"({layout}), a new trainer resumed to step 6: params equal "
              f"the uninterrupted run's bit for bit", flush=True)

        # 2. train(profile_dir=...): the trace holds the 3xTF32 kernels
        prof = new(params=init)
        prof.train(SyntheticDataset(4, seed=12), epochs=1,
                   batch_size=STREAM_BATCH, seed=SEED, verbose=False,
                   profile_dir=f"{tmp}/prof", profile_steps=2)
        traces = sorted(pathlib.Path(f"{tmp}/prof").glob("trace_*.json"))
        events = json.loads(traces[0].read_text())["traceEvents"]
        names = sorted({_kernel_name(e["name"]) for e in events
                        if e.get("cat") == "kernel"})
        tf32_fwd = [n for n in names if TF32_LAYER[0].search(n)]
        tf32_bwd = [n for n in names if TF32_LAYER_BWD[0].search(n)]
        if len(traces) != 1 or any(SIMT_FP32_STEP.search(n) for n in names) \
                or TF32_LAYER[1] not in " ".join(tf32_fwd) \
                or TF32_LAYER_BWD[1] not in " ".join(tf32_bwd):
            raise AssertionError(f"train(profile_dir=...) wrote {traces}; "
                                 f"its kernels: {names}")
        print(f"deployment: train(profile_dir=..., profile_steps=2) wrote "
              f"{traces[0].name} ({traces[0].stat().st_size} bytes): "
              f"{len(names)} kernels, the 3xTF32 layer's among them "
              f"({', '.join(sorted(set(tf32_fwd + tf32_bwd))[:6])}...), no "
              f"SIMT one", flush=True)
        del whole, first, prof
        trainer = resumed
        model, params = trainer.model, trainer.params
        cfg = model.config

        # 3. export, save and load: top-k and candidate scoring, fp32 and
        #    int8, at a symbolic batch
        arts, sizes, t_export = {}, {}, {}
        for name, fn in (
                ("top_k", lambda q: export.export_top_k(
                    model, params, 10, num_exclude=DEPLOY_EXCLUDE,
                    quantize=q)),
                ("score_candidates", lambda q: export.export_score_candidates(
                    model, params, DEPLOY_CANDIDATES, quantize=q))):
            for q in (None, "int8"):
                key = f"{name}{'_int8' if q else ''}"
                t0 = time.perf_counter()
                path = f"{tmp}/{key}.pt2"
                export.save_artifact(fn(q), path)
                arts[key] = export.load_artifact(path)
                t_export[key] = time.perf_counter() - t0
                sizes[key] = os.path.getsize(path)
        limit = export.batch_limit(model)
        b_sym = export.input_shapes(arts["top_k"])[0][0]
        if not isinstance(b_sym, torch.SymInt) or limit < max(DEPLOY_BATCHES):
            raise AssertionError(f"the artifact's batch is {b_sym} "
                                 f"(limit {limit})")
        print(f"deployment: artifacts (symbolic batch up to {limit}) "
              f"export + save + load s "
              f"{ {k: round(v, 1) for k, v in t_export.items()} }; .pt2 "
              f"bytes {sizes}; item table bytes fp32 "
              f"{quantization.table_bytes(params)}, int8 "
              f"{quantization.table_bytes(quantization.quantize_params(params))}",
              flush=True)

        # 4. ArtifactRecommender and the service over the fp32 artifact,
        #    against the eager Recommender and the plain path
        items = [f"movie_{i:04d}" for i in range(N_ITEMS)]
        dataloader = BERT4RecDataloader(cfg.max_sequence_length,
                                        cfg.max_predictions_per_seq)
        dataloader.generate_vocab(items)
        if dataloader.tokenizer.get_vocab_size() != VOCAB:
            raise AssertionError("the synthetic catalog's vocabulary")
        eager = Recommender(model, params, dataloader, device=device)
        rec = ArtifactRecommender(arts["top_k"], dataloader)

        def history():
            n = int(rng.integers(1, DEPLOY_EXCLUDE - 3))
            return [items[j] for j in rng.choice(N_ITEMS, size=n,
                                                 replace=False)]

        same, artifact_launches = {}, {}
        for b in DEPLOY_BATCHES:
            hist = [history() for _ in range(b)]
            fel.fused_encoder_layer.launches = 0
            fel.fused_encoder_layer.tf32_launches = 0
            got = rec.recommend_batch(hist)
            launches = (fel.fused_encoder_layer.launches,
                        fel.fused_encoder_layer.tf32_launches)
            if launches != (cfg.num_layers,) * 2:
                raise AssertionError(f"the fp32 artifact at B={b} launched "
                                     f"{launches} (layer, 3xTF32)")
            artifact_launches[b] = launches[0]
            want = eager.recommend_batch(hist, top_k=10)
            check_answers(torch, eager, hist, [10] * b, got,
                          f"deployment artifact B={b}")
            same[b] = sum(g == w for g, w in zip(got, want))
        # the kernels one artifact call runs, and its host and device time
        # at B=32 beside the eager path's
        hist = [history() for _ in range(32)]
        tf32 = layer_kernels_of(device_ops(
            torch, lambda: rec.recommend_batch(hist), need=TF32_LAYER[1:]))
        timing = {}
        for label, fn in (("artifact", lambda: rec.recommend_batch(hist)),
                          ("eager", lambda: eager.recommend_batch(
                              hist, top_k=10))):
            wall = []
            for _ in range(6):
                t0 = time.perf_counter()
                fn()                      # ends in a device->host copy
                wall.append((time.perf_counter() - t0) * 1e3)
            timing[label] = (sorted(wall)[3],
                             *device_breakdown(torch, fn, calls=5, top=4))
        print(f"deployment: ArtifactRecommender at B={DEPLOY_BATCHES}: "
              f"lists equal to the eager Recommender's {same}; every call "
              f"{cfg.num_layers} layer launches, all 3xTF32 "
              f"({sorted(set(tf32))})", flush=True)
        for label, (wall, dev, text) in timing.items():
            print(f"recommend_batch B=32 {label}: host wall {wall:.3f} ms "
                  f"(median of 6); {text}", flush=True)

        service = RecommenderService(rec, max_k=10, batch_capacity=32,
                                     max_wait_ms=2.0)
        server = ServingServer(service, port=0).start()
        try:
            hist = [history() for _ in range(16)]
            ks = [int(k) for k in rng.integers(1, 11, size=16)]
            post(server.port, hist[0], ks[0])
            with ThreadPoolExecutor(max_workers=16) as pool:
                answers = list(pool.map(lambda a: post(server.port, *a),
                                        zip(hist, ks)))
        finally:
            server.stop()
        check_answers(torch, eager, hist, ks, answers,
                      "deployment ServingServer over the artifact")

        # the int8 top-k and both candidate-scoring artifacts against the
        # eager model on the same (quantized) params
        qparams = quantization.quantize_params(params)
        hist = [history() for _ in range(32)]
        feats = dataloader.prepare_inference_batch(hist)
        batch = eager._batch(feats)
        exclude = torch.from_numpy(build_exclusion_rows(
            hist, dataloader.tokenizer, model.special_token_ids,
            width=DEPLOY_EXCLUDE)).to(device)
        args = [batch[k] for k in ("input_word_ids", "input_mask",
                                   "masked_lm_positions")]
        cands = torch.from_numpy(rng.integers(
            3, VOCAB, (32, cfg.max_predictions_per_seq, DEPLOY_CANDIDATES))
            .astype(np.int32)).to(device)
        with torch.inference_mode():
            held, q_err = check_topk_close(
                torch, arts["top_k_int8"].module()(*args, exclude),
                model.rank_top_k(qparams, batch, 10, exclude=exclude),
                "int8 top-k artifact B=32")
            s_err = {}
            for key, p in (("score_candidates", params),
                           ("score_candidates_int8", qparams)):
                got = arts[key].module()(*args, cands)
                want = model.score_candidates(p, batch, cands)
                s_err[key] = float((got - want).abs().max())
                if not (got.shape == want.shape
                        and s_err[key] <= LOGIT_TOL):
                    raise AssertionError(f"{key} artifact B=32: {s_err}")
        print(f"deployment: int8 top-k artifact B=32 scores within "
              f"{q_err:.3g} of the eager int8 model ({held} ranks held id "
              f"for id); candidate-scoring artifacts max abs err {s_err}",
              flush=True)

        # 6. one Ranker call, its rank the count of logits >= the target's
        ranker = Ranker(model, params, dataloader, device=device)
        hist = history()
        rank, text = ranker(hist, rank_item=items[7])
        with torch.inference_mode():
            logits = model.apply(params, eager._batch(
                dataloader.prepare_inference(hist)))["mlm_logits"][0, 0]
        want_rank = int((logits >= logits[dataloader.tokenizer.tokenize(
            items[7])]).sum())
        if rank != want_rank:
            raise AssertionError(f"Ranker: {rank}, logits count {want_rank}")
        print(f"deployment: Ranker: {text}", flush=True)
        del trainer, resumed, eager, rec, arts
        torch.cuda.empty_cache()

        # 7. the port's three example flows, on the card
        from bert4rec_tpu_torch.examples import (
            ranker_app, save_and_load, serving_export,
        )
        t0 = time.perf_counter()
        saved = save_and_load.main(device=str(device))
        ranked = ranker_app.main(device=str(device))
        exported = serving_export.main(f"{tmp}/examples", str(device))
        t_examples = time.perf_counter() - t0
        if not (saved["identical_outputs"] and saved["resumed_step"] == 6
                and saved["resumed_seed"] == 7 and ranked["rank"] >= 1
                and exported["int8_bytes"] < exported["fp32_bytes"]
                and len(exported["recommended"]) == 3):
            raise AssertionError(f"the example flows: {saved}, {ranked}, "
                                 f"{exported}")
        print(f"deployment: the three example flows ran on the card in "
              f"{t_examples:.1f} s", flush=True)

        # 5. one bf16 bert_base_512 artifact at B=4 against eager: K8 on
        #    its wgmma route through the exported program
        base = bert_base_trainer(torch, device)
        bmodel, bparams = base.model, base.params
        t0 = time.perf_counter()
        bart = export.export_top_k(bmodel, bparams, 10)
        export.save_artifact(bart, f"{tmp}/base.pt2")
        bart = export.load_artifact(f"{tmp}/base.pt2")
        t_base = time.perf_counter() - t0
        bbatch = {k: v[:4] for k, v in base._put_batch(base_batch(9)).items()
                  if k in ("input_word_ids", "input_mask",
                           "masked_lm_positions")}
        calls, launch = [], fa._launch_forward

        def record(q, k, v, mask, seed, rate, causal, save):
            calls.append((q, k, v, mask, seed, rate, causal))
            return launch(q, k, v, mask, seed, rate, causal, save)

        def unrounded(q, k, v, mask, seed, rate, causal, save):
            return (fa._probs(q, k, mask, causal) @ v.float()).to(q.dtype), ()

        before = {a: getattr(fa.flash_attention, a) for a in FLASH_COUNTERS}
        with torch.inference_mode():
            with mock.patch.object(fa, "_launch_forward", record):
                got = bart.module()(bbatch["input_word_ids"],
                                    bbatch["input_mask"],
                                    bbatch["masked_lm_positions"])
            torch.cuda.synchronize()
            moved = {a: getattr(fa.flash_attention, a) - before[a]
                     for a in FLASH_COUNTERS}
            want = bmodel.rank_top_k(bparams, bbatch, 10)
            # the plain version: the same eager call with every kernel
            # launch sent to its plain PyTorch body
            with ExitStack() as stack:
                for patch in plain_kernels():
                    stack.enter_context(patch)
                plain = bmodel.rank_top_k(bparams, bbatch, 10)
            with mock.patch.object(fa, "_launch_forward", unrounded):
                spread = float((bmodel.rank_top_k(bparams, bbatch, 10)[1]
                                .float() - plain[1].float()).abs().max())
            # the bf16 K8 operator on each of the program's calls' operands
            # (projection views) against its plain version
            op_err = 0.0
            for q, k, v, mask, seed, rate, causal in calls:
                o = fa.flash_attention_forward(q, k, v, mask, seed, rate,
                                               causal)
                ref = fa.mha_reference(q, k, v, mask, rate, seed, causal)
                if o.stride() != fa._empty_heads(q).stride():
                    raise AssertionError(f"the K8 operator's output strides "
                                         f"{o.stride()}")
                op_err = max(op_err,
                             float((o.float() - ref.float()).abs().max()))
        want_moved = dict.fromkeys(FLASH_COUNTERS, 0)
        want_moved["launches"] = bmodel.config.num_layers
        if moved != want_moved:
            raise AssertionError(f"the bf16 bert_base_512 artifact launched "
                                 f"{moved}, expected {want_moved}")
        if len(calls) != bmodel.config.num_layers \
                or not op_err <= FLASH_TOL["bfloat16"]:
            raise AssertionError(f"the bf16 K8 operator on the artifact's "
                                 f"{len(calls)} calls' operands: max abs err "
                                 f"{op_err} (tol {FLASH_TOL['bfloat16']})")
        b_held, b_err = check_topk_close(torch, got, want,
                                         "bf16 bert_base_512 artifact B=4")
        p_tol = BF16_LOGIT_TOL * float(plain[1].float().abs().max())
        p_held, p_err = check_topk_close(
            torch, got, plain, "bf16 bert_base_512 artifact B=4 vs plain",
            tol=p_tol)
        print(f"deployment: bf16 bert_base_512 artifact (export + save + "
              f"load {t_base:.1f} s, {os.path.getsize(f'{tmp}/base.pt2')} "
              f"bytes) at B=4: K8 launches {moved['launches']} on wgmma, "
              f"scores within {b_err:.3g} of eager ({b_held} ranks held id "
              f"for id) and within {p_err:.3g} of the plain version (tol "
              f"{p_tol:.3g}, {BF16_LOGIT_TOL} of its largest score; "
              f"{p_held} ranks held id for id; a second plain rounding "
              f"{spread:.3g} from it); the K8 operator on each "
              f"call's operands within {op_err:.3g} of its plain version "
              f"(tol {FLASH_TOL['bfloat16']})", flush=True)
        del base, bart
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"deployment phase: {seconds:.1f} s", flush=True)
    return dict(launches=artifact_launches, timing=timing, sizes=sizes,
                seconds=seconds)


# --------------------------------------------------------------------------- #
# phase 23: the (data, model) mesh at reddit_128 width, ranks on the card(s)
# --------------------------------------------------------------------------- #

MESH_VOCAB = 335_423          # Reddit: 335,420 items + [PAD], [MASK], [UNK]
MESH_PAD_TO = 1024            # -> 335,872 rows: 167,936 a shard at 'model' 2
MESH_SHAPE = (1, 2)           # (data, model)
MESH_STEPS = 3                # train() steps held against one process
MESH_TIMED_STEPS = 5
MESH_EVAL_ROWS = 512          # leave-one-out rows of the evaluation
MESH_TOPK_ROWS = 32
MESH_TOL = {"loss": 1e-5, "grad": 1e-4, "table": 1e-5, "metric": 1e-6}
MESH_COUNTERS = ("sharded.launches", "sharded.merged_launches",
                 "sharded.two_sweep_launches", "tiled.launches",
                 "layer.tf32_launches", "layer.tf32_backward_launches")


def mesh_counters(reset=False) -> dict:
    """The launch counters of the sharded loss (K5's stats entry, K6, K7),
    the unsharded tiled loss and the fp32 layer; with ``reset`` set to 0
    first."""
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    from bert4rec_tpu_torch.ops import sharded_mlm_loss as sml
    owners = {"sharded": sml.sharded_fused_mlm_loss,
              "tiled": fml.fused_mlm_loss_tiled,
              "layer": fel.fused_encoder_layer}
    out = {}
    for key in MESH_COUNTERS:
        owner, attr = key.split(".")
        if reset:
            setattr(owners[owner], attr, 0)
        out[key] = getattr(owners[owner], attr)
    return out


def mesh_model(torch):
    """reddit_128 at its full width, the Reddit oracle preset's fp32, the
    vocabulary padded to a multiple of 1,024, dropout 0 (parity)."""
    from bert4rec_tpu_torch.config import load_train_config
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.models import BERT4RecModel
    config = load_train_config(
        "reddit_128", vocab_size=MESH_VOCAB, vocab_pad_to=MESH_PAD_TO,
        attention_dropout=0.0, output_dropout=0.0, use_fused_layer=True,
        use_fused_loss=True)
    return BERT4RecModel(config=config, dtype_policy=DTypePolicy.f32())


def mesh_trainer(torch, device, mesh=None):
    """A trainer of ``mesh_model`` from seed 0 (on a mesh: this rank's
    pieces of the same params)."""
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
    model = mesh_model(torch)
    trainer = BERT4RecTrainer(model, mesh=mesh)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(init_lr=1e-3,
                                                     num_warmup_steps=1),
        params=model.init(torch.Generator().manual_seed(SEED), device),
        seed=SEED, device=device)
    return trainer


class MeshBatches:
    """train()'s dataset contract: one Reddit-vocabulary batch per call,
    seeded by the epoch; on a mesh this rank's 'data' slice of it."""

    def __init__(self, mesh=None):
        self.mesh = mesh

    def batches(self, batch_size, shuffle=True, seed=None,
                drop_remainder=False, pad_final_batch=False):
        from bert4rec_tpu_torch.core import partitioning
        batch = make_batch(500 + (seed or 0), batch_size, vocab=MESH_VOCAB)
        if self.mesh is not None:
            batch = partitioning.global_slice(self.mesh, batch)
        yield batch


def mesh_loss_inputs(torch, device):
    """One train batch's rows (B x P = 10,240, W=128) against the padded
    Reddit table, fp32, labels with pads, label 0 and a shard boundary."""
    import numpy as np
    rng = np.random.default_rng(SEED + 23)
    vp = -(-MESH_VOCAB // MESH_PAD_TO) * MESH_PAD_TO
    gen = torch.Generator().manual_seed(SEED + 23)
    hidden = torch.randn((N_ROWS, HIDDEN), generator=gen).to(device)
    table = (torch.randn((vp, HIDDEN), generator=gen) * 0.1).to(device)
    bias = torch.randn((vp,), generator=gen).to(device)
    lab = rng.integers(3, MESH_VOCAB, size=N_ROWS).astype(np.int32)
    lab[::9] = 0
    lab[1], lab[2] = vp // 2, vp // 2 - 1   # the first row of shard 1, the
    return hidden, table, bias, torch.from_numpy(lab).to(device)  # last of 0


def mesh_eval_data():
    """Leave-one-out test sequences over the Reddit vocabulary and the
    sampler's source."""
    import numpy as np
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset,
    )
    rng = np.random.default_rng(SEED + 24)
    seqs = [rng.integers(3, MESH_VOCAB, size=int(rng.integers(20, SEQ)))
            .astype(np.int32) for _ in range(MESH_EVAL_ROWS)]
    cfg = MaskingConfig(max_seq_len=SEQ, max_predictions_per_seq=40,
                        mask_token_id=1, pad_token_id=0, unk_token_id=2,
                        masked_lm_rate=0.2)
    ds = ProcessedDataset(seqs, cfg, lambda: MESH_VOCAB,
                          finetuning=np.full(len(seqs), True))
    return ds, [int(t) for s in seqs for t in s]


def mesh_evaluate(torch, model, params, mesh=None) -> dict:
    """The sampled 101-candidate protocol (device negatives, seed 7) and the
    full catalog, as ``{"sampled/...": x, "full/...": x}``."""
    from bert4rec_tpu_torch.dataloaders import samplers
    from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
    ds, source = mesh_eval_data()
    if mesh is not None:
        ds = ds.shard_for_process(mesh=mesh)
    sampler = samplers.get("pop_random", source=source,
                           vocab=list(dict.fromkeys(source)),
                           sample_size=100, seed=EVAL_SEED)
    out = {}
    for name, ev in (("sampled", BERT4RecEvaluator(
            sampler=sampler, sample_size=100, seed=EVAL_SEED, mesh=mesh)),
            ("full", BERT4RecEvaluator(full_ranking=True, mesh=mesh))):
        with torch.no_grad():
            got = ev.evaluate(model, params, ds, batch_size=128,
                              progress_bar=False)
        out.update({f"{name}/{k}": v for k, v in got.items()})
    return out


def mesh_probe_batch(torch, device, rows):
    """A batch of ``rows`` Reddit-vocabulary rows with its exclusion rows
    (the special tokens)."""
    import numpy as np
    b = make_batch(900, rows, npred=8, vocab=MESH_VOCAB)
    inputs = {k: torch.from_numpy(b[k]).to(device)
              for k in ("input_word_ids", "input_mask",
                        "masked_lm_positions")}
    excl = torch.from_numpy(np.tile(np.int32([0, 1, 2, -1]), (rows, 1))) \
        .to(device)
    return inputs, excl


def one_at_a_time(mesh, fn):
    """``fn()`` on each rank in turn (the others wait), so a time taken on
    a card that ranks share is not shared with another rank's work."""
    from bert4rec_tpu_torch.core import mesh as mesh_lib
    out = None
    for r in range(mesh.size("data") * mesh.size("model")):
        if mesh.rank == r:
            out = fn()
        mesh_lib.barrier(mesh)
    return out


def mesh_rank(mesh, out):
    """One rank of phase 23 (run by ``tools/mesh_run.py``): the sharded loss
    against the one-process loss, its kernels timed at the shard's shape;
    ``train()``; top-k, the evaluations and a checkpoint on the mesh.
    Returns what the main process compares."""
    import numpy as np
    import torch
    from bert4rec_tpu_torch.core import mesh as mesh_lib
    from bert4rec_tpu_torch.core import partitioning
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    from bert4rec_tpu_torch.ops import sharded_mlm_loss as sml
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, dev = pathlib.Path(out), mesh.device
    res = {}

    # (1) the sharded loss and its gradients against the one-process loss
    # on the whole table, the kernels' operands recorded as they launch
    h, table, bias, lab = mesh_loss_inputs(torch, dev)
    m, mp = mesh.index("model"), mesh.size("model")
    vl = table.shape[0] // mp
    rows = partitioning.global_slice(mesh, {"h": h, "lab": lab})
    hs = rows["h"].clone().requires_grad_(True)
    ts = table[m * vl:(m + 1) * vl].clone().requires_grad_(True)
    bs = bias[m * vl:(m + 1) * vl].clone().requires_grad_(True)
    calls = {}
    launch = {"K5": fml._launch_forward_tiled_stats,
              "K6": fml._launch_backward_tiled}

    def recording(key):
        def fn(*args, **kw):
            calls[key] = (args, kw)
            return launch[key](*args, **kw)
        return fn

    fml._launch_forward_tiled_stats = recording("K5")
    fml._launch_backward_tiled = recording("K6")
    try:
        mesh_counters(reset=True)
        loss, cv, ca, nv = sml.sharded_fused_mlm_loss(
            hs, ts, bs, rows["lab"], MESH_VOCAB, mesh)
        loss.backward()
        path = mesh_counters()
    finally:
        fml._launch_forward_tiled_stats = launch["K5"]
        fml._launch_backward_tiled = launch["K6"]
    if not (path["sharded.launches"] == path["sharded.merged_launches"] == 1
            and calls["K6"][0][7] is True
            and calls["K6"][1] == {"valid_ge_zero": True}):
        raise AssertionError(f"rank {mesh.rank}: the sharded loss launched "
                             f"{path} (want K5's stats entry and K6 with "
                             f"valid_ge_zero once each)")
    hw, tw, bw = (x.clone().requires_grad_(True) for x in (h, table, bias))
    want = fml.fused_mlm_loss_tiled(hw, tw, bw, lab, MESH_VOCAB)
    want[0].backward()
    dh_want = partitioning.global_slice(mesh, {"g": hw.grad})["g"]
    res["loss_err"] = abs(float(loss) - float(want[0])) / abs(float(want[0]))
    res["counts_equal"] = all(float(a) == float(b) for a, b in
                              zip((cv, ca, nv), want[1:]))
    res["grad_err"] = max(
        rel_err(hs.grad, dh_want),
        rel_err(ts.grad, tw.grad[m * vl:(m + 1) * vl]),
        rel_err(bs.grad, bw.grad[m * vl:(m + 1) * vl]))
    del hw, tw, bw, want, dh_want
    torch.cuda.empty_cache()

    # (2) this shard's K5 stats and K6 (valid_ge_zero) launches on the
    # recorded operands timed, each rank in turn
    def kernel_rows():
        (k5_args, _), (k6_args, k6_kw) = calls["K5"], calls["K6"]
        th, tt, tb, tlab = k5_args
        _, plain_stats, _ = plain_tiled(torch, fml, th, tt, tb, tlab)
        _, _, plain_bwd = plain_tiled(torch, fml, *k6_args[:4])
        lse, g, nvalid = k6_args[4:7]
        r_, v_, w_ = th.shape[0], tt.shape[0], tt.shape[1]
        label = f"mesh shard loss R={r_} V={v_} W={w_}"
        errs = {"K5": held(label, launch["K5"](*k5_args), plain_stats(),
                           LOSS_FWD_TOL),
                "K6": held(label, launch["K6"](*k6_args, **k6_kw), plain_bwd(
                    lse, g, nvalid[0], valid_ge_zero=True),
                    LOSS_TOL["float32"])}
        lib_fwd, lib_bwd = library_loss(torch, th, tt, tb, tlab)
        it = dict(iters=3, warmup=1)
        out_rows = {
            "K5": dict(max_abs_err=errs["K5"],
                       **timed(lambda: launch["K5"](*k5_args), **it),
                       **timed(plain_stats, "plain", **PLAIN),
                       **timed(lib_fwd, "library", **it),
                       **bound(roofline.loss_s, r_, v_, w_, False, "float32",
                               peak=roofline.TF32X3_FLOPS)),
            "K6": dict(max_abs_err=errs["K6"],
                       **timed(lambda: launch["K6"](*k6_args, **k6_kw), **it),
                       **timed(lambda: plain_bwd(
                           lse, g, nvalid[0], valid_ge_zero=True), "plain",
                           **PLAIN),
                       **timed(lib_bwd, "library", **it),
                       **bound(roofline.loss_s, r_, v_, w_, True, "float32",
                               peak=roofline.TF32X3_FLOPS))}
        del lib_fwd, lib_bwd
        torch.cuda.empty_cache()
        return out_rows

    rows_k = one_at_a_time(mesh, kernel_rows)
    for k, row in rows_k.items():
        res.update({f"{k}/{key}": (np.asarray(v, dtype=np.float64)
                                   if key != "bound_by" else np.asarray(v))
                    for key, v in row.items()})
    res["shard_shape"] = np.asarray([calls["K5"][0][0].shape[0],
                                     calls["K5"][0][1].shape[0], HIDDEN])
    del calls, h, table, bias, lab, hs, ts, bs, rows
    torch.cuda.empty_cache()

    # (3) train(): MESH_STEPS steps, the launches by route counted
    trainer = mesh_trainer(torch, dev, mesh)
    mesh_counters(reset=True)
    hist = trainer.train(MeshBatches(mesh), epochs=MESH_STEPS,
                         batch_size=STREAM_BATCH, steps_per_epoch=1,
                         verbose=False)
    torch.cuda.synchronize()
    res.update({f"counts/{k}": v for k, v in mesh_counters().items()})
    res["losses"] = np.asarray(hist.history["loss"])
    whole = trainer.gathered_params()
    if mesh.rank == 0:
        emb = whole["encoder"]["item_embeddings"]["embedding"]
        np.save(out / "mesh_table.npy", emb.detach().cpu().numpy())
    del whole
    # the step's wall, every rank synchronised (card and barrier) around it
    batch = trainer._put_batch(next(MeshBatches(mesh).batches(
        STREAM_BATCH, seed=0)))
    walls = []
    for _ in range(MESH_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        mesh_lib.barrier(mesh)
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        mesh_lib.barrier(mesh)
        walls.append((time.perf_counter() - t0) * 1e3)
    res["step_ms"] = float(np.median(walls[1:]))
    # the step's two largest all_reduces alone, over 'model': the
    # lookup's sum ([B, S, H] fp32) and the loss's dh ([B x P, W])
    for name, shape in (("lookup", (STREAM_BATCH, SEQ, HIDDEN)),
                        ("dh", (N_ROWS, HIDDEN))):
        x = torch.ones(shape, device=dev)
        walls = []
        for _ in range(MESH_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            mesh_lib.barrier(mesh)
            t0 = time.perf_counter()
            mesh_lib.all_reduce(mesh, x, "model")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        res[f"all_reduce_ms/{name}"] = float(np.median(walls[1:]))
    trainer.save_checkpoint(out / "mesh_ckpt.npz")
    probe, _ = mesh_probe_batch(torch, dev, 2)
    with torch.no_grad():
        res["ckpt_logits"] = trainer.model.apply(
            trainer.params, probe, mesh=mesh)["mlm_logits"]
    del trainer, batch
    torch.cuda.empty_cache()

    # (4) top-k and the evaluations on the seed's params (the one-process
    # run computes them from the same bits)
    model = mesh_model(torch)
    params = partitioning.shard_state(mesh, model.init(
        torch.Generator().manual_seed(SEED), dev))
    inputs, excl = mesh_probe_batch(torch, dev, MESH_TOPK_ROWS)
    with torch.no_grad():
        ids, vals = model.rank_top_k(params, inputs, 10, mesh=mesh,
                                     exclude=excl)
    res.update(topk_ids=ids, topk_vals=vals)
    res.update(mesh_evaluate(torch, model, params, mesh))
    return res


def check_mesh(torch, device):
    """Phase 23: ``MESH_SHAPE`` ranks (gloo on one card; NCCL where every
    rank has its own) at reddit_128 width through ``tools/mesh_run.py``,
    each running :func:`mesh_rank`; here the one-process run of the same
    trainer, top-k, evaluations and the sharded checkpoint reloaded.
    Returns the sharded kernels' rows and their launches."""
    import numpy as np
    from bert4rec_tpu_torch.tools import mesh_run
    t_phase = time.perf_counter()
    dp, mp = MESH_SHAPE
    world = dp * mp
    out = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))

    def row(x, k):   # a rank's K5 or K6 row, from its arrays
        return {key.split("/", 1)[1]: (str(v) if key.endswith("bound_by")
                                       else float(v) if not v.ndim
                                       else v.tolist())
                for key, v in x.items() if key.startswith(k + "/")}

    try:
        records = mesh_run.launch(
            [f"{pathlib.Path(__file__).resolve()}:mesh_rank"], data=dp,
            model=mp, device="cuda", out=out, timeout=600)
        ranks = mesh_run.load(out, "mesh_rank", world)
        for rec in records:
            print(f"mesh rank {rec['rank']} {rec['coords']} on "
                  f"{rec['device']} ({rec['backend']}): "
                  f"{rec['seconds']['mesh_rank']:.1f} s", flush=True)
        for r, x in enumerate(ranks):
            print(f"mesh rank {r}: sharded loss rel err "
                  f"{float(x['loss_err']):.3g} (tol {MESH_TOL['loss']}), "
                  f"counts equal {bool(x['counts_equal'])}, gradients "
                  f"{float(x['grad_err']):.3g} of their scale (tol "
                  f"{MESH_TOL['grad']}) against the one-process loss at "
                  f"R={N_ROWS}, V={MESH_VOCAB}", flush=True)
            if not (float(x["loss_err"]) <= MESH_TOL["loss"]
                    and bool(x["counts_equal"])
                    and float(x["grad_err"]) <= MESH_TOL["grad"]):
                raise AssertionError(f"mesh rank {r}: the sharded loss "
                                     f"against one process failed")
            for k in ("K5", "K6"):
                print(f"mesh rank {r} {k}"
                      f"{' stats' if k == 'K5' else ' valid_ge_zero'} at the "
                      f"shard's shape {x['shard_shape'].tolist()}: "
                      f"{timing_text(row(x, k))}", flush=True)
            print(f"mesh rank {r} train() launches: "
                  + ", ".join(f"{k.split('/', 1)[1]} {int(v)}"
                              for k, v in x.items()
                              if k.startswith("counts/")), flush=True)
            want_n = MESH_STEPS
            if not (int(x["counts/sharded.launches"]) == want_n
                    and int(x["counts/sharded.merged_launches"]) == want_n
                    and int(x["counts/sharded.two_sweep_launches"]) == 0
                    and int(x["counts/tiled.launches"]) == 0
                    and int(x["counts/layer.tf32_launches"]) == 2 * want_n):
                raise AssertionError(f"mesh rank {r}: train() did not run "
                                     f"the sharded kernels once a step")

        # the one-process run: train() on the same global batches
        one = mesh_trainer(torch, device)
        hist = one.train(MeshBatches(), epochs=MESH_STEPS,
                         batch_size=STREAM_BATCH, steps_per_epoch=1,
                         verbose=False)
        want = np.asarray(hist.history["loss"])
        table = np.load(out / "mesh_table.npy")
        ref_table = one.params["encoder"]["item_embeddings"]["embedding"] \
            .detach().cpu().numpy()
        table_err = float(np.abs(table - ref_table).max()
                          / np.abs(ref_table).max())
        moved = float(np.abs(ref_table - mesh_model(torch).init(
            torch.Generator().manual_seed(SEED), "cpu")["encoder"][
                "item_embeddings"]["embedding"].numpy()).max())
        for r, x in enumerate(ranks):
            err = float(np.abs(x["losses"] - want).max() / np.abs(want).max())
            print(f"mesh rank {r}: {MESH_STEPS} train() steps' losses "
                  f"{x['losses'].tolist()} against one process's "
                  f"{want.tolist()}: rel err {err:.3g} (tol "
                  f"{MESH_TOL['loss']})", flush=True)
            if not err <= MESH_TOL["loss"]:
                raise AssertionError(f"mesh rank {r}: step losses differ")
        print(f"mesh: the gathered table after {MESH_STEPS} steps is "
              f"{table_err:.3g} of its scale from one process's (tol "
              f"{MESH_TOL['table']}; the steps moved it by {moved:.3g})",
              flush=True)
        if not (table_err <= MESH_TOL["table"] and moved > 1e-4):
            raise AssertionError("mesh: the gathered table differs")
        batch = one._put_batch(next(MeshBatches().batches(STREAM_BATCH,
                                                          seed=0)))
        walls = []
        for _ in range(MESH_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.train_step(batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        one_ms = float(np.median(walls[1:]))
        card = card_line()
        print(f"mesh step at reddit_128 width (fp32, B={STREAM_BATCH}, P=40): "
              f"{world} ranks {[round(float(x['step_ms']), 3) for x in ranks]}"
              f" ms (median of {MESH_TIMED_STEPS} synchronised steps), one "
              f"process {one_ms:.3f} ms, on {card}; {world} ranks on one card "
              f"measure correctness and overhead, not scaling"
              if torch.cuda.device_count() < world else
              f"mesh step: {world} ranks "
              f"{[round(float(x['step_ms']), 3) for x in ranks]} ms, one "
              f"process {one_ms:.3f} ms, on {card}", flush=True)
        print(f"mesh all_reduce over 'model' alone "
              f"({records[0]['backend']}): " + ", ".join(
                  f"{k.split('/')[1]} {float(v):.3f} ms"
                  for k, v in ranks[0].items()
                  if k.startswith("all_reduce_ms/"))
              + f" (median of {MESH_TIMED_STEPS}, every rank synchronised)",
              flush=True)
        del one, batch
        torch.cuda.empty_cache()

        # the checkpoint the sharded run wrote, in one process
        again = mesh_trainer(torch, device)
        again.load_checkpoint(out / "mesh_ckpt.npz")
        probe, excl = mesh_probe_batch(torch, device, 2)
        with torch.no_grad():
            logits = again.model.apply(again.params, probe)["mlm_logits"]
        ckpt_err = float((logits.cpu() - torch.from_numpy(
            ranks[0]["ckpt_logits"])).abs().max())
        print(f"mesh: the sharded run's checkpoint (step "
              f"{again.state['step']}) in one process: logits within "
              f"{ckpt_err:.3g} of the mesh's (tol {TOL['float32']})",
              flush=True)
        if not (ckpt_err <= TOL["float32"]
                and again.state["step"] == MESH_STEPS + MESH_TIMED_STEPS + 1):
            raise AssertionError("mesh: the checkpoint's logits differ")
        del again
        torch.cuda.empty_cache()

        # top-k and the evaluations on the seed's params
        model = mesh_model(torch)
        params = model.init(torch.Generator().manual_seed(SEED), device)
        inputs, excl = mesh_probe_batch(torch, device, MESH_TOPK_ROWS)
        with torch.no_grad():
            want_topk = model.rank_top_k(params, inputs, 10, exclude=excl)
        metrics = mesh_evaluate(torch, model, params)
        for r, x in enumerate(ranks):
            held, err = check_topk_close(
                torch, (torch.from_numpy(x["topk_ids"]),
                        torch.from_numpy(x["topk_vals"])),
                want_topk, f"mesh rank {r} rank_top_k")
            diff = {k: abs(float(x[k]) - v) for k, v in metrics.items()}
            print(f"mesh rank {r}: rank_top_k {held} ranks held id for id, "
                  f"scores within {err:.3g}; evaluation (sampled and full "
                  f"catalog, {int(metrics['full/Valid Ranks'])} positions) "
                  f"largest metric difference {max(diff.values()):.3g}",
                  flush=True)
            bad = {k: d for k, d in diff.items()
                   if d > MESH_TOL["metric"] * max(abs(metrics[k]), 1.0)}
            if bad:
                raise AssertionError(f"mesh rank {r}: metrics differ {bad}")
        print(f"mesh evaluation: {json.dumps(metrics)}", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"mesh phase: {seconds:.1f} s", flush=True)
    total = {k: sum(int(x[f"counts/{k}"]) for x in ranks)
             for k in ("sharded.launches", "sharded.merged_launches")}
    return {"K5": row(ranks[0], "K5"), "K6": row(ranks[0], "K6"),
            "launches": total, "seconds": seconds}


# --------------------------------------------------------------------------- #
# phase 24: the measurement tools, and the kernel shapes of the shipped
# configs no earlier phase reaches
# --------------------------------------------------------------------------- #

# the shipped configs no earlier phase builds: each one's kernel step is held
# against its plain step before the sweep times it
NEW_CONFIGS = ("beauty_64", "beauty_128", "beauty_256", "ml-1m_64",
               "ml-1m_256", "ml-20m_64", "steam_64", "steam_128", "steam_256")
# one round of the sweep (24 steps a config), two of perf_guard (its 1-round
# fused speedup read 1.52-2.10 over three runs): the phase cuts rounds, never
# widths
TOOL_ROUNDS = 1
GUARD_ROUNDS = 2
# the bf16 layer shapes only the sweep's configs reach: (H, N, F, S) and the
# dropout rates of the first config named
NEW_LAYER_SHAPES = {
    "h64_f64_s50": (64, 2, 64, 50, (0.2, 0.5)),     # beauty_64
    "h64": (64, 2, 256, 200, (0.2, 0.2)),           # ml-1m_64, ml-20m_64
    "h64_s50": (64, 2, 256, 50, (0.1, 0.1)),        # steam_64
    "s50": (128, 4, 512, 50, (0.2, 0.5)),           # beauty_128, steam_128
    "h256_s50": (256, 8, 1024, 50, (0.2, 0.5)),     # beauty_256, steam_256
    "h256_f512": (256, 8, 512, 200, (0.2, 0.5)),    # ml-1m_256
}
# bf16 K3 / K4 at the table widths of ml-1m_64 and ml-1m_256
NEW_WHOLE_TABLE_WIDTHS = (64, 256)
STEAM_VOCAB = 13_047      # 13,044 games + [PAD], [MASK], [UNK]
# the bf16 tiled loss: (R, V, W, backward kernels): K5 and K6 at W=64 at
# ml-20m_64's batch (beauty_64's and steam_64's run the same kernels), and
# the merged K6 at W=256 at steam_256's R = 256 x 20 = 5,120 rows, whose dh
# fits merged_backward's 5.77 MB
NEW_TILED = {"w64": (N_ROWS, ML20M_VOCAB, 64, {"K6": True}),
             "w256": (STREAM_BATCH * 20, STEAM_VOCAB, 256, {"K6": True})}
SERVING_LOAD = dict(clients=16, requests=400)


def config_shape(name) -> dict:
    """A shipped config's kernel shape: hidden, inner, length, table
    width and the tiled loss's backward."""
    from bert4rec_tpu_torch.tools import config_sweep
    o, _ = config_sweep.build_overrides(name, config_sweep.load(name))
    return dict(h=o["hidden_size"], f=o["inner_dim"],
                s=o["max_sequence_length"], w=o["hidden_size"],
                **config_sweep.routes(o))


def swept(rows, counter, **shape) -> int:
    """The sweep's launches of ``counter`` over the configs of ``shape``."""
    return sum(row["launches"][counter] for name, row in rows.items()
               if all(config_shape(name)[k] == v for k, v in shape.items()))


def run_perf_guard() -> tuple:
    """``tools.perf_guard`` as its command line, ``GUARD_ROUNDS`` rounds,
    in a process of its own (its budgets hold the tool's runs, not a process
    that has run 23 phases): its exit code and report."""
    proc = subprocess.run(
        [sys.executable, "-m", "bert4rec_tpu_torch.tools.perf_guard",
         "--rounds", str(GUARD_ROUNDS)], capture_output=True, text=True,
        timeout=900, cwd=str(pathlib.Path(__file__).resolve().parent))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(f"perf_guard gave no report (exit "
                             f"{proc.returncode}): {proc.stderr[-2000:]}")
    return proc.returncode, json.loads(lines[-1])


def check_tools(torch, rng, device):
    """Phase 24: ``tools.bench``'s card run (its JSON line, ``vs_baseline``
    > 1); the kernels at the shapes only the shipped configs reach, timed;
    ``tools.config_sweep`` over all 13 configs at
    full width and depth (the nine configs no earlier phase builds held to
    the plain step first; each row's routes and launches checked);
    ``tools.serving_bench`` (p50 / p99); ``tools.perf_guard``'s ten variants
    against their budgets."""
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    from bert4rec_tpu_torch.tools import bench, config_sweep, serving_bench
    t_phase = time.perf_counter()
    out = {}

    report = bench.card_report(device)
    print(json.dumps(report["result"]), flush=True)
    if not report["result"]["vs_baseline"] > 1:
        raise AssertionError(f"bench: the card is not faster than the host "
                             f"CPU: {report}")
    out["bench"] = report
    torch.cuda.empty_cache()

    # the kernels at the new shapes, bf16, B=256 (the sweep's batch),
    # timed; no profiler trace of their launches: at
    # the end of a long process the profiler drops records (PERF.md §7),
    # and the launch counters of the sweep show the routes
    out["layer"] = {
        key: check_layer_training(
            torch, rng, device, h=h, n=n, f=f, rates=rates,
            cases=[(torch.bfloat16, STREAM_BATCH)], seq=s,
            trace=False)[("bfloat16", STREAM_BATCH)]
        for key, (h, n, f, s, rates) in NEW_LAYER_SHAPES.items()}
    out["whole_table"] = {
        w: check_loss_case(torch, rng, device, N_ROWS, VOCAB, w,
                           torch.bfloat16, {"K4": None}, trace=False)
        for w in NEW_WHOLE_TABLE_WIDTHS}
    out["tiled"] = {key: check_loss_case(torch, rng, device, r, v, w,
                                          torch.bfloat16, kernels,
                                          trace=False)
                    for key, (r, v, w, kernels) in NEW_TILED.items()}
    torch.cuda.empty_cache()

    def parity(runner):
        if runner.name in NEW_CONFIGS:
            check_step_parity(torch, runner.trainer, runner.batches[0],
                              f"{runner.name}, config_sweep")

    t0 = time.perf_counter()
    rows = config_sweep.sweep(config_sweep.config_names(), TOOL_ROUNDS,
                              device, before_timing=parity)
    steps = TOOL_ROUNDS * config_sweep.STEPS_PER_ROUND
    for name, row in rows.items():
        shape = config_shape(name)
        layers = 2 * steps     # every shipped config has 2 layers
        whole = row["loss_kernel"] == "whole_table"
        want = dict(layer_fwd=layers, layer_bwd=layers, mma_sync_fwd=0,
                    mma_sync_bwd=0, K3=steps * whole, K4=steps * whole,
                    K5=steps * (not whole),
                    K6=steps * (row["loss_backward"] == "K6"),
                    K7=steps * (row["loss_backward"] == "K7"))
        print(f"sweep {name}: {row['ms_per_step']:.4f} ms a step, "
              f"{row['examples_per_sec']:.1f} examples/s, layer "
              f"{row['layer_kernel']} (H={shape['h']} F={shape['f']} "
              f"S={shape['s']}), loss {row['loss_kernel']} / "
              f"{row['loss_backward']} (W={shape['w']}, V={row['vocab']}, "
              f"R={STREAM_BATCH * row['npred']}); launches in {steps} "
              f"steps {row['launches']}", flush=True)
        if row["launches"] != want or row["layer_kernel"] != "wgmma":
            raise AssertionError(f"sweep {name}: launches "
                                 f"{row['launches']}, expected {want}; "
                                 f"routes {row}")
    print(f"sweep: 13 configs in {time.perf_counter() - t0:.1f} s, "
          f"{len(NEW_CONFIGS)} held to the plain step", flush=True)
    out["sweep"] = rows

    fel.fused_encoder_layer.launches = 0
    fel.fused_encoder_layer.mma_sync_launches = 0
    served = serving_bench.run(device=device, **SERVING_LOAD)
    out["serving_launches"] = fel.fused_encoder_layer.launches
    print(f"serving_bench {json.dumps(served)}; K1 launches "
          f"{out['serving_launches']} (bf16, wgmma)", flush=True)
    # the warm request's batch, then each of the timed ones: 2 layers each
    if out["serving_launches"] != 2 * (served["batches"] + 1) or \
            fel.fused_encoder_layer.mma_sync_launches:
        raise AssertionError(f"serving_bench: {out['serving_launches']} "
                             f"layer launches for {served['batches']} + 1 "
                             f"batches")
    out["serving"] = served
    torch.cuda.empty_cache()

    rc, guard = run_perf_guard()
    print(f"perf_guard ({GUARD_ROUNDS} rounds): {json.dumps(guard)}; "
          + ("PASS" if rc == 0 and not guard["failures"] else
             "FAIL: " + "; ".join(guard["failures"])), flush=True)
    if rc != 0 or guard["failures"]:
        raise AssertionError(f"perf_guard: exit {rc}, {guard['failures']}")
    out["guard"] = guard
    torch.cuda.empty_cache()
    print(f"phase 24 (tools): {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# --------------------------------------------------------------------------- #
# phase 25: the example flows on format-exact corpora, and the harness's
# run_real at ML-1M
# --------------------------------------------------------------------------- #

REPO = pathlib.Path(__file__).resolve().parent
# tools/synth_corpus.py's corpora: full ML-1M, Beauty and Steam (their bytes
# pass the datasets' +-2% size gate), --small ML-20M and Reddit, loaded under
# EXAMPLE_CAP records, above their row counts: a cap makes the gate
# existence-only and cuts nothing
EXAMPLE_CORPORA = (("ml_1m", False), ("beauty", False), ("steam", False),
                   ("ml_20m", True), ("reddit", True))
EXAMPLE_CAP = 100_000_000
# Reddit's dump is zstd-compressed: tools/synth_corpus.py writes it and
# datasets/reddit.py reads it through the zstandard package, which a
# machine with a card may lack
NEEDS_ZSTANDARD = ("reddit",)
# each training example: its dataset, module and saved model's name
EXAMPLE_TRAINING = (
    ("ml_1m", "bert4rec_ml_1m_example", "bert4rec_ml-1m_128"),
    ("beauty", "bert4rec_beauty_example", "bert4rec_beauty_128"),
    ("steam", "bert4rec_steam_example", "bert4rec_steam_128"),
    ("ml_20m", "bert4rec_ml_20m_example", "bert4rec_ml-20m_128"),
    ("reddit", "bert4rec_reddit_example", "bert4rec_reddit_128"))
ARTIFACT_FILES = ("checkpoints/best.npz", "encoder_config.json",
                  "eval_results.json", "meta_config.json", "vocab.txt",
                  "weights.npz")
# the harness's real mode at JAX's quality_runs/ml1m_synthetic settings,
# on the same generator and seed's corpus
RUN_REAL = ("--dataset", "ml_1m", "--config", "ml-1m_128", "--epochs", "8",
            "--dup", "10")
JAX_REAL = "quality_runs/ml1m_synthetic/eval_results.json"
REAL_OVER_FLOOR = 5       # HR@10 and NDCG@10 against the popularity floor's
# sasrec_example's layer (B=64, S=16, hidden 48, 4 heads of 12, inner 96,
# dropout 0.1 / 0.1): fp32 K1'' causal on the SIMT route (head dim 12)
SASREC_LAYER = dict(b=64, s=16, h=48, n=4, f=96, rates=(0.1, 0.1))
BY_HAND_TOL = 1e-5        # fp32 library loss vs float64 by hand


def launch_counts(reset: bool = False) -> dict:
    """Every launch counter of the layer, loss and flash attention kernels
    (``tools/count_launches.COUNTERS``); ``reset`` sets them to 0 first."""
    from bert4rec_tpu_torch.tools import count_launches
    fns = count_launches.counted_functions()
    names = [(n, a) for n, attrs in count_launches.COUNTERS.items()
             for a in attrs]
    if reset:
        for name, attr in names:
            setattr(fns[name], attr, 0)
    return {f"{name}.{attr}": getattr(fns[name], attr)
            for name, attr in names}


def check_metrics(metrics: dict, label: str) -> None:
    """The evaluator's keys, a positive rank count, the rates in [0, 1]."""
    rates = {k: v for k, v in metrics.items() if k != "Valid Ranks"}
    if not (metrics.get("Valid Ranks", 0) > 0 and len(rates) == 7 and all(
            0.0 <= float(v) <= 1.0 for v in rates.values())):
        raise AssertionError(f"{label}: metrics {metrics}")


def check_layer_routes(counts: dict, label: str, route="tf32",
                       causal=False) -> None:
    """Every layer launch on ``route`` (the 3xTF32 kernels, or SIMT), in
    the bidirectional or the causal counters only; no flash attention."""
    lay = "fused_encoder_layer."
    kind = "causal_" if causal else ""
    fwd, bwd = counts[f"{lay}{kind}launches"], counts[
        f"{lay}{kind}backward_launches"]
    others = [k for k, v in counts.items() if v and k.startswith(lay) and k
              not in (f"{lay}{kind}launches", f"{lay}{kind}backward_launches",
                      f"{lay}tf32_launches", f"{lay}tf32_backward_launches")]
    tf32 = (counts[f"{lay}tf32_launches"], counts[
        f"{lay}tf32_backward_launches"])
    flash = [k for k, v in counts.items()
             if v and k.startswith("flash_attention.")]
    want_tf32 = (fwd, bwd) if route == "tf32" else (0, 0)
    if not (fwd > 0 and tf32 == want_tf32 and not others and not flash):
        raise AssertionError(f"{label}: the layer launches are not all "
                             f"{kind}{route}: {counts}")


def check_loss_routes(counts: dict, want: dict, steps: int,
                      label: str) -> None:
    """The loss kernels the laws pick (``config_sweep.routes``): K3 / K4,
    or K5 with K6 or K7; one backward a step."""
    k = {name: counts[f"fused_mlm_loss{c}"] for name, c in (
        ("K3", ".launches"), ("K4", ".backward_launches"),
        ("K5", "_tiled.launches"), ("K6", "_tiled.merged_launches"),
        ("K7", "_tiled.two_sweep_launches"))}
    if want["loss_kernel"] == "whole_table":
        ok = k["K3"] > 0 and k["K4"] == steps and not (
            k["K5"] or k["K6"] or k["K7"])
    else:
        back = want["loss_backward"]
        other = "K7" if back == "K6" else "K6"
        ok = (k["K5"] > 0 and k[back] == steps and not k[other]
              and not (k["K3"] or k["K4"]))
    if not ok:
        raise AssertionError(f"{label}: loss launches {k}, the laws say "
                             f"{want} for {steps} steps")


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def example_datasets() -> list:
    """The corpora phase 25 can make and read here: all five, less Reddit
    where the zstandard package is absent (printed, not hidden)."""
    import importlib.util
    if importlib.util.find_spec("zstandard") is not None:
        return [d for d, _ in EXAMPLE_CORPORA]
    print(f"examples: no zstandard package on this machine: "
          f"{list(NEEDS_ZSTANDARD)} not run (tools/synth_corpus.py cannot "
          f"write the dump, datasets/reddit.py cannot read one)", flush=True)
    return [d for d, _ in EXAMPLE_CORPORA if d not in NEEDS_ZSTANDARD]


def make_example_corpora(home, names) -> float:
    """``tools/synth_corpus.py``, unchanged, as a tool, for each corpus of
    ``names``; phase 7's ML-20M corpus makes way for its ``--small``
    one."""
    t0 = time.perf_counter()
    shutil.rmtree(pathlib.Path(home) / "data" / "ml-20m", ignore_errors=True)
    for dataset, small in EXAMPLE_CORPORA:
        if dataset not in names:
            continue
        proc = subprocess.run(
            [sys.executable, str(REPO / "tools" / "synth_corpus.py"),
             "--home", str(home), "--dataset", dataset,
             *(["--small"] if small else [])],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"synth_corpus {dataset}: "
                                 f"{proc.stderr[-2000:]}")
    return time.perf_counter() - t0


def check_trained(torch, trainer, train_ds, batch_size, steps, counts,
                  label) -> tuple:
    """One example's ``train()`` run against the laws, at the loader's P
    (``config_sweep.routes``): every layer launch on the route the shape
    law picks (causal where the model is), one backward a layer a step,
    the loss kernels the laws pick; then one of its train batches through
    the kernel step against the plain step. Returns the routes and P."""
    from bert4rec_tpu_torch.tools import config_sweep
    cfg = trainer.model.config
    batch = trainer._put_batch(next(iter(train_ds.batches(
        batch_size, shuffle=True, seed=0, drop_remainder=True))))
    npred = batch["masked_lm_positions"].shape[1]
    want = config_sweep.routes(
        dict(cfg.to_dict(), max_predictions_per_seq=npred),
        batch=batch_size, dtype_bytes=4)
    check_layer_routes(counts, label, want["layer_kernel"],
                       causal=cfg.causal_attention)
    kind = "causal_" if cfg.causal_attention else ""
    if counts[f"fused_encoder_layer.{kind}backward_launches"] != \
            cfg.num_layers * steps:
        raise AssertionError(f"{label}: {counts} for {steps} steps")
    check_loss_routes(counts, want, steps, label)
    check_step_parity(torch, trainer, batch, label)
    return want, npred


def check_training_example(torch, device, home, dataset, module_name,
                           save_name) -> dict:
    """One ``bert4rec_<dataset>_example`` on the card: the loss finite,
    the metrics in range, the artifact on disk, every layer launch on the
    3xTF32 route and the loss kernels the laws pick; then one of its train
    batches through the trained model, the kernel step against the plain
    step."""
    module = importlib.import_module(
        f"bert4rec_tpu_torch.examples.{module_name}")
    small = dict(EXAMPLE_CORPORA)[dataset]
    if small:
        os.environ["BERT4REC_TPU_LOAD_N_RECORDS"] = str(EXAMPLE_CAP)
    else:
        os.environ.pop("BERT4REC_TPU_LOAD_N_RECORDS", None)
    launch_counts(reset=True)
    t0 = time.perf_counter()
    with TrainCalls(torch) as recorded:
        _, metrics, history = module.main(device=str(device))
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    (trainer, train_ds, train_s, steps), = recorded.calls
    cfg = trainer.model.config
    losses = history.history.get("loss", [])
    if not (losses and all(math.isfinite(v) for v in losses) and steps > 0):
        raise AssertionError(f"{module_name}: losses {losses}, {steps} "
                             f"steps")
    check_metrics(metrics, module_name)
    saved = pathlib.Path(home) / "saved_models" / save_name
    missing = [f for f in ARTIFACT_FILES if not (saved / f).is_file()]
    if missing:
        raise AssertionError(f"{module_name}: {saved} lacks {missing}")
    want, npred = check_trained(torch, trainer, train_ds, STREAM_BATCH,
                                steps, counts, module_name)
    if want["layer_kernel"] != "tf32":
        raise AssertionError(f"{module_name}: the law routes the layer to "
                             f"{want}")
    print(f"examples {module_name}: V={cfg.vocab_size} S="
          f"{cfg.max_sequence_length} P={npred} "
          f"H={cfg.hidden_size} B={STREAM_BATCH}, {len(train_ds)} train rows"
          f", {steps} steps in {train_s:.1f} s of train() "
          f"({train_s * 1e3 / steps:.3f} ms a step), loss "
          f"{losses[-1]:.4f}; test HR@10 {metrics['HR@10']:.4f} NDCG@10 "
          f"{metrics['NDCG@10']:.4f} over {metrics['Valid Ranks']} users; "
          f"routes {want}; launches {nonzero(counts)}; {seconds:.1f} s",
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    return dict(counts=counts, steps=steps, seconds=seconds)


def check_ml1m_chain(torch, device, home) -> dict:
    """Phase 25's chain over the ML-1M example's artifact: evaluation,
    the Recommender, the Ranker and the HTTP server's demo request, every
    layer launch on the 3xTF32 route; the Recommender's and the server's
    answers against the plain path on the same artifact."""
    from bert4rec_tpu_torch.apps import Recommender
    from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
    from bert4rec_tpu_torch.examples import (
        bert4rec_evaluation_example, ranker_app, recommender_app_example,
        serving_server_example,
    )
    from bert4rec_tpu_torch.models import BERT4RecModelWrapper
    os.environ.pop("BERT4REC_TPU_LOAD_N_RECORDS", None)
    path = str(pathlib.Path(home) / "saved_models" / "bert4rec_ml-1m_128")
    launch_counts(reset=True)
    t0 = time.perf_counter()
    metrics = bert4rec_evaluation_example.main(path, device=str(device))
    recommended = recommender_app_example.main(path, device=str(device))
    ranked = ranker_app.main(path, str(device))
    served = serving_server_example.main(path, 0, "demo", str(device))
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_metrics(metrics, "bert4rec_evaluation_example")
    with open(f"{path}/eval_results.json") as f:
        if sorted(json.load(f)) != sorted(metrics):
            raise AssertionError("eval_results.json lacks the metrics")
    check_layer_routes(counts, "the ML-1M chain")
    if counts["fused_encoder_layer.backward_launches"] or any(
            v for k, v in counts.items() if k.startswith("fused_mlm_loss")):
        raise AssertionError(f"the ML-1M chain trained: {counts}")
    if not (ranked["rank"] >= 1 and sorted(
            r for _, r in ranked["ranking"]) == [1, 2, 3]):
        raise AssertionError(f"ranker_app: {ranked}")
    print(f"examples chain: evaluation {metrics}; recommendation "
          f"{recommended['history']} -> {recommended['recommendation']}; "
          f"ranker {ranked}; served {served['response']}, healthz "
          f"{served['healthz']}; launches {nonzero(counts)}; "
          f"{seconds:.1f} s", flush=True)
    wrapper, extras = BERT4RecModelWrapper.load(path, device=device)
    rec = Recommender(wrapper.model, wrapper.params,
                      get_dataloader_factory().create_ml_1m_dataloader(
                          tokenizer=extras["tokenizer"]), device=device)
    check_answers(torch, rec, [recommended["history"]], [1],
                  [[recommended["recommendation"]]],
                  "examples: recommender_app_example")
    check_answers(torch, rec, [served["history"]], [5],
                  [served["response"]["items"]],
                  "examples: serving_server_example demo")
    return dict(counts=counts, seconds=seconds)


def check_self_contained_examples(torch, device) -> dict:
    """The flows that need no corpus (and dataloader_usage_example on the
    ML-1M corpus) on the card: the lifecycle (3xTF32 layer, K3 / K4) and
    SASRec (K1'' causal on the route the shape law picks) held step for
    step against the plain path; the loss walk-through's library loss
    against the same numbers by hand; the temporal features' batch and the
    two temporal models' logits."""
    import numpy as np
    from bert4rec_tpu_torch.examples import (
        bert4rec_lifecycle_example, dataloader_usage_example,
        loss_calculation_example, sasrec_example, temporal_features_example,
    )
    out, counts = {}, {}
    t0 = time.perf_counter()
    for name, module, batch_size in (
            ("lifecycle", bert4rec_lifecycle_example, 32),
            ("sasrec", sasrec_example, SASREC_LAYER["b"])):
        launch_counts(reset=True)
        with TrainCalls(torch) as recorded:
            out[name] = module.main(device=str(device))
        counts[name] = launch_counts()
        (trainer, train_ds, _, steps), = recorded.calls
        cfg = trainer.model.config
        if name == "sasrec" and (
                cfg.hidden_size, cfg.num_attention_heads, cfg.inner_dim,
                cfg.max_sequence_length) != tuple(
                SASREC_LAYER[k] for k in "hnfs"):
            raise AssertionError(f"SASREC_LAYER is not the example's: {cfg}")
        want, _ = check_trained(torch, trainer, train_ds, batch_size, steps,
                                counts[name], f"{name} example")
        print(f"examples {name}: routes {want}, {steps} steps; "
              f"launches {nonzero(counts[name])}", flush=True)
    life, sas = out["lifecycle"], out["sasrec"]
    check_metrics(life["metrics"], "lifecycle example")
    check_metrics(sas["results"], "sasrec example")
    if not (all(math.isfinite(v) for v in life["loss"])
            and len(life["files"]) == 4 and life["recommendation"]):
        raise AssertionError(f"lifecycle example: {life}")
    if not (0.0 <= sas["masked_accuracy"] <= 1.0 and len(sas["after"]) == 3):
        raise AssertionError(f"sasrec example: {sas}")

    launch_counts(reset=True)
    walk = loss_calculation_example.main(device=str(device))
    temporal = temporal_features_example.main(device=str(device))
    counts["plain"] = launch_counts()
    if not (abs(walk["manual_loss"] - walk["loss"]) <= BY_HAND_TOL
            and math.isfinite(walk["loss"])):
        raise AssertionError(f"loss_calculation_example: library "
                             f"{walk['loss']}, by hand {walk['manual_loss']}")
    for flag in ("use_temporal_embeddings", "use_temporal_attention"):
        logits = temporal[flag]
        if logits.shape[:2] != (8, 4) or not np.isfinite(logits).all():
            raise AssertionError(f"temporal_features_example {flag}: "
                                 f"{logits.shape}")
    if nonzero(counts["plain"]):
        # JAX's configs of these two: no fused layer, no kernel
        raise AssertionError(f"the plain flows launched kernels: "
                             f"{counts['plain']}")
    os.environ.pop("BERT4REC_TPU_LOAD_N_RECORDS", None)
    usage = dataloader_usage_example.main(device=str(device))
    if not (usage["vocab_size"] == VOCAB and usage["batch"][
            "input_word_ids"].shape == (STREAM_BATCH, SEQ)):
        raise AssertionError(f"dataloader_usage_example: vocab "
                             f"{usage['vocab_size']}, sizes {usage['sizes']}")
    print(f"examples self-contained: loss walk-through {walk['loss']:.6f} "
          f"(by hand {walk['manual_loss']:.6f}), lifecycle eval "
          f"{life['metrics']}, sasrec {sas['results']} (masked accuracy "
          f"{sas['masked_accuracy']:.3f}), dataloader_usage vocab "
          f"{usage['vocab_size']} sizes {usage['sizes']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def check_run_real(torch, device) -> dict:
    """The harness's real mode (``tools/quality_run``'s default mode) at
    ML-1M, 8 epochs, dup 10, on the synthetic corpus: HR@10 and NDCG@10
    at least ``REAL_OVER_FLOOR`` times the popularity floor's, every layer
    launch on the 3xTF32 route and K3 / K4 once a step; printed beside
    JAX's run of ``JAX_REAL``."""
    import numpy as np
    from bert4rec_tpu_torch.evaluation import quality_harness
    from bert4rec_tpu_torch.tools import config_sweep
    os.environ.pop("BERT4REC_TPU_LOAD_N_RECORDS", None)
    launch_counts(reset=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp, \
            TrainCalls(torch) as recorded:
        rc = quality_harness.main([*RUN_REAL, "--device", str(device),
                                   "--out", tmp])
        with open(f"{tmp}/eval_results.json") as f:
            payload = json.load(f)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    (trainer, _, train_s, steps), = recorded.calls
    want = config_sweep.routes(trainer.model.config.to_dict(),
                               batch=STREAM_BATCH, dtype_bytes=4)   # P=40
    with open(REPO / JAX_REAL) as f:
        jax_run = json.load(f)
    res, floor = payload["results"], payload["results_popularity_floor"]
    jres, jfloor = jax_run["results"], jax_run["results_popularity_floor"]
    over = {k: res[k] / floor[k] for k in ("HR@10", "NDCG@10")}
    print(f"run_real ({' '.join(RUN_REAL)}; V={payload['vocab_size']}, "
          f"{payload['epochs_ran']} epochs ran): "
          f"HR@10 {res['HR@10']:.4f} NDCG@10 {res['NDCG@10']:.4f} (JAX "
          f"{jres['HR@10']:.4f} / {jres['NDCG@10']:.4f}; distance "
          f"{res['HR@10'] - jres['HR@10']:+.4f} / "
          f"{res['NDCG@10'] - jres['NDCG@10']:+.4f}); popularity floor "
          f"{floor['HR@10']:.4f} / {floor['NDCG@10']:.4f} (JAX "
          f"{jfloor['HR@10']:.4f} / {jfloor['NDCG@10']:.4f}); over the floor"
          f" {over['HR@10']:.2f}x / {over['NDCG@10']:.2f}x (needed "
          f"{REAL_OVER_FLOOR}x); wall {payload['wall_seconds']:.1f} s (JAX "
          f"{jax_run['wall_seconds']:.1f} s on its TPU), train() "
          f"{train_s * 1e3 / steps:.3f} ms a step over {steps} steps; "
          f"launches {nonzero(counts)}; {seconds:.1f} s", flush=True)
    print(f"run_real results {res}; floor {floor}", flush=True)
    check_layer_routes(counts, "run_real")
    check_loss_routes(counts, want, steps, "run_real")
    if not (rc == 0 and all(np.isfinite(list(res.values())))
            and min(over.values()) >= REAL_OVER_FLOOR):
        raise AssertionError(f"run_real: rc {rc}, {res} against the floor "
                             f"{floor}")
    del trainer
    torch.cuda.empty_cache()
    return dict(counts=counts, steps=steps, payload=payload)


def credit_examples(record, examples, entry) -> None:
    """Phase 25's launches in the kernels line, by kernel: the layer's
    inference forwards (validation, evaluation, the apps; mostly at B=256)
    to K1's B=256 row, one training forward per backward to K1', the loss
    kernels to their fp32 rows; SASRec's causal layer (SIMT, off the
    3xTF32 shape rule) as rows of its own, timed at its shape."""
    ex_counts = [c["counts"] for c in examples["training"].values()] + [
        examples["chain"]["counts"], examples["run_real"]["counts"],
        *examples["self_contained"].values()]

    def ex(key):
        return sum(c[key] for c in ex_counts)

    trained = ex("fused_encoder_layer.tf32_backward_launches")
    if ex("fused_mlm_loss_tiled.two_sweep_launches"):
        raise AssertionError("phase 25 ran fp32 K7, which has no row here")
    credit = {
        "fused_encoder_layer_b256":
            ex("fused_encoder_layer.tf32_launches") - trained,
        "fused_encoder_layer_dropout_fp32": trained,
        "fused_encoder_layer_backward_fp32": trained,
        "fused_mlm_loss_fp32": ex("fused_mlm_loss.launches"),
        "fused_mlm_loss_backward_fp32": ex("fused_mlm_loss.backward_launches"),
        "fused_mlm_loss_tiled_fp32": ex("fused_mlm_loss_tiled.launches"),
        "fused_mlm_loss_tiled_backward_merged_fp32":
            ex("fused_mlm_loss_tiled.merged_launches")}
    for k in record["kernels"]:
        k["launches"] += credit.get(k["name"], 0)
    c_sas = examples["self_contained"]["sasrec"]
    layer_src = "fused_encoder_layer.cu"
    record["kernels"] += [
        entry("fused_encoder_layer_causal_fp32_simt", layer_src,
              "bert4rec_tpu/ops/fused_encoder_layer.py:241",
              c_sas["fused_encoder_layer.causal_launches"],
              examples["sasrec_layer"]["fwd"]),
        entry("fused_encoder_layer_causal_backward_fp32_simt", layer_src,
              "bert4rec_tpu/ops/fused_encoder_layer.py:265",
              c_sas["fused_encoder_layer.causal_backward_launches"],
              examples["sasrec_layer"]["bwd"])]
    print(f"phase 25 launches in the kernels line: {credit}; SASRec's "
          f"causal layer {c_sas['fused_encoder_layer.causal_launches']} + "
          f"{c_sas['fused_encoder_layer.causal_backward_launches']}",
          flush=True)


def check_examples(torch, rng, device, home) -> dict:
    """Phase 25: the corpora, the five training examples, the ML-1M chain,
    the self-contained flows, SASRec's layer kernels timed at its shape,
    and ``run_real`` at ML-1M; its seconds."""
    t_phase = time.perf_counter()
    names = example_datasets()
    out = {"corpora_s": make_example_corpora(home, names)}
    print(f"examples: corpora {names} in {out['corpora_s']:.1f} s",
          flush=True)
    os.environ["BERT4REC_TPU_EXAMPLE_EPOCHS"] = "1"
    try:
        out["training"] = {
            dataset: check_training_example(torch, device, home, dataset,
                                            module, saved)
            for dataset, module, saved in EXAMPLE_TRAINING
            if dataset in names}
    finally:
        os.environ.pop("BERT4REC_TPU_EXAMPLE_EPOCHS", None)
    out["chain"] = check_ml1m_chain(torch, device, home)
    out["self_contained"] = check_self_contained_examples(torch, device)
    shape = SASREC_LAYER
    out["sasrec_layer"] = check_layer_training(
        torch, rng, device, h=shape["h"], n=shape["n"], f=shape["f"],
        rates=shape["rates"], cases=[(torch.float32, shape["b"])],
        seq=shape["s"], trace=False, causal=True)[("float32", shape["b"])]
    out["run_real"] = check_run_real(torch, device)
    print(f"phase 25 (examples): {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# Moonlight-16B-A3B's block as the benchmark's moonlight_5L.train runs it
MOON_CONFIG = REPO / "benchmark/configs/moonlight-16b-a3b_5L.json"
MOON_TRAFFIC = REPO / "benchmark/traffic/ml20m_users_next.json"
MOON_EXPERT = (76_800, 2048, 1408, 64)   # rows (64 x 200 tokens x 6), H, I, E
MOON_EMPTY = (5, 40)                     # experts with no rows
MOON_FLASH = (64, 16, 200, 192, 128)     # B, N, S, DK, DV (causal)
MOON_STEPS = 150                         # the counted train()'s steps
MOON_MARKS = (1, 25, 50, 100, 150)       # steps whose router load prints


def expert_counts(np, rows, experts, seed=0):
    """Rows per expert from a skewed law (share 1 / (1 + rank)^0.6, ranks
    shuffled), ``MOON_EMPTY`` empty."""
    rng = np.random.default_rng(seed)
    share = rng.permutation(1.0 / (1.0 + np.arange(experts)) ** 0.6)
    share[list(MOON_EMPTY)] = 0.0
    counts = np.floor(share / share.sum() * rows).astype(np.int64)
    counts[np.argmax(counts)] += rows - counts.sum()
    return counts


def grouped_mm_library(torch, x, counts, wg, wu, wd, dy):
    """K11's forward and backward by ``torch._grouped_mm`` with PyTorch's
    elementwise SwiGLU and its derivative, the yardstick; None where this
    torch lacks it or refuses the shapes (printed)."""
    gmm = getattr(torch, "_grouped_mm", None)
    if gmm is None:
        print("K11 yardstick: this torch has no _grouped_mm", flush=True)
        return None
    F = torch.nn.functional
    offs = torch.cumsum(counts, 0).to(torch.int32)
    wgt, wut, wdt = (w.transpose(-1, -2).contiguous().transpose(-1, -2)
                     for w in (wg, wu, wd))

    def fwd():
        g, u = gmm(x, wgt, offs=offs), gmm(x, wut, offs=offs)
        act = F.silu(g) * u
        return gmm(act, wdt, offs=offs), g, u, act

    _, g, u, act = fwd()

    def bwd():
        da = gmm(dy, wd.transpose(-1, -2), offs=offs)
        sig = torch.sigmoid(g)
        dg = da * u * (sig * (1 + g * (1 - sig)))
        du = da * (g * sig)
        dx = gmm(dg, wg.transpose(-1, -2), offs=offs) \
            + gmm(du, wu.transpose(-1, -2), offs=offs)
        return (dx, gmm(x.T, dg, offs=offs), gmm(x.T, du, offs=offs),
                gmm(act.T, dy, offs=offs))

    try:
        bwd()
    except (RuntimeError, TypeError, ValueError) as err:
        print(f"K11 yardstick: _grouped_mm refused: {str(err)[:300]}",
              flush=True)
        return None
    return fwd, bwd


def moon_model() -> dict:
    """The moonlight-16b-a3b_5L configuration's model keys."""
    return json.loads(MOON_CONFIG.read_text())["model"]


def check_expert_gemm(torch, device) -> dict:
    """K11 forward and backward at ``MOON_EXPERT`` (Moonlight's layer at
    the cell's batch, skewed rows, two empty experts): kernel, plain and
    ``_grouped_mm`` times and the bound; each launch's kernels by device
    time."""
    import numpy as np
    from bert4rec_tpu_torch.ops import expert_gemm as eg
    rows, h, i, e = MOON_EXPERT
    rng = np.random.default_rng(SEED)

    def t(*shape, scale=1.0):
        return (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                * scale).to(device, torch.bfloat16)
    counts = torch.from_numpy(expert_counts(np, rows, e)).to(device)
    x, dy = t(rows, h), t(rows, h)
    wg, wu, wd = t(e, h, i, scale=0.02), t(e, h, i, scale=0.02), \
        t(e, i, h, scale=0.02)
    c32 = counts.to(torch.int32)
    fwd = lambda: eg._launch_forward(x, c32, wg, wu, wd)  # noqa: E731
    _, g, u, act, sched = fwd()
    bwd = lambda: eg._launch_backward(  # noqa: E731
        dy, x, c32, wg, wu, wd, g, u, act, sched)
    plain = {"fwd": lambda: eg.expert_mlp_plain_forward(x, c32, wg, wu, wd),
             "bwd": lambda: eg.expert_mlp_plain_backward(
                 dy, x, c32, wg, wu, wd, g, u, act)}
    label = f"K11 at {MOON_EXPERT}"
    errs = dict(fwd=held(label, fwd()[:4], plain["fwd"](), EXPERT_TOL),
                bwd=held(label, bwd(), plain["bwd"](), EXPERT_TOL))
    lib = grouped_mm_library(torch, x, counts, wg, wu, wd, dy)
    row = {part: dict(
        max_abs_err=errs[part],
        **timed(fn), **timed(plain[part], "plain", **PLAIN),
        **(timed(lib[k], "library") if lib else {"library_ms": None}),
        **bound(roofline_mla_moe.expert_s, rows, moon_model(), k == 1))
        for k, (part, fn) in enumerate((("fwd", fwd), ("bwd", bwd)))}
    print(f"K11 (R, H, I, E)={MOON_EXPERT}, rows per expert "
          f"{int(counts.max())} most, experts {list(MOON_EMPTY)} empty "
          f"(tol {EXPERT_TOL} of the scale; library: _grouped_mm): "
          + "; ".join(f"{part}: {timing_text(r)}, "
                      f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound"
                      for part, r in row.items()), flush=True)
    print("  per K11 forward: " + device_breakdown(torch, fwd)[1], flush=True)
    print("  per K11 backward: " + device_breakdown(torch, bwd)[1],
          flush=True)
    del x, dy, wg, wu, wd, g, u, act, lib
    torch.cuda.empty_cache()
    return row


def check_mla_flash(torch, rng, device) -> dict:
    """K8 / K9 at ``MOON_FLASH`` (latent attention's 192-wide queries and
    keys against 128-wide values), causal, dropout 0, on the block's
    strided views with front-padded rows: kernel, plain and SDPA times and
    the bound."""
    import numpy as np
    import torch.nn.functional as F
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    b, n, s, dk, dv = MOON_FLASH

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(device, torch.bfloat16)
    q, k = t(b, s, n, dk).transpose(1, 2), t(b, s, n, dk).transpose(1, 2)
    v = t(b, s, n, 2 * dv)[..., dv:].transpose(1, 2)
    do = t(b, n, s, dv)
    lengths = rng.integers(1, s + 1, size=b)
    lengths[:2] = [s, 1]
    # front-padded, as the next-item batches are
    mask = torch.from_numpy((np.arange(s)[None, :] >= s - lengths[:, None])
                            .astype(np.int32)).to(device)
    fwd = lambda: fa._launch_forward(q, k, v, mask, 0, 0.0, True, True)  # noqa: E731,E501
    saved = fwd()[1]
    bwd = lambda: fa._launch_backward(q, k, v, mask, do, saved, 0, 0.0, True)  # noqa: E731,E501
    plain = {"fwd": lambda: fa.mha_reference(q, k, v, mask, 0.0, 0, True),
             "bwd": lambda: fa.flash_attention_plain_backward(
                 q, k, v, mask, do, dropout_rate=0.0, seed=0, causal=True)}
    bias = (torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
            + fa.causal_bias(s, device)).to(torch.bfloat16)
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias)

    lib_out = lib_fwd()
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, (ql, kl, vl), do, retain_graph=True)
    lib = {"fwd": lib_fwd, "bwd": lib_bwd}
    backend = sdpa_backend(torch, lib_bwd)
    label = f"flash attention at {MOON_FLASH}"
    errs = dict(fwd=held(label, [fwd()[0]], [plain["fwd"]()],
                         FLASH_TOL["bfloat16"], False),
                bwd=held(label, bwd(), plain["bwd"](), GRAD_TOL["bfloat16"]))
    row = {part: dict(max_abs_err=errs[part],
                      **timed(fn), **timed(plain[part], "plain", **PLAIN),
                      **timed(lib[part], "library"),
                      **bound(roofline_mla_moe.flash_s, moon_model(), b,
                              part == "bwd"))
           for part, fn in (("fwd", fwd), ("bwd", bwd))}
    print(f"flash attention bfloat16 (B, N, S, DK, DV)={MOON_FLASH} causal: "
          + "; ".join(f"{part}: {timing_text(r)}" for part, r in row.items())
          + f" (SDPA backend {backend})", flush=True)
    del q, k, v, do, saved, lib_out, lib_bwd, ql, kl, vl, bias
    torch.cuda.empty_cache()
    return row


def check_moonlight_training(torch, device) -> dict:
    """``BERT4RecTrainer.train()`` of a ``SASRecModel`` built from the
    benchmark's moonlight-16b-a3b_5L config (5 layers at the published
    widths, B=64, S=200, next-item, the cell's AdamW) over a corpus of the
    cell's traffic, ``MOON_STEPS`` steps: the run's launch counts (K11 once
    a MoE layer a step each way, K8 / K9 causal at 192 / 128 once a layer,
    K10 once a step, no row dropped), the loss finite, and per MoE layer
    the router's load as training goes (at ``MOON_MARKS``): the most rows
    on one expert, the sorted loads' top, the experts left with no row,
    and the share of the router's input in its mean direction (||mean
    x||^2 / mean ||x||^2: near 1, every token scores the experts alike);
    K12 three launches a step, then phase 28's ``check_adamw_leaves`` on
    the trained leaves."""
    from benchmark import traffic_gen
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset)
    from bert4rec_tpu_torch.models import BERT4RecConfig, SASRecModel
    from bert4rec_tpu_torch.models.components import mla_moe
    from bert4rec_tpu_torch.ops import adamw
    from bert4rec_tpu_torch.ops import expert_gemm as eg
    from bert4rec_tpu_torch.ops import table_gradient as tg
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    conf = json.loads(MOON_CONFIG.read_text())
    traffic = json.loads(MOON_TRAFFIC.read_text())
    cfg = dict(conf["model"], router_bias_seed=SEED)
    opt = conf["optimizer"]
    batch = int(conf["training"]["batch_size"])
    seqs = traffic_gen.corpus(traffic, SEED, device)
    masking = MaskingConfig(
        max_seq_len=cfg["max_sequence_length"],
        max_predictions_per_seq=cfg["max_predictions_per_seq"],
        mask_token_id=1, pad_token_id=0, unk_token_id=2)
    ds = ProcessedDataset(seqs[:batch * (MOON_STEPS + 8)], masking,
                          lambda: cfg["vocab_size"], task=traffic["task"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    trainer = BERT4RecTrainer(SASRecModel(
        config=BERT4RecConfig.from_dict(cfg),
        dtype_policy=DTypePolicy.bf16()))
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=opt["lr"], num_train_steps=opt["train_steps"],
            num_warmup_steps=opt["warmup"],
            weight_decay_rate=opt["weight_decay"], beta_1=opt["b1"],
            beta_2=opt["b2"], epsilon=opt["eps"],
            exclude_from_weight_decay=opt["exclude"],
            global_clipnorm=opt["clip"]),
        seed=SEED, device=device)
    moe_layers = cfg["num_layers"] - cfg["first_k_dense_replace"]
    n_exp = cfg["n_routed_experts"]
    loads, means, pads = [], [], []
    route, step = mla_moe.route, trainer.train_step

    def recorded_route(p, x, bias, c):
        out = route(p, x, bias, c)
        loads.append(torch.bincount(out[0].reshape(-1), minlength=n_exp))
        if len(pads) in MOON_MARKS:
            mean = x.mean(0, dtype=torch.float32)
            energy = torch.linalg.vector_norm(x, dim=-1,
                                              dtype=torch.float32)
            means.append(mean.square().sum() / energy.square().mean())
        return out

    def recorded_step(b):
        pads.append((b["input_mask"] == 0).float().mean())
        return step(b)

    counters = (lambda: (eg.expert_mlp.launches,
                         eg.expert_mlp.backward_launches,
                         fa.flash_attention.causal_launches,
                         fa.flash_attention.causal_backward_launches,
                         tg.table_gradient.launches,
                         adamw.adamw_update.launches))
    mla_moe.route, trainer.train_step = recorded_route, recorded_step
    mla_moe.routing_counts.reset()
    before = counters()
    try:
        hist = trainer.train(ds, epochs=1, batch_size=batch,
                             steps_per_epoch=MOON_STEPS, seed=SEED,
                             verbose=False)
        torch.cuda.synchronize()
    finally:
        # the instance's patch goes (a bound method kept on its own
        # instance is a cycle that holds the trainer's 30 GB)
        mla_moe.route = route
        del trainer.train_step
    got = dict(zip(("K11", "K11_backward", "flash", "flash_backward", "K10",
                    "K12"), (a - b for a, b in zip(counters(), before))))
    want = dict(K11=moe_layers * MOON_STEPS,
                K11_backward=moe_layers * MOON_STEPS,
                flash=cfg["num_layers"] * MOON_STEPS,
                flash_backward=cfg["num_layers"] * MOON_STEPS,
                K10=MOON_STEPS, K12=3 * MOON_STEPS)
    routing = mla_moe.routing_counts.read()
    tokens = batch * cfg["max_sequence_length"]
    if got != want or routing["dropped_rows"] or routing["routed_rows"] != (
            tokens * cfg["num_experts_per_tok"] * moe_layers * MOON_STEPS):
        raise AssertionError(f"moonlight train(): launches {got}, want "
                             f"{want}; routing {routing}")
    losses = [float(v) for v in hist.history.get("loss", [])]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"moonlight train(): loss {losses}")
    peak = torch.cuda.max_memory_allocated(device)
    table = torch.stack(loads).view(MOON_STEPS, moe_layers, n_exp).cpu()
    mean_share = torch.stack(means).view(len(MOON_MARKS), moe_layers).cpu()
    pad = float(torch.stack(pads).mean())
    print(f"moonlight train() (moonlight-16b-a3b_5L, B={batch}, the cell's "
          f"AdamW, {MOON_STEPS} steps, peak {peak} B with {held} B held "
          f"before): launches {got} (want {want}), routing "
          f"{routing}, epoch loss {losses}, [PAD] share {pad:.3f}",
          flush=True)
    for layer in range(moe_layers):
        top = table[:, layer].sort(dim=-1, descending=True).values
        print(f"  MoE layer {cfg['first_k_dense_replace'] + layer}: most "
              f"rows on one expert (of {tokens} tokens) at steps "
              + ", ".join(f"{k}: {int(top[k - 1, 0])}" for k in MOON_MARKS)
              + f"; step {MOON_STEPS}'s sorted top 8 "
              f"{top[-1, :8].tolist()}, experts with no row "
              f"{int((top[-1] == 0).sum())}; mean-direction share of the "
              f"router's input at those steps "
              + ", ".join(f"{v:.3f}" for v in mean_share[:, layer].tolist()),
              flush=True)
    del hist
    torch.cuda.empty_cache()
    # phase 28: K12 on the trained leaves (the last use of this trainer)
    update = check_adamw_leaves(torch, device, "moonlight_5L", trainer)
    del trainer
    torch.cuda.empty_cache()
    return {"counts": got, "routing": routing, "peak_bytes": peak,
            "adamw": update}


# phase 28: K12, the trainer's clip and AdamW update (csrc/adamw.cu), on
# the leaves of phases 14 and 27's trainers
ADAMW_COUNT = 150         # the optimizer count of the timed updates
ADAMW_KERNELS = ("adamw_sumsq_kernel", "adamw_leaf_sums_kernel",
                 "adamw_update_kernel")


def host_ms(torch, fn, calls=10) -> float:
    """Median host ms a call takes to return (its launches), the device
    drained between calls."""
    import statistics
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def check_adamw_leaves(torch, device, name, trainer) -> dict:
    """K12 on a trained cell's own params and moments with random fp32
    gradients (as the trainer hands them) at ``ADAMW_COUNT``: device ms of
    K12, the plain chain and
    ``torch._fused_adamw_`` (library: AdamW without the clip, timed only)
    against the 32-byte bound, each call's host ms, and the device
    operations of a call."""
    from bert4rec_tpu_torch.ops import adamw
    from bert4rec_tpu_torch.utils.checkpoint import flatten
    opt, state = trainer.optimizer, trainer.state
    flat = flatten(state["params"])
    paths = list(flat)
    p = [flat[k].detach() for k in paths]
    m = [flatten(state["opt_state"]["mu"])[k] for k in paths]
    v = [flatten(state["opt_state"]["nu"])[k] for k in paths]
    gen = torch.Generator(device=device).manual_seed(SEED)
    g = [torch.randn(t.shape, device=device, generator=gen) * 1e-3
         for t in p]
    decay = [bool(opt.decay_mask(k)) for k in paths]
    hyper = opt.hyper(ADAMW_COUNT)
    elements = sum(t.numel() for t in p)
    # one update against the plain chain on the eight smallest leaves and
    # the largest (copies of all would not fit beside moonlight_5L's),
    # the chain clipping by K12's norm; the card tests' limits: params
    # within 1e-7 + lr 1e-5, the 1e-7 one unit in the last place past 1,
    # moments within 1e-6 of their leaf's largest
    order = sorted(range(len(p)), key=lambda i: p[i].numel())
    some = order[:8] + order[-1:]
    want = [[x[i].clone() for i in some] for x in (p, m, v)]
    norm = []
    adamw.adamw_update(p, g, m, v, decay, hyper, sq_norm=lambda sums: (
        norm.append(torch.stack(sums).sum()) or norm[0]))
    adamw.adamw_update_plain(want[0], [g[i] for i in some], *want[1:],
                             [decay[i] for i in some], hyper,
                             sq_norm=lambda _: norm[0])
    for i, c in zip(some, want[0]):
        ulp = torch.nextafter(c.abs(), torch.full_like(c, math.inf)) - c.abs()
        if not bool(((p[i] - c).abs() <= ulp.clamp_min(1e-7)
                     + hyper.lr * 1e-5).all()):
            raise AssertionError(f"K12 {name}: leaf {paths[i]} off the "
                                 f"plain chain's params")
    held(f"K12 {name} moments", [x[i] for x in (m, v) for i in some],
         want[1] + want[2], 1e-6)
    p_err = max(float((p[i] - c).abs().max()) for i, c in zip(some, want[0]))
    del want

    def kernel():
        adamw.adamw_update(p, g, m, v, decay, hyper)

    def plain():
        adamw.adamw_update_plain(p, g, m, v, decay, hyper)

    steps = [torch.tensor(float(ADAMW_COUNT), device=device) for _ in p]

    def library():
        torch._fused_adamw_(p, g, m, v, [], steps, lr=hyper.lr,
                            beta1=opt.b1, beta2=opt.b2,
                            weight_decay=opt.weight_decay, eps=opt.eps,
                            amsgrad=False, maximize=False)

    row = {"leaves": len(p), "elements": elements, "max_abs_err": p_err,
           **timed(kernel), **timed(plain, "plain", **PLAIN),
           **timed(library, "library"), "bound_by": "bytes",
           "bound_ms": roofline._bound(0, 32 * elements, 1.0) * 1e3,
           "host_ms": host_ms(torch, kernel),
           "plain_host_ms": host_ms(torch, plain, calls=5),
           "ops": device_ops(torch, kernel, need=ADAMW_KERNELS),
           "plain_ops": device_ops(torch, plain)}
    dropped = [k for k in ADAMW_KERNELS
               if not any(k in op for op in row["ops"])]
    print(f"K12 {name} ({len(p)} leaves, {elements} elements, fp32 g): "
          f"{timing_text(row)}, {100 * row['bound_ms'] / row['ms']:.1f}% of "
          f"the bound (library: torch._fused_adamw_, no clip); host ms a "
          f"call {row['host_ms']:.3f} (plain {row['plain_host_ms']:.3f}); "
          f"device operations a call {op_count(row['ops'])} {row['ops']} "
          f"(plain: {op_count(row['plain_ops'])}; not in the profiler's "
          f"trace: {dropped or 'none'})", flush=True)
    del g, steps
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # the ML-20M corpus home, set before the port's datasets resolve
    # their data directory (at import)
    home = tempfile.mkdtemp(prefix="chip_smoke_home_")
    os.environ["BERT4REC_TPU_HOME"] = home
    try:
        return run(torch, home)
    finally:
        os.environ.pop("BERT4REC_TPU_LOAD_N_RECORDS", None)
        shutil.rmtree(home, ignore_errors=True)


def run(torch, home) -> int:
    import numpy as np
    from bert4rec_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    sources = kernel_build.kernel_sources()
    kernel_build.build(sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in kernel_build.build_logs.items():
        lines = log.splitlines()
        regs = [int(w) for ln in lines if "Used" in ln
                for w, nxt in zip(ln.split(), ln.split()[1:])
                if nxt == "registers,"]
        # the entry function a spill line belongs to is named two lines up
        spills = [f"{lines[i - 2].split()[-3][:90]}: {ln.strip()}"
                  for i, ln in enumerate(lines)
                  if "spill stores" in ln and " 0 bytes spill stores" not in ln]
        print(f"build {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spills "
              f"{spills or 'none'}", flush=True)
        # the wgmma loss kernels one by one: registers and spills at each
        # padded width (bf16 loss_fwd_sweep_kernel<WP>, loss_sweep_kernel<WP,
        # dt sweep>, loss_merged_kernel<WP>; fp32 the loss_tf32_ ones), and
        # ptxas's note where it had to serialise a kernel's wgmma
        for i, ln in enumerate(lines):
            lay = re.search(r"12layer_hopper(\d+)(\w+)", ln)
            if lay and "Compiling entry" in ln:
                kname = lay.group(2)[:int(lay.group(1))]
                targs = re.findall(r"Li(\d+)E", lay.group(2)[int(lay.group(1)):])
                used = next((x for x in lines[i + 1:i + 4] if "Used" in x), "")
                spill = next((x for x in lines[i + 1:i + 4] if "spill" in x), "")
                print(f"  layer_hopper::{kname}<{', '.join(targs)}>: "
                      f"{used.split(':')[-1].strip()}; {spill.strip()}",
                      flush=True)
            hit = re.search(r"(loss_(?:tf32_)?(?:fwd_sweep|sweep|merged)_kernel)"
                            r"ILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?", ln)
            if hit and "Compiling entry" in ln:
                used = next((x for x in lines[i + 1:i + 4] if "Used" in x), "")
                spill = next((x for x in lines[i + 1:i + 4] if "spill" in x), "")
                args = ", ".join(
                    [hit.group(2)] + ([hit.group(3)] if hit.group(3) else [])
                    + ([("dt" if hit.group(4) == "1" else "dh")]
                       if hit.group(4) else []))
                print(f"  {hit.group(1)}<{args}>: {used.split(':')[-1].strip()}; "
                      f"{spill.strip()}", flush=True)
        for ln in lines:
            if "Potential Performance Loss" in ln:
                print(f"  ptxas: {ln.split(':', 1)[-1].strip()[:220]}",
                      flush=True)

    rng = np.random.default_rng(SEED)
    layer_rows = check_fused_layer(torch, rng, device)
    launches, stream_launches = check_serving(torch, rng, device)
    table_rows = check_table_gradient(torch, rng, device)
    train_rows = check_layer_training(torch, rng, device)
    # phase 5's K3 / K4 at one train batch's rows, ml-1m_128's table
    loss_rows = {str(dt).removeprefix("torch."): check_loss_case(
        torch, rng, device, N_ROWS, VOCAB, HIDDEN, dt, {"K4": None})
        for dt in (torch.float32, torch.bfloat16)}
    counts = check_training(torch, device)["counts"]
    # ml-20m_256's layer width: H=256, 8 heads, F=1024, dropout 0.1
    wide_rows = check_layer_training(
        torch, rng, device, h=256, n=8, f=1024, rates=(0.1, 0.1),
        cases=[(torch.bfloat16, STREAM_BATCH)])
    loader, splits, _ = check_pipeline(home)
    tiled_rows = check_tiled_loss_kernels(torch, rng, device)
    # bf16 ml-20m_128 untimed: benchmark/ times the ml20m_128.train cell
    ml20m = {name: check_ml20m_training(
        torch, device, loader, splits, name,
        timed_steps=ML20M_TIMED_STEPS if name == "ml-20m_256" else 0)
        for name in ("ml-20m_128", "ml-20m_256")}
    causal_rows = check_masked_layer(torch, rng, device)
    sasrec_loader, sasrec_splits = check_sasrec_pipeline()
    sasrec = check_ml20m_training(torch, device, sasrec_loader,
                                  sasrec_splits, "ml-20m_128",
                                  family="sasrec")
    check_evaluation(torch, device, sasrec_loader, sasrec_splits,
                     sasrec["trainer"], "sasrec ml-20m_128")
    check_evaluation(torch, device, loader, splits,
                     ml20m["ml-20m_128"]["trainer"], "ml-20m_128")
    torch.cuda.empty_cache()
    flash_rows = check_flash_kernels(torch, rng, device)
    base = check_bert_base_training(torch, device)
    rel_rows = check_masked_layer(torch, rng, device, rel=True)
    t_loader, t_splits = check_temporal_pipeline()
    temporal = check_ml20m_training(torch, device, t_loader, t_splits,
                                    "ml-20m_128", family="temporal",
                                    timed_steps=TEMPORAL_TIMED_STEPS)
    check_temporal_extras(torch, device, temporal["trainer"],
                          temporal["host"][13])
    check_evaluation(torch, device, t_loader, t_splits, temporal["trainer"],
                     "temporal ml-20m_128", protocols=("device negatives",))
    del temporal["trainer"]
    torch.cuda.empty_cache()
    check_temporal_gate(torch, device)
    # phase 18: the fp32 ML-20M path (the quality harness's ml20m preset)
    fp32_ml20m = check_ml20m_training(torch, device, loader, splits,
                                      "ml-20m_128", fp32=True)
    del fp32_ml20m["trainer"]
    torch.cuda.empty_cache()
    # phase 19: the fp32 ml-1m path (the quality harness's ml1m preset)
    fp32_ml1m = check_training(
        torch, device, label="fp32 ml-1m_128 (harness ml1m)",
        new=lambda **kw: harness_ml1m_trainer(torch, device, **kw))
    torch.cuda.empty_cache()
    # phase 20: fp32 bert_base_512 (fp32 K8/K9 on 3xTF32)
    base_fp32 = check_bert_base_fp32(torch, device)
    torch.cuda.empty_cache()
    # phase 21: the quality harness's ml1m oracle gate (fp32 K1'/K2, K3/K4),
    # with the int8 table's block
    oracle = check_oracle_gate(torch, device)["counts"]
    torch.cuda.empty_cache()
    # phase 22: the deployment surface (fp32 K1 through exported programs)
    deployed = check_deployment(torch, device)
    torch.cuda.empty_cache()
    # phase 23: the (data, model) mesh at reddit_128 width (fp32 K5's
    # stats entry and K6 with valid_ge_zero on each vocab shard)
    meshed = check_mesh(torch, device)
    torch.cuda.empty_cache()
    # phase 24: the tools (bench, config_sweep over the 13 configs,
    # serving_bench, perf_guard) and the kernel shapes of those configs
    tools = check_tools(torch, rng, device)
    sweep = tools["sweep"]
    # phase 25: the example flows on format-exact corpora and run_real at
    # ML-1M (fp32: K1 and K1'/K2 on 3xTF32, K3/K4 or K5 + K6; SASRec's K1''
    # causal on the route its shape law picks)
    examples = check_examples(torch, rng, device, home)
    torch.cuda.empty_cache()
    # phase 27: Moonlight-16B-A3B's block (moonlight_5L.train): K11 and
    # K8 / K9 at 192 / 128 at the cell's shapes, then a counted train()
    expert_row = check_expert_gemm(torch, device)
    mla_row = check_mla_flash(torch, rng, device)
    moon = check_moonlight_training(torch, device)

    def entry(name, source, replaces, n, row):
        return {"name": name, "route": "cuda",
                "source": f"bert4rec_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n,
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}

    train_row = train_rows[("bfloat16", STREAM_BATCH)]   # the train shape
    fp32_row = train_rows[("float32", STREAM_BATCH)]
    wide_row = wide_rows[("bfloat16", STREAM_BATCH)]
    c128, c256 = ml20m["ml-20m_128"]["counts"], ml20m["ml-20m_256"]["counts"]
    csas = sasrec["counts"]
    causal_row = causal_rows[("bfloat16", CAUSAL_RATES)]   # SASRec's shape
    tiled_128 = tiled_rows[("bfloat16", N_ROWS, ML20M_VOCAB, 128)]
    tiled_256 = tiled_rows[("bfloat16", N_ROWS, ML20M_VOCAB, 256)]
    tiled_fp32 = tiled_rows[("float32", N_ROWS, ML20M_VOCAB, 128)]
    tf32_src = "layer_tf32.cu"       # fp32 K1 (serving), K1' and K2
    wgmma_src = "layer_hopper.cuh"   # bf16 K1 / K2
    loss_wgmma = "loss_hopper.cuh"   # bf16 K3-K7
    # K8 / K9 at bert_base_512's shape and rates; launches from its train()
    flash_row = flash_rows[(FLASH_SHAPES[0], "bfloat16", False)]
    flash_fp32 = flash_rows[(FLASH_SHAPES[0], "float32", False)]
    c_base, c_base32 = base["counts"], base_fp32["counts"]
    rel_row = rel_rows[("bfloat16", False)]   # the temporal path's variant
    c_temp = temporal["counts"]
    loss_py = "bert4rec_tpu/ops/fused_mlm_loss.py"
    k1, k2 = (f"bert4rec_tpu/ops/fused_encoder_layer.py:{n}"
              for n in (241, 265))
    k8, k9 = (f"bert4rec_tpu/ops/flash_attention.py:{n}" for n in (126, 141))
    record = {"kernels": [
        # what the server runs: fp32, B=32 (the HTTP burst's batches, with
        # the deployment phase's artifact call at B=32) and B=256
        # (recommend_stream's, with its artifact call at B=256)
        entry("fused_encoder_layer", tf32_src, k1,
              launches + deployed["launches"][32],
              layer_rows[("float32", 32)]),
        entry("fused_encoder_layer_b256", tf32_src, k1,
              stream_launches + deployed["launches"][STREAM_BATCH],
              layer_rows[("float32", STREAM_BATCH)]),
        # with the sweep's ml-1m_128, ml-20m_128 and reddit_128 (phase 24)
        entry("fused_encoder_layer_dropout", wgmma_src, k1, counts["layer_fwd"]
              + swept(sweep, "layer_fwd", h=128, f=512, s=SEQ),
              train_row["fwd"]),
        entry("fused_encoder_layer_backward", wgmma_src, k2,
              counts["layer_bwd"]
              + swept(sweep, "layer_bwd", h=128, f=512, s=SEQ),
              train_row["bwd"]),
        # fp32 K1' / K2 (3xTF32): launches from the fp32 ml-20m_128 and
        # ml-1m_128 train() runs (the harness's ml20m and ml1m presets) and
        # the ml1m oracle gate (its forwards with the evaluations' K1)
        entry("fused_encoder_layer_dropout_fp32", tf32_src, k1,
              fp32_ml20m["counts"]["layer_fwd"]
              + fp32_ml1m["counts"]["layer_fwd"] + oracle["layer_fwd"],
              fp32_row["fwd"]),
        entry("fused_encoder_layer_backward_fp32", tf32_src, k2,
              fp32_ml20m["counts"]["layer_bwd"]
              + fp32_ml1m["counts"]["layer_bwd"] + oracle["layer_bwd"],
              fp32_row["bwd"]),
        # ml-20m_256's width; launches from its train() run and the sweep's
        entry("fused_encoder_layer_dropout_h256", wgmma_src, k1,
              c256["layer_fwd"]
              + swept(sweep, "layer_fwd", h=256, f=1024, s=SEQ),
              wide_row["fwd"]),
        entry("fused_encoder_layer_backward_h256", wgmma_src, k2,
              c256["layer_bwd"]
              + swept(sweep, "layer_bwd", h=256, f=1024, s=SEQ),
              wide_row["bwd"]),
        entry("fused_mlm_loss", loss_wgmma, f"{loss_py}:111",
              counts["K3"] + swept(sweep, "K3", w=128),
              loss_rows["bfloat16"]["K3"]),
        entry("fused_mlm_loss_backward", loss_wgmma, f"{loss_py}:148",
              counts["K4"] + swept(sweep, "K4", w=128),
              loss_rows["bfloat16"]["K4"]),
        # the vocab-tiled family; launches from the four ML-20M train()
        # runs (BERT4Rec ml-20m_128 and ml-20m_256, SASRec ml-20m_128,
        # temporal ml-20m_128) and the sweep's configs, K5 at each width
        # apart
        entry("fused_mlm_loss_tiled", loss_wgmma, f"{loss_py}:375",
              c128["K5"] + csas["K5"] + c_temp["K5"]
              + swept(sweep, "K5", w=128), tiled_128["K5"]),
        entry("fused_mlm_loss_tiled_w256", loss_wgmma, f"{loss_py}:375",
              c256["K5"] + swept(sweep, "K5", w=256), tiled_256["K5"]),
        entry("fused_mlm_loss_tiled_backward_merged", loss_wgmma,
              f"{loss_py}:502",
              c128["K6"] + c256["K6"] + csas["K6"] + c_temp["K6"]
              + swept(sweep, "K6", w=128), tiled_128["K6"]),
        entry("fused_mlm_loss_tiled_backward_two_sweep", loss_wgmma,
              f"{loss_py}:602",
              c128["K7"] + c256["K7"] + csas["K7"] + c_temp["K7"]
              + swept(sweep, "K7", w=256), tiled_256["K7"]),
        # fp32 K5 and K6 (3xTF32): launches from the fp32 ml-20m_128
        # train() run (the harness's ml20m preset)
        entry("fused_mlm_loss_tiled_fp32", "loss_tf32.cuh", f"{loss_py}:375",
              fp32_ml20m["counts"]["K5"], tiled_fp32["K5"]),
        entry("fused_mlm_loss_tiled_backward_merged_fp32", "loss_tf32.cuh",
              f"{loss_py}:502", fp32_ml20m["counts"]["K6"], tiled_fp32["K6"]),
        # fp32 K3 / K4 (3xTF32): launches from the fp32 ml-1m_128 train()
        # run (the harness's ml1m preset) and the ml1m oracle gate
        entry("fused_mlm_loss_fp32", "loss_tf32.cuh", f"{loss_py}:111",
              fp32_ml1m["counts"]["K3"] + oracle["K3"],
              loss_rows["float32"]["K3"]),
        entry("fused_mlm_loss_backward_fp32", "loss_tf32.cuh",
              f"{loss_py}:148", fp32_ml1m["counts"]["K4"] + oracle["K4"],
              loss_rows["float32"]["K4"]),
        # K1'' causal (SASRec): launches from its train() run
        entry("fused_encoder_layer_causal", wgmma_src, k1,
              csas["causal_fwd"], causal_row["fwd"]),
        entry("fused_encoder_layer_causal_backward", wgmma_src, k2,
              csas["causal_bwd"], causal_row["bwd"]),
        # K8 / K9 (bert_base_512): launches from its train() run
        entry("flash_attention", "flash_attention.cu", k8,
              c_base["flash.launches"], flash_row["fwd"]),
        entry("flash_attention_backward", "flash_attention.cu", k9,
              c_base["flash.backward_launches"], flash_row["bwd"]),
        # fp32 K8 / K9 (3xTF32): launches on the tf32 route from the fp32
        # bert_base_512 train() run
        entry("flash_attention_fp32", "flash_tf32.cuh", k8,
              c_base32["flash.tf32_launches"], flash_fp32["fwd"]),
        entry("flash_attention_backward_fp32", "flash_tf32.cuh", k9,
              c_base32["flash.tf32_backward_launches"], flash_fp32["bwd"]),
        # K1'' rel_bias / K2 dRel (temporal ml-20m_128): launches from its
        # train() run
        entry("fused_encoder_layer_rel", wgmma_src, k1,
              c_temp["rel_fwd"], rel_row["fwd"]),
        entry("fused_encoder_layer_rel_backward", wgmma_src,
              "bert4rec_tpu/ops/fused_encoder_layer.py:315",
              c_temp["rel_bwd"], rel_row["bwd"]),
        # the vocab-sharded loss (phase 23): fp32 K5's stats entry and K6
        # with valid_ge_zero on each rank's block of the Reddit table;
        # launches from the ranks' train() runs, times at rank 0's shard
        entry("fused_mlm_loss_tiled_stats_sharded_fp32", "loss_tf32.cuh",
              f"{loss_py}:375", meshed["launches"]["sharded.launches"],
              meshed["K5"]),
        entry("fused_mlm_loss_tiled_backward_merged_sharded_fp32",
              "loss_tf32.cuh", f"{loss_py}:502",
              meshed["launches"]["sharded.merged_launches"], meshed["K6"]),
    ]}
    # phase 24: the shapes only the shipped configs reach; launches from
    # the sweep's configs of that shape, bf16 K1 from serving_bench
    for key, (h, _, f, s, _) in NEW_LAYER_SHAPES.items():
        row = tools["layer"][key]
        record["kernels"] += [
            entry(f"fused_encoder_layer_dropout_{key}", wgmma_src, k1,
                  swept(sweep, "layer_fwd", h=h, f=f, s=s), row["fwd"]),
            entry(f"fused_encoder_layer_backward_{key}", wgmma_src, k2,
                  swept(sweep, "layer_bwd", h=h, f=f, s=s), row["bwd"])]
    for w in NEW_WHOLE_TABLE_WIDTHS:
        row = tools["whole_table"][w]
        record["kernels"] += [
            entry(f"fused_mlm_loss_w{w}", loss_wgmma, f"{loss_py}:111",
                  swept(sweep, "K3", w=w), row["K3"]),
            entry(f"fused_mlm_loss_backward_w{w}", loss_wgmma,
                  f"{loss_py}:148", swept(sweep, "K4", w=w), row["K4"])]
    record["kernels"] += [
        entry("fused_mlm_loss_tiled_w64", loss_wgmma, f"{loss_py}:375",
              swept(sweep, "K5", w=64), tools["tiled"]["w64"]["K5"]),
        entry("fused_mlm_loss_tiled_backward_merged_w64", loss_wgmma,
              f"{loss_py}:502", swept(sweep, "K6", w=64),
              tools["tiled"]["w64"]["K6"]),
        entry("fused_mlm_loss_tiled_backward_merged_w256", loss_wgmma,
              f"{loss_py}:502", swept(sweep, "K6", w=256),
              tools["tiled"]["w256"]["K6"]),
        entry("fused_encoder_layer_bf16", wgmma_src, k1,
              tools["serving_launches"], layer_rows[("bfloat16", 32)])]
    # K10 at ml-20m_128's batch; launches from its counted train()
    record["kernels"].append(entry(
        "table_gradient", "table_grad.cu",
        "bert4rec_tpu/models/components/layers.py embedding_lookup "
        "(jnp.take; XLA's scatter-add, no TPU kernel)",
        c128["K10"], table_rows["ml-20m_128"]))
    # K11 and K8 / K9 at 192 / 128 (moonlight_5L.train); launches from
    # phase 27's counted train()
    record["kernels"] += [
        entry("expert_mlp", "expert_gemm.cu",
              "no TPU kernel (the JAX package has no experts): the mla_moe "
              "block's routed SwiGLU experts", moon["counts"]["K11"],
              expert_row["fwd"]),
        entry("expert_mlp_backward", "expert_gemm.cu",
              "no TPU kernel (the JAX package has no experts): the mla_moe "
              "block's routed SwiGLU experts",
              moon["counts"]["K11_backward"], expert_row["bwd"]),
        entry("flash_attention_dk192_dv128", "flash_attention.cu", k8,
              moon["counts"]["flash"], mla_row["fwd"]),
        entry("flash_attention_dk192_dv128_backward", "flash_attention.cu", k9,
              moon["counts"]["flash_backward"], mla_row["bwd"])]
    # K12 at the leaves of phases 27 and 14; launches from their counted
    # train()
    record["kernels"] += [
        entry(f"adamw_update_{name}", "adamw.cu",
              "no TPU kernel: optax's chain(clip_by_global_norm, adamw), "
              "left to XLA", n, row)
        for name, n, row in (
            ("moonlight_5L", moon["counts"]["K12"], moon["adamw"]),
            ("bert_base_512", base["counts"]["K12"], base["adamw"]))]
    credit_examples(record, examples, entry)
    idle = [k["name"] for k in record["kernels"] if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    print(f"card: {card}", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
