#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bert4rec_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device   — the card's name and power limit, as nvidia-smi reports them;
2. build    — every CUDA source under ``bert4rec_tpu_torch/csrc/`` built
              with nvcc for sm_90a, all at once;
3. kernels  — each kernel against its plain PyTorch version on the card at
              the serving path's shapes (ml-1m_128: S=200, H=128, 4 heads,
              F=512; B=32 and B=256; fp32 and bf16), with times of the
              kernel, the plain version and a PyTorch-library yardstick;
4. serving  — an ml-1m_128 artifact (random weights from a seed, a
              synthetic 3706-item vocab) written in the JAX package's
              on-disk format, loaded onto the card, served over HTTP by
              ``RecommenderService`` + ``ServingServer`` to a few dozen
              concurrent requests, each answer checked against the plain
              path on the card; then the bulk ``recommend_stream`` path at
              B=256. Kernel launch counts are reset before each path and
              must equal layers x batches after it.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, the script fails before printing either.
"""

import json
import math
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

SEED = 0
VOCAB = 3709          # ML-1M items + [PAD], [MASK], [UNK]
N_ITEMS = VOCAB - 3
SEQ, HIDDEN, HEADS, INNER = 200, 128, 4, 512
N_REQUESTS = 48
STREAM_BATCH, STREAM_BATCHES = 256, 2
TOL = {"float32": 1e-4, "bfloat16": 8e-2}  # kernel vs plain, max abs
LOGIT_TOL = 1e-3      # served path vs plain path, masked-slot logits
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s by operand type (fp32 outside the tensor cores, bf16 inside)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    import torch
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


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #

def random_layer(rng, device):
    """One ml-1m_128 encoder layer in the JAX param layout."""
    import numpy as np
    from bert4rec_tpu_torch.utils.checkpoint import params_from_numpy
    d = HIDDEN // HEADS

    def w(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return params_from_numpy({
        "attention/qkv/kernel": w(HIDDEN, 3, HEADS, d, scale=0.1),
        "attention/qkv/bias": w(3, HEADS, d, scale=0.02),
        "attention/output/kernel": w(HEADS, d, HIDDEN),
        "attention/output/bias": w(HIDDEN, scale=0.02),
        "attention_norm/scale": 1.0 + w(HIDDEN, scale=0.1),
        "attention_norm/bias": w(HIDDEN, scale=0.02),
        "intermediate/kernel": w(HIDDEN, INNER),
        "intermediate/bias": w(INNER, scale=0.02),
        "output/kernel": w(INNER, HIDDEN),
        "output/bias": w(HIDDEN, scale=0.02),
        "output_norm/scale": 1.0 + w(HIDDEN, scale=0.1),
        "output_norm/bias": w(HIDDEN, scale=0.02),
    }, device)


def library_layer(params, x, mask, num_heads):
    """The same layer from PyTorch library calls (torch.matmul,
    scaled_dot_product_attention, layer_norm): a speed yardstick only; the
    port never calls it."""
    import torch
    import torch.nn.functional as F
    from bert4rec_tpu_torch.ops.fused_encoder_layer import flat_weights
    flat = {k: v.to(x.dtype) for k, v in flat_weights(params).items()}
    b, s, h = x.shape
    qkv = torch.matmul(x, flat["wqkv"]) + flat["bqkv"]
    q, k, v = (t.view(b, s, num_heads, h // num_heads).transpose(1, 2)
               for t in qkv.split(h, dim=-1))
    bias = torch.where(mask > 0, 0.0, -1e9).to(x.dtype)[:, None, None, :]
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    ctx = ctx.transpose(1, 2).reshape(b, s, h)
    x1 = F.layer_norm(x + torch.matmul(ctx, flat["wo"]) + flat["bo"], (h,),
                      flat["g1"][0], flat["b1ln"][0], eps=1e-12)
    hact = F.gelu(torch.matmul(x1, flat["w1"]) + flat["bf1"],
                  approximate="tanh")
    return F.layer_norm(x1 + torch.matmul(hact, flat["w2"]) + flat["bf2"],
                        (h,), flat["g2"][0], flat["b2ln"][0], eps=1e-12)


def layer_bound_ms(b, dtype_name):
    """Least time for one layer on the card: the larger of its FLOP over
    the peak for the operand type and its bytes (x, mask and the fp32
    params read once, y written once) over the HBM rate."""
    s, h, f = SEQ, HIDDEN, INNER
    flops = b * (2 * s * h * 3 * h + 4 * s * s * h + 2 * s * h * h
                 + 4 * s * h * f)
    es = 4 if dtype_name == "float32" else 2
    params = 4 * (4 * h * h + 2 * h * f + 3 * h + h + 4 * h + f + h)
    nbytes = 2 * b * s * h * es + b * s * 4 + params
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _kernel_name(key: str) -> str:
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0][:60]


def device_breakdown(torch, fn, calls=5, top=6) -> str:
    """Device ms per call of ``fn`` in all and for its ``top`` costliest
    CUDA kernels, from torch.profiler (CUPTI); "not measured" if the trace
    holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((_kernel_name(e.key), e.self_device_time_total
                    / calls / 1e3) for e in prof.key_averages()
                   if getattr(e, "self_device_time_total", 0) > 0),
                  key=lambda r: -r[1])
    if not rows:
        return "device time not measured"
    total = sum(ms for _, ms in rows)
    rest = sum(ms for _, ms in rows[top:])
    parts = [f"{name} {ms:.4f}" for name, ms in rows[:top]]
    if rest:
        parts.append(f"{len(rows) - top} others {rest:.4f}")
    return f"device {total:.4f} ms = " + ", ".join(parts)


def check_fused_layer(torch, rng, device):
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    import numpy as np
    params = random_layer(rng, device)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for b in (32, STREAM_BATCH):
            x = torch.from_numpy(rng.normal(size=(b, SEQ, HIDDEN))
                                 .astype(np.float32)).to(device, dtype)
            lengths = rng.integers(1, SEQ + 1, size=b)
            mask = torch.from_numpy(
                (np.arange(SEQ)[None, :] < lengths[:, None])
                .astype(np.int32)).to(device)
            out = fel.fused_encoder_layer(params, x, mask, num_heads=HEADS)
            torch.cuda.synchronize()
            ref = fel.fused_encoder_layer_plain(params, x, mask,
                                                num_heads=HEADS)
            err = float((out.float() - ref.float()).abs().max())
            lib_err = float((library_layer(params, x, mask, HEADS).float()
                             - ref.float()).abs().max())
            if not (out.shape == x.shape and out.dtype == dtype
                    and bool(torch.isfinite(out).all())):
                raise AssertionError(f"fused layer output malformed "
                                     f"({name}, B={b})")
            if not err <= TOL[name]:
                raise AssertionError(
                    f"fused layer {name} B={b}: max abs err {err} > "
                    f"{TOL[name]}")
            ms = time_ms(lambda: fel.fused_encoder_layer(
                params, x, mask, num_heads=HEADS))
            plain_ms = time_ms(lambda: fel.fused_encoder_layer_plain(
                params, x, mask, num_heads=HEADS))
            library_ms = time_ms(lambda: library_layer(params, x, mask,
                                                       HEADS))
            bound_ms, bound_by = layer_bound_ms(b, name)
            rows[(name, b)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   library_ms=library_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
            print(f"fused_encoder_layer {name} B={b} S={SEQ} H={HIDDEN} "
                  f"N={HEADS} F={INNER}: max_abs_err={err:.3g} "
                  f"(tol {TOL[name]}; library composition differs by "
                  f"{lib_err:.3g}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
                  f" library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
                  f"({bound_by})", flush=True)
            print("  per launch of the kernel: " + device_breakdown(
                torch, lambda: fel.fused_encoder_layer(
                    params, x, mask, num_heads=HEADS)), flush=True)
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
    import numpy as np
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
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=N_REQUESTS) as pool:
            answers = list(pool.map(lambda a: post(server.port, *a),
                                    zip(histories, ks)))
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        launches = fel.fused_encoder_layer.launches
    finally:
        server.stop()
    batches = health["batches"] - warm["batches"]
    if health["requests"] - warm["requests"] != N_REQUESTS \
            or health["errors"] != 0:
        raise AssertionError(f"healthz: {health}")
    if launches != cfg.num_layers * batches:
        raise AssertionError(
            f"fused layer launched {launches} times for {batches} batches "
            f"of {cfg.num_layers} layers")
    print(f"serving: {N_REQUESTS} concurrent HTTP requests in "
          f"{wall * 1e3:.1f} ms, {batches} batches (largest "
          f"{health['max_batch_observed']}), fused_encoder_layer launches "
          f"{launches} = {cfg.num_layers} layers x {batches} batches",
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
              torch, lambda: rec.recommend_batch(batch, top_k=10)),
          flush=True)

    # the bulk path: recommend_stream over full 256-history batches
    stream = [[history() for _ in range(STREAM_BATCH)]
              for _ in range(STREAM_BATCHES)]
    fel.fused_encoder_layer.launches = 0
    results = list(rec.recommend_stream(stream, top_k=10))
    stream_launches = fel.fused_encoder_layer.launches
    if stream_launches != cfg.num_layers * STREAM_BATCHES:
        raise AssertionError(f"recommend_stream launched the fused layer "
                             f"{stream_launches} times")
    print(f"recommend_stream: {STREAM_BATCHES} batches of {STREAM_BATCH}, "
          f"fused_encoder_layer launches {stream_launches}", flush=True)
    flat_hist = [h for b in stream for h in b]
    flat_ans = [a for r in results for a in r]
    check_answers(torch, rec, flat_hist, [10] * len(flat_hist), flat_ans,
                  "recommend_stream")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
        regs = [int(w) for ln in log.splitlines() if "Used" in ln
                for w, nxt in zip(ln.split(), ln.split()[1:])
                if nxt == "registers,"]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill stores" in ln and " 0 bytes spill stores" not in ln]
        print(f"build {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spills "
              f"{spills or 'none'}", flush=True)

    rng = np.random.default_rng(SEED)
    layer_rows = check_fused_layer(torch, rng, device)
    launches = check_serving(torch, rng, device)

    main_row = layer_rows[("float32", 32)]   # what the server runs
    record = {"kernels": [{
        "name": "fused_encoder_layer",
        "route": "cuda",
        "source": "bert4rec_tpu_torch/csrc/fused_encoder_layer.cu",
        "replaces": "bert4rec_tpu/ops/fused_encoder_layer.py:241",
        "launches": launches,
        **main_row,
    }]}
    print(f"card: {card}", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
