"""Fused post-LN transformer encoder layer, forward and backward (port of
``bert4rec_tpu/ops/fused_encoder_layer.py``).

Replaces the TPU kernels ``_fwd_kernel`` (K1, ``_run_forward``) and
``_bwd_kernel`` / ``_bwd_element`` (K2, ``_run_backward``) of
``bert4rec_tpu/ops/fused_encoder_layer.py``, with their causal and
relative-bias variants, with the hand-written Hopper CUDA kernels of
``csrc/fused_encoder_layer.cu``. The TPU kernel kept one
layer and one sequence in ~14 MB of VMEM per grid cell; an H100 block has
at most 227 KB of shared memory, so the forward is five launches (tiled
GEMMs with bias / gelu / residual + dropout + LayerNorm epilogues and a
two-pass attention kernel) and the backward eleven plus deterministic
split reductions (see the source's header).

Bound: about 2·S·H·3H + 4·S²·H + 2·S·H² + 4·S·H·F FLOP per sequence
forward (99 MFLOP at S=200, H=128, F=512) and about twice that backward,
against a few MB of activations: the layer is bound by operations.
``kernel_route`` picks the kernels by a shape law: bf16 with H, the head
dim and F multiples of 8 runs the ``wgmma`` kernels of
``csrc/layer_hopper.cuh`` (attention on ``csrc/flash_hopper.cuh``'s); any
other bf16 shape the earlier ``mma.sync`` kernels (counted apart, in
``mma_sync_launches``); fp32 at H <= 256, head dim <= 64, H, head dim and F
multiples of 8 the 3xTF32 ``wgmma`` kernels of ``csrc/layer_tf32.cu``,
forward and backward, at inference and in training (counted also in
``tf32_launches`` / ``tf32_backward_launches``; each launch splits its
weights into TF32 hi and lo parts itself, so nothing is cached); fp32
off that rule the SIMT loops. Their times are in PERF.md.

What it computes is ``_layer_fwd_math`` and ``_bwd_element``:
tanh-approximate gelu (whatever ``inner_activation`` says — the JAX kernel
does the same), fp32 softmax/LayerNorm statistics, matmuls on operands in
the input dtype with fp32 sums, rounding to the input dtype at qkv, p, ctx,
x1, the gelu output and y, and dropout on the attention probabilities
(site ``h`` per head) and on both sublayer outputs (sites ``N`` and
``N + 1``) with the masks of ``ops/dropout_bits.py``. With ``causal`` the
scores add the TPU kernel's triangle, ``pad_bias + causal_bias`` (K1''
causal, the SASRec family): a padded key after its query scores -2e9, one
on or before it -1e9. With ``rel_bias`` (K1'' rel_bias and K2 dRel, the
temporal family) an fp32 ``[B, N, S, S]`` bias is added to the scores after
the pad and causal biases, and the backward returns its gradient, ``dRel =
p (dp - delta)`` in fp32 before the rounding to the compute dtype (JAX's
``ds32``). It adds 4 bytes per score read and, backward, 4 written: at
ml-20m_128 the bias and its gradient are 164 MB each.

Routing: a CPU tensor runs the plain version (forward and backward); a
CUDA tensor launches the kernels or raises. A forward that saves nothing
for a backward (inference: the served layer on every route) is the
registered operator ``torch.ops.bert4rec_tpu_torch.fused_layer_forward``
(``fused_layer_forward``), so ``torch.export`` keeps it in an exported
program as one call; its CUDA implementation launches K1, its CPU one is
the plain version, and its fake one gives the output's shape.
"""

import ctypes
import math
from typing import List, Optional

import torch

from bert4rec_tpu_torch.ops import dropout_bits

NEG_INF = -1e9
LN_EPS = 1e-12
MAX_FUSED_SEQ_LEN = 512
# the CUDA kernels' limits (b4r_fused_layer_max_hidden / _max_head_dim; the
# batch is a grid dimension)
MAX_KERNEL_HIDDEN = 512
MAX_KERNEL_HEAD_DIM = 128
MAX_KERNEL_BATCH = 65535
# the 3xTF32 kernels' limits (b4r_fused_layer_tf32_max_hidden /
# _max_head_dim in csrc/layer_tf32.cu)
TF32_MAX_HIDDEN = 256
TF32_MAX_HEAD_DIM = 64
VMEM_BUDGET_BYTES = 14 * 1024 * 1024
_SITES_PER_CELL = dropout_bits.SITES_PER_CELL
_LOG2E = math.log2(math.e)
_GELU_C = math.sqrt(2.0 / math.pi)

_W_ORDER = ("wqkv", "bqkv", "wo", "bo", "g1", "b1ln", "w1", "bf1",
            "w2", "bf2", "g2", "b2ln")
_MATRICES = ("wqkv", "wo", "w1", "w2")  # cast to the input dtype
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SAVED = ("qkv", "ctx", "x1", "hact", "xhat1", "rstd1", "xhat2", "rstd2",
          "stat_m", "stat_l", "keep_bits")


# --------------------------------------------------------------------------- #
# routing law — copied from the JAX package (fused_encoder_layer.py:41-80).
# It is the JAX package's VMEM-fit rule, kept for parity so the port routes
# exactly the configs JAX routes to the fused (tanh-gelu) layer; it is not a
# limit of the Hopper kernels.
# --------------------------------------------------------------------------- #

def estimate_vmem_bytes(*, batch: int, seq_len: int, hidden: int,
                        inner_dim: int, dtype_bytes: int = 2,
                        temporal_heads: int = 0) -> int:
    """The JAX kernel's VMEM working-set estimate (backward pass)."""
    s, h, f = seq_len, hidden, inner_dim
    weight_elems = 4 * h * h + 2 * h * f
    weights = 8 * weight_elems
    activations = 4 * (13 * s * h + 3 * s * s + 3 * s * f)
    cell_blocks = 3 * s * h * dtype_bytes
    mask = batch * s * 4
    temporal = 2 * temporal_heads * s * s * 4 if temporal_heads else 0
    return weights + activations + cell_blocks + mask + temporal


def fused_layer_supported(*, batch: int, seq_len: int, hidden: int,
                          inner_dim: int, num_heads: int,
                          dtype_bytes: int = 2,
                          temporal: bool = False) -> bool:
    """Whether the JAX package would run the whole-layer fusion here."""
    if seq_len > MAX_FUSED_SEQ_LEN:
        return False
    if hidden % num_heads != 0 or num_heads + 2 > _SITES_PER_CELL:
        return False
    est = estimate_vmem_bytes(batch=batch, seq_len=seq_len, hidden=hidden,
                              inner_dim=inner_dim, dtype_bytes=dtype_bytes,
                              temporal_heads=num_heads if temporal else 0)
    return est <= VMEM_BUDGET_BYTES


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #

def flat_weights(params: dict) -> dict:
    """Layer-param dict -> flat 2-D operands, as the JAX ``_flat_weights``
    (qkv kernel ``[H,3,N,D]`` -> ``[H,3H]``, output kernel ``[N,D,H]`` ->
    ``[H,H]``; vectors -> ``[1, n]``). The results are views, so autograd
    carries gradients of the flat operands back to the params."""
    h = params["attention"]["qkv"]["kernel"].shape[0]
    three_h = 3 * h
    f = params["intermediate"]["kernel"].shape[1]
    return dict(
        wqkv=params["attention"]["qkv"]["kernel"].reshape(h, three_h),
        bqkv=params["attention"]["qkv"]["bias"].reshape(1, three_h),
        wo=params["attention"]["output"]["kernel"].reshape(h, h),
        bo=params["attention"]["output"]["bias"].reshape(1, h),
        g1=params["attention_norm"]["scale"].reshape(1, h),
        b1ln=params["attention_norm"]["bias"].reshape(1, h),
        w1=params["intermediate"]["kernel"],
        bf1=params["intermediate"]["bias"].reshape(1, f),
        w2=params["output"]["kernel"],
        bf2=params["output"]["bias"].reshape(1, h),
        g2=params["output_norm"]["scale"].reshape(1, h),
        b2ln=params["output_norm"]["bias"].reshape(1, h),
    )


# --------------------------------------------------------------------------- #
# plain version — the same math in PyTorch, every cast where the kernel has it
# --------------------------------------------------------------------------- #

def _ln_fwd(w: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    mean = w.mean(dim=-1, keepdim=True)
    var = (w - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (w - mean) * rstd
    return xhat * g + b, xhat, rstd


def _ln_bwd(dy, xhat, rstd, g):
    dxhat = dy * g
    mean1 = dxhat.mean(dim=-1, keepdim=True)
    mean2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxhat - mean1 - xhat * mean2)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    inner = _GELU_C * (x + 0.044715 * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(inner))


def _gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    inner = _GELU_C * (x + 0.044715 * x * x * x)
    t = torch.tanh(inner)
    dinner = _GELU_C * (1.0 + 3.0 * 0.044715 * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner


def _work_dtype(dtype):
    """fp32 sums, as on the card; float64 stays float64 (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def dropout_keeps(seed: int, batch: int, seq_len: int, hidden: int,
                  num_heads: int, attn_rate: float, out_rate: float,
                  device, dtype=torch.float32):
    """The layer's keep-scale tensors (``None`` at rate 0): per head
    ``[B, N, S, S]`` on the probabilities, ``[B, S, H]`` on the attention
    output (site N) and on the FFN output (site N + 1)."""
    keep1 = keep2 = keep3 = None
    if attn_rate > 0.0:
        keep1 = dropout_bits.keep_scale(seed, batch, range(num_heads),
                                        seq_len, seq_len, attn_rate, device,
                                        dtype)
    if out_rate > 0.0:
        k = dropout_bits.keep_scale(seed, batch, (num_heads, num_heads + 1),
                                    seq_len, hidden, out_rate, device, dtype)
        keep2, keep3 = k[:, 0], k[:, 1]
    return keep1, keep2, keep3


def causal_bias(seq_len: int, device, dtype=torch.float32) -> torch.Tensor:
    """``[S, S]`` additive triangle: 0 where key <= query, -1e9 after
    (the TPU kernel's ``_causal_bias``)."""
    idx = torch.arange(seq_len, device=device)
    return torch.where(idx[None, :] <= idx[:, None], 0.0, NEG_INF).to(dtype)


def _forward_math(flat: dict, x: torch.Tensor, input_mask: torch.Tensor,
                  num_heads: int, seed: int, attn_rate: float,
                  out_rate: float, causal: bool = False, rel=None,
                  mm=torch.matmul) -> dict:
    """``_layer_fwd_math`` over the whole batch; returns every residual
    the backward needs. ``rel`` ([B, N, S, S]) is added to the scores
    last, in fp32, as the TPU kernel adds it. ``mm`` takes every product
    (the tests pass ``ops/tf32.py``'s 3xTF32 law)."""
    dtype = x.dtype
    f32 = _work_dtype(dtype)
    b, s, h = x.shape
    d = h // num_heads
    w = {k: flat[k].to(dtype).to(f32) for k in _MATRICES}
    v32 = {k: flat[k].to(f32) for k in _W_ORDER if k not in _MATRICES}
    scale = 1.0 / math.sqrt(d)
    keep1, keep2, keep3 = dropout_keeps(seed, b, s, h, num_heads, attn_rate,
                                        out_rate, x.device, f32)

    x32 = x.to(f32)
    qkv = (mm(x32, w["wqkv"]) + v32["bqkv"]).to(dtype).to(f32)
    q, k, v = (t.reshape(b, s, num_heads, d).transpose(1, 2)
               for t in qkv.split(h, dim=-1))                  # [B,N,S,D]
    bias = torch.where(input_mask > 0, 0.0, NEG_INF).to(f32)[:, None, None]
    if causal:
        bias = bias + causal_bias(s, x.device, f32)
    scores = mm(q, k.transpose(-1, -2)) * scale + bias
    if rel is not None:
        scores = scores + rel.to(f32)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp2((scores - m) * _LOG2E)
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))                # [B,N,S,S]
    pk = p if keep1 is None else p * keep1
    ctx = mm(pk.to(dtype).to(f32), v)                          # [B,N,S,D]
    ctx = ctx.transpose(1, 2).reshape(b, s, h).to(dtype).to(f32)

    attn = mm(ctx, w["wo"]) + v32["bo"]
    if keep2 is not None:
        attn = attn * keep2
    u = x32 + attn
    x1, xhat1, rstd1 = _ln_fwd(u, v32["g1"], v32["b1ln"])
    x1 = x1.to(dtype).to(f32)
    hpre = mm(x1, w["w1"]) + v32["bf1"]
    hact = _gelu_tanh(hpre).to(dtype).to(f32)
    f = mm(hact, w["w2"]) + v32["bf2"]
    if keep3 is not None:
        f = f * keep3
    y, xhat2, rstd2 = _ln_fwd(x1 + f, v32["g2"], v32["b2ln"])
    return dict(w=w, qkv=qkv, q=q, k=k, v=v, p=p, keep1=keep1, ctx=ctx,
                keep2=keep2, x1=x1, xhat1=xhat1, rstd1=rstd1, hpre=hpre,
                hact=hact, keep3=keep3, xhat2=xhat2, rstd2=rstd2,
                y=y.to(dtype))


def fused_encoder_layer_plain(params: dict, x: torch.Tensor,
                              input_mask: torch.Tensor, *,
                              num_heads: int,
                              attention_dropout: float = 0.0,
                              output_dropout: float = 0.0,
                              seed: int = 0,
                              causal: bool = False,
                              rel_bias=None) -> torch.Tensor:
    """Plain PyTorch version of the fused layer's forward
    (``_layer_fwd_math``, whole batch at once). Matmul operands in the
    input dtype are widened to fp32, so a bf16 product is exact and sums
    are fp32, as on the TPU."""
    return _forward_math(flat_weights(params), x, input_mask, num_heads,
                         seed, attention_dropout, output_dropout, causal,
                         rel_bias)["y"]


def _rows_sum(t: torch.Tensor) -> torch.Tensor:
    """Column sums over every leading axis, as ``[1, n]``."""
    return t.reshape(-1, t.shape[-1]).sum(dim=0, keepdim=True)


def _tn(a: torch.Tensor, b: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """``a^T b`` summed over all rows: ``[.., K1]`` x ``[.., N]`` ->
    ``[K1, N]``."""
    return mm(a.reshape(-1, a.shape[-1]).T, b.reshape(-1, b.shape[-1]))


def fused_encoder_layer_plain_backward(flat: dict, x: torch.Tensor,
                                       input_mask: torch.Tensor,
                                       dy: torch.Tensor, *, num_heads: int,
                                       attention_dropout: float = 0.0,
                                       output_dropout: float = 0.0,
                                       seed: int = 0,
                                       causal: bool = False,
                                       rel_bias=None, mm=torch.matmul):
    """Plain PyTorch version of the fused layer's backward
    (``_bwd_element``, whole batch at once): recomputes the forward with
    the same masks (triangle and relative bias) and returns ``(dx,
    {name: grad})`` with ``dx`` in the input dtype and the 12 flat-operand
    gradients in the params' dtype; with ``rel_bias`` also ``"rel"``, its
    gradient ``[B, N, S, S]`` in fp32 (JAX's ``ds32``). ``mm`` takes every
    product, the forward's recomputed ones too."""
    dtype = x.dtype
    f32 = _work_dtype(dtype)
    r = _forward_math(flat, x, input_mask, num_heads, seed,
                      attention_dropout, output_dropout, causal, rel_bias,
                      mm)
    w = r["w"]
    b, s, h = x.shape
    d = h // num_heads
    scale = 1.0 / math.sqrt(d)
    g1, g2 = flat["g1"].to(f32), flat["g2"].to(f32)

    def t(a):  # round to the input dtype, as JAX's ``.astype(dtype)``
        return a.to(dtype).to(f32)

    dy32 = dy.to(f32)
    grads = {}
    # ---- LN2 ----
    grads["g2"] = _rows_sum(dy32 * r["xhat2"])
    grads["b2ln"] = _rows_sum(dy32)
    dw_res = _ln_bwd(dy32, r["xhat2"], r["rstd2"], g2)
    # ---- FFN branch ----
    df = dw_res if r["keep3"] is None else dw_res * r["keep3"]
    grads["w2"] = _tn(r["hact"], t(df), mm)
    grads["bf2"] = _rows_sum(df)
    dhact = mm(t(df), w["w2"].T)
    dhpre = dhact * _gelu_tanh_grad(r["hpre"])
    grads["w1"] = _tn(r["x1"], t(dhpre), mm)
    grads["bf1"] = _rows_sum(dhpre)
    dx1 = dw_res + mm(t(dhpre), w["w1"].T)
    # ---- LN1 ----
    grads["g1"] = _rows_sum(dx1 * r["xhat1"])
    grads["b1ln"] = _rows_sum(dx1)
    du = _ln_bwd(dx1, r["xhat1"], r["rstd1"], g1)
    # ---- attention output projection ----
    dattn = du if r["keep2"] is None else du * r["keep2"]
    grads["wo"] = _tn(r["ctx"], t(dattn), mm)
    grads["bo"] = _rows_sum(dattn)
    dctx = t(mm(t(dattn), w["wo"].T))
    # ---- attention cores (same masks) ----
    dctx_h = dctx.reshape(b, s, num_heads, d).transpose(1, 2)   # [B,N,S,D]
    p, keep1 = r["p"], r["keep1"]
    d_mat = p if keep1 is None else p * keep1
    dv = mm(t(d_mat).transpose(-1, -2), dctx_h)
    dd = mm(dctx_h, r["v"].transpose(-1, -2))
    dp = dd if keep1 is None else dd * keep1
    ds32 = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = t(ds32)
    dq = mm(ds, r["k"]) * scale
    dk = mm(ds.transpose(-1, -2), r["q"]) * scale

    def merge(a):  # [B,N,S,D] -> [B,S,H]
        return a.transpose(1, 2).reshape(b, s, h)

    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)  # [B,S,3H]
    grads["wqkv"] = _tn(x.to(f32), t(dqkv), mm)
    grads["bqkv"] = _rows_sum(dqkv)
    dx = (du + mm(t(dqkv), w["wqkv"].T)).to(dtype)
    grads = {k: grads[k].to(flat[k].dtype) for k in _W_ORDER}
    if rel_bias is not None:
        grads["rel"] = ds32
    return dx, grads


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

_lib = None
# device-pointer order of the C entry points (FwdPtr / BwdPtr in the source)
_FWD_PTRS = ("x", "mask", *_W_ORDER, "qkv", "ctx", "x1", "hact", "y",
             "xhat1", "rstd1", "xhat2", "rstd2", "stat_m", "stat_l", "rel",
             "keep_bits")
_TF32_PTRS = ("x", "mask", *_W_ORDER, "qkv", "ctx", "x1", "hact", "y", "rel",
              "wt", "xhat1", "rstd1", "xhat2", "rstd2", "stat_m", "stat_l")
_TF32_BWD_PTRS = ("x", "mask", "dy", "wqkv", "wo", "w1", "w2", "bf1", "g1",
                  "g2", "qkv", "ctx", "x1", "hact", "xhat1", "rstd1", "xhat2",
                  "rstd2", "stat_m", "stat_l", "dx", "dwqkv", "dbqkv", "dwo",
                  "gln1", "dw1", "dbf1", "dw2", "gln2", "workspace", "rel",
                  "drel")
_BWD_PTRS = ("x", "mask", "dy", "wqkv_t", "wo_t", "w1", "w1_t", "w2_t", "bf1",
             "g1", "g2", "qkv", "ctx", "x1", "hact", "xhat1", "rstd1",
             "xhat2", "rstd2", "stat_m", "stat_l", "dx", "dwqkv", "dbqkv",
             "dwo", "gln1", "dw1", "dbf1", "dw2", "gln2", "workspace", "rel",
             "drel", "keep_bits")


def _kernel_lib():
    global _lib
    if _lib is None:
        from bert4rec_tpu_torch.ops import kernel_build
        lib = kernel_build.load("fused_encoder_layer")
        vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        cf = ctypes.c_float
        # dtype, ptrs, B, S, H, N, F, causal, scale, seed, the two dropouts'
        # (threshold, scale, on), stream
        step_args = [ci, vp] + [ci] * 6 + [cf, cu, cu, cf, ci, cu, cf, ci, vp]
        for fn in (lib.b4r_fused_layer_fwd, lib.b4r_fused_layer_bwd,
                   lib.b4r_fused_layer_fwd_wgmma,
                   lib.b4r_fused_layer_bwd_wgmma):
            fn.restype = ci
            fn.argtypes = step_args
        lib.b4r_fused_layer_bwd_workspace_bytes.restype = ctypes.c_size_t
        lib.b4r_fused_layer_bwd_workspace_bytes.argtypes = [ci] * 6
        lib.b4r_fused_layer_bwd_wgmma_workspace_bytes.restype = \
            ctypes.c_size_t
        lib.b4r_fused_layer_bwd_wgmma_workspace_bytes.argtypes = [ci] * 5
        lib.b4r_dropout_keep_scale.restype = ci
        lib.b4r_dropout_keep_scale.argtypes = [vp, cu, cu, cf] + [ci] * 5 \
            + [vp]
        lib.b4r_fused_layer_max_hidden.restype = ci
        lib.b4r_fused_layer_max_hidden.argtypes = []
        lib.b4r_fused_layer_max_head_dim.restype = ci
        lib.b4r_fused_layer_max_head_dim.argtypes = []
        _lib = lib
    return _lib


_tf32_lib = None


def _kernel_lib_tf32():
    global _tf32_lib
    if _tf32_lib is None:
        from bert4rec_tpu_torch.ops import kernel_build
        lib = kernel_build.load("layer_tf32")
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        # ptrs, B, S, H, N, F, causal, scale, seed, the two dropouts'
        # (threshold, scale, on), stream
        for fn in (lib.b4r_fused_layer_fwd_tf32, lib.b4r_fused_layer_bwd_tf32):
            fn.restype = ci
            fn.argtypes = [vp] + [ci] * 6 + [cf, cu, cu, cf, ci, cu, cf, ci, vp]
        lib.b4r_fused_layer_bwd_tf32_workspace_bytes.restype = ctypes.c_size_t
        lib.b4r_fused_layer_bwd_tf32_workspace_bytes.argtypes = [ci] * 5
        for name in ("b4r_fused_layer_tf32_max_hidden",
                     "b4r_fused_layer_tf32_max_head_dim"):
            getattr(lib, name).restype = ci
            getattr(lib, name).argtypes = []
        lib.b4r_fused_layer_tf32_workspace_bytes.restype = ctypes.c_size_t
        lib.b4r_fused_layer_tf32_workspace_bytes.argtypes = [ci, ci]
        if (lib.b4r_fused_layer_tf32_max_hidden(),
                lib.b4r_fused_layer_tf32_max_head_dim()) \
                != (TF32_MAX_HIDDEN, TF32_MAX_HEAD_DIM):
            raise RuntimeError("the 3xTF32 kernel library's limits differ "
                               "from TF32_MAX_HIDDEN / TF32_MAX_HEAD_DIM")
        _tf32_lib = lib
    return _tf32_lib


def _check_operands(x, input_mask, flat, num_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, H], got {tuple(x.shape)}")
    b, s, h = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if input_mask.shape != (b, s) or input_mask.dtype != torch.int32:
        raise ValueError(f"input_mask must be int32 [{b}, {s}], got "
                         f"{input_mask.dtype} {tuple(input_mask.shape)}")
    if h % num_heads:
        raise ValueError(f"hidden {h} is not divisible by {num_heads} heads")
    for t in (input_mask, *flat.values()):
        if t.device != x.device:
            raise ValueError("x, input_mask and the layer params must lie "
                             "on one device")
    f = flat["w1"].shape[1]
    want = dict(wqkv=(h, 3 * h), bqkv=(1, 3 * h), wo=(h, h), w1=(h, f),
                bf1=(1, f), w2=(f, h))
    for name, t in flat.items():
        shape = want.get(name, (1, h))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if name not in _MATRICES and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def kernel_route(dtype, batch: int, hidden: int, num_heads: int,
                 inner_dim: int) -> str:
    """Which CUDA kernels run a layer of this shape (the shape law, decided
    before any launch from the dtype and shape alone, so that one layer's
    forward and backward take one route whatever the forward saves or
    draws): ``"wgmma"`` (bf16 on the warpgroup kernels of
    ``csrc/layer_hopper.cuh``, whose 16-byte copies need H, the head dim
    and F to be multiples of 8), ``"mma_sync"`` (any other bf16 shape: the
    earlier ``mma.sync`` kernels), ``"tf32"`` (fp32 with H <= 256, head dim
    <= 64 and H, head dim and F multiples of 8: the 3xTF32 kernels of
    ``csrc/layer_tf32.cu``, forward and backward, any dropout, causal or
    with a relative bias) or ``"simt"`` (every other fp32 shape: the SIMT
    kernels). Raises ValueError past every kernel's limits."""
    d = hidden // num_heads
    if hidden > MAX_KERNEL_HIDDEN or d > MAX_KERNEL_HEAD_DIM \
            or batch > MAX_KERNEL_BATCH:
        raise ValueError(
            f"fused layer kernel takes hidden <= {MAX_KERNEL_HIDDEN}, head "
            f"dim <= {MAX_KERNEL_HEAD_DIM} and batch <= {MAX_KERNEL_BATCH};"
            f" got hidden {hidden}, {num_heads} heads, batch {batch}")
    aligned = hidden % 8 == 0 and d % 8 == 0 and inner_dim % 8 == 0
    if dtype == torch.float32:
        if aligned and hidden <= TF32_MAX_HIDDEN and d <= TF32_MAX_HEAD_DIM:
            return "tf32"
        return "simt"
    if dtype != torch.bfloat16:
        raise ValueError(f"no fused layer kernel for {dtype}")
    return "wgmma" if aligned else "mma_sync"


def _check_kernel_limits(lib):
    if (lib.b4r_fused_layer_max_hidden(), lib.b4r_fused_layer_max_head_dim()) \
            != (MAX_KERNEL_HIDDEN, MAX_KERNEL_HEAD_DIM):
        raise RuntimeError("the kernel library's limits differ from "
                           "MAX_KERNEL_HIDDEN / MAX_KERNEL_HEAD_DIM")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data starts on a 16-byte boundary (the
    ``wgmma`` kernels' copies read 16 bytes at a time), else a fresh copy
    (PyTorch's allocations are aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def keep_bits_shape(batch: int, num_heads: int, seq_len: int) -> tuple:
    """The attention dropout's keep bits the ``wgmma`` forward writes and
    its backward reads: ``[B, N, T, T, 128]`` 32-bit words, T = ceil(S /
    64) (``ops/dropout_bits.py`` ``tile_keep_bits`` is their plain
    packing)."""
    t = -(-seq_len // 64)
    return (batch, num_heads, t, t, 128)


def _drop_args(seed: int, attn_rate: float, out_rate: float) -> list:
    """``seed, attn (threshold, scale, on), out (threshold, scale, on)``
    for the C entry points."""
    args = [int(seed) & dropout_bits.MASK32]
    for rate in (attn_rate, out_rate):
        on = rate > 0.0
        args += [dropout_bits.threshold(rate) if on else 0,
                 dropout_bits.keep_scale_value(rate) if on else 1.0, int(on)]
    return args


def _ptr_array(tensors: dict, order) -> ctypes.Array:
    return (ctypes.c_void_p * len(order))(
        *[tensors[k].data_ptr() if tensors.get(k) is not None else None
          for k in order])


def kernel_keep_scale(seed: int, batch: int, site0: int, n_sites: int,
                      rows: int, cols: int, rate: float,
                      device) -> torch.Tensor:
    """The keep scales the CUDA kernels draw for sites ``site0 ..
    site0 + n_sites - 1``, ``[batch, n_sites, rows, cols]``, written by the
    kernels' own hash: a check holds them against
    ``dropout_bits.keep_scale`` (no kernel of the layer calls this)."""
    lib = _kernel_lib()
    out = torch.empty((batch, n_sites, rows, cols), dtype=torch.float32,
                      device=device)
    err = lib.b4r_dropout_keep_scale(
        out.data_ptr(), int(seed) & dropout_bits.MASK32,
        dropout_bits.threshold(rate), dropout_bits.keep_scale_value(rate),
        batch, site0, n_sites, rows, cols,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"keep-scale kernel launch failed: CUDA error "
                           f"{err}")
    return out


def _check_rel(rel, b, n, s, device):
    """The relative bias the kernels read: fp32 ``[B, N, S, S]``,
    contiguous, on the layer's device."""
    if rel.shape != (b, n, s, s) or rel.dtype != torch.float32 \
            or rel.device != device or not rel.is_contiguous():
        raise ValueError(f"rel_bias must be a contiguous float32 [{b}, {n}, "
                         f"{s}, {s}] tensor on {device}, got {rel.dtype} "
                         f"{tuple(rel.shape)} on {rel.device}")


def _launch_forward_tf32(flat: dict, x: torch.Tensor,
                         input_mask: torch.Tensor, num_heads: int, seed: int,
                         attn_rate: float, out_rate: float, save: bool,
                         causal: bool, rel):
    """K1 in fp32 on the 3xTF32 kernels of ``csrc/layer_tf32.cu``; returns
    ``(y, saved)`` as ``_launch_forward``. The launch writes the weights'
    transposed TF32 hi and lo parts into its own workspace."""
    lib = _kernel_lib_tf32()
    b, s, h = x.shape
    f = flat["w1"].shape[1]
    m, dev = b * s, x.device
    ops = {k: _aligned16(flat[k].contiguous()) if k not in _MATRICES
           else flat[k].float().contiguous() for k in _W_ORDER}
    f32 = dict(dtype=torch.float32, device=dev)
    ws = lib.b4r_fused_layer_tf32_workspace_bytes(h, f)
    ops.update(x=_aligned16(x.contiguous()), mask=input_mask.contiguous(),
               wt=torch.empty((ws,), dtype=torch.uint8, device=dev), rel=rel,
               qkv=torch.empty((m, 3 * h), **f32),
               ctx=torch.empty((m, h), **f32), x1=torch.empty((m, h), **f32),
               hact=torch.empty((m, f), **f32), y=torch.empty((b, s, h), **f32))
    if save:
        ops.update(_saved_stats(b, s, h, num_heads, dev))
    err = lib.b4r_fused_layer_fwd_tf32(
        _ptr_array(ops, _TF32_PTRS), b, s, h, num_heads, f, int(causal),
        1.0 / math.sqrt(h // num_heads), *_drop_args(seed, attn_rate, out_rate),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer 3xTF32 kernel launch "
                           f"failed: CUDA error {err}")
    ops["keep_bits"] = None
    return ops["y"], (tuple(ops[k] for k in _SAVED) if save else ())


def _saved_stats(b, s, h, num_heads, dev) -> dict:
    """The fp32 statistics a training forward writes for its backward."""
    m, f32 = b * s, dict(dtype=torch.float32, device=dev)
    return dict(xhat1=torch.empty((m, h), **f32),
                rstd1=torch.empty((m,), **f32),
                xhat2=torch.empty((m, h), **f32),
                rstd2=torch.empty((m,), **f32),
                stat_m=torch.empty((b, num_heads, s), **f32),
                stat_l=torch.empty((b, num_heads, s), **f32))


def _launch_forward(flat: dict, x: torch.Tensor, input_mask: torch.Tensor,
                    num_heads: int, seed: int, attn_rate: float,
                    out_rate: float, save: bool, causal: bool = False,
                    rel=None):
    """Launch K1 (K1'' causal with ``causal``, K1'' rel_bias with ``rel``);
    returns ``(y, saved)`` where ``saved`` holds the activations and
    statistics the backward reads (empty unless ``save``)."""
    b, s, h = x.shape
    f = flat["w1"].shape[1]
    route = kernel_route(x.dtype, b, h, num_heads, f)
    if rel is not None:
        _check_rel(rel, b, num_heads, s, x.device)
    if route == "tf32":
        return _launch_forward_tf32(flat, x, input_mask, num_heads, seed,
                                    attn_rate, out_rate, save, causal, rel)
    lib = _kernel_lib()
    _check_kernel_limits(lib)
    m = b * s
    dev, dt = x.device, x.dtype
    ops = {k: (flat[k].to(dt) if k in _MATRICES else flat[k]).contiguous()
           for k in _W_ORDER}
    x = x.contiguous()
    if route == "wgmma":   # 16-byte copies and loads, vectors too
        ops = {k: _aligned16(v) for k, v in ops.items()}
        x = _aligned16(x)
    ops.update(x=x, mask=input_mask.contiguous(), rel=rel,
               qkv=torch.empty((m, 3 * h), dtype=dt, device=dev),
               ctx=torch.empty((m, h), dtype=dt, device=dev),
               x1=torch.empty((m, h), dtype=dt, device=dev),
               hact=torch.empty((m, f), dtype=dt, device=dev),
               y=torch.empty_like(x))
    if save:
        ops.update(_saved_stats(b, s, h, num_heads, dev))
        if route == "wgmma" and attn_rate > 0.0:
            ops["keep_bits"] = torch.empty(
                keep_bits_shape(b, num_heads, s), dtype=torch.int32,
                device=dev)
    ops.setdefault("keep_bits", None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = lib.b4r_fused_layer_fwd_wgmma if route == "wgmma" \
        else lib.b4r_fused_layer_fwd
    err = entry(
        _DTYPE_CODE[dt], _ptr_array(ops, _FWD_PTRS), b, s, h, num_heads, f,
        int(causal), 1.0 / math.sqrt(h // num_heads),
        *_drop_args(seed, attn_rate, out_rate), stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer kernel launch failed: CUDA "
                           f"error {err}")
    saved = tuple(ops[k] for k in _SAVED) if save else ()
    return ops["y"], saved


def _launch_backward(flat: dict, x: torch.Tensor, input_mask: torch.Tensor,
                     dy: torch.Tensor, saved: tuple, num_heads: int,
                     seed: int, attn_rate: float, out_rate: float,
                     causal: bool = False, rel=None):
    """Launch K2 (causal with ``causal``, K2 dRel with ``rel``; both must be
    the forward's); returns ``(dx, {name: fp32 grad})``, with ``"rel"``
    (dRel, ``[B, N, S, S]`` fp32) when ``rel`` is given."""
    b, s, h = x.shape
    f = flat["w1"].shape[1]
    route = kernel_route(x.dtype, b, h, num_heads, f)
    if route == "tf32":
        return _launch_backward_tf32(flat, x, input_mask, dy, saved,
                                     num_heads, seed, attn_rate, out_rate,
                                     causal, rel)
    lib = _kernel_lib()
    dev, dt = x.device, x.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    ops = dict(zip(_SAVED, saved))
    ops.setdefault("keep_bits", None)
    if route == "wgmma" and attn_rate > 0.0 and ops["keep_bits"] is None:
        raise ValueError("the wgmma backward with attention dropout reads "
                         "the forward's keep bits (saved[-1])")
    x, dy = x.contiguous(), dy.contiguous()
    if route == "wgmma":
        x, dy = _aligned16(x), _aligned16(dy)
    ops.update(
        x=x, mask=input_mask.contiguous(), dy=dy,
        wqkv_t=_aligned16(flat["wqkv"].to(dt).t().contiguous()),
        wo_t=_aligned16(flat["wo"].to(dt).t().contiguous()),
        w1=_aligned16(flat["w1"].to(dt).contiguous()),
        w1_t=_aligned16(flat["w1"].to(dt).t().contiguous()),
        w2_t=_aligned16(flat["w2"].to(dt).t().contiguous()),
        bf1=_aligned16(flat["bf1"].contiguous()),
        g1=_aligned16(flat["g1"].contiguous()),
        g2=_aligned16(flat["g2"].contiguous()),
        dx=torch.empty_like(x), dwqkv=torch.empty((h, 3 * h), **f32),
        dbqkv=torch.empty((1, 3 * h), **f32), dwo=torch.empty((h, h), **f32),
        gln1=torch.empty((3, h), **f32), dw1=torch.empty((h, f), **f32),
        dbf1=torch.empty((1, f), **f32), dw2=torch.empty((f, h), **f32),
        gln2=torch.empty((3, h), **f32))
    if rel is not None:
        _check_rel(rel, b, num_heads, s, dev)
        ops.update(rel=rel, drel=torch.empty_like(rel))
    if route == "wgmma":
        nbytes = lib.b4r_fused_layer_bwd_wgmma_workspace_bytes(
            b, s, h, num_heads, f)
        entry = lib.b4r_fused_layer_bwd_wgmma
    else:
        nbytes = lib.b4r_fused_layer_bwd_workspace_bytes(
            _DTYPE_CODE[dt], b, s, h, num_heads, f)
        entry = lib.b4r_fused_layer_bwd
    ops["workspace"] = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = entry(
        _DTYPE_CODE[dt], _ptr_array(ops, _BWD_PTRS), b, s, h, num_heads, f,
        int(causal), 1.0 / math.sqrt(h // num_heads),
        *_drop_args(seed, attn_rate, out_rate), stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer backward kernel launch "
                           f"failed: CUDA error {err}")
    gln1, gln2 = ops["gln1"], ops["gln2"]
    grads = dict(wqkv=ops["dwqkv"], bqkv=ops["dbqkv"], wo=ops["dwo"],
                 bo=gln1[2:3], g1=gln1[0:1], b1ln=gln1[1:2], w1=ops["dw1"],
                 bf1=ops["dbf1"], w2=ops["dw2"], bf2=gln2[2:3], g2=gln2[0:1],
                 b2ln=gln2[1:2])
    if rel is not None:
        grads["rel"] = ops["drel"]
    return ops["dx"], grads


def _launch_backward_tf32(flat: dict, x: torch.Tensor,
                          input_mask: torch.Tensor, dy: torch.Tensor,
                          saved: tuple, num_heads: int, seed: int,
                          attn_rate: float, out_rate: float, causal: bool,
                          rel):
    """K2 in fp32 on the 3xTF32 kernels of ``csrc/layer_tf32.cu``, from
    the 3xTF32 forward's saves; returns ``(dx, {name: fp32 grad})`` as
    ``_launch_backward``. The launch splits the weights into TF32 hi and lo
    parts in its own workspace; an operand off the kernels' 16-byte rule
    is copied first."""
    lib = _kernel_lib_tf32()
    b, s, h = x.shape
    f = flat["w1"].shape[1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    ops = {k: v for k, v in zip(_SAVED, saved) if k != "keep_bits"}
    ops.update(
        x=_aligned16(x.contiguous()), mask=input_mask.contiguous(),
        dy=_aligned16(dy.contiguous()),
        **{k: flat[k].float().contiguous() for k in _MATRICES},
        **{k: _aligned16(flat[k].contiguous()) for k in ("bf1", "g1", "g2")},
        dx=torch.empty((b, s, h), **f32), dwqkv=torch.empty((h, 3 * h), **f32),
        dbqkv=torch.empty((1, 3 * h), **f32), dwo=torch.empty((h, h), **f32),
        gln1=torch.empty((3, h), **f32), dw1=torch.empty((h, f), **f32),
        dbf1=torch.empty((1, f), **f32), dw2=torch.empty((f, h), **f32),
        gln2=torch.empty((3, h), **f32), rel=rel,
        workspace=torch.empty(
            (lib.b4r_fused_layer_bwd_tf32_workspace_bytes(b, s, h, num_heads,
                                                          f),),
            dtype=torch.uint8, device=dev))
    if rel is not None:
        _check_rel(rel, b, num_heads, s, dev)
        ops["drel"] = torch.empty_like(rel)
    err = lib.b4r_fused_layer_bwd_tf32(
        _ptr_array(ops, _TF32_BWD_PTRS), b, s, h, num_heads, f, int(causal),
        1.0 / math.sqrt(h // num_heads), *_drop_args(seed, attn_rate, out_rate),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer 3xTF32 backward kernel "
                           f"launch failed: CUDA error {err}")
    gln1, gln2 = ops["gln1"], ops["gln2"]
    grads = dict(wqkv=ops["dwqkv"], bqkv=ops["dbqkv"], wo=ops["dwo"],
                 bo=gln1[2:3], g1=gln1[0:1], b1ln=gln1[1:2], w1=ops["dw1"],
                 bf1=ops["dbf1"], w2=ops["dw2"], bf2=gln2[2:3], g2=gln2[0:1],
                 b2ln=gln2[1:2])
    if rel is not None:
        grads["rel"] = ops["drel"]
    return ops["dx"], grads


def _count(backward: bool, causal: bool, rel: bool,
           route: str = "wgmma") -> None:
    """One launch of the CUDA kernels, in the counter of its variant: the
    relative-bias launches (causal or not) apart, then the causal ones; a
    bf16 launch the shape law sends to the ``mma.sync`` kernels also in
    ``mma_sync_launches`` / ``mma_sync_backward_launches``, an fp32 one it
    sends to the 3xTF32 kernels also in ``tf32_launches`` /
    ``tf32_backward_launches``."""
    kind = "rel_" if rel else "causal_" if causal else ""
    names = [f"{kind}backward_launches" if backward else f"{kind}launches"]
    if route in ("mma_sync", "tf32"):
        names.append(f"{route}_backward_launches" if backward
                     else f"{route}_launches")
    for name in names:
        setattr(fused_encoder_layer, name,
                getattr(fused_encoder_layer, name) + 1)


def _route_of(x, flat, num_heads) -> str:
    b, _, h = x.shape
    return kernel_route(x.dtype, b, h, num_heads, flat["w1"].shape[1])


class _FusedLayer(torch.autograd.Function):
    """K1 forward and K2 backward (the JAX ``custom_vjp``): the backward
    reuses the forward's dropout masks by regenerating them from the
    seed. A CPU ``x`` runs both plain versions; a CUDA ``x`` launches both
    kernels. ``operands`` are the 12 flat weights, then the relative bias
    where there is one (differentiable: its gradient is dRel)."""

    @staticmethod
    def forward(ctx, x, input_mask, seed, num_heads, attn_rate, out_rate,
                causal, *operands):
        flat_tuple = operands[:len(_W_ORDER)]
        rel = operands[len(_W_ORDER)] if len(operands) > len(_W_ORDER) \
            else None
        flat = dict(zip(_W_ORDER, flat_tuple))
        ctx.cfg = (int(seed), num_heads, attn_rate, out_rate, causal,
                   rel is not None)
        if x.device.type == "cpu":
            y = _forward_math(flat, x, input_mask, num_heads, seed,
                              attn_rate, out_rate, causal, rel)["y"]
            saved = ()
        else:
            y, saved = _launch_forward(flat, x, input_mask, num_heads, seed,
                                       attn_rate, out_rate, True,
                                       causal=causal, rel=rel)
            _count(False, causal, rel is not None,
                   _route_of(x, flat, num_heads))
        rel_saved = () if rel is None else (rel,)
        ctx.save_for_backward(x, input_mask, *rel_saved, *flat_tuple, *saved)
        return y

    @staticmethod
    def backward(ctx, dy):
        seed, num_heads, attn_rate, out_rate, causal, has_rel = ctx.cfg
        x, input_mask, *rest = ctx.saved_tensors
        rel = rest.pop(0) if has_rel else None
        flat = dict(zip(_W_ORDER, rest[:len(_W_ORDER)]))
        if x.device.type == "cpu":
            dx, grads = fused_encoder_layer_plain_backward(
                flat, x, input_mask, dy, num_heads=num_heads,
                attention_dropout=attn_rate, output_dropout=out_rate,
                seed=seed, causal=causal, rel_bias=rel)
        else:
            dx, grads = _launch_backward(flat, x, input_mask, dy,
                                         tuple(rest[len(_W_ORDER):]),
                                         num_heads, seed, attn_rate,
                                         out_rate, causal=causal, rel=rel)
            _count(True, causal, has_rel, _route_of(x, flat, num_heads))
        dflat = tuple(grads[k].to(flat[k].dtype) for k in _W_ORDER)
        drel = (grads["rel"],) if has_rel else ()
        return (dx, None, None, None, None, None, None, *dflat, *drel)


@torch.library.custom_op("bert4rec_tpu_torch::fused_layer_forward",
                         mutates_args=())
def fused_layer_forward(x: torch.Tensor, input_mask: torch.Tensor,
                        weights: List[torch.Tensor],
                        rel_bias: Optional[torch.Tensor], num_heads: int,
                        causal: bool, seed: int, attention_dropout: float,
                        output_dropout: float) -> torch.Tensor:
    """K1 (K1'' causal, K1'' ``rel_bias``) without the saves a backward
    reads: ``weights`` are the 12 flat operands in ``_W_ORDER``; returns a
    contiguous ``y`` like ``x``. This body is the CPU implementation, the
    plain version; a CUDA ``x`` launches the kernels (below)."""
    flat = dict(zip(_W_ORDER, weights))
    return _forward_math(flat, x, input_mask, num_heads, seed,
                         attention_dropout, output_dropout, causal,
                         rel_bias)["y"].contiguous()


@fused_layer_forward.register_kernel("cuda")
def _fused_layer_forward_cuda(x, input_mask, weights, rel_bias, num_heads,
                              causal, seed, attention_dropout,
                              output_dropout):
    flat = dict(zip(_W_ORDER, weights))
    y, _ = _launch_forward(flat, x, input_mask, num_heads, seed,
                           attention_dropout, output_dropout, False,
                           causal=causal, rel=rel_bias)
    _count(False, causal, rel_bias is not None,
           _route_of(x, flat, num_heads))
    return y.contiguous()


@fused_layer_forward.register_fake
def _fused_layer_forward_fake(x, input_mask, weights, rel_bias, num_heads,
                              causal, seed, attention_dropout,
                              output_dropout):
    return x.new_empty(x.shape)


def fused_encoder_layer(params: dict, x: torch.Tensor,
                        input_mask: torch.Tensor, *,
                        num_heads: int,
                        attention_dropout: float = 0.0,
                        output_dropout: float = 0.0,
                        seed=None,
                        causal: bool = False,
                        rel_bias=None) -> torch.Tensor:
    """Run one post-LN encoder layer: ``x [B, S, H]`` (float32 or
    bfloat16), ``input_mask [B, S]`` int32, ``params`` the JAX-layout
    layer dict; ``seed`` (an int, default 0) selects the dropout masks;
    ``causal`` lets position i attend to keys j <= i only (SASRec);
    ``rel_bias`` (``[B, num_heads, S, S]``, cast to fp32) is added to the
    attention scores (the temporal family's relative-time bias, JAX's
    ``rel_bias``). Returns ``y`` like ``x``; differentiable in ``x``, the
    params and ``rel_bias``.

    A CUDA ``x`` launches the kernels and counts each forward launch in
    ``fused_encoder_layer.launches`` (``causal_launches`` for the causal
    variant, ``rel_launches`` for the relative-bias one) and each backward
    launch in ``backward_launches`` (``causal_backward_launches``,
    ``rel_backward_launches``); a bf16 launch the shape law
    (``kernel_route``) sends to the ``mma.sync`` kernels also counts in
    ``mma_sync_launches`` / ``mma_sync_backward_launches``, and an fp32
    launch it sends to the 3xTF32 kernels in ``tf32_launches`` /
    ``tf32_backward_launches``. A CPU ``x`` runs the plain versions.
    """
    flat = flat_weights(params)
    _check_operands(x, input_mask, flat, num_heads)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused layer for device {x.device}")
    operands = tuple(flat[k] for k in _W_ORDER)
    if rel_bias is not None:
        rel_bias = rel_bias.to(torch.float32).contiguous()
        b, s, _ = x.shape
        _check_rel(rel_bias, b, num_heads, s, x.device)
    train = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, rel_bias, *operands))
    seed = 0 if seed is None else int(seed)
    if not train:
        return fused_layer_forward(x, input_mask, list(operands), rel_bias,
                                   num_heads, bool(causal), seed,
                                   float(attention_dropout),
                                   float(output_dropout))
    rel = () if rel_bias is None else (rel_bias,)
    return _FusedLayer.apply(x, input_mask, seed,
                             num_heads, float(attention_dropout),
                             float(output_dropout), bool(causal),
                             *operands, *rel)


fused_encoder_layer.launches = 0
fused_encoder_layer.backward_launches = 0
fused_encoder_layer.causal_launches = 0
fused_encoder_layer.causal_backward_launches = 0
fused_encoder_layer.rel_launches = 0
fused_encoder_layer.rel_backward_launches = 0
fused_encoder_layer.mma_sync_launches = 0
fused_encoder_layer.mma_sync_backward_launches = 0
fused_encoder_layer.tf32_launches = 0
fused_encoder_layer.tf32_backward_launches = 0
