"""Fused post-LN transformer encoder layer, forward (port of
``bert4rec_tpu/ops/fused_encoder_layer.py``).

Replaces the TPU kernel ``bert4rec_tpu/ops/fused_encoder_layer.py:_fwd_kernel``
(``_run_forward`` -> ``pl.pallas_call``) with the hand-written Hopper CUDA
kernels of ``csrc/fused_encoder_layer.cu``: a tiled GEMM with a bias (or
bias + tanh-gelu) epilogue for the qkv and W1 projections, a two-pass
masked attention kernel per (query tile, head, sequence), and a GEMM whose
block owns whole rows so bias, residual and LayerNorm run in its epilogue
(Wo -> LN1, W2 -> LN2). The TPU kernel kept one layer and one sequence in
~14 MB of VMEM per grid cell; an H100 block has at most 227 KB of shared
memory, hence the split.

Bound: about 2·S·H·3H + 4·S²·H + 2·S·H² + 4·S·H·F FLOP per sequence
(99 MFLOP at S=200, H=128, F=512) against a few MB of activations: the
layer is bound by operations. The first kernels are plain fp32 SIMT loops
(no tensor cores); their times are in PERF.md.

What it computes is ``_layer_fwd_math`` with all rates 0: tanh-approximate
gelu (whatever ``inner_activation`` says — the JAX kernel does the same),
fp32 softmax/LayerNorm statistics, matmuls on operands in the input dtype
with fp32 sums, and rounding to the input dtype at qkv, p, ctx, x1, the
gelu output and y. Dropout, the causal mask and the relative-time bias are
not ported yet and raise.

Routing: a CPU tensor runs :func:`fused_encoder_layer_plain`; a CUDA
tensor launches the kernels or raises.
"""

import ctypes
import math

import torch

NEG_INF = -1e9
LN_EPS = 1e-12
MAX_FUSED_SEQ_LEN = 512
VMEM_BUDGET_BYTES = 14 * 1024 * 1024
_SITES_PER_CELL = 64
_LOG2E = math.log2(math.e)
_GELU_C = math.sqrt(2.0 / math.pi)

_W_ORDER = ("wqkv", "bqkv", "wo", "bo", "g1", "b1ln", "w1", "bf1",
            "w2", "bf2", "g2", "b2ln")
_MATRICES = ("wqkv", "wo", "w1", "w2")  # cast to the input dtype
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    ``[H,H]``; vectors -> ``[1, n]``)."""
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

def _ln(w: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mean = w.mean(dim=-1, keepdim=True)
    var = (w - mean).square().mean(dim=-1, keepdim=True)
    return (w - mean) * torch.rsqrt(var + LN_EPS) * g + b


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    inner = _GELU_C * (x + 0.044715 * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(inner))


def fused_encoder_layer_plain(params: dict, x: torch.Tensor,
                              input_mask: torch.Tensor, *,
                              num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the fused layer (``_layer_fwd_math`` at
    rates 0, whole batch at once). Matmul operands in the input dtype are
    widened to fp32, so a bf16 product is exact and sums are fp32, as on
    the TPU."""
    flat = flat_weights(params)
    dtype, f32 = x.dtype, torch.float32
    b, s, h = x.shape
    d = h // num_heads
    w = {k: flat[k].to(dtype).to(f32) for k in _MATRICES}
    scale = 1.0 / math.sqrt(d)

    qkv = (x.to(f32) @ w["wqkv"] + flat["bqkv"]).to(dtype).to(f32)
    q, k, v = (t.reshape(b, s, num_heads, d).transpose(1, 2)
               for t in qkv.split(h, dim=-1))                  # [B,N,S,D]
    bias = torch.where(input_mask > 0, 0.0, NEG_INF).to(f32)[:, None, None]
    scores = q @ k.transpose(-1, -2) * scale + bias
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp2((scores - m) * _LOG2E)
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    ctx = p.to(dtype).to(f32) @ v                              # [B,N,S,D]
    ctx = ctx.transpose(1, 2).reshape(b, s, h).to(dtype).to(f32)

    u = x.to(f32) + (ctx @ w["wo"] + flat["bo"])
    x1 = _ln(u, flat["g1"], flat["b1ln"]).to(dtype).to(f32)
    hact = _gelu_tanh(x1 @ w["w1"] + flat["bf1"]).to(dtype).to(f32)
    f = hact @ w["w2"] + flat["bf2"]
    return _ln(x1 + f, flat["g2"], flat["b2ln"]).to(dtype)


# --------------------------------------------------------------------------- #
# the kernel
# --------------------------------------------------------------------------- #

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from bert4rec_tpu_torch.ops import kernel_build
        lib = kernel_build.load("fused_encoder_layer")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.b4r_fused_layer_fwd.restype = ci
        lib.b4r_fused_layer_fwd.argtypes = (
            [ci] + [vp] * 19 + [ci] * 5 + [ctypes.c_float, vp])
        lib.b4r_fused_layer_max_hidden.restype = ci
        lib.b4r_fused_layer_max_hidden.argtypes = []
        lib.b4r_fused_layer_max_head_dim.restype = ci
        lib.b4r_fused_layer_max_head_dim.argtypes = []
        _lib = lib
    return _lib


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


def _launch(flat: dict, x: torch.Tensor, input_mask: torch.Tensor,
            num_heads: int) -> torch.Tensor:
    lib = _kernel_lib()
    b, s, h = x.shape
    f = flat["w1"].shape[1]
    if h > lib.b4r_fused_layer_max_hidden() \
            or h // num_heads > lib.b4r_fused_layer_max_head_dim() \
            or b > 65535:
        raise ValueError(
            f"fused layer kernel takes hidden <= "
            f"{lib.b4r_fused_layer_max_hidden()}, head dim <= "
            f"{lib.b4r_fused_layer_max_head_dim()} and batch <= 65535; "
            f"got hidden {h}, {num_heads} heads, batch {b}")
    ops = {k: (flat[k].to(x.dtype) if k in _MATRICES else flat[k])
           .contiguous() for k in _W_ORDER}
    x = x.contiguous()
    mask = input_mask.contiguous()
    m = b * s
    qkv = torch.empty((m, 3 * h), dtype=x.dtype, device=x.device)
    ctx = torch.empty((m, h), dtype=x.dtype, device=x.device)
    x1 = torch.empty((m, h), dtype=x.dtype, device=x.device)
    hact = torch.empty((m, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.b4r_fused_layer_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), mask.data_ptr(),
        *[ops[k].data_ptr() for k in _W_ORDER],
        qkv.data_ptr(), ctx.data_ptr(), x1.data_ptr(), hact.data_ptr(),
        y.data_ptr(), b, s, h, num_heads, f, 1.0 / math.sqrt(h // num_heads),
        stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer kernel launch failed: CUDA "
                           f"error {err}")
    return y


def fused_encoder_layer(params: dict, x: torch.Tensor,
                        input_mask: torch.Tensor, *,
                        num_heads: int,
                        attention_dropout: float = 0.0,
                        output_dropout: float = 0.0,
                        causal: bool = False,
                        rel_bias=None) -> torch.Tensor:
    """Run one post-LN encoder layer: ``x [B, S, H]`` (float32 or
    bfloat16), ``input_mask [B, S]`` int32, ``params`` the JAX-layout
    layer dict. Returns ``y`` like ``x``.

    A CUDA ``x`` launches the kernels (and counts one launch in
    ``fused_encoder_layer.launches``); a CPU ``x`` runs the plain version.
    """
    if causal:
        raise NotImplementedError("causal fused layer is not ported yet")
    if rel_bias is not None:
        raise NotImplementedError("rel_bias fused layer is not ported yet")
    if attention_dropout > 0.0 or output_dropout > 0.0:
        raise NotImplementedError("fused layer dropout is not ported yet")
    flat = flat_weights(params)
    _check_operands(x, input_mask, flat, num_heads)
    if x.device.type == "cpu":
        return fused_encoder_layer_plain(params, x, input_mask,
                                         num_heads=num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"no fused layer for device {x.device}")
    y = _launch(flat, x, input_mask, num_heads)
    fused_encoder_layer.launches += 1
    return y


fused_encoder_layer.launches = 0
