"""Masked multi-head attention, forward and backward (port of
``bert4rec_tpu/ops/flash_attention.py``).

Replaces the TPU kernels ``_fwd_kernel`` (K8, launched by ``_forward``)
and ``_bwd_kernel`` (K9, launched by ``_backward`` through the custom
backward ``_flash_bwd``) of ``bert4rec_tpu/ops/flash_attention.py`` with
the hand-written Hopper CUDA kernels of ``csrc/flash_attention.cu``. The
TPU kernel holds whole [S, S] score matrices of a head group in VMEM; an
H100 block has at most 227 KB of shared memory, so the kernels stream
64-row tiles and recompute the scores (the backward reads the forward's
row max and sum).

Bound at the main path's shape (B=32, N=12, S=512, D=64, bf16): K8 moves
100.7 MB for 25.8 GFLOP, K9 176 MB for 51.5 GFLOP; both are bound by bytes
at the card's peaks (~0.030 and ~0.053 ms). In fp32 the same work is bound
by operations: 0.156 and 0.312 ms at 3xTF32's 165 TFLOP/s. Their times are
in PERF.md.

Design, by operand type (an explicit dispatch, not a fallback):

- bf16 (the main path): ``csrc/flash_hopper.cuh``. One warpgroup per
  64-row tile; tiles are copied as bf16 by ``cp.async`` into the 128-byte
  swizzle ``wgmma`` reads, the next tile in flight while the products run;
  every product is a ``wgmma`` with the scores in registers, and the
  rounded probabilities (or ds) are the next product's register operand.
  K9 is a dq kernel per query tile and a dk/dv kernel per key tile
  (``S^T = K Q^T``, so keys are the rows of its products).
- fp32 with a head dim that is a multiple of 8 up to 64 (``flash_route``
  ``"tf32"``: every config the repo ships): ``csrc/flash_tf32.cuh``'s
  3xTF32 ``wgmma`` kernels. K8 is one online-softmax pass, 128 queries a
  block, the query rows' split fragments in registers and each key tile
  split once for both warpgroups; K9 is a dq kernel and a dk/dv kernel.
  The dq kernel forms ds with ``delta0 = dO . o`` (flash attention's form,
  known before its one pass) while it sums JAX's ``sum_j dp_ij p_ij``
  beside, and corrects dq by their difference at the end; the dk/dv
  kernel reads JAX's sum. The backward reads the forward's output, saved
  with its row statistics.
- any other fp32 head dim (``"simt"``): ``csrc/attention.cuh``'s SIMT
  tiles, the fused encoder layer's off-rule ones.

A forward and its backward take one route, decided from the dtype and head
dim alone before any launch. fp32 launches count in ``tf32_launches`` /
``tf32_backward_launches`` or ``simt_launches`` /
``simt_backward_launches`` besides the counters below.

Layout rule (``check_copy_alignment``): a bf16 q, k, v or dO has a
16-byte aligned base and batch, head and sequence strides (dims of size 1
aside), as the 16-byte copies read rows; anything else raises before a
launch. The main path's views of one ``[B, S, 3, N, D]`` projection meet
it (sequence stride 3 N D elements). The 3xTF32 kernels read by the same
16-byte copies; an fp32 view that breaks the rule is copied to a
contiguous buffer first (``_tf32_operand``).

What it computes is the TPU kernel's: scores ``q k^T / sqrt(D)`` in fp32
plus the pad bias (``mask > 0 ? 0 : -1e9``) and, with ``causal``, a second
-1e9 after the diagonal; an fp32 softmax normalised as ``p * (1 / sum)``;
the dropout scale on p, then p rounded to v's type before ``p v`` (fp32
sums); the backward's ``dv = T(p keep)^T T(dO)``, ``dp = dO v^T keep``,
``ds = T(p (dp - rowsum(dp p)))``, ``dq = ds k / sqrt(D)``,
``dk = ds^T q / sqrt(D)``. Dropout masks come from the counter hash of
``ops/dropout_bits.py`` (site = head, counter = row * S + col), not from
the TPU's ``pltpu`` bits, which no other device reproduces: the kernels and
the plain versions draw equal masks from equal seeds.

Value width: v (and so o, dO and dv) may be narrower than q and k, as in
latent attention, where scores contract over ``DK`` = 192 (128 dims
without and 64 with rotary positions) and values are ``DV`` = 128 wide.
The plain versions take any pair; bf16 CUDA tensors launch it for the
pairs of ``WIDE_PAIRS`` (``flash_hopper.cuh`` instantiated at ``DP`` =
DK, ``DV``), and fp32 CUDA tensors raise for it. The scale is
``1 / sqrt(DK)``.

Layout: q, k, v ``[B, N, S, D]`` (any batch, head and sequence strides,
the last axis contiguous: the transposes of a ``[B, S, N, D]`` projection
are taken without a copy; bf16 within the rule above), ``mask [B, S]``
(1 = real key).

A forward that saves nothing for K9 (inference) is the registered operator
``torch.ops.bert4rec_tpu_torch.flash_attention_forward``
(``flash_attention_forward``), so ``torch.export`` keeps K8 in an exported
program as one call: its CUDA implementation launches K8, its CPU one is
the plain version.

Routing: a CUDA tensor launches K8/K9 at every sequence length up to
``MAX_KERNEL_SEQ_LEN`` and raises beyond it. A CPU tensor runs the plain
versions: through ``mha_reference`` and autograd when the sequence is
longer than ``MAX_FUSED_SEQ_LEN``, as the JAX package runs its
``mha_reference`` there (its shape law, kept on the CPU for parity), and
through the custom backward otherwise.
"""

import ctypes
import math

import torch

from bert4rec_tpu_torch.ops import dropout_bits
from bert4rec_tpu_torch.ops.fused_encoder_layer import (
    _work_dtype, causal_bias,
)

NEG_INF = -1e9
# The JAX package's shape law (flash_attention.py:32, :293-299): beyond
# this sequence length it runs mha_reference instead of its kernel. It is
# JAX's VMEM rule, not a limit of the Hopper kernels, which stream key
# tiles: the port keeps it for CPU tensors only.
MAX_FUSED_SEQ_LEN = 1024
# The kernels' limit: they form the dropout counter row * S + col as a
# signed 32-bit int (S^2 < 2^31).
MAX_KERNEL_SEQ_LEN = 46340
# The 3xTF32 kernels' head dims: multiples of 8 up to this (csrc/
# flash_tf32.cuh kMaxHeadDim; the library's value is checked at load).
TF32_MAX_HEAD_DIM = 64
# (query-key width, value width) pairs the bf16 kernels take with values
# narrower than queries (csrc/flash_attention.cu forward_bf16): latent
# attention's 128 + 64 rotary dims against 128-wide values
WIDE_PAIRS = ((192, 128),)
_LOG2E = math.log2(math.e)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_keep(seed: int, batch: int, num_heads: int, seq_len: int,
                   rate: float, device, dtype=torch.float32):
    """The keep scales K8/K9 draw, ``[B, N, S, S]`` (``None`` at rate 0):
    site ``h`` per head, counter ``row * S + col``."""
    if rate <= 0.0:
        return None
    return dropout_bits.keep_scale(seed, batch, range(num_heads), seq_len,
                                   seq_len, rate, device, dtype)


def flash_route(dtype, head_dim: int) -> str:
    """Which CUDA kernels run flash attention at this dtype and head dim
    (decided before any launch, from these alone, so that a forward and its
    backward take one route and the backward reads statistics of its own
    route's scores): ``"wgmma"`` (bf16, ``csrc/flash_hopper.cuh``),
    ``"tf32"`` (fp32 with a head dim that is a multiple of 8 up to
    ``TF32_MAX_HEAD_DIM``: the 3xTF32 kernels of ``csrc/flash_tf32.cuh``)
    or ``"simt"`` (any other fp32 head dim: ``csrc/attention.cuh``'s SIMT
    tiles). Raises ValueError for another dtype."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype != torch.float32:
        raise ValueError(f"no flash attention kernel for {dtype}")
    if head_dim % 8 == 0 and 0 < head_dim <= TF32_MAX_HEAD_DIM:
        return "tf32"
    return "simt"


def _probs(q, k, mask, causal):
    """fp32 ``softmax(q k^T / sqrt(D) + pad bias [+ causal bias])`` as the
    kernels form it: exp2 of the shifted scores times ``1 / sum``."""
    f32 = _work_dtype(q.dtype)
    s = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    bias = torch.where(mask > 0, 0.0, NEG_INF).to(f32)[:, None, None, :]
    if causal:
        bias = bias + causal_bias(s, q.device, f32)
    scores = q.to(f32) @ k.to(f32).transpose(-1, -2) * scale + bias
    e = torch.exp2((scores - scores.amax(dim=-1, keepdim=True)) * _LOG2E)
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, dropout_rate: float = 0.0,
                  seed=None, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K8 (JAX's ``mha_reference`` with the
    kernel's rounding points and the port's dropout masks; no dropout
    without a ``seed``). Differentiable by autograd."""
    b, n, s, _ = q.shape
    f32 = _work_dtype(q.dtype)
    p = _probs(q, k, mask, causal)
    keep = attention_keep(seed or 0, b, n, s,
                          dropout_rate if seed is not None else 0.0,
                          q.device, f32)
    if keep is not None:
        p = p * keep
    return (p.to(v.dtype).to(f32) @ v.to(f32)).to(q.dtype)


def flash_attention_plain_backward(q, k, v, mask, do, *,
                                   dropout_rate: float = 0.0, seed: int = 0,
                                   causal: bool = False):
    """Plain PyTorch version of K9 (``_bwd_kernel``, every head at once):
    recomputes p and the same mask; returns ``(dq, dk, dv)`` in the inputs'
    dtype."""
    dtype = q.dtype
    f32 = _work_dtype(dtype)
    b, n, s, d = q.shape
    scale = 1.0 / math.sqrt(d)

    def t(a):  # round to the input dtype, as JAX's ``.astype(v.dtype)``
        return a.to(dtype).to(f32)

    p = _probs(q, k, mask, causal)
    keep = attention_keep(seed, b, n, s, dropout_rate, q.device, f32)
    d_mat = p if keep is None else p * keep
    do32 = t(do)
    dv = t(d_mat).transpose(-1, -2) @ do32
    dd = do32 @ v.to(f32).transpose(-1, -2)
    dp = dd if keep is None else dd * keep
    ds = t(p * (dp - (dp * p).sum(dim=-1, keepdim=True)))
    dq = (ds @ k.to(f32)) * scale
    dk = (ds.transpose(-1, -2) @ q.to(f32)) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

_lib = None
# device-pointer order of the C entry points (FwdPtr / BwdPtr in the source)
_FWD_PTRS = ("q", "k", "v", "mask", "o", "stat_m", "stat_l", "keep_bits")
_BWD_PTRS = ("q", "k", "v", "do", "o", "mask", "stat_m", "stat_l", "delta",
             "dq", "dk", "dv", "keep_bits")
_FWD_VIEWS = ("q", "k", "v", "o")
_BWD_VIEWS = ("q", "k", "v", "do", "o", "dq", "dk", "dv")


def _kernel_lib():
    global _lib
    if _lib is None:
        from bert4rec_tpu_torch.ops import kernel_build
        lib = kernel_build.load("flash_attention")
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        # dtype, ptrs, strides, B, N, S, D, DV, causal, scale, seed,
        # threshold, keep scale, on, stream
        args = [ci, vp, vp] + [ci] * 6 + [cf, cu, cu, cf, ci, vp]
        for fn in (lib.b4r_flash_fwd, lib.b4r_flash_bwd):
            fn.restype = ci
            fn.argtypes = args
        for fn in (lib.b4r_flash_max_head_dim, lib.b4r_flash_tf32_max_head_dim):
            fn.restype = ci
            fn.argtypes = []
        if lib.b4r_flash_tf32_max_head_dim() != TF32_MAX_HEAD_DIM:
            raise RuntimeError("the kernel library's 3xTF32 head dims differ "
                               "from TF32_MAX_HEAD_DIM")
        _lib = lib
    return _lib


def head_strides(t: torch.Tensor) -> tuple:
    """The (batch, head, sequence) element strides of a ``[B, N, S, D]``
    operand the kernels take: any of those, with the head-dim axis
    contiguous and one head's span under 2^31 elements (the kernels index
    inside a head in 32 bits); raises on any other layout."""
    if t.dim() != 4 or (t.stride(3) != 1 and t.shape[3] > 1):
        raise ValueError(f"flash attention kernels take [B, N, S, D] "
                         f"operands with a contiguous last axis; got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    if (t.shape[2] - 1) * t.stride(2) + t.shape[3] >= 2 ** 31:
        raise ValueError(f"flash attention kernels index one head in 32 "
                         f"bits; sequence stride {t.stride(2)} spans too "
                         f"far for S={t.shape[2]}")
    # an axis of size 1 is never stepped: its stride is passed as 0
    return tuple(t.stride(i) if t.shape[i] > 1 else 0 for i in range(3))


def _misaligned(t: torch.Tensor) -> list:
    """What keeps ``t`` from the bf16 kernels' 16-byte copies (empty if
    nothing): its base, or a batch, head or sequence stride (axes of size 1
    aside), that is not a multiple of 16 bytes."""
    es = t.element_size()
    bad = [f"base address {t.data_ptr()} is {t.data_ptr() % 16} bytes "
           f"past a multiple of 16"] if t.data_ptr() % 16 else []
    return bad + [
        f"{axis} stride {t.stride(i)} elements is {t.stride(i) * es} bytes"
        for i, axis in enumerate(("batch", "head", "sequence"))
        if t.shape[i] > 1 and (t.stride(i) * es) % 16]


def check_copy_alignment(t: torch.Tensor, name: str) -> None:
    """The bf16 kernels read operand rows in 16-byte copies: raises unless
    ``t``'s base and its batch, head and sequence strides (axes of size 1
    aside) are multiples of 16 bytes."""
    bad = _misaligned(t)
    if bad:
        raise ValueError(f"the bf16 flash attention kernels take operands "
                         f"with a 16-byte aligned base and batch, head and "
                         f"sequence strides; {name} of shape "
                         f"{tuple(t.shape)}: " + "; ".join(bad))


def _tf32_operand(t: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 kernels copy operand rows in 16-byte pieces: ``t``
    itself if it meets that rule (``_misaligned`` finds nothing), else a
    contiguous copy (PyTorch's allocations are aligned, and a contiguous
    ``[B, N, S, D]`` with D a multiple of 8 has aligned strides)."""
    return t.clone(memory_format=torch.contiguous_format) if _misaligned(t) \
        else t


def _empty_heads(like: torch.Tensor, d=None) -> torch.Tensor:
    """An uninitialised ``[B, N, S, D]`` tensor laid out as ``like``'s axes
    run: ``[B, S, N, D]`` in memory when ``like`` steps heads faster than
    positions (a projection's transposed view: its grad then reshapes to
    ``[B, S, H]`` without a copy), else contiguous. ``d`` (default
    ``like``'s) is its last axis: the output of narrower values."""
    b, n, s, dl = like.shape
    d = dl if d is None else d
    kw = dict(dtype=like.dtype, device=like.device)
    if like.stride(1) < like.stride(2):
        return torch.empty((b, s, n, d), **kw).transpose(1, 2)
    return torch.empty((b, n, s, d), **kw)


def _drop_args(seed: int, rate: float) -> list:
    on = rate > 0.0
    return [int(seed) & dropout_bits.MASK32,
            dropout_bits.threshold(rate) if on else 0,
            dropout_bits.keep_scale_value(rate) if on else 1.0, int(on)]


def _launch(fn, ops: dict, order, views, q, seed, rate, causal, what):
    b, n, s, d = q.shape
    dv = ops["v"].shape[-1]
    lib = _kernel_lib()
    wide = (d, dv) in WIDE_PAIRS and q.dtype == torch.bfloat16
    if (d > lib.b4r_flash_max_head_dim() and not wide) or b > 65535 \
            or n > 65535:
        raise ValueError(f"flash attention kernels take head dim <= "
                         f"{lib.b4r_flash_max_head_dim()} and B, N <= 65535;"
                         f" got {tuple(q.shape)}")
    ptrs = (ctypes.c_void_p * len(order))(
        *[ops[k].data_ptr() if ops.get(k) is not None else None
          for k in order])
    strides = (ctypes.c_longlong * (3 * len(views)))(
        *[x for name in views
          for x in (head_strides(ops[name]) if ops.get(name) is not None
                    else (0, 0, 0))])
    err = fn(_DTYPE_CODE[q.dtype], ptrs, strides, b, n, s, d, dv,
             int(causal), 1.0 / math.sqrt(d), *_drop_args(seed, rate),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"CUDA error {err}")


def _launch_forward(q, k, v, mask, seed: int, rate: float, causal: bool,
                    save: bool):
    """Launch K8; returns ``(o, saved)``, ``saved`` what K9 reads (empty
    unless ``save``): the fp32 row max and sum ``[B, N, S]`` and, for bf16
    with dropout, the keep bits (``dropout_bits.tile_keep_bits``' layout;
    the tile pairs a causal block skips are left unwritten), or, on the
    3xTF32 route, ``o`` itself (its backward reads ``dO . o``)."""
    b, n, s, d = q.shape
    route = flash_route(q.dtype, d)
    if route == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_copy_alignment(t, name)
    elif route == "tf32":
        q, k, v = (_tf32_operand(t) for t in (q, k, v))
    ops = dict(q=q, k=k, v=v, mask=mask, o=_empty_heads(q, v.shape[-1]))
    if save:
        ops.update(stat_m=torch.empty((b, n, s), dtype=torch.float32,
                                      device=q.device),
                   stat_l=torch.empty((b, n, s), dtype=torch.float32,
                                      device=q.device))
        if q.dtype == torch.bfloat16 and rate > 0.0:
            t = dropout_bits.tiles(s)
            ops["keep_bits"] = torch.empty(
                (b, n, t, t, dropout_bits.TILE_WORDS), dtype=torch.int32,
                device=q.device)
    _launch(_kernel_lib().b4r_flash_fwd, ops, _FWD_PTRS, _FWD_VIEWS, q, seed,
            rate, causal, "forward")
    if save and route == "tf32":
        ops["saved_o"] = ops["o"]
    return ops["o"], tuple(ops[name] for name in ("stat_m", "stat_l",
                                                  "keep_bits", "saved_o")
                           if name in ops)


def _launch_backward(q, k, v, mask, do, saved: tuple, seed: int,
                     rate: float, causal: bool):
    """Launch K9 (causal and the rate must be the forward's: ``saved`` is
    its row statistics and keep bits, or its output on the 3xTF32 route);
    returns ``(dq, dk, dv)``."""
    b, n, s, d = q.shape
    route = flash_route(q.dtype, d)
    if do.stride(-1) != 1 or (route == "wgmma" and _misaligned(do)):
        do = do.contiguous()   # dO is autograd's gradient, not a layout
    o = keep_bits = None
    if route == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            check_copy_alignment(t, name)
        if rate > 0.0 and len(saved) < 3:
            raise ValueError("the bf16 backward kernels read the forward's "
                             "keep bits: save them (save=True, rate > 0)")
        keep_bits = saved[2] if len(saved) > 2 else None
    elif route == "tf32":
        if len(saved) < 3:
            raise ValueError("the 3xTF32 backward kernels read the forward's "
                             "output: save it (save=True)")
        q, k, v, do, o = (_tf32_operand(t) for t in (q, k, v, do, saved[2]))
    ops = dict(q=q, k=k, v=v, do=do, o=o, mask=mask, stat_m=saved[0],
               stat_l=saved[1], keep_bits=keep_bits,
               dq=_empty_heads(q), dk=_empty_heads(k),
               dv=_empty_heads(v),
               delta=torch.empty((b, n, s), dtype=torch.float32,
                                 device=q.device))
    _launch(_kernel_lib().b4r_flash_bwd, ops, _BWD_PTRS, _BWD_VIEWS, q, seed,
            rate, causal, "backward")
    return ops["dq"], ops["dk"], ops["dv"]


def _count(backward: bool, causal: bool, route: str) -> None:
    """One launch of the CUDA kernels: in ``causal_[backward_]launches`` or
    ``[backward_]launches``, and an fp32 one also in its route's
    ``tf32_[backward_]launches`` or ``simt_[backward_]launches``."""
    part = "backward_launches" if backward else "launches"
    names = [f"causal_{part}" if causal else part]
    if route in ("tf32", "simt"):
        names.append(f"{route}_{part}")
    for name in names:
        setattr(flash_attention, name, getattr(flash_attention, name) + 1)


class _FlashAttention(torch.autograd.Function):
    """K8 forward and K9 backward (the JAX ``custom_vjp``): the backward
    regenerates the forward's dropout mask from the seed. CPU operands run
    both plain versions; CUDA operands launch both kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, rate, causal):
        ctx.cfg = (seed, rate, causal)
        if q.device.type == "cpu":
            o = mha_reference(q, k, v, mask, rate, seed, causal)
            saved = ()
        else:
            o, saved = _launch_forward(q, k, v, mask, seed, rate, causal,
                                       True)
            _count(False, causal, flash_route(q.dtype, q.shape[-1]))
        ctx.save_for_backward(q, k, v, mask, *saved)
        return o

    @staticmethod
    def backward(ctx, do):
        seed, rate, causal = ctx.cfg
        q, k, v, mask, *saved = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_plain_backward(
                q, k, v, mask, do, dropout_rate=rate, seed=seed,
                causal=causal)
        else:
            dq, dk, dv = _launch_backward(q, k, v, mask, do, tuple(saved),
                                          seed, rate, causal)
            _count(True, causal, flash_route(q.dtype, q.shape[-1]))
        return dq, dk, dv, None, None, None, None


@torch.library.custom_op("bert4rec_tpu_torch::flash_attention_forward",
                         mutates_args=())
def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: torch.Tensor, seed: int,
                            rate: float, causal: bool) -> torch.Tensor:
    """K8 without the saves K9 reads (inference), laid out as
    ``_empty_heads(q)``. This body is the CPU implementation, the plain
    version; CUDA operands launch the kernels (below)."""
    o = _empty_heads(q, v.shape[-1])
    o.copy_(mha_reference(q, k, v, mask, rate, seed, causal))
    return o


@flash_attention_forward.register_kernel("cuda")
def _flash_attention_forward_cuda(q, k, v, mask, seed, rate, causal):
    o, _ = _launch_forward(q, k, v, mask, seed, rate, causal, False)
    _count(False, causal, flash_route(q.dtype, q.shape[-1]))
    want = _empty_heads(q, v.shape[-1])
    if o.stride() != want.stride():   # an operand the launch copied
        o = want.copy_(o)
    return o


@flash_attention_forward.register_fake
def _flash_attention_forward_fake(q, k, v, mask, seed, rate, causal):
    return _empty_heads(q, v.shape[-1])


def _check_operands(q, k, v, mask):
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q and k must be one [B, N, S, D] shape and v "
                         f"[B, N, S, DV], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    wide = v.shape[-1] != q.shape[-1]
    if wide and q.device.type == "cuda" and (
            q.dtype != torch.bfloat16
            or (q.shape[-1], v.shape[-1]) not in WIDE_PAIRS):
        raise ValueError(f"the kernels take values narrower than queries "
                         f"in bf16 at (DK, DV) in {WIDE_PAIRS}; got "
                         f"{q.dtype} at ({q.shape[-1]}, {v.shape[-1]})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, _, s, _ = q.shape
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"mask must be [{b}, {s}], got {tuple(mask.shape)}")
    if not all(t.device == q.device for t in (k, v, mask)):
        raise ValueError("q, k, v and mask must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")
    if q.device.type == "cuda" and q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernels take float32 or bfloat16, got "
                        f"{q.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, dropout_rate: float = 0.0,
                    seed=None, causal: bool = False) -> torch.Tensor:
    """Masked MHA ``[B, N, S, D] -> [B, N, S, DV]`` (DV: v's last axis,
    D unless values are narrower, module docstring) with optional fused
    attention-probability dropout; differentiable in q, k and v.

    :param mask: ``[B, S]``, 1 for real keys
    :param seed: an int seeding the dropout masks (same seed, same mask;
        the backward regenerates it). Without a seed there is no dropout,
        as the JAX block runs none without an rng.
    :param causal: query i sees keys j <= i only (SASRec); the triangle is
        built in the kernel, no dense bias in memory.

    A CUDA launch counts in ``flash_attention.launches`` and
    ``backward_launches`` (``causal_launches`` and
    ``causal_backward_launches`` for the causal variant); an fp32 launch
    also in its route's (``flash_route``) ``tf32_launches`` /
    ``tf32_backward_launches`` or ``simt_launches`` /
    ``simt_backward_launches``.
    """
    _check_operands(q, k, v, mask)
    rate = float(dropout_rate) if seed is not None else 0.0
    if rate > 0.0 and q.shape[1] > dropout_bits.SITES_PER_CELL:
        raise ValueError(f"dropout draws one site per head: at most "
                         f"{dropout_bits.SITES_PER_CELL} heads, got "
                         f"{q.shape[1]}")
    seed = 0 if seed is None else int(seed)
    mask = mask.to(torch.int32).contiguous()
    if q.device.type == "cuda" and q.shape[2] > MAX_KERNEL_SEQ_LEN:
        raise ValueError(f"flash attention kernels take S <= "
                         f"{MAX_KERNEL_SEQ_LEN} (a 32-bit dropout counter); "
                         f"got S={q.shape[2]}")
    if q.device.type == "cpu" and q.shape[2] > MAX_FUSED_SEQ_LEN:
        return mha_reference(q, k, v, mask, rate, seed, causal)
    train = torch.is_grad_enabled() and any(t.requires_grad
                                            for t in (q, k, v))
    if not train:
        return flash_attention_forward(q, k, v, mask, seed, rate,
                                       bool(causal))
    return _FlashAttention.apply(q, k, v, mask, seed, rate, bool(causal))


flash_attention.launches = 0
flash_attention.backward_launches = 0
flash_attention.causal_launches = 0
flash_attention.causal_backward_launches = 0
flash_attention.tf32_launches = 0
flash_attention.tf32_backward_launches = 0
flash_attention.simt_launches = 0
flash_attention.simt_backward_launches = 0
