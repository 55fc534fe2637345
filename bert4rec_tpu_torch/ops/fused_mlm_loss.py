"""Fused tied-softmax masked cross-entropy, forward and backward (port of
``bert4rec_tpu/ops/fused_mlm_loss.py``, the whole-table kernels).

Replaces the TPU kernels ``_fwd_kernel`` (K3, ``_run_forward``) and
``_bwd_kernel`` (K4, ``_run_backward``) of
``bert4rec_tpu/ops/fused_mlm_loss.py`` with the hand-written Hopper CUDA
kernels of ``csrc/fused_mlm_loss.cu``. As on the TPU, the ``[R, V]`` fp32
logits (152 MB at the ml-1m train shape) never reach device memory: every
kernel streams the table in vocabulary tiles and recomputes the logits
tile it needs. Bound: 2·R·V·W FLOP forward (9.7 GFLOP at R=10,240,
V=3,709, W=128) and about 3x that backward against ~3.5 MB of inputs —
bound by operations; bf16 products on the tensor cores, fp32 ones as SIMT
loops (times in PERF.md).

Semantics are the JAX kernel's: loss = mean NLL over labels > 0;
``masked_accuracy`` = correct-and-valid / n_valid; ``accuracy`` = correct
/ rows, where "correct" is ``label_logit >= row max`` (ties count).
Vocab-padding columns are killed by -1e9 folded into the bias
(``_mask_bias``). The backward reads the forward's per-row logsumexp where
the JAX single-tile backward recomputes max and sum: the same function up
to fp32 rounding.

Routing: a CPU tensor runs the plain version; a CUDA tensor launches the
kernels or raises. A vocabulary the JAX package sends to its vocab-tiled
kernels (K5-K7, ``fused_loss_supported`` false) raises on CUDA: those are
not ported yet.
"""

import ctypes

import torch

NEG_INF = -1e9
ROW_TILE = 256
VMEM_BUDGET_BYTES = 15 * 1024 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# routing law — copied from the JAX package (fused_mlm_loss.py:37-85): the
# TPU's VMEM-fit rule, kept so the port routes the vocabularies JAX routes
# --------------------------------------------------------------------------- #

def estimate_vmem_bytes(v_padded: int, width: int) -> int:
    return 8 * v_padded * width + 8 * ROW_TILE * v_padded


def fused_loss_supported(v_padded: int, width: int) -> bool:
    """Whether JAX runs the single-tile (whole-table) kernels K3/K4."""
    return estimate_vmem_bytes(v_padded, width) <= VMEM_BUDGET_BYTES


def fused_loss_available(v_padded: int, width: int) -> bool:
    """Whether JAX runs any fused loss: K3/K4, else the vocab-tiled
    K5-K7 for any table whose fp32 gradient fits 1 GiB."""
    if fused_loss_supported(v_padded, width):
        return True
    return 4 * v_padded * width <= 1 << 30


def _mask_bias(bias: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """-1e9 on the vocab-padding columns, folded into the bias once."""
    if bias.shape[0] <= vocab_size:
        return bias
    col = torch.arange(bias.shape[0], device=bias.device)
    return torch.where(col >= vocab_size, torch.full_like(bias, NEG_INF), bias)


# --------------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------------- #

def _logits(hidden, table, bias):
    return hidden.float() @ table.float().T + bias


def fused_mlm_loss_plain_forward(hidden: torch.Tensor, table: torch.Tensor,
                                 bias: torch.Tensor, labels: torch.Tensor):
    """``(lse [R], sums [4])`` with sums = (sum nll*w, sum correct*w,
    sum correct, sum w); ``table`` in the hidden dtype, ``bias`` masked."""
    logits = _logits(hidden, table, bias)
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    ll = logits.gather(1, labels.long()[:, None])[:, 0]
    w = (labels > 0).float()
    correct = (ll >= m).float()
    sums = torch.stack([((lse - ll) * w).sum(), (correct * w).sum(),
                        correct.sum(), w.sum()])
    return lse, sums


def fused_mlm_loss_plain_backward(hidden, table, bias, labels, lse, g,
                                  n_valid):
    """``(dh, dtable, dbias)``: ``dlog = (softmax - onehot) * w * g /
    max(n_valid, 1)``; dh in the hidden dtype, the others fp32."""
    logits = _logits(hidden, table, bias)
    scale = g.float().reshape(()) / torch.clamp(n_valid.float(), min=1.0)
    onehot = torch.zeros_like(logits).scatter_(1, labels.long()[:, None],
                                               1.0)
    w = (labels > 0).float() * scale
    dlog = (torch.exp(logits - lse[:, None]) - onehot) * w[:, None]
    dlog_t = dlog.to(hidden.dtype).float()
    dh = (dlog_t @ table.float()).to(hidden.dtype)
    return dh, dlog_t.T @ hidden.float(), dlog.sum(dim=0)


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from bert4rec_tpu_torch.ops import kernel_build
        lib = kernel_build.load("fused_mlm_loss")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.b4r_mlm_loss_fwd.restype = ci
        lib.b4r_mlm_loss_fwd.argtypes = [ci] + [vp] * 7 + [ci] * 3 + [vp]
        lib.b4r_mlm_loss_bwd.restype = ci
        lib.b4r_mlm_loss_bwd.argtypes = [ci] + [vp] * 11 + [ci] * 3 + [vp]
        lib.b4r_mlm_loss_workspace_bytes.restype = ctypes.c_size_t
        lib.b4r_mlm_loss_workspace_bytes.argtypes = [ci] * 3
        lib.b4r_mlm_loss_max_width.restype = ci
        lib.b4r_mlm_loss_max_width.argtypes = []
        _lib = lib
    return _lib


def _workspace(lib, rows, v, w, device):
    return torch.empty((lib.b4r_mlm_loss_workspace_bytes(rows, v, w),),
                       dtype=torch.uint8, device=device)


def _launch_forward(hidden, table, bias, labels):
    lib = _kernel_lib()
    rows, w = hidden.shape
    v = table.shape[0]
    if w > lib.b4r_mlm_loss_max_width():
        raise ValueError(f"fused loss kernel takes width <= "
                         f"{lib.b4r_mlm_loss_max_width()}, got {w}")
    dev = hidden.device
    lse = torch.empty((rows,), dtype=torch.float32, device=dev)
    sums = torch.empty((4,), dtype=torch.float32, device=dev)
    ws = _workspace(lib, rows, v, w, dev)
    err = lib.b4r_mlm_loss_fwd(
        _DTYPE_CODE[hidden.dtype], hidden.data_ptr(), table.data_ptr(),
        bias.data_ptr(), labels.data_ptr(), lse.data_ptr(), sums.data_ptr(),
        ws.data_ptr(), rows, v, w, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlm_loss kernel launch failed: CUDA error "
                           f"{err}")
    return lse, sums


def _launch_backward(hidden, table, bias, labels, lse, g, n_valid):
    lib = _kernel_lib()
    rows, w = hidden.shape
    v = table.shape[0]
    dev = hidden.device
    dh = torch.empty_like(hidden)
    dt = torch.empty((v, w), dtype=torch.float32, device=dev)
    db = torch.empty((v,), dtype=torch.float32, device=dev)
    g = g.reshape(1).float().contiguous()
    ws = _workspace(lib, rows, v, w, dev)
    err = lib.b4r_mlm_loss_bwd(
        _DTYPE_CODE[hidden.dtype], hidden.data_ptr(), table.data_ptr(),
        bias.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        n_valid.data_ptr(), dh.data_ptr(), dt.data_ptr(), db.data_ptr(),
        ws.data_ptr(), rows, v, w, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlm_loss backward kernel launch failed: "
                           f"CUDA error {err}")
    return dh, dt, db


class _FusedLoss(torch.autograd.Function):
    """K3 forward and K4 backward (the JAX ``custom_vjp``); only the loss
    carries a gradient, the three counts are metrics."""

    @staticmethod
    def forward(ctx, hidden, table, bias, labels, vocab_size):
        table_s = table.to(hidden.dtype).contiguous()
        bias_m = _mask_bias(bias, vocab_size).float().contiguous()
        hidden = hidden.contiguous()
        labels = labels.contiguous()
        if hidden.device.type == "cpu":
            lse, sums = fused_mlm_loss_plain_forward(hidden, table_s, bias_m,
                                                     labels)
        else:
            lse, sums = _launch_forward(hidden, table_s, bias_m, labels)
            fused_mlm_loss.launches += 1
        ctx.save_for_backward(hidden, table_s, bias_m, labels, lse, sums)
        ctx.vocab_size = vocab_size
        ctx.dtypes = (table.dtype, bias.dtype)
        loss = sums[0] / torch.clamp(sums[3], min=1.0)
        cv, ca, nv = sums[1].clone(), sums[2].clone(), sums[3].clone()
        ctx.mark_non_differentiable(cv, ca, nv)
        return loss, cv, ca, nv

    @staticmethod
    def backward(ctx, g_loss, *_):
        hidden, table_s, bias_m, labels, lse, sums = ctx.saved_tensors
        if hidden.device.type == "cpu":
            dh, dt, db = fused_mlm_loss_plain_backward(
                hidden, table_s, bias_m, labels, lse, g_loss, sums[3])
        else:
            dh, dt, db = _launch_backward(hidden, table_s, bias_m, labels,
                                          lse, g_loss, sums[3:4])
            fused_mlm_loss.backward_launches += 1
        # the padding columns' bias is the constant -1e9: no gradient
        db[ctx.vocab_size:] = 0.0
        t_dtype, b_dtype = ctx.dtypes
        return dh, dt.to(t_dtype), db.to(b_dtype), None, None


def fused_mlm_loss(hidden: torch.Tensor, table: torch.Tensor,
                   bias: torch.Tensor, labels: torch.Tensor,
                   vocab_size: int):
    """``(loss_mean, masked_correct, all_correct, n_valid)`` over flat rows:
    ``hidden [R, W]``, ``table [Vp, W]`` (the tied table, cast to the
    hidden dtype inside), ``bias [Vp]``, ``labels [R]`` int32 (0 = pad).
    A CUDA ``hidden`` launches K3 (and K4 in backward), counted in
    ``fused_mlm_loss.launches`` / ``.backward_launches``."""
    if hidden.dim() != 2 or labels.shape != (hidden.shape[0],):
        raise ValueError(f"hidden must be [R, W] and labels [R], got "
                         f"{tuple(hidden.shape)} and {tuple(labels.shape)}")
    if hidden.dtype not in _DTYPE_CODE or labels.dtype != torch.int32:
        raise TypeError(f"hidden must be float32 or bfloat16 and labels "
                        f"int32, got {hidden.dtype} and {labels.dtype}")
    if table.shape[1] != hidden.shape[1] or bias.shape != (table.shape[0],):
        raise ValueError(f"table must be [Vp, {hidden.shape[1]}] and bias "
                         f"[Vp], got {tuple(table.shape)}, "
                         f"{tuple(bias.shape)}")
    for t in (table, bias, labels):
        if t.device != hidden.device:
            raise ValueError("hidden, table, bias and labels must lie on one "
                             "device")
    if hidden.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused loss for device {hidden.device}")
    return _FusedLoss.apply(hidden, table, bias, labels, int(vocab_size))


fused_mlm_loss.launches = 0
fused_mlm_loss.backward_launches = 0


def mlm_loss_and_metrics(hidden: torch.Tensor, table: torch.Tensor,
                         bias: torch.Tensor, labels: torch.Tensor,
                         vocab_size: int):
    """``(loss, {"masked_accuracy", "accuracy"})`` as the JAX
    ``mlm_loss_and_metrics``; ``hidden`` is ``[B, P, W]`` or ``[R, W]``."""
    rows = hidden.shape[0] * hidden.shape[1] if hidden.dim() == 3 \
        else hidden.shape[0]
    if not fused_loss_supported(table.shape[0], table.shape[1]) \
            and hidden.device.type == "cuda":
        raise NotImplementedError(
            f"a {table.shape[0]} x {table.shape[1]} table takes the "
            f"vocab-tiled loss kernels K5-K7 (bert4rec_tpu/ops/"
            f"fused_mlm_loss.py _fwd_kernel_tiled, _bwd_merged_kernel, "
            f"_bwd_dh_kernel/_bwd_dt_kernel), which are not ported yet")
    loss, cv, ca, nv = fused_mlm_loss(
        hidden.reshape(rows, hidden.shape[-1]), table, bias,
        labels.reshape(rows).to(torch.int32), vocab_size)
    return loss, {"masked_accuracy": cv / torch.clamp(nv, min=1.0),
                  "accuracy": ca / rows}
