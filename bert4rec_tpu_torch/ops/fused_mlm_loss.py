"""Fused tied-softmax masked cross-entropy, forward and backward (port of
``bert4rec_tpu/ops/fused_mlm_loss.py``).

Replaces the TPU kernels of ``bert4rec_tpu/ops/fused_mlm_loss.py`` with
the hand-written Hopper CUDA kernels of ``csrc/fused_mlm_loss.cu``:

- K3 ``_fwd_kernel`` and K4 ``_bwd_kernel``, the whole-table pair that JAX
  runs where ``fused_loss_supported`` holds (ml-1m);
- K5 ``_fwd_kernel_tiled``, K6 ``_bwd_merged_kernel`` and K7
  ``_bwd_dh_kernel`` + ``_bwd_dt_kernel``, the vocab-tiled family JAX runs
  for every larger table (ml-20m, reddit). The backward takes K6 or K7 by
  JAX's own law (``merged_backward``, a copy of ``_run_backward_tiled``'s).

As on the TPU, the ``[R, V]`` fp32 logits (1.1 GB at the ml-20m train
shape) never reach device memory: every kernel streams the table in
vocabulary tiles and recomputes the logits tile it needs. Bound: 2·R·V·W
FLOP forward, 6·R·V·W (K6) or 8·R·V·W (K4, K7) backward, against a few MB
of inputs — bound by operations; bf16 products on the tensor cores, fp32
K3-K7 there too in 3xTF32 (times in PERF.md).

By operand type (an explicit dispatch, nothing caught): bf16 K3-K7 run the
``wgmma`` kernels of ``csrc/loss_hopper.cuh`` (bf16 tiles by ``cp.async``,
the logits and dlog in registers). K5 holds 128 hidden rows a block as
register fragments, overlaps one vocabulary tile's online softmax with the
next tile's product, and merges its vocabulary splits in split order; K3 is
the same sweep and merge over the whole table, its vocabulary split by K5's
law (``whole_table_splits`` is its Python mirror); K4 runs K7's two sweeps
from K3's lse; K7's two sweeps and K6 sum their fp32 partials across a
thread-block cluster through distributed shared memory, K6 into at most 32
dh partials of ``R x W`` that do not grow with V. fp32 K3-K7 run in 3xTF32
on ``.tf32`` ``wgmma`` (``csrc/loss_tf32.cuh``; every product's A operand
from registers, since ``.tf32`` reads shared memory only K-major;
``ops/tf32.py`` emulates its rounding law): K4, K6 and K7 the bf16
designs' sweeps and clusters, K3 and K5 one forward sweep of their own (at
W <= 128 bf16 K5's blocks: 128 rows, each warpgroup's 64 as fragments
split once and held in registers, both sharing each streamed vocabulary
tile; at W = 256 64-row tiles whose warpgroups take the tiles in turn)
over vocabulary splits by its law (``tiled_forward_splits`` /
``whole_table_splits`` with ``dtype``), merged in split order. Layout rule of the bf16 K3-K7 (``check_copy_alignment``,
raised before the library is reached): hidden and table contiguous with a
16-byte aligned base and rows, W a multiple of 8 up to 256 (zero-filled to
64, 128 or 256). The main path's gathered hidden rows and cast table meet
it at every config width (64, 128, 256). fp32 K3-K7 copy 16-byte pieces
too, with W a multiple of 4: an fp32 operand off that layout is copied
into an aligned, zero-filled buffer first (``_tf32_operand``), which is
exact.

Semantics are the JAX kernels': loss = mean NLL over labels > 0;
``masked_accuracy`` = correct-and-valid / n_valid; ``accuracy`` = correct
/ rows, where "correct" is ``label_logit >= row max`` and label >= 0 (ties
count). Vocab-padding columns are killed by -1e9 folded into the bias
(``_mask_bias``); JAX's extra padding of the vocabulary to 1,024 columns
is not needed (the kernels mask the ragged last tile) and is not done.
The backwards read the forward's per-row logsumexp where the JAX
whole-table backward recomputes max and sum: the same function up to fp32
rounding.

Routing: a CPU tensor runs the plain version; a CUDA tensor launches the
kernels or raises.
"""

import ctypes

import torch

NEG_INF = -1e9
LOSS_MAXW = 256     # the kernels' widest W (csrc/fused_mlm_loss.cu)
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


# the merged-versus-two-sweep law of ``_run_backward_tiled`` (JAX
# fused_mlm_loss.py:359-364, 655-661): K6 where the fp32 dh of the rows,
# padded to BWD_ROW_TILE, fits _MERGED_DH_BYTES, K7 otherwise
_MERGED_DH_BYTES = int(5.5 * 1024 * 1024)
BWD_ROW_TILE = 1024


def merged_backward(rows: int, width: int) -> bool:
    """Whether JAX's tiled backward runs the merged K6 (else K7)."""
    rows_padded = rows + ((-rows) % BWD_ROW_TILE)
    return rows_padded * width * 4 <= _MERGED_DH_BYTES


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


def _label_logit(logits, labels):
    """Each row's logit at its label; 0 where the label matches no column
    (the sharded loss's remote and invalid labels)."""
    v = logits.shape[1]
    labels = labels.long()
    hit = (labels >= 0) & (labels < v)
    ll = logits.gather(1, labels.clamp(0, v - 1)[:, None])[:, 0]
    return torch.where(hit, ll, torch.zeros_like(ll))


def fused_mlm_loss_plain_stats(hidden: torch.Tensor, table: torch.Tensor,
                               bias: torch.Tensor, labels: torch.Tensor):
    """Per-row ``(m, s, ll)`` [R]: the logits' max, the sum of
    ``exp(logits - m)``, and the label logit (0 if no column matches) —
    what JAX's ``_run_forward_tiled_stats`` returns. ``table`` in the
    hidden dtype, ``bias`` masked."""
    logits = _logits(hidden, table, bias)
    m = logits.amax(dim=-1)
    s = torch.exp(logits - m[:, None]).sum(dim=-1)
    return m, s, _label_logit(logits, labels)


def fused_mlm_loss_plain_forward(hidden: torch.Tensor, table: torch.Tensor,
                                 bias: torch.Tensor, labels: torch.Tensor):
    """``(lse [R], sums [4])`` with sums = (sum nll*w, sum correct*w,
    sum correct, sum w), w = label > 0, correct = label logit >= max and
    label >= 0: the plain version of K3 and of K5."""
    m, s, ll = fused_mlm_loss_plain_stats(hidden, table, bias, labels)
    lse = m + torch.log(s)
    w = (labels > 0).float()
    correct = ((ll >= m) & (labels >= 0)).float()
    sums = torch.stack([((lse - ll) * w).sum(), (correct * w).sum(),
                        correct.sum(), w.sum()])
    return lse, sums


def fused_mlm_loss_plain_backward(hidden, table, bias, labels, lse, g,
                                  n_valid, valid_ge_zero: bool = False):
    """``(dh, dtable, dbias)``: ``dlog = (softmax - onehot) * w * g /
    max(n_valid, 1)`` with w = label > 0 (label >= 0 under
    ``valid_ge_zero``); dh in the hidden dtype, the others fp32. The plain
    version of K4, K6 and K7."""
    logits = _logits(hidden, table, bias)
    scale = g.float().reshape(()) / torch.clamp(n_valid.float(), min=1.0)
    col = torch.arange(logits.shape[1], device=logits.device)
    onehot = (col[None, :] == labels.long()[:, None]).float()
    valid = labels >= 0 if valid_ge_zero else labels > 0
    w = valid.float() * scale
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
        lib.b4r_mlm_loss_tiled_fwd.restype = ci
        lib.b4r_mlm_loss_tiled_fwd.argtypes = [ci] + [vp] * 10 + [ci] * 3 \
            + [vp]
        lib.b4r_mlm_loss_tiled_bwd.restype = ci
        lib.b4r_mlm_loss_tiled_bwd.argtypes = [ci, ci] + [vp] * 7 + [ci] \
            + [vp] * 4 + [ci] * 3 + [vp]
        for name, n in (("b4r_mlm_loss_workspace_bytes", 4),
                        ("b4r_mlm_loss_tiled_fwd_workspace_bytes", 4),
                        ("b4r_mlm_loss_tiled_bwd_workspace_bytes", 4)):
            getattr(lib, name).restype = ctypes.c_size_t
            getattr(lib, name).argtypes = [ci] * n
        lib.b4r_mlm_loss_max_width.restype = ci
        lib.b4r_mlm_loss_max_width.argtypes = []
        lib.b4r_mlm_loss_sweep_grid.restype = None
        lib.b4r_mlm_loss_sweep_grid.argtypes = [ci] * 4 + [vp]
        _lib = lib
    return _lib


# K5's blocks: bf16 (csrc/loss_hopper.cuh kFwdRows, kFwdN, kFwdItems) and
# fp32 at W <= 128 (csrc/loss_tf32.cuh kFwdBlockRows, kFwdYn, kFwdRowItems)
# 128 hidden rows each, vocabulary tiles of 64 entries (bf16 128 at W >
# 128), the vocabulary split until the grid holds ~1,024 blocks; fp32 at
# W > 128 (kRows, kSweepYn, kFwdTileItems) 64 rows, 32 entries, ~512
# blocks; a split at least one vocabulary tile
_FWD_ROWS, _FWD_ITEMS = 128, 1024
_TF32_WIDE_FWD = (64, 32, 512)


def tiled_forward_splits(rows: int, v: int, w: int,
                         dtype: torch.dtype = torch.bfloat16) -> int:
    """K5's vocabulary splits in the operand ``dtype``
    (``loss_hopper::fwd_splits`` in bf16, ``loss_tf32::fwd_splits`` in
    fp32, fp32 K3's law too): the fewest that bring (row blocks x splits)
    to the target, at most one per vocabulary tile; 128-row blocks, 64-entry
    tiles (128 in bf16 at W > 128) and 1,024 blocks, but fp32 at W > 128:
    64-row tiles, 32-entry tiles, 512 blocks (at ML-20M's batch, R =
    10,240, V = 26,732, W = 128, 80 row blocks x 13 splits in both
    dtypes). The library decides the splits itself; this mirror and
    ``tiled_forward_workspace_bytes`` are held against the library's
    workspace bytes by the card tests."""
    if dtype == torch.float32 and w > 128:
        block, tile, items = _TF32_WIDE_FWD
    else:
        block, tile, items = _FWD_ROWS, (128 if w > 128 else 64), _FWD_ITEMS
    rblocks, vtiles = -(-rows // block), -(-v // tile)
    return max(1, min(vtiles, -(-items // rblocks)))


def whole_table_splits(rows: int, v: int, w: int,
                       dtype: torch.dtype = torch.bfloat16) -> int:
    """K3's vocabulary splits: K3 is K5's sweep over the whole table in
    either dtype and splits it by K5's law (``tiled_forward_splits``). In
    bf16, at ml-1m's batch (R = 10,240, V = 3,709, W = 128), 13 splits,
    1,040 blocks, against one split's 80 blocks on 132 SMs, which measured
    slower on the card (PERF.md); in fp32 the same at W <= 128. The
    library decides the splits itself (``fwd_splits`` in
    csrc/fused_mlm_loss.cu); this mirror and ``whole_table_workspace_bytes``
    are held against the library's workspace bytes by the card tests."""
    return tiled_forward_splits(rows, v, w, dtype)


def _carved(*counts: int) -> int:
    """Bytes of fp32 arrays of ``counts`` elements carved one after another,
    each rounded up to 256 bytes (``Carve`` in csrc/common.cuh)."""
    return sum(-(-4 * n // 256) * 256 for n in counts)


def tiled_forward_workspace_bytes(rows: int, v: int, w: int,
                                  dtype: torch.dtype = torch.bfloat16) -> int:
    """K5's workspace (``b4r_mlm_loss_tiled_fwd_workspace_bytes``), in
    either dtype: the per-split row (max, sum, label logit) and the 256-row
    block sums, with no V x W term."""
    n = tiled_forward_splits(rows, v, w, dtype) * rows
    return _carved(n, n, n, -(-rows // 256) * 4)


def whole_table_workspace_bytes(rows: int, v: int, w: int,
                                dtype: torch.dtype = torch.bfloat16) -> int:
    """K3's workspace (``b4r_mlm_loss_workspace_bytes``), in either dtype:
    K5's at the same shape. K4 needs none."""
    return tiled_forward_workspace_bytes(rows, v, w, dtype)


def workspace_bytes(kernel: str, rows: int, v: int, w: int,
                    dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of device workspace the library asks for: ``kernel`` is
    ``"K3/K4"`` (K3's; K4 needs none), ``"K5"``, ``"K6"`` or ``"K7"``, in
    the operand ``dtype`` (K3 and K5 split the vocabulary by another law in
    each dtype; K6 and K7 need the same in both)."""
    lib = _kernel_lib()
    code = _DTYPE_CODE[dtype]
    if kernel == "K3/K4":
        return lib.b4r_mlm_loss_workspace_bytes(code, rows, v, w)
    if kernel == "K5":
        return lib.b4r_mlm_loss_tiled_fwd_workspace_bytes(code, rows, v, w)
    if kernel in ("K6", "K7"):
        return lib.b4r_mlm_loss_tiled_bwd_workspace_bytes(
            rows, v, w, int(kernel == "K6"))
    raise ValueError(f"no kernel {kernel!r}")


def _workspace(nbytes, device):
    return torch.empty((nbytes,), dtype=torch.uint8, device=device)


def _check_width(lib, w):
    if w > lib.b4r_mlm_loss_max_width():
        raise ValueError(f"fused loss kernels take width <= "
                         f"{lib.b4r_mlm_loss_max_width()}, got {w}")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def sweep_grid(rows: int, v: int, w: int, dtype: torch.dtype) -> dict:
    """The grid of K4's (and K7's) two sweeps as the library launches them:
    ``{"dh": (blocks, cluster), "dt": (blocks, cluster)}``."""
    out = (ctypes.c_int * 4)()
    _kernel_lib().b4r_mlm_loss_sweep_grid(_DTYPE_CODE[dtype], rows, v, w,
                                          out)
    return {"dh": (out[0], out[1]), "dt": (out[2], out[3])}


def _launch_forward(hidden, table, bias, labels):
    """K3: ``(lse [R], sums [4])``."""
    hidden, table = _kernel_operands(hidden, table)
    lib = _kernel_lib()
    rows, w = hidden.shape
    v = table.shape[0]
    _check_width(lib, w)
    dev = hidden.device
    lse = torch.empty((rows,), dtype=torch.float32, device=dev)
    sums = torch.empty((4,), dtype=torch.float32, device=dev)
    ws = _workspace(workspace_bytes("K3/K4", rows, v, w, hidden.dtype), dev)
    _raise_on(lib.b4r_mlm_loss_fwd(
        _DTYPE_CODE[hidden.dtype], hidden.data_ptr(), table.data_ptr(),
        bias.data_ptr(), labels.data_ptr(), lse.data_ptr(), sums.data_ptr(),
        ws.data_ptr(), rows, v, w, torch.cuda.current_stream(dev).cuda_stream),
        "fused_mlm_loss")
    return lse, sums


def _launch_backward(hidden, table, bias, labels, lse, g, n_valid):
    """K4: ``(dh, dtable, dbias)``, K7's two sweeps from K3's lse."""
    return _backward(None, hidden, table, bias, labels, lse, g, n_valid)


def _launch_tiled(hidden, table, bias, labels, stats):
    """K5: ``(lse [R], sums [4])``, or with ``stats`` the per-row
    ``(m, s, ll)`` [R] without the scalars."""
    hidden, table = _kernel_operands(hidden, table)
    lib = _kernel_lib()
    rows, w = hidden.shape
    v = table.shape[0]
    _check_width(lib, w)
    dev = hidden.device
    row = lambda: torch.empty((rows,), dtype=torch.float32,  # noqa: E731
                              device=dev)
    lse, sums = (None, None) if stats else (
        row(), torch.empty((4,), dtype=torch.float32, device=dev))
    m, s, ll = (row(), row(), row()) if stats else (None, None, None)
    ws = _workspace(workspace_bytes("K5", rows, v, w, hidden.dtype), dev)
    _raise_on(lib.b4r_mlm_loss_tiled_fwd(
        _DTYPE_CODE[hidden.dtype], hidden.data_ptr(), table.data_ptr(),
        bias.data_ptr(), labels.data_ptr(), _ptr(lse), _ptr(sums), _ptr(m),
        _ptr(s), _ptr(ll), ws.data_ptr(), rows, v, w,
        torch.cuda.current_stream(dev).cuda_stream), "fused_mlm_loss_tiled")
    return (m, s, ll) if stats else (lse, sums)


def _launch_forward_tiled(hidden, table, bias, labels):
    return _launch_tiled(hidden, table, bias, labels, stats=False)


def _launch_forward_tiled_stats(hidden, table, bias, labels):
    return _launch_tiled(hidden, table, bias, labels, stats=True)


def check_copy_alignment(t: torch.Tensor, name: str) -> None:
    """The bf16 K3-K7 kernels copy operand rows in 16-byte pieces: raises
    unless ``t`` is a contiguous ``[rows, W]`` matrix with a 16-byte
    aligned base and rows (W a multiple of 8) and W <= LOSS_MAXW."""
    bad = []
    if t.dim() != 2 or not t.is_contiguous():
        bad.append("not a contiguous matrix")
    if t.data_ptr() % 16:
        bad.append(f"base {t.data_ptr() % 16} bytes past 16")
    if t.dim() == 2 and (t.shape[1] % 8 or t.shape[1] > LOSS_MAXW):
        bad.append(f"width {t.shape[1]} is not a multiple of 8 up to "
                   f"{LOSS_MAXW}")
    if bad:
        raise ValueError(f"the bf16 loss kernels K3-K7 take "
                         f"contiguous operands with a 16-byte aligned base "
                         f"and rows; {name} of shape {tuple(t.shape)}: "
                         + "; ".join(bad))


def _check_layout(hidden, table):
    """bf16 K3-K7's layout rule, before the library is reached."""
    if hidden.dtype == torch.bfloat16:
        check_copy_alignment(hidden, "hidden")
        check_copy_alignment(table, "table")


def _kernel_operands(hidden, table):
    """``(hidden, table)`` as the kernels take them: bf16 held to the
    layout rule (raises), fp32 copied onto it where off it."""
    _check_layout(hidden, table)
    if hidden.dtype == torch.float32:
        return _tf32_operand(hidden), _tf32_operand(table)
    return hidden, table


def _tf32_operand(t: torch.Tensor) -> torch.Tensor:
    """fp32 K3-K7 copy operand rows in 16-byte pieces: ``t``
    itself if it is a contiguous matrix with a 16-byte aligned base and W a
    multiple of 4, else a copy into a new zero-filled ``[rows, W rounded up
    to 4]`` buffer (the zero columns are exact for every product)."""
    w = t.shape[1]
    if t.is_contiguous() and t.data_ptr() % 16 == 0 and w % 4 == 0:
        return t
    out = t.new_zeros((t.shape[0], -(-w // 4) * 4))
    out[:, :w] = t
    return out


def _launch_backward_tiled(hidden, table, bias, labels, lse, g, n_valid,
                           merged, valid_ge_zero=False):
    """K6 (``merged``) or K7: ``(dh, dtable, dbias)``."""
    return _backward(bool(merged), hidden, table, bias, labels, lse, g,
                     n_valid, valid_ge_zero)


def _backward(merged, hidden, table, bias, labels, lse, g, n_valid,
              valid_ge_zero=False):
    """K4 (``merged`` None, the whole-table entry) or K6 / K7:
    ``(dh, dtable, dbias)`` at the caller's width."""
    width = hidden.shape[1]
    hidden, table = _kernel_operands(hidden, table)
    lib = _kernel_lib()
    rows, w = hidden.shape
    v = table.shape[0]
    dev = hidden.device
    dh = torch.empty_like(hidden)
    dt = torch.empty((v, w), dtype=torch.float32, device=dev)
    db = torch.empty((v,), dtype=torch.float32, device=dev)
    g = g.reshape(1).float().contiguous()
    ptrs = (hidden.data_ptr(), table.data_ptr(), bias.data_ptr(),
            labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
            n_valid.data_ptr())
    outs = (dh.data_ptr(), dt.data_ptr(), db.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _DTYPE_CODE[hidden.dtype]
    if merged is None:
        _raise_on(lib.b4r_mlm_loss_bwd(code, *ptrs, *outs, None, rows, v, w,
                                       stream), "fused_mlm_loss backward")
    else:
        kernel = "K6" if merged else "K7"
        ws = _workspace(workspace_bytes(kernel, rows, v, w, hidden.dtype),
                        dev)
        _raise_on(lib.b4r_mlm_loss_tiled_bwd(
            int(merged), code, *ptrs, int(valid_ge_zero), *outs,
            ws.data_ptr(), rows, v, w, stream),
            f"fused_mlm_loss_tiled backward ({kernel})")
    if w != width:
        dh, dt = dh[:, :width].contiguous(), dt[:, :width].contiguous()
    return dh, dt, db


class _FusedLoss(torch.autograd.Function):
    """K3 forward and K4 backward, or (``tiled``) K5 forward and K6 / K7
    backward: the JAX ``custom_vjp``s. Only the loss carries a gradient,
    the three counts are metrics."""

    @staticmethod
    def forward(ctx, hidden, table, bias, labels, vocab_size, tiled):
        table_s = table.to(hidden.dtype).contiguous()
        bias_m = _mask_bias(bias, vocab_size).float().contiguous()
        hidden = hidden.contiguous()
        labels = labels.contiguous()
        if hidden.device.type == "cpu":
            lse, sums = fused_mlm_loss_plain_forward(hidden, table_s, bias_m,
                                                     labels)
        elif tiled:
            lse, sums = _launch_forward_tiled(hidden, table_s, bias_m, labels)
            fused_mlm_loss_tiled.launches += 1
        else:
            lse, sums = _launch_forward(hidden, table_s, bias_m, labels)
            fused_mlm_loss.launches += 1
        ctx.save_for_backward(hidden, table_s, bias_m, labels, lse, sums)
        ctx.vocab_size, ctx.tiled = vocab_size, tiled
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
        elif ctx.tiled:
            merged = merged_backward(*hidden.shape)
            dh, dt, db = _launch_backward_tiled(
                hidden, table_s, bias_m, labels, lse, g_loss, sums[3:4],
                merged)
            if merged:
                fused_mlm_loss_tiled.merged_launches += 1
            else:
                fused_mlm_loss_tiled.two_sweep_launches += 1
        else:
            dh, dt, db = _launch_backward(hidden, table_s, bias_m, labels,
                                          lse, g_loss, sums[3:4])
            fused_mlm_loss.backward_launches += 1
        # the padding columns' bias is the constant -1e9: no gradient
        db[ctx.vocab_size:] = 0.0
        t_dtype, b_dtype = ctx.dtypes
        return dh, dt.to(t_dtype), db.to(b_dtype), None, None, None


def _check_operands(hidden, table, bias, labels):
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


def fused_mlm_loss(hidden: torch.Tensor, table: torch.Tensor,
                   bias: torch.Tensor, labels: torch.Tensor,
                   vocab_size: int):
    """``(loss_mean, masked_correct, all_correct, n_valid)`` over flat rows:
    ``hidden [R, W]``, ``table [Vp, W]`` (the tied table, cast to the
    hidden dtype inside), ``bias [Vp]``, ``labels [R]`` int32 (0 = pad).
    A CUDA ``hidden`` launches K3 (and K4 in backward), counted in
    ``fused_mlm_loss.launches`` / ``.backward_launches``."""
    _check_operands(hidden, table, bias, labels)
    return _FusedLoss.apply(hidden, table, bias, labels, int(vocab_size),
                            False)


fused_mlm_loss.launches = 0
fused_mlm_loss.backward_launches = 0


def fused_mlm_loss_tiled(hidden: torch.Tensor, table: torch.Tensor,
                         bias: torch.Tensor, labels: torch.Tensor,
                         vocab_size: int):
    """The vocab-tiled twin of :func:`fused_mlm_loss` (JAX
    ``fused_mlm_loss_tiled``): the same contract for any vocabulary. A
    CUDA ``hidden`` launches K5, counted in ``fused_mlm_loss_tiled.launches``,
    and in backward K6 or K7 by :func:`merged_backward`, counted in
    ``.merged_launches`` / ``.two_sweep_launches``."""
    _check_operands(hidden, table, bias, labels)
    return _FusedLoss.apply(hidden, table, bias, labels, int(vocab_size),
                            True)


fused_mlm_loss_tiled.launches = 0
fused_mlm_loss_tiled.merged_launches = 0
fused_mlm_loss_tiled.two_sweep_launches = 0


def fused_mlm_loss_tiled_stats(hidden: torch.Tensor, table: torch.Tensor,
                               bias: torch.Tensor, labels: torch.Tensor,
                               vocab_size: int):
    """Per-row ``(m, s, ll)`` [R] fp32 (JAX ``_run_forward_tiled_stats``,
    for the vocab-sharded loss): the running max, the sum of exp at it, and
    the label logit (0 if the label matches no column). A CUDA ``hidden``
    launches K5 (counted in ``fused_mlm_loss_tiled.launches``)."""
    _check_operands(hidden, table, bias, labels)
    table_s = table.to(hidden.dtype).contiguous()
    bias_m = _mask_bias(bias, vocab_size).float().contiguous()
    hidden, labels = hidden.contiguous(), labels.contiguous()
    if hidden.device.type == "cpu":
        return fused_mlm_loss_plain_stats(hidden, table_s, bias_m, labels)
    out = _launch_forward_tiled_stats(hidden, table_s, bias_m, labels)
    fused_mlm_loss_tiled.launches += 1
    return out


def mlm_loss_and_metrics(hidden: torch.Tensor, table: torch.Tensor,
                         bias: torch.Tensor, labels: torch.Tensor,
                         vocab_size: int):
    """``(loss, {"masked_accuracy", "accuracy"})`` as the JAX
    ``mlm_loss_and_metrics``; ``hidden`` is ``[B, P, W]`` or ``[R, W]``.
    The whole-table kernels where ``fused_loss_supported`` holds, the
    vocab-tiled ones otherwise (JAX fused_mlm_loss.py:317-319)."""
    rows = hidden.shape[0] * hidden.shape[1] if hidden.dim() == 3 \
        else hidden.shape[0]
    fn = (fused_mlm_loss
          if fused_loss_supported(table.shape[0], table.shape[1])
          else fused_mlm_loss_tiled)
    loss, cv, ca, nv = fn(hidden.reshape(rows, hidden.shape[-1]), table,
                          bias, labels.reshape(rows).to(torch.int32),
                          vocab_size)
    return loss, {"masked_accuracy": cv / torch.clamp(nv, min=1.0),
                  "accuracy": ca / rows}
