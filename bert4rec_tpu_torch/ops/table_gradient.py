"""The embedding table's gradient: the backward of a row gather.

``dtable[v, :] = sum of g[r, :] over the positions r with ids[r] == v``,
fp32, 0 in every row no position touches; the [PAD] row keeps its
gradient, as JAX's ``jnp.take`` has no padding index.

Replaces no TPU kernel: the JAX package's gather leaves its backward to
XLA's scatter-add. On the card it replaces PyTorch's
``index_put_(accumulate=True)``, which gives each run of equal ids to one
warp that walks it row by row, and the separate kernel of the cast's
backward: a batch's [PAD] and [MASK] runs (27,623 and 4,630 of 51,200
positions at ml-20m_128) made that walk 16-18 ms a step.

A CUDA tensor launches ``csrc/table_grad.cu``: warp tiles of 32 positions,
each group of equal ids in a tile summed in position order, the groups of
an id added in tile order; no float atomics, so two calls give the same
bits. It reads ``g`` in the compute dtype (bf16 or fp32) and needs no
``.long()`` copy of the int32 ids. Bound: read ``g`` once, write the table
once (13.1 + 13.7 MB at ml-20m_128, about 8 us at 3.35 TB/s). Its times are
in PERF.md (K10). A CPU tensor runs the plain version, ``index_add_`` in
fp32 (fixed order).

``table_gather`` is the gather with this backward: today's
``table[ids.long()].to(dtype)`` forward, and only when grad is enabled and
the table requires grad; otherwise (``no_grad``, inference, export) it is
that indexing alone.
"""

import ctypes

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from bert4rec_tpu_torch.ops import kernel_build
        lib = kernel_build.load("table_grad")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.b4r_table_grad.restype = ci
        # dtype, g, ids, R, H, V, iscratch, part, out, stream
        lib.b4r_table_grad.argtypes = [ci, vp, vp, ci, ci, ci, vp, vp, vp, vp]
        lib.b4r_table_grad_scratch.restype = ctypes.c_longlong
        lib.b4r_table_grad_scratch.argtypes = [ci, ci]
        _lib = lib
    return _lib


def table_gradient_plain(g: torch.Tensor, ids: torch.Tensor,
                         num_rows: int) -> torch.Tensor:
    """The plain version: ``g``'s rows added onto their ids' rows of a
    zero ``[num_rows, H]`` table by ``index_add_``, in fp32 (float64 for a
    float64 ``g``)."""
    h = g.shape[-1]
    dtype = torch.promote_types(g.dtype, torch.float32)
    out = torch.zeros((num_rows, h), dtype=dtype, device=g.device)
    return out.index_add_(0, ids.reshape(-1).long(),
                          g.reshape(-1, h).to(dtype))


def _launch(g: torch.Tensor, ids: torch.Tensor,
            num_rows: int) -> torch.Tensor:
    h = g.shape[-1]
    g2 = g.reshape(-1, h).contiguous()
    ids1 = ids.reshape(-1).contiguous()
    r = ids1.numel()
    if g2.shape[0] != r:
        raise ValueError(f"g has {g2.shape[0]} rows for {r} ids")
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"the table gradient kernel takes bf16 or fp32 g, "
                        f"got {g.dtype}")
    if ids1.dtype != torch.int32:
        raise TypeError(f"the table gradient kernel takes int32 ids, got "
                        f"{ids1.dtype}")
    out = torch.empty((num_rows, h), dtype=torch.float32, device=g.device)
    if r == 0:
        return out.zero_()
    lib = _kernel_lib()
    scratch = lib.b4r_table_grad_scratch(r, num_rows)
    if scratch == 0:
        raise ValueError(f"the table gradient kernel does not take {r} "
                         f"positions onto {num_rows} rows")
    hp = -(-h // 8) * 8
    iscratch = torch.empty(scratch, dtype=torch.int32, device=g.device)
    part = torch.empty(r * hp, dtype=torch.float32, device=g.device)
    err = lib.b4r_table_grad(
        _DTYPE_CODE[g.dtype], g2.data_ptr(), ids1.data_ptr(), r, h, num_rows,
        iscratch.data_ptr(), part.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"table gradient kernel launch failed: CUDA "
                           f"error {err}")
    table_gradient.launches += 1
    return out


def table_gradient(g: torch.Tensor, ids: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """``[num_rows, H]`` fp32: the rows of ``g`` (``[..., H]``) summed onto
    the rows ``ids`` (int32, ``g``'s leading shape) name. A CUDA tensor
    launches the kernel (counted in ``table_gradient.launches``) or raises;
    a CPU tensor runs ``table_gradient_plain``."""
    if g.device.type == "cpu":
        return table_gradient_plain(g, ids, num_rows)
    return _launch(g, ids, num_rows)


table_gradient.launches = 0


class _TableGather(torch.autograd.Function):
    """``table[ids].to(dtype)`` whose backward is ``table_gradient``; only
    the ids are saved."""

    @staticmethod
    def forward(ctx, table, ids, dtype):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        return table[ids.long()].to(dtype)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        dtable = table_gradient(g, ids, ctx.num_rows)
        return dtable.to(ctx.table_dtype), None, None


def table_gather(table: torch.Tensor, ids: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Rows ``ids`` of ``table`` cast to ``dtype``, as
    ``table[ids.long()].to(dtype)``. When grad is enabled and ``table``
    requires grad, its backward is ``table_gradient`` (ids other than int32
    are cast to int32 once, in the forward); otherwise it is that indexing
    alone."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[ids.long()].to(dtype)
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    return _TableGather.apply(table, ids, dtype)
