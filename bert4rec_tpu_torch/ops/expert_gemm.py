"""K11: the grouped expert GEMM of a mixture of SwiGLU experts, forward and
backward, over rows sorted by expert.

No TPU kernel: the JAX package has no sparse experts. It was added for the
``"mla_moe"`` block (``models/components/mla_moe.py``): every token's row
is copied once per expert it is routed to, the copies are sorted by
expert, and each expert ``e`` maps its run of rows ``x`` [R_e, H] to

    g = x W_g[e],  u = x W_u[e]        [R_e, I]
    y = (silu(g) * u) W_d[e]           [R_e, H]

Runs are uneven and may be empty; no row is dropped (``counts`` [E] holds
each run's length and the runs fill ``x`` in expert order). The backward
gives dx and every expert's dW_g, dW_u, dW_d, in fp32.

Bound (Moonlight-16B-A3B's layer at B=64, S=200: 76,800 rows, H=2,048,
I=1,408, bf16): 3 products of 2 R H I = 1.33 TFLOP forward and 2.66
backward, 1.34 / 2.69 ms at 989 TFLOP/s, against ~1.7 GB of bf16
weights, rows and intermediates moved a forward (0.5 ms at 3.35 TB/s):
bound by operations. Design (CUDA, ``csrc/expert_gemm.cu``: wgmma with
fp32 sums, on ``csrc/layer_hopper.cuh``'s product machinery): a schedule
of 128-row tiles, each inside one expert's run (built on the device from
``counts``, no host sync):

- forward: gate and up in one kernel sharing the row tile, the
  ``silu(g) * u`` epilogue from the fp32 sums (g and u stored rounded for
  the backward), then the down product;
- backward: ``dA = dy W_d[e]^T`` with the SwiGLU derivative in its
  epilogue (dg, du), ``dx = dg W_g[e]^T + du W_u[e]^T`` in one kernel, and
  the weight gradients ``act^T dy``, ``x^T dg``, ``x^T du`` by a kernel
  that takes one expert's run of rows as its contraction (an empty run
  writes zeros).

The weights enter as the fp32 master parameters: the forward casts them to
the rows' dtype once and the backward returns fp32 gradients from fp32
sums, never rounded to bf16.

Rounding points (the kernels' and the plain version's): g, u, the
activation, y, dg, du and dx are rounded to the rows' dtype; every sum is
fp32; dg and du come from the rounded g and u.

A CPU tensor runs the plain version, a loop of per-expert products with
the same rounding points; a CUDA tensor launches the kernels (bf16 only)
and counts in ``expert_mlp.launches`` / ``backward_launches``.
"""

import ctypes

import torch

BM = 128      # rows of a tile of the schedule (the kernels' block rows)
_lib = None


def _kernel_lib():
    """``csrc/expert_gemm.cu``, built (nvcc) and bound at first use."""
    global _lib
    if _lib is None:
        from bert4rec_tpu_torch.ops import kernel_build
        lib = kernel_build.load("expert_gemm")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.b4r_expert_forward.restype = ci
        # x, wg, wu, wd, g, u, act, y, tile_e, tile_r0, tile_r1, tiles, H,
        # I, stream
        lib.b4r_expert_forward.argtypes = [vp] * 11 + [ci] * 3 + [vp]
        lib.b4r_expert_backward.restype = ci
        # dy, x, wg, wu, wd, g, u, act, dg, du, dx, dwg, dwu, dwd, tile_e,
        # tile_r0, tile_r1, tiles, offsets, E, H, I, stream
        lib.b4r_expert_backward.argtypes = ([vp] * 17 + [ci, vp] + [ci] * 3
                                            + [vp])
        _lib = lib
    return _lib


# --------------------------------------------------------------------------- #
# the plain version
# --------------------------------------------------------------------------- #

def _runs(counts: torch.Tensor) -> list:
    """``(start, end)`` of each expert's run of rows (a host sync)."""
    ends = torch.cumsum(counts.long(), 0).tolist()
    return list(zip([0] + ends[:-1], ends))


def expert_mlp_plain_forward(x, counts, wg, wu, wd) -> tuple:
    """``(y, g, u, act)``: K11's forward, a loop of per-expert fp32
    products of the operands as they are (``wg``, ``wu`` [E, H, I], ``wd``
    [E, I, H] in ``x``'s dtype), rounded where the kernels round."""
    dt = x.dtype
    r, h = x.shape
    i = wg.shape[-1]
    g = x.new_empty((r, i))
    u = x.new_empty((r, i))
    act = x.new_empty((r, i))
    y = x.new_empty((r, h))
    for e, (a, b) in enumerate(_runs(counts)):
        if a == b:
            continue
        xe = x[a:b].float()
        g32 = xe @ wg[e].float()
        u32 = xe @ wu[e].float()
        g[a:b], u[a:b] = g32.to(dt), u32.to(dt)
        act[a:b] = (torch.nn.functional.silu(g32) * u32).to(dt)
        y[a:b] = (act[a:b].float() @ wd[e].float()).to(dt)
    return y, g, u, act


def expert_mlp_plain_backward(dy, x, counts, wg, wu, wd, g, u, act) -> tuple:
    """``(dx, dwg, dwu, dwd)``: K11's backward from the forward's saves;
    the weight gradients fp32 [E, ...], dx in ``x``'s dtype."""
    dt = x.dtype
    dx = torch.zeros_like(x)
    dwg = torch.zeros(wg.shape, dtype=torch.float32, device=x.device)
    dwu = torch.zeros_like(dwg)
    dwd = torch.zeros(wd.shape, dtype=torch.float32, device=x.device)
    for e, (a, b) in enumerate(_runs(counts)):
        if a == b:
            continue
        dye = dy[a:b].float()
        da = dye @ wd[e].float().T
        gs, us = g[a:b].float(), u[a:b].float()
        sig = torch.sigmoid(gs)
        dg = (da * us * (sig * (1.0 + gs * (1.0 - sig)))).to(dt)
        du = (da * (gs * sig)).to(dt)
        dx[a:b] = (dg.float() @ wg[e].float().T
                   + du.float() @ wu[e].float().T).to(dt)
        xe = x[a:b].float()
        dwd[e] = act[a:b].float().T @ dye
        dwg[e] = xe.T @ dg.float()
        dwu[e] = xe.T @ du.float()
    return dx, dwg, dwu, dwd


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

def tile_schedule(counts: torch.Tensor, rows: int, bm: int = BM) -> tuple:
    """``(tile_e, tile_r0, tile_r1)`` int32 [cdiv(rows, bm) + E]: for tile
    ``t`` its expert, first row and its run's end (``tile_e`` -1 past the
    last tile). Built on ``counts``' device without a host sync."""
    e_n = counts.numel()
    dev = counts.device
    c = counts.long()
    n = (c + bm - 1) // bm
    ends = torch.cumsum(n, 0)
    starts = torch.cumsum(c, 0) - c
    t = torch.arange(-(-rows // bm) + e_n, device=dev)
    e = torch.searchsorted(ends, t, right=True)
    ec = e.clamp(max=e_n - 1)
    r0 = starts[ec] + (t - (ends[ec] - n[ec])) * bm
    return (torch.where(e < e_n, ec, -1).to(torch.int32),
            r0.to(torch.int32), (starts[ec] + c[ec]).to(torch.int32))


def _check(x, wg):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the expert GEMM kernels take bf16 rows, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the expert GEMM kernels take contiguous rows")
    h, i = wg.shape[1], wg.shape[2]
    if h % 8 or i % 8:
        raise ValueError(f"the expert GEMM kernels take H and I multiples "
                         f"of 8, got {h} and {i}")
    if x.shape[0] >= 2 ** 31 // max(h, i):
        raise ValueError(f"too many rows for 32-bit tile indices: "
                         f"{x.shape[0]}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _raise(err, what):
    if err != 0:
        raise RuntimeError(f"expert GEMM {what} launch failed: CUDA error "
                           f"{err}")


def _launch_forward(x, counts, wg, wu, wd):
    """K11's forward kernels: ``(y, g, u, act, schedule)``."""
    _check(x, wg)
    r, h = x.shape
    i = wg.shape[-1]
    sched = tile_schedule(counts, r)
    g, u, act = (x.new_empty((r, i)) for _ in range(3))
    y = x.new_empty((r, h))
    if r:
        _raise(_kernel_lib().b4r_expert_forward(
            *map(_ptr, (x, wg, wu, wd, g, u, act, y, *sched)),
            sched[0].numel(), h, i,
            torch.cuda.current_stream(x.device).cuda_stream), "forward")
    return y, g, u, act, sched


def _launch_backward(dy, x, counts, wg, wu, wd, g, u, act, sched):
    """K11's backward kernels: ``(dx, dwg, dwu, dwd)``."""
    dy = dy.contiguous()
    r, h = x.shape
    e_n, _, i = wg.shape
    dg, du = x.new_empty((r, i)), x.new_empty((r, i))
    dx = x.new_empty((r, h))
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts, 0)]).to(torch.int32)
    dwd = torch.empty((e_n, i, h), dtype=torch.float32, device=x.device)
    dwg = torch.empty((e_n, h, i), dtype=torch.float32, device=x.device)
    dwu = torch.empty_like(dwg)
    _raise(_kernel_lib().b4r_expert_backward(
        *map(_ptr, (dy, x, wg, wu, wd, g, u, act, dg, du, dx, dwg, dwu, dwd,
                    *sched)),
        sched[0].numel(), _ptr(offsets), e_n, h, i,
        torch.cuda.current_stream(x.device).cuda_stream), "backward")
    return dx, dwg, dwu, dwd


class _ExpertMLP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, counts, w_gate, w_up, w_down):
        wg, wu, wd = (w.to(x.dtype).contiguous()
                      for w in (w_gate, w_up, w_down))
        if x.device.type == "cpu":
            y, g, u, act = expert_mlp_plain_forward(x, counts, wg, wu, wd)
            sched = ()
        else:
            y, g, u, act, sched = _launch_forward(x, counts, wg, wu, wd)
            expert_mlp.launches += 1
        ctx.save_for_backward(x, counts, wg, wu, wd, g, u, act, *sched)
        ctx.w_dtype = w_gate.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, counts, wg, wu, wd, g, u, act, *sched = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dwg, dwu, dwd = expert_mlp_plain_backward(
                dy, x, counts, wg, wu, wd, g, u, act)
        else:
            dx, dwg, dwu, dwd = _launch_backward(
                dy, x, counts, wg, wu, wd, g, u, act, tuple(sched))
            expert_mlp.backward_launches += 1
        dt = ctx.w_dtype
        return dx, None, dwg.to(dt), dwu.to(dt), dwd.to(dt)


def expert_mlp(x: torch.Tensor, counts: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts over rows sorted by expert: ``x`` [R, H] (the
    compute dtype), ``counts`` [E] int32 rows per expert (summing to R),
    ``w_gate`` / ``w_up`` [E, H, I] and ``w_down`` [E, I, H] (any float
    dtype; cast to ``x``'s). Returns ``y`` [R, H]; differentiable in
    ``x`` and the weights. A CUDA launch counts in ``expert_mlp.launches``
    (forward) and ``expert_mlp.backward_launches``."""
    e_n, h, i = w_gate.shape
    if x.dim() != 2 or x.shape[1] != h or w_up.shape != w_gate.shape \
            or tuple(w_down.shape) != (e_n, i, h) \
            or tuple(counts.shape) != (e_n,):
        raise ValueError(f"expert_mlp: x {tuple(x.shape)}, counts "
                         f"{tuple(counts.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, "
                         f"w_down {tuple(w_down.shape)}")
    if not all(t.device == x.device for t in (counts, w_gate, w_up, w_down)):
        raise ValueError("expert_mlp: operands on different devices")
    return _ExpertMLP.apply(x, counts.to(torch.int32), w_gate, w_up, w_down)


expert_mlp.launches = 0
expert_mlp.backward_launches = 0
