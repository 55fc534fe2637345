"""The trainer's update: optax's ``chain(clip_by_global_norm, adamw)`` over
a list of leaves, in place.

    norm = sqrt(sum over every leaf of sum(g * g))
    g    = g where norm < clip, else g / norm * clip     (optax's clip)
    m    = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2
    u    = (m / bc1) / (sqrt(v / bc2) + eps) + wd p      (wd on decayed leaves)
    p   -= lr u

``p``, ``m`` and ``v`` are fp32 and updated in place; ``g`` is fp32 or bf16
(another dtype is cast to fp32 first). Every sum and the update are fp32.

Replaces no TPU kernel: the JAX package leaves optax's chain to XLA. On the
card it replaces the plain version below, a per-leaf clip and eleven foreach
operations, which wrote the clipped gradient and three fp32 temporaries a
leaf: ~150 bytes moved an element (133 ms of moonlight_5L's 360 ms step over
2.48 B parameters) and ~1,100 launches a step at bert_base_512.

A CUDA tensor launches ``csrc/adamw.cu`` (K12), three kernels a step
whatever the number of leaves: each leaf's sum of squares in fixed-size
chunks, the per-leaf sums and the norm, then the update of every element
(read p, g, m, v once, write p, m, v once). Its bound is 32 bytes an
element, g read twice (79.4 GB, 23.7 ms at 3.35 TB/s, at moonlight_5L). No
float atomics, so two calls give the same bits. The kernels write the
tensors through their pointers, so autograd's version counters of ``p``,
``m`` and ``v`` do not move. A CPU tensor runs the plain version.

With ``sq_norm`` (a mesh), the kernels' per-leaf sums go to the hook, one
0-d fp32 tensor a leaf, and the square root of what it returns clips.
"""

import ctypes
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

# elements of a chunk: a block of the kernels (csrc/adamw.cu kChunk)
CHUNK = 1 << 16
# the table's flags (csrc/adamw.cu Leaf::flags)
DECAY, BF16 = 1, 2
# int64 a leaf's row: p, g, m, v, elements, flags
ROW = 6


class Hyper(NamedTuple):
    """One update's scalars: the step's rate and Adam's bias corrections
    (``1 - b ** count``), and the optimizer's constants."""
    lr: float
    bc1: float
    bc2: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    clip: float


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from bert4rec_tpu_torch.ops import kernel_build
        lib = kernel_build.load("adamw")
        vp, ci, ll, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
        lib.b4r_adamw_norm.restype = ci
        # leaves, begin, n_leaves, n_chunks, partial, sums, norm, stream
        lib.b4r_adamw_norm.argtypes = [vp, vp, ci, ll, vp, vp, vp, vp]
        lib.b4r_adamw_update.restype = ci
        # leaves, begin, n_leaves, n_chunks, norm, lr, b1, 1 - b1, b2,
        # 1 - b2, eps, wd, bc1, bc2, clip, stream
        lib.b4r_adamw_update.argtypes = [vp, vp, ci, ll, vp] + [cf] * 10 + [vp]
        _lib = lib
    return _lib


def leaf_table(numels: Sequence[int], pointers: Sequence[Sequence[int]],
               decay: Sequence[bool], bf16: Sequence[bool]) -> np.ndarray:
    """The kernels' table, int64: a row of ``ROW`` a leaf (the addresses
    of p, g, m and v, the element count, the flags ``DECAY`` and ``BF16``),
    then ``begin``, each leaf's first chunk and last the chunk count. Leaf
    ``i`` owns chunks ``begin[i] .. begin[i + 1] - 1``, each ``CHUNK``
    elements of it but the last, so no chunk crosses a leaf; an empty leaf
    owns none."""
    n = len(numels)
    counts = np.asarray(numels, dtype=np.int64).reshape(n)
    rows = np.empty((n, ROW), dtype=np.int64)
    rows[:, :4] = np.asarray(pointers, dtype=np.int64).reshape(n, 4)
    rows[:, 4] = counts
    rows[:, 5] = (np.asarray(decay, dtype=bool) * DECAY
                  + np.asarray(bf16, dtype=bool) * BF16)
    begin = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(-(-counts // CHUNK), out=begin[1:])
    return np.concatenate([rows.reshape(-1), begin])


def adamw_update(p: List[torch.Tensor], g: List[torch.Tensor],
                 m: List[torch.Tensor], v: List[torch.Tensor],
                 decay: Sequence[bool], hyper: Hyper,
                 sq_norm: Optional[Callable] = None) -> torch.Tensor:
    """The clip and AdamW update of the leaves ``p`` (moments ``m``, ``v``)
    by their gradients ``g``, in place; ``decay[i]`` puts weight decay on
    leaf ``i``. ``sq_norm`` maps the list of per-leaf sums of squares to
    the global squared norm (default: their sum). Returns the norm that
    clipped, a 0-d fp32 tensor on the leaves' device. A CUDA tensor launches
    the kernels (counted in ``adamw_update.launches``, three a call, and
    ``adamw_update.elements``) or raises; a CPU tensor runs
    ``adamw_update_plain``."""
    if p[0].device.type == "cpu":
        return adamw_update_plain(p, g, m, v, decay, hyper, sq_norm)
    return _launch(p, g, m, v, decay, hyper, sq_norm)


adamw_update.launches = 0
adamw_update.elements = 0


def _launch(p, g, m, v, decay, hyper, sq_norm) -> torch.Tensor:
    device = p[0].device
    f32, bf16 = torch.float32, torch.bfloat16
    grads = []
    for i, (a, b, c, d) in enumerate(zip(p, g, m, v)):
        if not all(t.device == device and t.dtype == f32 and t.is_contiguous()
                   for t in (a, c, d)):
            raise ValueError(f"leaf {i}: the update kernel takes contiguous "
                             f"fp32 params and moments on {device}")
        if b.device != device or not a.numel() == b.numel() == c.numel() \
                == d.numel():
            raise ValueError(f"leaf {i}: the gradient, params and moments "
                             f"differ in device or size")
        if b.dtype not in (f32, bf16):
            b = b.float()
        grads.append(b.contiguous())
    numels = [t.numel() for t in p]
    table = leaf_table(
        numels, [(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr())
                 for a, b, c, d in zip(p, grads, m, v)],
        [bool(x) and bool(hyper.weight_decay) for x in decay],
        [b.dtype == bf16 for b in grads])
    n, n_chunks = len(p), int(table[-1])
    if n_chunks == 0:
        return torch.zeros((), dtype=f32, device=device)
    # the table goes up through pinned memory: the caching host allocator
    # keeps the buffer until the copy has run, and the copy does not block
    host = torch.empty(table.size, dtype=torch.int64, pin_memory=True)
    host.numpy()[:] = table
    table_dev = torch.empty(table.size, dtype=torch.int64, device=device)
    table_dev.copy_(host, non_blocking=True)
    leaves = table_dev.data_ptr()
    begin = leaves + 8 * ROW * n
    partial = torch.empty(n_chunks, dtype=f32, device=device)
    sums = torch.empty(n, dtype=f32, device=device)
    norm = torch.empty((), dtype=f32, device=device)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.b4r_adamw_norm(leaves, begin, n, n_chunks, partial.data_ptr(),
                             sums.data_ptr(), norm.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"adamw norm kernels' launch failed: CUDA error "
                           f"{err}")
    if sq_norm is not None:
        norm = sq_norm(list(sums.unbind())).to(f32).sqrt().contiguous()
    h = hyper
    err = lib.b4r_adamw_update(
        leaves, begin, n, n_chunks, norm.data_ptr(), h.lr, h.b1, 1.0 - h.b1,
        h.b2, 1.0 - h.b2, h.eps, h.weight_decay, h.bc1, h.bc2, h.clip, stream)
    if err != 0:
        raise RuntimeError(f"adamw update kernel's launch failed: CUDA error "
                           f"{err}")
    adamw_update.launches += 3
    adamw_update.elements += sum(numels)
    return norm


@torch.no_grad()
def adamw_update_plain(p, g, m, v, decay, hyper: Hyper,
                       sq_norm: Optional[Callable] = None) -> torch.Tensor:
    """The plain version: the clip, then foreach operations over groups of
    at most ``GROUP_ELEMENTS`` elements. Returns the norm."""
    g = [t.float() for t in g]
    # clip_by_global_norm: sqrt of the sum of every leaf's sum of squares;
    # untouched below the bound, t / norm * bound at or above
    sums = [(t * t).sum() for t in g]
    norm = (sq_norm(sums) if sq_norm is not None
            else torch.stack(sums).sum()).sqrt()
    below = norm < hyper.clip
    for group in _groups(g):
        _step(*([x[i] for i in group] for x in (p, g, m, v, decay)), hyper,
              norm, below)
    return norm


def _step(p, g, m, v, decay, hyper, norm, below) -> None:
    """The clip and the AdamW update of one group of leaves, in place."""
    g = [torch.where(below, t, t / norm * hyper.clip) for t in g]
    torch._foreach_mul_(m, hyper.b1)
    torch._foreach_add_(m, g, alpha=1.0 - hyper.b1)
    torch._foreach_mul_(v, hyper.b2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - hyper.b2)
    mu_hat = torch._foreach_div(m, hyper.bc1)
    den = torch._foreach_div(v, hyper.bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, hyper.eps)
    upd = torch._foreach_div(mu_hat, den)
    on = [i for i, d in enumerate(decay) if d]
    if hyper.weight_decay and on:
        torch._foreach_add_([upd[i] for i in on], [p[i] for i in on],
                            alpha=hyper.weight_decay)
    torch._foreach_add_(p, upd, alpha=-hyper.lr)


# elements of the leaves one pass of the plain update takes: its clipped
# gradients and Adam's temporaries (four fp32 copies) stay within 4 x 4
# bytes of this, so a model of billions of parameters updates without
# four copies of itself; any model under it updates in one pass
GROUP_ELEMENTS = 1 << 28


def _groups(g: list) -> list:
    """Consecutive runs of leaf indices, each of at most ``GROUP_ELEMENTS``
    elements (a larger leaf alone)."""
    out, run, size = [], [], 0
    for i, t in enumerate(g):
        if run and size + t.numel() > GROUP_ELEMENTS:
            out.append(run)
            run, size = [], 0
        run.append(i)
        size += t.numel()
    return out + [run] if run else out
