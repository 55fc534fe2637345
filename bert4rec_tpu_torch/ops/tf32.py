"""The 3xTF32 rounding law of the port's fp32 tensor-core kernels
(``csrc/tf32.cuh``: the inference layer ``csrc/layer_tf32.cu`` and the
vocab-tiled loss backwards ``csrc/loss_tf32.cuh``), emulated on any device.

Each fp32 operand is split into ``hi = rna(v)`` and ``lo = rna(v - hi)``,
where ``rna`` is PTX's ``cvt.rna.tf32.f32``, and a product accumulates
``lo_a hi_b + hi_a lo_b``, then ``hi_a hi_b``, in fp32. The tests hold
the kernels' arithmetic to the JAX fp32 references through these
functions before any card time; the kernels' own sums run in another
order inside the tensor cores."""

import torch


def rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """PTX's ``cvt.rna.tf32.f32`` on the tensor's bits: 13 low mantissa
    bits rounded off, to nearest, ties away from zero (the sign and
    magnitude are apart, so adding half an ulp to the magnitude rounds away
    from zero in both signs)."""
    u = t.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(t: torch.Tensor):
    """``(hi, lo)``: ``hi = rna(t)``, ``lo = rna(t - hi)``."""
    hi = rna_tf32(t)
    return hi, rna_tf32(t - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels take it: ``lo_a hi_b + hi_a lo_b`` first,
    ``hi_a hi_b`` last, in fp32."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One pass of TF32, for contrast: what the kernels do not do."""
    return rna_tf32(a) @ rna_tf32(b)
