"""Primitive layers as (init, apply) function pairs over dict params
(port of ``bert4rec_tpu/models/components/layers.py``).

Params are nested dicts of tensors with the JAX package's paths and
shapes, so a checkpoint carries across unchanged. Params live in fp32;
matmuls run in ``compute_dtype``; layer norm accumulates in fp32.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from bert4rec_tpu_torch.ops.table_gradient import table_gather

LN_EPSILON = 1e-12  # reference LayerNorm epsilon


def truncated_normal_init(generator: Optional[torch.Generator], shape,
                          stddev: float, device="cpu",
                          dtype=torch.float32) -> torch.Tensor:
    """TF-style TruncatedNormal: a standard normal cut at +-2 sigma, then
    scaled (no variance correction). Sampled in fp32 on the CPU from
    ``generator`` so a seed gives the same params on every device, then
    cast to ``dtype`` and scaled there (JAX's order); ``device="meta"``
    gives shapes only (the load-time structure check)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return (out.to(dtype) * stddev).to(device)


# --------------------------------------------------------------------------- #
# dense
# --------------------------------------------------------------------------- #

def init_dense(generator, in_dim: int, out_dim: int, stddev: float,
               device="cpu") -> dict:
    return {
        "kernel": truncated_normal_init(generator, (in_dim, out_dim), stddev,
                                        device),
        "bias": torch.zeros((out_dim,), dtype=torch.float32, device=device),
    }


def dense(params: dict, x: torch.Tensor,
          compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ kernel + bias`` with the output in ``compute_dtype``."""
    kernel = params["kernel"].to(compute_dtype)
    y = torch.matmul(x.to(compute_dtype), kernel)
    return y + params["bias"].to(compute_dtype)


# --------------------------------------------------------------------------- #
# dropout
# --------------------------------------------------------------------------- #

def dropout(x: torch.Tensor, rate: float, seed: Optional[int] = None,
            training: bool = True) -> torch.Tensor:
    """Inverted dropout (the JAX ``dropout``): each element is kept with
    probability ``1 - rate`` and divided by it. The mask is drawn from a
    ``torch.Generator`` on ``x``'s device seeded with ``seed``, so a seed
    gives the same mask on every call; identity when not ``training``,
    when ``seed`` is None or when ``rate`` is 0 (no seed means no dropout,
    as no rng does in JAX). JAX's order is ``(rng, x, rate, training)``."""
    if not training or seed is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    kept = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


# --------------------------------------------------------------------------- #
# layer norm — fp32 accumulation
# --------------------------------------------------------------------------- #

def init_layer_norm(dim: int, device="cpu") -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layer_norm(params: dict, x: torch.Tensor,
               epsilon: float = LN_EPSILON) -> torch.Tensor:
    orig_dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + epsilon)
    y = y * params["scale"] + params["bias"]
    return y.to(orig_dtype)


# --------------------------------------------------------------------------- #
# embeddings
# --------------------------------------------------------------------------- #

def init_embedding(generator, vocab_size: int, width: int, stddev: float,
                   device="cpu") -> dict:
    return {"embedding": truncated_normal_init(
        generator, (vocab_size, width), stddev, device)}


def embedding_lookup(params: dict, ids: torch.Tensor,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """Gather rows of a dense (``embedding``) or int8 weights-only
    quantized (``embedding_q`` + ``embedding_scale``, models/quantization.py)
    table; quantized rows are scaled after the gather, so only the touched
    rows pay the multiply. A dense table's gather is
    ``ops.table_gradient.table_gather``: its backward, when there is one,
    is the table-gradient kernel."""
    if "embedding_q" in params:
        idx = ids.long()
        rows = params["embedding_q"][idx].to(compute_dtype)
        scale = params["embedding_scale"][idx].to(compute_dtype)
        return rows * scale[..., None]
    return table_gather(params["embedding"], ids, compute_dtype)


def sharded_embedding_lookup(params: dict, ids: torch.Tensor, mesh,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """Rows of a table row-sharded on ``mesh``'s 'model' axis (``params``
    holds this rank's block): each rank gathers the rows it owns, zeros
    elsewhere, and the pieces are summed over 'model' (what GSPMD does to
    JAX's ``jnp.take`` on the sharded table). The backward reaches only
    the owned rows of the local block (``table_gather``'s kernel; the
    rows it does not own read local row 0 and add it zeros); the [PAD] row
    keeps its gradient, as in JAX (no ``padding_idx``)."""
    from bert4rec_tpu_torch.core import mesh as mesh_lib
    table = params["embedding"]
    v_local = table.shape[0]
    local = ids.to(torch.int32) - mesh.index(mesh_lib.MODEL_AXIS) * v_local
    owned = (local >= 0) & (local < v_local)
    rows = table_gather(table, torch.where(owned, local,
                                           torch.zeros_like(local)),
                        table.dtype)
    rows = torch.where(owned[..., None], rows, torch.zeros_like(rows))
    return mesh_lib.psum(mesh, rows, mesh_lib.MODEL_AXIS).to(compute_dtype)


def quantize_embedding(params: dict) -> dict:
    """Weights-only int8 quantization of an embedding table, symmetric
    per-row (per-item) scales: ``q = round(row / s)`` (half to even, as
    ``jnp.round``), ``s = max|row| / 127`` (at least float32's smallest
    normal). Per-row scales keep the tied-softmax math exact to apply
    after the logits product (``(h @ q^T) * s == h @ (q * s)^T``)."""
    table = params["embedding"].detach().float()
    scale = table.abs().amax(dim=1) / 127.0
    scale = torch.clamp(scale, min=torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(table / scale[:, None]), -127, 127) \
        .to(torch.int8)
    return {"embedding_q": q, "embedding_scale": scale}


def dequantize_embedding(params: dict, dtype=torch.float32) -> torch.Tensor:
    """Dense ``[V, W]`` table from a quantized one (the fallback of paths
    without a quantized fast path)."""
    return (params["embedding_q"].to(dtype)
            * params["embedding_scale"][:, None].to(dtype))


def init_position_embedding(generator, max_length: int, width: int,
                            stddev: float, device="cpu") -> dict:
    return {"embedding": truncated_normal_init(
        generator, (max_length, width), stddev, device)}


def position_embedding(params: dict, seq_len: int,
                       compute_dtype=torch.float32) -> torch.Tensor:
    return params["embedding"][:seq_len].to(compute_dtype)


# --------------------------------------------------------------------------- #
# activations — "gelu" is the exact (erf) form, "gelu_approx" the tanh form,
# as in the JAX package. The fused encoder layer computes tanh gelu whatever
# this table says (see ops/fused_encoder_layer.py).
# --------------------------------------------------------------------------- #

_ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_approx": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "tanh": torch.tanh,
    "linear": lambda x: x,
}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")


# --------------------------------------------------------------------------- #
# attention mask
# --------------------------------------------------------------------------- #

def self_attention_mask(input_mask: torch.Tensor) -> torch.Tensor:
    """2-D pad mask ``[B, S]`` -> additive fp32 bias ``[B, 1, 1, S]``:
    0 for real tokens, -1e9 for padding."""
    zero = torch.zeros((), dtype=torch.float32, device=input_mask.device)
    neg = torch.full((), -1e9, dtype=torch.float32, device=input_mask.device)
    return torch.where(input_mask[:, None, None, :] > 0, zero, neg)
