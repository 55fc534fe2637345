"""Unfused transformer encoder block (port of
``bert4rec_tpu/models/components/transformer.py``), used when the encoder
does not route a layer to the fused kernel.

Post-LN by default:

    y = LN(x + MHA(x))
    out = LN(y + FFN(y))

The param layout is the JAX package's: qkv kernel ``[H, 3, N, D]`` and
bias ``[3, N, D]``, output kernel ``[N, D, H]``. In training, dropout
falls where the JAX block puts it: on the attention probabilities and on
both sublayer outputs (JAX ``transformer.py:113,145,156``), with seeds
``fold_in(seed, 0..2)``; autograd does the backward. Causal attention
(SASRec) reaches the block as a triangle the caller has folded into
``attn_bias`` (``[B, 1, S, S]``), as the JAX encoder folds it. No
``query_range`` slicing and no flash-attention dispatch yet.
"""

import math
from typing import Optional

import torch

from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.ops.dropout_bits import fold_in


def init_transformer_block(generator, hidden_size: int, num_heads: int,
                           inner_dim: int, stddev: float,
                           device="cpu") -> dict:
    head_dim = hidden_size // num_heads
    return {
        "attention": {
            "qkv": {
                "kernel": L.truncated_normal_init(
                    generator, (hidden_size, 3, num_heads, head_dim), stddev,
                    device),
                "bias": torch.zeros((3, num_heads, head_dim),
                                    dtype=torch.float32, device=device),
            },
            "output": {
                "kernel": L.truncated_normal_init(
                    generator, (num_heads, head_dim, hidden_size), stddev,
                    device),
                "bias": torch.zeros((hidden_size,), dtype=torch.float32,
                                    device=device),
            },
        },
        "attention_norm": L.init_layer_norm(hidden_size, device),
        "intermediate": L.init_dense(generator, hidden_size, inner_dim,
                                     stddev, device),
        "output": L.init_dense(generator, inner_dim, hidden_size, stddev,
                               device),
        "output_norm": L.init_layer_norm(hidden_size, device),
    }


def _attention(params: dict, x: torch.Tensor, attn_bias: torch.Tensor,
               *, compute_dtype, attention_dropout: float = 0.0,
               seed: Optional[int] = None) -> torch.Tensor:
    """Multi-head self-attention with an additive bias ``[B, 1, 1, S]``
    (or ``[B, 1, S, S]`` with a causal triangle). Scores and softmax in
    fp32; products in ``compute_dtype``."""
    head_dim = params["qkv"]["kernel"].shape[-1]
    qkv_kernel = params["qkv"]["kernel"].to(compute_dtype)
    qkv_bias = params["qkv"]["bias"].to(compute_dtype)

    kv = torch.einsum("bsh,htnd->tbsnd", x.to(compute_dtype), qkv_kernel) \
        + qkv_bias[:, None, None]
    q, k, v = kv[0], kv[1], kv[2]

    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    scores = scores + attn_bias
    probs = torch.softmax(scores, dim=-1)
    probs = L.dropout(probs, attention_dropout, seed).to(compute_dtype)

    context = torch.einsum("bnqk,bknd->bqnd", probs, v)
    out = torch.einsum("bqnd,ndh->bqh", context,
                       params["output"]["kernel"].to(compute_dtype))
    return out + params["output"]["bias"].to(compute_dtype)


def transformer_block(params: dict, x: torch.Tensor, attn_bias: torch.Tensor,
                      *, inner_activation, norm_first: bool = False,
                      compute_dtype=torch.float32,
                      output_dropout: float = 0.0,
                      attention_dropout: float = 0.0,
                      seed: Optional[int] = None,
                      training: bool = False) -> torch.Tensor:
    """One block; dropout only when ``training`` and ``seed`` is given."""
    seeds = ([fold_in(seed, i) for i in range(3)]
             if training and seed is not None else [None] * 3)
    attn_in = L.layer_norm(params["attention_norm"], x) if norm_first else x
    attn_out = _attention(params["attention"], attn_in, attn_bias,
                          compute_dtype=compute_dtype,
                          attention_dropout=attention_dropout,
                          seed=seeds[0])
    attn_out = L.dropout(attn_out, output_dropout, seeds[1])
    if norm_first:
        y = x + attn_out
        ffn_in = L.layer_norm(params["output_norm"], y)
    else:
        y = L.layer_norm(params["attention_norm"], x + attn_out)
        ffn_in = y

    h = L.dense(params["intermediate"], ffn_in, compute_dtype)
    h = inner_activation(h)
    h = L.dense(params["output"], h, compute_dtype)
    h = L.dropout(h, output_dropout, seeds[2])
    if norm_first:
        return y + h
    return L.layer_norm(params["output_norm"], y + h)
