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
(SASRec) reaches the plain attention as a triangle the caller has folded
into ``attn_bias`` (``[B, 1, S, S]``), as the JAX encoder folds it.

``use_flash`` sends the attention core to ``ops/flash_attention.py``
(K8/K9) when no query slicing is asked for and an ``input_mask`` is given,
as JAX's ``_attention`` does (:81-101); the kernel then builds the causal
triangle itself and draws the probability dropout from the block's
attention seed (``fold_in(seed, 0)``, JAX's ``rngs[0]``) instead of
``L.dropout``. ``query_range`` (the encoder's last-layer ``output_range``)
cuts the queries and the residual stream to the first positions while keys
and values span the sequence, and cuts a dense ``[B, 1, S, S]`` bias to
the query rows (JAX :69-79, :106-110).
"""

import math
from typing import Optional

import torch

from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.ops.dropout_bits import fold_in
from bert4rec_tpu_torch.ops.flash_attention import flash_attention


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
               seed: Optional[int] = None,
               query_range: Optional[int] = None, use_flash: bool = False,
               input_mask: Optional[torch.Tensor] = None,
               causal: bool = False) -> torch.Tensor:
    """Multi-head self-attention with an additive bias ``[B, 1, 1, S]``
    (or ``[B, 1, S, S]`` with a causal triangle). Scores and softmax in
    fp32; products in ``compute_dtype``."""
    head_dim = params["qkv"]["kernel"].shape[-1]
    qkv_kernel = params["qkv"]["kernel"].to(compute_dtype)
    qkv_bias = params["qkv"]["bias"].to(compute_dtype)

    x = x.to(compute_dtype)
    # fused projection: keys and values from the full sequence
    kv = torch.einsum("bsh,htnd->tbsnd", x, qkv_kernel) \
        + qkv_bias[:, None, None]
    if query_range is None:
        q = kv[0]
    else:
        q = torch.einsum("bsh,hnd->bsnd", x[:, :query_range],
                         qkv_kernel[:, 0]) + qkv_bias[0][None, None]
    k, v = kv[1], kv[2]
    out_kernel = params["output"]["kernel"].to(compute_dtype)
    out_bias = params["output"]["bias"].to(compute_dtype)

    if use_flash and query_range is None and input_mask is not None:
        # no seed, no dropout (JAX: no rng); the kernel's own masks
        context = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            input_mask, dropout_rate=attention_dropout, seed=seed,
            causal=causal).transpose(1, 2)
        out = torch.einsum("bqnd,ndh->bqh", context.to(compute_dtype),
                           out_kernel)
        return out + out_bias

    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if query_range is not None and attn_bias.dim() >= 3 \
            and attn_bias.shape[-2] not in (1, scores.shape[-2]):
        # a dense [B, 1, S, S] bias (the causal triangle): cut its query
        # rows to the sliced scores
        attn_bias = attn_bias[..., :query_range, :]
    scores = scores + attn_bias
    probs = torch.softmax(scores, dim=-1)
    probs = L.dropout(probs, attention_dropout, seed).to(compute_dtype)

    context = torch.einsum("bnqk,bknd->bqnd", probs, v)
    out = torch.einsum("bqnd,ndh->bqh", context, out_kernel)
    return out + out_bias


def transformer_block(params: dict, x: torch.Tensor, attn_bias: torch.Tensor,
                      *, num_heads: Optional[int] = None, inner_activation,
                      norm_first: bool = False,
                      compute_dtype=torch.float32,
                      output_dropout: float = 0.1,
                      attention_dropout: float = 0.1,
                      seed: Optional[int] = None,
                      training: bool = False,
                      query_range: Optional[int] = None,
                      use_flash: bool = False,
                      input_mask: Optional[torch.Tensor] = None,
                      causal: bool = False) -> torch.Tensor:
    """One block; dropout only when ``training`` and ``seed`` is given,
    at JAX's default rates (0.1 / 0.1). ``num_heads`` (JAX's keyword)
    must agree with the heads of the qkv kernel ``[H, 3, N, D]``, which
    the port reads the count from. With ``query_range`` the output holds
    the first ``query_range`` positions only."""
    heads = params["attention"]["qkv"]["kernel"].shape[2]
    if num_heads is not None and num_heads != heads:
        raise ValueError(f"num_heads={num_heads}, but the block's qkv "
                         f"kernel holds {heads} heads")
    seeds = ([fold_in(seed, i) for i in range(3)]
             if training and seed is not None else [None] * 3)
    residual = x if query_range is None else x[:, :query_range]
    attn_in = L.layer_norm(params["attention_norm"], x) if norm_first else x
    attn_out = _attention(params["attention"], attn_in, attn_bias,
                          compute_dtype=compute_dtype,
                          attention_dropout=attention_dropout,
                          seed=seeds[0], query_range=query_range,
                          use_flash=use_flash, input_mask=input_mask,
                          causal=causal)
    attn_out = L.dropout(attn_out, output_dropout, seeds[1])
    if norm_first:
        y = residual + attn_out
        ffn_in = L.layer_norm(params["output_norm"], y)
    else:
        y = L.layer_norm(params["attention_norm"], residual + attn_out)
        ffn_in = y

    h = L.dense(params["intermediate"], ffn_in, compute_dtype)
    h = inner_activation(h)
    h = L.dense(params["output"], h, compute_dtype)
    h = L.dropout(h, output_dropout, seeds[2])
    if norm_first:
        return y + h
    return L.layer_norm(params["output_norm"], y + h)
