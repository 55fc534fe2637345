"""BERT4Rec's training loss in plain float32 PyTorch.

Embeddings (item + learned position) -> LayerNorm (eps 1e-12) -> dropout
-> ``layers`` post-LN BERT blocks -> the MLM head (gather the masked
positions, dense, gelu, LayerNorm, the tied item table, an output bias) ->
the mean cross-entropy over the positions whose label is not 0.

Two blocks are written out, by the route the configuration states:
``fused`` (the fused encoder layer's definition: tanh-approximate gelu in
the FFN, hash dropout on the probabilities and both sublayer outputs, all
from the layer's seed) and ``block`` (the unfused block: exact gelu,
probabilities dropped by the hash law under flash attention or by the
generator law otherwise, sublayer outputs by the generator law from the
block's second and third seeds). ``mm`` takes every product, so the
control can run the same model with its operands rounded lower.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference import laws

NEG = -1e9
EPS = 1e-12


def layer_norm(x, p):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * p["scale"] + p["bias"]


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def block(p, x, mask, seed, cfg, route, mm):
    """One post-LN encoder block at training rates (``seed`` None: at
    inference, no dropout)."""
    b, s, h = x.shape
    n = cfg["num_attention_heads"]
    d = h // n
    a_rate, o_rate = cfg["attention_dropout"], cfg["output_dropout"]
    if seed is None:
        attn_keep = keep_attn_out = keep_ffn = 1.0
        act = gelu_tanh if route == "fused" else (
            lambda t: F.gelu(t, approximate="none"))
    elif route == "fused":
        attn_keep = laws.hash_keep(seed, b, range(n), s, s, a_rate, x.device)
        out_keep = laws.hash_keep(seed, b, (n, n + 1), s, h, o_rate,
                                  x.device)
        keep_attn_out, keep_ffn = out_keep[:, 0], out_keep[:, 1]
        act = gelu_tanh
    else:
        sub = [laws.fold_in(seed, i) for i in range(3)]
        attn_keep = (laws.hash_keep(sub[0], b, range(n), s, s, a_rate,
                                    x.device)
                     if cfg.get("use_flash_attention") else
                     laws.rand_keep(sub[0], (b, n, s, s), a_rate, x.device))
        keep_attn_out = laws.rand_keep(sub[1], (b, s, h), o_rate, x.device)
        keep_ffn = laws.rand_keep(sub[2], (b, s, h), o_rate, x.device)
        act = lambda t: F.gelu(t, approximate="none")  # noqa: E731
    att = p["attention"]
    qkv = mm(x, att["qkv"]["kernel"].reshape(h, 3 * h)) \
        + att["qkv"]["bias"].reshape(3 * h)
    q, k, v = (t.reshape(b, s, n, d).transpose(1, 2)
               for t in qkv.split(h, dim=-1))
    bias = torch.where(mask > 0, 0.0, NEG)[:, None, None, :]
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d) + bias
    probs = torch.softmax(scores, dim=-1) * attn_keep
    ctx = mm(probs, v).transpose(1, 2).reshape(b, s, h)
    out = mm(ctx, att["output"]["kernel"].reshape(h, h)) \
        + att["output"]["bias"]
    y = layer_norm(x + out * keep_attn_out, p["attention_norm"])
    f = act(mm(y, p["intermediate"]["kernel"]) + p["intermediate"]["bias"])
    f = mm(f, p["output"]["kernel"]) + p["output"]["bias"]
    return layer_norm(y + f * keep_ffn, p["output_norm"])


def encode(params, ids, mask, cfg, step_seed, route, mm=torch.matmul):
    """The encoder's output ``[B, S, H]`` (``step_seed`` None: no
    dropout)."""
    enc = params["encoder"]
    x = enc["item_embeddings"]["embedding"][ids.long()] \
        + enc["position_embeddings"]["embedding"][:ids.shape[1]]
    x = layer_norm(x, enc["embedding_norm"])
    if step_seed is not None:
        x = x * laws.rand_keep(laws.fold_in(step_seed, 0), x.shape,
                               cfg["output_dropout"], x.device)
    for i in range(cfg["num_layers"]):
        seed = None if step_seed is None else laws.fold_in(step_seed, 1 + i)
        x = block(enc["layers"][f"layer_{i}"], x, mask, seed, cfg, route,
                  mm)
    return x


def logits(params, x, pos, mm=torch.matmul):
    """The MLM head over the positions ``pos [B, P]``: ``[B, P, V]``."""
    hid = torch.gather(x, 1, pos.long()[..., None].expand(-1, -1,
                                                           x.shape[-1]))
    mlm = params["mlm"]
    hid = F.gelu(mm(hid, mlm["transform"]["kernel"])
                 + mlm["transform"]["bias"], approximate="none")
    hid = layer_norm(hid, mlm["transform_norm"])
    return mm(hid, params["encoder"]["item_embeddings"]["embedding"].T) \
        + mlm["output_bias"]


def loss(params, batch, cfg, step_seed, route, mm=torch.matmul,
         rows=None):
    """The mean masked cross-entropy of one training batch (dropout on).
    ``rows`` keeps only those batch rows (the half-batch fault)."""
    ids, mask = batch["input_word_ids"], batch["input_mask"]
    pos, labels = batch["masked_lm_positions"], batch["masked_lm_ids"].long()
    if rows is not None:
        ids, mask, pos, labels = ids[rows], mask[rows], pos[rows], labels[rows]
    x = encode(params, ids, mask, cfg, step_seed, route, mm)
    nll = -torch.log_softmax(logits(params, x, pos, mm), -1).gather(
        -1, labels[..., None])[..., 0]
    valid = (labels != 0).to(nll.dtype)
    return (nll * valid).sum() / valid.sum().clamp(min=1.0)


class _Round(torch.autograd.Function):
    """An operand rounded to float8 e4m3 with a per-tensor scale, forward
    and backward (the control's precision)."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


def round_fp8(x):
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def mm_fp8(a, b):
    return torch.matmul(_Round.apply(a), _Round.apply(b))
