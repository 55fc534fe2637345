"""DeepSeek-V3's decoder block (``model_type`` ``deepseek_v3``, as
Moonlight-16B-A3B publishes it) as a block kind of the port's encoder:
multi-head latent attention (MLA) and a mixture of sigmoid-routed experts.

With ``x`` the residual stream, ``N`` heads, and the config's widths
(Moonlight's: ``qk_nope_head_dim`` 128, ``qk_rope_head_dim`` 64,
``v_head_dim`` 128, ``kv_lora_rank`` 512, 64 experts of width 1,408, 6 a
token, 2 shared):

    h   = RMSNorm(x)                                     (weight only)
    q   = h W_q -> [N, nope + rope] = [q_nope | q_pe]     (no q-LoRA)
    c   = h W_kv_down -> [rank | k_pe];  c_kv = RMSNorm(c[:rank])
    kv  = c_kv W_kv_up -> [N, nope + v] = [k_nope | v]
    q_pe, k_pe <- RoPE(rope_theta) on the pairs (2i, 2i+1) at the position;
                  k_pe is one head, shared by all N
    o   = softmax([q_nope|q_pe] . [k_nope|k_pe] / sqrt(nope + rope)
                  + pad bias [+ causal bias]) v;  x += o W_o
    h2  = RMSNorm(x)
    layer i < first_k_dense_replace:  x += W_d(silu(h2 W_g) * (h2 W_u))
    other layers:  s = sigmoid(h2 W_r^T) in fp32;  sel = top-k(s + b)
                   w = s[sel] / (sum s[sel] + 1e-20) * routed_scaling_factor
                   x += sum_j w_j E_sel_j(h2) + Shared(h2)

E and Shared are SwiGLU MLPs (Shared of width ``n_shared_experts *
moe_intermediate_size``); ``b`` is the selection bias, chosen by the
top-k but absent from the weights. After the layers a final RMSNorm; the
model's item head follows (``bert4rec_model.py``). RoPE on adjacent pairs
is the same dot product as the source's interleave-then-``rotate_half``.

Departures from the source: no position table and no embedding norm (as
the source); the item head in place of an untied ``lm_head``; ``b`` is a
buffer drawn from ``router_bias_seed`` (``selection_bias``) and held
fixed (no auxiliary balance loss, no update of ``b``); no dropout (0, as
published); RMSNorm's weight multiplies in fp32 before the rounding to
the compute dtype. Every token, [PAD] included, is routed, and no row is
dropped: each expert takes every row routed to it.

Kernels: the attention core is flash attention (``ops/flash_attention.py``
K8/K9; bf16 at DK = 192, DV = 128 on the card) with
``use_flash_attention``, the routed experts are K11
(``ops/expert_gemm.py``); the router, the permutation, RMSNorm and RoPE are
plain PyTorch. Spans: ``mla.attention``, ``moe.route`` (the gate, the
scores, the biased top-k, the sort by expert and the rows' copy into that
order), ``moe.experts`` (K11), ``moe.shared``, ``moe.combine`` (the
un-permute and the weighted sum). ``routing_counts`` keeps the rows routed,
the most rows on one expert and the rows dropped (always 0), on the device.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from bert4rec_tpu_torch.core import partitioning
from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.ops.expert_gemm import expert_mlp
from bert4rec_tpu_torch.ops.flash_attention import (flash_attention,
                                                    mha_reference)
from bert4rec_tpu_torch.utils.profiling import span


def check_config(cfg) -> None:
    """Raises where the config asks the block for what it does not have."""
    bad = []
    if cfg.output_dropout or cfg.attention_dropout:
        bad.append("dropout (the block has none: rates must be 0)")
    if cfg.embedding_width not in (None, cfg.hidden_size):
        bad.append("a factorized embedding")
    if cfg.use_temporal_embeddings or cfg.use_temporal_attention:
        bad.append("temporal features")
    if cfg.use_fused_layer or cfg.remat or cfg.norm_first:
        bad.append("use_fused_layer, remat or norm_first")
    if cfg.qk_rope_head_dim % 2:
        bad.append("an odd qk_rope_head_dim")
    if bad:
        raise ValueError("the mla_moe block takes no " + "; ".join(bad))


def n_moe_layers(cfg) -> int:
    return max(cfg.num_layers - cfg.first_k_dense_replace, 0)


def selection_bias(cfg, device) -> torch.Tensor:
    """``b`` of every MoE layer, ``[n_moe_layers, E]`` fp32: a standard
    normal drawn on the CPU from ``router_bias_seed`` (mod 2^63), times
    ``router_bias_std``, row ``i`` for layer ``first_k_dense_replace +
    i``."""
    gen = torch.Generator().manual_seed(cfg.router_bias_seed % (2 ** 63))
    b = torch.randn((n_moe_layers(cfg), cfg.n_routed_experts),
                    generator=gen, dtype=torch.float32)
    return (b * cfg.router_bias_std).to(device)


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #

def _kernel(g, shape, std, device):
    return {"kernel": L.truncated_normal_init(g, shape, std, device)}


def _ones(n, device):
    return {"scale": torch.ones((n,), dtype=torch.float32, device=device)}


def _swiglu_params(g, h, f, std, device):
    return {"gate": _kernel(g, (h, f), std, device),
            "up": _kernel(g, (h, f), std, device),
            "down": _kernel(g, (f, h), std, device)}


def init_layer(g, cfg, index: int, device) -> dict:
    h, n, std = cfg.hidden_size, cfg.num_attention_heads, \
        cfg.initializer_range
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    r = cfg.kv_lora_rank
    out = {
        "attention_norm": _ones(h, device),
        "attention": {
            "query": _kernel(g, (h, n, dq), std, device),
            "kv_down": _kernel(g, (h, r + cfg.qk_rope_head_dim), std,
                               device),
            "kv_norm": _ones(r, device),
            "kv_up": _kernel(g, (r, n, cfg.qk_nope_head_dim
                                 + cfg.v_head_dim), std, device),
            "output": _kernel(g, (n, cfg.v_head_dim, h), std, device),
        },
        "ffn_norm": _ones(h, device),
    }
    if index < cfg.first_k_dense_replace:
        out["mlp"] = _swiglu_params(g, h, cfg.inner_dim, std, device)
    else:
        e, i = cfg.n_routed_experts, cfg.moe_intermediate_size
        out["moe"] = {
            "router": _kernel(g, (e, h), std, device),
            "experts": {
                "gate": L.truncated_normal_init(g, (e, h, i), std, device),
                "up": L.truncated_normal_init(g, (e, h, i), std, device),
                "down": L.truncated_normal_init(g, (e, i, h), std, device)},
            "shared": _swiglu_params(g, h, cfg.n_shared_experts * i, std,
                                     device),
        }
    return out


def init_params(g, cfg, device) -> dict:
    """The encoder's params: the item table, the layers and the final
    norm (no position table, no embedding norm, no pooler)."""
    return {
        "item_embeddings": L.init_embedding(
            g, cfg.padded_vocab_size, cfg.hidden_size,
            cfg.initializer_range, device),
        "layers": {f"layer_{i}": init_layer(g, cfg, i, device)
                   for i in range(cfg.num_layers)},
        "final_norm": _ones(cfg.hidden_size, device),
    }


# --------------------------------------------------------------------------- #
# the layer's parts
# --------------------------------------------------------------------------- #

def rms_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """``x / sqrt(mean(x^2) + eps) * scale`` in fp32, then ``x``'s dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"]).to(x.dtype)


def rope_tables(seq_len: int, dim: int, theta: float, device) -> tuple:
    """``(cos, sin)`` fp32 ``[S, dim / 2]``: pair ``i`` turns by ``pos *
    theta^(-2i / dim)``."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    ang = torch.outer(torch.arange(seq_len, dtype=torch.float32,
                                   device=device), inv)
    return ang.cos(), ang.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """Rotate the pairs (2i, 2i+1) of ``x [B, S, heads, dim]`` in fp32;
    returns ``x``'s dtype."""
    x32 = x.float()
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    even, odd = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([even * c - odd * s, even * s + odd * c], dim=-1)
    return out.flatten(-2).to(x.dtype)


def _mm(x, w, dt):
    return torch.matmul(x, w.to(dt))


def swiglu(p: dict, x: torch.Tensor, dt) -> torch.Tensor:
    """``W_d(silu(x W_g) * (x W_u))`` in the compute dtype."""
    return _mm(F.silu(_mm(x, p["gate"]["kernel"], dt))
               * _mm(x, p["up"]["kernel"], dt), p["down"]["kernel"], dt)


def mla_attention(p: dict, h: torch.Tensor, mask: torch.Tensor, cos, sin,
                  cfg, dt) -> torch.Tensor:
    """Latent attention of the normed stream ``h [B, S, H]`` (before the
    residual add)."""
    b, s, _ = h.shape
    n = cfg.num_attention_heads
    nope, rdim, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.kv_lora_rank
    q = torch.einsum("bsh,hnd->bsnd", h, p["query"]["kernel"].to(dt))
    c = _mm(h, p["kv_down"]["kernel"], dt)
    c_kv = rms_norm(p["kv_norm"], c[..., :r], cfg.rms_norm_eps)
    kv = torch.einsum("bsr,rnd->bsnd", c_kv, p["kv_up"]["kernel"].to(dt))
    k_pe = rope(c[..., r:][:, :, None, :], cos, sin)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, s, n, rdim)], dim=-1)
    v = kv[..., nope:]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    causal = cfg.causal_attention
    if cfg.use_flash_attention:
        o = flash_attention(qt, kt, vt, mask, causal=causal)
    else:
        o = mha_reference(qt, kt, vt, mask.to(torch.int32), causal=causal)
    return torch.einsum("bnsd,ndh->bsh", o.to(dt),
                        p["output"]["kernel"].to(dt))


class RoutingCounts:
    """Device-side sums of the router's work: rows routed, the most rows
    one expert took in one layer call (since ``reset``), and rows the
    experts did not take (always 0: no row is dropped). Adding never
    synchronises; ``read`` does."""

    def __init__(self):
        self._t = None

    def add(self, counts: torch.Tensor, routed: int) -> None:
        c = counts.long()
        if self._t is None or self._t.device != c.device:
            self._t = torch.zeros(3, dtype=torch.int64, device=c.device)
        total = c.sum()
        self._t[0] += total
        torch.maximum(self._t[1], c.max(), out=self._t[1])
        self._t[2] += routed - total

    def read(self) -> dict:
        v = [0, 0, 0] if self._t is None else self._t.tolist()
        return dict(zip(("routed_rows", "max_expert_rows", "dropped_rows"),
                        v))

    def reset(self) -> None:
        if self._t is not None:
            self._t.zero_()


routing_counts = RoutingCounts()


def route(p: dict, h: torch.Tensor, bias: torch.Tensor, cfg) -> tuple:
    """``(sel [T, k], w [T, k] fp32, scores [T, E] fp32)`` of the rows ``h
    [T, H]``: sigmoid scores in fp32, the top-k of the biased scores, the
    unbiased scores of those experts normalised and scaled."""
    scores = torch.sigmoid(h.float() @ p["router"]["kernel"].float().T)
    sel = torch.topk(scores + bias, cfg.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, sel)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return sel, w * cfg.routed_scaling_factor, scores


def moe(p: dict, h2: torch.Tensor, bias: torch.Tensor, cfg, dt
        ) -> torch.Tensor:
    """The routed and shared experts of the normed stream ``h2 [B, S, H]``
    (before the residual add)."""
    b, s, hd = h2.shape
    t, k = b * s, cfg.num_experts_per_tok
    x = h2.reshape(t, hd)
    with span("moe.route"):
        sel, w, _ = route(p, x, bias, cfg)
        flat = sel.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=cfg.n_routed_experts)
        rows = x.unsqueeze(1).expand(t, k, hd).reshape(t * k, hd)[order]
    ex = p["experts"]
    with span("moe.experts"):
        y = expert_mlp(rows, counts.to(torch.int32), ex["gate"], ex["up"],
                       ex["down"])
    with span("moe.shared"):
        shared = swiglu(p["shared"], x, dt)
    with span("moe.combine"):
        pairs = torch.empty_like(y)
        pairs[order] = y
        routed = torch.einsum("tk,tkh->th", w, pairs.view(t, k, hd).float())
        out = routed.to(dt) + shared
    routing_counts.add(counts, t * k)
    return out.view(b, s, hd)


def layer(p: dict, x: torch.Tensor, mask: torch.Tensor, cos, sin, cfg, dt,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """One block on the residual stream ``x [B, S, H]``; ``bias`` is the
    layer's selection bias (None for a dense layer)."""
    eps = cfg.rms_norm_eps
    with span("mla.attention"):
        x = x + mla_attention(p["attention"],
                              rms_norm(p["attention_norm"], x, eps), mask,
                              cos, sin, cfg, dt)
    h2 = rms_norm(p["ffn_norm"], x, eps)
    if "mlp" in p:
        return x + swiglu(p["mlp"], h2, dt)
    return x + moe(p["moe"], h2, bias, cfg, dt)


def apply(params: dict, ids: torch.Tensor, mask: torch.Tensor, cfg, dt,
          bias: torch.Tensor, output_range: Optional[int] = None,
          mesh=None) -> dict:
    """The encoder's forward (``Bert4RecEncoder.apply``'s outputs):
    ``sequence_output`` after the final norm (its first ``output_range``
    positions with one), ``pooled_output`` its position 0, and each
    layer's output."""
    emb = params["item_embeddings"]
    if "embedding" in emb and partitioning.vocab_sharded(
            mesh, emb["embedding"].shape[0], cfg.padded_vocab_size):
        x = L.sharded_embedding_lookup(emb, ids, mesh, dt)
    else:
        x = L.embedding_lookup(emb, ids, dt)
    seq_len = ids.shape[1]
    cos, sin = rope_tables(seq_len, cfg.qk_rope_head_dim, cfg.rope_theta,
                           ids.device)
    mask = mask.to(torch.int32)
    outputs = []
    for i in range(cfg.num_layers):
        j = i - cfg.first_k_dense_replace
        x = layer(params["layers"][f"layer_{i}"], x, mask, cos, sin, cfg,
                  dt, bias[j] if j >= 0 else None)
        outputs.append(x)
    x = rms_norm(params["final_norm"], x, cfg.rms_norm_eps)
    if output_range is not None:
        x = x[:, :output_range]
    return {"sequence_output": x, "pooled_output": x[:, 0],
            "encoder_outputs": outputs}
