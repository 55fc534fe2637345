"""Parameters, operations, bytes and least times of the ``mla_moe`` block's
training step and of its kernels, from the configuration's shapes, against
the published peaks of one NVIDIA H100 SXM (``roofline.py``: 989 TFLOP/s
bf16, 3.35 TB/s of HBM). Model operations count no recomputation; causal
attention counts the pairs (query, key <= query) only."""

from benchmark.roofline import HBM_BYTES_S, PEAK_FLOPS, _bound


def _dims(cfg: dict) -> tuple:
    n = cfg["num_attention_heads"]
    dk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return n, dk, cfg["v_head_dim"]


def mla_params(cfg: dict) -> int:
    """One layer's attention: W_q, W_kv_down, W_kv_up, W_o and the two
    norms' scales (the layer's input norm and the latent's)."""
    h, r = cfg["hidden_size"], cfg["kv_lora_rank"]
    n, dk, dv = _dims(cfg)
    return (h * n * dk + h * (r + cfg["qk_rope_head_dim"])
            + r * n * (cfg["qk_nope_head_dim"] + dv) + n * dv * h + h + r)


def routed_params(cfg: dict) -> int:
    return 3 * cfg["n_routed_experts"] * cfg["hidden_size"] \
        * cfg["moe_intermediate_size"]


def shared_params(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["n_shared_experts"] \
        * cfg["moe_intermediate_size"]


def moe_layer_params(cfg: dict) -> int:
    """An MoE layer: attention, the routed and shared experts, the router
    and the FFN's norm."""
    h = cfg["hidden_size"]
    return (mla_params(cfg) + routed_params(cfg) + shared_params(cfg)
            + cfg["n_routed_experts"] * h + h)


def dense_layer_params(cfg: dict) -> int:
    h = cfg["hidden_size"]
    return mla_params(cfg) + 3 * h * cfg["inner_dim"] + h


def head_params(cfg: dict) -> int:
    """The item table, the final norm and the item head."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    return v * h + h + h * h + 3 * h + v


def total_params(cfg: dict) -> int:
    dense = min(cfg["first_k_dense_replace"], cfg["num_layers"])
    return (dense * dense_layer_params(cfg)
            + (cfg["num_layers"] - dense) * moe_layer_params(cfg)
            + head_params(cfg))


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def train_step_flops(cfg: dict, batch: int) -> float:
    """Model operations of one training step, three times the forward's:
    per token 2 x the layer's matrix parameters (attention, the dense FFN
    or the shared experts and the router), per routed row 2 x an expert's
    (6 H I; tokens x experts per token x MoE layers rows a step: the
    router drops no row), causal attention's 2 (DK + DV) per pair and head,
    and the head's 2 (H^2 + H V) per predicted position."""
    s, h = cfg["max_sequence_length"], cfg["hidden_size"]
    tokens = batch * s
    layers = cfg["num_layers"]
    dense = min(cfg["first_k_dense_replace"], layers)
    moe = layers - dense
    n, dk, dv = _dims(cfg)
    i = cfg["moe_intermediate_size"]
    routed_rows = tokens * cfg["num_experts_per_tok"] * moe
    per_token = (layers * 2 * mla_params(cfg)
                 + dense * 6 * h * cfg["inner_dim"]
                 + moe * (2 * shared_params(cfg)
                          + 2 * h * cfg["n_routed_experts"]))
    attention = layers * batch * n * causal_pairs(s) * 2 * (dk + dv)
    rows = batch * cfg["max_predictions_per_seq"]
    head = rows * 2 * (h * h + h * cfg["vocab_size"])
    return 3 * (tokens * per_token + routed_rows * 6 * h * i + attention
                + head)


def expert_s(rows: float, cfg: dict, backward: bool) -> float:
    """K11's least time for ``rows`` routed rows: 6 R H I operations
    forward (gate, up, down), 12 backward (dA, dx's two, three dW);
    bytes: forward x, the bf16 weights, g, u, the activation and y once
    each; backward dy, x, g, u and the activation read, the bf16 weights
    read, dx written and the fp32 weight gradients written."""
    h, i, e = cfg["hidden_size"], cfg["moe_intermediate_size"], \
        cfg["n_routed_experts"]
    w = 3 * e * h * i
    if backward:
        nbytes = 2 * (2 * rows * h + 3 * rows * i + w + rows * h) + 4 * w
    else:
        nbytes = 2 * (rows * h + w + 3 * rows * i + rows * h)
    return _bound((12 if backward else 6) * rows * h * i, nbytes,
                  PEAK_FLOPS["bfloat16"])


def flash_s(cfg: dict, batch: int, backward: bool) -> float:
    """K8 / K9 at (DK, DV), causal: per pair and head 2 (DK + DV)
    operations forward, 4 (DK + DV) backward (dv, dp, dq, dk; the scores'
    recomputation not counted); bytes: forward q, k, v, the mask read and
    o written; backward q, k, v, dO, the row statistics and the mask read,
    dq, dk, dv written."""
    s = cfg["max_sequence_length"]
    n, dk, dv = _dims(cfg)
    flops = (4 if backward else 2) * batch * n * causal_pairs(s) * (dk + dv)
    heads = batch * n * s
    if backward:
        nbytes = heads * (2 * (4 * dk + 3 * dv) + 8) + batch * s * 4
    else:
        nbytes = heads * 2 * (2 * dk + 2 * dv) + batch * s * 4
    return _bound(flops, nbytes, PEAK_FLOPS["bfloat16"])


__all__ = ["HBM_BYTES_S", "PEAK_FLOPS", "train_step_flops", "expert_s",
           "flash_s", "total_params", "moe_layer_params",
           "dense_layer_params", "head_params", "mla_params"]
