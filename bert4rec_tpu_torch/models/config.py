"""Encoder configuration (port of ``bert4rec_tpu/models/config.py``).

The same frozen dataclass, fields, defaults and V1 aliases as the JAX
package, so an ``encoder_config.json`` written by either package loads in
the other. No framework import.
"""

import dataclasses
import json
import pathlib
from typing import Optional

# Reference V1 kwarg names -> canonical names
_V1_ALIASES = {
    "num_hidden_layers": "num_layers",
    "intermediate_size": "inner_dim",
    "hidden_activation": "inner_activation",
    "hidden_dropout_rate": "output_dropout",
    "attention_dropout_rate": "attention_dropout",
    "max_position_embeddings": "max_sequence_length",
    "dropout_rate": "output_dropout",
}


BLOCKS = ("bert", "mla_moe")
# the fields only the "mla_moe" block reads: a "bert" config writes none of
# them, so its dict is the JAX package's, key for key
MLA_MOE_FIELDS = ("block", "qk_nope_head_dim", "qk_rope_head_dim",
                  "v_head_dim", "kv_lora_rank", "rope_theta", "rms_norm_eps",
                  "first_k_dense_replace", "n_routed_experts",
                  "num_experts_per_tok", "n_shared_experts",
                  "moe_intermediate_size", "routed_scaling_factor",
                  "norm_topk_prob", "router_bias_std", "router_bias_seed")


@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    """Hyperparameters of the bidirectional encoder + MLM head.

    Field meanings are documented in the JAX package's config; the port
    reads every field so configs round-trip, and raises where a field
    selects a path it does not run yet (temporal features, int8 tables).
    ``causal_attention`` (SASRec), ``use_flash_attention`` and ``remat``
    run.
    """
    vocab_size: int
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    inner_dim: int = 3072
    inner_activation: str = "gelu"
    output_dropout: float = 0.1
    attention_dropout: float = 0.1
    max_sequence_length: int = 512
    initializer_range: float = 0.02
    embedding_width: Optional[int] = None
    norm_first: bool = False
    use_flash_attention: bool = False
    use_fused_layer: bool = False
    use_fused_loss: bool = False
    vocab_pad_to: Optional[int] = None
    max_predictions_per_seq: int = 40
    use_temporal_embeddings: bool = False
    temporal_buckets: int = 32
    use_temporal_attention: bool = False
    temporal_attention_buckets: int = 64
    causal_attention: bool = False
    remat: bool = False
    # the block kind: "bert" (the post-LN BERT block above) or "mla_moe"
    # (DeepSeek-V3's decoder block: latent attention and sparse experts,
    # models/components/mla_moe.py). The fields below are read by
    # "mla_moe" only; their defaults are Moonlight-16B-A3B's.
    block: str = "bert"
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    first_k_dense_replace: int = 1
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    moe_intermediate_size: int = 1408
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    # the routers' selection bias (held fixed): N(0, std^2) per expert and
    # MoE layer, drawn from this seed (mla_moe.selection_bias)
    router_bias_std: float = 0.01
    router_bias_seed: int = 0

    def __post_init__(self):
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"hidden_size={self.hidden_size} must be divisible by "
                f"num_attention_heads={self.num_attention_heads}")
        if self.block not in BLOCKS:
            raise ValueError(f"block={self.block!r}; known: {BLOCKS}")
        if self.block == "mla_moe" and not (
                0 < self.num_experts_per_tok <= self.n_routed_experts):
            raise ValueError(
                f"num_experts_per_tok={self.num_experts_per_tok} must lie "
                f"in [1, n_routed_experts={self.n_routed_experts}]")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def table_width(self) -> int:
        """Width of the item-embedding table (embedding_width if factorized)."""
        return self.embedding_width or self.hidden_size

    @property
    def padded_vocab_size(self) -> int:
        """Row count of the embedding table / output bias (>= vocab_size)."""
        if not self.vocab_pad_to:
            return self.vocab_size
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    # ------------------------------------------------------------------ #

    @classmethod
    def from_dict(cls, d: dict, **overrides) -> "BERT4RecConfig":
        d = {_V1_ALIASES.get(k, k): v for k, v in d.items()}
        d.update(overrides)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_json_file(cls, path, **overrides) -> "BERT4RecConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f), **overrides)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.block == "bert":
            for name in MLA_MOE_FIELDS:
                del d[name]
        return d

    def to_json_file(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def replace(self, **kwargs) -> "BERT4RecConfig":
        return dataclasses.replace(self, **kwargs)
