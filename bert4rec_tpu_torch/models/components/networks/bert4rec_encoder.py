"""Bidirectional transformer encoder (port of
``bert4rec_tpu/models/components/networks/bert4rec_encoder.py``).

Item-embedding lookup + learned positions -> add -> LayerNorm (fp32,
eps 1e-12) -> optional factorized projection -> N encoder layers -> tanh
pooler on token 0. Each layer is the fused kernel
(``ops/fused_encoder_layer.py``) where the JAX package's routing law sends
it there, else the unfused block (``transformer.py``). Inference only;
temporal features, causal attention and ``output_range`` are not ported
yet and raise.
"""

from typing import Optional

import torch

from bert4rec_tpu_torch.core.dtypes import DTypePolicy
from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.models.components.transformer import (
    init_transformer_block,
    transformer_block,
)
from bert4rec_tpu_torch.models.config import BERT4RecConfig
from bert4rec_tpu_torch.ops.fused_encoder_layer import (
    fused_encoder_layer,
    fused_layer_supported,
)


class Bert4RecEncoder:
    """Stateless module: ``init`` makes the param dict, ``apply`` runs it."""

    def __init__(self, config: BERT4RecConfig,
                 dtype_policy: Optional[DTypePolicy] = None):
        self.config = config
        self.dtype_policy = dtype_policy or DTypePolicy.f32()

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> dict:
        cfg = self.config
        if cfg.use_temporal_embeddings or cfg.use_temporal_attention:
            raise NotImplementedError(
                "temporal encoder features are not ported yet")
        std = cfg.initializer_range
        g = generator
        params = {
            "item_embeddings": L.init_embedding(
                g, cfg.padded_vocab_size, cfg.table_width, std, device),
            "position_embeddings": L.init_position_embedding(
                g, cfg.max_sequence_length, cfg.table_width, std, device),
            "embedding_norm": L.init_layer_norm(cfg.table_width, device),
            "layers": {
                f"layer_{i}": init_transformer_block(
                    g, cfg.hidden_size, cfg.num_attention_heads,
                    cfg.inner_dim, std, device)
                for i in range(cfg.num_layers)
            },
            "pooler": L.init_dense(g, cfg.hidden_size, cfg.hidden_size, std,
                                   device),
        }
        if cfg.embedding_width is not None \
                and cfg.embedding_width != cfg.hidden_size:
            params["embedding_projection"] = L.init_dense(
                g, cfg.embedding_width, cfg.hidden_size, std, device)
        return params

    def fused_layer_routed(self, batch: int, seq_len: int) -> bool:
        """The JAX encoder's routing law (bert4rec_encoder.py:194-213) at
        inference (dropout inactive, no ``output_range``): the fused,
        tanh-gelu layer runs only where JAX runs it."""
        cfg = self.config
        return (cfg.use_fused_layer and not cfg.norm_first
                and cfg.inner_activation == "gelu"
                and fused_layer_supported(
                    batch=batch, seq_len=seq_len, hidden=cfg.hidden_size,
                    inner_dim=cfg.inner_dim,
                    num_heads=cfg.num_attention_heads,
                    dtype_bytes=self.dtype_policy.compute_dtype.itemsize))

    def apply(self, params: dict, input_word_ids: torch.Tensor,
              input_mask: torch.Tensor) -> dict:
        """Forward pass: ``input_word_ids`` / ``input_mask`` are ``[B, S]``
        ints (mask 1 for real tokens). Returns ``sequence_output [B, S, H]``,
        ``pooled_output [B, H]`` and ``encoder_outputs`` (one per layer)."""
        cfg = self.config
        if cfg.causal_attention:
            raise NotImplementedError("causal attention is not ported yet")
        if "temporal_embeddings" in params \
                or "temporal_attention_bias" in params:
            raise NotImplementedError(
                "temporal encoder features are not ported yet")
        compute_dtype = self.dtype_policy.compute_dtype
        batch, seq_len = input_word_ids.shape

        x = L.embedding_lookup(params["item_embeddings"], input_word_ids,
                               compute_dtype)
        x = x + L.position_embedding(params["position_embeddings"], seq_len,
                                     compute_dtype)
        x = L.layer_norm(params["embedding_norm"], x)
        if "embedding_projection" in params:
            x = L.dense(params["embedding_projection"], x, compute_dtype)

        fused = self.fused_layer_routed(batch, seq_len)
        if not fused and cfg.use_flash_attention:
            raise NotImplementedError(
                "the flash-attention kernel (bert4rec_tpu/ops/"
                "flash_attention.py) is not ported yet")
        act = L.get_activation(cfg.inner_activation)
        attn_bias = None if fused else L.self_attention_mask(input_mask)

        encoder_outputs = []
        for i in range(cfg.num_layers):
            layer_params = params["layers"][f"layer_{i}"]
            if fused:
                x = fused_encoder_layer(layer_params, x,
                                        input_mask.to(torch.int32),
                                        num_heads=cfg.num_attention_heads)
            else:
                x = transformer_block(layer_params, x, attn_bias,
                                      inner_activation=act,
                                      norm_first=cfg.norm_first,
                                      compute_dtype=compute_dtype)
            encoder_outputs.append(x)

        sequence_output = encoder_outputs[-1]
        pooled_output = torch.tanh(
            L.dense(params["pooler"], sequence_output[:, 0], compute_dtype))
        return {
            "sequence_output": sequence_output,
            "pooled_output": pooled_output,
            "encoder_outputs": encoder_outputs,
        }

    @staticmethod
    def get_embedding_table(params: dict) -> torch.Tensor:
        """The tied item-embedding table ``[V, W]``."""
        emb = params["item_embeddings"]
        if "embedding_q" in emb:
            raise NotImplementedError(
                "int8-quantized embedding tables are not ported yet")
        return emb["embedding"]
