"""Bidirectional transformer encoder (port of
``bert4rec_tpu/models/components/networks/bert4rec_encoder.py``).

Item-embedding lookup + learned positions -> add -> LayerNorm (fp32,
eps 1e-12) -> optional factorized projection -> N encoder layers -> tanh
pooler on token 0. Each layer is the fused kernel
(``ops/fused_encoder_layer.py``) where the JAX package's routing law sends
it there, else the unfused block (``transformer.py``). In training,
dropout follows the embedding LayerNorm and sits inside every layer; its
seeds derive from one step seed (``fold_in(seed, i)``: 0 for the
embeddings, ``1 + i`` for layer ``i``). With ``causal_attention``
(SASRec) position i attends to keys j <= i: the fused kernel builds the
triangle itself, and the unfused block reads it folded into its additive
bias, as in the JAX encoder. Temporal features and ``output_range`` are
not ported yet and raise.
"""

from typing import Optional

import torch

from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.core.dtypes import DTypePolicy
from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.models.components.transformer import (
    init_transformer_block,
    transformer_block,
)
from bert4rec_tpu_torch.models.config import BERT4RecConfig
from bert4rec_tpu_torch.ops.dropout_bits import fold_in
from bert4rec_tpu_torch.ops.fused_encoder_layer import (
    causal_bias,
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
             device="cuda") -> dict:
        """Fresh params sampled on the CPU from ``generator`` and moved to
        ``device`` (default the card; ``"meta"`` gives shapes only)."""
        if str(device) != "meta":
            device = resolve_device(device)
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

    def fused_layer_routed(self, batch: int, seq_len: int,
                           dropout_active: bool = False,
                           device=None) -> bool:
        """The JAX encoder's routing law (bert4rec_encoder.py:194-213): the
        fused, tanh-gelu layer runs only where JAX runs it. JAX runs it
        with dropout only on the TPU; the port reads the TPU as the card,
        so with dropout active it is fused on CUDA only, as JAX's CPU runs
        it fused only at rate 0."""
        cfg = self.config
        on_card = device is not None and torch.device(device).type == "cuda"
        return (cfg.use_fused_layer and not cfg.norm_first
                and cfg.inner_activation == "gelu"
                and (on_card or not dropout_active)
                and fused_layer_supported(
                    batch=batch, seq_len=seq_len, hidden=cfg.hidden_size,
                    inner_dim=cfg.inner_dim,
                    num_heads=cfg.num_attention_heads,
                    dtype_bytes=self.dtype_policy.compute_dtype.itemsize))

    def apply(self, params: dict, input_word_ids: torch.Tensor,
              input_mask: torch.Tensor, *, training: bool = False,
              seed: Optional[int] = None) -> dict:
        """Forward pass: ``input_word_ids`` / ``input_mask`` are ``[B, S]``
        ints (mask 1 for real tokens). Returns ``sequence_output [B, S, H]``,
        ``pooled_output [B, H]`` and ``encoder_outputs`` (one per layer).
        Dropout runs only when ``training`` and a ``seed`` is given."""
        cfg = self.config
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
        seeds = ([fold_in(seed, i) for i in range(cfg.num_layers + 1)]
                 if training and seed is not None
                 else [None] * (cfg.num_layers + 1))
        x = L.layer_norm(params["embedding_norm"], x)
        x = L.dropout(x, cfg.output_dropout, seeds[0])
        if "embedding_projection" in params:
            x = L.dense(params["embedding_projection"], x, compute_dtype)

        # the JAX law: the rates of training decide the route; a layer
        # without a seed then runs them at 0 (no rng, no dropout)
        attn_rate = cfg.attention_dropout if training else 0.0
        out_rate = cfg.output_dropout if training else 0.0
        fused = self.fused_layer_routed(
            batch, seq_len, dropout_active=attn_rate > 0 or out_rate > 0,
            device=input_word_ids.device)
        if seeds[0] is None:
            attn_rate = out_rate = 0.0
        if not fused and cfg.use_flash_attention:
            raise NotImplementedError(
                "the flash-attention kernel (bert4rec_tpu/ops/"
                "flash_attention.py) is not ported yet")
        act = L.get_activation(cfg.inner_activation)
        causal = cfg.causal_attention
        attn_bias = None
        if not fused:
            attn_bias = L.self_attention_mask(input_mask)
            if causal:
                # the dense triangle, for the unfused block only (JAX
                # bert4rec_encoder.py:174-183); the fused kernel builds it
                attn_bias = attn_bias + causal_bias(seq_len,
                                                    input_mask.device)

        encoder_outputs = []
        for i in range(cfg.num_layers):
            layer_params = params["layers"][f"layer_{i}"]
            if fused:
                x = fused_encoder_layer(layer_params, x,
                                        input_mask.to(torch.int32),
                                        num_heads=cfg.num_attention_heads,
                                        attention_dropout=attn_rate,
                                        output_dropout=out_rate,
                                        seed=seeds[1 + i] or 0,
                                        causal=causal)
            else:
                x = transformer_block(layer_params, x, attn_bias,
                                      inner_activation=act,
                                      norm_first=cfg.norm_first,
                                      compute_dtype=compute_dtype,
                                      output_dropout=cfg.output_dropout,
                                      attention_dropout=cfg.attention_dropout,
                                      seed=seeds[1 + i], training=training)
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
