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
bias, as in the JAX encoder. Routing is JAX's (bert4rec_encoder.py:
187-228): the fused layer where its law allows, else the unfused block,
whose attention core is flash attention (``ops/flash_attention.py``,
K8/K9) with ``use_flash_attention`` and the plain attention otherwise.
``output_range`` computes only the first positions of the last layer (it
takes the fused layer off, as in JAX), and ``remat`` wraps each unfused
block in ``torch.utils.checkpoint``: its activations are recomputed in the
backward instead of kept (the fused layer ignores it, as in JAX).
Temporal features are not ported yet and raise.
"""

import functools
from typing import Optional

import torch
import torch.utils.checkpoint

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
                           device=None, output_range=None) -> bool:
        """The JAX encoder's routing law (bert4rec_encoder.py:194-213): the
        fused, tanh-gelu layer runs only where JAX runs it, never with an
        ``output_range``. JAX runs it with dropout only on the TPU; the
        port reads the TPU as the card, so with dropout active it is fused
        on CUDA only, as JAX's CPU runs it fused only at rate 0."""
        cfg = self.config
        on_card = device is not None and torch.device(device).type == "cuda"
        return (cfg.use_fused_layer and not cfg.norm_first
                and output_range is None
                and cfg.inner_activation == "gelu"
                and (on_card or not dropout_active)
                and fused_layer_supported(
                    batch=batch, seq_len=seq_len, hidden=cfg.hidden_size,
                    inner_dim=cfg.inner_dim,
                    num_heads=cfg.num_attention_heads,
                    dtype_bytes=self.dtype_policy.compute_dtype.itemsize))

    def apply(self, params: dict, input_word_ids: torch.Tensor,
              input_mask: torch.Tensor, *, training: bool = False,
              seed: Optional[int] = None,
              output_range: Optional[int] = None) -> dict:
        """Forward pass: ``input_word_ids`` / ``input_mask`` are ``[B, S]``
        ints (mask 1 for real tokens). Returns ``sequence_output [B, S, H]``
        (``[B, output_range, H]`` with ``output_range``: the last layer
        computes only those positions), ``pooled_output [B, H]`` and
        ``encoder_outputs`` (one per layer). Dropout runs only when
        ``training`` and a ``seed`` is given."""
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
            device=input_word_ids.device, output_range=output_range)
        if seeds[0] is None:
            attn_rate = out_rate = 0.0
        act = L.get_activation(cfg.inner_activation)
        causal = cfg.causal_attention
        attn_bias = None
        if not fused and (not cfg.use_flash_attention
                          or output_range is not None):
            # read by the plain attention only: every unfused layer, or the
            # last one when output_range takes it off flash attention
            attn_bias = L.self_attention_mask(input_mask)
            if causal:
                # the dense triangle (JAX bert4rec_encoder.py:174-183); the
                # fused and flash kernels build it themselves
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
                block = functools.partial(
                    transformer_block, inner_activation=act,
                    norm_first=cfg.norm_first, compute_dtype=compute_dtype,
                    output_dropout=cfg.output_dropout,
                    attention_dropout=cfg.attention_dropout,
                    seed=seeds[1 + i], training=training,
                    query_range=(output_range if i == cfg.num_layers - 1
                                 else None),
                    use_flash=cfg.use_flash_attention,
                    input_mask=input_mask, causal=causal)
                if cfg.remat:
                    # the backward recomputes the block (the same dropout
                    # masks: every one is drawn from a seed) instead of
                    # holding its activations (JAX :267-271)
                    x = torch.utils.checkpoint.checkpoint(
                        block, layer_params, x, attn_bias,
                        use_reentrant=False)
                else:
                    x = block(layer_params, x, attn_bias)
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
