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

The temporal family (JAX :110-123, :154-249, :290-360): with
``use_temporal_embeddings`` a learned embedding of each event's log2
recency bucket joins the token and position embeddings; with
``use_temporal_attention`` a learned ``[buckets, heads]`` table, zero at
init, gives every (query, key) pair an additive attention bias indexed by
the signed log2 bucket of their time difference. That bias is built once
per forward, ``[B, N, S, S]`` fp32, and shared by every layer: the fused
layer reads it as ``rel_bias`` (K1'' rel_bias, K2 dRel); the unfused block
reads it folded into its dense additive bias, which turns flash attention
off. Both bucket laws are JAX's to the bit on the CPU and the card: JAX's
float32 ``log2`` is XLA's ``log(y) * float32(1 / ln 2)``, reproduced here
from a float64 ``log`` rounded to float32, so no libm's rounding of
``log2`` near a power of two moves a bucket.
"""

import functools
import math
from typing import Optional

import torch
import torch.utils.checkpoint

from bert4rec_tpu_torch.core import partitioning
from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.core.dtypes import DTypePolicy
from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.models.components import mla_moe
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


_INV_LN2 = 1.0 / math.log(2.0)   # rounded to float32 where it is used
_INT32_MIN = -2 ** 31
# pairs per chunk of the table gradient's fixed-order sums
TABLE_GRAD_CHUNK = 1024


def _floor_log2_plus1(magnitude: torch.Tensor) -> torch.Tensor:
    """JAX's ``floor(log2(float32(magnitude) + 1))`` on int32 magnitudes,
    bit for bit: y = float32(magnitude) + 1 in float32, XLA's log2 as
    float32(log(y)) * float32(1 / ln 2), and 0 where y is not positive
    (|int32 min| wraps negative; XLA turns the NaN into 0)."""
    y = magnitude.to(torch.float32) + 1.0
    log_y = torch.log(y.to(torch.float64)).to(torch.float32)
    v = log_y * torch.tensor(_INV_LN2, dtype=torch.float32, device=y.device)
    return torch.where(y > 0, torch.floor(v), torch.zeros_like(v)) \
        .to(torch.int32)


def table_grad_sorted(bucket: torch.Tensor, g: torch.Tensor,
                      n_buckets: int) -> torch.Tensor:
    """``dtable[k, h] = sum of g[b, h, q, key] over bucket[b, q, key] == k``
    as a fixed-order two-stage reduction: the (query, key) pairs sorted by
    bucket (stable), each bucket's run padded with zeros to whole chunks of
    ``TABLE_GRAD_CHUNK`` pairs, every chunk summed, then the chunk sums
    gathered onto their buckets by a small one-hot product. No atomics:
    two runs give the same bits. The lookup's backward."""
    chunk, n = TABLE_GRAD_CHUNK, g.shape[1]
    rows = bucket.numel()
    # one-byte keys sort in one radix pass (the table has <= 256 rows)
    narrow = torch.uint8 if n_buckets <= 256 else torch.int64
    keys, order = torch.sort(bucket.reshape(-1).to(narrow), stable=True)
    keys = keys.to(torch.int64)
    ar = torch.arange(n_buckets, device=g.device)
    start = torch.searchsorted(keys, ar)          # each bucket's first pair
    counts = torch.searchsorted(keys, ar, right=True) - start
    padded = (counts + chunk - 1) // chunk * chunk
    pstart = torch.cumsum(padded, 0) - padded
    dest = torch.arange(rows, device=g.device) + (pstart - start)[keys]
    n_chunks = -(-rows // chunk) + n_buckets
    buf = torch.zeros((n_chunks * chunk, n), dtype=torch.float32,
                      device=g.device)
    buf[dest] = g.permute(0, 2, 3, 1).reshape(rows, n)[order].to(torch.float32)
    part = buf.view(n_chunks, chunk, n).sum(1)
    ends = torch.cumsum(padded, 0) // chunk
    owner = torch.searchsorted(
        ends, torch.arange(n_chunks, device=g.device), right=True)
    return (owner[None, :] == ar[:, None]).to(torch.float32) @ part


class _RelLookup(torch.autograd.Function):
    """``table[bucket]`` as ``[B, N, S, S]`` fp32 (JAX's ``_rel_lookup``
    followed by its transpose): a gather forward; the backward sums the
    bias gradient onto the ``[buckets, N]`` table by ``table_grad_sorted``,
    deterministically (never an atomic scatter), keeping only the int32
    bucket matrix as residual."""

    @staticmethod
    def forward(ctx, table, bucket):
        ctx.save_for_backward(bucket)
        ctx.n_buckets = table.shape[0]
        rel = table.to(torch.float32).T[:, bucket.long()]       # [N, B, S, S]
        return rel.permute(1, 0, 2, 3).contiguous()

    @staticmethod
    def backward(ctx, g):
        (bucket,) = ctx.saved_tensors
        return table_grad_sorted(bucket, g.contiguous(),
                                 ctx.n_buckets), None


class Bert4RecEncoder:
    """Stateless module: ``init`` makes the param dict, ``apply`` runs it.
    A config with ``block="mla_moe"`` makes and runs DeepSeek-V3's decoder
    block instead (``components/mla_moe.py``: its own params, no position
    table), with the routers' fixed selection bias held here, drawn from
    the config's seed on first use."""

    def __init__(self, config: BERT4RecConfig,
                 dtype_policy: Optional[DTypePolicy] = None):
        self.config = config
        self.dtype_policy = dtype_policy or DTypePolicy.f32()
        if config.block == "mla_moe":
            mla_moe.check_config(config)
        self._selection_bias = {}

    def selection_bias(self, device) -> torch.Tensor:
        """The MoE layers' fixed selection bias on ``device`` (a
        ``block="mla_moe"`` config's; ``mla_moe.selection_bias``)."""
        key = str(torch.device(device))
        if key not in self._selection_bias:
            self._selection_bias[key] = mla_moe.selection_bias(
                self.config, device)
        return self._selection_bias[key]

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> dict:
        """Fresh params sampled on the CPU from ``generator`` and moved to
        ``device`` (default the card; ``"meta"`` gives shapes only)."""
        if str(device) != "meta":
            device = resolve_device(device)
        cfg = self.config
        if cfg.block == "mla_moe":
            return mla_moe.init_params(generator, cfg, device)
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
        if cfg.use_temporal_embeddings:
            # a learned vector per log2 recency bucket (JAX :110-116)
            params["temporal_embeddings"] = L.init_embedding(
                g, cfg.temporal_buckets, cfg.table_width, std, device)
        if cfg.use_temporal_attention:
            # per-head score bias per signed log2 time-delta bucket; zeros,
            # so the flag is a no-op until trained (JAX :117-123)
            params["temporal_attention_bias"] = {"embedding": torch.zeros(
                (cfg.temporal_attention_buckets, cfg.num_attention_heads),
                dtype=torch.float32, device=device)}
        return params

    def fused_layer_routed(self, batch: int, seq_len: int,
                           dropout_active: bool = False,
                           device=None, output_range=None,
                           temporal: Optional[bool] = None) -> bool:
        """The JAX encoder's routing law (bert4rec_encoder.py:194-213): the
        fused, tanh-gelu layer runs only where JAX runs it, never with an
        ``output_range``. JAX runs it with dropout only on the TPU; the
        port reads the TPU as the card, so with dropout active it is fused
        on CUDA only, as JAX's CPU runs it fused only at rate 0. A
        temporal attention bias (``temporal``, by default the config's
        flag) enters JAX's VMEM estimate and does not refuse the layer."""
        cfg = self.config
        if temporal is None:
            temporal = cfg.use_temporal_attention
        on_card = device is not None and torch.device(device).type == "cuda"
        return (cfg.use_fused_layer and not cfg.norm_first
                and output_range is None
                and cfg.inner_activation == "gelu"
                and (on_card or not dropout_active)
                and fused_layer_supported(
                    batch=batch, seq_len=seq_len, hidden=cfg.hidden_size,
                    inner_dim=cfg.inner_dim,
                    num_heads=cfg.num_attention_heads,
                    dtype_bytes=self.dtype_policy.compute_dtype.itemsize,
                    temporal=temporal))

    def apply(self, params: dict, input_word_ids: torch.Tensor,
              input_mask: torch.Tensor, *, training: bool = False,
              seed: Optional[int] = None,
              output_range: Optional[int] = None,
              input_timestamps: Optional[torch.Tensor] = None,
              mesh=None) -> dict:
        """Forward pass: ``input_word_ids`` / ``input_mask`` are ``[B, S]``
        ints (mask 1 for real tokens); ``input_timestamps`` ``[B, S]`` ints
        (epoch seconds, the temporal preprocessor's), read by the temporal
        features only. Returns ``sequence_output [B, S, H]``
        (``[B, output_range, H]`` with ``output_range``: the last layer
        computes only those positions), ``pooled_output [B, H]`` and
        ``encoder_outputs`` (one per layer). Dropout runs only when
        ``training`` and a ``seed`` is given. With a ``mesh`` whose
        'model' axis row-shards the item table, the lookup is
        :func:`layers.sharded_embedding_lookup`."""
        cfg = self.config
        compute_dtype = self.dtype_policy.compute_dtype
        if cfg.block == "mla_moe":
            return mla_moe.apply(
                params, input_word_ids, input_mask, cfg, compute_dtype,
                self.selection_bias(input_word_ids.device),
                output_range=output_range, mesh=mesh)
        batch, seq_len = input_word_ids.shape

        emb = params["item_embeddings"]
        if "embedding" in emb and partitioning.vocab_sharded(
                mesh, emb["embedding"].shape[0], cfg.padded_vocab_size):
            x = L.sharded_embedding_lookup(emb, input_word_ids, mesh,
                                           compute_dtype)
        else:
            x = L.embedding_lookup(emb, input_word_ids, compute_dtype)
        x = x + L.position_embedding(params["position_embeddings"], seq_len,
                                     compute_dtype)
        if "temporal_embeddings" in params:
            buckets = self._recency_buckets(input_timestamps, input_mask,
                                            cfg.temporal_buckets)
            # a one-hot product, not a gather: B*S ids in a few dozen rows
            # collide so often that the gather's sorted scatter-add
            # backward serializes on them (PERF.md §5); the product's
            # backward is one deterministic GEMM
            table = params["temporal_embeddings"]["embedding"]
            onehot = torch.nn.functional.one_hot(
                buckets.long(), table.shape[0]).to(table.dtype)
            x = x + (onehot @ table).to(compute_dtype)
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
        temporal_attn = (cfg.use_temporal_attention
                         and "temporal_attention_bias" in params)
        fused = self.fused_layer_routed(
            batch, seq_len, dropout_active=attn_rate > 0 or out_rate > 0,
            device=input_word_ids.device, output_range=output_range,
            temporal=temporal_attn)
        if seeds[0] is None:
            attn_rate = out_rate = 0.0
        act = L.get_activation(cfg.inner_activation)
        causal = cfg.causal_attention
        # the relative-time bias, built once and shared by every layer
        # (JAX :229-242): the fused layer reads it as rel_bias; the unfused
        # block reads it in its dense bias, which takes flash attention off
        rel = (self._relative_time_bias(
            params["temporal_attention_bias"]["embedding"], input_timestamps,
            input_mask) if temporal_attn else None)
        use_flash = cfg.use_flash_attention and (fused or rel is None)
        attn_bias = None
        if not fused and (not use_flash or output_range is not None):
            # read by the plain attention only: every unfused layer, or the
            # last one when output_range takes it off flash attention
            attn_bias = L.self_attention_mask(input_mask)
            if causal:
                # the dense triangle (JAX bert4rec_encoder.py:174-183); the
                # fused and flash kernels build it themselves
                attn_bias = attn_bias + causal_bias(seq_len,
                                                    input_mask.device)
            if rel is not None:
                attn_bias = attn_bias + rel

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
                                        causal=causal, rel_bias=rel)
            else:
                block = functools.partial(
                    transformer_block, num_heads=cfg.num_attention_heads,
                    inner_activation=act,
                    norm_first=cfg.norm_first, compute_dtype=compute_dtype,
                    output_dropout=cfg.output_dropout,
                    attention_dropout=cfg.attention_dropout,
                    seed=seeds[1 + i], training=training,
                    query_range=(output_range if i == cfg.num_layers - 1
                                 else None),
                    use_flash=use_flash,
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
    def _recency_buckets(input_timestamps, input_mask, n_buckets):
        """``[B, S]`` int32 log2 recency buckets (JAX :290-313): 0 for the
        newest event, padding, or no timestamps at all; else
        ``floor(log2(seconds before the sequence's newest event + 1))``,
        clipped. Differences are taken in int32 with wraparound, as JAX
        takes them (float32 epoch seconds would quantize to ~128 s)."""
        if input_timestamps is None:
            return torch.zeros_like(input_mask, dtype=torch.int32)
        ts = input_timestamps.to(torch.int32)
        valid = input_mask > 0
        newest = torch.where(valid, ts, _INT32_MIN).amax(dim=1, keepdim=True)
        delta = torch.clamp(newest - ts, min=0)
        bucket = _floor_log2_plus1(delta).clamp(0, n_buckets - 1)
        return torch.where(valid, bucket, 0).to(torch.int32)

    @staticmethod
    def _time_bucket_matrix(input_timestamps, input_mask, n_buckets):
        """``[B, S, S]`` int32 query-key time-delta buckets (JAX :315-341):
        delta = t_query - t_key in int32; magnitude = clip(floor(log2(|delta|
        + 1)), 0, half - 1) with half = n_buckets // 2; the bucket is the
        magnitude for delta >= 0 and half + magnitude below. Without
        timestamps every pair is bucket 0."""
        b, s = input_mask.shape
        if input_timestamps is None:
            return torch.zeros((b, s, s), dtype=torch.int32,
                               device=input_mask.device)
        ts = input_timestamps.to(torch.int32)
        delta = ts[:, :, None] - ts[:, None, :]
        half = max(n_buckets // 2, 1)
        mag = _floor_log2_plus1(delta.abs()).clamp(0, half - 1)
        bucket = torch.where(delta >= 0, mag, half + mag)
        return bucket.clamp(0, n_buckets - 1).to(torch.int32)

    @staticmethod
    def _relative_time_bias(bias_table, input_timestamps, input_mask):
        """The per-head additive attention bias ``[B, N, S, S]`` fp32 (JAX
        :343-360): the table's entry at each pair's time-delta bucket;
        differentiable in the table (``_RelLookup``)."""
        bucket = Bert4RecEncoder._time_bucket_matrix(
            input_timestamps, input_mask, bias_table.shape[0])
        return _RelLookup.apply(bias_table, bucket)

    @staticmethod
    def get_embedding_table(params: dict) -> torch.Tensor:
        """The tied item-embedding table ``[V, W]``. An int8-quantized
        table (models/quantization.py) is dequantized here, the fallback;
        the hot serving paths branch on the quantized form and never build
        this dense tensor."""
        emb = params["item_embeddings"]
        if "embedding_q" in emb:
            return L.dequantize_embedding(emb)
        return emb["embedding"]

    def get_config(self) -> dict:
        return self.config.to_dict()

    @classmethod
    def from_config(cls, config: dict,
                    dtype_policy: Optional[DTypePolicy] = None
                    ) -> "Bert4RecEncoder":
        return cls(BERT4RecConfig.from_dict(config), dtype_policy)
