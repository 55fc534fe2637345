"""Post-training int8 quantization for serving (port of
``bert4rec_tpu/models/quantization.py``).

The item-embedding table is most of the model at catalog scale.
Weights-only symmetric per-item int8 (``layers.quantize_embedding``) cuts
its bytes, and the serving artifact's, by about 4x against fp32 (3,709 x
128: 1,899,008 -> 489,588 bytes with the per-row scales).

The scales are per table row, so ``h @ (q * s)^T == (h @ q^T) * s``: the
hot paths (``mlm_logits`` top-k, ``score_candidates``) multiply or gather
the raw int8 codes and apply the scales afterwards; no dense dequantized
table is built there. Input-side lookups scale only the gathered rows.

Serving only: quantized params are for inference (export, apps,
evaluation); training needs the float table.
"""

from bert4rec_tpu_torch.models.components import layers as L


def quantize_params(params: dict) -> dict:
    """A new params dict with the item-embedding table replaced by its int8
    weights-only form (``embedding_q`` int8 ``[V, W]`` + ``embedding_scale``
    fp32 ``[V]``), on the table's device. Every other leaf is shared, not
    copied."""
    if is_quantized(params):
        return params
    encoder = dict(params["encoder"])
    encoder["item_embeddings"] = L.quantize_embedding(
        params["encoder"]["item_embeddings"])
    return {**params, "encoder": encoder}


def dequantize_params(params: dict) -> dict:
    """Invert :func:`quantize_params`' structure (values keep the
    quantization's rounding error, at most scale / 2 per weight)."""
    if not is_quantized(params):
        return params
    encoder = dict(params["encoder"])
    encoder["item_embeddings"] = {
        "embedding": L.dequantize_embedding(encoder["item_embeddings"])}
    return {**params, "encoder": encoder}


def is_quantized(params: dict) -> bool:
    return "embedding_q" in params.get("encoder", {}).get(
        "item_embeddings", {})


def table_bytes(params: dict) -> int:
    """Bytes of the (possibly quantized) item-embedding table."""
    emb = params["encoder"]["item_embeddings"]
    return sum(v.numel() * v.element_size() for v in emb.values())
