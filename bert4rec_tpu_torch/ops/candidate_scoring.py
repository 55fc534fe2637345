"""Candidate scoring for the sampled and full-catalog evaluations (port of
``bert4rec_tpu/ops/candidate_scoring.py``; the vocab-sharded variant waits
for the multi-GPU layout).

``score_candidates`` computes only the C candidate logits of each masked
position: gather the candidates' rows of the tied table and contract them
with the transformed hidden states, ``O(B*P*C*W)`` in place of the
``O(B*P*V*W)`` full-vocab logits. ``gt_ranks_tiled`` ranks each ground
truth against the whole catalog one vocabulary tile at a time, so the
``[B, P, V]`` logits never exist. Both are plain PyTorch: the JAX package
leaves them to XLA, with no Pallas kernel.

Operands are the hidden states' dtype (the table rows cast to it), products
summed in fp32, as the JAX einsums with ``preferred_element_type=float32``.
"""

from typing import Optional

import torch


def _logits_fp32(hidden: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``hidden [..., W]`` against ``rows [..., C, W]`` -> ``[..., C]`` fp32,
    the rows rounded to the hidden dtype first."""
    return torch.einsum("...w,...cw->...c", hidden.float(),
                        rows.to(hidden.dtype).float())


def score_candidates_reference(hidden: torch.Tensor, table: torch.Tensor,
                               output_bias: torch.Tensor,
                               candidates: torch.Tensor) -> torch.Tensor:
    """Full-vocab matmul then gather (the reference semantics)."""
    logits = hidden.float() @ table.to(hidden.dtype).float().T + output_bias
    return torch.gather(logits, -1, candidates.long())


def score_candidates(hidden: torch.Tensor, table: torch.Tensor,
                     output_bias: torch.Tensor,
                     candidates: torch.Tensor) -> torch.Tensor:
    """Candidate-only logits ``[B, P, C]``.

    :param hidden: ``[B, P, W]`` transformed masked-position states
    :param table: ``[V, W]`` tied embedding table
    :param output_bias: ``[V]``
    :param candidates: ``[B, P, C]`` int candidate ids
    """
    idx = candidates.long()
    return _logits_fp32(hidden, table[idx]) + output_bias[idx]


def score_candidates_quantized(hidden: torch.Tensor, emb_params: dict,
                               output_bias: torch.Tensor,
                               candidates: torch.Tensor) -> torch.Tensor:
    """Candidate-only logits from an int8 weights-only quantized table
    (``embedding_q`` ``[V, W]`` int8 + ``embedding_scale`` ``[V]``;
    models/quantization.py): the raw int8 rows are gathered and each
    candidate's scale is applied after the contraction, the math of
    :func:`score_candidates` on the dequantized table."""
    idx = candidates.long()
    q_rows = emb_params["embedding_q"][idx]                  # [B, P, C, W]
    s_rows = emb_params["embedding_scale"][idx]              # [B, P, C]
    return _logits_fp32(hidden, q_rows) * s_rows + output_bias[idx]


def gt_ranks_tiled(hidden: torch.Tensor, table: torch.Tensor,
                   output_bias: torch.Tensor, gt_ids: torch.Tensor, *,
                   vocab_size: int,
                   exclude: Optional[torch.Tensor] = None,
                   tile: int = 8192) -> torch.Tensor:
    """Full-catalog 1-based ground-truth ranks without ``[B, P, V]``.

    The table streams through in tiles of ``tile`` rows: per tile one
    ``[B, P, tile]`` product, compared with the ground-truth logit, and the
    count of competitors accumulated. Rank law of the dense path: ties
    count ahead of the ground truth; the ground-truth column never counts
    itself; vocabulary-padding rows (ids >= ``vocab_size``) and excluded ids
    never compete: rank = 1 + #{v: valid(v), v != gt, logit_v >= logit_gt}.

    The ground-truth logit comes from its own gathered row-dot (as in the
    JAX function), so a tie can rank otherwise than in the dense law on
    real hardware; comparisons use tie-free inputs.

    :param hidden: ``[B, P, W]``; ``table``: ``[Vp, W]``; ``output_bias``:
        ``[Vp]``; ``gt_ids``: ``[B, P]`` int
    :param exclude: optional ``[B, E]`` int ids (< 0 = padding) removed
        from the competitor set per batch row
    :returns: ``[B, P]`` int32 ranks (>= 1)
    """
    vp = table.shape[0]
    b, p = gt_ids.shape
    gt = gt_ids.long()
    gt_logit = (_logits_fp32(hidden, table[gt][..., None, :])[..., 0]
                + output_bias[gt])
    excl = None
    if exclude is not None:
        excl = torch.zeros((b, vp), dtype=torch.bool, device=table.device)
        keep = (exclude >= 0) & (exclude < vp)
        rows = torch.arange(b, device=table.device)[:, None] \
            .expand_as(exclude)
        excl[rows[keep], exclude[keep].long()] = True
    h32 = hidden.float()
    count = torch.zeros((b, p), dtype=torch.int32, device=table.device)
    for t0 in range(0, vp, tile):
        t1 = min(vp, t0 + tile)
        logits = h32 @ table[t0:t1].to(hidden.dtype).float().T \
            + output_bias[t0:t1]                              # [B, P, T]
        ids = torch.arange(t0, t1, device=table.device)
        valid = (ids < vocab_size)[None, None, :] & (ids != gt[..., None])
        if excl is not None:
            valid = valid & ~excl[:, None, t0:t1]
        count += (valid & (logits >= gt_logit[..., None])).sum(
            -1, dtype=torch.int32)
    return count + 1
