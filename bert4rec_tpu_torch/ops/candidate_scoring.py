"""Candidate scoring for the sampled and full-catalog evaluations (port of
``bert4rec_tpu/ops/candidate_scoring.py``).

``score_candidates`` computes only the C candidate logits of each masked
position: gather the candidates' rows of the tied table and contract them
with the transformed hidden states, ``O(B*P*C*W)`` in place of the
``O(B*P*V*W)`` full-vocab logits. ``gt_ranks_tiled`` ranks each ground
truth against the whole catalog one vocabulary tile at a time, so the
``[B, P, V]`` logits never exist. Both are plain PyTorch: the JAX package
leaves them to XLA, with no Pallas kernel.

On a table row-sharded over a mesh's 'model' axis,
``score_candidates_sharded`` gathers on each rank only the candidate rows
it owns and sums the partial ``[B, P, C]`` logits over 'model', and
``gt_ranks_sharded`` counts each rank's competitors on its own block and
sums the counts: neither gathers the table.

Operands are the hidden states' dtype (the table rows cast to it), products
summed in fp32, as the JAX einsums with ``preferred_element_type=float32``.
"""

from typing import Optional

import torch

from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core.mesh import MODEL_AXIS


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
    return _beaten(hidden, table, output_bias, gt, gt_logit, vocab_size,
                   excl, tile, 0) + 1


def _beaten(hidden, table, output_bias, gt, gt_logit, vocab_size, excl,
            tile, offset) -> torch.Tensor:
    """``[B, P]`` int32: the catalog items among ``table``'s rows (ids
    ``offset + row``) that are valid, not the ground truth, not excluded
    (``excl`` over these rows) and score at least ``gt_logit``."""
    vp = table.shape[0]
    h32 = hidden.float()
    count = torch.zeros(gt.shape, dtype=torch.int32, device=table.device)
    for t0 in range(0, vp, tile):
        t1 = min(vp, t0 + tile)
        logits = h32 @ table[t0:t1].to(hidden.dtype).float().T \
            + output_bias[t0:t1]                              # [B, P, T]
        ids = torch.arange(offset + t0, offset + t1, device=table.device)
        valid = (ids < vocab_size)[None, None, :] & (ids != gt[..., None])
        if excl is not None:
            valid = valid & ~excl[:, None, t0:t1]
        count += (valid & (logits >= gt_logit[..., None])).sum(
            -1, dtype=torch.int32)
    return count


def score_candidates_sharded(hidden: torch.Tensor, table: torch.Tensor,
                             output_bias: torch.Tensor,
                             candidates: torch.Tensor,
                             mesh) -> torch.Tensor:
    """Candidate-only logits ``[B, P, C]`` over a table row-sharded on
    ``mesh``'s 'model' axis: ``table [V / mp, W]`` and ``output_bias
    [V / mp]`` are this rank's block. Each rank scores the candidates it
    owns (zero elsewhere) and the partial logits are summed over 'model':
    the math of :func:`score_candidates`, on every rank.

    :param hidden: ``[B, P, W]``, this rank's 'data' slice
    :param candidates: ``[B, P, C]`` int candidate ids (valid vocab rows)
    """
    v_local = table.shape[0]
    local = candidates.long() - mesh.index(MODEL_AXIS) * v_local
    owned = (local >= 0) & (local < v_local)
    safe = torch.where(owned, local, torch.zeros_like(local))
    logits = _logits_fp32(hidden, table[safe]) + output_bias[safe]
    partial = torch.where(owned, logits, torch.zeros_like(logits))
    return mesh_lib.psum(mesh, partial, MODEL_AXIS)


def gt_ranks_sharded(hidden: torch.Tensor, table: torch.Tensor,
                     output_bias: torch.Tensor, gt_ids: torch.Tensor, *,
                     vocab_size: int, mesh,
                     exclude: Optional[torch.Tensor] = None,
                     tile: int = 8192) -> torch.Tensor:
    """:func:`gt_ranks_tiled`'s rank law over a table row-sharded on
    ``mesh``'s 'model' axis (``table`` / ``output_bias`` this rank's
    block): the ground truth's logit from its owner
    (:func:`score_candidates_sharded`), each rank's count of competitors
    on its block, the counts summed over 'model'."""
    v_local = table.shape[0]
    offset = mesh.index(MODEL_AXIS) * v_local
    gt = gt_ids.long()
    gt_logit = score_candidates_sharded(hidden, table, output_bias,
                                        gt[..., None], mesh)[..., 0]
    excl = None
    if exclude is not None:
        excl = torch.zeros((gt.shape[0], v_local), dtype=torch.bool,
                           device=table.device)
        local = exclude.long() - offset
        keep = (exclude >= 0) & (local >= 0) & (local < v_local)
        rows = torch.arange(gt.shape[0], device=table.device)[:, None] \
            .expand_as(exclude)
        excl[rows[keep], local[keep]] = True
    count = _beaten(hidden, table, output_bias, gt, gt_logit, vocab_size,
                    excl, tile, offset)
    return mesh_lib.all_reduce(mesh, count, MODEL_AXIS) + 1
