"""Non-learned baselines scored through the evaluation protocol itself
(port of ``bert4rec_tpu/evaluation/baselines.py``).

A sampled-negative HR@10 means little alone: the popularity floor of a
101-candidate protocol with a popularity-biased sampler is high.
:class:`PopularityScorer` has the model interface the evaluator reads
(``score_candidates`` and ``gt_ranks_full_vocab``, a ``device`` instead
of params), so one evaluator run gives the baseline under the same
candidates, exclusions and tie law:

    base = PopularityScorer.from_source(source, vocab_size=V)
    floor = BERT4RecEvaluator(sampler=...).evaluate(base, None, test_ds)
"""

from typing import Optional, Sequence

import numpy as np
import torch

from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.ops import sharded_topk

NEG_INF = -1e9

__all__ = ["PopularityScorer"]


class PopularityScorer:
    """Scores every item by its global interaction count.

    Candidate scoring and full-catalog ranking use the count as the
    logit, with the tie law of :meth:`BERT4RecModel.gt_ranks_full_vocab`
    (ties rank ahead of the ground truth). It has no params: the evaluator
    passes ``None`` and reads :attr:`device`.

    :param counts: ``[vocab_size]`` interaction count per token id.
    :param special_token_ids: ids that never outrank anything (PAD, MASK,
        UNK; scored ``NEG_INF``).
    :param device: where the scores live and the scoring runs.
    """

    def __init__(self, counts: np.ndarray,
                 special_token_ids: Sequence[int] = (0, 1, 2),
                 device="cuda"):
        self.device = resolve_device(device)
        scores = np.asarray(counts, np.float32).copy()
        for sid in special_token_ids:
            if 0 <= sid < scores.shape[0]:
                scores[sid] = NEG_INF
        self._scores = torch.from_numpy(scores).to(self.device)

    @classmethod
    def from_source(cls, source: Sequence[int], vocab_size: int,
                    **kwargs) -> "PopularityScorer":
        """Build from a token-id interaction list (duplicates are counts),
        the ``source`` a sampler reads."""
        counts = np.bincount(np.asarray(source, np.int64),
                             minlength=vocab_size)[:vocab_size]
        return cls(counts, **kwargs)

    # ------------------------------------------------------------------ #
    # the model interface the evaluator reads
    # ------------------------------------------------------------------ #

    def score_candidates(self, params, batch: dict,
                         candidates: torch.Tensor,
                         mesh=None) -> torch.Tensor:
        """``[B, P, C]`` popularity scores of candidate item ids."""
        safe = candidates.clamp(0, self._scores.shape[0] - 1)
        scores = self._scores[safe.long()]
        return torch.where(candidates == safe, scores,
                           torch.full_like(scores, NEG_INF))

    def gt_ranks_full_vocab(self, params, inputs: dict, *,
                            exclude: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """Full-catalog 1-based ground-truth ranks under the popularity
        order, the law of ``BERT4RecModel.gt_ranks_full_vocab``: ties rank
        ahead of the ground truth, which never counts itself; ``exclude``
        ids and the specials never compete."""
        gt_ids = inputs["masked_lm_ids"].long()
        logits = self._scores[None, None, :].expand(
            *gt_ids.shape, self._scores.shape[0])
        return full_rank_competitors(logits, gt_ids, exclude, NEG_INF)


def full_rank_competitors(logits: torch.Tensor, gt_ids: torch.Tensor,
                          exclude: Optional[torch.Tensor],
                          neg: float) -> torch.Tensor:
    """1-based ranks ``[B, P]`` of ``gt_ids`` in ``logits [B, P, V]``:
    ``exclude`` ids never compete, the ground truth never counts itself
    (its cell set to ``neg``), ties rank ahead of it."""
    gt = torch.gather(logits, -1, gt_ids[..., None])
    if exclude is not None:
        bias = sharded_topk.exclusion_bias(exclude, logits.shape[-1])
        logits = logits + bias[:, None, :]
    else:
        logits = logits.clone()
    logits.scatter_(-1, gt_ids[..., None], neg)
    return (logits >= gt).sum(-1, dtype=torch.int32) + 1
