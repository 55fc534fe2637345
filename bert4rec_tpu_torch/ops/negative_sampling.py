"""Device-side weighted negative sampling: Gumbel top-k, no replacement
(port of ``bert4rec_tpu/ops/negative_sampling.py``).

Adding iid Gumbel noise to log-probabilities and keeping the k largest is
distributed as k sequential draws without replacement from their softmax,
so this path and the host sampler (``PopularRandomSampler.sample_batch``)
draw from one distribution. The noise comes from a seeded
``torch.Generator`` on the scores' device, where JAX draws with
``jax.random``: the same law, another stream, so the two are compared by
their laws and not bit for bit. Plain PyTorch: the JAX function has no
Pallas kernel.
"""

import numpy as np
import torch

from bert4rec_tpu_torch.core.mesh import mesh_kwargs


def sample_negatives(generator: torch.Generator, logp: torch.Tensor,
                     without_idx: torch.Tensor, k: int,
                     neg: float = -1e30) -> torch.Tensor:
    """Draw ``k`` weighted negatives per row, excluding per-row index sets.

    :param generator: a ``torch.Generator`` on ``logp``'s device
    :param logp: ``[V]`` fp32 log-probabilities (``-inf`` for zero-mass
        items: they are never drawn while the pool holds ``k`` others)
    :param without_idx: ``[..., W]`` int indices into ``logp`` to exclude;
        entries outside ``[0, V)`` (``V`` as padding) are ignored
    :returns: ``[..., k]`` int32 indices into ``logp``
    """
    v = logp.shape[0]
    lead = without_idx.shape[:-1]
    rows = int(np.prod(lead, dtype=np.int64))
    # uniform on [1e-12, 1), as jax.random.uniform(minval=1e-12, maxval=1)
    u = torch.rand((rows, v), generator=generator, device=logp.device,
                   dtype=torch.float32).clamp_(min=1e-12)
    gumbel = -torch.log(-torch.log(u))
    # a -inf log-prob would turn the sum into NaN: clamp to a finite floor
    # that still never wins a top-k
    scores = gumbel + torch.clamp(logp, min=neg)
    flat = without_idx.reshape(rows, -1).long()
    keep = (flat >= 0) & (flat < v)
    r = torch.arange(rows, device=logp.device)[:, None].expand_as(flat)
    scores[r[keep], flat[keep]] = neg
    idx = torch.topk(scores, k, dim=-1).indices
    return idx.reshape(*lead, k).to(torch.int32)


def popularity_logp(probs, device) -> torch.Tensor:
    """Host probabilities -> fp32 log-probabilities on ``device``."""
    p = np.asarray(probs, dtype=np.float32)
    with np.errstate(divide="ignore"):
        return torch.from_numpy(np.log(p)).to(device)


def ranks_from_candidates(model, params, batch: dict,
                          candidates: torch.Tensor,
                          mesh=None) -> torch.Tensor:
    """1-based ground-truth ranks ``[B, P]`` from ``candidates [B, P, C]``
    whose last column is the ground truth: 1 + the negatives scoring at
    least the ground truth's logit (ties rank ahead of it); invalid
    positions get 0. ``mesh`` goes to a ``score_candidates`` that takes
    it (vocab-sharded params)."""
    cand = model.score_candidates(params, batch, candidates,
                                  **mesh_kwargs(model.score_candidates,
                                                mesh))
    beaten = (cand[..., :-1] >= cand[..., -1:]).sum(-1, dtype=torch.int32)
    return torch.where(batch["masked_lm_weights"] > 0, beaten + 1,
                       torch.zeros_like(beaten))


def ranks_with_device_negatives(model, params, batch: dict, *,
                                logp: torch.Tensor,
                                vocab_ids: torch.Tensor,
                                without_idx: torch.Tensor,
                                generator: torch.Generator,
                                sample_size: int,
                                mesh=None) -> torch.Tensor:
    """Sample negatives -> candidate-only scoring -> ground-truth ranks
    ``[B, P]``, all on the device.

    :param vocab_ids: ``[V]`` item id of each sampler-vocab index
    :param without_idx: ``[B, P, W]`` sampler-vocab indices to exclude
    """
    neg_idx = sample_negatives(generator, logp, without_idx, sample_size)
    negatives = vocab_ids[neg_idx.long()]                  # [B, P, k] ids
    gt = batch["masked_lm_ids"][..., None].to(negatives.dtype)
    candidates = torch.cat([negatives, gt], dim=-1)
    return ranks_from_candidates(model, params, batch, candidates, mesh)
