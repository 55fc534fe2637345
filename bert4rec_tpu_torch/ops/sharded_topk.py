"""Top-k over the vocab axis and the exclusion bias (port of
``bert4rec_tpu/ops/sharded_topk.py``).

The vocab axis is taken as ``n`` contiguous blocks: each block's local
top-k, then only the ``n * k`` surviving (value, index) pairs are merged by
a second top-k. Every global top-k element is among its own block's local
top-k, so the merge pool holds the exact answer. With a mesh whose 'model'
axis has ``n > 1`` ranks, the blocks are the ranks' shards of the
vocabulary: each rank passes its own block of the logits, and the pairs
cross the ranks (an all_reduce of zero-padded pieces over 'model'), so
every rank returns the same answer.
"""

from typing import Optional, Tuple

import torch

from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core.mesh import MODEL_AXIS


def _merge(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The best ``k`` of ``[..., pool]`` pairs, best first."""
    top_vals, pos = torch.topk(vals, min(k, vals.shape[-1]), dim=-1)
    return top_vals, torch.gather(idx, -1, pos)


def topk_over_vocab(logits: torch.Tensor, k: int, *,
                    vocab_shards: int = 1,
                    mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k values and indices over the last (vocab) axis, best first.
    Ties may be ordered differently from ``lax.top_k``.

    :param logits: ``[..., V]``; with a mesh whose 'model' axis has more
        than one rank, this rank's block ``[..., V / n]`` of the vocabulary
        (columns ``[i * V / n, (i + 1) * V / n)`` on model rank ``i``)
    :param vocab_shards: split a whole ``V`` into this many blocks for the
        local pass (any divisor of V is correct)
    :returns: ``(values [..., k], indices [..., k])``, indices global
    """
    mp = mesh.size(MODEL_AXIS) if mesh is not None else 1
    if mp > 1:
        block = logits.shape[-1]
        vals, idx = torch.topk(logits, min(k, block), dim=-1)
        idx = idx + mesh.index(MODEL_AXIS) * block
        vals = torch.movedim(mesh_lib.gather(mesh, vals, MODEL_AXIS), 0, -2)
        idx = torch.movedim(mesh_lib.gather(mesh, idx, MODEL_AXIS), 0, -2)
        return _merge(vals.flatten(-2), idx.flatten(-2), k)
    v = logits.shape[-1]
    n = vocab_shards
    if n <= 1 or v % n != 0:
        return torch.topk(logits, min(k, v), dim=-1, largest=True,
                          sorted=True)
    block = v // n
    blocks = logits.reshape(*logits.shape[:-1], n, block)
    vals, idx = torch.topk(blocks, min(k, block), dim=-1)
    idx = idx + torch.arange(n, device=idx.device)[:, None] * block
    return _merge(vals.flatten(-2), idx.flatten(-2), k)


def exclusion_bias(batch_excludes: torch.Tensor, vocab_size: int,
                   neg: float = -1e9, offset: int = 0) -> torch.Tensor:
    """Additive ``[B, V]`` fp32 bias: ``neg`` at each row's excluded ids, 0
    elsewhere. ``batch_excludes`` is ``[B, E]`` int; entries < 0 (padding)
    and ids outside the ``vocab_size`` columns are dropped. With
    ``offset``, the columns are the ids ``[offset, offset + vocab_size)``
    (a vocab shard's block)."""
    # dropped entries are sent to a spare column past the vocabulary, so
    # the shapes never depend on the data (torch.export traces this)
    ids = batch_excludes.long() - offset
    keep = (batch_excludes >= 0) & (ids >= 0) & (ids < vocab_size)
    ids = torch.where(keep, ids, vocab_size)
    bias = torch.zeros((batch_excludes.shape[0], vocab_size + 1),
                       dtype=torch.float32, device=batch_excludes.device)
    bias.scatter_(1, ids, neg)
    return bias[:, :vocab_size]
