"""Top-k over the vocab axis and the exclusion bias (port of
``bert4rec_tpu/ops/sharded_topk.py``, single device: the JAX package's
per-shard pass + merge is only needed for a vocab-sharded table, which the
port does not have yet)."""

from typing import Tuple

import torch


def topk_over_vocab(logits: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k values and indices over the last (vocab) axis, best first.
    Ties may be ordered differently from ``lax.top_k``."""
    return torch.topk(logits, min(k, logits.shape[-1]), dim=-1, largest=True,
                      sorted=True)


def exclusion_bias(batch_excludes: torch.Tensor, vocab_size: int,
                   neg: float = -1e9) -> torch.Tensor:
    """Additive ``[B, V]`` fp32 bias: ``neg`` at each row's excluded ids, 0
    elsewhere. ``batch_excludes`` is ``[B, E]`` int; entries < 0 (padding)
    and ids >= ``vocab_size`` are dropped."""
    # dropped entries are sent to a spare column past the vocabulary, so
    # the shapes never depend on the data (torch.export traces this)
    ids = batch_excludes.long()
    keep = (ids >= 0) & (ids < vocab_size)
    ids = torch.where(keep, ids, vocab_size)
    bias = torch.zeros((batch_excludes.shape[0], vocab_size + 1),
                       dtype=torch.float32, device=batch_excludes.device)
    bias.scatter_(1, ids, neg)
    return bias[:, :vocab_size]
