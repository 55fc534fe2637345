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
    b = batch_excludes.shape[0]
    bias = torch.zeros((b, vocab_size), dtype=torch.float32,
                       device=batch_excludes.device)
    rows = torch.arange(b, device=batch_excludes.device)[:, None] \
        .expand_as(batch_excludes)
    keep = (batch_excludes >= 0) & (batch_excludes < vocab_size)
    bias[rows[keep], batch_excludes[keep].long()] = neg
    return bias
