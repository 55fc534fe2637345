"""Model utilities (port of ``bert4rec_tpu/models/model_utils.py``)."""

import pathlib
from typing import Optional, Union

import numpy as np
import torch

from bert4rec_tpu_torch.utils import utils


def determine_model_path(path: Union[str, pathlib.Path],
                         mode: int = 0) -> pathlib.Path:
    """Resolve a model save path: an absolute path as given; otherwise
    mode 0 -> under the default model save dir, mode 1 -> under the
    environment base dir, mode 2 -> as given."""
    path = pathlib.Path(path)
    if path.is_absolute():
        return path
    if mode == 0:
        return utils.get_default_model_save_path() / path
    if mode == 1:
        return utils.get_virtual_env_path() / path
    if mode == 2:
        return path
    raise ValueError(f"Unknown path mode: {mode}")


def init_output_bias_from_popularity(params: dict, item_counts,
                                     smoothing: float = 1.0) -> dict:
    """A copy of ``params`` whose MLM ``output_bias`` is the log of the
    Laplace-smoothed item prior instead of zeros: training then starts at
    the popularity entropy rather than on the saddle of learning plain
    popularity first (JAX ``model_utils.py:31-75``).

    :param item_counts: occurrence count per token id, length <= the bias
        length (a shorter array is zero-padded)
    :param smoothing: additive smoothing (> 0), so unseen items get a
        finite floor
    :returns: a new param dict (``params`` is not changed)
    """
    if smoothing <= 0:
        raise ValueError(f"smoothing must be > 0, got {smoothing}")
    bias = params["mlm"]["output_bias"]
    counts = np.zeros(bias.shape[0], np.float64)
    item_counts = np.asarray(item_counts, np.float64)
    if item_counts.ndim != 1 or item_counts.shape[0] > bias.shape[0]:
        raise ValueError(
            f"item_counts must be 1-D with length <= {bias.shape[0]}, "
            f"got shape {item_counts.shape}")
    counts[:item_counts.shape[0]] = item_counts
    log_prior = np.log(counts + smoothing) - np.log(counts.sum()
                                                    + smoothing * len(counts))
    new_params = dict(params)
    new_params["mlm"] = dict(params["mlm"])
    new_params["mlm"]["output_bias"] = torch.as_tensor(
        log_prior, dtype=bias.dtype, device=bias.device)
    return new_params


def rank_items(logits: torch.Tensor,
               embeddings: Optional[torch.Tensor] = None,
               items=None, *, with_probabilities: bool = True) -> tuple:
    """Standalone ranking (JAX ``model_utils.py:78-101``), also the
    model's ``rank_with_candidates`` / ``rank_full_vocab``.

    :param logits: logits over the vocab, or hidden states scored against
        ``embeddings [V, H]`` by a product when those are given
    :param items: candidate ids gathered before ranking: the logits' rank
        (per-row candidates) or 1-D (one list for every row)
    :param with_probabilities: False skips the softmax over the vocab
    :returns: ``(rankings, probabilities)``, rankings best first,
        probabilities None without ``with_probabilities``
    """
    if embeddings is not None:
        logits = torch.matmul(logits.float(), embeddings.float().T)
    probabilities = (torch.softmax(logits, dim=-1) if with_probabilities
                     else None)
    if items is None:
        return torch.argsort(-logits, dim=-1, stable=True), probabilities
    items = torch.as_tensor(items, device=logits.device).long()
    if items.dim() == logits.dim():
        gathered = torch.gather(logits, -1, items)
        order = torch.argsort(-gathered, dim=-1, stable=True)
        return torch.gather(items, -1, order), probabilities
    order = torch.argsort(-logits[..., items], dim=-1, stable=True)
    return items[order], probabilities
