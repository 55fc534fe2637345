"""Loss and metrics (port of ``bert4rec_tpu/trainers/trainer_utils.py``):
masked sparse categorical cross-entropy over labels != 0, masked and plain
argmax accuracy, and the position counts that weight epoch means. Plain
tensor functions returning fp32 scalars."""

import torch


def masked_sparse_categorical_crossentropy(y_true: torch.Tensor,
                                           logits: torch.Tensor
                                           ) -> torch.Tensor:
    """Mean NLL over positions with ``y_true != 0``: ``y_true [B, P]``
    ints (0 = padding), ``logits [B, P, V]``."""
    mask = (y_true != 0).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, y_true.long()[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_accuracy(y_true: torch.Tensor, logits: torch.Tensor
                    ) -> torch.Tensor:
    """argmax == label over non-pad positions (first index wins ties)."""
    mask = (y_true != 0).float()
    correct = (logits.argmax(dim=-1) == y_true.long()).float()
    return (correct * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def n_valid_positions(y_true: torch.Tensor) -> torch.Tensor:
    """Count of non-pad MLM positions, fp32: the weight of a batch's
    masked means in an epoch mean."""
    return (y_true != 0).float().sum()


def n_real_positions(y_true: torch.Tensor) -> torch.Tensor:
    """Positions of rows with at least one non-pad label, fp32: the
    denominator of the unmasked accuracy (a padded eval batch's fake rows
    do not count)."""
    real_rows = (y_true != 0).any(dim=-1).float()
    return real_rows.sum() * y_true.shape[-1]


def sparse_categorical_accuracy(y_true: torch.Tensor, logits: torch.Tensor
                                ) -> torch.Tensor:
    """Unmasked argmax accuracy."""
    return (logits.argmax(dim=-1) == y_true.long()).float().mean()
