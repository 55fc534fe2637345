"""Loss and metrics (port of ``bert4rec_tpu/trainers/trainer_utils.py``):
masked sparse categorical cross-entropy over labels != 0, masked and plain
argmax accuracy, and the position counts that weight epoch means. Plain
tensor functions returning fp32 scalars; ``global_means`` turns a mesh
rank's batch-slice means into the global batch's."""

import torch

from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core.mesh import DATA_AXIS


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


def global_means(mesh, loss, logs: dict, labels) -> tuple:
    """A rank's batch-slice means -> the global batch's, on every rank:
    the loss and ``masked_accuracy`` weighted by the slices' valid
    positions, ``accuracy`` by their rows. The loss's gradient on each
    rank is its own slice's share, so the 'data' sum of the gradients
    (the trainer's) is the global mean's."""
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return loss, logs
    nv = (labels > 0).float().sum()
    counts = mesh_lib.all_reduce(
        mesh, torch.stack([nv, torch.tensor(float(labels.numel()),
                                            device=nv.device)]),
        DATA_AXIS)
    n_valid = torch.clamp(counts[0], min=1.0)
    loss = mesh_lib.psum(mesh, loss * nv, DATA_AXIS) / n_valid
    out = {}
    for k, v in logs.items():
        w, total = ((labels.numel(), counts[1]) if k == "accuracy"
                    else (nv, n_valid))
        out[k] = mesh_lib.all_reduce(mesh, (v * w).detach().clone(),
                                     DATA_AXIS) / total
    return loss, out
