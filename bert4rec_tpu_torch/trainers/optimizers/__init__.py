"""Optimizer factory (port of ``bert4rec_tpu/trainers/optimizers/__init__.py``):

    clip_by_global_norm(5.0)
    -> adamw(warmup+polynomial-decay schedule,
             weight decay masked to exclude LayerNorm/layer_norm/bias/norm)

written out as optax computes it, so a step matches the JAX chain:

- the clip is ``g * 5 / ||g||`` where ``||g|| >= 5`` (optax's
  ``(t / g_norm) * max_norm``), not ``torch.nn.utils.clip_grad_norm_``'s
  division by ``||g|| + 1e-6``;
- the learning rate of update ``n`` (counting from 0) is ``schedule(n)``,
  so under warmup the first update is zero;
- Adam's moments are bias-corrected with the count after the update, and
  the update is ``mu_hat / (sqrt(nu_hat) + eps) + wd * p`` (decay only on
  masked-in paths), times ``-lr``.

The parameters are updated in place (the JAX chain returns new arrays);
the optimizer state is ``{"count": int, "mu": tree, "nu": tree}`` with
the moments in the params' nested layout. On disk it takes optax's paths
(``optax_paths`` / ``optax_count``): the chain's Adam state is
``opt_state/1/0/{count,mu,nu}`` and its schedule's count
``opt_state/1/2/count``, both int32 and both the port's one count, so
either package resumes the other's train checkpoint.
"""

import re
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from bert4rec_tpu_torch.ops import adamw
from bert4rec_tpu_torch.utils.checkpoint import flatten, unflatten

DEFAULT_EXCLUDE_FROM_WEIGHT_DECAY = ("LayerNorm", "layer_norm", "bias",
                                     "norm", "scale_bias")


def create_warmup_poly_schedule(init_lr: float,
                                num_train_steps: int,
                                num_warmup_steps: int,
                                power: float = 1.0,
                                end_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup to ``init_lr`` then polynomial decay to ``end_lr``,
    evaluated in float32 as the JAX schedule is."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < num_warmup_steps:
            return float(f32(init_lr) * step
                         / f32(max(1.0, float(num_warmup_steps))))
        frac = np.clip(step / f32(num_train_steps), f32(0.0), f32(1.0))
        decay = (f32(init_lr) - f32(end_lr)) * (f32(1.0) - frac) \
            ** f32(power) + f32(end_lr)
        return float(decay)
    return schedule


def weight_decay_mask(exclude_patterns: Sequence[str]
                      ) -> Callable[[str], bool]:
    """``path -> bool``: decay only params whose ``/``-joined path (e.g.
    ``encoder/layers/layer_0/attention_norm/scale``) matches none of the
    excluded patterns by ``re.search`` — the JAX mask's own strings."""
    regexes = [re.compile(p) for p in exclude_patterns]
    return lambda path: not any(r.search(path) for r in regexes)


class AdamW:
    """Global-norm clip, then AdamW with a schedule and a decay mask."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01,
                 decay_mask: Callable[[str], bool] = None,
                 global_clipnorm: float = 5.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_mask = decay_mask or weight_decay_mask(
            DEFAULT_EXCLUDE_FROM_WEIGHT_DECAY)
        self.global_clipnorm = global_clipnorm

    def init(self, params: dict) -> dict:
        flat = flatten(params)
        zeros = {k: torch.zeros_like(v, dtype=torch.float32)
                 for k, v in flat.items()}
        return {"count": 0, "mu": unflatten(zeros),
                "nu": unflatten({k: torch.zeros_like(v)
                                 for k, v in zeros.items()})}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: dict, sq_norm: Optional[Callable] = None) -> dict:
        """Apply one update to ``params`` in place; returns the new
        state. ``grads`` is ``{path: tensor}`` for every param path.
        ``sq_norm`` maps ``{path: leaf's sum of squares}`` to the global
        squared norm (on a mesh: the sharded leaves' sums added over the
        'model' axis, the replicated ones once); by default their sum.
        On the card the update is ``ops/adamw.py``'s kernels, on the CPU
        its plain version."""
        flat = flatten(params)
        paths = list(flat)
        mu_flat, nu_flat = flatten(state["mu"]), flatten(state["nu"])
        hook = None if sq_norm is None else (
            lambda sums: sq_norm(dict(zip(paths, sums))))
        adamw.adamw_update([flat[k] for k in paths],
                           [grads[k] for k in paths],
                           [mu_flat[k] for k in paths],
                           [nu_flat[k] for k in paths],
                           [bool(self.decay_mask(k)) for k in paths],
                           self.hyper(state["count"]), hook)
        return {"count": state["count"] + 1, "mu": state["mu"],
                "nu": state["nu"]}

    def hyper(self, count: int) -> adamw.Hyper:
        """The scalars of the update that follows ``count`` updates: the
        schedule's rate at ``count`` and the bias corrections with the count
        after it, in float32 as optax computes them."""
        f32 = np.float32
        return adamw.Hyper(
            lr=self.schedule(count),
            bc1=float(f32(1.0) - f32(self.b1) ** f32(count + 1)),
            bc2=float(f32(1.0) - f32(self.b2) ** f32(count + 1)),
            b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, clip=self.global_clipnorm)


# where optax's chain(clip_by_global_norm, adamw) keeps its state: element 1
# of the chain is adamw's own chain, whose element 0 is scale_by_adam
# (count, mu, nu) and element 2 scale_by_schedule (count); the clip and the
# masked weight decay keep no leaves
ADAM_PATH = "opt_state/1/0"
SCHEDULE_PATH = "opt_state/1/2"


def optax_paths(state: dict) -> dict:
    """The port's optimizer state as the leaves optax's chain saves, keyed
    by their checkpoint paths: ``opt_state/1/0/count``, ``.../mu/<param
    path>``, ``.../nu/<param path>`` and ``opt_state/1/2/count``. Each
    count is the port's count as int32."""
    count = np.int32(state["count"])
    flat = {f"{ADAM_PATH}/count": count, f"{SCHEDULE_PATH}/count": count}
    for name in ("mu", "nu"):
        flat.update({f"{ADAM_PATH}/{name}/{k}": v
                     for k, v in flatten(state[name]).items()})
    return flat


def optax_count(stored: dict, source="checkpoint") -> int:
    """The count of a checkpoint's leaves in optax's layout (the moments
    are ``ADAM_PATH/mu/...`` and ``ADAM_PATH/nu/...``, keyed by their param
    paths). Raises ValueError when the Adam count and the schedule's count
    differ: the port keeps one."""
    counts = {p: int(stored[f"{p}/count"])
              for p in (ADAM_PATH, SCHEDULE_PATH) if f"{p}/count" in stored}
    if ADAM_PATH not in counts:
        raise KeyError(f"{source} is missing leaf {ADAM_PATH + '/count'!r}")
    if len(set(counts.values())) != 1:
        raise ValueError(f"{source} keeps the Adam count {counts[ADAM_PATH]}"
                         f" and the schedule count "
                         f"{counts.get(SCHEDULE_PATH)}; the port's "
                         f"optimizer keeps one count for both")
    return counts[ADAM_PATH]


def create_adam_w_optimizer(
        init_lr: float = 1e-4,
        num_train_steps: int = 400000,
        num_warmup_steps: int = 100,
        weight_decay_rate: float = 0.01,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        epsilon: float = 1e-6,
        exclude_from_weight_decay: Sequence[str] =
        DEFAULT_EXCLUDE_FROM_WEIGHT_DECAY,
        global_clipnorm: float = 5.0,
        power: float = 1.0) -> AdamW:
    schedule = create_warmup_poly_schedule(
        init_lr, num_train_steps, num_warmup_steps, power)
    return AdamW(schedule, b1=beta_1, b2=beta_2, eps=epsilon,
                 weight_decay=weight_decay_rate,
                 decay_mask=weight_decay_mask(exclude_from_weight_decay),
                 global_clipnorm=global_clipnorm)


optimizers_map = {
    "adamw": create_adam_w_optimizer,
    "adam_w": create_adam_w_optimizer,
}


def get(identifier: Union[str, AdamW] = "adamw", **kwargs) -> AdamW:
    """Factory (the JAX ``optimizers.get``)."""
    if isinstance(identifier, AdamW):
        return identifier
    if identifier in optimizers_map:
        return optimizers_map[identifier](**kwargs)
    raise ValueError(f"{identifier} is not a known optimizer identifier!")


__all__ = ["AdamW", "create_adam_w_optimizer", "create_warmup_poly_schedule",
           "weight_decay_mask", "optimizers_map", "get",
           "DEFAULT_EXCLUDE_FROM_WEIGHT_DECAY", "optax_paths",
           "optax_count", "ADAM_PATH", "SCHEDULE_PATH"]
