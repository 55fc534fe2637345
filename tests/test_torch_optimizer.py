"""The port's clip + AdamW chain (bert4rec_tpu_torch/trainers/optimizers)
held against the JAX package's optax chain over three updates: the
weight-decay mask's path rule, the global-norm clip with the norm above
and below 5, and the warmup-then-decay schedule (whose first warmup step
has rate 0, so a one-step test would prove nothing)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.trainers import optimizers as jax_opt
from bert4rec_tpu_torch.ops import adamw
from bert4rec_tpu_torch.trainers import optimizers
from bert4rec_tpu_torch.utils.checkpoint import flatten, unflatten

# paths of every kind the mask must tell apart: LayerNorm scales and
# biases under *_norm, dense biases, the temporal bias table (excluded
# because its path contains "bias"), kernels and the embedding table
PATHS = {
    "encoder/embedding_norm/scale": (8,),
    "encoder/layers/layer_0/attention/qkv/kernel": (8, 3, 2, 4),
    "encoder/layers/layer_0/attention/qkv/bias": (3, 2, 4),
    "encoder/layers/layer_0/output_norm/bias": (8,),
    "encoder/temporal_attention_bias/embedding": (6, 2),
    "encoder/item_embeddings/embedding": (11, 8),
    "mlm/transform/kernel": (8, 8),
    "mlm/output_bias": (11,),
}


def tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in PATHS.items()}


def test_decay_mask_matches_jax():
    mask_fn = jax_opt._weight_decay_mask(
        jax_opt.DEFAULT_EXCLUDE_FROM_WEIGHT_DECAY)
    jmask = flatten(mask_fn(unflatten({k: jnp.zeros(1) for k in PATHS})))
    ours = optimizers.weight_decay_mask(
        optimizers.DEFAULT_EXCLUDE_FROM_WEIGHT_DECAY)
    assert {k: ours(k) for k in PATHS} == {k: bool(v)
                                           for k, v in jmask.items()}
    assert not ours("encoder/temporal_attention_bias/embedding")
    assert ours("encoder/item_embeddings/embedding")


@pytest.mark.parametrize("warmup,total", [(100, 1000), (0, 50), (3, 10)])
def test_schedule_matches_jax(warmup, total):
    ours = optimizers.create_warmup_poly_schedule(1e-3, total, warmup)
    theirs = jax_opt.create_warmup_poly_schedule(1e-3, total, warmup)
    for step in (0, 1, 2, 3, 50, 99, 100, 101, 999, 1000, 1500):
        assert ours(step) == float(theirs(step)), step


# grad scale 5 puts the global norm far above the clip bound 5, scale 0.01
# far below it; warmup 2 makes update 0 run at rate 0 and the later ones
# at rate > 0, warmup 0 decays from the start
@pytest.mark.parametrize("grad_scale", [5.0, 0.01], ids=["clipped",
                                                          "unclipped"])
@pytest.mark.parametrize("warmup", [2, 0], ids=["warmup2", "warmup0"])
def test_three_updates_match_optax(grad_scale, warmup):
    rng = np.random.default_rng(int(grad_scale * 100) + warmup)
    params = tree(rng)
    kw = dict(init_lr=1e-2, num_train_steps=20, num_warmup_steps=warmup,
              weight_decay_rate=0.1)
    jopt = jax_opt.create_adam_w_optimizer(**kw)
    jparams = unflatten({k: jnp.asarray(v) for k, v in params.items()})
    jstate = jopt.init(jparams)
    opt = optimizers.create_adam_w_optimizer(**kw)
    tparams = unflatten({k: torch.from_numpy(v.copy())
                         for k, v in params.items()})
    state = opt.init(tparams)
    norms = []
    for _ in range(3):
        g = tree(rng, grad_scale)
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                       for v in g.values()))))
        jg = unflatten({k: jnp.asarray(v) for k, v in g.items()})
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                           state, tparams)
        ref = {k: np.asarray(v) for k, v in flatten(jparams).items()}
        for k, v in flatten(tparams).items():
            # fp32 arithmetic in another order (fused multiply-adds in the
            # foreach kernels); Adam normalises by sqrt(v), so a relative
            # rounding error of the update stays relative: lr * 1e-6
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=0,
                                       atol=1e-7 + 1e-2 * 1e-5, err_msg=k)
    assert state["count"] == 3
    assert (min(norms) > 5.0) if grad_scale > 1 else (max(norms) < 5.0)


def test_factory():
    opt = optimizers.get("adamw")
    assert isinstance(opt, optimizers.AdamW)
    assert optimizers.get(opt) is opt
    with pytest.raises(ValueError):
        optimizers.get("nope")


@pytest.mark.parametrize("elements", [1, 64, 100])
def test_an_update_in_groups_of_leaves_gives_the_same_bits(monkeypatch,
                                                           elements):
    """A model over ``GROUP_ELEMENTS`` updates a group of leaves at a time
    (its temporaries bounded); the clip's norm is the whole model's, so
    every leaf gets the bits of the update in one pass."""
    rng = np.random.default_rng(4)
    start, grads = tree(rng), [tree(rng, 3.0) for _ in range(2)]

    def run():
        opt = optimizers.create_adam_w_optimizer(
            init_lr=1e-2, num_warmup_steps=0, global_clipnorm=5.0)
        params = unflatten({k: torch.from_numpy(v.copy())
                            for k, v in start.items()})
        state = opt.init(params)
        for g in grads:
            state = opt.update({k: torch.from_numpy(v) for k, v in
                                g.items()}, state, params)
        return flatten(params), flatten(state["mu"])
    whole = run()
    monkeypatch.setattr(adamw, "GROUP_ELEMENTS", elements)
    assert len(adamw._groups([torch.zeros(s) for s in PATHS.values()])) > 1
    grouped = run()
    for a, b in zip(whole, grouped):
        assert all(torch.equal(a[k], b[k]) for k in a)
