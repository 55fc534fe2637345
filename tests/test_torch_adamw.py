"""The update's wrapper (bert4rec_tpu_torch/ops/adamw.py) on the CPU: the
kernels' leaf table, the CPU route (against the JAX package's optax chain
with and without decay and with bf16 gradients, no launch counted), the
mesh hook's arguments, the decay flags and the checks the card route makes
before it launches. The kernels themselves are held against the plain
version in tests/test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.trainers import optimizers as jax_opt
from bert4rec_tpu_torch.ops import adamw
from bert4rec_tpu_torch.trainers import optimizers
from bert4rec_tpu_torch.utils.checkpoint import flatten, unflatten

C = adamw.CHUNK


def chunks_of(table, n):
    """Every chunk of a table as (leaf, first element, elements), by the
    kernels' rule: the last leaf whose first chunk is at or before it."""
    rows = table[:adamw.ROW * n].reshape(n, adamw.ROW)
    begin = table[adamw.ROW * n:]
    out = []
    for c in range(int(begin[-1])):
        leaf = int(np.searchsorted(begin[:n], c, side="right")) - 1
        start = (c - int(begin[leaf])) * C
        out.append((leaf, start, min(C, int(rows[leaf, 4]) - start)))
    return out


@pytest.mark.parametrize("numels", [
    [1, 7, 768, (1 << 20) + 3],
    [C, C + 1, 2 * C - 1, 2 * C],
    [0, 5, 0, 0, C, 0],
    [3 * C + 17],
], ids=["ragged", "edges", "empty_leaves", "one_leaf"])
def test_the_table_cuts_each_leaf_into_chunks_of_its_own(numels):
    n = len(numels)
    ptrs = [(16 * i + 1, 16 * i + 2, 16 * i + 3, 16 * i + 4)
            for i in range(n)]
    table = adamw.leaf_table(numels, ptrs, [False] * n, [False] * n)
    assert table.dtype == np.int64 and table.shape == (adamw.ROW * n + n + 1,)
    rows = table[:adamw.ROW * n].reshape(n, adamw.ROW)
    assert rows[:, :4].tolist() == [list(p) for p in ptrs]
    assert rows[:, 4].tolist() == numels
    covered = [0] * n
    for leaf, start, length in chunks_of(table, n):
        assert 0 < length <= C and start % C == 0
        assert start + length <= numels[leaf]       # never past its leaf
        assert start == covered[leaf]               # in order, no gap
        covered[leaf] += length
    assert covered == numels
    assert int(table[-1]) == sum(-(-k // C) for k in numels)


def test_the_table_counts_past_32_bits():
    """Leaves of more than 2^31 elements: counts, chunk offsets and the
    chunk total stay exact in int64."""
    numels = [(1 << 31) + 5, 3, (3 << 31) + C - 1]
    table = adamw.leaf_table(numels, [(0, 0, 0, 0)] * 3, [True] * 3,
                             [False] * 3)
    rows, begin = table[:18].reshape(3, 6), table[18:]
    assert rows[:, 4].tolist() == numels
    want = [0, (1 << 15) + 1, (1 << 15) + 2, (1 << 15) + 2 + 3 * (1 << 15)
            + 1]
    assert begin.tolist() == want
    last = int(begin[1]) - 1                      # leaf 0's last chunk
    assert (last - int(begin[0])) * C == 1 << 31  # its first element
    assert numels[0] - (1 << 31) == 5             # the ragged five


@pytest.mark.parametrize("decay,bf16", [
    ([True, False, True], [False, False, True]),
    ([False, False, False], [True, True, False]),
])
def test_the_table_flags_each_leaf(decay, bf16):
    table = adamw.leaf_table([4, 4, 4], [(0, 0, 0, 0)] * 3, decay, bf16)
    flags = table[:18].reshape(3, 6)[:, 5]
    assert flags.tolist() == [adamw.DECAY * d + adamw.BF16 * b
                              for d, b in zip(decay, bf16)]


# ---------------------------------------------------------------- the CPU
PATHS = {
    "encoder/embedding_norm/scale": (8,),
    "encoder/layers/layer_0/attention/qkv/kernel": (8, 3, 2, 4),
    "encoder/layers/layer_0/output_norm/bias": (8,),
    "encoder/item_embeddings/embedding": (11, 8),
    "encoder/pooler/kernel": (8, 8),
    "mlm/output_bias": (11,),
}


@pytest.mark.parametrize("grad_scale", [5.0, 0.01],
                         ids=["clipped", "unclipped"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0],
                         ids=["decay", "no_decay"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32_g", "bf16_g"])
def test_the_cpu_route_matches_optax_and_counts_no_launch(grad_scale,
                                                          weight_decay, bf16):
    """Three updates of the CPU route against the JAX package's optax chain
    (a bf16 gradient is given to optax as the fp32 values it holds), within
    tests/test_torch_optimizer.py's bound, and no launch counted."""
    rng = np.random.default_rng(3)
    start = {k: rng.normal(size=s).astype(np.float32)
             for k, s in PATHS.items()}
    steps = [{k: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                  * grad_scale)
              for k, s in PATHS.items()} for _ in range(3)]
    if bf16:
        steps = [{k: v.to(torch.bfloat16) for k, v in g.items()}
                 for g in steps]
    kw = dict(init_lr=1e-2, num_train_steps=20, num_warmup_steps=1,
              weight_decay_rate=weight_decay)
    jopt = jax_opt.create_adam_w_optimizer(**kw)
    jparams = unflatten({k: jnp.asarray(v) for k, v in start.items()})
    jstate = jopt.init(jparams)
    opt = optimizers.create_adam_w_optimizer(**kw)
    params = unflatten({k: torch.from_numpy(v.copy())
                        for k, v in start.items()})
    state = opt.init(params)
    before = (adamw.adamw_update.launches, adamw.adamw_update.elements)
    for g in steps:
        jg = unflatten({k: jnp.asarray(v.float().numpy())
                        for k, v in g.items()})
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        state = opt.update(g, state, params)
        ref = flatten(jparams)
        for k, v in flatten(params).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), rtol=0,
                                       atol=1e-7 + 1e-2 * 1e-5, err_msg=k)
    assert (adamw.adamw_update.launches,
            adamw.adamw_update.elements) == before


def test_the_hook_gets_a_0d_fp32_sum_a_path_in_order():
    torch.manual_seed(1)
    params = unflatten({k: torch.randn(s) for k, s in PATHS.items()})
    grads = {k: torch.randn(s) * 3 for k, s in PATHS.items()}
    seen = []

    def hook(sums):
        seen.append(sums)
        return torch.stack(list(sums.values())).sum()

    opt = optimizers.create_adam_w_optimizer(init_lr=0.1, num_warmup_steps=0)
    opt.update(grads, opt.init(params), params, sq_norm=hook)
    (sums,) = seen
    assert list(sums) == list(flatten(params))
    for k, v in sums.items():
        assert v.shape == () and v.dtype == torch.float32
        assert torch.equal(v, (grads[k] * grads[k]).sum())


def test_the_decay_mask_is_read_again_when_it_changes(monkeypatch):
    """``AdamW.update`` hands the update one decay flag a leaf, in the
    params' path order, read from ``decay_mask`` at every update."""
    flags = []
    monkeypatch.setattr(adamw, "adamw_update",
                        lambda p, g, m, v, decay, hyper, hook: flags.append(
                            list(decay)))
    opt = optimizers.create_adam_w_optimizer()
    params = unflatten({k: torch.zeros(s) for k, s in PATHS.items()})
    grads = {k: torch.zeros(s) for k, s in PATHS.items()}
    state = opt.update(grads, opt.init(params), params)
    opt.decay_mask = lambda path: False
    opt.update(grads, state, params)
    assert list(flatten(params)) == list(PATHS)
    assert flags == [[False, True, False, True, True, False],
                     [False] * len(PATHS)]


def leaves(n=3, size=8):
    return [[torch.zeros(size) for _ in range(n)] for _ in range(4)]


@pytest.mark.parametrize("fault", ["strided_param", "fp16_moment",
                                   "short_grad", "moment_size"])
def test_the_card_route_refuses_what_the_kernels_do_not_take(fault):
    p, g, m, v = leaves()
    if fault == "strided_param":
        p[1] = torch.zeros(8, 2)[:, 0]
    elif fault == "fp16_moment":
        m[2] = m[2].half()
    elif fault == "short_grad":
        g[0] = torch.zeros(7)
    else:
        v[1] = torch.zeros(9)
    hyper = adamw.Hyper(lr=1e-3, bc1=0.1, bc2=0.001, b1=0.9, b2=0.999,
                        eps=1e-6, weight_decay=0.01, clip=5.0)
    with pytest.raises(ValueError, match="leaf"):
        adamw._launch(p, g, m, v, [True] * 3, hyper, None)
