"""The item table's gather and its gradient (``ops/table_gradient.py``) on
the CPU: the forward is today's ``table[ids.long()].to(dtype)`` bit for
bit; the plain backward (``index_add_`` in fp32) equals autograd's
gradient of that indexing, in float64, at [PAD] and [MASK] runs as long as
a batch's, with untouched rows 0, at the shipped widths and in both compute
dtypes; the sharded lookup's local ids go through the same Function; under
``no_grad``, ``inference_mode`` and export the gather never enters it.

Imports neither JAX nor ``bert4rec_tpu``. The kernel's own tests run on a
card (``tests/test_torch_cuda_kernels.py``, ``-k table_grad``).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel, export
from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.ops import table_gradient as tg

# ml-20m_128's batch: 51,200 positions, 27,623 [PAD] and 4,630 [MASK] ids
BATCH_IDS = (51_200, 26_732, 27_623, 4_630)


def batch_ids(r, v, pad, mask, seed=0) -> torch.Tensor:
    """int32 ids: ``pad`` zeros in runs at the rows' heads of ``[r // 200,
    200]`` sequences, ``mask`` [MASK] ids (v - 1) among the rest, items
    elsewhere."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, max(v - 1, 2), size=r).astype(np.int32)
    at = rng.permutation(r)
    ids[at[:pad]] = 0
    ids[at[pad:pad + mask]] = v - 1
    return torch.from_numpy(ids)


def grads(table, ids, g, dtype):
    """(the Function's gradient, autograd's of today's indexing)."""
    t1 = table.detach().clone().requires_grad_(True)
    t2 = table.detach().clone().requires_grad_(True)
    (d1,) = torch.autograd.grad(tg.table_gather(t1, ids, dtype), t1, g)
    (d2,) = torch.autograd.grad(t2[ids.long()].to(dtype), t2, g)
    return d1, d2


@pytest.mark.parametrize("h", [48, 64, 128, 768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_is_todays_gather_bit_for_bit(h, dtype):
    table = torch.randn(97, h, requires_grad=True)
    ids = batch_ids(600, 97, 250, 60).view(3, 200)
    got = tg.table_gather(table, ids, dtype)
    assert got.dtype == dtype and got.grad_fn is not None
    assert torch.equal(got, table.detach()[ids.long()].to(dtype))


@pytest.mark.parametrize("h", [48, 64, 128, 768])
def test_gradient_equals_autograd_in_float64(h):
    v = 61
    ids = batch_ids(400, v, 170, 40).view(2, 200)
    table = torch.randn(v, h, dtype=torch.float64)
    g = torch.randn(2, 200, h, dtype=torch.float64)
    d1, d2 = grads(table, ids, g, torch.float64)
    assert d1.dtype == torch.float64
    torch.testing.assert_close(d1, d2, rtol=1e-12, atol=1e-12)


def test_gradient_at_a_batchs_pad_and_mask_runs():
    r, v, pad, mask = BATCH_IDS
    ids = batch_ids(r, v, pad, mask, seed=1).view(-1, 200)
    table = torch.randn(v, 8, dtype=torch.float64)
    g = torch.randn(*ids.shape, 8, dtype=torch.float64)
    d1, d2 = grads(table, ids, g, torch.float64)
    torch.testing.assert_close(d1, d2, rtol=1e-10, atol=1e-10)
    # the [PAD] row keeps its gradient: 27,623 rows' sum, as JAX's jnp.take
    flat = g.reshape(-1, 8)
    torch.testing.assert_close(d1[0], flat[ids.reshape(-1) == 0].sum(0))
    torch.testing.assert_close(d1[v - 1],
                               flat[ids.reshape(-1) == v - 1].sum(0))


def test_untouched_rows_are_zero():
    ids = torch.tensor([[0, 0, 5, 5, 9]], dtype=torch.int32)
    table = torch.randn(12, 16, requires_grad=True)
    y = tg.table_gather(table, ids)
    (d,) = torch.autograd.grad(y, table, torch.randn_like(y))
    untouched = [i for i in range(12) if i not in (0, 5, 9)]
    assert torch.equal(d[untouched], torch.zeros(len(untouched), 16))
    assert bool((d[[0, 5, 9]] != 0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_compute_dtype_gradient_is_fp32(dtype):
    """The backward reads g in the compute dtype and sums in fp32: exact on
    integer-valued g, and within fp32 rounding of today's cast-then-index
    backward on random g. Both sum a row's n terms in fp32 in orders of
    their own, so each is within n * 2^-24 * (the row's sum of |g|) of the
    float64 sum (g is exact in fp32), and they are within twice that of
    each other; a fixed tolerance does not scale with the 400-term [PAD]
    row."""
    v, h = 50, 64
    gen = torch.Generator().manual_seed(3)
    ids = batch_ids(1_000, v, 400, 100, seed=2).view(5, 200)
    table = torch.randn(v, h, generator=gen)
    ints = torch.randint(-4, 5, (5, 200, h), generator=gen).to(dtype)
    d1, d2 = grads(table, ids, ints, dtype)
    assert d1.dtype == torch.float32 and torch.equal(d1, d2)
    g = torch.randn(5, 200, h, generator=gen).to(dtype)
    d1, d2 = grads(table, ids, g, dtype)
    want = tg.table_gradient_plain(g.double(), ids, v)
    terms = torch.bincount(ids.reshape(-1).long(), minlength=v)
    bound = terms.double()[:, None] * 2.0 ** -24 * tg.table_gradient_plain(
        g.double().abs(), ids, v)
    assert bool(((d1.double() - want).abs() <= bound).all())
    assert bool(((d1 - d2).double().abs() <= 2 * bound).all())


def test_int64_ids_are_taken_as_int32():
    table = torch.randn(20, 8, requires_grad=True)
    ids = torch.randint(0, 20, (3, 7))
    y = tg.table_gather(table, ids)
    (d,) = torch.autograd.grad(y, table, torch.ones_like(y))
    assert torch.equal(d[:, 0], torch.bincount(ids.reshape(-1),
                                               minlength=20).float())


class _Rank:
    """A mesh stand-in for one rank of the 'model' axis."""

    def __init__(self, rank):
        self.rank = rank

    def index(self, axis):
        return self.rank


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_sharded_lookup_goes_through_the_function(rank):
    """Each rank's local ids (rows it does not own read local row 0 and
    add it zeros) give today's gradient of its block, through the
    Function."""
    from bert4rec_tpu_torch.core import mesh as mesh_lib
    v_local, h = 7, 16
    ids = torch.randint(0, 3 * v_local, (4, 10), dtype=torch.int32)
    ids[:, :3] = 0
    block = torch.randn(v_local, h, dtype=torch.float64, requires_grad=True)
    g = torch.randn(4, 10, h, dtype=torch.float64)
    calls = []
    real = tg.table_gradient

    def counted(*a):
        calls.append(a[1].dtype)
        return real(*a)

    with mock.patch.object(mesh_lib, "psum", lambda mesh, x, axis: x), \
            mock.patch.object(tg, "table_gradient", counted):
        y = L.sharded_embedding_lookup({"embedding": block}, ids,
                                       _Rank(rank), torch.float64)
        (d1,) = torch.autograd.grad(y, block, g)
    assert calls == [torch.int32]
    local = ids.long() - rank * v_local
    owned = (local >= 0) & (local < v_local)
    t2 = block.detach().clone().requires_grad_(True)
    rows = t2[torch.where(owned, local, torch.zeros_like(local))]
    y2 = torch.where(owned[..., None], rows, torch.zeros_like(rows))
    (d2,) = torch.autograd.grad(y2, t2, g)
    assert torch.equal(y.detach(), y2.detach())
    torch.testing.assert_close(d1, d2, rtol=1e-12, atol=1e-12)


def _refusing_function():
    def refuse(*args):
        raise AssertionError("the gather entered _TableGather")
    return mock.patch.object(tg._TableGather, "apply", refuse)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "no_requires_grad"])
def test_no_grad_routes_are_todays_indexing(mode):
    table = torch.randn(30, 16, requires_grad=mode != "no_requires_grad")
    ids = torch.randint(0, 30, (2, 9), dtype=torch.int32)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_requires_grad": torch.enable_grad}[mode]
    with _refusing_function(), ctx():
        got = L.embedding_lookup({"embedding": table}, ids, torch.bfloat16)
    assert got.grad_fn is None
    assert torch.equal(got, table.detach()[ids.long()].to(torch.bfloat16))


def test_export_never_enters_the_function():
    cfg = BERT4RecConfig(vocab_size=41, hidden_size=32, num_layers=1,
                         num_attention_heads=4, inner_dim=64,
                         max_sequence_length=12, max_predictions_per_seq=3)
    model = BERT4RecModel(config=cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for leaf in (params["encoder"]["item_embeddings"]["embedding"],):
        leaf.requires_grad_(True)
    with _refusing_function():
        art = export.export_top_k(model, params, 5)
    assert art is not None


def test_plain_route_counts_no_launch():
    """``table_gradient.launches`` counts kernel launches only: a backward
    on the plain version leaves it as it was."""
    table = torch.randn(30, 16, requires_grad=True)
    ids = torch.randint(0, 30, (2, 9), dtype=torch.int32)
    before = tg.table_gradient.launches
    y = tg.table_gather(table, ids, torch.bfloat16)
    torch.autograd.grad(y, table, torch.ones_like(y))
    assert tg.table_gradient.launches == before
