"""The port's vocab-tiled loss (K5 forward, K6 / K7 backward;
bert4rec_tpu_torch/ops/fused_mlm_loss.py) held against the JAX package's
Pallas kernels run in interpret mode on the CPU: ``_run_forward_tiled``,
``_run_forward_tiled_stats``, ``_run_backward_merged`` and
``_run_backward_tiled`` (two sweeps forced by patching
``_MERGED_DH_BYTES``, as JAX's own test does), with the ``valid_ge_zero``
label encoding, all-padding rows and vocabularies off every tile; the
merged-versus-two-sweep law; and the autograd entry point. The CUDA
kernels are held against these plain versions on a card in
tests/test_torch_cuda_kernels.py.

Tolerances, fp32: the loss sum within 2e-5 relative, lse and the stats
within 1e-5, gradients within 3e-4 of their scale (the same math summed in
another order). bf16 gradients: 5e-3 of their scale, because dlog is
rounded to bf16 in both and a sum-order difference can flip that
rounding."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.ops import fused_mlm_loss as jax_fml
from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
from bert4rec_tpu_torch.ops import tf32


def inputs(rows, v, vp, w, seed, labels="mixed"):
    """hidden [rows, w], table [vp, w], bias [vp], labels [rows]: ``vp - v``
    config-padding columns; labels ``mixed`` (random, every 5th 0),
    ``padding`` (all 0), ``sharded`` (the backward's valid_ge_zero
    encoding: local ids, a sentinel past the table for remote labels, -1
    for none), ``sharded_fwd`` (the forward's: local ids with 0, -2 for
    remote or none) or ``edges`` (every 7th 0, then column 0, the last
    real and the last padded column, -1 and -2)."""
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(rows, w)).astype(np.float32)
    table = (rng.normal(size=(vp, w)) * 0.3).astype(np.float32)
    bias = rng.normal(size=vp).astype(np.float32)
    lab = rng.integers(1, v, size=rows).astype(np.int32)
    if labels == "mixed":
        lab[::5] = 0
    elif labels == "padding":
        lab[:] = 0
    elif labels == "sharded":
        lab[::4] = -1
        lab[1::4] = vp + 7
    elif labels == "sharded_fwd":
        lab[::3] = -2
        lab[1::6] = 0
    elif labels == "edges":
        lab[::7] = 0
        lab[:5] = [0, v - 1, vp - 1, -1, -2]
    return hidden, table, bias, lab


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _plain_operands(h, t, b, lab, v, dtype):
    ht = torch.from_numpy(h).to(dtype)
    return (ht, torch.from_numpy(t).to(dtype),
            fml._mask_bias(torch.from_numpy(b), v), torch.from_numpy(lab))


# (rows, vocab, padded vocab, width): 300 rows are one JAX row tile off its
# 1,024 grid; 97 < 104 columns carry the -1e9 bias and neither is a
# multiple of a tile; 1,100 x 2,100 spans two row and three vocab tiles
SHAPES = [(300, 97, 104, 32), (1100, 2100, 2100, 16)]
SHAPE_IDS = ["ragged_padded", "two_row_tiles"]


class TestForward:

    @pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
    @pytest.mark.parametrize("labels", ["mixed", "padding"])
    def test_forward_matches_interpret_kernel(self, shape, labels):
        rows, v, vp, w = shape
        h, t, b, lab = inputs(rows, v, vp, w, rows + w, labels)
        loss_sum, cv, ca, nv, lse, n = jax_fml._run_forward_tiled(
            jnp.asarray(h), jnp.asarray(t), jnp.asarray(b), jnp.asarray(lab),
            v, True)
        plse, sums = fml.fused_mlm_loss_plain_forward(
            *_plain_operands(h, t, b, lab, v, torch.float32))
        assert n == rows
        assert abs(float(sums[0]) - float(loss_sum)) <= \
            2e-5 * max(abs(float(loss_sum)), 1e-6)
        assert [float(x) for x in sums[1:]] == \
            [float(cv), float(ca), float(nv)]
        np.testing.assert_allclose(plse.numpy(),
                                   np.asarray(lse)[:rows, 0], rtol=1e-5)
        if labels == "padding":     # JAX's boundary sweep: loss 0, nv 0
            assert float(sums[0]) == 0.0 and float(sums[3]) == 0.0

    @pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
    @pytest.mark.parametrize("labels", ["mixed", "sharded_fwd"])
    def test_stats_match_interpret_kernel(self, shape, labels):
        rows, v, vp, w = shape
        h, t, b, lab = inputs(rows, v, vp, w, rows, labels)
        m, s, ll = jax_fml._run_forward_tiled_stats(
            jnp.asarray(h), jnp.asarray(t), jnp.asarray(b), jnp.asarray(lab),
            v, True)
        got = fml.fused_mlm_loss_tiled_stats(
            torch.from_numpy(h), torch.from_numpy(t), torch.from_numpy(b),
            torch.from_numpy(lab), v)
        for g, r in zip(got, (m, s, ll)):
            assert g.shape == (rows,)
            np.testing.assert_allclose(g.numpy(), np.asarray(r)[:, 0],
                                       rtol=1e-5, atol=1e-5)


def _jax_backward(h, t, b, lab, v, two_sweep, vge0):
    """JAX's interpret-mode K6 (``_run_backward_merged``) or K7 (two sweeps,
    forced as JAX's own test does) from its K5's lse, g = 0.75; returns the
    numpy gradients, the lse and n_valid."""
    rows = h.shape[0]
    hj, tj, bj, labj = (jnp.asarray(x) for x in (h, t, b, lab))
    _, _, _, nv, lse, _ = jax_fml._run_forward_tiled(hj, tj, bj, labj, v, True)
    lse = lse[:rows]
    run = jax_fml._run_backward_tiled if two_sweep \
        else jax_fml._run_backward_merged
    with mock.patch.object(jax_fml, "_MERGED_DH_BYTES",
                           0 if two_sweep else jax_fml._MERGED_DH_BYTES):
        grads = run(hj, tj, bj, labj, lse, jnp.float32(0.75), nv, v, True,
                    valid_ge_zero=vge0)
    return ([np.asarray(x) for x in grads], np.array(lse)[:, 0],
            float(nv))


class TestBackward:

    @pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
    @pytest.mark.parametrize("two_sweep", [False, True],
                             ids=["merged_K6", "two_sweep_K7"])
    @pytest.mark.parametrize("labels", ["mixed", "sharded", "padding"])
    def test_backward_matches_interpret_kernel(self, shape, two_sweep,
                                               labels):
        rows, v, vp, w = shape
        vge0 = labels == "sharded"
        h, t, b, lab = inputs(rows, v, vp, w, rows + 1, labels)
        jgrads, lse, nv = _jax_backward(h, t, b, lab, v, two_sweep, vge0)
        ht, tt, bt, labt = _plain_operands(h, t, b, lab, v, torch.float32)
        dh, dt, db = fml.fused_mlm_loss_plain_backward(
            ht, tt, bt, labt, torch.from_numpy(lse), torch.tensor(0.75),
            torch.tensor(nv), valid_ge_zero=vge0)
        assert dh.shape == (rows, w) and dt.shape == (vp, w)
        for got, ref in zip((dh, dt, db), jgrads):
            if not np.abs(ref).any():       # all-padding rows: all zero
                assert not got.numpy().any()
                continue
            assert _rel_err(got.numpy(), ref) <= 3e-4

    @pytest.mark.parametrize("rows,w,merged", [
        (1024, 1344, True), (1025, 1344, False), (10240, 128, True),
        (10240, 256, False), (2048, 128, True), (300, 32, True)])
    def test_merged_law_matches_jax(self, rows, w, merged):
        """K6 where JAX runs ``_run_backward_merged``, K7 where it runs two
        sweeps: ml-20m_128 (R = 256 x 40, W = 128) takes K6, ml-20m_256
        takes K7."""
        assert fml.merged_backward(rows, w) is merged

        class Merged(Exception):
            pass

        class TwoSweep(Exception):
            pass

        with mock.patch.object(jax_fml, "_run_backward_merged",
                               side_effect=Merged), \
                mock.patch.object(jax_fml.pl, "pallas_call",
                                  side_effect=TwoSweep), \
                pytest.raises(Merged if merged else TwoSweep):
            jax_fml._run_backward_tiled(
                jnp.zeros((rows, w)), jnp.zeros((8, w)), jnp.zeros(8),
                jnp.zeros(rows, jnp.int32), jnp.zeros((rows, 1)), 1.0, 1.0,
                8, True)


class TestThreeTf32:
    """The rounding law of fp32 K6 / K7 (csrc/loss_tf32.cuh), emulated on
    the CPU with ``ops/tf32.py``: the logits, dh and dtable each a 3xTF32
    product (hi / lo split by cvt.rna, three products summed in fp32), dlog
    split where it is formed, dbias summing the unsplit dlog. The emulated
    backward stays within TestBackward's 3e-4 of JAX's interpret K6 and K7
    and within 1e-5 of the plain fp32 backward; one TF32 pass lands at
    least 10x further from the plain fp32 backward."""

    @staticmethod
    def _backward(mm, h, t, b, lab, lse, g, n_valid, valid_ge_zero):
        logits = mm(h, t.T) + b
        scale = g / max(n_valid, 1.0)
        col = torch.arange(logits.shape[1])
        onehot = (col[None, :] == lab.long()[:, None]).float()
        valid = lab >= 0 if valid_ge_zero else lab > 0
        dlog = (torch.exp(logits - lse[:, None]) - onehot) \
            * (valid.float() * scale)[:, None]
        return mm(dlog, t), mm(dlog.T, h), dlog.sum(dim=0)

    @pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
    @pytest.mark.parametrize("two_sweep", [False, True],
                             ids=["merged_K6", "two_sweep_K7"])
    @pytest.mark.parametrize("labels", ["mixed", "sharded", "padding"])
    def test_3xtf32_backward_matches_jax_and_plain(self, shape, two_sweep,
                                                   labels):
        rows, v, vp, w = shape
        vge0 = labels == "sharded"
        h, t, b, lab = inputs(rows, v, vp, w, rows + 1, labels)
        jgrads, lse, nv = _jax_backward(h, t, b, lab, v, two_sweep, vge0)
        ops = _plain_operands(h, t, b, lab, v, torch.float32)
        lse_t = torch.from_numpy(lse)
        plain = fml.fused_mlm_loss_plain_backward(
            *ops, lse_t, torch.tensor(0.75), torch.tensor(nv),
            valid_ge_zero=vge0)
        got3 = self._backward(tf32.mm_3xtf32, *ops, lse_t, 0.75, nv, vge0)
        got1 = self._backward(tf32.mm_tf32, *ops, lse_t, 0.75, nv, vge0)
        for g3, g1, p, j in zip(got3, got1, plain, jgrads):
            if not np.abs(j).any():     # all-padding rows: all zero
                assert not g3.numpy().any() and not p.numpy().any()
                continue
            assert _rel_err(g3.numpy(), j) <= 3e-4
            err3 = _rel_err(g3.numpy(), p.numpy())
            err1 = _rel_err(g1.numpy(), p.numpy())
            assert err3 <= 1e-5, err3
            assert err1 >= 10 * err3, (err1, err3)


class TestThreeTf32Forward:
    """The rounding law of fp32 K5 (csrc/loss_tf32.cuh's forward sweep,
    fp32 K3's), emulated on the CPU with ``ops/tf32.py``: the logits a
    3xTF32 product (hi / lo split by cvt.rna, three products summed in
    fp32), the max, sum of exponentials, label logit, lse and sums from
    them in fp32. Both entries against JAX's interpret-mode
    ``_run_forward_tiled`` / ``_run_forward_tiled_stats`` and the plain
    fp32 forward: lse, the loss sum and ``(m, s, ll)`` within 1e-4 of
    JAX's and 1e-5 of the plain version's, the counts equal; one TF32 pass
    lands at least 10x further from the plain version. ``edges`` puts
    labels on the table's first, last real and last padded columns and at
    -1 and -2, which match no column in either package. (A label at or
    past the padded table's end also matches none in the port, where JAX's
    padding of the vocabulary to 1,024 columns gives it a -1e9 column: a
    difference by design, held against the plain version on the card.)"""

    @staticmethod
    def _stats(mm, h, t, b, lab):
        logits = mm(h, t.T) + b
        m = logits.amax(dim=-1)
        s = torch.exp(logits - m[:, None]).sum(dim=-1)
        return m, s, fml._label_logit(logits, lab)

    @classmethod
    def _forward(cls, mm, h, t, b, lab):
        m, s, ll = cls._stats(mm, h, t, b, lab)
        lse = m + torch.log(s)
        w = (lab > 0).float()
        correct = ((ll >= m) & (lab >= 0)).float()
        return lse, torch.stack([((lse - ll) * w).sum(), (correct * w).sum(),
                                 correct.sum(), w.sum()])

    @staticmethod
    def _closer(got3, got1, plain, jax_ref):
        """Within 1e-4 of JAX's, 1e-5 of the plain version's, one TF32 pass
        at least 10x further from the plain version."""
        assert _rel_err(got3, jax_ref) <= 1e-4
        err3, err1 = _rel_err(got3, plain), _rel_err(got1, plain)
        assert err3 <= 1e-5, err3
        assert err1 >= 10 * err3, (err1, err3)

    @pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
    @pytest.mark.parametrize("labels", ["mixed", "padding", "sharded_fwd",
                                        "edges"])
    def test_3xtf32_forward_matches_jax_and_plain(self, shape, labels):
        rows, v, vp, w = shape
        h, t, b, lab = inputs(rows, v, vp, w, rows + w, labels)
        loss_sum, cv, ca, nv, jlse, n = jax_fml._run_forward_tiled(
            jnp.asarray(h), jnp.asarray(t), jnp.asarray(b), jnp.asarray(lab),
            v, True)
        ops = _plain_operands(h, t, b, lab, v, torch.float32)
        plse, psums = fml.fused_mlm_loss_plain_forward(*ops)
        lse3, sums3 = self._forward(tf32.mm_3xtf32, *ops)
        lse1, _ = self._forward(tf32.mm_tf32, *ops)
        assert n == rows
        self._closer(lse3.numpy(), lse1.numpy(), plse.numpy(),
                     np.asarray(jlse)[:rows, 0])
        assert abs(float(sums3[0]) - float(psums[0])) <= \
            1e-5 * max(abs(float(psums[0])), 1e-6)
        assert abs(float(sums3[0]) - float(loss_sum)) <= \
            1e-4 * max(abs(float(loss_sum)), 1e-6)
        assert [float(x) for x in sums3[1:]] == \
            [float(cv), float(ca), float(nv)] == \
            [float(x) for x in psums[1:]]
        if labels == "padding":
            assert float(sums3[0]) == 0.0 and float(sums3[3]) == 0.0

    @pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
    @pytest.mark.parametrize("labels", ["mixed", "padding", "sharded_fwd",
                                        "edges"])
    def test_3xtf32_stats_match_jax_and_plain(self, shape, labels):
        rows, v, vp, w = shape
        h, t, b, lab = inputs(rows, v, vp, w, rows, labels)
        jstats = jax_fml._run_forward_tiled_stats(
            jnp.asarray(h), jnp.asarray(t), jnp.asarray(b), jnp.asarray(lab),
            v, True)
        ops = _plain_operands(h, t, b, lab, v, torch.float32)
        plain = fml.fused_mlm_loss_plain_stats(*ops)
        got3 = self._stats(tf32.mm_3xtf32, *ops)
        got1 = self._stats(tf32.mm_tf32, *ops)
        for g3, g1, p, j in zip(got3, got1, plain, jstats):
            assert g3.shape == (rows,)
            self._closer(g3.numpy(), g1.numpy(), p.numpy(),
                         np.asarray(j)[:, 0])


class TestForwardSplitLaw:
    """K5's vocabulary splits and workspace in each dtype, decided in
    Python before any launch (the card tests hold the library's workspace
    bytes to these): fp32 K5 runs fp32 K3's sweep and its law."""

    @pytest.mark.parametrize("rows, v, w, splits", [
        (10240, 26732, 128, 13),   # ML-20M's batch: 80 row blocks x 13
        (10240, 26732, 256, 4),    # 64-row tiles, 32-entry tiles: 160 x 4
        (10240, 26732, 64, 13),
        (2048, 335424, 128, 64),   # Reddit's V, R cut to 2,048: 16 x 64
        (10240, 335424, 128, 13),  # the Reddit preset's batch
        (300, 104, 32, 2),         # two 64-entry tiles, 3 row blocks
        (77, 61, 256, 2),          # two 32-entry tiles, 2 row tiles
        (1, 61, 128, 1),
    ], ids=lambda v: str(v))
    def test_fp32_splits_by_the_tf32_sweep_law(self, rows, v, w, splits):
        """fp32 K5 (and K3): 128-row blocks, 64-entry tiles and ~1,024
        blocks at W <= 128, bf16 K5's law there; 64-row tiles, 32-entry
        tiles and ~512 blocks at W > 128."""
        assert fml.tiled_forward_splits(rows, v, w, torch.float32) == splits
        assert fml.whole_table_splits(rows, v, w, torch.float32) == splits
        if w <= 128:
            assert fml.tiled_forward_splits(rows, v, w) == splits

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                             ids=["bf16", "fp32"])
    @pytest.mark.parametrize("rows, v, w", [
        (10240, 26732, 128), (10240, 26732, 256), (2048, 335424, 128),
        (10240, 335424, 128), (300, 104, 32)], ids=lambda v: str(v))
    def test_workspace_bytes(self, rows, v, w, dtype):
        """The splits' (max, sum, label logit) rows and the 256-row block
        sums, each carved to 256 bytes, with no V x W term."""
        up = lambda n: -(-n // 256) * 256  # noqa: E731
        n = fml.tiled_forward_splits(rows, v, w, dtype) * rows
        assert fml.tiled_forward_workspace_bytes(rows, v, w, dtype) == \
            3 * up(4 * n) + up(16 * -(-rows // 256))
        assert fml.tiled_forward_workspace_bytes(rows, v, w, dtype) == \
            fml.whole_table_workspace_bytes(rows, v, w, dtype)


class TestAutograd:

    @pytest.mark.parametrize("dtype,tol", [
        (torch.float32, 3e-4), (torch.bfloat16, 5e-3)], ids=["fp32", "bf16"])
    @pytest.mark.parametrize("two_sweep", [False, True],
                             ids=["merged", "two_sweep"])
    def test_fused_mlm_loss_tiled_matches_jax(self, dtype, tol, two_sweep):
        rows, v, vp, w = 300, 97, 104, 32
        h, t, b, lab = inputs(rows, v, vp, w, 11)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        import jax

        def f(h_, t_, b_):
            loss, cv, ca, nv = jax_fml.fused_mlm_loss_tiled(
                h_, t_, b_, jnp.asarray(lab), v, True)
            return loss, (cv, ca, nv)

        with mock.patch.object(jax_fml, "_MERGED_DH_BYTES",
                               0 if two_sweep else jax_fml._MERGED_DH_BYTES):
            (jloss, jcounts), jg = jax.value_and_grad(
                f, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(h).astype(jdt), jnp.asarray(t), jnp.asarray(b))
        ht = torch.from_numpy(h).to(dtype).requires_grad_(True)
        tt = torch.from_numpy(t).requires_grad_(True)
        bt = torch.from_numpy(b).requires_grad_(True)
        before = (fml.fused_mlm_loss_tiled.launches,
                  fml.fused_mlm_loss_tiled.merged_launches,
                  fml.fused_mlm_loss_tiled.two_sweep_launches)
        loss, cv, ca, nv = fml.fused_mlm_loss_tiled(ht, tt, bt,
                                                    torch.from_numpy(lab), v)
        loss.backward()
        # the plain versions run on the CPU: nothing is counted
        assert (fml.fused_mlm_loss_tiled.launches,
                fml.fused_mlm_loss_tiled.merged_launches,
                fml.fused_mlm_loss_tiled.two_sweep_launches) == before
        assert abs(float(loss.detach()) - float(jloss)) <= \
            2e-5 * abs(float(jloss))
        assert [float(cv), float(ca), float(nv)] == \
            [float(c) for c in jcounts]
        for got, ref in ((ht.grad, jg[0]), (tt.grad, jg[1]),
                         (bt.grad, jg[2])):
            assert _rel_err(got.float().numpy(),
                            np.asarray(ref, np.float32)) <= tol
        assert not bt.grad[v:].any()

    def test_mlm_loss_and_metrics_routes_a_large_table_to_the_tiled_loss(
            self):
        """A 7,000 x 64 table fails JAX's whole-table VMEM law, so both
        packages take the tiled kernels; the loss and metrics agree."""
        rows, v, vp, w = 24, 6990, 7000, 64
        assert not fml.fused_loss_supported(vp, w)
        h, t, b, lab = inputs(rows, v, vp, w, 5)
        jl, jlogs = jax_fml.mlm_loss_and_metrics(
            jnp.asarray(h).reshape(4, 6, w), jnp.asarray(t), jnp.asarray(b),
            jnp.asarray(lab).reshape(4, 6), v, interpret=True)
        with mock.patch.object(fml, "fused_mlm_loss",
                               side_effect=AssertionError("K3 path")):
            tl, tlogs = fml.mlm_loss_and_metrics(
                torch.from_numpy(h).reshape(4, 6, w), torch.from_numpy(t),
                torch.from_numpy(b), torch.from_numpy(lab).reshape(4, 6), v)
        assert abs(float(tl) - float(jl)) <= 2e-5 * float(jl)
        for k in ("masked_accuracy", "accuracy"):
            assert float(tlogs[k]) == pytest.approx(float(jlogs[k]),
                                                    abs=1e-7)


class TestKernelLayoutRule:
    """The bf16 K4-K7 kernels copy 16-byte pieces of each operand row into
    shared memory: ``check_copy_alignment`` decides in Python, before the
    kernel library is reached, which bf16 layouts they take; widths below
    a wgmma width (64, 128, 256) are zero-filled, which the plain version
    shows to be exact."""

    @staticmethod
    def _bf16(rows, w):
        return torch.zeros((rows, w), dtype=torch.bfloat16)

    @pytest.mark.parametrize("w", [8, 32, 40, 64, 128, 256])
    def test_contiguous_rows_of_16_bytes_are_accepted(self, w):
        fml.check_copy_alignment(self._bf16(77, w), "hidden")

    @pytest.mark.parametrize("case", ["shifted_base", "width_36",
                                      "width_264", "column_slice",
                                      "transposed"])
    def test_other_layouts_are_refused(self, case):
        t = {"shifted_base": lambda: torch.zeros(
                 77 * 64 + 1, dtype=torch.bfloat16)[1:].view(77, 64),
             "width_36": lambda: self._bf16(77, 36),
             "width_264": lambda: self._bf16(77, 264),
             "column_slice": lambda: self._bf16(77, 72)[:, :64],
             "transposed": lambda: self._bf16(64, 77).T}[case]()
        with pytest.raises(ValueError, match="16-byte"):
            fml.check_copy_alignment(t, "hidden")

    def _operands(self, hidden, table):
        rows, v = hidden.shape[0], table.shape[0]
        return (hidden, table, torch.zeros(v), torch.ones(rows, dtype=torch.int32),
                torch.zeros(rows), torch.ones(()), torch.ones(1))

    def test_a_refused_layout_raises_before_the_kernel_library(self):
        """A misaligned bf16 hidden or table raises ValueError without the
        library being loaded; an aligned one goes on to it, and fp32
        operands have no such rule."""
        table = self._bf16(200, 64)
        shifted = torch.zeros(130 * 64 + 1, dtype=torch.bfloat16)[1:] \
            .view(130, 64)
        reached = AssertionError("the kernel library was reached")
        with mock.patch.object(fml, "_kernel_lib", side_effect=reached):
            for merged in (True, False):
                with pytest.raises(ValueError, match="16-byte"):
                    fml._launch_backward_tiled(
                        *self._operands(shifted, table), merged)
                with pytest.raises(ValueError, match="16-byte"):
                    fml._launch_backward_tiled(
                        *self._operands(self._bf16(130, 64),
                                        self._bf16(200, 72)[:, :64]), merged)
                with pytest.raises(AssertionError, match="reached"):
                    fml._launch_backward_tiled(
                        *self._operands(self._bf16(130, 64), table), merged)
                with pytest.raises(AssertionError, match="reached"):
                    fml._launch_backward_tiled(
                        *self._operands(shifted.float(), table.float()),
                        merged)

    @pytest.mark.parametrize("entry", ["K3", "K4", "K5", "K5_stats"])
    def test_k4_and_k5_refuse_a_layout_before_the_kernel_library(self,
                                                                 entry):
        """bf16 K3 (K5's sweep over the whole table), K4 (from K3's lse)
        and K5 (both entries) run the same copies: a misaligned base, a
        column slice or a width off the rule raises ValueError without the
        library being loaded; an aligned bf16 layout and fp32 operands go
        on to it."""
        table = self._bf16(200, 64)
        shifted = torch.zeros(130 * 64 + 1, dtype=torch.bfloat16)[1:] \
            .view(130, 64)

        def launch(hidden, tbl):
            ops = self._operands(hidden, tbl)
            if entry == "K4":
                return fml._launch_backward(*ops)
            fn = {"K3": fml._launch_forward,
                  "K5": fml._launch_forward_tiled,
                  "K5_stats": fml._launch_forward_tiled_stats}[entry]
            return fn(*ops[:4])

        reached = AssertionError("the kernel library was reached")
        with mock.patch.object(fml, "_kernel_lib", side_effect=reached):
            for hidden, tbl in ((shifted, table),
                                (self._bf16(130, 64), self._bf16(200, 72)[:, :64]),
                                (self._bf16(130, 36), self._bf16(200, 36)),
                                (self._bf16(130, 264), self._bf16(200, 264))):
                with pytest.raises(ValueError, match="16-byte"):
                    launch(hidden, tbl)
            for hidden, tbl in ((self._bf16(130, 64), table),
                                (shifted.float(), table.float())):
                with pytest.raises(AssertionError, match="reached"):
                    launch(hidden, tbl)

    @pytest.mark.parametrize("w", [8, 40, 72, 200])
    def test_zero_filled_width_is_exact(self, w):
        """W zero-filled to the kernels' width (64, 128 or 256) gives the
        same dh, dtable and dbias on the first W columns and zeros past
        them."""
        wp = next(p for p in (64, 128, 256) if p >= w)
        rows, v, vp = 70, 97, 104
        h, t, b, lab = inputs(rows, v, vp, w, w)
        ht, tt, bt, labt = _plain_operands(h, t, b, lab, v, torch.float32)
        lse, sums = fml.fused_mlm_loss_plain_forward(ht, tt, bt, labt)
        g = torch.tensor(0.75)
        pad = lambda x: torch.nn.functional.pad(x, (0, wp - w))  # noqa: E731
        ref = fml.fused_mlm_loss_plain_backward(ht, tt, bt, labt, lse, g,
                                                sums[3])
        got = fml.fused_mlm_loss_plain_backward(pad(ht), pad(tt), bt, labt,
                                                lse, g, sums[3])
        for a, r in zip(got[:2], ref[:2]):
            assert a.shape[1] == wp
            assert not a[:, w:].any()
            torch.testing.assert_close(a[:, :w], r, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=1e-7)
