"""The port's fused tied-softmax loss (bert4rec_tpu_torch/ops/fused_mlm_loss.py)
held against the JAX package's whole-table Pallas kernels K3/K4, run in
interpret mode on the CPU: the forward scalars and all three gradients,
on rows that are no multiple of the TPU's 256-row tile, with vocabulary
padding and label-0 rows; the routing law; and the model's
``loss_and_metrics`` on both of its paths. The CUDA kernels themselves are
held against the plain versions on a card in
tests/test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.ops import fused_mlm_loss as jax_fml
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
from bert4rec_tpu_torch.ops import tf32
from bert4rec_tpu_torch.utils.checkpoint import (
    flatten, params_from_numpy, unflatten,
)


def inputs(rows, v, vp, w, seed):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(rows, w)).astype(np.float32)
    table = (rng.normal(size=(vp, w)) * 0.5).astype(np.float32)
    bias = rng.normal(size=vp).astype(np.float32)
    labels = rng.integers(1, v, size=rows).astype(np.int32)
    labels[::5] = 0          # padding rows: no loss, still in `accuracy`
    return hidden, table, bias, labels


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


class TestPlainVersusJaxKernel:

    # (rows, vocab, padded vocab, width): 300 rows pad to two 256-row
    # tiles in JAX; 104 > 97 columns carry the -1e9 bias
    @pytest.mark.parametrize("shape", [(300, 97, 104, 32), (256, 61, 61, 16)],
                             ids=["ragged_padded", "aligned"])
    # fp32: the same math in another order; bf16: the hidden and table are
    # bf16 in both and dlog is rounded to bf16 in both, so only sum-order
    # flips of that rounding differ
    @pytest.mark.parametrize("dtype,tol", [
        (torch.float32, 1e-5), (torch.bfloat16, 5e-3)], ids=["fp32", "bf16"])
    def test_forward_and_grads_match_interpret_kernel(self, shape, dtype,
                                                      tol):
        rows, v, vp, w = shape
        h, t, b, lab = inputs(rows, v, vp, w, rows + w)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

        def f(h_, t_, b_):
            loss, cv, ca, nv = jax_fml.fused_mlm_loss(
                h_, t_, b_, jnp.asarray(lab), v, True)
            return loss, (cv, ca, nv)

        (jloss, jcounts), jg = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h).astype(jdt), jnp.asarray(t), jnp.asarray(b))
        ht = torch.from_numpy(h).to(dtype).requires_grad_(True)
        tt = torch.from_numpy(t).requires_grad_(True)
        bt = torch.from_numpy(b).requires_grad_(True)
        loss, cv, ca, nv = fml.fused_mlm_loss(ht, tt, bt,
                                              torch.from_numpy(lab), v)
        loss.backward()
        # the loss: fp32 sums of up to 300 terms in another order
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        # the counts are exact (random logits: no tie within rounding)
        assert [float(cv), float(ca), float(nv)] == \
            [float(c) for c in jcounts]
        for got, ref in ((ht.grad, jg[0]), (tt.grad, jg[1]),
                         (bt.grad, jg[2])):
            assert got.dtype == (dtype if got is ht.grad else torch.float32)
            assert _rel_err(got.float().numpy(),
                            np.asarray(ref, np.float32)) <= tol
        # the padding columns' bias gets no gradient
        assert not bt.grad[v:].any()

    def test_mlm_loss_and_metrics_matches_jax(self):
        h, t, b, lab = inputs(4 * 6, 50, 56, 16, 3)
        jl, jlogs = jax_fml.mlm_loss_and_metrics(
            jnp.asarray(h).reshape(4, 6, 16), jnp.asarray(t),
            jnp.asarray(b), jnp.asarray(lab).reshape(4, 6), 50,
            interpret=True)
        tl, tlogs = fml.mlm_loss_and_metrics(
            torch.from_numpy(h).reshape(4, 6, 16), torch.from_numpy(t),
            torch.from_numpy(b), torch.from_numpy(lab).reshape(4, 6), 50)
        assert abs(float(tl) - float(jl)) <= 1e-5 * float(jl)
        for k in ("masked_accuracy", "accuracy"):
            assert float(tlogs[k]) == pytest.approx(float(jlogs[k]),
                                                    abs=1e-7)

    def test_ties_count_as_correct(self):
        """`correct` is label_logit >= row max: a label tied with the max
        counts, as in the TPU kernel."""
        hidden = torch.zeros((2, 4))
        table = torch.zeros((5, 4))
        bias = torch.tensor([0.0, 1.0, 1.0, 0.0, 0.0])
        labels = torch.tensor([2, 3], dtype=torch.int32)
        _, cv, ca, nv = fml.fused_mlm_loss(hidden, table, bias, labels, 5)
        assert (float(cv), float(ca), float(nv)) == (1.0, 1.0, 2.0)

    def test_cpu_wrapper_counts_no_launch_and_checks_operands(self):
        h, t, b, lab = inputs(10, 20, 20, 8, 0)
        before = fml.fused_mlm_loss.launches
        fml.fused_mlm_loss(torch.from_numpy(h), torch.from_numpy(t),
                           torch.from_numpy(b), torch.from_numpy(lab), 20)
        assert fml.fused_mlm_loss.launches == before
        with pytest.raises(TypeError):
            fml.fused_mlm_loss(torch.from_numpy(h), torch.from_numpy(t),
                               torch.from_numpy(b),
                               torch.from_numpy(lab).long(), 20)
        with pytest.raises(ValueError):
            fml.fused_mlm_loss(torch.from_numpy(h), torch.from_numpy(t)[:, :4],
                               torch.from_numpy(b), torch.from_numpy(lab), 20)


class TestRoutingLawParity:

    @pytest.mark.parametrize("vp", [61, 3709, 3712, 7000, 26744, 26752,
                                    100000, 335000, 2 ** 21])
    @pytest.mark.parametrize("w", [16, 64, 128, 256])
    def test_routing_functions_match_jax(self, vp, w):
        assert fml.estimate_vmem_bytes(vp, w) == \
            jax_fml.estimate_vmem_bytes(vp, w)
        assert fml.fused_loss_supported(vp, w) == \
            jax_fml.fused_loss_supported(vp, w)
        assert fml.fused_loss_available(vp, w) == \
            jax_fml.fused_loss_available(vp, w)

    def test_mask_bias_matches_jax(self):
        b = np.random.default_rng(0).normal(size=16).astype(np.float32)
        for v in (10, 16):
            np.testing.assert_array_equal(
                fml._mask_bias(torch.from_numpy(b), v).numpy(),
                np.asarray(jax_fml._mask_bias(jnp.asarray(b), v)))

    def test_ml1m_takes_the_whole_table_kernels(self):
        assert fml.fused_loss_supported(3709, 128)
        assert not fml.fused_loss_supported(26744, 128)   # ml-20m: K5-K7


class TestWholeTableSplitLaw:
    """bf16 K3 runs K5's sweep over the whole table, fp32 K3 its own 3xTF32
    sweep: their vocabulary splits and their workspace, decided in Python
    before any launch (the card tests hold the library's workspace to
    these)."""

    @pytest.mark.parametrize("rows, v, w, splits", [
        (10240, 3709, 128, 13),    # ml-1m's batch: 80 row blocks x 13
        (10240, 3709, 64, 13),
        (10240, 3709, 256, 13),    # 128-entry tiles at W > 128: 29 tiles
        (300, 104, 32, 2),         # two 64-entry tiles, 3 row blocks
        (1, 61, 128, 1),
        (2048, 26732, 128, 64),
        (10240, 26732, 128, 13),   # K5 at ML-20M's batch: 80 x 13
        (10240, 26732, 256, 13),   # 209 tiles of 128 entries
        (2048, 335424, 128, 64),   # Reddit's V, R cut to 2,048: 16 x 64
    ], ids=lambda v: str(v))
    def test_bf16_splits_by_the_tiled_forward_law(self, rows, v, w, splits):
        assert fml.whole_table_splits(rows, v, w) == splits
        assert fml.tiled_forward_splits(rows, v, w) == splits

    @pytest.mark.parametrize("rows, v, w, splits", [
        (10240, 3709, 128, 13),    # ml-1m's batch: 80 row blocks x 13
        (10240, 3709, 64, 13),
        (10240, 3709, 256, 4),     # 64-row tiles, 32-entry tiles: 160 x 4
        (6144, 3709, 64, 22),      # 48 row blocks
        (300, 104, 32, 2),         # two 64-entry tiles, 3 row blocks
        (77, 61, 256, 2),          # two 32-entry tiles
        (1, 61, 128, 1),
        (2048, 26732, 128, 64),
    ], ids=lambda v: str(v))
    def test_fp32_splits_by_its_own_law(self, rows, v, w, splits):
        """fp32 K3 (fp32 K5's sweep over the whole table): the fewest
        splits that bring (row blocks x splits) to the target, one block an
        SM, at most one per vocabulary tile: 128-row blocks, 64-entry tiles
        and 1,024 blocks (bf16's law) at W <= 128; 64-row tiles, 32-entry
        tiles and 512 blocks at W > 128."""
        assert fml.whole_table_splits(rows, v, w, torch.float32) == splits

    @pytest.mark.parametrize("rows, v, w", [(10240, 3709, 128),
                                            (300, 104, 32), (77, 61, 256)],
                             ids=lambda v: str(v))
    def test_workspace_bytes(self, rows, v, w):
        """Both dtypes: the splits' (max, sum, label logit) rows and the
        256-row block sums, each carved to 256 bytes, with no V x W term
        (K4 needs none), each dtype by its own split law."""
        up = lambda n: -(-n // 256) * 256  # noqa: E731
        for dtype in (torch.bfloat16, torch.float32):
            n = fml.whole_table_splits(rows, v, w, dtype) * rows
            assert fml.whole_table_workspace_bytes(rows, v, w, dtype) == \
                3 * up(4 * n) + up(16 * -(-rows // 256))

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                             ids=["bf16", "fp32"])
    def test_workspace_does_not_grow_with_the_vocabulary(self, dtype):
        r, w = 10240, 128
        assert fml.whole_table_workspace_bytes(r, 3709, w, dtype) == \
            fml.whole_table_workspace_bytes(r, 335424, w, dtype)

    def test_bf16_workspace_does_not_grow_with_the_vocabulary(self):
        r, w = 10240, 128
        assert fml.whole_table_workspace_bytes(r, 3709, w) == \
            fml.whole_table_workspace_bytes(r, 335424, w)


class TestThreeTf32:
    """The rounding law of fp32 K3 / K4 (csrc/loss_tf32.cuh), emulated on
    the CPU with ``ops/tf32.py``: K3's logits a 3xTF32 product (hi / lo
    split by cvt.rna, three products summed in fp32), its max, sum of
    exponentials, label logit and counts from them in fp32; K4 from that
    lse, dh and dtable each a 3xTF32 product, dbias summing the unsplit
    dlog. Against JAX's interpret-mode ``_run_forward`` / ``_run_backward``
    and the plain fp32 versions: the forward's lse and loss sum within 1e-5
    relative of the plain forward and the loss sum within 1e-4 of JAX's,
    the counts equal on tie-free logits; the backward within 3e-4 of JAX's
    and 1e-5 of the plain backward. One TF32 pass lands at least 10x
    further from the plain versions."""

    # (rows, vocab, padded vocab, width): ml-1m's shape cut to size (W =
    # 128, V off every tile, rows off JAX's 256-row tile), and the
    # temporal gate's width with config-padding columns
    SHAPES = [(600, 371, 371, 128), (300, 97, 104, 64)]
    IDS = ["ml1m_like", "w64_padded"]

    @staticmethod
    def _forward(mm, h, t, b, lab):
        logits = mm(h, t.T) + b
        m = logits.amax(dim=-1)
        lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
        ll = fml._label_logit(logits, lab)
        w = (lab > 0).float()
        correct = ((ll >= m) & (lab >= 0)).float()
        return lse, torch.stack([((lse - ll) * w).sum(), (correct * w).sum(),
                                 correct.sum(), w.sum()])

    @staticmethod
    def _backward(mm, h, t, b, lab, lse, g, n_valid):
        logits = mm(h, t.T) + b
        col = torch.arange(logits.shape[1])
        onehot = (col[None, :] == lab.long()[:, None]).float()
        w = (lab > 0).float() * (g / max(n_valid, 1.0))
        dlog = (torch.exp(logits - lse[:, None]) - onehot) * w[:, None]
        return mm(dlog, t), mm(dlog.T, h), dlog.sum(dim=0)

    @staticmethod
    def _operands(shape, labels):
        rows, v, vp, w = shape
        h, t, b, lab = inputs(rows, v, vp, w, rows + w)
        if labels == "padding":
            lab[:] = 0
        ops = (torch.from_numpy(h), torch.from_numpy(t),
               fml._mask_bias(torch.from_numpy(b), v), torch.from_numpy(lab))
        return (h, t, b, lab), ops

    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    @pytest.mark.parametrize("labels", ["mixed", "padding"])
    def test_3xtf32_forward_matches_jax_and_plain(self, shape, labels):
        (h, t, b, lab), ops = self._operands(shape, labels)
        loss_sum, cv, ca, nv, n = jax_fml._run_forward(
            jnp.asarray(h), jnp.asarray(t), jnp.asarray(b), jnp.asarray(lab),
            shape[1], True)
        plse, psums = fml.fused_mlm_loss_plain_forward(*ops)
        lse3, sums3 = self._forward(tf32.mm_3xtf32, *ops)
        lse1, _ = self._forward(tf32.mm_tf32, *ops)
        assert n == shape[0]
        err3, err1 = _rel_err(lse3.numpy(), plse.numpy()), \
            _rel_err(lse1.numpy(), plse.numpy())
        assert err3 <= 1e-5, err3
        assert err1 >= 10 * err3, (err1, err3)
        ref = max(abs(float(psums[0])), 1e-6)
        assert abs(float(sums3[0]) - float(psums[0])) <= 1e-5 * ref
        assert abs(float(sums3[0]) - float(loss_sum)) <= \
            1e-4 * max(abs(float(loss_sum)), 1e-6)
        assert [float(x) for x in sums3[1:]] == \
            [float(cv), float(ca), float(nv)] == \
            [float(x) for x in psums[1:]]
        if labels == "padding":
            assert float(sums3[0]) == 0.0 and float(sums3[3]) == 0.0

    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    @pytest.mark.parametrize("labels", ["mixed", "padding"])
    def test_3xtf32_backward_matches_jax_and_plain(self, shape, labels):
        """K4 reads K3's lse: the emulated backward takes the emulated
        forward's, the plain backward the plain forward's, JAX's
        whole-table backward recomputes its own."""
        (h, t, b, lab), ops = self._operands(shape, labels)
        _, _, _, nv, _ = jax_fml._run_forward(
            jnp.asarray(h), jnp.asarray(t), jnp.asarray(b), jnp.asarray(lab),
            shape[1], True)
        jgrads = [np.asarray(x) for x in jax_fml._run_backward(
            jnp.asarray(h), jnp.asarray(t), jnp.asarray(b), jnp.asarray(lab),
            jnp.float32(0.75), nv, shape[1], True)]
        nv = float(nv)
        plse, _ = fml.fused_mlm_loss_plain_forward(*ops)
        plain = fml.fused_mlm_loss_plain_backward(
            *ops, plse, torch.tensor(0.75), torch.tensor(nv))
        lse3, _ = self._forward(tf32.mm_3xtf32, *ops)
        lse1, _ = self._forward(tf32.mm_tf32, *ops)
        got3 = self._backward(tf32.mm_3xtf32, *ops, lse3, 0.75, nv)
        got1 = self._backward(tf32.mm_tf32, *ops, lse1, 0.75, nv)
        for g3, g1, p, j in zip(got3, got1, plain, jgrads):
            assert g3.shape == p.shape == j.shape
            if not np.abs(j).any():     # all-padding rows: all zero
                assert not g3.numpy().any() and not p.numpy().any()
                continue
            assert _rel_err(g3.numpy(), j) <= 3e-4
            err3 = _rel_err(g3.numpy(), p.numpy())
            err1 = _rel_err(g1.numpy(), p.numpy())
            assert err3 <= 1e-5, err3
            assert err1 >= 10 * err3, (err1, err3)


class TestModelLossAndMetrics:

    @pytest.mark.parametrize("fused_loss", [True, False],
                             ids=["fused_loss", "logits_path"])
    def test_matches_jax_model(self, fused_loss):
        kw = dict(vocab_size=61, hidden_size=32, num_layers=2,
                  num_attention_heads=4, inner_dim=64, max_sequence_length=24,
                  max_predictions_per_seq=3, use_fused_layer=True,
                  use_fused_loss=fused_loss, vocab_pad_to=8)
        jm = JaxModel(config=JaxConfig(**kw))
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        rng = np.random.default_rng(4)
        flat = {k: (1.0 + 0.1 * rng.normal(size=v.shape)
                    if k.endswith("/scale")
                    else 0.5 * rng.normal(size=v.shape)).astype(np.float32)
                for k, v in flatten(jm.init(jax.random.key(0))).items()}
        ids = rng.integers(3, 61, size=(4, 24)).astype(np.int32)
        pos = np.stack([np.sort(rng.choice(24, 3, replace=False))
                        for _ in range(4)]).astype(np.int32)
        labels = np.take_along_axis(ids, pos, axis=1)
        labels[0, 2] = 0
        feats = {"input_word_ids": ids, "input_mask": np.ones_like(ids),
                 "masked_lm_positions": pos, "masked_lm_ids": labels}
        jl, jlogs = jm.loss_and_metrics(
            unflatten({k: jnp.asarray(v) for k, v in flat.items()}),
            {k: jnp.asarray(v) for k, v in feats.items()})
        tl, tlogs = model.loss_and_metrics(
            params_from_numpy(flat, "cpu"),
            {k: torch.from_numpy(v) for k, v in feats.items()})
        assert abs(float(tl) - float(jl)) <= 1e-5 * float(jl)
        for k in ("masked_accuracy", "accuracy"):
            assert float(tlogs[k]) == pytest.approx(float(jlogs[k]),
                                                    abs=1e-7)
