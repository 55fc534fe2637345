"""The port's temporal family held against the JAX package on the CPU: the
fused layer's plain version with a relative bias (K1'' rel_bias, K2 dRel)
against the Pallas kernel in interpret mode, forward, input gradients and
dRel, bidirectional and causal; the encoder with recency embeddings and the
relative-time attention bias, fused and unfused, outputs and the gradients
of both temporal tables; both bucket laws, exactly, at the edges of
float32's log2; the temporal preprocessor's batches; the routing of the
temporal configs; the two table-gradient candidates; and the quality
harness's temporal gate. The CUDA kernels are held against the plain
version on a card in tests/test_torch_cuda_kernels.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu import dataloaders as jax_dataloaders
from bert4rec_tpu import datasets as jax_datasets
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models.components.networks import (
    Bert4RecEncoder as JaxEncoder,
)
from bert4rec_tpu.models.components.networks import (
    bert4rec_encoder as jax_encoder_module,
)
from bert4rec_tpu.ops import fused_encoder_layer as jax_fel
from bert4rec_tpu_torch import dataloaders, datasets
from bert4rec_tpu_torch.config import load_train_config
from bert4rec_tpu_torch.dataloaders import preprocessors
from bert4rec_tpu_torch.datasets.synthetic import write_ml20m_corpus
from bert4rec_tpu_torch.evaluation import quality_harness
from bert4rec_tpu_torch.models import BERT4RecConfig, Bert4RecEncoder
from bert4rec_tpu_torch.models import BERT4RecModel
from bert4rec_tpu_torch.models.components.networks import (
    bert4rec_encoder as encoder_module,
)
from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
from bert4rec_tpu_torch.utils.checkpoint import (
    flatten, params_from_numpy, unflatten,
)
from tests.test_torch_cuda_kernels import inputs_np, layer_params_np
from tests.test_torch_fused_layer import (
    _JAX_PATHS, _rel_err, backward_3xtf32_errs, dropout_3xtf32_err,
)

B, S, H, N, F, V = 4, 24, 32, 4, 64, 61
ALL_PAD = 2   # the row of `layer_inputs` whose mask is all padding
TOL = 1e-4


def layer_inputs(seed):
    """The same random layer for both packages, inputs with right-padded
    rows and one all-pad row, a relative bias ~ N(0, 1) and dy."""
    rng = np.random.default_rng(seed)
    flat = flatten(layer_params_np(rng, H, N, F))
    x, mask = inputs_np(rng, B, S, H)
    mask[ALL_PAD] = 0
    rel = rng.normal(size=(B, N, S, S)).astype(np.float32)
    dy = rng.normal(size=(B, S, H)).astype(np.float32)
    jax_p = unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    return jax_p, params_from_numpy(flat, "cpu"), x, mask, rel, dy


def stamps(rng, b=B, s=S):
    """Increasing epoch seconds with gaps from a minute to a day."""
    return (1_600_000_000 + np.cumsum(rng.integers(60, 90_000, size=(b, s)),
                                      axis=1)).astype(np.int64)


class TestRelLayerVersusJaxKernel:

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal_rel"])
    def test_forward_matches_interpret_kernel(self, causal):
        jax_p, torch_p, x, mask, rel, _ = layer_inputs(0)
        ref = jax_fel.fused_encoder_layer(
            jax_p, jnp.asarray(x), jnp.asarray(mask), num_heads=N,
            interpret=True, causal=causal, rel_bias=jnp.asarray(rel))
        out = fel.fused_encoder_layer(torch_p, torch.from_numpy(x),
                                      torch.from_numpy(mask), num_heads=N,
                                      causal=causal,
                                      rel_bias=torch.from_numpy(rel))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
        without = fel.fused_encoder_layer(torch_p, torch.from_numpy(x),
                                          torch.from_numpy(mask),
                                          num_heads=N, causal=causal)
        assert float((out - without).abs().max()) > 1e-2   # the bias bites

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal_rel"])
    def test_dx_weight_grads_and_drel_match_interpret_kernel(self, causal):
        """The plain backward against ``jax.grad`` through the interpret
        kernel (K2 with ``rel``): dx, the 12 weight gradients and dRel
        within 1e-4 of their scale, with an all-pad row; dRel is exactly 0
        after the diagonal when causal."""
        jax_p, torch_p, x, mask, rel, dy = layer_inputs(1)

        def loss(p, xx, rr):
            y = jax_fel.fused_encoder_layer(
                p, xx, jnp.asarray(mask), num_heads=N, interpret=True,
                causal=causal, rel_bias=rr)
            return jnp.sum(y * dy)

        gp, gx, grel = jax.grad(loss, argnums=(0, 1, 2))(
            jax_p, jnp.asarray(x), jnp.asarray(rel))
        for leaf in flatten(torch_p).values():
            leaf.requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        rt = torch.from_numpy(rel).requires_grad_(True)
        y = fel.fused_encoder_layer(torch_p, xt, torch.from_numpy(mask),
                                    num_heads=N, causal=causal, rel_bias=rt)
        (y * torch.from_numpy(dy)).sum().backward()
        assert _rel_err(xt.grad.numpy(), np.asarray(gx)) <= TOL
        assert _rel_err(rt.grad.numpy(), np.asarray(grel)) <= TOL
        gflat, ours = flatten(gp), flatten(torch_p)
        for path in _JAX_PATHS.values():
            assert _rel_err(ours[path].grad.numpy(),
                            np.asarray(gflat[path])) <= TOL, path
        if causal:
            upper = np.triu(np.ones((S, S), bool), 1)
            assert (rt.grad.numpy()[..., upper] == 0).all()

    def test_plain_backward_returns_ds_before_rounding(self):
        """In bf16, ``grads["rel"]`` is the fp32 ds (JAX's ``ds32``), not
        its bf16 rounding: it holds values no bf16 number has."""
        _, torch_p, x, mask, rel, dy = layer_inputs(2)
        flat = fel.flat_weights(torch_p)
        _, grads = fel.fused_encoder_layer_plain_backward(
            flat, torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(mask), torch.from_numpy(dy).to(torch.bfloat16),
            num_heads=N, rel_bias=torch.from_numpy(rel))
        drel = grads["rel"]
        assert drel.dtype == torch.float32 and drel.shape == (B, N, S, S)
        assert not torch.equal(drel, drel.to(torch.bfloat16).float())

    def test_gradcheck_float64(self):
        """Analytic gradients of the autograd Function with a relative
        bias (plain forward and backward, dropout on, causal) against
        finite differences, the bias's included."""
        rng = np.random.default_rng(31)
        b, s, h, n, f = 2, 5, 8, 2, 12
        flat = {k: torch.from_numpy(v.astype(np.float64))
                for k, v in fel.flat_weights(
                    unflatten(flatten(layer_params_np(rng, h, n, f)))).items()}
        x, mask = inputs_np(rng, b, s, h)
        xt = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
        rt = torch.from_numpy(rng.normal(size=(b, n, s, s))) \
            .requires_grad_(True)
        mt = torch.from_numpy(mask)
        ops = [flat[k].clone().requires_grad_(True) for k in fel._W_ORDER]

        def fn(xx, rr, *w):
            return fel._FusedLayer.apply(xx, mt, 5, n, 0.2, 0.5, True, *w,
                                         rr)

        assert torch.autograd.gradcheck(fn, (xt, rt, *ops), eps=1e-6,
                                        atol=1e-5, rtol=1e-4)

    def test_rejects_a_malformed_bias(self):
        _, torch_p, x, mask, rel, _ = layer_inputs(3)
        with pytest.raises(ValueError, match="rel_bias"):
            fel.fused_encoder_layer(torch_p, torch.from_numpy(x),
                                    torch.from_numpy(mask), num_heads=N,
                                    rel_bias=torch.from_numpy(rel[:, :2]))


def _edge_deltas():
    """2^k - 2, 2^k - 1, 2^k for k = 1..30, both signs, and 0."""
    base = [2 ** k + o for k in range(1, 31) for o in (-2, -1, 0)]
    return sorted(set([0] + base + [-d for d in base]))


class TestBucketLaws:

    @pytest.mark.parametrize("n_buckets", [64, 8, 2])
    def test_time_bucket_matrix_equals_jax_at_the_edges(self, n_buckets):
        """Query-key deltas at float32's log2 edges, both signs: the
        port's law equals JAX's static method bit for bit."""
        deltas = np.asarray(_edge_deltas(), np.int64)
        ts = np.stack([np.zeros_like(deltas), deltas], axis=1)  # [D, 2]
        mask = np.ones(ts.shape, np.int32)
        want = np.asarray(JaxEncoder._time_bucket_matrix(
            jnp.asarray(ts.astype(np.int32)), jnp.asarray(mask), n_buckets))
        got = Bert4RecEncoder._time_bucket_matrix(
            torch.from_numpy(ts), torch.from_numpy(mask), n_buckets)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_jax_log2_is_xlas_not_a_correctly_rounded_one(self):
        """Why the port does not take a libm log2: JAX's float32 log2 is
        XLA's log(y) * float32(1 / ln 2), one bucket below a correctly
        rounded log2 where float32(|delta|) + 1 is 2^13, 2^15, 2^26, 2^27
        or 2^30; the port's law follows JAX's there too."""
        deltas = np.asarray([d for d in _edge_deltas() if d >= 0], np.int64)
        ts = np.stack([deltas, np.zeros_like(deltas)], axis=1)
        mask = np.ones(ts.shape, np.int32)
        jax_b = np.asarray(JaxEncoder._time_bucket_matrix(
            jnp.asarray(ts.astype(np.int32)), jnp.asarray(mask), 64))[:, 0, 1]
        ours = Bert4RecEncoder._time_bucket_matrix(
            torch.from_numpy(ts), torch.from_numpy(mask), 64).numpy()[:, 0, 1]
        y = deltas.astype(np.float32) + np.float32(1)
        rounded = np.log2(y.astype(np.float64)).astype(np.float32)
        correct = np.minimum(np.floor(rounded), 31)
        low = sorted(set(int(v) for v in y[jax_b != correct]))
        assert low == [2 ** 13, 2 ** 15, 2 ** 26, 2 ** 27, 2 ** 30]
        assert (jax_b <= correct).all()
        np.testing.assert_array_equal(ours, jax_b)

    def test_int32_wraparound_near_2_31(self):
        """Stamps straddling 2^31 (int64 in the batch, int32 in both
        laws) and the int32 minimum: differences wrap as JAX's do."""
        ts = np.array([[2 ** 31 - 10, 2 ** 31 + 5, 2 ** 31 - 1, 2 ** 31,
                        0, 2 ** 32 - 1],
                       [-2 ** 31, 0, 2 ** 31 - 1, 5, -5, 1]], np.int64)
        wrapped = ts.astype(np.int32)   # numpy wraps as torch's cast does
        mask = np.ones(ts.shape, np.int32)
        mask[1, 5] = 0
        for n in (64, 32):
            np.testing.assert_array_equal(
                Bert4RecEncoder._time_bucket_matrix(
                    torch.from_numpy(ts), torch.from_numpy(mask), n).numpy(),
                np.asarray(JaxEncoder._time_bucket_matrix(
                    jnp.asarray(wrapped), jnp.asarray(mask), n)))
            np.testing.assert_array_equal(
                Bert4RecEncoder._recency_buckets(
                    torch.from_numpy(ts), torch.from_numpy(mask), n).numpy(),
                np.asarray(JaxEncoder._recency_buckets(
                    jnp.asarray(wrapped), jnp.asarray(mask), n)))

    @pytest.mark.parametrize("n_buckets", [32, 4])
    def test_recency_buckets_equal_jax_at_the_edges(self, n_buckets):
        """Events 2^k - 2, 2^k - 1 and 2^k seconds before the newest one,
        padding and an all-pad row."""
        deltas = np.asarray([d for d in _edge_deltas() if d >= 0], np.int64)
        newest = 1_700_000_000
        ts = np.stack([newest - deltas[::-1], newest - deltas[::-1]])
        mask = np.ones(ts.shape, np.int32)
        mask[1] = 0
        want = np.asarray(JaxEncoder._recency_buckets(
            jnp.asarray(ts.astype(np.int32)), jnp.asarray(mask), n_buckets))
        got = Bert4RecEncoder._recency_buckets(
            torch.from_numpy(ts), torch.from_numpy(mask), n_buckets)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got[0].max()) > 0 and int(got[1].max()) == 0

    def test_no_timestamps_is_bucket_zero(self):
        mask = torch.ones((2, 5), dtype=torch.int32)
        assert int(Bert4RecEncoder._time_bucket_matrix(None, mask, 64)
                   .abs().sum()) == 0
        assert int(Bert4RecEncoder._recency_buckets(None, mask, 32)
                   .abs().sum()) == 0

    def test_relative_bias_and_table_grad_match_jax(self):
        """``_relative_time_bias`` and the table gradient through it (JAX's
        one-hot custom VJP) on random stamps."""
        rng = np.random.default_rng(4)
        ts = stamps(rng)
        mask = np.ones((B, S), np.int32)
        table = rng.normal(size=(64, N)).astype(np.float32)
        g = rng.normal(size=(B, N, S, S)).astype(np.float32)

        def jax_loss(t):
            r = JaxEncoder._relative_time_bias(
                t, jnp.asarray(ts.astype(np.int32)), jnp.asarray(mask))
            return jnp.sum(r * g), r

        (_, jrel), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(
            jnp.asarray(table))
        tt = torch.from_numpy(table).requires_grad_(True)
        rel = Bert4RecEncoder._relative_time_bias(
            tt, torch.from_numpy(ts), torch.from_numpy(mask))
        (rel * torch.from_numpy(g)).sum().backward()
        assert rel.shape == (B, N, S, S) and rel.is_contiguous()
        np.testing.assert_array_equal(rel.detach().numpy(), np.asarray(jrel))
        assert _rel_err(tt.grad.numpy(), np.asarray(jgrad)) <= 1e-5

    @pytest.mark.parametrize("n_buckets", [16, 300])
    def test_table_grad_repeats_its_bits(self, n_buckets, monkeypatch):
        """The sorted table gradient sums in a fixed order: several chunks
        per bucket here; one-byte sort keys at 16 buckets, 64-bit ones
        past 256."""
        monkeypatch.setattr(encoder_module, "TABLE_GRAD_CHUNK", 8)
        rng = np.random.default_rng(5)
        bucket = torch.from_numpy(
            rng.integers(0, n_buckets, size=(3, 20, 20)).astype(np.int32))
        g = torch.from_numpy(rng.normal(size=(3, 2, 20, 20))
                             .astype(np.float32))
        fn = encoder_module.table_grad_sorted
        a, b = fn(bucket, g, n_buckets), fn(bucket, g, n_buckets)
        assert torch.equal(a, b) and a.shape == (n_buckets, 2)
        want = np.zeros((n_buckets, 2))
        np.add.at(want, bucket.numpy().reshape(-1),
                  g.permute(0, 2, 3, 1).reshape(-1, 2).double().numpy())
        np.testing.assert_allclose(a.numpy(), want, rtol=1e-5, atol=1e-5)


def encoder_kwargs(**over):
    kw = dict(vocab_size=V, hidden_size=H, num_layers=2,
              num_attention_heads=N, inner_dim=F, max_sequence_length=S,
              attention_dropout=0.0, output_dropout=0.0,
              use_temporal_embeddings=True, use_temporal_attention=True)
    kw.update(over)
    return kw


def temporal_case(seed, **over):
    """One random temporal encoder for both packages (every leaf drawn,
    the bias table non-zero) and a batch with timestamps."""
    kw = encoder_kwargs(**over)
    jenc = JaxEncoder(JaxConfig(**kw))
    shapes = flatten(jenc.init(jax.random.key(0)))
    rng = np.random.default_rng(seed)
    flat = {k: (1.0 + 0.1 * rng.normal(size=v.shape) if k.endswith("/scale")
                else 0.5 * rng.normal(size=v.shape)
                if k.startswith("temporal_attention_bias")
                else 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in shapes.items()}
    ids = rng.integers(3, V, size=(B, S)).astype(np.int32)
    _, mask = inputs_np(rng, B, S, H)
    ts = stamps(rng) * mask
    return kw, jenc, flat, ids * mask, mask, ts


def _grads(jenc, flat, ids, mask, ts, dy):
    """JAX's encoder output and the gradients of ``sum(y * dy)``."""
    def loss(p):
        y = jenc.apply(p, jnp.asarray(ids), jnp.asarray(mask),
                       input_timestamps=jnp.asarray(ts.astype(np.int32)))
        return jnp.sum(y["sequence_output"] * dy), y["sequence_output"]

    (_, y), g = jax.value_and_grad(loss, has_aux=True)(
        unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    return np.asarray(y), flatten(g)


def _torch_grads(enc, flat, ids, mask, ts, dy):
    params = params_from_numpy(flat, "cpu")
    leaves = flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    y = enc.apply(params, torch.from_numpy(ids), torch.from_numpy(mask),
                  input_timestamps=torch.from_numpy(ts))["sequence_output"]
    (y * torch.from_numpy(dy)).sum().backward()
    return y.detach().numpy(), {k: v.grad for k, v in leaves.items()}


class TestTemporalEncoderVersusJax:

    @pytest.mark.parametrize("fused", [True, False], ids=["fused",
                                                          "unfused"])
    def test_outputs_and_table_grads_match_jax(self, fused):
        """Both temporal flags on, a non-zero bias table: the port's
        encoder against JAX's on the same route (fused: the interpret
        kernel with ``rel_bias``; unfused: the dense bias), outputs and
        the gradients of both temporal tables within 1e-4."""
        kw, _, flat, ids, mask, ts = temporal_case(6)
        jenc = JaxEncoder(JaxConfig(**kw, use_fused_layer=fused))
        enc = Bert4RecEncoder(BERT4RecConfig(**kw, use_fused_layer=fused))
        assert enc.fused_layer_routed(B, S) == fused
        dy = np.random.default_rng(7).normal(size=(B, S, H)) \
            .astype(np.float32)
        jy, jg = _grads(jenc, flat, ids, mask, ts, dy)
        ty, tg = _torch_grads(enc, flat, ids, mask, ts, dy)
        np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
        for path in ("temporal_attention_bias/embedding",
                     "temporal_embeddings/embedding",
                     "layers/layer_0/attention/qkv/kernel"):
            assert float(tg[path].abs().max()) > 0, path
            assert _rel_err(tg[path].numpy(), np.asarray(jg[path])) <= TOL, \
                path

    def test_unfused_and_fused_differ_by_the_gelu_only(self):
        """JAX's own cross-check bound for the two gelus (erf unfused,
        tanh fused; tests/ops_tests/test_fused_layer.py:173-232), with the
        temporal bias and causal attention composed."""
        for causal in (False, True):
            kw, _, flat, ids, mask, ts = temporal_case(
                8, causal_attention=causal)
            outs = []
            for fused in (False, True):
                enc = Bert4RecEncoder(BERT4RecConfig(
                    **kw, use_fused_layer=fused))
                outs.append(enc.apply(
                    params_from_numpy(flat, "cpu"), torch.from_numpy(ids),
                    torch.from_numpy(mask),
                    input_timestamps=torch.from_numpy(ts))[
                        "sequence_output"].numpy())
            np.testing.assert_allclose(outs[1], outs[0], rtol=2e-2,
                                       atol=2e-2)


class TestTemporalEvaluationVersusJax:

    def _world(self, seed):
        """A temporal model with a non-zero bias table, in both packages,
        and leave-one-out datasets whose rows carry timestamps."""
        from bert4rec_tpu.dataloaders.processed_dataset import (
            MaskingConfig as JaxMaskingConfig,
            ProcessedDataset as JaxProcessedDataset,
        )
        from bert4rec_tpu.models import BERT4RecModel as JaxModel
        from bert4rec_tpu_torch.dataloaders.processed_dataset import (
            MaskingConfig, ProcessedDataset,
        )
        from tests.test_torch_model import random_params, to_jax
        kw = dict(encoder_kwargs(max_sequence_length=16),
                  max_predictions_per_seq=4, use_fused_layer=True)
        jmodel = JaxModel(config=JaxConfig(**kw))
        flat = random_params(jmodel, seed)
        flat["encoder/temporal_attention_bias/embedding"] = 0.5 * \
            np.random.default_rng(seed).normal(
                size=flat["encoder/temporal_attention_bias/embedding"]
                .shape).astype(np.float32)
        rng = np.random.default_rng(seed + 1)
        seqs = [rng.integers(3, V, size=int(n)).astype(np.int32)
                for n in rng.integers(6, 20, size=29)]
        ts = [1_600_000_000 + np.cumsum(rng.integers(60, 90_000, size=len(q)))
              for q in seqs]
        mk = dict(max_seq_len=16, max_predictions_per_seq=4, mask_token_id=1,
                  pad_token_id=0, unk_token_id=2, masked_lm_rate=0.3)
        ft = np.ones(len(seqs), bool)
        ours = ProcessedDataset(seqs, MaskingConfig(**mk), lambda: V,
                                finetuning=ft, timestamps=ts)
        theirs = JaxProcessedDataset(seqs, JaxMaskingConfig(**mk), lambda: V,
                                     finetuning=ft, timestamps=ts)
        return (jmodel, to_jax(flat), BERT4RecModel(config=BERT4RecConfig(
            **kw)), params_from_numpy(flat, "cpu"), ours, theirs)

    @pytest.mark.parametrize("protocol", ["host_negatives", "full_ranking"])
    def test_evaluate_reads_the_timestamps_as_jax(self, protocol):
        """The evaluator hands ``input_timestamps`` to the temporal model:
        the same ranks and metrics as JAX's evaluator, by the host sampler
        (the same negatives) and over the whole catalog; without the
        timestamps the metrics move."""
        from bert4rec_tpu.dataloaders import samplers as jax_samplers
        from bert4rec_tpu.evaluation import BERT4RecEvaluator as JaxEvaluator
        from bert4rec_tpu_torch.dataloaders import samplers
        from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
        jmodel, jparams, model, params, ours, theirs = self._world(3)
        if protocol == "full_ranking":
            make = [lambda: BERT4RecEvaluator(full_ranking=True),
                    lambda: JaxEvaluator(full_ranking=True)]
        else:
            source = [int(t) for q in ours.sequences for t in q]
            skw = dict(source=source, vocab=list(dict.fromkeys(source)),
                       sample_size=12, seed=11)
            make = [lambda: BERT4RecEvaluator(
                        sampler=samplers.get("pop_random", **skw),
                        sample_size=12, device_negatives=False),
                    lambda: JaxEvaluator(
                        sampler=jax_samplers.get("pop_random", **skw),
                        sample_size=12, device_negatives=False)]
        got = make[0]().evaluate(model, params, ours, batch_size=8,
                                 progress_bar=False)
        want = make[1]().evaluate(jmodel, jparams, theirs, batch_size=8,
                                  progress_bar=False)
        assert got == want and got["Valid Ranks"] == len(ours)
        without = type(ours)(ours.sequences, ours.config, lambda: V,
                             finetuning=ours.finetuning)
        blind = make[0]().evaluate(model, params, without, batch_size=8,
                                   progress_bar=False)
        assert blind != got

    def test_output_range_cuts_the_dense_bias_rows_as_jax(self):
        """The unfused route with ``output_range``: the dense [B, N, S, S]
        bias (pad + rel) is cut to the last layer's query rows (JAX
        transformer.py:108-113); outputs match JAX's."""
        kw, jenc, flat, ids, mask, ts = temporal_case(15)
        enc = Bert4RecEncoder(BERT4RecConfig(**kw))
        jp = unflatten({k: jnp.asarray(v) for k, v in flat.items()})
        for rng_ in (5, S):
            want = jenc.apply(jp, jnp.asarray(ids), jnp.asarray(mask),
                              output_range=rng_,
                              input_timestamps=jnp.asarray(
                                  ts.astype(np.int32)))["sequence_output"]
            got = enc.apply(params_from_numpy(flat, "cpu"),
                            torch.from_numpy(ids), torch.from_numpy(mask),
                            output_range=rng_,
                            input_timestamps=torch.from_numpy(ts))[
                                "sequence_output"]
            assert got.shape == (B, rng_, H)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)


class TestTemporalLaws:

    def test_zero_bias_table_is_an_exact_no_op(self):
        """As JAX's zero-init law: the attention-bias flag with its zero
        table gives the non-temporal encoder's outputs bit for bit on the
        unfused route and within rounding on the fused one."""
        kw, _, flat, ids, mask, ts = temporal_case(
            9, use_temporal_embeddings=False)
        flat["temporal_attention_bias/embedding"][:] = 0.0
        base = {k: v for k, v in flat.items()
                if not k.startswith("temporal")}
        for fused in (False, True):
            tenc = Bert4RecEncoder(BERT4RecConfig(**kw,
                                                  use_fused_layer=fused))
            benc = Bert4RecEncoder(BERT4RecConfig(**dict(
                kw, use_temporal_attention=False), use_fused_layer=fused))
            a = tenc.apply(params_from_numpy(flat, "cpu"),
                           torch.from_numpy(ids), torch.from_numpy(mask),
                           input_timestamps=torch.from_numpy(ts))
            b = benc.apply(params_from_numpy(base, "cpu"),
                           torch.from_numpy(ids), torch.from_numpy(mask))
            np.testing.assert_allclose(a["sequence_output"].numpy(),
                                       b["sequence_output"].numpy(),
                                       rtol=0 if not fused else 1e-6,
                                       atol=0 if not fused else 1e-6)

    @pytest.mark.parametrize("flag", ["use_temporal_embeddings",
                                      "use_temporal_attention"])
    def test_timestamps_change_the_output(self, flag):
        other = ("use_temporal_attention" if flag == "use_temporal_embeddings"
                 else "use_temporal_embeddings")
        kw, _, flat, ids, mask, ts = temporal_case(10, **{other: False})
        flat = {k: v for k, v in flat.items()
                if k.split("/")[0] in flatten_roots(kw)}
        enc = Bert4RecEncoder(BERT4RecConfig(**kw))
        params = params_from_numpy(flat, "cpu")
        run = lambda t: enc.apply(  # noqa: E731
            params, torch.from_numpy(ids), torch.from_numpy(mask),
            input_timestamps=None if t is None else torch.from_numpy(t))[
                "sequence_output"]
        a, b = run(ts), run(ts * 3 - 1_000_000)
        assert float((a - b).abs().max()) > 1e-3
        assert torch.isfinite(run(None)).all()

    def test_wrapper_round_trips_a_temporal_model(self, tmp_path):
        """A temporal model saved by the port's wrapper loads back in both
        packages' layouts with the same outputs (JAX's wrapper law,
        tests/models_tests/test_bert4rec_encoder.py:229-410)."""
        from bert4rec_tpu.models import BERT4RecModelWrapper as JaxWrapper
        from bert4rec_tpu_torch.models import BERT4RecModelWrapper
        kw = dict(encoder_kwargs(), max_predictions_per_seq=3)
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        params["encoder"]["temporal_attention_bias"]["embedding"] += 0.3
        wrapper = BERT4RecModelWrapper(model, params)
        wrapper.save(tmp_path / "m")
        loaded, _ = BERT4RecModelWrapper.load(tmp_path / "m", device="cpu")
        assert loaded.model.config == model.config
        ours, back = flatten(params), flatten(loaded.params)
        assert ours.keys() == back.keys()
        for k in ours:
            assert torch.equal(ours[k], back[k]), k
        jw, _ = JaxWrapper.load(str(tmp_path / "m"))
        jflat = flatten(jw.params)
        assert set(jflat) == set(ours)
        rng = np.random.default_rng(11)
        ids = rng.integers(3, V, size=(B, S)).astype(np.int32)
        mask = np.ones((B, S), np.int32)
        ts = stamps(rng)
        pos = np.tile(np.arange(3, dtype=np.int32), (B, 1))
        feats = dict(input_word_ids=ids, input_mask=mask,
                     masked_lm_positions=pos, input_timestamps=ts)
        got = loaded.model.apply(loaded.params, {
            k: torch.from_numpy(v) for k, v in feats.items()})["mlm_logits"]
        want = jw.model.apply(jw.params, dict(
            {k: jnp.asarray(v) for k, v in feats.items()},
            input_timestamps=jnp.asarray(ts.astype(np.int32))))["mlm_logits"]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def flatten_roots(kw):
    """Top-level param names an encoder of ``kw`` holds."""
    roots = {"item_embeddings", "position_embeddings", "embedding_norm",
             "layers", "pooler"}
    if kw.get("use_temporal_embeddings"):
        roots.add("temporal_embeddings")
    if kw.get("use_temporal_attention"):
        roots.add("temporal_attention_bias")
    return roots


class TestRouting:

    @pytest.mark.parametrize("name,fused", [("ml-20m_128", True),
                                            ("ml-20m_256", False)])
    def test_temporal_configs_route_as_jax(self, name, fused):
        """JAX's VMEM law with the temporal term: ml-20m_128 temporal stays
        fused (rel_bias), ml-20m_256 temporal is refused and takes the
        dense bias, with flash attention off."""
        cfg = load_train_config(name, vocab_size=26_732, use_fused_layer=True,
                                use_fused_loss=True,
                                use_temporal_embeddings=True,
                                use_temporal_attention=True)
        kw = dict(batch=256, seq_len=200, hidden=cfg.hidden_size,
                  inner_dim=cfg.inner_dim, num_heads=cfg.num_attention_heads)
        assert fel.fused_layer_supported(**kw, temporal=True) == fused
        assert fel.fused_layer_supported(**kw, temporal=True) == \
            jax_fel.fused_layer_supported(**kw, temporal=True)
        assert fel.fused_layer_supported(**kw, temporal=False)
        enc = Bert4RecEncoder(cfg)
        assert enc.fused_layer_routed(256, 200, dropout_active=True,
                                      device="cuda") == fused
        assert enc.fused_layer_routed(256, 200, dropout_active=True,
                                      device="cuda", temporal=False)

    def test_flash_is_off_under_a_dense_bias(self, monkeypatch):
        """Unfused with the temporal bias: no flash-attention call, even
        with ``use_flash_attention``; without the bias, flash runs."""
        from bert4rec_tpu_torch.models.components import transformer
        calls = []
        real = transformer.flash_attention

        def spy(*a, **k):
            calls.append(1)
            return real(*a, **k)

        monkeypatch.setattr(transformer, "flash_attention", spy)
        for temporal in (True, False):
            kw, _, flat, ids, mask, ts = temporal_case(
                12, use_temporal_attention=temporal,
                use_temporal_embeddings=False)
            enc = Bert4RecEncoder(BERT4RecConfig(**kw,
                                                 use_flash_attention=True))
            calls.clear()
            flat = {k: v for k, v in flat.items()
                    if k.split("/")[0] in flatten_roots(kw)}
            enc.apply(params_from_numpy(flat, "cpu"), torch.from_numpy(ids),
                      torch.from_numpy(mask),
                      input_timestamps=torch.from_numpy(ts))
            assert (len(calls) == 0) == temporal


class TestTemporalPreprocessor:

    def test_factory(self):
        pre = preprocessors.get("bert4rec_temporal")
        assert isinstance(pre, preprocessors.BERT4RecTemporalPreprocessor)

    def test_ml20m_batches_byte_identical_to_jax(self, monkeypatch,
                                                 tmp_path):
        """``create_ml_20m_dataloader(preprocessor="bert4rec_temporal")
        .prepare_training(extract_data=["movie_name", "timestamp"])`` on the
        synthetic corpus: the same batches as JAX's for one seed,
        ``input_timestamps`` included and aligned with the items."""
        monkeypatch.setenv("BERT4REC_TPU_LOAD_N_RECORDS", "100000")
        write_ml20m_corpus(tmp_path, n_users=50, n_movies=300)
        dest = tmp_path / "data" / "ml-20m"
        out = []
        for factory, ds_mod in ((dataloaders.get_dataloader_factory(),
                                 datasets),
                                (jax_dataloaders.get_dataloader_factory(),
                                 jax_datasets)):
            monkeypatch.setattr(ds_mod.ML20M, "dest", dest)
            loader = factory.create_ml_20m_dataloader(
                preprocessor="bert4rec_temporal", max_seq_len=40,
                input_duplication_factor=2)
            out.append(loader.prepare_training(
                extract_data=["movie_name", "timestamp"],
                finetuning_split=0.1))
        for ds, jds in zip(*out):
            assert len(ds) == len(jds) > 0
            got = list(ds.batches(16, seed=3))
            want = list(jds.batches(16, seed=3))
            assert len(got) == len(want) > 0
            for x, y in zip(got, want):
                assert x.keys() == y.keys()
                assert "input_timestamps" in x
                for k in y:
                    assert x[k].dtype == y[k].dtype and \
                        x[k].tobytes() == y[k].tobytes(), k
        batch = got[0]
        real = batch["input_mask"] > 0
        assert (batch["input_timestamps"][~real] == 0).all()
        assert (batch["input_timestamps"][real] > 0).all()

    def test_inference_appends_now_and_serving_batches_carry_none(self):
        from bert4rec_tpu.dataloaders import preprocessors as jax_pre
        from bert4rec_tpu.tokenizers import get as jax_tok
        from bert4rec_tpu_torch.tokenizers import get as tok
        kw = dict(max_seq_len=6, max_predictions_per_seq=2,
                  mask_token_id=1, unk_token_id=2, pad_token_id=0,
                  masked_lm_rate=0.2, mask_token_rate=1.0,
                  random_token_rate=0.0)
        pres = []
        for get, mod in ((tok, preprocessors), (jax_tok, jax_pre)):
            t = get("simple")
            t.tokenize(["a", "b", "c"])
            pres.append(mod.BERT4RecTemporalPreprocessor(tokenizer=t, **kw))
        ours, theirs = (p.prepare_inference(["a", "b", "c"],
                                            timestamps=[5, 6, 7])
                        for p in pres)
        assert ours.keys() == theirs.keys()
        for k in ours:
            if k == "input_timestamps":
                np.testing.assert_array_equal(ours[k][0, :3], [5, 6, 7])
                assert ours[k][0, 3] > 1_600_000_000
            else:
                np.testing.assert_array_equal(ours[k], theirs[k])
        assert "input_timestamps" not in pres[0].prepare_inference_batch(
            [["a", "b"]])
        with pytest.raises(ValueError, match="timestamps"):
            pres[0].process_element(["a", "b"], True, True,
                                    timestamps=[1])


class TestTemporalTrainingAndHarness:

    def test_train_steps_carry_timestamps(self):
        """The trainer places ``input_timestamps`` with the batch, so the
        temporal tables train; a batch without it still steps."""
        from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
        model = BERT4RecModel(config=BERT4RecConfig(**dict(
            encoder_kwargs(), max_predictions_per_seq=3)))
        trainer = BERT4RecTrainer(model)
        trainer.initialize_model(
            optimizer=optimizers.create_adam_w_optimizer(
                init_lr=1e-2, num_warmup_steps=0), seed=0, device="cpu")
        rng = np.random.default_rng(13)
        ids = rng.integers(3, V, size=(B, S)).astype(np.int32)
        pos = np.tile(np.arange(0, 6, 2, dtype=np.int32), (B, 1))
        batch = dict(input_word_ids=ids, input_mask=np.ones((B, S), np.int32),
                     masked_lm_positions=pos,
                     masked_lm_ids=np.take_along_axis(ids, pos, 1),
                     masked_lm_weights=np.ones((B, 3), np.int32),
                     input_timestamps=stamps(rng))
        placed = trainer._put_batch(batch)
        assert "input_timestamps" in placed
        before = trainer.params["encoder"]["temporal_attention_bias"][
            "embedding"].detach().clone()
        trainer.train_step(placed)
        after = trainer.params["encoder"]["temporal_attention_bias"][
            "embedding"].detach()
        assert float((after - before).abs().max()) > 0
        no_ts = {k: v for k, v in batch.items() if k != "input_timestamps"}
        assert "input_timestamps" not in trainer._put_batch(no_ts)
        trainer.train_step(trainer._put_batch(no_ts))

    def test_generator_plants_the_copy_rule(self):
        seqs, tss = quality_harness.copy_by_time_delta(20, 0)
        assert len(seqs) == 20
        for items, ts in zip(seqs, tss):
            assert 40 <= len(items) <= quality_harness.SEQ
            assert set(np.diff(ts)) <= set(quality_harness.GAPS)
            for i in range(quality_harness.WARMUP, len(items)):
                j = int(np.argmin(np.abs((ts[i] - quality_harness.T0_DELTA)
                                         - ts[:i])))
                assert items[i] == items[j]

    def test_run_smoke_temporal_runs_and_emits(self, tmp_path, monkeypatch):
        """The gate's plumbing at a tiny budget on the CPU (one step per
        model): it emits JAX's payload; the gate itself runs on the card
        (chip_smoke phase 17)."""
        for name, value in (("EPOCHS", 1), ("TRAIN_ROWS", 128),
                            ("TEST_ROWS", 64)):
            monkeypatch.setattr(quality_harness, name, value)
        args = types.SimpleNamespace(seed=42, out=str(tmp_path))
        rc = quality_harness.run_smoke_temporal(args, device="cpu")
        import json
        payload = json.loads((tmp_path / "eval_results.json").read_text())
        assert rc in (0, 1)
        assert set(payload["checks"]) == {"temporal_learns_rule",
                                          "ablation_cannot", "hr1_separates"}
        for res in (payload["results"],
                    payload["results_time_blind_ablation"]):
            assert set(res) == {"HR@1", "HR@5", "HR@10"}
            assert 0.0 <= res["HR@1"] <= res["HR@5"] <= res["HR@10"] <= 1.0


def test_jax_lookup_module_is_the_reference():
    """The port's lookup mirrors JAX's ``_rel_lookup`` (the same function
    of the table and the bucket matrix)."""
    rng = np.random.default_rng(14)
    table = rng.normal(size=(8, N)).astype(np.float32)
    bucket = rng.integers(0, 8, size=(2, 5, 5)).astype(np.int32)
    want = np.asarray(jax_encoder_module._rel_lookup(
        8, jnp.asarray(table), jnp.asarray(bucket))).transpose(0, 3, 1, 2)
    got = encoder_module._RelLookup.apply(torch.from_numpy(table),
                                          torch.from_numpy(bucket))
    np.testing.assert_array_equal(got.numpy(), want)


class TestThreeTf32Rel:
    """K2 dRel's 3xTF32 law (csrc/layer_tf32.cu), emulated on the CPU,
    bidirectional and causal: dx, the 12 weight gradients and dRel within
    3e-4 of their scale of ``jax.grad`` through the interpret kernel at
    rate 0 (one TF32 pass at least 10x further off), and within 1e-5 of
    the plain fp32 backward with dropout."""

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal_rel"])
    def test_backward_in_3xtf32_matches_interpret_kernel(self, causal):
        err3, err1 = backward_3xtf32_errs(causal=causal, rel=True)
        assert err3 <= 3e-4, err3
        assert err1 >= 10 * err3, (err3, err1)

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal_rel"])
    def test_backward_in_3xtf32_with_dropout_matches_plain(self, causal):
        assert dropout_3xtf32_err(causal=causal, rel=True) <= 1e-5
