"""The port's evaluation held against the JAX package on the CPU: the rank
metrics on the same rank arrays, the numpy samplers drawing the same
negatives for one seed, ``BERT4RecEvaluator.evaluate`` giving JAX's
metrics exactly on the host-negatives and full-catalog paths (tie-free
logits, BERT4Rec and SASRec), candidate scoring within 1e-5 and full-
catalog ranks equal (dense and tiled); and the device-negatives path by
its laws (no excluded, zero-mass or repeated draw; the popularity law; the
host path's ranks for the same candidates)."""

import json

import jax
import numpy as np
import pytest
import torch

from bert4rec_tpu.dataloaders import samplers as jax_samplers
from bert4rec_tpu.dataloaders.processed_dataset import (
    MaskingConfig as JaxMaskingConfig,
    ProcessedDataset as JaxProcessedDataset,
)
from bert4rec_tpu.evaluation import BERT4RecEvaluator as JaxEvaluator
from bert4rec_tpu.evaluation import evaluation_metrics as jax_metrics
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.models import SASRecModel as JaxSASRec
from bert4rec_tpu.ops import candidate_scoring as jax_scoring
from bert4rec_tpu_torch.dataloaders import samplers
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    MaskingConfig, ProcessedDataset,
)
from bert4rec_tpu_torch.evaluation import (
    BERT4RecEvaluator, evaluation_metrics, get as get_evaluator,
)
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.models import SASRecModel
from bert4rec_tpu_torch.ops import candidate_scoring, negative_sampling as ns
from bert4rec_tpu_torch.ops.dropout_bits import fold_in
from bert4rec_tpu_torch.utils.checkpoint import params_from_numpy
from tests import test_utils
from tests.test_torch_model import random_params, to_jax

V, SEQ, PRED, SAMPLE = 61, 16, 4, 12


class TestMetrics:

    def test_equal_to_jax_on_the_same_ranks(self):
        rng = np.random.default_rng(0)
        batches = [rng.integers(1, 60, size=n) for n in (7, 1, 0, 33)]
        pairs = [(evaluation_metrics.Counter("Valid Ranks"),
                  jax_metrics.Counter("Valid Ranks")), (
                  evaluation_metrics.MAP(), jax_metrics.MAP())]
        for k in (1, 5, 10):
            pairs += [(evaluation_metrics.HR(k), jax_metrics.HR(k)),
                      (evaluation_metrics.NDCG(k), jax_metrics.NDCG(k))]
        for ours, theirs in pairs:
            assert ours.name == theirs.name
            for i, ranks in enumerate(batches):
                if i % 2:
                    ours.update_batch(ranks)
                    theirs.update_batch(ranks)
                else:
                    for r in ranks:
                        ours.update(int(r))
                        theirs.update(int(r))
            assert ours.result() == theirs.result(), ours.name
            ours.reset()
            assert ours.result() == 0


def int_source(seed=0, n=400):
    rng = np.random.default_rng(seed)
    # a skewed popularity: low ids far more frequent
    return [int(x) for x in 3 + rng.zipf(1.5, size=n) % (V - 3)]


class TestSamplers:

    @pytest.mark.parametrize("seed", [0, 5])
    def test_pop_random_draws_the_same_negatives(self, seed):
        source = int_source(seed)
        vocab = list(dict.fromkeys(source))
        kw = dict(source=source, vocab=vocab, sample_size=8, seed=seed)
        ours = samplers.get("pop_random", **kw)
        theirs = jax_samplers.get("pop_random", **kw)
        assert ours.probability_distribution == \
            theirs.probability_distribution
        rng = np.random.default_rng(seed + 1)
        without = [rng.choice(vocab, size=int(rng.integers(0, 6)))
                   for _ in range(20)]
        np.testing.assert_array_equal(ours.sample_batch(without),
                                      theirs.sample_batch(without))
        assert ours.sample(without=list(without[0])) == \
            theirs.sample(without=list(without[0]))

    def test_random_and_popular_samplers_match(self):
        source = int_source(3)
        for name, kw in (("random", dict(seed=4)), ("popular", {})):
            ours = samplers.get(name, source=source, sample_size=6, **kw)
            theirs = jax_samplers.get(name, source=source, sample_size=6,
                                      **kw)
            for without in ([], source[:5]):
                assert ours.sample(without=without) == \
                    theirs.sample(without=without)
        with pytest.raises(ValueError):
            samplers.get("nope")

    def test_pool_too_small_raises(self):
        s = samplers.get("pop_random", source=[3, 4, 5], vocab=[3, 4, 5],
                         sample_size=2, seed=0)
        with pytest.raises(ValueError):
            s.sample_batch([np.array([3, 4])])


def eval_sequences(seed=0, n=37):
    return test_utils.generate_tokenized_dataset(
        n_sequences=n, min_len=6, max_len=SEQ + 4, vocab_size=V, seed=seed)


def datasets(seqs, task, finetuning=True):
    kw = dict(max_seq_len=SEQ, max_predictions_per_seq=PRED,
              mask_token_id=1, pad_token_id=0, unk_token_id=2,
              masked_lm_rate=0.3)
    ft = np.full(len(seqs), finetuning)
    return (ProcessedDataset(seqs, MaskingConfig(**kw), lambda: V,
                             finetuning=ft, task=task),
            JaxProcessedDataset(seqs, JaxMaskingConfig(**kw), lambda: V,
                                finetuning=ft, task=task))


def models(family, seed=2):
    kw = dict(vocab_size=V, hidden_size=32, num_layers=2,
              num_attention_heads=4, inner_dim=64, max_sequence_length=SEQ,
              max_predictions_per_seq=PRED, use_fused_layer=True)
    jcls, pcls = ((JaxModel, BERT4RecModel) if family == "bert4rec"
                  else (JaxSASRec, SASRecModel))
    jmodel = jcls(config=JaxConfig(**kw))
    flat = random_params(jmodel, seed)   # the output bias spreads logits
    return (jmodel, to_jax(flat), pcls(config=BERT4RecConfig(**kw)),
            params_from_numpy(flat, "cpu"))


def sampler_kw(seqs):
    source = [int(t) for s in seqs for t in s]
    return dict(source=source, vocab=list(dict.fromkeys(source)),
                sample_size=SAMPLE, seed=11)


FAMILIES = [("bert4rec", "mlm"), ("sasrec", "next_item")]


class TestEvaluateAgainstJax:

    @pytest.mark.parametrize("family,task", FAMILIES,
                             ids=[f for f, _ in FAMILIES])
    @pytest.mark.parametrize("finetuning", [True, False],
                             ids=["leave_one_out", "all_positions"])
    def test_host_negatives_give_jax_metrics(self, family, task, finetuning):
        """``device_negatives=False`` with a seeded sampler: the same
        negatives, the same ranks, the same metrics (P-slicing to one slot
        for leave-one-out rows, up to P slots otherwise)."""
        seqs = eval_sequences(1)
        ours_ds, jax_ds = datasets(seqs, task, finetuning)
        jmodel, jparams, model, params = models(family)
        kw = sampler_kw(seqs)
        want = JaxEvaluator(sampler=jax_samplers.get("pop_random", **kw),
                            sample_size=SAMPLE, device_negatives=False) \
            .evaluate(jmodel, jparams, jax_ds, batch_size=8,
                      progress_bar=False)
        got = BERT4RecEvaluator(sampler=samplers.get("pop_random", **kw),
                                sample_size=SAMPLE, device_negatives=False) \
            .evaluate(model, params, ours_ds, batch_size=8,
                      progress_bar=False)
        assert got == want
        n_valid = int(ours_ds.materialize(0)["masked_lm_weights"].sum())
        assert got["Valid Ranks"] == n_valid

    @pytest.mark.parametrize("family,task", FAMILIES,
                             ids=[f for f, _ in FAMILIES])
    def test_full_ranking_gives_jax_metrics(self, family, task):
        seqs = eval_sequences(2)
        ours_ds, jax_ds = datasets(seqs, task)
        jmodel, jparams, model, params = models(family, seed=4)
        want = JaxEvaluator(full_ranking=True).evaluate(
            jmodel, jparams, jax_ds, batch_size=16, progress_bar=False)
        got = BERT4RecEvaluator(full_ranking=True).evaluate(
            model, params, ours_ds, batch_size=16, progress_bar=False)
        assert got == want and got["Valid Ranks"] == len(seqs)
        assert got["HR@10"] >= got["NDCG@10"]


class TestScoringAgainstJax:

    def _hidden(self, seed=0, b=5, p=3, w=16, vp=V + 3):
        rng = np.random.default_rng(seed)
        hidden = rng.normal(size=(b, p, w)).astype(np.float32)
        table = rng.normal(size=(vp, w)).astype(np.float32)
        bias = rng.normal(size=vp).astype(np.float32)
        gt = rng.integers(3, V, size=(b, p)).astype(np.int32)
        return hidden, table, bias, gt

    def test_score_candidates_within_1e5(self):
        hidden, table, bias, _ = self._hidden()
        cand = np.random.default_rng(1).integers(
            0, V, size=(5, 3, 9)).astype(np.int32)
        want = jax_scoring.score_candidates(hidden, table, bias, cand)
        t = [torch.from_numpy(a) for a in (hidden, table, bias, cand)]
        got = candidate_scoring.score_candidates(*t)
        ref = candidate_scoring.score_candidates_reference(*t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ref.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("tile", [7, 16, 200])
    def test_gt_ranks_tiled_equal_jax(self, tile):
        hidden, table, bias, gt = self._hidden(2)
        exclude = np.random.default_rng(3).integers(-1, V, size=(5, 6)) \
            .astype(np.int32)
        want = jax_scoring.gt_ranks_tiled(hidden, table, bias, gt,
                                          vocab_size=V, exclude=exclude,
                                          tile=tile)
        got = candidate_scoring.gt_ranks_tiled(
            *[torch.from_numpy(a) for a in (hidden, table, bias, gt)],
            vocab_size=V, exclude=torch.from_numpy(exclude), tile=tile)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("tile", [None, 13], ids=["dense", "tiled"])
    def test_gt_ranks_full_vocab_equal_jax(self, tile):
        jmodel, jparams, model, params = models("bert4rec", seed=6)
        seqs = eval_sequences(3, n=9)
        _, jax_ds = datasets(seqs, "mlm")
        batch = jax_ds.materialize(0)
        exclude = np.where(batch["labels"] > 0, batch["labels"], -1)
        feats = {k: v for k, v in batch.items() if k != "labels"}
        want = jmodel.gt_ranks_full_vocab(jparams, feats, exclude=exclude,
                                          vocab_tile=tile)
        got = model.gt_ranks_full_vocab(
            params, {k: torch.from_numpy(v) for k, v in feats.items()},
            exclude=torch.from_numpy(exclude), vocab_tile=tile)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_model_score_candidates_within_1e5(self):
        jmodel, jparams, model, params = models("sasrec", seed=7)
        _, jax_ds = datasets(eval_sequences(4, n=6), "next_item")
        feats = {k: v for k, v in jax_ds.materialize(0).items()
                 if k != "labels"}
        cand = np.random.default_rng(2).integers(
            3, V, size=feats["masked_lm_ids"].shape + (10,)).astype(np.int32)
        want = jmodel.score_candidates(jparams, feats, cand)
        got = model.score_candidates(
            params, {k: torch.from_numpy(v) for k, v in feats.items()},
            torch.from_numpy(cand))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


class TestDeviceNegatives:

    def test_never_draws_excluded_zero_mass_or_repeated(self):
        rng = np.random.default_rng(0)
        probs = rng.random(50)
        probs[[3, 17, 40]] = 0.0
        logp = ns.popularity_logp(probs / probs.sum(), "cpu")
        without = rng.integers(0, 51, size=(64, 2, 9)).astype(np.int32)
        gen = torch.Generator().manual_seed(5)
        idx = ns.sample_negatives(gen, logp, torch.from_numpy(without),
                                  20).numpy()
        assert idx.shape == (64, 2, 20) and idx.dtype == np.int32
        for row, excl in zip(idx.reshape(-1, 20), without.reshape(-1, 9)):
            assert len(set(row.tolist())) == 20
            assert not set(row.tolist()) & set(excl.tolist())
            assert not set(row.tolist()) & {3, 17, 40}

    def test_draws_follow_the_popularity_law(self):
        """One draw per row is categorical in the probabilities (the Gumbel
        max law): 40,000 rows, each frequency within 0.01."""
        probs = np.array([0.4, 0.25, 0.15, 0.1, 0.06, 0.04])
        gen = torch.Generator().manual_seed(9)
        idx = ns.sample_negatives(gen, ns.popularity_logp(probs, "cpu"),
                                  torch.full((40000, 1), 6), 1).numpy()
        freq = np.bincount(idx.ravel(), minlength=6) / 40000
        np.testing.assert_allclose(freq, probs, atol=1e-2)

    @pytest.mark.parametrize("family,task", FAMILIES,
                             ids=[f for f, _ in FAMILIES])
    def test_same_candidates_give_the_host_path_ranks(self, family, task):
        """The device path's first batch: its negatives, redrawn from the
        same per-batch generator seed, fed to the JAX evaluator's host rank
        computation give the ranks the device path returned."""
        seqs = eval_sequences(5, n=8)
        ours_ds, jax_ds = datasets(seqs, task)
        jmodel, jparams, model, params = models(family, seed=8)
        ev = BERT4RecEvaluator(sampler=samplers.get("pop_random",
                                                    **sampler_kw(seqs)),
                               sample_size=SAMPLE, seed=21, fetch_workers=0)
        ev._prepare_sampler()
        assert ev._device_sampling_available()
        batch = next(ours_ds.batches(8, shuffle=False, seed=0))
        got = ev.evaluate_batch(model, params, batch, fetch=False).numpy()

        p_used = 1
        sliced = {k: (v[:, :p_used] if k.startswith("masked_lm") else v)
                  for k, v in batch.items()}
        without = ev._build_without_idx(sliced["labels"],
                                        sliced["masked_lm_ids"],
                                        sliced["masked_lm_weights"] > 0)
        gen = torch.Generator().manual_seed(fold_in(21, 0))
        neg = ns.sample_negatives(gen, ns.popularity_logp(
            ev.sampler._probs, "cpu"), torch.from_numpy(without), SAMPLE)
        vocab = np.asarray(ev.sampler.vocab, np.int32)
        cand = np.concatenate([vocab[neg.numpy()],
                               sliced["masked_lm_ids"][..., None]], axis=-1)
        jax_ev = JaxEvaluator(sampler=jax_samplers.get(
            "pop_random", **sampler_kw(seqs)), sample_size=SAMPLE)
        feats = {k: v for k, v in sliced.items() if k != "labels"}
        want = np.asarray(jax_ev._rank_fn(jmodel)(jparams, feats, cand))
        np.testing.assert_array_equal(got, want)

    def test_seeded_runs_repeat_and_unseeded_runs_differ(self):
        seqs = eval_sequences(6, n=40)
        ours_ds, _ = datasets(seqs, "mlm")
        _, _, model, params = models("bert4rec", seed=9)

        def run(seed):
            return BERT4RecEvaluator(
                sampler=samplers.get("pop_random", **{
                    **sampler_kw(seqs), "seed": seed}),
                sample_size=SAMPLE, seed=seed).evaluate(
                    model, params, ours_ds, batch_size=8, progress_bar=False)

        assert run(3) == run(3)
        a, b = run(None), run(None)
        assert a["Valid Ranks"] == b["Valid Ranks"] == len(seqs)
        assert a != b


class TestEvaluatorSurface:

    def test_mesh_raises(self):
        """A port mesh is taken (one rank here: the same metrics as without
        it); anything else raises a TypeError naming it."""
        from bert4rec_tpu_torch.core import create_mesh
        with pytest.raises(TypeError, match="BERT4RecEvaluator.*object"):
            BERT4RecEvaluator(mesh=object())
        seqs = eval_sequences(2)
        ours_ds, _ = datasets(seqs, "mlm")
        _, _, model, params = models("bert4rec", seed=4)
        mesh = create_mesh(device="cpu")
        runs = [BERT4RecEvaluator(full_ranking=True, mesh=m).evaluate(
            model, params, ours_ds, batch_size=16, progress_bar=False)
            for m in (None, mesh)]
        assert runs[0] == runs[1] and runs[0]["Valid Ranks"] == len(seqs)

    def test_device_negatives_true_needs_an_int_vocab(self):
        seqs = eval_sequences(7, n=8)
        ours_ds, _ = datasets(seqs, "mlm")
        _, _, model, params = models("bert4rec", seed=10)
        src = [f"i{int(t)}" for s in seqs for t in s]
        ev = BERT4RecEvaluator(
            sampler=samplers.get("pop_random", source=src,
                                 vocab=list(dict.fromkeys(src)),
                                 sample_size=SAMPLE, seed=0),
            sample_size=SAMPLE, device_negatives=True)
        with pytest.raises(ValueError, match="device_negatives"):
            ev.evaluate(model, params, ours_ds, batch_size=8,
                        progress_bar=False)

    def test_threaded_fetch_and_wrapper_match_sequential(self):
        """Fetching ranks on worker threads gives the metrics of the
        strictly sequential loop, and a model wrapper stands for (model,
        params)."""
        from bert4rec_tpu_torch.models import BERT4RecModelWrapper
        seqs = eval_sequences(9, n=30)
        ours_ds, _ = datasets(seqs, "next_item")
        _, _, model, params = models("sasrec", seed=12)
        results = []
        for workers, wrapped in ((0, False), (2, False), (2, True)):
            ev = BERT4RecEvaluator(sampler=samplers.get(
                "pop_random", **sampler_kw(seqs)), sample_size=SAMPLE,
                seed=5, fetch_workers=workers)
            args = ((BERT4RecModelWrapper(model, params), None) if wrapped
                    else (model, params))
            results.append(ev.evaluate(*args, ours_ds, batch_size=4,
                                       progress_bar=False))
        assert results[0] == results[1] == results[2]

    def test_factory_and_save_results(self, tmp_path):
        seqs = eval_sequences(8, n=12)
        ours_ds, _ = datasets(seqs, "mlm")
        _, _, model, params = models("bert4rec", seed=11)
        ev = get_evaluator(sampler=samplers.get("pop_random",
                                                **sampler_kw(seqs)),
                           sample_size=SAMPLE, seed=1)
        assert isinstance(ev, BERT4RecEvaluator)
        res = ev.evaluate(model, params, ours_ds, batch_size=5,
                          progress_bar=False)
        out = ev.save_results(tmp_path / "r")
        assert json.loads(out.read_text()) == res
        assert res["Valid Ranks"] == 12
        assert all(0.0 <= v <= 1.0 for k, v in res.items()
                   if k != "Valid Ranks")
