"""The port's quality oracles held against the JAX package on the CPU: the
planted catalogs (their laws and their sequences, bit for bit, at the tiny
preset's width and at ml-1m's), the popularity, Markov and temporal
scorers (candidate scores within 1e-6, the -inf cells equal; full-catalog
ranks equal), the host full-ranking ceilings (metrics and ranks equal),
``evaluate_scorer`` on the host-negatives path (metrics equal), and the
evaluator taking a scorer with no params on its three paths."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bert4rec_tpu.evaluation as jax_evaluation
from bert4rec_tpu.dataloaders.processed_dataset import (
    MaskingConfig as JaxMaskingConfig,
    ProcessedDataset as JaxProcessedDataset,
)
from bert4rec_tpu.evaluation import baselines as jax_baselines
from bert4rec_tpu.evaluation import markov_oracle as jax_mo
from bert4rec_tpu.evaluation import temporal_oracle as jax_to
import bert4rec_tpu_torch.evaluation as evaluation
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    MaskingConfig, ProcessedDataset,
)
from bert4rec_tpu_torch.evaluation import baselines
from bert4rec_tpu_torch.evaluation import markov_oracle as mo
from bert4rec_tpu_torch.evaluation import temporal_oracle as to

SCORE_TOL = 1e-6
TINY, ML1M = 512, 3706         # the oracle presets' catalog widths
SEQ, PRED = 32, 8              # the tiny preset's sequence and predictions


@pytest.fixture(scope="module")
def markov_pair():
    return (mo.MarkovCatalog(n_items=TINY, seed=5),
            jax_mo.MarkovCatalog(n_items=TINY, seed=5))


@pytest.fixture(scope="module")
def temporal_pair():
    return (to.TemporalMarkovCatalog(n_items=TINY, seed=6),
            jax_to.TemporalMarkovCatalog(n_items=TINY, seed=6))


def both(batch: dict) -> tuple:
    """The same numpy batch as port tensors and as JAX arrays."""
    return ({k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


def scoring_batch(cat, seed, b=6, s=SEQ, p=PRED, timestamps=None):
    """A batch of the catalog's sequences with masked positions over the
    whole row (0, 1 and s-1 among them), and candidates: out-of-range
    ids, specials, random items, and the successors of both contexts."""
    rng = np.random.default_rng(seed)
    seqs = cat.sample_sequences(b, s, s, seed=seed)
    if timestamps:
        seqs, tss = seqs
    ids = np.stack([q[:s] for q in seqs]).astype(np.int32)
    pos = np.stack([np.sort(np.concatenate([
        [0, 1, s - 1], rng.choice(np.arange(2, s - 1), size=p - 3,
                                  replace=False)])) for _ in range(b)])
    cand = rng.integers(-2, cat.vocab_size + 3, size=(b, p, 40))
    for back, lo in ((1, 0), (2, 8)):
        prev = np.take_along_axis(ids, np.maximum(pos - back, 0), axis=1)
        item = np.clip(prev - cat.n_specials, 0, cat.n_items - 1)
        cand[..., lo:lo + 8] = cat.succ[item] + cat.n_specials
    batch = {"input_word_ids": ids,
             "input_mask": np.ones((b, s), np.int32),
             "masked_lm_positions": pos.astype(np.int32),
             "masked_lm_ids": np.take_along_axis(ids, pos, axis=1)}
    if timestamps:
        batch["input_timestamps"] = np.stack([q[:s] for q in tss])
    return batch, cand.astype(np.int32)


def assert_scores_match(got: torch.Tensor, want, neg: float):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got == neg, want == neg)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)


def loo_datasets(seqs, timestamps=None, task="mlm"):
    """The port's and JAX's leave-one-out test datasets of ``seqs``."""
    kw = dict(max_seq_len=SEQ, max_predictions_per_seq=PRED,
              mask_token_id=1, pad_token_id=0, unk_token_id=2,
              masked_lm_rate=0.3)
    vocab = int(max(int(q.max()) for q in seqs)) + 1
    fin = np.ones(len(seqs), bool)
    return (ProcessedDataset(seqs, MaskingConfig(**kw), lambda: vocab,
                             finetuning=fin, timestamps=timestamps,
                             task=task),
            JaxProcessedDataset(seqs, JaxMaskingConfig(**kw), lambda: vocab,
                                finetuning=fin, timestamps=timestamps,
                                task=task))


class TestCatalogs:

    @pytest.mark.parametrize("n_items", [TINY, ML1M], ids=["tiny", "ml1m"])
    def test_markov_catalog_equals_jax(self, n_items):
        ours = mo.MarkovCatalog(n_items=n_items, seed=42)
        theirs = jax_mo.MarkovCatalog(n_items=n_items, seed=42)
        for name in ("pop", "succ", "w"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name))
        assert ours.vocab_size == theirs.vocab_size == n_items + 3
        np.testing.assert_array_equal(ours.next_prob(), theirs.next_prob())
        np.testing.assert_array_equal(ours.log_next_prob_matrix(),
                                      theirs.log_next_prob_matrix())
        a = ours.sample_sequences(64, 16, 40, seed=43)
        b = theirs.sample_sequences(64, 16, 40, seed=43)
        assert len(a) == len(b) == 64
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, y)

    @pytest.mark.parametrize("n_items", [TINY, ML1M], ids=["tiny", "ml1m"])
    def test_temporal_catalog_equals_jax(self, n_items):
        ours = to.TemporalMarkovCatalog(n_items=n_items, seed=42)
        theirs = jax_to.TemporalMarkovCatalog(n_items=n_items, seed=42)
        for name in ("pop", "succ", "w", "gaps", "t0"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name))
        assert ours.regime_threshold_s == theirs.regime_threshold_s
        np.testing.assert_array_equal(ours.cond_prob(), theirs.cond_prob())
        (sa, ta) = ours.sample_sequences(64, 16, 40, seed=44)
        (sb, tb) = theirs.sample_sequences(64, 16, 40, seed=44)
        for x, y, u, v in zip(sa, sb, ta, tb):
            assert x.dtype == y.dtype and u.dtype == v.dtype == np.int64
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(u, v)

    def test_vectorized_supports_equal_jax(self):
        """The support sampler of catalogs wider than 50,000 items (the
        Reddit preset's), on a 60,000-item popularity law."""
        pop = np.arange(1, 60_001, dtype=np.float64) ** -1.1
        pop /= pop.sum()
        ours = mo.sample_popularity_supports(np.random.default_rng(7), pop,
                                             2_000, 8)
        theirs = jax_mo.sample_popularity_supports(
            np.random.default_rng(7), pop, 2_000, 8)
        np.testing.assert_array_equal(ours, theirs)
        assert (np.sort(ours, 1)[:, 1:] != np.sort(ours, 1)[:, :-1]).all()

    def test_gaps_must_be_fast_then_slow(self):
        with pytest.raises(ValueError, match="gaps"):
            to.TemporalMarkovCatalog(n_items=16, gaps=(43_200, 3_600))


class TestScorers:

    def test_popularity_scores_and_ranks_equal_jax(self):
        rng = np.random.default_rng(1)
        counts = rng.integers(0, 50, size=TINY + 3)
        ours = baselines.PopularityScorer(counts, device="cpu")
        theirs = jax_baselines.PopularityScorer(counts)
        cat = mo.MarkovCatalog(n_items=TINY, seed=1)
        batch, cand = scoring_batch(cat, 2)
        (tb, jb), tc = both(batch), torch.from_numpy(cand)
        assert_scores_match(ours.score_candidates(None, tb, tc),
                            theirs.score_candidates(None, jb,
                                                    jnp.asarray(cand)),
                            baselines.NEG_INF)
        self.assert_ranks_match(ours, theirs, batch, rng)

    @pytest.mark.parametrize("offset", [-1, 0, 1])
    def test_markov_scores_equal_jax(self, markov_pair, offset):
        ours, theirs = markov_pair
        batch, cand = scoring_batch(ours, 10 + offset)
        (tb, jb) = both(batch)
        got = mo.MarkovOracleScorer(ours, context_offset=offset,
                                    device="cpu").score_candidates(
            None, tb, torch.from_numpy(cand))
        want = jax_mo.MarkovOracleScorer(
            theirs, context_offset=offset).score_candidates(
            None, jb, jnp.asarray(cand))
        assert_scores_match(got, want, mo.NEG_INF)

    @pytest.mark.parametrize("offset", [-1, 0, 1])
    def test_markov_full_vocab_ranks_equal_jax(self, markov_pair, offset):
        ours, theirs = markov_pair
        batch, _ = scoring_batch(ours, 20 + offset)
        self.assert_ranks_match(
            mo.MarkovOracleScorer(ours, context_offset=offset, device="cpu"),
            jax_mo.MarkovOracleScorer(theirs, context_offset=offset), batch,
            np.random.default_rng(offset + 5))

    @staticmethod
    def assert_ranks_match(ours, theirs, batch, rng):
        """Full-catalog ranks without and with an exclusion set (padded
        with -1), equal to JAX's."""
        b = batch["input_word_ids"].shape[0]
        exclude = rng.integers(-1, TINY + 3, size=(b, 12)).astype(np.int32)
        (tb, jb) = both(batch)
        for ex in (None, exclude):
            got = ours.gt_ranks_full_vocab(
                None, tb, exclude=None if ex is None
                else torch.from_numpy(ex))
            want = theirs.gt_ranks_full_vocab(
                None, jb, exclude=None if ex is None else jnp.asarray(ex))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_dense_rank_path_refuses_catalog_scale(self, markov_pair):
        cat = markov_pair[0]
        scorer = mo.MarkovOracleScorer(cat, device="cpu")
        scorer._vocab = mo.MarkovOracleScorer.DENSE_VOCAB_LIMIT + 1
        batch, _ = scoring_batch(markov_pair[0], 3)
        with pytest.raises(ValueError, match="DENSE_VOCAB_LIMIT"):
            scorer.gt_ranks_full_vocab(None, both(batch)[0])
        assert scorer._dense is None
        assert mo.MarkovOracleScorer.DENSE_VOCAB_LIMIT == \
            jax_mo.MarkovOracleScorer.DENSE_VOCAB_LIMIT

    @pytest.mark.parametrize("blind", [False, True], ids=["temporal",
                                                          "time_blind"])
    @pytest.mark.parametrize("offset", [-1, 0])
    def test_temporal_scores_equal_jax(self, temporal_pair, blind, offset):
        ours, theirs = temporal_pair
        batch, cand = scoring_batch(ours, 30 + offset, timestamps=True)
        (tb, jb) = both(batch)
        got = to.TemporalOracleScorer(
            ours, time_blind=blind, context_offset=offset,
            device="cpu").score_candidates(None, tb, torch.from_numpy(cand))
        want = jax_to.TemporalOracleScorer(
            theirs, time_blind=blind,
            context_offset=offset).score_candidates(None, jb,
                                                    jnp.asarray(cand))
        assert_scores_match(got, want, to.NEG_INF)

    def test_temporal_blind_scorer_never_reads_timestamps(self,
                                                          temporal_pair):
        batch, cand = scoring_batch(temporal_pair[0], 40, timestamps=True)
        del batch["input_timestamps"]
        scorer = to.TemporalOracleScorer(temporal_pair[0], time_blind=True,
                                         device="cpu")
        out = scorer.score_candidates(None, both(batch)[0],
                                      torch.from_numpy(cand))
        assert torch.isfinite(out).all()


class TestHostCeilings:

    @pytest.mark.parametrize("offset", [0, 1], ids=["mlm", "next_item"])
    def test_host_full_ranking_oracle_equals_jax(self, markov_pair, offset):
        ours, theirs = markov_pair
        task = "next_item" if offset else "mlm"
        seqs = ours.sample_sequences(96, 12, SEQ, seed=50)
        ds, jds = loo_datasets(seqs, task=task)
        m, r = mo.host_full_ranking_oracle(ours, ds, context_offset=offset,
                                           batch_size=32)
        jm, jr = jax_mo.host_full_ranking_oracle(
            theirs, jds, context_offset=offset, batch_size=32)
        assert m == jm
        np.testing.assert_array_equal(r, jr)
        assert mo.fits_host_dense(ours) == jax_mo.fits_host_dense(theirs)

    @pytest.mark.parametrize("blind", [False, True], ids=["temporal",
                                                          "time_blind"])
    def test_host_full_ranking_temporal_oracle_equals_jax(self,
                                                          temporal_pair,
                                                          blind):
        ours, theirs = temporal_pair
        seqs, tss = ours.sample_sequences(96, 12, SEQ, seed=51)
        ds, jds = loo_datasets(seqs, timestamps=tss)
        m, r = to.host_full_ranking_temporal_oracle(ours, ds,
                                                    time_blind=blind,
                                                    batch_size=32)
        jm, jr = jax_to.host_full_ranking_temporal_oracle(
            theirs, jds, time_blind=blind, batch_size=32)
        assert m == jm
        np.testing.assert_array_equal(r, jr)


def host_negatives(monkeypatch):
    """Both packages' ``evaluate_scorer`` on the host-negatives path."""
    monkeypatch.setattr(evaluation, "BERT4RecEvaluator", functools.partial(
        evaluation.BERT4RecEvaluator, device_negatives=False))
    monkeypatch.setattr(jax_evaluation, "BERT4RecEvaluator",
                        functools.partial(jax_evaluation.BERT4RecEvaluator,
                                          device_negatives=False))


class TestEvaluateScorer:

    @pytest.mark.parametrize("sampler", ["pop_random", "random"])
    def test_markov_and_popularity_metrics_equal_jax(self, markov_pair,
                                                     monkeypatch, sampler):
        host_negatives(monkeypatch)
        ours, theirs = markov_pair
        train = ours.sample_sequences(300, 12, SEQ, seed=60)
        source = [int(t) for s in train for t in s]
        ds, jds = loo_datasets(ours.sample_sequences(200, 12, SEQ, seed=61))
        kw = dict(source=source, sample_size=100, seed=0, sampler=sampler,
                  batch_size=64)
        for offset in (0, -1):
            got = mo.evaluate_scorer(
                mo.MarkovOracleScorer(ours, context_offset=offset,
                                      device="cpu"), None, ds, **kw)
            want = jax_mo.evaluate_scorer(
                jax_mo.MarkovOracleScorer(theirs, context_offset=offset),
                None, jds, **kw)
            assert got == {k: float(v) for k, v in want.items()}, offset
        got = mo.evaluate_scorer(baselines.PopularityScorer.from_source(
            source, ours.vocab_size, device="cpu"), None, ds, **kw)
        want = jax_mo.evaluate_scorer(
            jax_baselines.PopularityScorer.from_source(source,
                                                       theirs.vocab_size),
            None, jds, **kw)
        assert got == {k: float(v) for k, v in want.items()}

    def test_temporal_metrics_equal_jax(self, temporal_pair, monkeypatch):
        host_negatives(monkeypatch)
        ours, theirs = temporal_pair
        train, _ = ours.sample_sequences(300, 12, SEQ, seed=62)
        source = [int(t) for s in train for t in s]
        seqs, tss = ours.sample_sequences(200, 12, SEQ, seed=63)
        ds, jds = loo_datasets(seqs, timestamps=tss)
        kw = dict(source=source, sample_size=100, seed=0, batch_size=64)
        for blind, offset in ((False, 0), (True, 0), (False, -1)):
            got = mo.evaluate_scorer(
                to.TemporalOracleScorer(ours, time_blind=blind,
                                        context_offset=offset,
                                        device="cpu"), None, ds, **kw)
            want = jax_mo.evaluate_scorer(
                jax_to.TemporalOracleScorer(theirs, time_blind=blind,
                                            context_offset=offset),
                None, jds, **kw)
            assert got == {k: float(v) for k, v in want.items()}, \
                (blind, offset)

    def test_device_negatives_agree_in_distribution(self, markov_pair):
        """The device-negatives path (the default for ``pop_random``)
        draws another stream of the same law: the oracle's HR@10 over 512
        leave-one-out rows lies within 0.06 of the host path's (about
        three standard deviations of the difference)."""
        cat = markov_pair[0]
        train = cat.sample_sequences(300, 12, SEQ, seed=64)
        source = [int(t) for s in train for t in s]
        ds, _ = loo_datasets(cat.sample_sequences(512, 12, SEQ, seed=65))
        scorer = mo.MarkovOracleScorer(cat, device="cpu")
        kw = dict(source=source, sample_size=100, seed=0, batch_size=128)
        device = mo.evaluate_scorer(scorer, None, ds, **kw)
        with pytest.MonkeyPatch.context() as mp:
            host_negatives(mp)
            host = mo.evaluate_scorer(scorer, None, ds, **kw)
        assert device["Valid Ranks"] == host["Valid Ranks"] == 512
        assert abs(device["HR@10"] - host["HR@10"]) <= 0.06

    def test_mesh_raises(self, markov_pair):
        """``evaluate_scorer`` takes a port mesh (one rank here: the
        metrics without it) and names anything else in a TypeError."""
        from bert4rec_tpu_torch.core import create_mesh
        cat = markov_pair[0]
        scorer = mo.MarkovOracleScorer(cat, device="cpu")
        with pytest.raises(TypeError, match="BERT4RecEvaluator.*object"):
            mo.evaluate_scorer(scorer, None, [], source=[3, 4],
                               mesh=object())
        ds, _ = loo_datasets(cat.sample_sequences(64, 12, SEQ, seed=66))
        source = [int(t) for s in cat.sample_sequences(300, 12, SEQ,
                                                       seed=64) for t in s]
        kw = dict(source=source, sample_size=100, seed=0, batch_size=32)
        plain = mo.evaluate_scorer(scorer, None, ds, **kw)
        meshed = mo.evaluate_scorer(scorer, None, ds, **kw,
                                    mesh=create_mesh(device="cpu"))
        assert meshed == plain and plain["Valid Ranks"] == 64


class TestEvaluatorWithoutParams:
    """The evaluator places a params-free scorer's batches on the scorer's
    ``device`` on all three paths, as JAX evaluates its scorers with
    ``params=None``."""

    @pytest.fixture(scope="class")
    def world(self):
        rng = np.random.default_rng(70)
        seqs = [rng.integers(3, 60, size=int(rng.integers(6, SEQ)))
                .astype(np.int32) for _ in range(80)]
        source = [int(t) for s in seqs for t in s]
        return seqs, source

    def evaluators(self, source, pkg, samplers, **kw):
        s = samplers.get("pop_random", source=source,
                         vocab=list(dict.fromkeys(source)), sample_size=20,
                         seed=3)
        return pkg.BERT4RecEvaluator(sampler=s, sample_size=20, seed=3,
                                     **kw)

    @pytest.mark.parametrize("path", ["host", "full"])
    def test_popularity_floor_equals_jax(self, world, path):
        from bert4rec_tpu.dataloaders import samplers as jax_samplers
        from bert4rec_tpu_torch.dataloaders import samplers
        seqs, source = world
        ds, jds = loo_datasets(seqs)
        kw = ({"full_ranking": True} if path == "full"
              else {"device_negatives": False})
        got = self.evaluators(source, evaluation, samplers, **kw).evaluate(
            baselines.PopularityScorer.from_source(source, 60, device="cpu"),
            None, ds, batch_size=16, progress_bar=False)
        want = self.evaluators(source, jax_evaluation, jax_samplers,
                               **kw).evaluate(
            jax_baselines.PopularityScorer.from_source(source, 60), None,
            jds, batch_size=16, progress_bar=False)
        assert got == {k: float(v) for k, v in want.items()}

    def test_device_negatives_path(self, world):
        from bert4rec_tpu_torch.dataloaders import samplers
        seqs, source = world
        ds, _ = loo_datasets(seqs)
        ev = self.evaluators(source, evaluation, samplers)
        assert ev._device_sampling_available()
        res = ev.evaluate(
            baselines.PopularityScorer.from_source(source, 60, device="cpu"),
            None, ds, batch_size=16, progress_bar=False)
        assert res["Valid Ranks"] == len(seqs)
        assert 0.0 < res["HR@10"] <= 1.0

    def test_scorer_without_device_raises(self, world):
        seqs, _ = world
        ds, _ = loo_datasets(seqs)

        class NoDevice:
            def score_candidates(self, params, batch, candidates):
                raise AssertionError("never reached")

        with pytest.raises(ValueError, match="no `device`"):
            evaluation.BERT4RecEvaluator(full_ranking=True).evaluate(
                NoDevice(), None, ds, batch_size=16, progress_bar=False)

    def test_scorers_default_to_the_card(self, markov_pair, temporal_pair,
                                         monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (lambda: baselines.PopularityScorer(np.ones(8)),
                     lambda: mo.MarkovOracleScorer(markov_pair[0]),
                     lambda: to.TemporalOracleScorer(temporal_pair[0])):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()


def test_jax_stays_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
