"""Popularity-weighted random sampler — the default evaluation sampler
(port of ``bert4rec_tpu/dataloaders/samplers/popular_random_sampler.py``:
the same numpy draws, so one seed gives the JAX package's negatives).

Semantics of reference ``samplers/popular_random_sampler.py``: per-item
probability = frequency in ``source`` / len(source) (:119-126); a sample draws
``sample_size`` items without replacement from that distribution, excluding
``without`` (:77-117 — the reference oversamples by ``len(without)`` then
filters and truncates, which lands on the same support).

Differences from the reference:
- the probability distribution is built with one vectorized ``np.bincount``
  instead of the reference's O(V*S) ``source.count(item)`` loop;
- :meth:`sample_batch` draws **many exclusion sets at once** via Gumbel
  top-k (exact weighted sampling without replacement), which is what the
  vectorized evaluator uses — the reference samples one python list per
  masked position (SURVEY.md §3.3 "hot, pure python").
"""

from typing import Optional, Sequence

import numpy as np

from bert4rec_tpu_torch.dataloaders.samplers.base_sampler import BaseSampler


class PopularRandomSampler(BaseSampler):

    def __init__(self, source: Optional[list] = None,
                 vocab: Optional[list] = None,
                 sample_size: Optional[int] = None,
                 allow_duplicates: bool = False,
                 seed: Optional[int] = None):
        super().__init__(source, vocab, sample_size)
        self.allow_duplicates = allow_duplicates
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.probability_distribution: list = []
        self._vocab_index: dict = {}
        self._probs: Optional[np.ndarray] = None
        if self.source is not None and self.vocab is not None:
            self._determine_probability_distribution(self.source, self.vocab)

    def is_fully_prepared(self) -> bool:
        if self.vocab is None or self.sample_size is None:
            return False
        if self._probs is None or len(self.vocab) != len(self._probs):
            return False
        return True

    # ------------------------------------------------------------------ #

    def _determine_probability_distribution(self, source: list, vocab: list):
        """Vectorized popularity distribution (replaces reference :119-126)."""
        self._vocab_index = {item: i for i, item in enumerate(vocab)}
        counts = np.zeros(len(vocab), dtype=np.int64)
        idx = np.fromiter(
            (self._vocab_index.get(item, -1) for item in source),
            count=len(source), dtype=np.int64)
        np.add.at(counts, idx[idx >= 0], 1)
        self._probs = counts / max(len(source), 1)
        self.probability_distribution = self._probs.tolist()

    def _ensure_distribution(self, source, vocab):
        if self._probs is None or source is not self.source or vocab is not self.vocab:
            self._determine_probability_distribution(source, vocab)

    # ------------------------------------------------------------------ #

    def sample(self, sample_size: Optional[int] = None,
               source: Optional[list] = None,
               vocab: Optional[list] = None,
               allow_duplicates: Optional[bool] = None,
               seed: Optional[int] = None,
               without: Optional[list] = None) -> list:
        source, vocab, sample_size = self._get_parameters(
            source, vocab, sample_size)
        if source is None:
            raise ValueError(
                "PopularRandomSampler needs a source: pass one to the "
                "constructor or to sample().")
        if vocab is None:
            raise ValueError(
                "PopularRandomSampler needs a vocab: pass one to the "
                "constructor or to sample().")
        if allow_duplicates is None:
            allow_duplicates = self.allow_duplicates
        if not allow_duplicates and sample_size > len(vocab):
            raise ValueError(
                f"Cannot draw {sample_size} distinct items from a vocab of "
                f"only {len(vocab)} (duplicates are disallowed).")

        self._ensure_distribution(source, vocab)
        rng = np.random.default_rng(seed) if seed is not None else self._rng

        without_idx = self._without_indices(without)
        if not allow_duplicates and sample_size > len(vocab) - len(without_idx):
            raise ValueError(
                f"Excluding {len(without_idx)} items leaves fewer than "
                f"{sample_size} of the {len(vocab)}-item vocab to sample "
                f"without replacement.")

        if allow_duplicates:
            idx = rng.choice(len(vocab), size=sample_size, replace=True,
                             p=self._probs)
        else:
            idx = self._gumbel_topk(rng, without_idx, sample_size)
        return [vocab[i] for i in idx]

    def sample_batch(self,
                     without_lists: Sequence[Sequence],
                     sample_size: Optional[int] = None,
                     seed: Optional[int] = None) -> np.ndarray:
        """Draw one weighted-without-replacement sample per exclusion set.

        :param without_lists: B exclusion sets (vocab items)
        :returns: ``[B, sample_size]`` array of vocab *indices*
        """
        _, vocab, sample_size = self._get_parameters(None, None, sample_size)
        self._ensure_distribution(self.source, vocab)
        rng = np.random.default_rng(seed) if seed is not None else self._rng

        b, v = len(without_lists), len(vocab)
        with np.errstate(divide="ignore"):
            logp = np.log(self._probs).astype(np.float32)
        # f32 Gumbel keys: half the memory traffic of rng.gumbel's f64 at
        # [B, V] scale (the eval host path's dominant cost for big vocabs)
        u = rng.random((b, v), dtype=np.float32)
        tiny = np.float32(1e-12)
        gumbel = -np.log(-np.log(u + tiny) + tiny)
        scores = gumbel + logp[None, :]

        lut = self._int_id_lut()
        if lut is not None and all(
                isinstance(w, np.ndarray) and w.dtype.kind in "iu"
                for w in without_lists):
            # fully vectorized exclusion: one flat scatter for the batch
            lens = np.fromiter((len(w) for w in without_lists),
                               count=b, dtype=np.int64)
            if lens.sum():
                flat = np.concatenate(
                    [np.asarray(w) for w in without_lists])
                rows = np.repeat(np.arange(b), lens)
                valid = (flat >= 0) & (flat < len(lut))
                cols = lut[flat[valid]]
                rows, keep = rows[valid], cols >= 0
                scores[rows[keep], cols[keep]] = -np.inf
        else:
            for i, without in enumerate(without_lists):
                idx = self._without_indices(without)
                if idx.size:
                    scores[i, idx] = -np.inf
        # per-row pool check: argpartition would otherwise silently fill
        # short rows with excluded/zero-mass items (sample() raises on the
        # same condition, and silent fill inflates eval metrics)
        pool = np.isfinite(scores).sum(axis=1)
        if np.any(pool < sample_size):
            short = int(pool.min())
            raise ValueError(
                f"Excluding the per-row item sets leaves as few as {short} "
                f"of the {v}-item vocab with probability mass — fewer than "
                f"the {sample_size} negatives requested.")
        # top-k per row; candidate order within a sample does not matter
        part = np.argpartition(-scores, sample_size - 1, axis=1)[:, :sample_size]
        return part

    # ------------------------------------------------------------------ #

    def _int_id_lut(self) -> Optional[np.ndarray]:
        """Dense id -> vocab-index LUT when the vocab is integer ids (the
        tokenized-eval case); -1 marks ids outside the vocab."""
        if getattr(self, "_lut_cache_for", None) is self.vocab:
            return self._lut_cache
        lut = None
        try:
            ids = np.asarray(self.vocab)
            if ids.dtype.kind in "iu" and ids.size and ids.min() >= 0:
                lut = np.full(int(ids.max()) + 1, -1, dtype=np.int64)
                lut[ids] = np.arange(len(ids))
        except (TypeError, ValueError):
            lut = None
        self._lut_cache = lut
        self._lut_cache_for = self.vocab
        return lut

    def _without_indices(self, without: Optional[list]) -> np.ndarray:
        if without is None or len(without) == 0:
            return np.empty(0, dtype=np.int64)
        seen = {self._vocab_index[w] for w in set(without)
                if w in self._vocab_index}
        return np.fromiter(seen, dtype=np.int64, count=len(seen))

    def _gumbel_topk(self, rng, without_idx: np.ndarray, k: int) -> np.ndarray:
        with np.errstate(divide="ignore"):
            logp = np.log(self._probs)
        scores = rng.gumbel(size=logp.shape) + logp
        if without_idx.size:
            scores[without_idx] = -np.inf
        return np.argpartition(-scores, k - 1)[:k]

    def set_source(self, source: list):
        super().set_source(source)
        if self.vocab is not None:
            self._determine_probability_distribution(self.source, self.vocab)

    def set_vocab(self, vocab: list):
        super().set_vocab(vocab)
        if self.source is not None:
            self._determine_probability_distribution(self.source, self.vocab)
