"""A quality benchmark for the temporal family: planted time-routed
Markov structure with two computable ceilings (port of
``bert4rec_tpu/evaluation/temporal_oracle.py``).

The time signal routes the transition's context position:

    context(t) = item[t-1]  if the gap before event t is short ("fast")
               = item[t-2]  if the gap is long ("slow")
    P(item[t] = j | context c) = alpha * T[c, j] + (1 - alpha) * pop[j]

with one transition world T over a Zipf popularity. The regimes are
equiprobable and the gaps regime-deterministic, so every event's regime
is decodable from the timestamps: the signal the model's pairwise log2
time-delta buckets see. Two Bayes ceilings bracket the value of time
under the 101-candidate leave-one-out protocol:

- the temporal oracle decodes the regime and conditions on the routed
  context: the ceiling of a time-aware model;
- the time-blind oracle scores the regime-marginal law
  ``0.5 * (P(.|item[t-1]) + P(.|item[t-2]))`` (positions are visible to
  it, time is not): the ceiling of a model that cannot see timestamps.

The first step (t=1) has no ``item[t-2]`` and is forced "fast"; the
scorers treat positions without a second-back context the same way.
"""

import numpy as np
import torch

from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.evaluation import markov_oracle

NEG_INF = float(np.finfo(np.float32).min)


class TemporalMarkovCatalog:
    """The planted time-routed generative process and its exact laws.

    :param gaps: inter-event gap in seconds per regime ``(fast, slow)``;
        the defaults land in well separated log2 buckets (11 and 15) of
        the model's bucket law.
    """

    def __init__(self, n_items: int, branching: int = 8,
                 alpha: float = 0.6, zipf_s: float = 1.1,
                 dirichlet: float = 1.0, seed: int = 0,
                 n_specials: int = 3, gaps=(3_600, 43_200),
                 t0: int = 1_600_000_000):
        rng = np.random.default_rng(seed)
        self.n_items = int(n_items)
        self.n_specials = int(n_specials)
        self.vocab_size = self.n_items + self.n_specials
        self.branching = int(branching)
        self.alpha = float(alpha)
        self.gaps = (int(gaps[0]), int(gaps[1]))
        if not self.gaps[0] < self.gaps[1]:
            raise ValueError(f"gaps must be (fast, slow), got {gaps}")
        self.t0 = int(t0)
        # one successor world, drawn as MarkovCatalog draws its own
        self.pop, self.succ, self.w = markov_oracle.popularity_and_supports(
            rng, self.n_items, self.branching, zipf_s, dirichlet)

    def cond_prob(self) -> np.ndarray:
        """Dense ``[n_items, n_items]`` ``P(next | routed context)``."""
        return markov_oracle.mixture_matrix(self.pop, self.succ, self.w,
                                            self.alpha)

    @property
    def regime_threshold_s(self) -> float:
        """Gap threshold between the regimes (geometric midpoint)."""
        return float(np.sqrt(self.gaps[0]) * np.sqrt(self.gaps[1]))

    def sample_sequences(self, n: int, min_len: int, max_len: int,
                         seed: int = 0):
        """``n`` (token-id sequence, int64 timestamp sequence) pairs. Per
        step: regime ~ Bernoulli(0.5) (fast at t=1); the gap before the
        event is ``gaps[regime]``; the item follows the mixture law of the
        routed context (one or two back)."""
        rng = np.random.default_rng(seed)
        lens = rng.integers(min_len, max_len + 1, size=n)
        steps = int(lens.max())
        cur = rng.choice(self.n_items, size=n, p=self.pop)
        rows = np.empty((n, steps), dtype=np.int64)
        ts = np.empty((n, steps), dtype=np.int64)
        rows[:, 0] = cur
        ts[:, 0] = self.t0
        cum_w = np.cumsum(self.w, axis=1)                 # [n_items, B]
        gaps = np.asarray(self.gaps)
        for t in range(1, steps):
            regime = (rng.random(n) < 0.5).astype(np.int64)
            if t == 1:
                regime[:] = 0  # no item[t-2] yet
            ts[:, t] = ts[:, t - 1] + gaps[regime]
            ctx = np.where(regime == 0, rows[:, t - 1],
                           rows[:, max(t - 2, 0)])
            use_trans = rng.random(n) < self.alpha
            r = rng.random(n)
            k = (r[:, None] > cum_w[ctx]).sum(axis=1)
            nxt_trans = self.succ[ctx, np.minimum(k, self.branching - 1)]
            nxt_pop = rng.choice(self.n_items, size=n, p=self.pop)
            rows[:, t] = np.where(use_trans, nxt_trans, nxt_pop)
        seqs = [(rows[i, :lens[i]] + self.n_specials).astype(np.int32)
                for i in range(n)]
        tss = [ts[i, :lens[i]].copy() for i in range(n)]
        return seqs, tss


class TemporalOracleScorer:
    """Bayes-optimal scorer of :class:`TemporalMarkovCatalog` data, with
    the model interface the evaluator reads.

    :param time_blind: score the regime-marginal law (never reads the
        timestamps; positions stay visible): the time-blind ceiling.
    :param context_offset: 0 is correct; -1 the deliberately broken
        off-by-one variant (the contexts one further back, and the regime
        decoded from the shifted gap).
    :param device: where the law lives and the scoring runs.

    The sparse law (any catalog width): score = log((1-alpha)*pop[cand]
    + the matched successor mass of the routed context); a special-token
    context falls back to the popularity marginal.
    """

    def __init__(self, catalog: TemporalMarkovCatalog,
                 time_blind: bool = False, context_offset: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self._cat = catalog
        self._blind = bool(time_blind)
        self._offset = int(context_offset)
        self._s = catalog.n_specials
        self._vocab = catalog.vocab_size
        self._threshold = catalog.regime_threshold_s
        pop = catalog.pop

        def put(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(
                a.astype(dtype))).to(self.device)

        self._pop = put(pop)
        self._base = put((1.0 - catalog.alpha) * pop)
        self._succ = put(catalog.succ, np.int64)
        self._contrib = put(catalog.alpha * catalog.w)

    def _contexts(self, batch: dict):
        """Per masked position: the one-back and two-back tokens, the
        no-context and no-second-back flags, and (unless blind) the
        decoded regime."""
        pos = batch["masked_lm_positions"].long()
        ids = batch["input_word_ids"].long()
        i1 = (pos - 1 + self._offset).clamp(min=0)
        i2 = (pos - 2 + self._offset).clamp(min=0)
        prev1 = torch.gather(ids, 1, i1)                  # [B, P]
        prev2 = torch.gather(ids, 1, i2)
        no_ctx = pos + self._offset <= 0
        no_second = pos - 2 + self._offset < 0
        prev1 = torch.where(no_ctx, torch.ones_like(prev1), prev1)
        if self._blind:
            regime = None
        else:
            # int32 as the encoder's bucket law and JAX read the stamps:
            # differences of seconds are exact under 2^31 s
            ts = batch["input_timestamps"].to(torch.int32)
            cur_idx = (pos + self._offset).clamp(min=0)
            gap = torch.gather(ts, 1, cur_idx) - torch.gather(ts, 1, i1)
            regime = (gap.float() > self._threshold).to(torch.int32)
        return prev1, prev2, no_ctx, no_second, regime

    def _matched_mass(self, ctx_tok, cand, ci):
        """[B, P, C] mixture mass of ``cand`` given the context tokens
        ``ctx_tok`` [B, P]; the popularity marginal where the context is a
        special token."""
        s = self._s
        ctx_is_item = ctx_tok >= s
        ctx_item = (ctx_tok - s).clamp(0, self._pop.shape[0] - 1)
        succ_tok = self._succ[ctx_item] + s               # [B, P, K]
        contrib = self._contrib[ctx_item]                 # [B, P, K]
        match = cand[..., :, None] == succ_tok[..., None, :]  # [B,P,C,K]
        extra = torch.where(match, contrib[..., None, :],
                            torch.zeros_like(contrib[..., None, :])).sum(-1)
        p = self._base[ci] + extra
        return torch.where(ctx_is_item[..., None], p, self._pop[ci])

    def score_candidates(self, params, batch: dict,
                         candidates: torch.Tensor,
                         mesh=None) -> torch.Tensor:
        prev1, prev2, no_ctx, no_second, regime = self._contexts(batch)
        cand = candidates.long()                          # [B, P, C]
        in_range = (cand >= 0) & (cand < self._vocab)
        is_item = cand >= self._s
        ci = (cand - self._s).clamp(0, self._pop.shape[0] - 1)
        p1 = self._matched_mass(prev1, cand, ci)          # [B, P, C]
        p2 = self._matched_mass(prev2, cand, ci)
        if self._blind:
            # the regime marginal; positions without a second-back context
            # are "fast" by construction (visible without timestamps)
            p = torch.where(no_second[..., None], p1, 0.5 * (p1 + p2))
        else:
            use2 = (regime == 1) & ~no_second
            p = torch.where(use2[..., None], p2, p1)
        p = torch.where(no_ctx[..., None], self._pop[ci], p)
        sc = torch.log(p.clamp(min=1e-30))
        return torch.where(in_range & is_item, sc,
                           torch.full_like(sc, NEG_INF))


def host_full_ranking_temporal_oracle(catalog, test_ds, *,
                                      time_blind: bool = False,
                                      batch_size: int = 256):
    """Full-catalog (unsampled) ground-truth ranks and metrics of the
    temporal (or time-blind) Bayes ceiling in host numpy: the paired
    ceilings of ``BERT4RecEvaluator(full_ranking=True)`` on the temporal
    family. The law of :class:`TemporalOracleScorer` (offset 0) and the
    rank law of :func:`markov_oracle.host_ranks_from_rows`; callers check
    :func:`markov_oracle.fits_host_dense` first.

    :returns: ``(metrics dict, ranks np.ndarray)``
    """
    from bert4rec_tpu_torch.evaluation.bert4rec_evaluator import (
        default_metrics,
    )

    s, v = catalog.n_specials, catalog.vocab_size
    threshold = catalog.regime_threshold_s
    # token-space dense law in probability space (the blind mixture is
    # taken there), float32 throughout
    probs = np.zeros((v, v), np.float32)
    base = (catalog.pop * (1.0 - catalog.alpha)).astype(np.float32)
    probs[s:, s:] = base[None, :]
    np.add.at(probs[s:, s:],
              (np.repeat(np.arange(catalog.n_items), catalog.branching),
               catalog.succ.ravel()),
              (catalog.alpha * catalog.w).ravel().astype(np.float32))
    probs[:s, s:] = catalog.pop.astype(np.float32)[None, :]

    metrics = default_metrics()
    all_ranks = []
    for batch, labels, gt_ids, pos, ids, valid in \
            markov_oracle.host_batches(test_ds, batch_size):
        # numpy twin of TemporalOracleScorer._contexts (offset 0)
        i1 = np.maximum(pos - 1, 0)
        i2 = np.maximum(pos - 2, 0)
        prev1 = np.take_along_axis(ids, i1, axis=1)
        prev2 = np.take_along_axis(ids, i2, axis=1)
        no_ctx = pos <= 0
        no_second = pos - 2 < 0
        prev1 = np.where(no_ctx, 1, prev1)

        p1 = probs[prev1]                                 # [B, P, V]
        if time_blind:
            p2 = probs[prev2]
            p = np.where(no_second[..., None], p1, 0.5 * (p1 + p2))
        else:
            ts = np.asarray(batch["input_timestamps"]).astype(np.int64)
            gap = (np.take_along_axis(ts, np.maximum(pos, 0), axis=1)
                   - np.take_along_axis(ts, i1, axis=1))
            use2 = (gap.astype(np.float64) > threshold) & ~no_second
            p = probs[np.where(use2, prev2, prev1)]
        rows = np.log(np.maximum(p, 1e-30))
        rows[:, :, :s] = NEG_INF                          # specials never score
        r = markov_oracle.host_ranks_from_rows(rows, gt_ids, labels, valid,
                                               v)
        all_ranks.append(r)
        for m in metrics:
            m.update_batch(r)
    return ({m.name: m.result() for m in metrics},
            np.concatenate(all_ranks) if all_ranks else np.empty(0))
