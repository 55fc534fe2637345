"""A quality benchmark that cannot saturate: planted Markov structure with
a computable Bayes-optimal oracle (port of
``bert4rec_tpu/evaluation/markov_oracle.py``).

The planted law is stochastic:

    P(next = j | current = i) = alpha * T[i, j] + (1 - alpha) * pop[j]

where each item ``i`` has ``branching`` random successors with Dirichlet
weights (the rows of ``T``) and ``pop`` is a Zipf popularity tail. Under
the leave-one-out protocol (mask the last item) the Bayes-optimal score
is exactly ``log P(candidate | previous item)``: in first-order Markov data
no other context informs the last position. The oracle's HR@10 / NDCG@10
under the same 101-candidate protocol are the ceiling a correct model
approaches from below, and with alpha < 1 the ceiling lies well inside
(0, 1).

The oracle runs through :class:`BERT4RecEvaluator` itself (the same
sampler law, seed and rank law), so model against oracle is a paired
comparison. Deliberately broken variants show the benchmark detects
faults:

- ``context_offset=-1`` scores from the token two back (a leave-one-out
  or position misalignment): the metrics fall toward the popularity floor;
- a uniform ("random") sampler instead of "pop_random": the sampled
  metrics rise (uniform negatives are easier to beat).

The catalogs are numpy and draw the JAX package's sequences bit for bit;
the scorers hold their law as tensors on an explicit ``device``.
"""

from typing import Optional, Sequence

import numpy as np
import torch

from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.evaluation.baselines import full_rank_competitors

NEG_INF = float(np.finfo(np.float32).min)

# catalogs wider than this draw their successor supports vectorized: the
# per-row ``rng.choice(..., replace=False, p=pop)`` renormalises the whole
# probability vector per row, O(V^2) overall (minutes at ML-20M width,
# hours at the Reddit catalog's 335k items)
FAST_SUPPORT_THRESHOLD = 50_000


def sample_popularity_supports(rng, pop: np.ndarray, n_rows: int,
                               branching: int) -> np.ndarray:
    """``[n_rows, branching]`` popularity-weighted distinct successor
    supports, vectorized: inverse-CDF draws (``searchsorted`` over the
    popularity CDF), and rows that drew a duplicate drawn again whole.
    Another RNG stream and a slightly different without-replacement law
    than the per-row path; the scorers compute the exact law from the
    drawn supports either way. Used only above FAST_SUPPORT_THRESHOLD."""
    cdf = np.cumsum(pop)
    cdf[-1] = 1.0  # guard the float edge
    n_items = len(pop)
    succ = np.minimum(
        np.searchsorted(cdf, rng.random((n_rows, branching))), n_items - 1)
    for _ in range(256):
        srt = np.sort(succ, axis=1)
        bad = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        n_bad = int(bad.sum())
        if not n_bad:
            return succ.astype(np.int64)
        succ[bad] = np.minimum(
            np.searchsorted(cdf, rng.random((n_bad, branching))),
            n_items - 1)
    raise RuntimeError(
        "support resampling failed to produce distinct rows — the "
        "popularity law is too concentrated for distinct "
        f"{branching}-item supports over {n_items} items")


def popularity_and_supports(rng, n_items: int, branching: int,
                            zipf_s: float, dirichlet: float) -> tuple:
    """``(pop, succ, w)`` of a planted world, drawn from ``rng`` in the
    JAX package's order: the Zipf popularity over a random permutation,
    ``branching`` popularity-drawn distinct successors per item, and
    their Dirichlet weights. Supports are drawn by popularity so that the
    successors of observed items are observed often enough to learn, and
    the sampler's popularity negatives stay competitive."""
    ranks = rng.permutation(n_items).astype(np.float64) + 1.0
    pop = ranks ** -float(zipf_s)
    pop = pop / pop.sum()
    if n_items > FAST_SUPPORT_THRESHOLD:
        succ = sample_popularity_supports(rng, pop, n_items, branching)
    else:
        succ = np.stack([
            rng.choice(n_items, size=branching, replace=False, p=pop)
            for _ in range(n_items)]).astype(np.int64)
    w = rng.dirichlet(np.full(branching, float(dirichlet)), size=n_items)
    return pop, succ, w


def mixture_matrix(pop: np.ndarray, succ: np.ndarray, w: np.ndarray,
                   alpha: float) -> np.ndarray:
    """Dense ``[n_items, n_items]`` mixture law
    ``alpha * T[i, j] + (1 - alpha) * pop[j]`` in item space."""
    n_items, branching = succ.shape
    m = np.tile(pop * (1.0 - alpha), (n_items, 1))
    np.add.at(m, (np.repeat(np.arange(n_items), branching), succ.ravel()),
              alpha * w.ravel())
    return m


class MarkovCatalog:
    """The planted generative process and its exact conditional law.

    :param n_items: catalog size (token ids ``n_specials ..
        n_specials+n_items-1``).
    :param branching: successors per item (the support of a ``T`` row).
    :param alpha: weight of the transition component; the ceiling rises
        with it.
    :param zipf_s: popularity exponent, ``pop ~ rank^-s`` over a random
        permutation (id order carries no signal).
    :param dirichlet: concentration of the successor weights.
    """

    def __init__(self, n_items: int, branching: int = 8,
                 alpha: float = 0.6, zipf_s: float = 1.1,
                 dirichlet: float = 1.0, seed: int = 0,
                 n_specials: int = 3):
        rng = np.random.default_rng(seed)
        self.n_items = int(n_items)
        self.n_specials = int(n_specials)
        self.vocab_size = self.n_items + self.n_specials
        self.branching = int(branching)
        self.alpha = float(alpha)
        self.pop, self.succ, self.w = popularity_and_supports(
            rng, self.n_items, self.branching, zipf_s, dirichlet)

    # ------------------------------------------------------------------ #
    # the exact law
    # ------------------------------------------------------------------ #

    def next_prob(self) -> np.ndarray:
        """Dense ``[n_items, n_items]`` ``P(next | current)`` in item
        space."""
        return mixture_matrix(self.pop, self.succ, self.w, self.alpha)

    def log_next_prob_matrix(self) -> np.ndarray:
        """``[V, V]`` log-conditional in token space. Rows of special
        tokens (no usable previous item) are the popularity marginal, the
        Bayes predictor without context; special-token columns score
        ``NEG_INF``."""
        v, s = self.vocab_size, self.n_specials
        out = np.full((v, v), NEG_INF, dtype=np.float32)
        items = np.log(np.maximum(self.next_prob(), 1e-30))
        out[s:, s:] = items
        out[:s, s:] = np.log(np.maximum(self.pop, 1e-30))[None, :]
        return out

    # ------------------------------------------------------------------ #
    # sampling
    # ------------------------------------------------------------------ #

    def sample_sequences(self, n: int, min_len: int, max_len: int,
                         seed: int = 0):
        """``n`` token-id sequences of the process, lengths uniform in
        ``[min_len, max_len]``; one mixture draw per (sequence, step)."""
        rng = np.random.default_rng(seed)
        lens = rng.integers(min_len, max_len + 1, size=n)
        steps = int(lens.max())
        cur = rng.choice(self.n_items, size=n, p=self.pop)
        rows = np.empty((n, steps), dtype=np.int64)
        rows[:, 0] = cur
        cum_w = np.cumsum(self.w, axis=1)                 # [n_items, B]
        for t in range(1, steps):
            use_trans = rng.random(n) < self.alpha
            # transition component: inverse CDF over the current rows
            r = rng.random(n)
            k = (r[:, None] > cum_w[cur]).sum(axis=1)
            nxt_trans = self.succ[cur, np.minimum(k, self.branching - 1)]
            nxt_pop = rng.choice(self.n_items, size=n, p=self.pop)
            cur = np.where(use_trans, nxt_trans, nxt_pop)
            rows[:, t] = cur
        return [(rows[i, :lens[i]] + self.n_specials).astype(np.int32)
                for i in range(n)]


class MarkovOracleScorer:
    """Bayes-optimal scorer of :class:`MarkovCatalog` data, with the model
    interface the evaluator reads (as
    :class:`~bert4rec_tpu_torch.evaluation.baselines.PopularityScorer`).

    ``context_offset=0`` is the correct oracle (it conditions on the token
    just before each masked position); ``-1`` is the deliberately broken
    off-by-one variant (the token two back); ``1`` is the next-item
    protocol's oracle, where the predicted position holds its context.
    """

    # widest vocab whose dense [V, V] law gt_ranks_full_vocab may build
    # (8k fp32 ~= 256 MiB); ml20m (26.7k ~= 2.9 GiB) and up use the sparse
    # score_candidates path
    DENSE_VOCAB_LIMIT = 8192

    def __init__(self, catalog: MarkovCatalog, context_offset: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self._cat = catalog
        self._offset = int(context_offset)
        s = catalog.n_specials
        self._s = s
        self._vocab = catalog.vocab_size
        # the sparse law, O(V * branching) at any catalog width:
        # (1-alpha)*pop[next] everywhere, alpha*w_k + (1-alpha)*pop on the
        # current item's successors
        pop = catalog.pop
        mix = catalog.alpha * catalog.w \
            + (1.0 - catalog.alpha) * pop[catalog.succ]

        def put(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(
                a.astype(dtype))).to(self.device)

        self._log_pop = put(np.log(np.maximum(pop, 1e-30)))
        self._log_nonsucc = put(
            np.log(np.maximum((1.0 - catalog.alpha) * pop, 1e-30)))
        self._succ = put(catalog.succ, np.int64)
        self._log_succ = put(np.log(np.maximum(mix, 1e-30)))
        self._dense = None  # built on first use by gt_ranks_full_vocab

    def _prev_tokens(self, batch: dict) -> torch.Tensor:
        pos = batch["masked_lm_positions"].long()
        prev_idx = (pos - 1 + self._offset).clamp(min=0)
        prev = torch.gather(batch["input_word_ids"].long(), 1, prev_idx)
        # a masked position at index 0 reads its own [MASK]; the special
        # rows of the law are the popularity fallback, the Bayes predictor
        # without context
        return torch.where(pos + self._offset <= 0,
                           torch.ones_like(prev), prev)

    # ------------------------------------------------------------------ #
    # the model interface the evaluator reads
    # ------------------------------------------------------------------ #

    def score_candidates(self, params, batch: dict,
                         candidates: torch.Tensor,
                         mesh=None) -> torch.Tensor:
        prev = self._prev_tokens(batch)                   # [B, P]
        cand = candidates.long()                          # [B, P, C]
        s = self._s
        in_range = (cand >= 0) & (cand < self._vocab)
        is_item = cand >= s
        ci = (cand - s).clamp(0, self._log_pop.shape[0] - 1)
        prev_is_item = prev >= s
        prev_item = (prev - s).clamp(0, self._succ.shape[0] - 1)
        base = torch.where(prev_is_item[..., None],
                           self._log_nonsucc[ci], self._log_pop[ci])
        succ_tok = self._succ[prev_item] + s              # [B, P, K]
        succ_val = self._log_succ[prev_item]              # [B, P, K]
        match = cand[..., :, None] == succ_tok[..., None, :]  # [B,P,C,K]
        matched = torch.where(match, succ_val[..., None, :],
                              torch.full_like(succ_val[..., None, :],
                                              NEG_INF)).amax(-1)
        sc = torch.where(prev_is_item[..., None] & match.any(-1),
                         matched, base)
        return torch.where(in_range & is_item, sc,
                           torch.full_like(sc, NEG_INF))

    def gt_ranks_full_vocab(self, params, inputs: dict, *,
                            exclude: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """Full-catalog 1-based ground-truth ranks under the oracle order,
        the rank law of ``BERT4RecModel.gt_ranks_full_vocab``. Builds dense
        [B, P, V] rows from a dense [V, V] law kept on the device: small
        catalogs only, guarded by ``DENSE_VOCAB_LIMIT``."""
        if self._vocab > self.DENSE_VOCAB_LIMIT:
            raise ValueError(
                f"gt_ranks_full_vocab materializes a dense [V, V] matrix; "
                f"vocab_size={self._vocab} > {self.DENSE_VOCAB_LIMIT} "
                f"would pin ~{4 * self._vocab**2 / 2**30:.1f} GiB on "
                f"device. Use score_candidates (sparse) at this scale, "
                f"or raise DENSE_VOCAB_LIMIT explicitly.")
        if self._dense is None:
            self._dense = torch.from_numpy(
                self._cat.log_next_prob_matrix()).to(self.device)
        logits = self._dense[self._prev_tokens(inputs)]    # [B, P, V]
        return full_rank_competitors(logits, inputs["masked_lm_ids"].long(),
                                     exclude, NEG_INF)


def host_ranks_from_rows(rows: np.ndarray, gt_ids: np.ndarray,
                         labels: np.ndarray, valid: np.ndarray,
                         vocab_size: int) -> np.ndarray:
    """The host rank law of the full-ranking Bayes ceilings: given score
    rows ``[B, P, V]``, apply the evaluator's exclusion set (the row's
    labels and ground truths), never let the ground truth count itself,
    count ties ahead of it, and return the valid ranks."""
    b, p = gt_ids.shape
    gt = np.take_along_axis(rows, gt_ids[..., None], axis=-1)
    excl = np.zeros((b, vocab_size), bool)
    np.put_along_axis(excl, np.where(labels > 0, labels, 0),
                      labels > 0, axis=1)
    np.put_along_axis(excl, np.where(valid, gt_ids, 0), valid, axis=1)
    rows = np.where(excl[:, None, :], NEG_INF, rows)
    np.put_along_axis(rows, gt_ids[..., None], NEG_INF, axis=-1)
    ranks = (rows >= gt).sum(axis=-1) + 1                 # [B, P]
    return ranks[valid]


def host_batches(test_ds, batch_size: int):
    """``(batch, labels, gt_ids, positions, ids, valid)`` of each host
    batch of ``test_ds`` in order, as numpy."""
    for batch in test_ds.batches(batch_size, shuffle=False, seed=0):
        yield (batch, np.asarray(batch["labels"]),
               np.asarray(batch["masked_lm_ids"]).astype(np.int64),
               np.asarray(batch["masked_lm_positions"]).astype(np.int64),
               np.asarray(batch["input_word_ids"]),
               np.asarray(batch["masked_lm_weights"]) > 0)


def host_full_ranking_oracle(catalog, test_ds, *, context_offset: int = 0,
                             batch_size: int = 256):
    """Full-catalog (unsampled) ground-truth ranks and metrics of the Bayes
    oracle, in host numpy: the paired ceiling of the evaluator's
    ``full_ranking=True`` protocol, with its rank law and exclusions. The
    dense law takes 4 V^2 bytes of host memory (2.9 GB at ML-20M width);
    callers check :func:`fits_host_dense` first.

    :returns: ``(metrics dict, ranks np.ndarray)``
    """
    from bert4rec_tpu_torch.evaluation.bert4rec_evaluator import (
        default_metrics,
    )

    logm = catalog.log_next_prob_matrix()                 # [V, V] fp32
    v = catalog.vocab_size
    metrics = default_metrics()
    all_ranks = []
    for _, labels, gt_ids, pos, ids, valid in host_batches(test_ds,
                                                           batch_size):
        # numpy twin of MarkovOracleScorer._prev_tokens
        prev_idx = np.maximum(pos - 1 + context_offset, 0)
        prev = np.take_along_axis(ids, prev_idx, axis=1)
        prev = np.where(pos + context_offset <= 0, 1, prev)
        r = host_ranks_from_rows(logm[prev], gt_ids, labels, valid, v)
        all_ranks.append(r)
        for m in metrics:
            m.update_batch(r)
    return ({m.name: m.result() for m in metrics},
            np.concatenate(all_ranks) if all_ranks else np.empty(0))


def fits_host_dense(catalog, budget_bytes: int = 16 * 2**30) -> bool:
    """True if the catalog's dense [V, V] fp32 law fits the host budget."""
    return 4 * catalog.vocab_size ** 2 <= budget_bytes


def evaluate_scorer(scorer, params, test_ds, *, source: Sequence[int],
                    sample_size: int = 100, seed: int = 0,
                    sampler: str = "pop_random",
                    batch_size: int = 256, mesh=None) -> dict:
    """Run a model or scorer through the standard evaluator with a pinned
    sampler: model against oracle as a paired comparison (the same
    negatives law, seed and rank law). ``sampler='random'`` is the broken
    shuffled-negatives variant. ``mesh`` scores over a device mesh
    (``test_ds`` this rank's 'data' slice, ``params`` its pieces)."""
    from bert4rec_tpu_torch import evaluation
    from bert4rec_tpu_torch.dataloaders import samplers

    s = samplers.get(sampler, source=list(source),
                     vocab=list(dict.fromkeys(source)),
                     sample_size=sample_size, seed=seed)
    evaluator = evaluation.BERT4RecEvaluator(sampler=s,
                                             sample_size=sample_size,
                                             seed=seed, mesh=mesh)
    return evaluator.evaluate(scorer, params, test_ds,
                              batch_size=batch_size, progress_bar=False)
