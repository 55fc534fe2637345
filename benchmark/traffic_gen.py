"""Synthetic interaction logs from a traffic file's laws (frozen here; the
program never sees these functions, only their output).

A corpus is ``users`` histories. History lengths are ``min_len`` plus a
lognormal draw whose median and mean make the corpus's ``median_len`` and
``mean_len``, capped at ``max_len``. The lengths come from a fixed stream
(``LENGTH_SEED``), so every ``--seed`` trains on the same multiset of
lengths; the run's seed only permutes them over the users and draws the
items. Item popularity is a rank-frequency curve through the traffic
file's ``popularity`` knots (``[rank, ratings]``, 1-based ranks, straight
lines between them on log-log axes) over ``items`` ids; item ``i``
(0-based by popularity) is token ``first_token + perm[i]`` with a seeded
permutation, so popular items are spread over the table.
"""

import numpy as np
import torch

LENGTH_SEED = 20240601


def history_lengths(traffic: dict, seed) -> np.ndarray:
    """``[users]`` int64 lengths: the fixed multiset, in the seed's order
    (``seed`` None: in the fixed order)."""
    users = int(traffic["users"])
    low, mean = int(traffic["min_len"]), float(traffic["mean_len"])
    mu = np.log(float(traffic["median_len"]) - low)
    sigma = np.sqrt(2.0 * (np.log(mean - low) - mu))
    fixed = np.random.default_rng(LENGTH_SEED)
    lengths = low + np.rint(fixed.lognormal(mu, sigma, users)).astype(np.int64)
    lengths = np.minimum(lengths, int(traffic["max_len"]))
    if seed is None:
        return lengths
    return np.random.default_rng([seed, 1]).permutation(lengths)


def popularity(n_items: int, knots) -> np.ndarray:
    """``[n_items]`` float64 shares by rank: the knots' curve, normalised."""
    ranks = np.log(np.arange(1, n_items + 1, dtype=np.float64))
    at = np.log(np.asarray(knots, dtype=np.float64))
    counts = np.exp(np.interp(ranks, at[:, 0], at[:, 1]))
    return counts / counts.sum()


def draw_items(traffic: dict, n: int, seed: int, device) -> np.ndarray:
    """``[n]`` int32 token ids under the popularity curve, drawn on
    ``device`` in one call from a generator seeded with ``seed``."""
    n_items = int(traffic["items"])
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    u = torch.rand(n, generator=gen, device=device)
    cdf = np.cumsum(popularity(n_items, traffic["popularity"]))
    rank = torch.searchsorted(torch.from_numpy(cdf / cdf[-1]).to(
        device, torch.float32), u).clamp_(max=n_items - 1)
    perm = torch.randperm(n_items, generator=gen, device=device)
    return (perm[rank] + int(traffic["first_token"])).to(
        torch.int32).cpu().numpy()


def corpus(traffic: dict, seed: int, device) -> list:
    """The users' histories: a list of int32 arrays of token ids."""
    lengths = history_lengths(traffic, seed)
    flat = draw_items(traffic, int(lengths.sum()), seed, device)
    return np.split(flat, np.cumsum(lengths)[:-1])
