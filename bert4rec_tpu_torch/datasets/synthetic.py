"""A seeded ML-20M-format corpus, for runs that have no download: the same
files, columns and headers as the real ``ml-20m`` directory, by the law of
the repo's synthetic corpus generator (``tools/synth_corpus.py``
``make_ml20m``)."""

import pathlib

import numpy as np
import pandas as pd


def write_ml20m_corpus(home, seed=0, n_users=20_000, n_movies=26_729):
    """Write ``ratings.csv`` and ``movies.csv`` under ``home/data/ml-20m``:
    ML-20M's golden 26,729-movie catalog, users who walk one fixed random
    permutation of it from random starts, history lengths lognormal(4.8,
    0.7) clipped to [20, 800]. Cut to ``n_users`` users, which keeps the
    vocabulary whole; no genome-file filler, so it is loaded under a record
    cap. Returns the number of ratings."""
    rng = np.random.default_rng(seed + 3)
    dest = pathlib.Path(home) / "data" / "ml-20m"
    dest.mkdir(parents=True, exist_ok=True)
    ids = np.arange(1, n_movies + 1)
    pd.DataFrame({
        "movieId": ids,
        "title": [f"Synthetic Feature No. {i:05d} ({1920 + i % 100})"
                  for i in ids],
        "genres": ["Drama|Comedy" if i % 2 else "Action" for i in ids],
    }).to_csv(dest / "movies.csv", index=False)
    perm = rng.permutation(n_movies) + 1
    lengths = np.clip(rng.lognormal(4.8, 0.7, n_users), 20, 800).astype(int)
    uid = np.repeat(np.arange(1, n_users + 1), lengths)
    starts = rng.integers(0, n_movies, n_users)
    offsets = np.concatenate([np.arange(n) for n in lengths])
    sid = perm[(np.repeat(starts, lengths) + offsets) % n_movies]
    t0 = np.repeat(rng.integers(9.6e8, 1.0e9, n_users), lengths)
    pd.DataFrame({
        "userId": uid, "movieId": sid,
        "rating": ((sid + offsets) % 9 + 2) / 2.0,
        "timestamp": t0 + offsets * 60,
    }).to_csv(dest / "ratings.csv", index=False)
    return int(lengths.sum())
