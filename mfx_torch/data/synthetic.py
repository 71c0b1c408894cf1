"""Synthetic rating generators (SURVEY.md C2, billion-scale path).

The environment has zero network egress, so benchmark-scale datasets
(MovieLens-25M shapes, Netflix-Prize 100M, billion-rating implicit) are
generated from a seeded ground-truth low-rank model. Ratings are
``clip(mu + p_u . q_i + noise)``, so held-out RMSE has a known noise floor
and convergence targets are meaningful.
"""

from __future__ import annotations

import numpy as np

from mfx_torch.data.coo import RatingsCOO

__all__ = [
    "make_synthetic",
    "make_implicit_synthetic",
    "ML100K_SHAPE",
    "ML1M_SHAPE",
    "ML25M_SHAPE",
    "NETFLIX_SHAPE",
    "BILLION_SHAPE",
]

# (num_users, num_items, n_ratings) matching BASELINE.json's config ladder.
ML100K_SHAPE = (943, 1682, 100_000)
ML1M_SHAPE = (6040, 3706, 1_000_209)
ML25M_SHAPE = (162_541, 59_047, 25_000_095)
NETFLIX_SHAPE = (480_189, 17_770, 100_480_507)
BILLION_SHAPE = (10_000_000, 1_000_000, 1_000_000_000)


def make_synthetic(
    num_users: int,
    num_items: int,
    n_ratings: int,
    rank: int = 16,
    noise: float = 0.35,
    mean: float = 3.5,
    clip: tuple[float, float] = (0.5, 5.0),
    seed: int = 0,
    chunk: int = 8_000_000,
    star_step: float | None = None,
    user_zipf_s: float = 0.0,
) -> RatingsCOO:
    """Seeded explicit-feedback synthetic dataset from a true low-rank model.

    Generated in chunks so 100M+ rating datasets stay within host memory;
    (user, item) pairs are sampled iid (duplicates possible, harmless for
    SGD benchmarking). Popularity is Zipf-tilted on items to mimic the
    long-tail degree distribution of MovieLens/Netflix data.

    ``star_step`` rounds ratings to that granularity, matching real rating
    scales exactly (MovieLens-25M: half-stars 0.5; ML-100K/1M and Netflix:
    whole stars 1.0) — this raises the achievable RMSE floor by the
    rounding variance (~step²/12) and makes the int4 dense-rating stream
    (mfx/kernels/dense_pallas.py) lossless, as it is on the real data.
    None keeps the legacy continuous ratings (small test datasets).

    ``user_zipf_s`` tilts USER activity by a Zipf law of that exponent
    (0 keeps the legacy iid-uniform users). Real rating data is
    heavy-tailed on both axes — in MovieLens-25M the most active users
    contribute thousands of ratings while the median user has ~70; at
    s=0.6 the top 1% of users carry ~16% of ratings, matching that
    shape. Like items, users are popularity-sorted by construction
    (user 0 = most active), mirroring the loader's activity relabel of
    raw data (mfx/data/loaders.py _densify).
    """
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(rank)
    true_p = rng.normal(0.0, scale, size=(num_users, rank)).astype(np.float32)
    true_q = rng.normal(0.0, scale, size=(num_items, rank)).astype(np.float32)
    # Zipf item popularity (s=0.85), matching the skew of real rating data:
    # in MovieLens-25M the top ~512 movies carry ~35-40% of all ratings
    # (here: 38%) and the median movie has single-digit counts. Sampled via
    # the inverse-CDF of precomputed Zipf weights (exact, vectorized).
    zipf_s = 0.85
    w = 1.0 / np.power(np.arange(1, num_items + 1, dtype=np.float64), zipf_s)
    item_cdf = np.cumsum(w)
    item_cdf /= item_cdf[-1]
    user_cdf = None
    if user_zipf_s > 0.0:
        wu = 1.0 / np.power(
            np.arange(1, num_users + 1, dtype=np.float64), user_zipf_s
        )
        user_cdf = np.cumsum(wu)
        user_cdf /= user_cdf[-1]
    users = np.empty(n_ratings, np.int32)
    items = np.empty(n_ratings, np.int32)
    ratings = np.empty(n_ratings, np.float32)
    lo, hi = clip
    for start in range(0, n_ratings, chunk):
        stop = min(start + chunk, n_ratings)
        m = stop - start
        if user_cdf is None:
            u = rng.integers(0, num_users, size=m, dtype=np.int32)
        else:
            u = np.searchsorted(
                user_cdf, rng.random(m), side="right"
            ).astype(np.int32)
            u = np.minimum(u, num_users - 1)
        i = np.searchsorted(
            item_cdf, rng.random(m), side="right"
        ).astype(np.int32)
        i = np.minimum(i, num_items - 1)
        r = mean + np.einsum("bk,bk->b", true_p[u], true_q[i])
        r += rng.normal(0.0, noise, size=m).astype(np.float32)
        if star_step is not None:
            r = np.round(r / star_step) * star_step
        users[start:stop] = u
        items[start:stop] = i
        ratings[start:stop] = np.clip(r, lo, hi, dtype=np.float32, casting="unsafe")
    return RatingsCOO(users, items, ratings, num_users, num_items,
                      synthetic=True)


def make_implicit_synthetic(
    num_users: int,
    num_items: int,
    n_ratings: int,
    rank: int = 16,
    seed: int = 0,
    chunk: int = 8_000_000,
) -> RatingsCOO:
    """Implicit-feedback positives (rating==1.0) for BPR training.

    Positive (u, i) pairs are sampled with probability tilted by a true
    low-rank affinity, so learned rankings are recoverable.
    """
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(rank)
    true_p = rng.normal(0.0, scale, size=(num_users, rank)).astype(np.float32)
    true_q = rng.normal(0.0, scale, size=(num_items, rank)).astype(np.float32)
    users = np.empty(n_ratings, np.int32)
    items = np.empty(n_ratings, np.int32)
    for start in range(0, n_ratings, chunk):
        stop = min(start + chunk, n_ratings)
        m = stop - start
        u = rng.integers(0, num_users, size=m, dtype=np.int32)
        # two candidate items per positive; keep the higher-affinity one
        c0 = rng.integers(0, num_items, size=m, dtype=np.int32)
        c1 = rng.integers(0, num_items, size=m, dtype=np.int32)
        s0 = np.einsum("bk,bk->b", true_p[u], true_q[c0])
        s1 = np.einsum("bk,bk->b", true_p[u], true_q[c1])
        users[start:stop] = u
        items[start:stop] = np.where(s0 >= s1, c0, c1)
    return RatingsCOO(
        users, items, np.ones(n_ratings, np.float32), num_users, num_items,
        synthetic=True,
    )
