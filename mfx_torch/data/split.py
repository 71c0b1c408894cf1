"""Train/test splitting and epoch shuffling (SURVEY.md C3).

Seeded and reproducible: ``train_test_split`` and ``epoch_permutation``
depend only on (seed, n) — a precondition for the bitwise-determinism
guarantees in BASELINE.json's north star. ``leave_one_out_split`` is
seeded per (seed, coo): its draws are positional over the COO's per-user
runs, so the same seed on the same COO always reproduces the split, but
a row-reordered COO does not.
"""

from __future__ import annotations

import numpy as np

from mfx_torch.data.coo import RatingsCOO

__all__ = [
    "train_test_split",
    "chronological_split",
    "user_chronological_split",
    "leave_one_out_split",
    "epoch_permutation",
]


def train_test_split(
    coo: RatingsCOO, test_frac: float = 0.1, seed: int = 0
) -> tuple[RatingsCOO, RatingsCOO]:
    """Uniform held-out split. Returns (train, test)."""
    if not 0.0 <= test_frac < 1.0:
        raise ValueError(f"test_frac must be in [0, 1), got {test_frac}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5B117]))
    n = coo.n_ratings
    n_test = int(round(n * test_frac))
    perm = rng.permutation(n)
    test_idx = perm[:n_test]
    train_idx = perm[n_test:]
    return coo.select(train_idx), coo.select(test_idx)


def chronological_split(
    coo: RatingsCOO, test_frac: float = 0.1
) -> tuple[RatingsCOO, RatingsCOO]:
    """Global time cut: train on the past, test on the future — the
    leakage-free evaluation protocol for production serving (a random
    split lets the model peek at events that happen AFTER the ones it
    is scored on). Requires ``coo.timestamp`` (kept by the loaders when
    the source data carries a time column). Deterministic: the cut
    orders by (timestamp, original row position), so ties never make
    the split ambiguous. Returns (train, test)."""
    if coo.timestamp is None:
        raise ValueError(
            "chronological_split needs coo.timestamp; this dataset was "
            "loaded without a time column (use train_test_split, or "
            "reload from source files that include timestamps)"
        )
    if not 0.0 <= test_frac < 1.0:
        raise ValueError(f"test_frac must be in [0, 1), got {test_frac}")
    n = coo.n_ratings
    n_test = int(round(n * test_frac))
    order = np.argsort(coo.timestamp, kind="stable")
    train_idx = np.sort(order[: n - n_test])
    test_idx = np.sort(order[n - n_test:])
    return coo.select(train_idx), coo.select(test_idx)


def user_chronological_split(
    coo: RatingsCOO, test_frac: float = 0.1
) -> tuple[RatingsCOO, RatingsCOO]:
    """Per-user timeline cut: each user's LAST ``floor(test_frac * n_u)``
    events are held out — the user-level leakage-free protocol (a global
    cut under-represents early-adopter users in test; this one scores
    every active user on their own future). Users whose holdout count
    rounds to zero (fewer than ``1/test_frac`` events) stay entirely in
    train. Deterministic: within a user, events order by (timestamp,
    original row position). Requires ``coo.timestamp``.
    Returns (train, test)."""
    if coo.timestamp is None:
        raise ValueError(
            "user_chronological_split needs coo.timestamp; this dataset "
            "was loaded without a time column"
        )
    if not 0.0 <= test_frac < 1.0:
        raise ValueError(f"test_frac must be in [0, 1), got {test_frac}")
    n = coo.n_ratings
    # stable sort by (user, timestamp): per-user segments in time order,
    # ties by original position
    order = np.lexsort((np.arange(n), coo.timestamp, coo.user))
    u_sorted = coo.user[order]
    starts = np.searchsorted(u_sorted, np.arange(coo.num_users + 1))
    counts = starts[1:] - starts[:-1]
    # floor(test_frac * n_u), with an epsilon so exact products are not
    # knocked below their floor by float error (0.35 * 180 = 62.9999...)
    n_test_u = np.floor(counts * test_frac + 1e-9).astype(np.int64)
    # a position p (within the sorted order) is TEST iff it lies in the
    # last n_test_u[u] slots of its user's segment
    pos = np.arange(n, dtype=np.int64)
    seg_end = np.repeat(starts[1:], counts)
    is_test = pos >= seg_end - np.repeat(n_test_u, counts)
    train_idx = np.sort(order[~is_test])
    test_idx = np.sort(order[is_test])
    return coo.select(train_idx), coo.select(test_idx)


def leave_one_out_split(
    coo: RatingsCOO, seed: int = 0, by: str = "random"
) -> tuple[RatingsCOO, RatingsCOO]:
    """Leave-one-out split: ONE held-out item per user — the canonical
    protocol for sampled ranking evaluation (NCF style; pairs with
    ``mfx.eval.ranking.hr_ndcg_at_k``, which ranks each held-out
    positive against sampled candidates).

    ``by='random'`` picks uniformly over each user's unique items
    (seeded, reproducible for a given (seed, coo)); ``by='time'`` holds
    out each user's LATEST unique item — the NCF paper's actual
    protocol — where a pair's recency is the max timestamp over its
    duplicate copies (requires ``coo.timestamp``; ties break toward the
    later pair in item-key order, deterministically, no RNG).

    Duplicate-safe: every duplicate copy of the held-out (user, item)
    pair is removed from train (raw COOs may repeat pairs — a surviving
    copy would train on the exact pair being ranked and inflate
    HR/NDCG). Users with fewer than two unique items stay entirely in
    train (holding their only item out would leave an untrainable row).
    Cost: one O(n log n) key sort (built once per run).
    Returns (train, test)."""
    if by not in ("random", "time"):
        raise ValueError(f"by must be 'random' or 'time', got {by!r}")
    if by == "time" and coo.timestamp is None:
        raise ValueError(
            "leave_one_out_split(by='time') needs coo.timestamp; this "
            "dataset was loaded without a time column"
        )
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x100]))
    n = coo.n_ratings
    num_items = coo.num_items
    keys = coo.user.astype(np.int64) * num_items + coo.item
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    first = np.ones(n, bool)
    first[1:] = ks[1:] != ks[:-1]
    # cf0[p] = number of unique keys among sorted positions [0, p)
    cf0 = np.concatenate(([0], np.cumsum(first)))
    # user run boundaries in the key-sorted order
    starts = np.searchsorted(
        ks, np.arange(coo.num_users + 1, dtype=np.int64) * num_items
    )
    u_uniq = cf0[starts[1:]] - cf0[starts[:-1]]
    active = np.flatnonzero(u_uniq >= 2)
    uniq_pos = np.flatnonzero(first)
    if by == "time":
        # a pair's recency = max timestamp over its duplicate copies
        # (copies are contiguous in key-sorted order)
        pair_ts = np.maximum.reduceat(coo.timestamp[order], uniq_pos)
        pair_user = ks[uniq_pos] // num_items
        # per-user argmax over pair recency: lexsort pairs by
        # (user, recency, pair rank); each user's segment in the sorted
        # order is [cf0[starts[u]], cf0[starts[u+1]]) and its LAST entry
        # is the latest pair
        ord2 = np.lexsort((np.arange(len(uniq_pos)), pair_ts, pair_user))
        pick_rank = ord2[cf0[starts[1:]][active] - 1]
    else:
        # uniform pick among each active user's unique items
        pick_rank = cf0[starts[:-1]][active] + rng.integers(0, u_uniq[active])
    p = uniq_pos[pick_rank]  # first copy of the picked pair
    run_end = np.searchsorted(ks, ks[p], side="right")
    # drop ALL copies of each picked pair from train; test keeps one
    lengths = run_end - p
    ramp = np.arange(int(lengths.sum())) - np.repeat(
        np.cumsum(lengths) - lengths, lengths
    )
    drop_pos = np.repeat(p, lengths) + ramp
    mask = np.ones(n, bool)
    mask[order[drop_pos]] = False
    test_idx = order[p]
    return coo.select(np.flatnonzero(mask)), coo.select(np.sort(test_idx))


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """Deterministic per-epoch permutation of rating order."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xE70C, epoch]))
    return rng.permutation(n).astype(np.int64)
