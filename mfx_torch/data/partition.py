"""Minibatch partitioning, the port's own copy of ``mfx/data/partition.py``
(``pad_to_batches``, ``partition_fixed``, ``partition_conflict_free``,
``validate_conflict_free``, ``PAD_ID``; the DSGD ``BlockedPartition``,
which nothing in the port calls, is left out).

- ``partition_fixed``: permutation → fixed-shape ``[num_batches, B]`` padded
  minibatches. Duplicate rows within a batch are allowed; the update
  applies a segment-summed scatter, so results are bitwise-deterministic.
- ``partition_conflict_free``: greedy matching-based rounds where no user
  row and no item row repeats within a batch, so rank-1 scatter updates
  are race-free by construction.

The reference plans conflict-free rounds with its native O(n) greedy
(``mfx/native/planner.cpp::mfx_conflict_free_rounds``) and falls back to a
NumPy multi-pass greedy that returns the same batches but is far slower
under skew (one pass a round). This copy runs the native rule as a plain
Python loop over ``tolist()`` arrays (no toolchain needed); the tests hold
its batches to both of the reference's.

All functions are seeded/pure: same inputs → same partition, a precondition
for bitwise-deterministic training.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pad_to_batches",
    "partition_fixed",
    "partition_conflict_free",
    "conflict_free_rounds",
    "validate_conflict_free",
    "PAD_ID",
]

# Legacy pad id (kept for callers that don't pass table sizes). Padded
# slots always carry weight 0, so their deltas are exactly zero; but id-0
# pads duplicate a *real* row id inside a batch. ``pad_to_batches``
# therefore emits *unique, out-of-range* pad ids (``num_rows + slot``)
# whenever table sizes are provided; the update path gathers with clamped
# ids and adds nothing for a pad, so every in-batch id is genuinely unique.
PAD_ID = 0


def pad_to_batches(
    user: np.ndarray,
    item: np.ndarray,
    rating: np.ndarray,
    order: np.ndarray | list[np.ndarray],
    batch_size: int,
    num_users: int | None = None,
    num_items: int | None = None,
    extras: dict[str, np.ndarray] | None = None,
) -> dict[str, np.ndarray]:
    """Materialize padded ``[num_batches, B]`` epoch tensors.

    ``order`` is either a flat index array (split into consecutive batches)
    or a list of per-batch index arrays (each of length <= batch_size).
    Returns dict with int32 ``users``/``items``, float32 ``ratings``/
    ``weights`` (1.0 real, 0.0 padding). When ``num_users``/``num_items``
    are given, padded slots carry unique out-of-range sentinel ids
    (``num_rows + slot``) instead of 0, keeping batches duplicate-free.
    ``extras`` adds further per-rating columns (same length as ``user``),
    batched in the same order with zero-valued padding and their dtype
    preserved.
    """
    if isinstance(order, np.ndarray):
        n = len(order)
        nb = max(1, -(-n // batch_size))
        batches = [order[b * batch_size : (b + 1) * batch_size] for b in range(nb)]
    else:
        batches = list(order)
        nb = len(batches)

    slot = np.arange(batch_size, dtype=np.int32)
    if num_users is not None:
        users = np.broadcast_to(np.int32(num_users) + slot, (nb, batch_size)).copy()
    else:
        users = np.full((nb, batch_size), PAD_ID, np.int32)
    if num_items is not None:
        items = np.broadcast_to(np.int32(num_items) + slot, (nb, batch_size)).copy()
    else:
        items = np.full((nb, batch_size), PAD_ID, np.int32)
    ratings = np.zeros((nb, batch_size), np.float32)
    weights = np.zeros((nb, batch_size), np.float32)
    out = {"users": users, "items": items, "ratings": ratings, "weights": weights}
    for name, col in (extras or {}).items():
        if name in out:
            raise ValueError(f"extras key {name!r} collides with a core column")
        if len(col) != len(user):
            raise ValueError(
                f"extras[{name!r}] has length {len(col)} != {len(user)} ratings"
            )
        out[name] = np.zeros((nb, batch_size), col.dtype)
    for b, idx in enumerate(batches):
        m = len(idx)
        if m > batch_size:
            raise ValueError(f"batch {b} has {m} > batch_size={batch_size} entries")
        users[b, :m] = user[idx]
        items[b, :m] = item[idx]
        ratings[b, :m] = rating[idx]
        weights[b, :m] = 1.0
        for name, col in (extras or {}).items():
            out[name][b, :m] = col[idx]
    return out


def partition_fixed(n: int, batch_size: int, perm: np.ndarray) -> np.ndarray:
    """Fixed-size batches in permutation order (flat order array)."""
    if len(perm) != n:
        raise ValueError("perm length mismatch")
    return perm


def conflict_free_rounds(
    user: np.ndarray, item: np.ndarray, perm: np.ndarray,
    num_users: int, num_items: int,
) -> tuple[np.ndarray, int]:
    """Greedy O(n) conflict-free round of each rating in ``perm`` order:
    a rating takes the later of its user's and its item's next free
    round, so no two ratings of a round share a user or an item (at most
    max-degree rounds). The rule of ``mfx_conflict_free_rounds``
    (``mfx/native/planner.cpp:142-164``); returns (rounds int32[n],
    num_rounds)."""
    next_u = [0] * int(num_users)
    next_i = [0] * int(num_items)
    perm = np.asarray(perm, np.int64)
    us = user[perm].tolist()
    its = item[perm].tolist()
    out = [0] * len(us)
    for k, (u, i) in enumerate(zip(us, its)):
        a, b = next_u[u], next_i[i]
        r = a if a > b else b
        out[k] = r
        next_u[u] = next_i[i] = r + 1
    rounds = np.asarray(out, np.int32)
    return rounds, int(rounds.max()) + 1 if len(out) else 0


def partition_conflict_free(
    user: np.ndarray,
    item: np.ndarray,
    batch_size: int,
    perm: np.ndarray,
    max_rounds: int | None = None,
    num_users: int | None = None,
    num_items: int | None = None,
) -> list[np.ndarray]:
    """Greedy conflict-free rounds: within each returned batch no user id
    and no item id repeats (a matching in the bipartite rating graph).

    Rounds come from :func:`conflict_free_rounds`; each round's ratings
    keep their permutation order and are split into ≤ batch_size chunks,
    which is conflict-free-safe (chunks of a matching are matchings).
    Seeded-deterministic, and the same batches as the reference's native
    planner and its NumPy fallback.
    """
    nu = int(num_users if num_users is not None else user.max() + 1)
    ni = int(num_items if num_items is not None else item.max() + 1)
    rounds, n_rounds = conflict_free_rounds(user, item, perm, nu, ni)
    if max_rounds is not None and n_rounds > max_rounds:
        raise RuntimeError(f"conflict-free partition exceeded {max_rounds} rounds")
    out: list[np.ndarray] = []
    order = np.argsort(rounds, kind="stable")
    bounds = np.searchsorted(rounds[order], np.arange(n_rounds + 1))
    for rr in range(n_rounds):
        members = perm[order[bounds[rr] : bounds[rr + 1]]]
        for s in range(0, len(members), batch_size):
            out.append(members[s : s + batch_size])
    return out


def validate_conflict_free(
    user: np.ndarray, item: np.ndarray, batches: list[np.ndarray]
) -> None:
    """Debug validator: asserts the no-duplicate-row property and coverage."""
    seen = 0
    for b, idx in enumerate(batches):
        if len(np.unique(user[idx])) != len(idx):
            raise AssertionError(f"batch {b}: duplicate user row")
        if len(np.unique(item[idx])) != len(idx):
            raise AssertionError(f"batch {b}: duplicate item row")
        seen += len(idx)
    total = sum(len(b) for b in batches)
    if seen != total:
        raise AssertionError("coverage mismatch")
