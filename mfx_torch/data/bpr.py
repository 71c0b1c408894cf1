"""BPR negative sampling, the counterpart of ``mfx/data/bpr.py``.

The host (numpy) part is the reference's, verbatim: the positive-key
index, exact rejection sampling and the epoch triples, so the port's
evaluation draws exactly the reference's negatives.

The device part is written in torch. The positive set is a pair of int32
arrays ``(pu, pi)`` sorted lexicographically, with duplicate pairs
replaced by ``INT32_MAX`` sentinels (sorted to the tail), as the
reference's. Searches over it use int64 composite keys
``(u << 32) + (i + 2**31)`` and ``torch.searchsorted``; the reference runs
fixed-depth 32-bit binary searches only because JAX runs in 32 bits, and
both find the same lower bound. Random numbers come from the caller: the
uniform draw ``x`` of :func:`complement_draw`, or an explicit
``torch.Generator``. The popularity-weighted device sampler
(:func:`sample_negatives_weighted_device`, the snapshot-minibatch trainers'
``bpr.neg_weighting='popularity'``) takes each round's two uniform draws
the same way and searches the reference's double-single CDF
(:func:`split_cdf_f32`) with int64 keys that order its (hi, lo) pairs as
the reference's lexicographic search does (:func:`upperbound_cdf2`).
"""

from __future__ import annotations

import numpy as np
import torch

from mfx_torch.data.coo import RatingsCOO

__all__ = [
    "build_positive_index",
    "build_positive_index_device",
    "complement_draw",
    "lowerbound_2key",
    "members_2key",
    "popularity_cdf",
    "split_cdf_f32",
    "upperbound_cdf2",
    "sample_negatives",
    "sample_negatives_device",
    "sample_negatives_weighted_device",
    "bpr_epoch_triples",
]

# Rejection rounds before giving up on a pending sample. Expected pending
# fraction after r rounds is density^r under the uniform proposal; real
# datasets (density < 5%) clear in 2-3 rounds. Under a popularity-weighted
# proposal the per-slot bound is the user's share of the sampling MASS
# raised to r — worst realistic case (a user holding half the mass) is
# 2^-32; bpr_epoch_triples additionally falls back to the positive
# (zero-gradient pair) for any slot still colliding.
MAX_REJECTION_ROUNDS = 32


def build_positive_index(coo: RatingsCOO) -> np.ndarray:
    """Sorted int64 keys ``u * num_items + i`` of all observed positives.
    Build once per training run and pass to :func:`sample_negatives` /
    :func:`bpr_epoch_triples`."""
    keys = coo.user.astype(np.int64) * coo.num_items + coo.item
    keys.sort()
    return keys


def popularity_cdf(
    item: np.ndarray, num_items: int, beta: float = 0.75
) -> np.ndarray:
    """Cumulative distribution over items with P(i) ∝ count(i)**beta —
    the standard popularity-weighted ("adaptive") negative-sampling
    measure (word2vec's beta=0.75 default): popular items make harder
    negatives, which sharpens top-of-ranking resolution. Items unseen in
    ``item`` have zero mass (they are never drawn as negatives). Build
    once per run; pass to :func:`sample_negatives` /
    :func:`bpr_epoch_triples` (host) or, as a device array, to
    :func:`sample_negatives_weighted_device`. float64 so the inverse-CDF
    searchsorted stays exact at billion-count scale."""
    counts = np.bincount(item, minlength=num_items).astype(np.float64)
    w = counts**beta
    tot = w.sum()
    if tot <= 0:
        raise ValueError("popularity_cdf needs at least one interaction")
    cdf = np.cumsum(w / tot)
    cdf[-1] = 1.0  # close the rounding gap so every u < 1 maps in-range
    return cdf


def _cdf_draw(rng: np.random.Generator, cdf: np.ndarray, size: int):
    """Inverse-CDF draw: item k with probability cdf[k] - cdf[k-1]."""
    return np.searchsorted(cdf, rng.random(size), side="right").astype(
        np.int32
    )


def _members(pos_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Boolean membership of each query key in the sorted key array."""
    idx = np.searchsorted(pos_keys, queries)
    idx_c = np.minimum(idx, len(pos_keys) - 1)
    return (idx < len(pos_keys)) & (pos_keys[idx_c] == queries)


def sample_negatives(
    n: int,
    num_items: int,
    seed: int,
    epoch: int,
    users: np.ndarray | None = None,
    pos_keys: np.ndarray | None = None,
    cdf: np.ndarray | None = None,
) -> np.ndarray:
    """Seeded negatives. With ``users`` + ``pos_keys`` the sampling is
    exact (rejection against each user's positive set); without them it is
    plain uniform (used only where positives are acceptable, e.g. sampled
    AUC's ranking noise floor). ``cdf`` (from :func:`popularity_cdf`)
    switches the proposal measure to popularity-weighted; rejection then
    samples the user-conditional renormalization of that measure."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xBB12, epoch]))

    def draw(size):
        if cdf is not None:
            return _cdf_draw(rng, cdf, size)
        return rng.integers(0, num_items, size=size, dtype=np.int32)

    neg = draw(n)
    if users is None or pos_keys is None:
        return neg
    ukeys = users.astype(np.int64) * num_items
    pending = np.flatnonzero(_members(pos_keys, ukeys + neg))
    rounds = 0
    while pending.size and rounds < MAX_REJECTION_ROUNDS:
        neg[pending] = draw(pending.size)
        pending = pending[_members(pos_keys, ukeys[pending] + neg[pending])]
        rounds += 1
    return neg


_INT32_MAX = 2**31 - 1


def _pair_key(u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """int64 key ordering (u, i) pairs of signed int32 lexicographically."""
    return (u.to(torch.int64) << 32) + (i.to(torch.int64) + 2**31)


def build_positive_index_device(u_dev, i_dev):
    """Device analog of :func:`build_positive_index`: the positive set as
    an int32 (users, items) pair sorted lexicographically on the ids'
    device. Duplicate pairs become ``INT32_MAX`` sentinels sorted to the
    tail, so the kept region is strictly increasing, which
    :func:`complement_draw` needs; membership queries are unaffected."""
    u = torch.as_tensor(u_dev).to(torch.int32)
    i = torch.as_tensor(i_dev).to(u.device, torch.int32)
    key = torch.sort(_pair_key(u, i)).values
    dup = torch.zeros_like(key, dtype=torch.bool)
    dup[1:] = key[1:] == key[:-1]
    sent = _pair_key(torch.tensor(_INT32_MAX), torch.tensor(_INT32_MAX))
    key = torch.sort(torch.where(dup, sent.to(key.device), key)).values
    pu = (key >> 32).to(torch.int32)
    pi = ((key & 0xFFFF_FFFF) - 2**31).to(torch.int32)
    return pu, pi


def lowerbound_2key(pu, pi, qu, qi):
    """First index whose (pu, pi) pair is >= each query pair (qu, qi)."""
    out = torch.searchsorted(_pair_key(pu, pi), _pair_key(qu, qi))
    return out.to(torch.int32)


def members_2key(pu, pi, qu, qi):
    """Membership of each query pair (qu, qi) in the sorted positive
    pairs."""
    lo = lowerbound_2key(pu, pi, qu, qi).long()
    n = pu.shape[0]
    if n == 0:
        return torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    safe = lo.clamp(max=n - 1)
    return (lo < n) & (pu[safe] == qu) & (pi[safe] == qi)


def uniform_below(n, generator: torch.Generator | None = None):
    """x ~ U[0, max(n, 1)) for each entry of the int tensor ``n``, as int32:
    a 62-bit draw reduced modulo n (bias below n / 2**62)."""
    n = n.to(torch.int64).clamp(min=1)
    r = torch.randint(0, 2**62, n.shape, generator=generator,
                      dtype=torch.int64, device=n.device)
    return (r % n).to(torch.int32)


def complement_draw(pi, start, cnt, navail, base, fallback, x=None,
                    generator: torch.Generator | None = None, steps=32):
    """EXACT uniform draw from the complement of a sorted positive slice,
    one draw per query slot, zero rejection.

    Per slot: ``pi[start : start + cnt)`` holds the slot's positives as
    strictly increasing ids inside [base, base + span), and
    ``navail = span - cnt`` is the complement size. With x ~ U[0, navail)
    (``x``, or ``x(navail)`` where it is a function, or drawn from
    ``generator``), the smallest m with
    ``pi[start + m] - base - m > x`` gives j = base + x + m, the x-th
    non-positive id. ``steps`` fixed binary-search steps, as the
    reference's, must be >= ceil(log2(max cnt + 1)). Slots with
    navail <= 0 return ``fallback``."""
    if x is None:
        x = uniform_below(navail, generator)
    elif callable(x):
        x = x(navail)
    x = x.to(navail.device, torch.int32)
    lo = torch.zeros_like(cnt)
    hi = cnt.clone()
    nmax = pi.shape[0] - 1
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) // 2  # < hi <= cnt keeps start + mid in-slice
        off = pi[(start + mid).clamp(max=nmax).long()] - base
        gt = off - mid > x
        hi = torch.where(active & gt, mid, hi)
        lo = torch.where(active & ~gt, mid + 1, lo)
    return torch.where(navail > 0, base + x + lo, fallback)


def sample_negatives_device(users, pu, pi, num_items: int, x=None,
                            generator: torch.Generator | None = None):
    """Device-side exact negatives over the whole catalog: one complement
    draw per slot. A user who rated the entire catalog gets one of their
    positives (a loss-neutral pair)."""
    zeros = torch.zeros_like(users)
    start = lowerbound_2key(pu, pi, users, zeros)
    end = lowerbound_2key(pu, pi, users, zeros + num_items)
    cnt = end - start
    nmax = pi.shape[0] - 1
    fallback = pi[start.clamp(max=nmax).long()]
    return complement_draw(pi, start, cnt, num_items - cnt, zeros, fallback,
                           x=x, generator=generator)


def split_cdf_f32(cdf: np.ndarray, device=None):
    """Double-single form of a float64 CDF: float32 ``(hi, lo)`` tensors on
    ``device`` with ``hi + lo == cdf`` to ~2^-48, the reference's. A plain
    f32 cast collapses long-tail items (a count-1 item's mass ~1e-8 is below
    the f32 ulp near 1.0) so that no draw can reach them; the pair keeps
    every item reachable with its true mass."""
    hi = cdf.astype(np.float32)
    lo = (cdf - hi.astype(np.float64)).astype(np.float32)
    return (torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device))


def _f32_key(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) ordering float32 values as ``<`` does (no NaN;
    -0.0 is made +0.0 first, as the two compare equal)."""
    b = (x.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(b >= 0, b + 2**31, -1 - b)


def _cdf2_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering (hi, lo) float32 pairs lexicographically: hi's
    key in the high 32 bits (hi >= 0 here, so the key stays below 2**63)."""
    return (_f32_key(hi) << 32) + _f32_key(lo)


def upperbound_cdf2(hi, lo, q_hi, q_lo):
    """First index whose (hi, lo) pair is > (q_hi, q_lo) lexicographically:
    the reference's ``_upperbound_cdf2`` (a fixed-depth binary search on the
    pairs). A float64 ``hi + lo`` would not do: near a binade edge of hi the
    query's lo (up to half an ulp of u either way) reorders the sums, and
    the search would pick another item now and then."""
    keys = _cdf2_key(hi, lo)
    return torch.searchsorted(keys, _cdf2_key(q_hi, q_lo),
                              right=True).to(torch.int32)


def sample_negatives_weighted_device(users, pu, pi, cdf, fallback=None,
                                     rounds: int = 16, draw=None,
                                     generator: torch.Generator | None = None):
    """Device-side popularity-weighted negatives: inverse-CDF draws from
    ``cdf`` (a :func:`split_cdf_f32` pair, or one float32 tensor for a
    small catalog) and ``rounds`` fixed redraw rounds that replace the
    draws colliding with the user's positives (:func:`members_2key`); the
    slots still colliding after the last round get ``fallback`` (the slot's
    positive: a zero-gradient pair), where it is given. The measure has no
    order-statistic shortcut, so rejection leaves a residual: per slot the
    user's share of the weighted mass to the power ``rounds + 1``.

    ``draw(r)`` returns round ``r``'s (0 the first draw, 1 … ``rounds`` the
    redraws) uniforms ``(u, u2)``, float32 in [0, 1) of the users' shape;
    else they come from ``generator``. ``u`` picks the CDF entry and ``u2``
    refines the query below the f32 ulp, ``q_lo = (u2 - 0.5) * 2**-24``, so
    that sub-ulp gaps of the pair are reached in proportion to their mass,
    as the reference's. Every round redraws every slot, as the
    reference's."""
    pair = isinstance(cdf, (tuple, list))
    c_hi, c_lo = cdf if pair else (cdf.to(torch.float32), None)

    def pick(r):
        if draw is not None:
            u, u2 = (x.to(users.device, torch.float32) for x in draw(r))
        else:
            u, u2 = (torch.rand(users.shape, generator=generator,
                                device=users.device) for _ in range(2))
        if not pair:
            return torch.searchsorted(c_hi, u, right=True).to(torch.int32)
        return upperbound_cdf2(c_hi, c_lo, u, (u2 - 0.5) * 2.0**-24)

    neg = pick(0)
    for r in range(rounds):
        coll = members_2key(pu, pi, users, neg)
        neg = torch.where(coll, pick(1 + r), neg)
    if fallback is not None:
        neg = torch.where(members_2key(pu, pi, users, neg),
                          fallback.to(neg.dtype), neg)
    return neg


def bpr_epoch_triples(
    coo: RatingsCOO,
    seed: int,
    epoch: int,
    perm: np.ndarray | None = None,
    pos_keys: np.ndarray | None = None,
    cdf: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(users, pos_items, neg_items) for one epoch, in permuted order.
    Pass ``pos_keys`` (from :func:`build_positive_index`) for exact
    negatives and ``cdf`` (from :func:`popularity_cdf`) for
    popularity-weighted ones."""
    neg = sample_negatives(
        coo.n_ratings, coo.num_items, seed, epoch,
        users=coo.user if pos_keys is not None else None,
        pos_keys=pos_keys,
        cdf=cdf,
    )
    if cdf is not None and pos_keys is not None:
        # weighted rejection has a user-mass residual (see
        # MAX_REJECTION_ROUNDS); make any survivor a zero-gradient pair
        ukeys = coo.user.astype(np.int64) * coo.num_items
        neg = np.where(_members(pos_keys, ukeys + neg), coo.item, neg)
    if perm is None:
        return coo.user, coo.item, neg
    return coo.user[perm], coo.item[perm], neg[perm]
