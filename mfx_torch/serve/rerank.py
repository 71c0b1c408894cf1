"""Diversity re-ranking of served top-K lists by greedy maximal marginal
relevance (MMR, Carbonell & Goldstein 1998) over the factor space, the
counterpart of ``mfx/serve/rerank.py``.

MMR picks the next slot greedily:

    argmax_j  lam * rel(j)  -  (1 - lam) * max_{s in selected} cos(q_j, q_s)

with ``rel`` the recommender's score min-max-normalized per user over the
candidate pool (a row of equal scores gets 1.0), and item similarity the
factor cosine. ``lam=1`` reproduces the accuracy ranking; lower values
trade relevance for spread. The whole user batch re-ranks at once: the
candidates' factor rows are gathered into one (B, C, r) block on the
model's device, then ``k`` steps of a batched product and a masked
argmax (the first index on ties) in stock torch ops, in the dtype of the
item table. No Pallas kernel stands behind this in the reference.

Use: over-fetch a pool (C = 3-5 x k), then re-rank:

    items, scores = rec.recommend(users, k=50)
    items, scores = rerank_mmr(model, items, scores, k=10, lam=0.7)

or wrap a recommender in :class:`MMRRecommender` (what ``cli serve
--mmr`` does).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rerank_mmr", "MMRRecommender"]


def _mmr_batch(V, rel, valid, k: int, lam: float) -> torch.Tensor:
    """V: (B, C, r) candidate factor rows; rel: (B, C) relevance in
    [0, 1], V's dtype; valid: (B, C) bool. Returns (B, k) int64 indices
    into the candidate axis, in selection order."""
    f = V.dtype
    Vn = V / torch.linalg.vector_norm(V, dim=-1, keepdim=True).clamp_min(
        1e-12)
    B, C, _ = V.shape
    dev = V.device
    lam_t = torch.tensor(lam, dtype=f, device=dev)
    neg = torch.tensor(float("-inf"), dtype=f, device=dev)
    cols = torch.arange(C, device=dev)
    maxsim = torch.zeros((B, C), dtype=f, device=dev)
    taken = torch.zeros((B, C), dtype=torch.bool, device=dev)
    out = torch.zeros((B, k), dtype=torch.int64, device=dev)
    for t in range(k):
        util = lam_t * rel - (1.0 - lam_t) * maxsim
        open_ = valid & ~taken
        util = torch.where(open_, util, neg)
        # a row whose finite candidates ran out (k > its unseen pool)
        # fills from the remaining pool slots in order, never repeating
        exhausted = ~open_.any(dim=1)
        fallback = torch.where(~taken, -cols.to(f)[None, :], neg)
        util = torch.where(exhausted[:, None], fallback, util)
        j = torch.argmax(util, dim=1)  # the first maximum
        out[:, t] = j
        taken |= cols[None, :] == j[:, None]
        vj = Vn[torch.arange(B, device=dev), j]  # (B, r)
        sim = torch.einsum("bcr,br->bc", Vn, vj)
        maxsim = torch.maximum(maxsim, sim)
    return out


def rerank_mmr(model, items, scores, k: int, lam: float = 0.7):
    """Re-rank candidate pools ``(items, scores)`` of shape (B, C), as any
    recommender returns them with C >= k, into diversified (B, k) lists.
    Non-finite scores (exclusion overflow pads) are skipped. Returns
    (items (B, k) int32, scores (B, k) f32): each item's original score,
    in MMR selection order. ``model`` is an ``MFModel`` or the item
    table itself."""
    if not 0.0 <= lam <= 1.0:
        raise ValueError(f"lam must be in [0, 1], got {lam}")
    items = np.asarray(items, np.int32)
    scores = np.asarray(scores, np.float32)
    if items.ndim != 2 or items.shape != scores.shape:
        raise ValueError("items/scores must be matching (B, C) arrays")
    B, C = items.shape
    if not 1 <= k <= C:
        raise ValueError(f"k must be in [1, {C}], got {k}")
    valid = np.isfinite(scores)
    if not valid.any(axis=1).all():
        raise ValueError("a row has no finite-scored candidates")
    # per-user min-max relevance over the pool (constant rows -> 1.0)
    fin = np.where(valid, scores, np.nan)
    lo = np.nanmin(fin, axis=1, keepdims=True)
    hi = np.nanmax(fin, axis=1, keepdims=True)
    rel = np.where(valid, (scores - lo) / np.maximum(hi - lo, 1e-12), 0.0)
    Q = model.Q if hasattr(model, "Q") else model
    dev = Q.device
    idx = torch.as_tensor(items, device=dev).long().clamp(0, Q.shape[0] - 1)
    V = Q[idx]  # (B, C, r), the reference's clipped gather
    sel = _mmr_batch(V, torch.as_tensor(rel, device=dev).to(V.dtype),
                     torch.as_tensor(valid, device=dev), k, lam).cpu().numpy()
    rows = np.arange(B)[:, None]
    return items[rows, sel], scores[rows, sel]


class MMRRecommender:
    """Wrap any recommender so that its lists come back MMR-diversified:
    over-fetches a ``pool`` x k candidate pool from the inner recommender
    (clamped to what it can serve, its ``max_k``) and re-ranks it. Same
    ``recommend(users, k)`` / ``model`` surface, so it drops into the HTTP
    server."""

    def __init__(self, inner, model=None, lam: float = 0.7, pool: int = 4):
        if pool < 1:
            raise ValueError(f"pool must be >= 1, got {pool}")
        if not 0.0 <= lam <= 1.0:
            raise ValueError(f"lam must be in [0, 1], got {lam}")
        self._inner = inner
        self._model = model if model is not None else inner.model
        self.lam = float(lam)
        self.pool = int(pool)

    @property
    def model(self):
        return self._model

    def recommend(self, users, k: int = 10):
        cap = getattr(self._inner, "max_k", self._model.num_items)
        c = min(self.pool * k, self._model.num_items, cap)
        if k > c:
            raise ValueError(
                f"k={k} exceeds the inner recommender's pool ({cap})"
            )
        items, scores = self._inner.recommend(users, k=max(c, k))
        return rerank_mmr(self._model, items, scores, k, lam=self.lam)
