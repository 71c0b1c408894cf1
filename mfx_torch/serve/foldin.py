"""Fold-in: factors for NEW users (or items) from their ratings without
retraining, the counterpart of the explicit part of
``mfx/serve/foldin.py`` (the cold-start serving path behind
``/recommend_cold``).

A new user's row is the regularized least-squares solve against the
FROZEN item table — one ALS half-step for that row:

    p_u = (Q_Ω^T Q_Ω + λ·|Ω|·I)^{-1} Q_Ω^T (r - mu - bi_Ω)

with the bias folded in as an augmented coordinate (q̃ = [q, 1]) when the
model is biased. The batch is two einsums and one batched Cholesky solve
(``torch.linalg.cholesky`` + ``torch.cholesky_solve``) on the model's
device. Ragged histories are padded to a (B, D) window, D the next power
of two of the longest (at least 8); pad slots carry item id ``num_items``
and weight 0.

``fold_in_implicit`` (iALS) is not ported yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from mfx_torch.models.mf import MFModel
from mfx_torch.serve.topk import _topk_batch

__all__ = ["fold_in", "fold_in_batch", "recommend_cold"]


def _pow2_at_least(n: int, lo: int = 256) -> int:
    n = int(max(n, lo))  # int(): numpy ints lack bit_length
    return 1 << (n - 1).bit_length()


def _fold_in_solve(model, items, ratings, lengths, reg, *, use_bias,
                   transpose):
    """items/ratings: (B, D) padded; lengths: (B,). Returns (F, b) new
    rows. ``transpose=True`` folds in new ITEMS against the user table."""
    F = model.P if transpose else model.Q
    bias = model.bu if transpose else model.bi
    k = F.shape[1]
    # bf16 tables solve in f32 (the batched Cholesky takes no bf16)
    f = torch.float32 if F.dtype == torch.bfloat16 else F.dtype
    D = items.shape[1]
    lane = torch.arange(D, dtype=torch.int32, device=F.device)
    mask = (lane[None, :] < lengths[:, None]).to(f)  # (B, D)
    idx = items.long().clamp(0, F.shape[0] - 1)  # the reference's mode="clip"
    q = F[idx].to(f)  # (B, D, k)
    resid = ratings - torch.tensor(model.mu, dtype=f, device=F.device) \
        - bias[idx].to(f)
    if use_bias:
        q = torch.cat([q, torch.ones(q.shape[:2] + (1,), dtype=f,
                                     device=F.device)], dim=2)
    qm = q * mask[:, :, None]
    A = torch.einsum("bmd,bme->bde", qm, qm)
    b = torch.einsum("bm,bmd->bd", resid * mask, qm)
    # weighted regularization λ·degree: the stationary point of the
    # trained per-occurrence objective
    deg = mask.sum(dim=1)
    d = A.shape[-1]
    lam = reg * deg.clamp_min(1.0)
    A = A + lam[:, None, None] * torch.eye(d, dtype=f, device=F.device)
    L = torch.linalg.cholesky(A)
    sol = torch.cholesky_solve(b[..., None], L)[..., 0]
    sol = torch.where(deg[:, None] > 0, sol, torch.zeros_like(sol))
    if use_bias:
        return sol[:, :k], sol[:, k]
    return sol, torch.zeros(sol.shape[0], dtype=f, device=F.device)


def fold_in_batch(
    model: MFModel,
    items: np.ndarray,  # (B, D) int padded with any out-of-range id
    ratings: np.ndarray,  # (B, D) float
    lengths: np.ndarray,  # (B,) valid prefix per row
    reg: float,
    *,
    use_bias: bool = True,
    transpose: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-padded variant (static shapes supplied by the caller)."""
    dev = model.device
    return _fold_in_solve(
        model,
        torch.as_tensor(np.asarray(items, np.int32), device=dev),
        torch.as_tensor(np.asarray(ratings, np.float32), device=dev),
        torch.as_tensor(np.asarray(lengths, np.int32), device=dev),
        float(reg),
        use_bias=use_bias,
        transpose=transpose,
    )


def fold_in(
    model: MFModel,
    histories: list[tuple[np.ndarray, np.ndarray]],  # [(item_ids, ratings)]
    reg: float,
    *,
    use_bias: bool = True,
    transpose: bool = False,
    max_deg: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a batch of new-user histories into factor rows.

    Returns ``(P_new, bu_new)`` with ``P_new[b]`` the solved factor row for
    ``histories[b]`` (or ``(Q_new, bi_new)`` with ``transpose=True``).
    Histories longer than ``max_deg`` keep their ``max_deg`` most recent
    (last) entries. Empty histories get zero factors (score = mu + bi, the
    popularity baseline).
    """
    B = len(histories)
    if B == 0:
        raise ValueError("fold_in needs at least one history")
    n = model.num_users if transpose else model.num_items
    lens = np.array(
        [min(len(ids), max_deg) for ids, _ in histories], np.int32
    )
    D = _pow2_at_least(int(lens.max()) if B else 1, lo=8)
    items = np.full((B, D), n, np.int32)  # pad: out-of-range id
    vals = np.zeros((B, D), np.float32)
    for b, (ids, r) in enumerate(histories):
        ids = np.asarray(ids)[-max_deg:]
        r = np.asarray(r)[-max_deg:]
        items[b, : lens[b]] = ids
        vals[b, : lens[b]] = r
    return fold_in_batch(
        model, items, vals, lens, reg,
        use_bias=use_bias, transpose=transpose,
    )


def recommend_cold(
    model: MFModel,
    histories: list[tuple[np.ndarray, np.ndarray]],
    k: int = 10,
    reg: float = 0.05,
    *,
    use_bias: bool = True,
    exclude_history: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Cold-start top-K: fold each new-user history into a factor row
    (:func:`fold_in`) and serve it through the stock scorer of
    :class:`mfx_torch.serve.TopKRecommender` (one f32 product over the
    catalog, the history's own items excluded), on the model's device.
    No table is changed.

    Returns (items (B, k) int32, scores (B, k) f32)."""
    if k < 1 or k > model.num_items:
        raise ValueError(f"k must be in [1, {model.num_items}], got {k}")
    for ids, _ in histories:
        ids = np.asarray(ids)
        if ids.size and (
            (ids < 0).any() or (ids >= model.num_items).any()
        ):
            raise ValueError("history item id out of range")
    P_new, bu_new = fold_in(model, histories, reg, use_bias=use_bias)
    dev = model.device
    mu = torch.tensor(model.mu, dtype=torch.float32, device=dev)
    B = len(histories)
    # fixed-size user chunks like TopKRecommender.recommend: the
    # (chunk, num_items) block is capped at ~1 GB
    bsz = max(1, min(256, (1 << 28) // max(1, model.num_items)))
    bsz = min(bsz, _pow2_at_least(B, lo=8))
    out_i = np.empty((B, k), np.int32)
    out_s = np.empty((B, k), np.float32)
    for start in range(0, B, bsz):
        stop = min(start + bsz, B)
        # pad rows repeat the last user; their outputs are discarded
        ub = torch.clamp(torch.arange(start, start + bsz, device=dev),
                         max=B - 1)
        if exclude_history:
            chunk = histories[start:stop]
            total = sum(len(ids) for ids, _ in chunk)
            cap = _pow2_at_least(max(total, 1), lo=8)
            rows = np.full(cap, bsz, np.int32)  # out-of-range sentinel
            excl = np.zeros(cap, np.int32)
            pos = 0
            for b, (ids, _) in enumerate(chunk):
                c = len(ids)
                rows[pos:pos + c] = b
                excl[pos:pos + c] = np.asarray(ids, np.int32)
                pos += c
        else:
            rows = np.full(8, bsz, np.int32)
            excl = np.zeros(8, np.int32)
        s, i = _topk_batch(P_new[ub], bu_new[ub], model.Q, model.bi, mu,
                           rows, excl, k)
        out_i[start:stop] = i[: stop - start].cpu().numpy()
        out_s[start:stop] = s[: stop - start].cpu().numpy()
    return out_i, out_s
