"""Held-out RMSE/MAE and sampled AUC, the counterpart of
``mfx/eval/metrics.py``.

The split's ids and ratings are copied to the model's device one chunk at
a time and reduced there in float64 (the reference accumulates its chunk
sums on the host in float64). The AUC's negatives are the reference's
host draws (``mfx_torch.data.bpr.sample_negatives``), so both packages
score the same pairs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["rmse_mae", "rmse", "sampled_auc"]


def rmse_mae(model, coo, chunk: int = 1 << 22, clip=None) -> tuple[float, float]:
    """(RMSE, MAE) of ``model`` on a host ``RatingsCOO`` split. ``clip``
    = (lo, hi) clips predictions first, as the training driver does."""
    n = coo.n_ratings
    if n == 0:
        return 0.0, 0.0
    dev = model.device
    sse = torch.zeros((), dtype=torch.float64, device=dev)
    sae = torch.zeros((), dtype=torch.float64, device=dev)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        u = torch.as_tensor(coo.user[start:stop]).to(dev, torch.int64)
        i = torch.as_tensor(coo.item[start:stop]).to(dev, torch.int64)
        r = torch.as_tensor(coo.rating[start:stop]).to(dev, torch.float32)
        pred = model.predict(u, i)
        if clip is not None:
            pred = pred.clamp(clip[0], clip[1])
        err = r - pred
        sse += (err * err).sum(dtype=torch.float64)
        sae += err.abs().sum(dtype=torch.float64)
    return math.sqrt(float(sse) / n), float(sae) / n


def rmse(model, coo, **kw) -> float:
    return rmse_mae(model, coo, **kw)[0]


def sampled_auc(model, coo, seed: int = 0, chunk: int = 1 << 20,
                pos_keys: np.ndarray | None = None) -> float:
    """Implicit-feedback ranking quality: P(score(pos) > score(neg)), ties
    counting half, with one exact negative per held-out positive (uniform
    over the catalog, rejection-filtered against ``pos_keys``: the sorted
    ``u * num_items + i`` keys of all observed positives, train and test;
    the split's own positives when omitted)."""
    from mfx_torch.data.bpr import build_positive_index, sample_negatives

    n = coo.n_ratings
    if n == 0:
        return 0.5
    if pos_keys is None:
        pos_keys = build_positive_index(coo)
    neg = sample_negatives(n, coo.num_items, seed, epoch=0xE7A1,
                           users=coo.user, pos_keys=pos_keys)
    dev = model.device
    wins = torch.zeros((), dtype=torch.float64, device=dev)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        u = torch.as_tensor(coo.user[start:stop]).to(dev, torch.int64)
        p = torch.as_tensor(coo.item[start:stop]).to(dev, torch.int64)
        q = torch.as_tensor(neg[start:stop]).to(dev, torch.int64)
        pu = model.P[u]
        s_pos = (pu * model.Q[p]).sum(-1)
        s_neg = (pu * model.Q[q]).sum(-1)
        wins += ((s_pos > s_neg).double()
                 + 0.5 * (s_pos == s_neg).double()).sum()
    return float(wins) / n
