"""Held-out RMSE/MAE, the counterpart of ``mfx/eval/metrics.py``.

The split's ids and ratings are copied to the model's device one chunk at
a time and reduced there in float64 (the reference accumulates its chunk
sums on the host in float64).
"""

from __future__ import annotations

import math

import torch

__all__ = ["rmse_mae", "rmse"]


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
