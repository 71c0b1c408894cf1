"""Temporal-dynamics MF (Koren, "Collaborative Filtering with Temporal
Dynamics", KDD 2009), the counterpart of ``mfx/models/timesvd.py``:

    r_hat(u, i, t) = mu + b_u + alpha_u * dev_u(t) + b_i + b_{i,Bin(t)}
                        + p_u . q_i

    dev_u(t) = sign(t - t_u) * |(t - t_u) / span|^beta

Item biases drift by ``n_bins`` equal-count time bins; each user drifts by
a learned ``alpha_u`` against a smooth deviation curve. ``TimeFeatures``
and ``fit_time_features`` are the reference's NumPy featurizer, copied
verbatim: raw timestamps stay int64/float64 on the host (unix seconds
lose about two minutes in f32), and only each rating's bin (int32) and
deviation (f32) go to the device. ``TimeSVDModel`` holds the tables as
buffers of an ``nn.Module``; ``as_mf`` folds the temporal terms at one
reference time into an ``MFModel``, which checkpoints, ranking and
serving take unchanged. ``save_npz`` / ``load_npz`` use the reference's
npz layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from mfx_torch.models.mf import MFModel, init_model

__all__ = [
    "TimeFeatures", "fit_time_features", "TimeSVDModel", "init_timesvd",
]

_KEYS = ("P", "Q", "bu", "bi", "mu", "bt", "alpha")


@dataclasses.dataclass(frozen=True)
class TimeFeatures:
    """Host-side time featurizer (raw dataset time units stay in
    int64/float64 on the host; only the derived f32/int32 feature columns
    go to device).

    t0/t1:  raw-unit train time range (int64 scalars).
    span:   max(1, t1 - t0) as float64 — the dev normalizer.
    edges:  [n_bins - 1] raw-unit bin boundaries (equal-count quantiles
            of the train times; ``searchsorted(edges, t, 'right')`` is
            the bin index, so test times beyond the train range clamp
            into the first/last bin automatically).
    tu:     [num_users] float64 mean raw train time per user (users with
            no train ratings get the global mean time).
    beta:   the deviation exponent.
    """

    t0: int
    t1: int
    span: float
    edges: np.ndarray
    tu: np.ndarray
    beta: float

    @property
    def n_bins(self) -> int:
        return len(self.edges) + 1

    def bins(self, ts: np.ndarray) -> np.ndarray:
        """Raw timestamps -> int32 bin ids in [0, n_bins)."""
        return np.searchsorted(self.edges, ts, side="right").astype(np.int32)

    def dev(self, users: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Raw (user, timestamp) -> f32 dev_u(t) (float64 internally)."""
        d = (ts.astype(np.float64) - self.tu[users]) / self.span
        return (np.sign(d) * np.abs(d) ** self.beta).astype(np.float32)

    def features(self, users, ts) -> tuple[np.ndarray, np.ndarray]:
        return self.bins(ts), self.dev(users, ts)


def fit_time_features(
    coo, n_bins: int = 30, beta: float = 0.4
) -> TimeFeatures:
    """Fit the featurizer on the TRAIN split (deterministic — rebuilt
    identically on resume, like SVD++'s nu)."""
    ts = coo.timestamp
    if ts is None:
        raise ValueError(
            "temporal model needs coo.timestamp; this dataset was loaded "
            "without a time column"
        )
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    t0, t1 = int(ts.min()), int(ts.max())
    # equal-count bins: each bin sees ~the same number of train ratings
    # (calendar-uniform bins would starve sparse eras). Duplicate edges
    # from heavy ties just leave some bins empty — harmless.
    edges = np.quantile(
        ts, np.arange(1, n_bins, dtype=np.float64) / n_bins
    ).astype(np.int64) if n_bins > 1 else np.zeros(0, np.int64)
    tsum = np.zeros(coo.num_users, np.float64)
    cnt = np.zeros(coo.num_users, np.int64)
    np.add.at(tsum, coo.user, ts.astype(np.float64))
    np.add.at(cnt, coo.user, 1)
    mean_all = float(ts.mean())
    tu = np.where(cnt > 0, tsum / np.maximum(cnt, 1), mean_all)
    return TimeFeatures(
        t0=t0, t1=t1, span=float(max(1, t1 - t0)),
        edges=edges, tu=tu, beta=float(beta),
    )


class TimeSVDModel(nn.Module):
    """Learned temporal-MF state: the ``MFModel`` tables plus ``bt``
    (num_items, n_bins), the time-binned item biases, and ``alpha``
    (num_users,), the user drift coefficients; ``mu`` a Python float."""

    def __init__(self, P, Q, bu, bi, mu: float, bt, alpha):
        super().__init__()
        for k, v in (("P", P), ("Q", Q), ("bu", bu), ("bi", bi), ("bt", bt),
                     ("alpha", alpha)):
            self.register_buffer(k, v)
        self.mu = float(mu)

    @property
    def rank(self) -> int:
        return self.P.shape[1]

    @property
    def num_users(self) -> int:
        return self.P.shape[0]

    @property
    def num_items(self) -> int:
        return self.Q.shape[0]

    @property
    def n_bins(self) -> int:
        return self.bt.shape[1]

    @property
    def device(self) -> torch.device:
        return self.P.device

    def predict_t(self, users, items, tbins, devs) -> torch.Tensor:
        """Time-aware prediction from int64 ids and featurized columns
        (int bins, f32 deviations; ``TimeFeatures.features``), in the
        reference's order of sums. Ids are clamped to the tables, as the
        reference's ``mode='clip'`` gathers."""
        u = users.clamp(0, self.num_users - 1)
        i = items.clamp(0, self.num_items - 1)
        flat = (items * self.n_bins + tbins).clamp(0, self.bt.numel() - 1)
        pred = (self.P[u] * self.Q[i]).sum(-1) + self.mu
        pred = pred + self.bu[u]
        pred = pred + self.bi[i]
        pred = pred + self.bt.reshape(-1)[flat]
        return pred + self.alpha[u] * devs

    def as_mf(self, feats: TimeFeatures | None = None,
              at: int | None = None) -> MFModel:
        """The biased-MF view with the temporal terms folded in at one
        reference time ``at`` (raw units; default the end of the train
        window, the "serve now" state). Without ``feats`` the temporal
        terms are dropped (the static-bias view)."""
        if feats is None:
            return MFModel(self.P, self.Q, self.bu, self.bi, self.mu)
        t_ref = feats.t1 if at is None else int(at)
        b = int(feats.bins(np.asarray([t_ref], np.int64))[0])
        dev = feats.dev(np.arange(len(feats.tu)),
                        np.full(len(feats.tu), t_ref, np.int64))
        dev = torch.as_tensor(dev, device=self.device)
        return MFModel(self.P, self.Q, self.bu + self.alpha * dev,
                       self.bi + self.bt[:, b], self.mu)

    def save_npz(self, path) -> None:
        """Full-state single-file export in the reference's layout (the MF
        view alone cannot resume training: bt and alpha would be lost)."""
        arrs = {k: getattr(self, k).cpu().numpy() for k in _KEYS if k != "mu"}
        np.savez_compressed(path, mu=np.asarray(self.mu, np.float32), **arrs)

    @staticmethod
    def load_npz(path, device: torch.device | str = "cuda") -> "TimeSVDModel":
        """Inverse of :meth:`save_npz`; reads files the reference wrote.
        The tables land on the card unless ``device`` says otherwise."""
        with np.load(path) as z:
            arrs = {k: z[k] for k in _KEYS}
        t = {k: torch.as_tensor(arrs[k], dtype=torch.float32, device=device)
             for k in _KEYS if k != "mu"}
        return TimeSVDModel(mu=float(arrs["mu"]), **t)


def init_timesvd(
    generator: torch.Generator | None,
    num_users: int,
    num_items: int,
    rank: int,
    n_bins: int,
    *,
    global_mean: float = 0.0,
    init_scale: float | None = None,
    base: MFModel | None = None,
) -> TimeSVDModel:
    """Scaled-normal P/Q from ``generator`` (or a warm start from ``base``,
    whose tables are shared, not copied), zero temporal tables: the model
    starts exactly at the biased-MF point."""
    if base is None:
        base = init_model(generator, num_users, num_items, rank,
                          global_mean=global_mean, init_scale=init_scale)
    z = dict(dtype=base.P.dtype, device=base.device)
    return TimeSVDModel(base.P, base.Q, base.bu, base.bi, base.mu,
                        torch.zeros((num_items, n_bins), **z),
                        torch.zeros((num_users,), **z))
