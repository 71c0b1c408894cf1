"""Temporal-dynamics MF trainer (``solver='timesvd'``, ``timesvd.kernel=
'jnp'``, the default), the counterpart of ``mfx/solvers/timesvd.py``.

SGD over the Koren-2009 bias-level model (``models.timesvd``): each
rating's time bin and deviation are computed once on the host and ride the
padded epoch batches as two more columns (``data.partition.pad_to_batches``
extras); the step is the snapshot-minibatch step of ``solvers.sgd`` with
two more bias-like streams:

    b_{i,Bin(t)} += lr_t (e - reg_t b_{i,Bin(t)})   [by flat (item, bin) key]
    alpha_u      += lr_a (e dev - reg_a alpha_u)     [by user]

The reference writes this step in XLA, not Pallas, so stock torch ops are
its port, dispatched a batch at a time. Every scatter-add goes through
``kernels.packing.row_add``, which repeats from run to run. Sentinel pads
(``num_rows + slot``, weight 0) scatter into zero sink rows of their own,
as ``kernels.minibatch`` does; their bin is 0, so their flat key falls in
their item's sink row of ``bt``. Eval is time-aware (:func:`rmse_mae_time`):
each held-out rating is predicted at its own timestamp.
"""

from __future__ import annotations

import math
from typing import Iterator

import torch

from mfx_torch.config import TimeSVDConfig
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.kernels import minibatch as mb
from mfx_torch.kernels.packing import row_add
from mfx_torch.models.mf import MFModel
from mfx_torch.models.timesvd import (TimeFeatures, TimeSVDModel,
                                      fit_time_features, init_timesvd)
from mfx_torch.solvers.sgd import plan_epoch

__all__ = ["timesvd_minibatch_update", "train_epochs_timesvd",
           "rmse_mae_time"]


def _step(tabs, mu, n_bins, u, i, r, w, tb, dv, rates, *, unique_rows,
          dup_trust, counts):
    """One batch on the sink-extended tables ``tabs`` = (P, Q, bu, bi,
    bt_flat, alpha), in place, at int64 row ids ``u`` / ``i``; returns the
    batch's squared error. ``rates`` = (lr, lr_t, lr_a, reg, reg_t, reg_a)
    as f32 0-d tensors; ``counts`` the ids ``dup_trust`` counts (users,
    items, flat keys; pads as ``PAD_COUNT_ID``) or None."""
    P, Q, bu, bi, bt, al = tabs
    lr, lr_t, lr_a, reg, reg_t, reg_a = rates
    flat = i * n_bins + tb
    pu = P.index_select(0, u)
    qi = Q.index_select(0, i)
    b_u = bu.index_select(0, u)
    b_i = bi.index_select(0, i)
    b_t = bt.index_select(0, flat)
    a = al.index_select(0, u)
    pred = (pu * qi).sum(-1) + mu
    pred = pred + b_u + b_i + b_t + a * dv
    err = (r - pred) * w
    e = err[:, None]
    wc = w[:, None]
    d_pu = lr * (e * qi - reg * wc * pu)
    d_qi = lr * (e * pu - reg * wc * qi)
    d_bu = lr * (err - reg * w * b_u)
    d_bi = lr * (err - reg * w * b_i)
    d_bt = lr_t * (err - reg_t * w * b_t)
    d_al = lr_a * (err * dv - reg_a * w * a)
    if dup_trust > 0.0 and not unique_rows:
        s_u, s_i, s_f = (torch.clamp(dup_trust / mb._dup_counts(c), max=1.0)
                         for c in counts)
        d_pu = d_pu * s_u[:, None]
        d_qi = d_qi * s_i[:, None]
        d_bu = d_bu * s_u
        d_bi = d_bi * s_i
        d_bt = d_bt * s_f
        d_al = d_al * s_u
    for table, rows, d in ((P, u, d_pu), (Q, i, d_qi), (bu, u, d_bu),
                           (bi, i, d_bi), (bt, flat, d_bt), (al, u, d_al)):
        row_add(table, rows, d)
    return (err * err).sum()


def _sinked(model: TimeSVDModel, B: int):
    """Copies of the tables with ``B`` zero sink rows each (``bt`` as B more
    item rows), ``bt`` flattened."""
    P, Q, bu, bi, bt, al = mb.with_sinks(
        (model.P, model.Q, model.bu, model.bi, model.bt, model.alpha), B)
    return [P, Q, bu, bi, bt.reshape(-1), al]


def _unsinked(tabs, model: TimeSVDModel) -> TimeSVDModel:
    U, I, nb = model.num_users, model.num_items, model.n_bins
    P, Q, bu, bi, bt, al = tabs
    return TimeSVDModel(P[:U], Q[:I], bu[:U], bi[:I], model.mu,
                        bt.reshape(-1, nb)[:I], al[:U])


def _counts(users, items, tbins, weights, n_bins):
    flat = items.long() * n_bins + tbins.long()
    return tuple(mb.count_ids(x, weights) for x in (users.long(),
                                                    items.long(), flat))


def timesvd_minibatch_update(
    model: TimeSVDModel, users, items, ratings, weights, tbins, devs,
    lr, lr_t, lr_a, reg, reg_t, reg_a, *, unique_rows: bool = False,
    dup_trust: float = 0.0,
):
    """One fused snapshot-minibatch update; returns ``(new_model,
    batch_sq_err)``; the input model is left as it was. All reads come from
    the batch-entry snapshot; per-key deltas are summed and applied once.
    Padded slots carry weight 0 (and may carry out-of-range sentinel ids)."""
    dev, B, nb = model.device, users.shape[0], model.n_bins
    tabs = _sinked(model, B)
    rates = tuple(mb.as_f32(x, dev) for x in (lr, lr_t, lr_a, reg, reg_t,
                                              reg_a))
    counts = _counts(users, items, tbins, weights, nb)
    sq = _step(tabs, model.mu, nb, mb.clamp_ids(users, model.num_users + B),
               mb.clamp_ids(items, model.num_items + B), ratings, weights,
               tbins.long(), devs, rates, unique_rows=unique_rows,
               dup_trust=dup_trust, counts=counts)
    return _unsinked(tabs, model), sq


def train_epochs_timesvd(
    model: MFModel,
    train: RatingsCOO,
    cfg: TimeSVDConfig,
    use_bias: bool = True,
    seed: int = 0,
    start_epoch: int = 0,
    feats: TimeFeatures | None = None,
    device: torch.device | str | None = None,
) -> Iterator[tuple[int, TimeSVDModel, float]]:
    """Generator of temporal-SGD epochs from a biased-MF warm start (bt and
    alpha start at 0); yields ``(epoch, TimeSVDModel, train_rmse)``, the
    RMSE a float read once an epoch. ``device`` defaults to the model's."""
    if not use_bias:
        raise ValueError(
            "solver='timesvd' is the temporal extension of BIASED MF; "
            "set model.use_bias=true"
        )
    if start_epoch > 0:
        raise ValueError(
            "timesvd cannot resume from an MF-view checkpoint (bt/alpha "
            "are not in it); restart, or persist full state via "
            "TimeSVDModel.save_npz"
        )
    if feats is None:
        feats = fit_time_features(train, n_bins=cfg.n_bins, beta=cfg.beta)
    dev = torch.device(device) if device is not None else model.device
    base = MFModel(*(t.to(dev) for t in (model.P, model.Q, model.bu,
                                         model.bi)), model.mu)
    ts = init_timesvd(None, model.num_users, model.num_items, model.rank,
                      feats.n_bins, base=base)
    tbins, devs = feats.features(train.user, train.timestamp)
    extras = {"tbins": tbins, "devs": devs}
    lr_t0 = cfg.lr if cfg.lr_t is None else cfg.lr_t
    lr_a0 = cfg.lr if cfg.lr_alpha is None else cfg.lr_alpha
    reg_t = cfg.reg if cfg.reg_t is None else cfg.reg_t
    reg_a = 10.0 * cfg.reg if cfg.reg_alpha is None else cfg.reg_alpha
    unique_rows = cfg.partitioner == "conflict_free"
    trust = cfg.dup_trust > 0.0 and not unique_rows
    nb = ts.n_bins
    for epoch in range(start_epoch, cfg.epochs):
        decay = cfg.lr_decay ** epoch
        rates = tuple(mb.as_f32(x, dev) for x in (
            cfg.lr * decay, lr_t0 * decay, lr_a0 * decay, cfg.reg, reg_t,
            reg_a))
        plan = plan_epoch(train, cfg, seed, epoch, device=dev, extras=extras)
        b = plan.batches
        B = plan.batch_size
        u = mb.clamp_ids(b["users"], ts.num_users + B)
        i = mb.clamp_ids(b["items"], ts.num_items + B)
        tb = b["tbins"].long()
        tabs = _sinked(ts, B)
        sse = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(plan.num_batches):
            counts = (_counts(b["users"][k], b["items"][k], b["tbins"][k],
                              b["weights"][k], nb) if trust else None)
            sse += _step(tabs, ts.mu, nb, u[k], i[k], b["ratings"][k],
                         b["weights"][k], tb[k], b["devs"][k], rates,
                         unique_rows=unique_rows, dup_trust=cfg.dup_trust,
                         counts=counts)
        ts = _unsinked(tabs, ts)
        yield epoch, ts, float(torch.sqrt(sse / max(1, plan.n_real)))


def rmse_mae_time(model: TimeSVDModel, feats: TimeFeatures, coo: RatingsCOO,
                  chunk: int = 1 << 22, clip=None) -> tuple[float, float]:
    """Time-aware (RMSE, MAE): each held-out rating is predicted at its own
    timestamp (``eval.metrics.rmse_mae`` with the temporal terms); sums in
    float64 on the model's device."""
    if coo.timestamp is None:
        raise ValueError("rmse_mae_time needs coo.timestamp on the split")
    n = coo.n_ratings
    if n == 0:
        return 0.0, 0.0
    dev = model.device
    sse = torch.zeros((), dtype=torch.float64, device=dev)
    sae = torch.zeros((), dtype=torch.float64, device=dev)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        tb, dv = feats.features(coo.user[start:stop],
                                coo.timestamp[start:stop])
        u, i, tb = (torch.as_tensor(x).to(dev, torch.int64) for x in (
            coo.user[start:stop], coo.item[start:stop], tb))
        r = torch.as_tensor(coo.rating[start:stop]).to(dev, torch.float32)
        pred = model.predict_t(u, i, tb, torch.as_tensor(dv).to(dev))
        if clip is not None:
            pred = pred.clamp(clip[0], clip[1])
        err = r - pred
        sse += (err * err).sum(dtype=torch.float64)
        sae += err.abs().sum(dtype=torch.float64)
    return math.sqrt(float(sse) / n), float(sae) / n
