"""timeSVD++ trainer (``solver='timesvdpp'``), the counterpart of
``mfx/solvers/timesvdpp.py``: temporal dynamics and implicit feedback on
one model (Koren, KDD 2009),

    r_hat(u,i,t) = mu + b_u + alpha_u dev_u(t) + b_i + b_{i,Bin(t)}
                      + q_i . (p_u + nu_u sum_{j in N(u)} y_j)

composed from the two parents' machinery, as the reference composes it:

1. refresh ``S_u = nu_u sum_j y_j`` (``models.svdpp.implicit_sums``);
2. one temporal SGD epoch of the timeSVD model over ``X = P + S``, by
   ``timesvdpp.kernel``: ``'jnp'``, the snapshot-minibatch epoch of
   ``solvers.timesvd`` (:func:`~mfx_torch.solvers.timesvd.timesvd_epoch`);
   ``'pallas'``, the blocked epoch of ``solvers.timesvd_blocked``
   (``run_temporal_epoch``: X packed into the time-lane tables, the time
   form of ``csrc/sgd_sweep.cu`` on the card, unpacked), on one device
   plan made once a run at epoch id 0 (su = si = 512, T = 256, tpg 4);
3. one exact full-batch gradient step on Y with the time-aware residual
   (:func:`y_gradient_step_t`), trust-capped per item, through
   ``kernels.packing.segment_row_add``.

On ``'pallas'`` the reference replays the blocked plan's tiles for the Y
step with one-hot matmuls (``y_gradient_step_tiles``), a TPU workaround;
the port runs :func:`y_gradient_step_t`'s math over the training COO on
both kernels, which sums in another order (ROADMAP, "Expected
differences").

With ``lr_y = 0`` the trajectory is the timeSVD trainer's bit for bit;
with ``lr_t = lr_alpha = 0`` (and timestamps that leave the temporal terms
at 0) the SVD++ trainer's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np
import torch

from mfx_torch.config import TimeSVDPPConfig
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.kernels import minibatch as mb
from mfx_torch.models.mf import MFModel
from mfx_torch.models.svdpp import CHUNK, implicit_sums
from mfx_torch.models.timesvd import (TimeFeatures, TimeSVDModel,
                                      fit_time_features)
from mfx_torch.solvers import timesvd_blocked as tsb
from mfx_torch.solvers.blocked import TPG, sweep_geometry
from mfx_torch.solvers.sgd import plan_epoch
from mfx_torch.solvers.svdpp import (Y_TR_ETA, _apply_y_step, coo_chunks,
                                     svdpp_run_constants, y_step_pull)
from mfx_torch.solvers.timesvd import timesvd_epoch

__all__ = ["train_epochs_timesvdpp", "y_gradient_step_t", "TimeSVDppState"]

_TABLES = ("P", "Q", "Y", "bu", "bi", "bt", "alpha", "nu")


@dataclasses.dataclass(frozen=True)
class TimeSVDppState:
    """Full trainer state for warm starts (the TimeSVDModel view alone
    cannot resume: Y would be lost). Host-side numpy arrays, npz-backed in
    the reference's keys."""

    P: np.ndarray
    Q: np.ndarray
    Y: np.ndarray
    bu: np.ndarray
    bi: np.ndarray
    mu: np.ndarray
    bt: np.ndarray
    alpha: np.ndarray
    nu: np.ndarray

    def save_npz(self, path) -> None:
        np.savez_compressed(
            path, **{f.name: np.asarray(getattr(self, f.name))
                     for f in dataclasses.fields(self)}
        )

    @staticmethod
    def load_npz(path) -> "TimeSVDppState":
        with np.load(path) as z:
            return TimeSVDppState(**{k: z[k] for k in z.files})


def y_gradient_step_t(Y, X, Q, bu, bi, mu, bt, alpha, nu, deg_i, y_scale,
                      batches, lr_y, reg_y, tr_eta=None):
    """One full-batch gradient step on Y at frozen (X, Q, biases, bt,
    alpha) with the time-aware residual: ``svdpp.y_gradient_step`` whose
    chunks also carry each rating's ``tbins`` and ``devs``. Exact gradient
    with all-ones ``y_scale``; the trainer passes the trust cap. Returns
    ``(Y_new, sse)``."""
    dev = X.device
    n_bins = bt.shape[1]
    bt_flat = bt.reshape(-1)

    def residual(c, u, i, q):
        pred = (X.index_select(0, u) * q).sum(-1) + mu
        pred = pred + bu.index_select(0, u)
        pred = pred + bi.index_select(0, i)
        flat = (batches["items"][c].long() * n_bins
                + batches["tbins"][c].long())
        pred = pred + bt_flat.index_select(
            0, flat.clamp(0, bt_flat.shape[0] - 1))
        pred = pred + alpha.index_select(0, u) * batches["devs"][c]
        return batches["ratings"][c] - pred

    G, sse = y_step_pull(Y, X, Q, nu, batches, residual)
    eta = Y_TR_ETA if tr_eta is None else tr_eta
    return _apply_y_step(Y, y_scale[:, None] * G, deg_i,
                         mb.as_scalar(lr_y, dev), mb.as_scalar(reg_y, dev),
                         eta), sse


def _check_blocked(cfg, rank: int, n_bins: int) -> None:
    """The reference's refusals of ``kernel='pallas'``, in its order."""
    tsb._require_uniform_schedule(cfg)
    if 128 % rank:
        raise ValueError(
            f"timesvdpp.kernel='pallas' needs rank dividing 128, got {rank}")
    if n_bins > rank - 4:
        raise ValueError(
            f"timesvdpp.kernel='pallas' carries the {n_bins} bin biases in "
            f"the factor lanes: needs n_bins <= rank-4 = {rank - 4}")


def _start(model: MFModel, init_state, n_bins: int, dev):
    """The tables (P, Q, Y, bu, bi, bt, alpha) and mu a run starts from:
    ``init_state``'s, or the MF init with Y, bt and alpha at 0."""
    if init_state is not None:
        if init_state.bt.shape[1] != n_bins:
            raise ValueError(
                f"init_state has {init_state.bt.shape[1]} time bins; this "
                f"run's featurizer has {n_bins} (timesvdpp.n_bins)")
        t = [torch.as_tensor(np.asarray(getattr(init_state, k)),
                             dtype=torch.float32, device=dev)
             for k in ("P", "Q", "Y", "bu", "bi", "bt", "alpha")]
        return t, float(np.asarray(init_state.mu))
    P, Q, bu, bi = (getattr(model, k).to(dev) for k in ("P", "Q", "bu", "bi"))
    z = dict(dtype=P.dtype, device=dev)
    return [P, Q, torch.zeros_like(Q), bu, bi,
            torch.zeros((model.num_items, n_bins), **z),
            torch.zeros((model.num_users,), **z)], model.mu


def train_epochs_timesvdpp(
    model: MFModel,
    train: RatingsCOO,
    cfg: TimeSVDPPConfig,
    use_bias: bool = True,
    seed: int = 0,
    start_epoch: int = 0,
    feats: TimeFeatures | None = None,
    chunk: int = CHUNK,
    init_state: TimeSVDppState | None = None,
    capture: dict | None = None,
    device: torch.device | str | None = None,
    plan_rand: Callable[[int, int], torch.Tensor] | None = None,
    timings: dict | None = None,
) -> Iterator[tuple[int, TimeSVDModel, float]]:
    """Generator yielding ``(epoch, timesvd_view, train_rmse)``: the
    post-epoch ``TimeSVDModel`` over ``X = P + S`` (S refreshed after the
    Y step), which the driver's time-aware eval and ``as_mf`` serving take
    as they take the timeSVD trainers'; the RMSE a float read once an
    epoch. ``device`` defaults to the model's.

    Warm starts: with ``capture={}`` the trainer puts the full post-epoch
    :class:`TimeSVDppState` in ``capture['state']`` each epoch (persist it
    with ``save_npz``); a run started with ``init_state`` and the matching
    ``start_epoch`` continues the unbroken run bit for bit (the blocked
    plan is pinned to epoch id 0, whatever ``start_epoch`` is).

    ``plan_rand(0, nnz)``: the blocked plan's shuffle bits, as
    ``solvers.timesvd_blocked``'s. ``timings``, if given, gets ``prep_s``
    (constants, chunks and, blocked, the plan; host clock after a sync)
    and ``y_ms``, each epoch's Y step and S refresh on the device (CUDA
    events on the card, the host clock on the CPU), read at the epoch's
    end."""
    if not use_bias:
        raise ValueError(
            "solver='timesvdpp' is the temporal+implicit extension of "
            "BIASED MF; set model.use_bias=true"
        )
    if start_epoch != 0 and init_state is None:
        raise ValueError(
            "timesvdpp cannot resume from a view checkpoint (Y/bt/alpha "
            "are not all in it); restart from epoch 0, or pass "
            "init_state=TimeSVDppState (persisted via capture + save_npz)"
        )
    if feats is None:
        feats = fit_time_features(train, n_bins=cfg.n_bins, beta=cfg.beta)
    nb = feats.n_bins
    dev = torch.device(device) if device is not None else model.device
    (P, Q, Y, bu, bi, bt, alpha), mu = _start(model, init_state, nb, dev)
    blocked = cfg.kernel == "pallas"
    if blocked:
        _check_blocked(cfg, model.rank, nb)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_prep = time.perf_counter()
    tbins, devs = feats.features(train.user, train.timestamp)
    user, item, nu, deg_i, y_scale = svdpp_run_constants(train, cfg, dev)
    chunks = coo_chunks(train, chunk, dev,
                        extras={"tbins": tbins, "devs": devs})
    rates = (cfg.lr if cfg.lr_t is None else cfg.lr_t,
             cfg.lr if cfg.lr_alpha is None else cfg.lr_alpha)
    reg_t = cfg.reg if cfg.reg_t is None else cfg.reg_t
    reg_a = 10.0 * cfg.reg if cfg.reg_alpha is None else cfg.reg_alpha
    lr_y0 = cfg.lr if cfg.lr_y is None else cfg.lr_y
    reg_y = cfg.reg if cfg.reg_y is None else cfg.reg_y
    if blocked:
        skel = tsb.build_temporal_plan_skeleton(
            train, tbins, devs, su=tsb.BLOCK, si=tsb.BLOCK, tile=tsb.TILE,
            tpg=TPG, nwin=sweep_geometry(model.num_items, model.rank,
                                         tsb.BLOCK), device=dev)
        rand = plan_rand(0, train.n_ratings) if plan_rand else None
        tl, sweeps = tsb.plan_temporal_epoch_device(*skel, seed, 0,
                                                    rand=rand)
        del skel
    if timings is not None:
        sync()
        timings["prep_s"] = time.perf_counter() - t_prep
        timings["y_ms"] = []
    S = implicit_sums(Y, user, item, nu, chunk)  # zeros at init
    for epoch in range(start_epoch, cfg.epochs):
        decay = cfg.lr_decay ** epoch
        ts = TimeSVDModel(P + S, Q, bu, bi, mu, bt, alpha)
        if blocked:
            ts, sse = tsb.run_temporal_epoch(ts, tl, sweeps, cfg.lr * decay,
                                             cfg.reg, nb, su=tsb.BLOCK,
                                             si=tsb.BLOCK, tpg=TPG)
            n_real = train.n_ratings
        else:
            plan = plan_epoch(train, cfg, seed, epoch, device=dev,
                              extras={"tbins": tbins, "devs": devs})
            ts, sse = timesvd_epoch(ts, plan, (
                cfg.lr * decay, rates[0] * decay, rates[1] * decay, cfg.reg,
                reg_t, reg_a), cfg)
            n_real = plan.n_real
        clock = _Clock(dev) if timings is not None else None
        Y, _ = y_gradient_step_t(Y, ts.P, ts.Q, ts.bu, ts.bi, mu, ts.bt,
                                 ts.alpha, nu, deg_i, y_scale, chunks,
                                 lr_y0 * decay, reg_y)
        P, Q = ts.P - S, ts.Q
        bu, bi, bt, alpha = ts.bu, ts.bi, ts.bt, ts.alpha
        # the next epoch's start and this epoch's eval-consistent view
        S = implicit_sums(Y, user, item, nu, chunk)
        if clock is not None:
            clock.stop()
        train_rmse = float(torch.sqrt(sse / max(1, n_real)))
        if clock is not None:
            timings["y_ms"].append(clock.ms())
        if capture is not None:
            capture["state"] = TimeSVDppState(
                mu=np.asarray(mu, np.float32), **{
                    k: v.cpu().numpy() for k, v in zip(_TABLES, (
                        P, Q, Y, bu, bi, bt, alpha, nu))})
        yield epoch, TimeSVDModel(P + S, Q, bu, bi, mu, bt, alpha), train_rmse


class _Clock:
    """A device span: CUDA events on the card, the host clock on the CPU
    (read once the span's work is done)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(2)]
            self.events[0].record()
        else:
            self.t = [time.perf_counter()]

    def stop(self):
        if self.cuda:
            self.events[1].record()
        else:
            self.t.append(time.perf_counter())

    def ms(self) -> float:
        if self.cuda:
            self.events[1].synchronize()
            return self.events[0].elapsed_time(self.events[1])
        return (self.t[1] - self.t[0]) * 1e3
