"""Blocked timeSVD trainer (``timesvd.kernel='pallas'``), the counterpart of
``mfx/solvers/timesvd_blocked.py``.

Koren's bias-level temporal terms ride the lane sweep: with L = rank - 3 -
n_bins latent dims the tables are the time-lane form
(``kernels.packing.to_tlane_model``)

  P rows  [p(L), 0 x n_bins, alpha_u, 1, bu]
  Q rows  [q(L), bt_{i,.}, 0 (drift), bi, 1]

and each rating's (time bin, deviation) rides the tile stream as two more
int32 rows (``kernels.plan_device.epoch_tiles_device(extras=...)``), which
``kernels.sgd_sweep.sgd_sweep_time`` injects into the slot's snapshot rows,
so the ordinary lane step is the temporal update. The reference's
semantics, on purpose simpler than ``TimeSVDConfig``'s full schedule:

- one lr and one reg for every term (``lr_t`` / ``lr_alpha`` / ``reg_t`` /
  ``reg_alpha`` left at None or equal to them, or refused);
- each occurrence of item i regularizes all of its bin biases (the
  gathered Q row), where the minibatch path regularizes the active bin;
- conflict-free tiles of the blocked plan instead of iid minibatches.

Blocks are su = si = 512, tiles T = 256, runs padded to 4 tiles, and
``sweep_geometry``'s windows a sweep, as the reference's. Planning is on
the device only: the skeleton once a run, the tile stream every
``replan_every`` epochs (epoch 0's alone with 0, the default). The
reference's host planner is not ported (``plan_device='host'``, ROADMAP
Queue 1 item 5).
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Iterator

import numpy as np
import torch

from mfx_torch.config import TimeSVDConfig
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels.packing import (from_tlane_model, pad_rows,
                                       to_tlane_model)
from mfx_torch.kernels.sgd_sweep import sgd_sweep_time
from mfx_torch.models.mf import MFModel
from mfx_torch.models.timesvd import (TimeFeatures, TimeSVDModel,
                                      fit_time_features, init_timesvd)
from mfx_torch.solvers.blocked import TPG, sweep_geometry

__all__ = ["train_epochs_timesvd_blocked", "run_temporal_epoch",
           "build_temporal_plan_skeleton", "plan_temporal_epoch_device",
           "BLOCK", "TILE"]

BLOCK = 512  # su = si, the reference trainer's
TILE = 256


def _require_uniform_schedule(cfg: TimeSVDConfig) -> None:
    # On the minibatch path None means "derived default" (lr for the rates,
    # reg for reg_t, 10*reg for reg_alpha); the lane scheme trains every
    # term at the one lr/reg, so here None means exactly that, and alpha
    # is regularized at reg, not 10*reg.
    for name, val, base in (
        ("lr_t", cfg.lr_t, cfg.lr), ("lr_alpha", cfg.lr_alpha, cfg.lr),
        ("reg_t", cfg.reg_t, cfg.reg), ("reg_alpha", cfg.reg_alpha, cfg.reg),
    ):
        if val is not None and val != base:
            raise ValueError(
                f"timesvd.kernel='pallas' trains every term with the one "
                f"lr/reg of the lane scheme; set timesvd.{name} to None "
                f"(or exactly {base}), or use kernel='jnp' for the "
                "per-term schedule"
            )
    if cfg.reg_alpha is None and cfg.reg != 0.0:
        warnings.warn(
            "timesvd.kernel='pallas' with reg_alpha=None trains the user "
            f"drift alpha at the uniform reg ({cfg.reg}); the jnp kernel's "
            f"None default is 10*reg ({10 * cfg.reg}). Set "
            f"reg_alpha={cfg.reg} explicitly to silence this, or use "
            "kernel='jnp' to keep the stronger alpha regularization.",
            stacklevel=3,
        )


def build_temporal_plan_skeleton(train: RatingsCOO, tbins, devs, *, su, si,
                                 tile, tpg, nwin, device):
    """Once a run: the plan skeleton (strata do not depend on the payload)
    and the rating streams on ``device``. Returns ``(skel, u, i, r, tb,
    dvb)``: int32 ids, f32 ratings, int32 bins and the deviations' f32 bits
    as int32."""
    dev = torch.device(device)
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    tb = torch.as_tensor(np.asarray(tbins, np.int32)).to(dev)
    dvb = torch.as_tensor(np.asarray(devs, np.float32).view(np.int32)).to(dev)
    skel = pdv.build_plan_skeleton(u, i, train.num_users, train.num_items,
                                   su, si, tile, tpg, nwin)
    return skel, u, i, r, tb, dvb


def plan_temporal_epoch_device(skel, u, i, r, tb, dvb, seed, epoch,
                               rand=None):
    """One epoch's (NT, 5, T) tile stream (rows 0-2 bitwise the 3-row
    plan's, rows 3-4 each slot's bin and deviation bits) and the sweeps
    that hold tiles. ``rand`` as in ``plan_device.epoch_tiles_device``."""
    tl = pdv.epoch_tiles_device(skel, u, i, r, seed, epoch, rand=rand,
                                extras=(tb, dvb))
    return tl, [s for s in skel.sweeps if s.t1 > s.t0]


def _run_sweeps(P, Q, tl, sweeps, lr, reg, mu, n_bins, su, si, tpg):
    """Every sweep of an epoch on the padded time-lane tables, in place;
    returns the epoch's SSE (0-d f32 on the tables' device)."""
    sse = torch.zeros((), dtype=torch.float32, device=P.device)
    for sw in sweeps:
        seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
        sse = sse + sgd_sweep_time(P, Q[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1],
                                   lr, reg, mu, su=su, si=si, tpg=tpg,
                                   n_bins=n_bins, deps=sw.deps)
    return sse


def _tables(ts: TimeSVDModel, n_bins, su, si, device):
    lane = to_tlane_model(ts, n_bins)
    return pad_rows(lane.P.to(device), su), pad_rows(lane.Q.to(device), si)


def _canonical(P, Q, U, I, mu, n_bins) -> TimeSVDModel:
    z = torch.zeros((), dtype=P.dtype, device=P.device)
    return from_tlane_model(
        MFModel(P[:U], Q[:I], z.expand(U), z.expand(I), mu), n_bins)


def run_temporal_epoch(ts: TimeSVDModel, tl, sweeps, lr, reg, n_bins, *, su,
                       si, tpg=TPG):
    """One blocked temporal epoch on a canonical ``TimeSVDModel``: pack to
    the time-lane tables, run every sweep, unpack. Returns ``(model,
    sse)``; the input model is left as it was. The composition hook of
    timeSVD++'s temporal epoch in the reference."""
    P, Q = _tables(ts, n_bins, su, si, ts.device)
    sse = _run_sweeps(P, Q, tl, sweeps, lr, reg, ts.mu, n_bins, su, si, tpg)
    return _canonical(P, Q, ts.num_users, ts.num_items, ts.mu, n_bins), sse


def train_epochs_timesvd_blocked(
    model: MFModel,
    train: RatingsCOO,
    cfg: TimeSVDConfig,
    use_bias: bool = True,
    seed: int = 0,
    start_epoch: int = 0,
    feats: TimeFeatures | None = None,
    timings: dict | None = None,
    replan_every: int = 0,
    device: torch.device | str | None = None,
    plan_rand: Callable[[int, int], torch.Tensor] | None = None,
) -> Iterator[tuple[int, TimeSVDModel, torch.Tensor]]:
    """Yields ``(epoch, TimeSVDModel, train_rmse)`` through
    ``kernels.sgd_sweep.sgd_sweep_time``, from a biased-MF warm start
    (``model``; bt and alpha start at 0). ``train_rmse`` is a 0-d tensor on
    ``device`` (default: the model's). ``timings`` and ``plan_rand`` as in
    ``solvers.blocked.train_epochs_blocked``; ``plan_rand(epoch, n)`` is
    called with the epoch the stream is planned for."""
    if not use_bias:
        raise ValueError("timesvd is the temporal extension of BIASED MF")
    if train.timestamp is None:
        raise ValueError("solver='timesvd' needs dataset timestamps")
    if start_epoch > 0:
        raise ValueError(
            "blocked timesvd cannot resume from an MF-view checkpoint; "
            "persist full state via TimeSVDModel.save_npz"
        )
    _require_uniform_schedule(cfg)
    rank = model.rank
    if 128 % rank:
        raise ValueError(
            f"blocked timesvd needs rank dividing 128, got {rank}")
    if feats is None:
        feats = fit_time_features(train, n_bins=cfg.n_bins, beta=cfg.beta)
    nb = feats.n_bins  # the operative count: a caller's feats may differ
    if nb > rank - 4:
        raise ValueError(
            f"timesvd.kernel='pallas' carries the {nb} bin "
            f"biases in the factor lanes: needs n_bins <= rank-4 = "
            f"{rank - 4} (lower n_bins or raise the rank)"
        )
    dev = torch.device(device) if device is not None else model.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    U, I = model.num_users, model.num_items
    su = si = BLOCK
    t_prep = time.perf_counter()
    tbins, devs = feats.features(train.user, train.timestamp)
    ts = init_timesvd(None, U, I, rank, nb, base=model)
    P, Q = _tables(ts, nb, su, si, dev)
    mu = ts.mu
    plan = build_temporal_plan_skeleton(
        train, tbins, devs, su=su, si=si, tile=TILE, tpg=TPG,
        nwin=sweep_geometry(I, rank, si), device=dev)
    if timings is not None:
        sync()
        timings["prep_s"] = time.perf_counter() - t_prep
        timings.setdefault("plan_s", 0.0)
        timings["sweep_tiles"] = [(s.deps.n_tiles, s.deps.critical)
                                  for s in plan[0].sweeps if s.t1 > s.t0]
    tl = sweeps = None
    for epoch in range(start_epoch, cfg.epochs):
        if tl is None or (replan_every and epoch % replan_every == 0):
            t_plan = time.perf_counter()
            rand = plan_rand(epoch, train.n_ratings) if plan_rand else None
            tl, sweeps = plan_temporal_epoch_device(*plan, seed, epoch,
                                                    rand=rand)
            if timings is not None:
                sync()
                timings["plan_s"] += time.perf_counter() - t_plan
        sse = _run_sweeps(P, Q, tl, sweeps, cfg.lr * cfg.lr_decay ** epoch,
                          cfg.reg, mu, nb, su, si, TPG)
        yield (epoch, _canonical(P, Q, U, I, mu, nb),
               torch.sqrt(sse / max(1, train.n_ratings)))
