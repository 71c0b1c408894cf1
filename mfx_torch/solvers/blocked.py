"""Blocked-SGD trainer, the counterpart of
``mfx/solvers/blocked.py::train_epochs_blocked`` with the device planner,
for every ``sgd.bias_mode``, with the dense phase off, over the full item
span (``sgd.dense_span='full'``, with ``sgd.dense_spg``) or over the head
(``'head'``, the first ``ceil(8192 / si)`` windows), with
``sgd.dense_echo`` passes, and with ``sgd.mxu`` 'f32' or 'bf16':

- ``'lane'`` (the ``ml25m_rank64`` preset at rank 64 with int4 codes,
  ``netflix100m_rank128_dp`` with ``parallel.mode=single`` at rank 128
  with int8 codes, ``ml1m_rank32_biased`` with ``sgd.bias_mode=lane`` at
  rank 32): lane-form tables, the lane form of ``kernels.dense_phase``
  then ``kernels.sgd_sweep``;
- ``'tile'`` (the ``ml1m_rank32_biased`` preset) or no biases
  (``model.use_bias=false``): canonical tables with ``bu`` / ``bi``
  beside them; the dense phase in its frozen-bias form, each group
  followed by one batched bias update (``dense_bias_update``), or its
  bias-free form; then ``kernels.sgd_sweep_tile`` or, with
  ``sgd.step_user_batch``, ``kernels.sgd_sweep_step_u``;
- ``'epoch'``: the same tables and dense phase; the sweeps through
  ``kernels.sgd_sweep_epoch``, biases frozen for the epoch, each slot's
  residual written to one buffer, and one batched bias update from the
  residuals at the epoch's end.

One epoch is the dense groups in order, then the sparse item-sweeps in
order, on plain padded ``(rows, rank)`` f32 tables updated in place.
``sgd.mxu='bf16'`` runs every sweep in its bf16-rounded form
(``kernels.sgd_sweep``); the dense phase takes no ``mxu``, as the
reference's. ``sgd.dense_spg`` changes no stratum: the reference's
padding for it adds only exact no-ops, so the run is the ``spg=1`` run
(``dense_info`` counts the padding's slots). Prep
(dense carving, the R image, the plan skeleton) runs once; the tile stream
is rebuilt every ``replan_every`` epochs. Windows per sweep and per dense
group follow the reference's geometry so that the port replays its stratum
order. Every sum of the bias updates goes through
``kernels.packing.row_add``: no float atomics.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import numpy as np
import torch

from mfx_torch.config import SGDConfig
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels.dense_phase import (bias_step, dense_bias_update,
                                           dense_phase, plan_launch)
from mfx_torch.kernels.packing import (from_lane_model, lane_tables,
                                       plain_tables, row_add)
from mfx_torch.kernels.sgd_sweep import (check_lane_rank, sgd_sweep,
                                         sgd_sweep_epoch, sgd_sweep_step_u,
                                         sgd_sweep_tile)
from mfx_torch.models.mf import MFModel
from mfx_torch.solvers.dense_prep import (prepare_dense_device,
                                          prepare_dense_full)

__all__ = ["train_epochs_blocked", "sweep_geometry", "dense_group_windows",
           "dense_rfmt", "TPG"]

# Tiles per user-block run unit: the reference trainer's grid step of 4
# tiles. The planner pads each user block's run of tiles to a multiple of
# it, so the port's tile stream is the reference's, pad tiles included;
# with sgd.step_user_batch it is also the user-side batch of
# kernels.sgd_sweep_step_u (TPG * tile slots).
TPG = 4

# Order parameters, not memory budgets: the reference sized its item-sweeps
# and dense groups to the TPU's VMEM (11 MB and 4.3 MB of merged Q rows,
# 128 lanes of f32 per row plus 8 bias rows per block). The port keeps
# the resulting window counts so that it visits strata in the reference's
# order; choosing them for this card is later work (ROADMAP).
_REF_SWEEP_Q_BYTES = 11 * 1024 * 1024
_REF_DENSE_Q_BYTES = 4_300_000
# the item span of the head-only dense split (the reference's
# DENSE_HEAD_ITEMS)
DENSE_HEAD_ITEMS = 8192


def _ref_q_row_bytes(rank: int, si: int) -> int:
    return (si // (128 // rank) + 8) * 128 * 4


def sweep_geometry(num_items: int, rank: int, si: int,
                   step_u: tuple[int, int] | None = None) -> int:
    """Item windows per sparse sweep (the reference's ``sweep_geometry``).
    With ``sgd.step_user_batch`` pass ``step_u=(su, tile)``: the
    reference trainer first takes its step-batched operands out of the
    budget (floored at 2 MB), so its sweeps can be shorter."""
    budget = _REF_SWEEP_Q_BYTES
    if step_u is not None:
        su, tile = step_u
        budget = max(1 << 21,
                     budget - TPG * tile * (su // (128 // rank) + 512) * 4)
    c = -(-num_items // si)
    return min(c, max(1, budget // _ref_q_row_bytes(rank, si)))


def dense_group_windows(rank: int, si: int) -> int:
    """Item windows per dense group (the reference's
    ``dense_group_windows``)."""
    return max(1, _REF_DENSE_Q_BYTES // _ref_q_row_bytes(rank, si))


def dense_rfmt(cfg: SGDConfig, rank: int, rating: np.ndarray) -> str:
    """Rating-code width of the dense phase (``sgd.dense_int4``): 'auto'
    picks int4 when every rating lies on the half-star grid (then int4 is
    lossless) and the rank is 64 or 32."""
    small = 128 // rank in (2, 4)
    if cfg.dense_int4 == "on":
        if not small:
            raise ValueError("sgd.dense_int4='on' requires rank 64 or 32")
        return "int4"
    if cfg.dense_int4 == "off" or not small:
        return "int8"
    r2 = np.asarray(rating, np.float32) * 2.0
    return "int4" if bool(np.all(np.round(r2) == r2)) else "int8"


def _unsupported(cfg: SGDConfig, use_bias: bool) -> str | None:
    if cfg.partitioner != "blocked":
        raise ValueError(
            f"train_epochs_blocked needs partitioner='blocked', got "
            f"{cfg.partitioner!r} (mfx_torch.solvers.sgd.train_epochs runs "
            "'fixed' and 'conflict_free')")
    if cfg.kernel == "blocked_jnp":
        return ("kernel='blocked_jnp' (the reference's one-hot XLA mirror "
                "of the fused kernel; the kernels' plain versions stand in "
                "for it in the tests; Queue 1 item 5)")
    if cfg.kernel != "pallas":
        raise ValueError(f"unknown blocked kernel {cfg.kernel!r}")
    if cfg.plan_device == "host":
        return ("plan_device='host' (the port plans on the device only; "
                "Queue 1 item 5)")
    return None


def train_epochs_blocked(
    model: MFModel,
    train: RatingsCOO,
    cfg: SGDConfig,
    use_bias: bool,
    seed: int = 0,
    device: torch.device | str | None = None,
    timings: dict | None = None,
    plan_rand: Callable[[int, int], torch.Tensor] | None = None,
    start_epoch: int = 0,
) -> Iterator[tuple[int, MFModel, torch.Tensor]]:
    """Yields ``(epoch, model, train_rmse)`` like the reference, for the
    epochs from ``start_epoch`` on.

    ``model`` is canonical (biases in ``bu``/``bi``); each yielded model is
    a fresh canonical copy of the tables after the epoch, and
    ``train_rmse`` a 0-d tensor on ``device`` (reading it waits for the
    epoch). ``device`` defaults to the model's. ``timings``, if given, is
    filled with ``prep_s`` (the dense carving, the dense kernel's launch
    orders and the plan skeleton), the cumulative ``plan_s``, ``dense_s``
    (the dense groups' kernels), ``sparse_s`` (the sweeps) and ``bias_s``
    (the batched bias updates of the frozen-bias dense groups and of
    ``bias_mode='epoch'``); on the card these three are read from CUDA
    events around each part, all at the epoch's end (one wait for the
    device there, none inside the epoch), ``dense_info`` and ``sweep_tiles``: per sparse sweep its tiles and the
    tiles on its longest dependency chain (their ratio is the most that
    walking the sweep on many SMs can give).
    ``plan_rand(epoch, n)``, if given, supplies the epoch's
    within-stratum shuffle key (n int32 values) instead of the seeded
    torch generator — the parity tests pass the reference planner's bits
    this way.

    The lr schedule follows the epoch number, and the tile stream of an
    epoch is the one planned for its last replan epoch (a multiple of
    ``replan_every``; epoch 0 when that is 0), so a run resumed
    at ``start_epoch`` from the tables an unbroken run had there repeats
    that run bit for bit. (The reference plans a resumed run's first
    epoch with its own number.)
    """
    why = _unsupported(cfg, use_bias)
    if why is not None:
        raise NotImplementedError(f"mfx_torch blocked trainer: {why}; see ROADMAP")
    bf16 = cfg.mxu == "bf16"
    echo = cfg.dense_echo
    lane = use_bias and cfg.bias_mode == "lane"
    if lane:
        check_lane_rank("train_epochs_blocked", model.rank)
    epoch_bias = use_bias and cfg.bias_mode == "epoch"
    dense_bias = "lane" if lane else "frozen" if use_bias else "none"
    dev = torch.device(device) if device is not None else model.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    su, si, T = cfg.ublock, cfg.iblock, cfg.tile
    U, I, rank = model.num_users, model.num_items, model.rank
    mu = model.mu
    n_train = train.n_ratings
    want_dense = cfg.dense_chi != 0 and su == si and 128 // rank in (1, 2, 4)
    if want_dense and echo > 1 and use_bias and cfg.bias_mode == "tile":
        raise ValueError(
            "sgd.dense_echo > 1 with biases requires sgd.bias_mode='lane' "
            "(the frozen-bias dense path consumes single-pass E sums)")
    rfmt = dense_rfmt(cfg, rank, train.rating) if want_dense else "int4"

    t_prep = time.perf_counter()
    if lane:
        P, Q = lane_tables(model, su, si, dev)
        zu = torch.zeros(U, dtype=torch.float32, device=dev)
        zi = torch.zeros(I, dtype=torch.float32, device=dev)

        def run_sweep(sw, seg, lr):
            return sgd_sweep(P, Q[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr,
                             cfg.reg, mu, su=su, si=si, tpg=TPG, deps=sw.deps,
                             bf16=bf16)

        def canonical():
            return from_lane_model(MFModel(P[:U], Q[:I], zu, zi, mu))
    else:
        P, Q, bu, bi = plain_tables(model, su, si, dev)
        sweep_fn = sgd_sweep_step_u if cfg.step_user_batch else sgd_sweep_tile

        def run_sweep(sw, seg, lr):
            if epoch_bias:
                return sgd_sweep_epoch(P, Q[seg], bu, bi[seg], sw.sa, sw.tc,
                                       tl[sw.t0:sw.t1], e_all[sw.t0:sw.t1],
                                       lr, cfg.reg, mu, su=su, si=si, tpg=TPG,
                                       deps=sw.deps, bf16=bf16)
            return sweep_fn(P, Q[seg], bu, bi[seg], sw.sa, sw.tc,
                            tl[sw.t0:sw.t1], lr, cfg.reg, mu, su=su, si=si,
                            tpg=TPG, use_bias=use_bias, deps=sw.deps,
                            bf16=bf16)

        def canonical():
            return MFModel(P[:U].clone(), Q[:I].clone(), bu[:U].clone(),
                           bi[:I].clone(), mu)
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    dense_meta, dense_groups, dinfo = (), (), None
    if want_dense and cfg.dense_span == "full":
        dense_meta, dense_groups, (u, i, r), dinfo = prepare_dense_full(
            u, i, r, U, I, su, si, chi_min=cfg.dense_chi,
            nwd=cfg.dense_nwd or dense_group_windows(rank, si), rfmt=rfmt,
            spg=cfg.dense_spg,
        )
    elif want_dense:
        dense_meta, dense_groups, (u, i, r), dinfo = prepare_dense_device(
            u, i, r, U, I, su, si, chi_min=cfg.dense_chi,
            nwin_head=min(-(-DENSE_HEAD_ITEMS // si), -(-I // si)),
            rfmt=rfmt)
    # the groups the kernel runs: their strata ordered echo slots each
    dense_groups = tuple(dict(g, deps=g["deps"].repeat(echo))
                         for g in dense_groups)
    for grp in dense_groups:
        plan_launch(grp, su, si, rank, dense_bias, echo)
    skel = pdv.build_plan_skeleton(
        u, i, U, I, su, si, T, TPG, sweep_geometry(
            I, rank, si, step_u=(su, T) if cfg.step_user_batch else None)
    )
    sweeps = [s for s in skel.sweeps if s.t1 > s.t0]
    if epoch_bias:  # each slot's residual of the epoch (0 in pads)
        e_all = torch.zeros((skel.nt_total, T), dtype=torch.float32,
                            device=dev)
    if timings is not None:
        sync()
        timings["prep_s"] = time.perf_counter() - t_prep
        for key in ("plan_s", "dense_s", "sparse_s", "bias_s"):
            timings.setdefault(key, 0.0)
        timings["sweep_tiles"] = [(sw.deps.n_tiles, sw.deps.critical)
                                  for sw in sweeps]
        if dinfo is not None:
            timings["dense_info"] = dinfo

    marks = []  # (key, start, end) of this epoch's timed parts

    def timed(key, fn, *args):
        if timings is None:
            return fn(*args)
        if dev.type != "cuda":
            t0 = time.perf_counter()
            out = fn(*args)
            timings[key] += time.perf_counter() - t0
            return out
        stream = torch.cuda.current_stream(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        out = fn(*args)
        end.record(stream)
        marks.append((key, start, end))
        return out

    def read_marks():
        if marks:
            marks[-1][2].synchronize()
        for key, start, end in marks:
            timings[key] += start.elapsed_time(end) / 1e3
        marks.clear()

    def epoch_bias_update(lr):
        # the reference's batched update from the epoch's residual sums,
        # per global row, with the per-row trust scaling of the dense
        # phase (a d-occurrence batched bias step has curvature lr d)
        e_r = e_all.view(-1)[d]
        for b, ids, deg in ((bu, u_s, deg_u), (bi, i_s, deg_i)):
            esum = torch.zeros_like(b)
            row_add(esum, ids, e_r)
            bias_step(b, esum, deg, lr, cfg.reg)

    tl = None
    for epoch in range(start_epoch, cfg.epochs):
        lr = cfg.lr * (cfg.lr_decay ** epoch)
        if tl is None or (cfg.replan_every and epoch % cfg.replan_every == 0):
            t_plan = time.perf_counter()
            key = (epoch - epoch % cfg.replan_every if cfg.replan_every
                   else 0)
            rand = plan_rand(key, u.shape[0]) if plan_rand else None
            if epoch_bias:
                tl, d, u_s, i_s = pdv.epoch_tiles_device(
                    skel, u, i, r, seed, key, rand=rand, with_slots=True)
                deg_u = torch.bincount(u_s, minlength=bu.shape[0]).float()
                deg_i = torch.bincount(i_s, minlength=bi.shape[0]).float()
            else:
                tl = pdv.epoch_tiles_device(skel, u, i, r, seed, key,
                                            rand=rand)
            if timings is not None:
                sync()
                timings["plan_s"] += time.perf_counter() - t_plan
        sse = torch.zeros((), dtype=torch.float32, device=dev)
        for (win0, nw), grp in zip(dense_meta, dense_groups):
            seg = slice(win0 * si, (win0 + nw) * si)
            if dense_bias != "frozen":
                sse = sse + timed("dense_s", lambda: dense_phase(
                    P, Q[seg], grp, lr, cfg.reg, mu, su=su, si=si,
                    bias=dense_bias, deps=grp["deps"], echo=echo))
                continue
            # frozen biases: the group reads them at its start, then one
            # batched update, which the next group sees
            s, (dbu, dbi) = timed("dense_s", lambda: dense_phase(
                P, Q[seg], grp, lr, cfg.reg, mu, su=su, si=si, bias="frozen",
                bu=bu, bi=bi[seg], deps=grp["deps"]))
            sse = sse + s
            timed("bias_s", lambda: dense_bias_update(
                bu, bi[seg], grp, dbu, dbi, lr, cfg.reg, su=su, si=si))

        def sparse(sse):
            for sw in sweeps:
                seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
                sse = sse + run_sweep(sw, seg, lr)
            return sse

        sse = timed("sparse_s", sparse, sse)
        if epoch_bias:
            timed("bias_s", epoch_bias_update, lr)
        read_marks()
        yield epoch, canonical(), torch.sqrt(sse / max(1, n_train))
