"""Minibatch SGD solver, the counterpart of ``mfx/solvers/sgd.py``
(``EpochPlan``, ``plan_epoch``, ``make_epoch_fn``, ``train_epochs``).

The epoch's partition is prepared on the host (``mfx_torch.data.partition``)
and uploaded once as fixed-shape ``[num_batches, B]`` tensors. The
reference scans them as one XLA program; the port runs the batches in
order, each a handful of stock torch ops (``kernels.minibatch``): on the
card one replay a batch of the step captured as a CUDA graph, on the CPU
dispatched op by op. There is no host sync inside an epoch: the train RMSE
is read once an epoch. The reference's filler batches (``_bucket``) only
bound its XLA recompiles and change no table bit, so the port plans
without them.

Kernel dispatch: ``'jnp'`` is this path (the reference's XLA gather /
scatter step), the only kernel the reference wires for it;
``partitioner='blocked'`` goes to ``mfx_torch.solvers.blocked``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from mfx_torch.config import SGDConfig
from mfx_torch.data import partition as part
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.data.split import epoch_permutation
from mfx_torch.kernels import minibatch as mb
from mfx_torch.models.mf import MFModel
from mfx_torch.solvers.capture import CapturedLoop

__all__ = ["EpochPlan", "plan_epoch", "make_epoch_fn", "train_epochs"]


@dataclasses.dataclass
class EpochPlan:
    """Device-ready epoch tensors: dict of [num_batches, B] tensors plus the
    count of real (non-padding) ratings."""

    batches: dict[str, torch.Tensor]
    n_real: int

    @property
    def num_batches(self) -> int:
        return self.batches["users"].shape[0]

    @property
    def batch_size(self) -> int:
        return self.batches["users"].shape[1]


def plan_epoch(
    coo: RatingsCOO, cfg, seed: int, epoch: int,
    device: torch.device | str = "cuda",
    extras: dict[str, np.ndarray] | None = None,
) -> EpochPlan:
    """Partition one epoch of ratings into padded batches on ``device``:
    the reference's plan with ``bucket=False``. ``extras``: more per-rating
    columns batched in the same order, zero in pads (the temporal model's
    bins and deviations)."""
    perm = epoch_permutation(coo.n_ratings, seed, epoch)
    if cfg.partitioner == "fixed":
        order: np.ndarray | list[np.ndarray] = perm
    elif cfg.partitioner == "conflict_free":
        order = part.partition_conflict_free(coo.user, coo.item, cfg.batch_size, perm)
    else:
        raise ValueError(
            f"plan_epoch handles 'fixed'/'conflict_free'; got {cfg.partitioner!r}"
            " (blocked partitions are planned by mfx_torch.kernels.plan_device)"
        )
    arrays = part.pad_to_batches(
        coo.user, coo.item, coo.rating, order, cfg.batch_size,
        num_users=coo.num_users, num_items=coo.num_items, extras=extras,
    )
    return EpochPlan(
        batches={k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
        n_real=coo.n_ratings,
    )


def _tables(model: MFModel):
    return model.P, model.Q, model.bu, model.bi


def _step(tabs, mu, u, i, r, w, cu, ci, lr, reg, sse, *, use_bias,
          unique_rows, dup_trust):
    """One batch on the tables ``tabs`` in place; its squared error is
    added to ``sse``."""
    P, Q, bu, bi = tabs
    d_pu, d_qi, d_bu, d_bi, sq = mb.deltas(P, Q, bu, bi, mu, u, i, r, w, lr,
                                           reg, use_bias)
    sse.add_(sq)
    mb.apply(P, Q, bu, bi, u, i, d_pu, d_qi, d_bu, d_bi, use_bias=use_bias,
             unique_rows=unique_rows, dup_trust=dup_trust, cu=cu, ci=ci)


def _epoch_inputs(model: MFModel, plan: EpochPlan, trust: bool) -> dict:
    """The plan's batches as the step reads them: int64 row ids of the
    tables with ``B`` sink rows (a sentinel pad ``num_rows + slot`` has a
    sink of its own), and with ``dup_trust`` the ids it counts."""
    b = plan.batches
    B = plan.batch_size
    out = {"u": mb.clamp_ids(b["users"], model.num_users + B),
           "i": mb.clamp_ids(b["items"], model.num_items + B),
           "r": b["ratings"], "w": b["weights"]}
    if trust:
        out["cu"] = mb.count_ids(b["users"], b["weights"])
        out["ci"] = mb.count_ids(b["items"], b["weights"])
    return out


class _CapturedStep:
    """The per-batch step on static tables (with their sink rows), replayed
    once a batch as a CUDA graph on the card (:class:`CapturedLoop`): an
    epoch is a copy of the tables and the plan into static buffers and one
    replay a batch. Recaptured when the tables' shapes, the batch size or
    ``mu`` change, or an epoch has more batches than the buffers hold."""

    def __init__(self, model: MFModel, plan: EpochPlan, reg: float,
                 step_kw: dict, trust: bool):
        dev = model.device
        self.key = self.key_of(model, plan)
        self.tabs = mb.with_sinks([torch.zeros_like(t)
                                   for t in _tables(model)], plan.batch_size)
        self.rows = (model.num_users, model.num_items) * 2
        self.sse = torch.zeros((), dtype=torch.float32, device=dev)
        # lr and reg in the tables' dtype, as the reference casts them
        self.lr = torch.zeros((), dtype=model.P.dtype, device=dev)
        self.reg = mb.as_scalar(reg, dev, model.P.dtype)
        mu = model.mu

        def step(row):
            _step(self.tabs, mu, row["u"], row["i"], row["r"], row["w"],
                  row.get("cu"), row.get("ci"), self.lr, self.reg, self.sse,
                  **step_kw)

        # captured on zero tables and weights (the warm-up's a no-op step)
        self.loop = CapturedLoop(step, _epoch_inputs(model, plan, trust), dev)

    @staticmethod
    def key_of(model: MFModel, plan: EpochPlan):
        return (tuple(model.P.shape), tuple(model.Q.shape), plan.batch_size,
                model.mu, model.device, model.P.dtype)

    def fits(self, model: MFModel, plan: EpochPlan) -> bool:
        return (self.key == self.key_of(model, plan)
                and plan.num_batches <= self.loop.cap)

    def run(self, model: MFModel, plan: EpochPlan, lr: float, trust: bool):
        for t, src, n in zip(self.tabs, _tables(model), self.rows):
            t[:n].copy_(src)
            t[n:].zero_()
        self.sse.zero_()
        self.lr.fill_(lr)
        self.loop.run(_epoch_inputs(model, plan, trust))
        return ([t[:n].clone() for t, n in zip(self.tabs, self.rows)],
                self.sse.clone())


def make_epoch_fn(cfg: SGDConfig, use_bias: bool, graph: bool | None = None):
    """Returns ``epoch_fn(model, plan, lr) -> (model, train_sse)``: one pass
    over the plan's batches in order on copies of the model's tables (the
    input model is left as it was); ``train_sse`` is a 0-d f32 tensor on
    the model's device, the batches' squared errors summed in order.

    ``graph`` (default: on the card) replays the step as a CUDA graph
    (:class:`_CapturedStep`); otherwise each batch's ops are dispatched from
    the host. Both run the same kernels in the same order: the same
    bits."""
    unique_rows = cfg.partitioner == "conflict_free"
    if cfg.kernel != "jnp":
        raise ValueError(
            f"unknown/unwired kernel {cfg.kernel!r} for plan_epoch path")
    trust = cfg.dup_trust > 0.0 and not unique_rows
    step_kw = dict(use_bias=use_bias, unique_rows=unique_rows,
                   dup_trust=cfg.dup_trust)
    captured: list[_CapturedStep] = []

    def epoch_fn(model: MFModel, plan: EpochPlan, lr: float):
        dev = model.device
        if graph if graph is not None else dev.type == "cuda":
            if not captured or not captured[0].fits(model, plan):
                captured[:] = [_CapturedStep(model, plan, cfg.reg, step_kw,
                                             trust)]
            tabs, sse = captured[0].run(model, plan, lr, trust)
            return MFModel(*tabs, model.mu), sse
        tabs = mb.with_sinks(_tables(model), plan.batch_size)
        dt = model.P.dtype
        lr_t, reg_t = mb.as_scalar(lr, dev, dt), mb.as_scalar(cfg.reg, dev,
                                                               dt)
        x = _epoch_inputs(model, plan, trust)
        sse = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(plan.num_batches):
            _step(tabs, model.mu, x["u"][k], x["i"][k], x["r"][k],
                  x["w"][k], x["cu"][k] if trust else None,
                  x["ci"][k] if trust else None, lr_t, reg_t, sse, **step_kw)
        U, I = model.num_users, model.num_items
        return MFModel(tabs[0][:U], tabs[1][:I], tabs[2][:U], tabs[3][:I],
                       model.mu), sse

    return epoch_fn


def train_epochs(
    model: MFModel,
    train: RatingsCOO,
    cfg: SGDConfig,
    use_bias: bool,
    seed: int = 0,
    start_epoch: int = 0,
    timings: dict | None = None,
    device: torch.device | str | None = None,
) -> Iterator[tuple[int, MFModel, float]]:
    """Generator driving SGD epochs from ``start_epoch``; yields ``(epoch,
    model, train_rmse)``. On the blocked path ``train_rmse`` is a 0-d
    tensor (reading it waits for the epoch, see
    ``solvers.blocked.train_epochs_blocked``, which also fills
    ``timings``); here a float, read once an epoch. ``device`` defaults to
    the model's.

    The lr schedule and the epoch-seeded plans follow the epoch number, so
    a run resumed at ``start_epoch`` from the tables an unbroken run had
    there repeats that run bit for bit.
    """
    if cfg.partitioner == "blocked":
        from mfx_torch.solvers.blocked import train_epochs_blocked

        yield from train_epochs_blocked(
            model, train, cfg, use_bias, seed=seed, start_epoch=start_epoch,
            timings=timings, device=device,
        )
        return
    epoch_fn = make_epoch_fn(cfg, use_bias)
    dev = torch.device(device) if device is not None else model.device
    if model.device != dev:
        model = MFModel(*(t.to(dev) for t in _tables(model)), model.mu)
    for epoch in range(start_epoch, cfg.epochs):
        lr = cfg.lr * (cfg.lr_decay**epoch)
        plan = plan_epoch(train, cfg, seed, epoch, device=dev)
        model, sse = epoch_fn(model, plan, lr)
        train_rmse = float(torch.sqrt(sse / max(1, plan.n_real)))
        yield epoch, model, train_rmse
