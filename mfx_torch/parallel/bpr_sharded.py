"""Sharded-table BPR, the counterpart of ``mfx/parallel/bpr_sharded.py``
for a ring of one shard: the fused DSGD-ring path of the
``billion_bpr_sharded`` preset with ``parallel.model_axis=1``.

Triples are stratified by (user block, positive-item window) with the
ring planner (``kernels.plan_ring_device``); each triple's negative is an
exact uniform draw from the positive's item window minus the user's
positives (``window_negatives``). With the item table relabelled by a
seeded random permutation (``item_shuffle``) a window is a uniform random
subset of the catalog. One epoch is the epoch's window negatives, the
tile stream, and one ``bpr_sweep`` per segment of windows, in order. With
one shard the reference's ``ppermute`` and ``psum`` are the identity.
Rings of more shards (ROADMAP Queue 1 item 13) and the
snapshot-minibatch path (``bpr.kernel='jnp'``, Queue 1 item 12) are not
ported and are refused.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np
import torch

from mfx_torch.config import BPRConfig
from mfx_torch.data.bpr import (build_positive_index_device, complement_draw,
                                lowerbound_2key)
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.kernels import plan_ring_device as prd
from mfx_torch.kernels.bpr_sweep import bpr_sweep
from mfx_torch.kernels.packing import pad_rows
from mfx_torch.models.mf import MFModel
from mfx_torch.solvers.blocked import TPG, sweep_geometry

__all__ = ["item_shuffle", "window_negative_bounds", "window_negatives",
           "neg_generator", "RingState", "ring_state", "ring_epoch_tiles",
           "train_epochs_bpr_ring"]


def item_shuffle(num_items: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded random relabeling of item ids (forward, inverse)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x17E11]))
    fwd = rng.permutation(num_items).astype(np.int32)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(num_items, dtype=np.int32)
    return fwd, inv


def window_negative_bounds(u, irel, pu, pi, *, si: int, num_items: int):
    """Run-constant per-rating bounds for the window complement draw:
    (wstart, start, cnt, navail), where ``[start, start + cnt)`` slices the
    sorted positive index to the (user, window) cell and ``navail`` is the
    number of non-positive real items in the window."""
    wstart = (irel // si) * si
    start = lowerbound_2key(pu, pi, u, wstart)
    end = lowerbound_2key(pu, pi, u, wstart + si)
    cnt = end - start
    span = torch.clamp(num_items - wstart, max=si)
    return wstart, start, cnt, (span - cnt).to(torch.int32)


def window_negatives(irel, pi, wstart, start, cnt, navail, *, si: int,
                     x=None, generator: torch.Generator | None = None):
    """Exact negatives from each positive's item window: one complement
    draw each (``x`` ~ U[0, navail), given or drawn from ``generator``).
    A cell whose every real window item is a positive (navail == 0) gets
    the positive itself: the triple then only decays its rows."""
    return complement_draw(pi, start, cnt, navail, wstart, irel, x=x,
                           generator=generator,
                           steps=max(1, si.bit_length()))


def neg_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The epoch's negative-draw generator, seeded from (seed, epoch)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 0xB9 * 7919 + int(epoch))
                  & 0x7FFF_FFFF_FFFF)
    return g


def _unsupported(cfg: BPRConfig, shards: int) -> None:
    if getattr(cfg, "neg_weighting", "uniform") != "uniform":
        raise ValueError(
            "the ring's block-stratified samplers are uniform-exact by "
            "construction; bpr.neg_weighting='popularity' runs on the "
            "snapshot-minibatch paths (parallel.mode 'single' or 'dp')"
        )
    if shards != 1:
        raise NotImplementedError(
            f"mfx_torch BPR ring: {shards} shards; only a ring of one shard "
            "is ported (ROADMAP Queue 1 item 13)"
        )
    if cfg.kernel != "pallas":
        raise NotImplementedError(
            f"mfx_torch BPR ring: bpr.kernel={cfg.kernel!r}; only the fused "
            "kernel path is ported (the snapshot-minibatch ring is ROADMAP "
            "Queue 1 item 12)"
        )


@dataclasses.dataclass
class RingState:
    """The run-constant state of the fused ring: the relabelled, padded
    tables (updated in place by the sweeps), the device ids and positive
    index, the window bounds of every rating, and the plan skeleton."""

    P: torch.Tensor  # (S·ublock, rank) user table
    Q: torch.Tensor  # (S·iblock, rank) item table in the shuffled labelling
    fwd: torch.Tensor  # (I,) int64 original -> shuffled item id
    u: torch.Tensor  # (n,) int32 users of the training positives
    irel: torch.Tensor  # (n,) int32 shuffled items of the positives
    pi: torch.Tensor  # items of the sorted positive index
    bounds: tuple  # (wstart, start, cnt, navail) per positive
    skel: prd.RingSkeleton
    su: int
    si: int

    def segments(self):
        """(win0, nwin, sa, tc, deps) of each segment, for a ring of one
        shard."""
        return [(seg.win0, seg.nwin, seg.sa[0, 0].contiguous(),
                 seg.tc[0, 0].contiguous(), seg.deps[0][0])
                for seg in self.skel.segments]


def ring_state(model: MFModel, train: RatingsCOO, cfg: BPRConfig,
               shards: int = 1, seed: int = 0,
               device: torch.device | str | None = None) -> RingState:
    """Once per run: relabel and pad the tables, move the positives to
    ``device`` (default the model's), build the positive index, the window
    bounds and the plan skeleton."""
    _unsupported(cfg, shards)
    dev = torch.device(device) if device is not None else model.device
    S = shards
    U, I = train.num_users, train.num_items
    su, si = cfg.ublock, cfg.iblock
    ublock = -(-(-(-U // S)) // su) * su
    iblock = -(-(-(-I // S)) // si) * si
    nwin = sweep_geometry(iblock, model.rank, si)

    # per-run random item relabel: ring blocks and their windows become
    # uniform random catalog subsets; internal row j = original row inv[j]
    fwd, inv = item_shuffle(I, seed)
    fwd_t = torch.as_tensor(fwd, device=dev).long()
    P = pad_rows(model.P.to(dev, torch.float32), S * ublock)
    Q = pad_rows(model.Q.to(dev, torch.float32)[
        torch.as_tensor(inv, device=dev).long()], S * iblock)
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    irel = fwd_t.to(torch.int32)[torch.as_tensor(train.item).to(dev).long()]
    pu, pi = build_positive_index_device(u, irel)
    bounds = window_negative_bounds(u, irel, pu, pi, si=si, num_items=I)
    del pu
    skel = prd.build_ring_skeleton(u, irel, S, ublock, iblock, su, si,
                                   cfg.tile, TPG, nwin)
    return RingState(P=P, Q=Q, fwd=fwd_t, u=u, irel=irel, pi=pi,
                     bounds=bounds, skel=skel, su=su, si=si)


def ring_epoch_tiles(st: RingState, cfg: BPRConfig, seed: int, epoch: int,
                     plan_rand=None, neg_rand=None,
                     timings: dict | None = None) -> list[torch.Tensor]:
    """One epoch's tile slabs (one per segment): the window negatives,
    then the ring plan with them in row 2. ``plan_rand`` / ``neg_rand``
    as in :func:`train_epochs_bpr_ring`; ``timings`` gets ``neg_s``
    and ``plan_s`` (each waiting for the device)."""
    dev = st.u.device

    def mark(name, t0):
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if neg_rand is not None:
        x, gen = neg_rand(epoch, st.bounds[3]).to(dev), None
    else:
        x, gen = None, neg_generator(seed + cfg.neg_seed, epoch, dev)
    j = window_negatives(st.irel, st.pi, *st.bounds, si=st.si, x=x,
                         generator=gen)
    mark("neg_s", t0)
    t0 = time.perf_counter()
    rand = plan_rand(epoch, st.u.shape[0]) if plan_rand else None
    tls = prd.epoch_tiles_ring(st.skel, st.u, st.irel, None, seed, epoch,
                               payload2=j % st.si, sent2=st.si, rand=rand)
    mark("plan_s", t0)
    return tls


def train_epochs_bpr_ring(
    model: MFModel,
    train: RatingsCOO,
    cfg: BPRConfig,
    shards: int = 1,
    seed: int = 0,
    device: torch.device | str | None = None,
    timings: dict | None = None,
    plan_rand: Callable[[int, int], torch.Tensor] | None = None,
    neg_rand: Callable[[int, torch.Tensor], torch.Tensor] | None = None,
    start_epoch: int = 0,
) -> Iterator[tuple[int, MFModel, float]]:
    """Fused BPR epochs on a ring of ``shards`` (one) shard; yields
    ``(epoch, model, mean_loss)`` with the model in the original item
    labelling (fresh tensors) and the mean loss over ``train``. Only
    ``bpr.kernel='pallas'`` and one shard are ported; :func:`ring_state`
    refuses the rest.

    ``device`` defaults to the model's. ``timings``, if given, is filled
    with ``prep_s``, ``segment_tiles`` (per segment its tiles and the
    tiles on its longest dependency chain) and, per epoch, ``neg_s`` and
    ``plan_s`` (each waiting for the device). ``plan_rand(epoch, n)``
    supplies the within-stratum shuffle key (n int32) and
    ``neg_rand(epoch, navail)`` the uniform draws x ~ U[0, max(navail, 1))
    instead of the seeded torch generators; the parity tests pass the
    reference's ``jax.random`` numbers this way. Epochs run from
    ``start_epoch``; the item relabelling is the run's and the negatives
    and plans are seeded by epoch, so a run resumed there from the tables
    an unbroken run had repeats it bit for bit.
    """
    t_prep = time.perf_counter()
    st = ring_state(model, train, cfg, shards=shards, seed=seed,
                    device=device)
    if timings is not None:
        if st.P.is_cuda:
            torch.cuda.synchronize(st.P.device)
        timings["prep_s"] = time.perf_counter() - t_prep
    segs = st.segments()
    if timings is not None:
        timings["segment_tiles"] = [(seg[4].n_tiles, seg[4].critical)
                                    for seg in segs]
    si, U = st.si, train.num_users
    for epoch in range(start_epoch, cfg.epochs):
        tls = ring_epoch_tiles(st, cfg, seed, epoch, plan_rand=plan_rand,
                               neg_rand=neg_rand, timings=timings)
        loss = torch.zeros((), dtype=torch.float32, device=st.P.device)
        for (win0, nw, sa, tc, deps), slab in zip(segs, tls):
            loss = loss + bpr_sweep(
                st.P, st.Q[win0 * si:(win0 + nw) * si], sa, tc, slab[0, 0],
                cfg.lr, cfg.reg, su=st.su, si=si, tpg=TPG, deps=deps,
            )
        del tls
        out = MFModel(st.P[:U].clone(), st.Q[st.fwd], model.bu, model.bi,
                      model.mu)
        yield epoch, out, float(loss) / max(1, train.n_ratings)
