"""Sharded-table BPR, the counterpart of ``mfx/parallel/bpr_sharded.py``
for a ring of one shard: the ``billion_bpr_sharded`` preset with
``parallel.model_axis=1``, by ``bpr.kernel``.

``'pallas'``, the fused DSGD-ring path: triples are stratified by (user
block, positive-item window) with the ring planner
(``kernels.plan_ring_device``); each triple's negative is an exact uniform
draw from the positive's item window minus the user's positives
(``window_negatives``). With the item table relabelled by a seeded random
permutation (``item_shuffle``) a window is a uniform random subset of the
catalog. One epoch is the epoch's window negatives, the tile stream, and
one ``bpr_sweep`` per segment of windows, in order.

``'jnp'``, the snapshot-minibatch ring: each epoch's (user, positive)
pairs are stratified into the S x S ring cells (``plan_bpr_ring_epoch`` on
the host, the reference's NumPy, or ``bpr_ring_epoch_device``) with exact
uniform negatives from the held item block, and each cell's batches run
through ``solvers.bpr.EpochRunner``, as the reference scans
``bpr_minibatch_update`` over them. Its tables keep the model's dtype
(f32 or bf16).

With one shard the reference's ``ppermute`` and ``psum`` are the
identity, and the whole catalog is the one block. Rings of more shards
(ROADMAP Queue 1 item 13) are refused, and so is
``bpr.neg_weighting='popularity'``, with the reference's own error.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np
import torch

from mfx_torch.config import BPRConfig
from mfx_torch.data.bpr import (MAX_REJECTION_ROUNDS, _members,
                                build_positive_index_device, complement_draw,
                                lowerbound_2key)
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.data.split import epoch_permutation
from mfx_torch.kernels import plan_ring_device as prd
from mfx_torch.kernels.bpr_sweep import bpr_sweep
from mfx_torch.kernels.packing import pad_rows
from mfx_torch.models.mf import MFModel
from mfx_torch.solvers.blocked import TPG, sweep_geometry
from mfx_torch.solvers.bpr import (EpochRunner, samples_on_device,
                                   seeded_generator)

__all__ = ["item_shuffle", "window_negative_bounds", "window_negatives",
           "neg_generator", "RingState", "ring_state", "ring_epoch_tiles",
           "BprRingPlan", "plan_bpr_ring_epoch", "BprRingSkeleton",
           "build_bpr_ring_skeleton", "bpr_ring_epoch_device",
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
    """The fused ring's negative-draw generator, seeded from (seed,
    epoch)."""
    return seeded_generator(seed, 0xB9, epoch, device)


def _unsupported(cfg: BPRConfig, shards: int) -> None:
    if cfg.neg_weighting != "uniform":
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


@dataclasses.dataclass
class BprRingPlan:
    users: np.ndarray  # [S, S, NB, B] local user ids
    pos: np.ndarray  # [S, S, NB, B] block-local positive item ids
    neg: np.ndarray  # [S, S, NB, B] block-local sampled negatives
    weights: np.ndarray  # [S, S, NB, B]
    ublock: int
    iblock: int
    n_real: int


def plan_bpr_ring_epoch(
    coo: RatingsCOO,
    S: int,
    batch_size: int,
    seed: int,
    epoch: int,
    item_map: np.ndarray | None = None,
    pos_keys: np.ndarray | None = None,
) -> BprRingPlan:
    """Stratify one epoch of (user, pos) pairs into the S×S ring schedule
    and sample block-local negatives. ``item_map`` is the forward relabel
    from item_shuffle (identity if None). ``pos_keys`` (sorted
    ``u * num_items + relabeled_i`` keys) makes negatives exact: samples
    colliding with a user's positives are block-locally resampled. The
    reference's NumPy, verbatim."""
    perm = epoch_permutation(coo.n_ratings, seed, epoch)
    ublock = -(-coo.num_users // S)
    iblock = -(-coo.num_items // S)
    u = coo.user[perm].astype(np.int64)
    i = coo.item[perm].astype(np.int64)
    if item_map is not None:
        i = item_map[i].astype(np.int64)
    s_of = u // ublock
    b_of = i // iblock
    t_of = (b_of - s_of) % S
    key = t_of * S + s_of
    sorter = np.argsort(key, kind="stable")
    u, i, key, b_of = u[sorter], i[sorter], key[sorter], b_of[sorter]

    counts = np.bincount(key, minlength=S * S)
    nb = max(1, int(-(-counts.max() // batch_size)))
    width = nb * batch_size
    users = np.zeros((S * S, width), np.int32)
    pos = np.zeros((S * S, width), np.int32)
    weights = np.zeros((S * S, width), np.float32)
    offsets = np.zeros(S * S + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    slot = np.arange(len(u), dtype=np.int64) - offsets[key]
    users[key, slot] = (u % ublock).astype(np.int32)
    pos[key, slot] = (i % iblock).astype(np.int32)
    weights[key, slot] = 1.0

    # block-local negatives: uniform over the real rows of the block each
    # (t, s) cell holds; block b may be partial at the catalog tail
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xBB5D, epoch]))
    neg = rng.integers(0, iblock, size=(S * S, width), dtype=np.int32)
    cell_block = np.empty(S * S, np.int64)
    for t in range(S):
        for s in range(S):
            cell_block[t * S + s] = (s + t) % S
    block_rows = np.minimum(
        coo.num_items - cell_block * iblock, iblock
    ).astype(np.int64)
    block_rows = np.maximum(block_rows, 1)
    neg = (neg % block_rows[:, None]).astype(np.int32)

    if pos_keys is not None:
        # global ids per slot: user = s*ublock + local; item (relabeled
        # space) = held_block*iblock + local
        s_of_cell = (np.arange(S * S, dtype=np.int64) % S)[:, None]
        gu = users.astype(np.int64) + s_of_cell * ublock
        gbase = (cell_block * iblock)[:, None]
        qk = (gu * coo.num_items + gbase + neg).reshape(-1)
        real = (weights > 0).reshape(-1)
        idx = np.flatnonzero(real & _members(pos_keys, qk))
        rounds = 0
        while idx.size and rounds < MAX_REJECTION_ROUNDS:
            cells = idx // width
            draw = (
                rng.integers(0, iblock, size=idx.size, dtype=np.int64)
                % block_rows[cells]
            ).astype(np.int32)
            neg.reshape(-1)[idx] = draw
            qk_new = (
                gu.reshape(-1)[idx] * coo.num_items
                + cell_block[cells] * iblock
                + draw
            )
            idx = idx[_members(pos_keys, qk_new)]
            rounds += 1

    shape = (S, S, nb, batch_size)
    return BprRingPlan(
        users=users.reshape(shape),
        pos=pos.reshape(shape),
        neg=neg.reshape(shape),
        weights=weights.reshape(shape),
        ublock=ublock,
        iblock=iblock,
        n_real=len(u),
    )


@dataclasses.dataclass
class BprRingSkeleton:
    """The snapshot-minibatch ring's run-constant device state: the cells'
    occupancy does not depend on the permutation, so the padded batch
    geometry is fixed and each epoch is one seeded device sort and scatter
    plus the complement draws (:func:`bpr_ring_epoch_device`)."""

    S: int
    ublock: int
    iblock: int
    nb: int
    width: int  # nb * per-shard batch size
    n_real: int
    strat_start: torch.Tensor  # (S*S,) exclusive cumsum of cell counts
    cell_block: torch.Tensor  # (S*S,) item block held by each cell
    block_rows: torch.Tensor  # (S*S,) real rows of that block
    s_of_cell: torch.Tensor  # (S*S,) shard of each cell
    pu: torch.Tensor  # sorted positive pairs (relabelled item space)
    pi: torch.Tensor


def _ring_cells(u, irel, S: int, ublock: int, iblock: int) -> torch.Tensor:
    """Each positive's ring cell ``t * S + s`` (int64)."""
    s_of = u.long() // ublock
    return ((irel.long() // iblock - s_of) % S) * S + s_of


def build_bpr_ring_skeleton(u_dev, irel_dev, S: int, num_users: int,
                            num_items: int, batch_size: int
                            ) -> BprRingSkeleton:
    """Once per run, on the ids' device: the cells' counts (one host read),
    the batch geometry and the sorted positive pairs."""
    ublock = -(-num_users // S)
    iblock = -(-num_items // S)
    cell = _ring_cells(u_dev, irel_dev, S, ublock, iblock)
    counts = torch.bincount(cell, minlength=S * S).cpu().numpy().astype(
        np.int64)
    nb = max(1, int(-(-counts.max() // batch_size)))
    width = nb * batch_size
    if S * S * width >= 2**31:
        raise NotImplementedError(
            "BPR ring batch slabs exceed int32 addressing at this scale; "
            "raise bpr.batch_size or plan per-host shards (each host "
            "builds only its user shard's cells)"
        )
    strat_start = np.zeros(S * S, np.int64)
    np.cumsum(counts[:-1], out=strat_start[1:])
    cell_block = np.array([(s + t) % S for t in range(S) for s in range(S)],
                          np.int64)
    block_rows = np.maximum(
        np.minimum(num_items - cell_block * iblock, iblock), 1)
    pu, pi = build_positive_index_device(u_dev, irel_dev)
    dev = u_dev.device

    def put(x):
        return torch.as_tensor(x.astype(np.int32), device=dev)

    return BprRingSkeleton(
        S=S, ublock=ublock, iblock=iblock, nb=nb, width=width,
        n_real=int(counts.sum()), strat_start=put(strat_start),
        cell_block=put(cell_block), block_rows=put(block_rows),
        s_of_cell=put(np.arange(S * S, dtype=np.int64) % S), pu=pu, pi=pi)


def bpr_ring_epoch_device(skel: BprRingSkeleton, u_dev, irel_dev, seed: int,
                          epoch: int, batch_size: int, plan_rand=None,
                          neg_rand=None) -> dict:
    """One epoch's ring batches on the ids' device, the reference's
    ``_bpr_ring_epoch_device``: the positives sorted stably by (cell,
    random int32 key), so each cell's are shuffled, scattered into the
    cells' padded slabs, and given exact uniform negatives from the held
    block (one complement draw each; a user who rated the whole block gets
    the positive). The keys are ``plan_rand(epoch, n)`` and the draws
    ``neg_rand(epoch, navail)`` (navail: each slot's complement size, pad
    slots included, which draw for user 0 of their shard) where given,
    else from torch generators seeded from (seed, epoch). Returns
    ``{users, pos, neg, weights}`` of shape (S, S, nb, B)."""
    S, ublock, iblock, width = skel.S, skel.ublock, skel.iblock, skel.width
    dev = u_dev.device
    n = u_dev.shape[0]
    cell = _ring_cells(u_dev, irel_dev, S, ublock, iblock)
    if plan_rand is not None:
        rand = plan_rand(epoch, n).to(dev, torch.int32)
    else:
        rand = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                             device=dev,
                             generator=seeded_generator(seed, 0x5F, epoch,
                                                        dev))
    order = torch.sort((cell << 32) + (rand.long() + 2**31),
                       stable=True).indices
    cell_s = cell[order]
    slot = (torch.arange(n, device=dev) - skel.strat_start.long()[cell_s]
            + cell_s * width)
    flat = S * S * width
    users = torch.zeros(flat, dtype=torch.int32, device=dev)
    positems = torch.zeros(flat, dtype=torch.int32, device=dev)
    weights = torch.zeros(flat, dtype=torch.float32, device=dev)
    users[slot] = (u_dev.long()[order] % ublock).to(torch.int32)
    positems[slot] = (irel_dev.long()[order] % iblock).to(torch.int32)
    weights[slot] = 1.0
    users = users.view(S * S, width)
    positems = positems.view(S * S, width)
    gu = users + skel.s_of_cell[:, None] * ublock
    gbase = (skel.cell_block * iblock)[:, None].expand_as(gu).contiguous()
    start = lowerbound_2key(skel.pu, skel.pi, gu, gbase)
    end = lowerbound_2key(skel.pu, skel.pi, gu,
                          gbase + skel.block_rows[:, None])
    cnt = end - start
    navail = skel.block_rows[:, None] - cnt
    if neg_rand is not None:
        x, gen = (lambda nav: neg_rand(epoch, nav)), None
    else:
        x, gen = None, seeded_generator(seed, 0xBB5D, epoch, dev)
    jg = complement_draw(skel.pi, start, cnt, navail, gbase,
                         gbase + positems, x=x, generator=gen)
    shape = (S, S, skel.nb, batch_size)
    return {"users": users.view(shape), "pos": positems.view(shape),
            "neg": (jg - gbase).view(shape),
            "weights": weights.view(shape)}


def _train_epochs_bpr_ring_jnp(model, train, cfg, shards, seed, device,
                               plan_rand, neg_rand, start_epoch):
    """The ``bpr.kernel='jnp'`` ring (see :func:`train_epochs_bpr_ring`)."""
    dev = torch.device(device) if device is not None else model.device
    S = shards
    U, I = train.num_users, train.num_items
    fwd, inv = item_shuffle(I, seed)
    fwd_t = torch.as_tensor(fwd, device=dev).long()
    use_dev = samples_on_device(cfg, dev)
    per_shard_bs = -(-cfg.batch_size // S)
    nseed = seed + cfg.neg_seed
    if use_dev:
        # the skeleton once; then each epoch is a seeded device sort and
        # scatter and the complement draws, no host work with the data
        u_dev = torch.as_tensor(train.user).to(dev, torch.int32)
        irel_dev = fwd_t.to(torch.int32)[
            torch.as_tensor(train.item).to(dev).long()]
        skel = build_bpr_ring_skeleton(u_dev, irel_dev, S, U, I,
                                       per_shard_bs)
        n_real = skel.n_real
    else:
        # exact negatives: positive-key index in the relabelled item space
        pos_keys = np.sort(train.user.astype(np.int64) * I + fwd[train.item])
        n_real = train.n_ratings
    # internal Q[j] = Q_orig[inv[j]]; one shard pads no row
    run = EpochRunner(model.P.to(dev), model.Q.to(dev)[
        torch.as_tensor(inv, device=dev).long()], cfg.lr, cfg.reg)
    bu, bi = model.bu.to(dev), model.bi.to(dev)
    for epoch in range(start_epoch, cfg.epochs):
        if use_dev:
            arrays = bpr_ring_epoch_device(skel, u_dev, irel_dev, nseed,
                                           epoch, per_shard_bs,
                                           plan_rand=plan_rand,
                                           neg_rand=neg_rand)
        else:
            plan = plan_bpr_ring_epoch(train, S, per_shard_bs, nseed, epoch,
                                       item_map=fwd, pos_keys=pos_keys)
            arrays = {k: torch.from_numpy(getattr(plan, k)).to(dev)
                      for k in ("users", "pos", "neg", "weights")}
        # one shard: the cell (t, s) = (0, 0) holds every batch
        loss = run.run({k: v[0, 0] for k, v in arrays.items()})
        del arrays
        yield (epoch, MFModel(run.P.clone(), run.Q[fwd_t], bu, bi, model.mu),
               float(loss) / max(1, n_real))


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
    """BPR epochs on a ring of ``shards`` (one) shard, by ``cfg.kernel``
    (module docstring); yields ``(epoch, model, mean_loss)`` with the model
    in the original item labelling (fresh tensors) and the mean loss over
    ``train``. More shards and popularity negatives are refused.

    ``device`` defaults to the model's. ``plan_rand(epoch, n)`` supplies
    the within-stratum shuffle key (n int32) and ``neg_rand(epoch,
    navail)`` the uniform draws x ~ U[0, max(navail, 1)) instead of the
    seeded torch generators; the parity tests pass the reference's
    ``jax.random`` numbers this way (``'jnp'`` reads them only when it
    samples on the device: ``cfg.sample_device`` 'device', or 'auto' on
    the card; on the host it draws the reference's NumPy plan). Epochs run
    from ``start_epoch``; the item relabelling is the run's and the
    negatives and plans are seeded by epoch, so a run resumed there from
    the tables an unbroken run had repeats it bit for bit. ``timings``
    (``'pallas'`` only), if given, is filled with ``prep_s``,
    ``segment_tiles`` (per segment its tiles and the tiles on its longest
    dependency chain) and, per epoch, ``neg_s`` and ``plan_s`` (each
    waiting for the device).
    """
    if cfg.kernel == "jnp":
        _unsupported(cfg, shards)
        yield from _train_epochs_bpr_ring_jnp(
            model, train, cfg, shards, seed, device, plan_rand, neg_rand,
            start_epoch)
        return
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
