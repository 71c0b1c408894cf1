"""Device-side epoch tile planning, the counterpart of
``mfx/kernels/plan_device.py``.

A rating's stratum (user block × item window) depends only on its ids, so
the plan splits into a **skeleton** built once per run (per-stratum counts
by one device ``bincount``, then O(strata) host arithmetic: tile counts,
user-block runs padded to ``tpg`` tiles, the per-step user block ``sa`` and
the per-tile window ``tc``) and a **per-epoch pass** (a stable device sort
on (stratum, random) with the ratings riding along, then a scatter into
the padded ``(NT, 3, T)`` int32 tile stream). Row 0 of a tile holds the
block-local user id, row 1 the window-local item id, row 2 the f32 rating
bit-cast to int32; pad slots hold ``u = su`` and ``i = si``.

The random key is a signed int32 compared as such, as the reference's
``lax.sort(num_keys=2, is_stable=True)`` does, so the port rebuilds the
reference's tile stream bit for bit when it is handed the reference's
random bits (``epoch_tiles_device(..., rand=...)``).

The skeleton also carries each sweep's **dependency table**
(:class:`SweepDeps`, :func:`sweep_deps`), with which the sweep kernels
walk a sweep on many SMs and still produce the plan-order result. A tile
reads and writes only the P rows of its user block and the Q rows of its
window, so two tiles conflict only if they share one of the two. The
tiles of one user block are contiguous in the stream (a *run*, walked
front to back by one thread block), and a stratum's first tile waits for
the last tile of the nearest earlier run with a non-empty stratum in the
same window. Any execution that keeps those two orders reads and writes
the values the plan-order walk does.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

__all__ = ["PlanSkeleton", "SweepSlice", "SweepDeps", "build_plan_skeleton",
           "epoch_tiles_device", "epoch_rand", "sweep_deps", "chain_depths",
           "critical_path", "wavefront_order"]


@dataclasses.dataclass
class SweepDeps:
    """The order a sweep's tiles must keep beyond "front to back inside a
    run"; the tensors live on the plan's device."""

    runs: torch.Tensor  # (R, 2) int32: first tile and tile count of each run
    # (nt, 3) int32 per tile: do not gather before run ``wait[t, 0]`` has
    # finished ``wait[t, 1]`` of its tiles, (-1, 0) where nothing is
    # waited for; ``wait[t, 2]`` is 1 where a later run may wait for this
    # tile's end (the last tile of a stratum)
    wait: torch.Tensor
    n_tiles: int  # tiles of the sweep, pad tiles included
    critical: int  # tiles on the longest dependency chain
    _orders: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def list_order(self, slots: int, parts: int, tail: int,
                   tail_cost: float, ring: int) -> torch.Tensor:
        """An order in which to hand out the tiles (strata) to ``slots``
        workers, each stratum as ``parts`` units of cost 1 that may start
        once its predecessors have finished (and the stratum handed out
        ``ring`` places before it), then ``tail`` units of cost
        ``tail_cost`` that start once its parts have: a greedy list
        schedule that takes next the stratum that can start soonest, the
        one with the longest chain still behind it first. Every stratum
        comes after all it waits for. An int32 tensor on the table's
        device, computed once for each set of arguments."""
        key = (slots, parts, tail, tail_cost, ring)
        if key not in self._orders:
            order = _list_schedule(self.runs.cpu().numpy(),
                                   self.wait.cpu().numpy(), *key)
            self._orders[key] = torch.as_tensor(order, dtype=torch.int32,
                                                device=self.runs.device)
        return self._orders[key]

    def prefix(self, nt: int) -> "SweepDeps":
        """The table of the sweep's first ``nt`` tiles (a wait only ever
        names an earlier run, so a prefix orders itself)."""
        runs = self.runs.cpu().numpy()
        runs = runs[runs[:, 0] < nt].copy()
        runs[:, 1] = np.minimum(runs[:, 1], nt - runs[:, 0])
        wait = self.wait[:nt].contiguous()
        return SweepDeps(
            runs=torch.as_tensor(runs, device=self.runs.device), wait=wait,
            n_tiles=nt, critical=critical_path(runs, wait.cpu().numpy()))


def chain_depths(runs: np.ndarray, wait: np.ndarray) -> np.ndarray:
    """Per tile, the tiles on the longest chain of the table that ends
    with it: a tile follows its run's previous tile and, where it waits,
    tile ``wait[t, 1] - 1`` of run ``wait[t, 0]``. A tile's depth exceeds
    that of every tile it follows, so sorting by depth gives an order the
    table allows."""
    finish = np.zeros(wait.shape[0], np.int64)
    for base, n in runs.tolist():
        w = wait[base:base + n]
        dep = np.where(w[:, 0] >= 0,
                       finish[runs[w[:, 0].clip(0), 0] + w[:, 1] - 1], 0)
        # finish[i] = max(finish[i - 1], dep[i]) + 1
        k = np.arange(n)
        finish[base:base + n] = k + 1 + np.maximum.accumulate(dep - k)
    return finish


def critical_path(runs: np.ndarray, wait: np.ndarray) -> int:
    """Tiles on the longest chain of the table (:func:`chain_depths`)."""
    return int(chain_depths(runs, wait).max(initial=0))


def _preds(runs: np.ndarray, wait: np.ndarray) -> list[list[int]]:
    """Per tile, the tiles it follows: its run's previous tile and the
    one its wait names."""
    first = np.zeros(wait.shape[0], bool)
    first[runs[:, 0]] = True
    named = np.where(wait[:, 0] >= 0,
                     runs[wait[:, 0].clip(0), 0] + wait[:, 1] - 1, -1)
    return [[p for p in ((t - 1) if not first[t] else -1, named[t]) if p >= 0]
            for t in range(wait.shape[0])]


def _list_schedule(runs, wait, slots, parts, tail, tail_cost, ring):
    """``SweepDeps.list_order``'s schedule, simulated on ``slots``
    workers that each take the next unit as they come free."""
    nd = wait.shape[0]
    preds = _preds(runs, wait)
    succs = [[] for _ in range(nd)]
    for t, ps in enumerate(preds):
        for p in ps:
            succs[p].append(t)
    behind = np.zeros(nd, np.int64)  # the longest chain from t to the end
    for t in range(nd - 1, -1, -1):
        behind[t] = 1 + max((behind[x] for x in succs[t]), default=0)
    left = np.array([len(p) for p in preds])
    ready_at = np.zeros(nd)
    finish = np.zeros(nd)
    free = [0.0] * slots
    cands = [t for t in range(nd) if left[t] == 0]
    order = []
    while cands:
        now = free[0]
        t = min(cands, key=lambda x: (max(ready_at[x], now), -behind[x], x))
        cands.remove(t)
        if len(order) >= ring:
            ready_at[t] = max(ready_at[t], finish[order[-ring]])
        end = 0.0
        for _ in range(parts):
            e = max(heapq.heappop(free), ready_at[t]) + 1.0
            end = max(end, e)
            heapq.heappush(free, e)
        done = end
        for _ in range(tail):
            e = max(heapq.heappop(free), end) + tail_cost
            done = max(done, e)
            heapq.heappush(free, e)
        finish[t] = done
        order.append(t)
        for x in succs[t]:
            ready_at[x] = max(ready_at[x], done)
            left[x] -= 1
            if left[x] == 0:
                cands.append(x)
    return np.asarray(order, np.int64)


def sweep_deps(tp: np.ndarray, run_len: np.ndarray, device) -> SweepDeps:
    """The dependency table of one sweep from its layout: ``tp`` (A, W)
    real tiles per (user block, window) stratum, ``run_len`` (A,) tiles of
    each user block's run in the stream (its strata in window order, then
    pad tiles, which touch nothing and wait for nothing). User blocks
    with no tiles have no run."""
    keep = np.flatnonzero(run_len > 0)
    tp, run_len = tp[keep].astype(np.int64), run_len[keep].astype(np.int64)
    R, W = tp.shape
    if R == 0:  # a sweep with no rating
        return SweepDeps(
            runs=torch.zeros((0, 2), dtype=torch.int32, device=device),
            wait=torch.zeros((0, 3), dtype=torch.int32, device=device),
            n_tiles=0, critical=0)
    base = np.cumsum(run_len) - run_len
    nt = int(run_len.sum())
    end = np.cumsum(tp, axis=1)  # tiles of the run done after the stratum
    filled = tp > 0
    # nearest earlier run with a non-empty stratum in the same window
    last = np.maximum.accumulate(
        np.where(filled, np.arange(R)[:, None], -1), axis=0)
    prev = np.vstack([np.full((1, W), -1, np.int64), last[:-1]])
    count = np.where(prev >= 0,
                     end[prev.clip(0), np.arange(W)[None, :]], 0)
    wait = np.tile(np.array([-1, 0, 0], np.int32), (nt, 1))
    first = (base[:, None] + end - tp)[filled]  # first tile of each stratum
    wait[first, 0] = prev[filled]
    wait[first, 1] = count[filled]
    wait[(base[:, None] + end - 1)[filled], 2] = 1
    runs = np.stack([base, run_len], axis=1).astype(np.int32)
    return SweepDeps(runs=torch.as_tensor(runs, device=device),
                     wait=torch.as_tensor(wait, device=device), n_tiles=nt,
                     critical=critical_path(runs, wait))


def wavefront_order(deps: SweepDeps, seed: int) -> np.ndarray:
    """A seeded random order of the sweep's tiles that the table allows:
    at every step one of the runs whose next tile may start, picked at
    random, advances by one tile. The tests replay the plain versions in
    such orders to show that the table is enough."""
    rng = np.random.default_rng(seed)
    runs = deps.runs.cpu().numpy()
    wait = deps.wait.cpu().numpy()
    done = np.zeros(runs.shape[0], np.int64)
    order = []
    while len(order) < deps.n_tiles:
        nxt = runs[:, 0] + done
        live = np.flatnonzero(done < runs[:, 1])
        w = wait[nxt[live]]
        ready = live[(w[:, 0] < 0) | (done[w[:, 0].clip(0)] >= w[:, 1])]
        r = int(rng.choice(ready))
        order.append(int(nxt[r]))
        done[r] += 1
    return np.asarray(order, np.int64)


@dataclasses.dataclass
class SweepSlice:
    """Static per-sweep view into the epoch tile stream."""

    win0: int
    nwin: int
    t0: int  # first tile (global index)
    t1: int  # one past the last tile
    n_real: int
    sa: torch.Tensor  # (nt / tpg,) int32 user block per group of tpg tiles
    tc: torch.Tensor  # (nt,) int32 sweep-local item window per tile
    deps: SweepDeps  # what orders the sweep's tiles on many SMs


@dataclasses.dataclass
class PlanSkeleton:
    su: int
    si: int
    tile: int
    tpg: int
    nwin: int
    nt_total: int
    sweeps: list[SweepSlice]
    # device constants for the per-epoch pass (sid = stratum id in
    # (sweep, user block, window-local) order)
    strat_start: torch.Tensor  # (NS,) int64 exclusive cumsum of counts
    pos_base: torch.Tensor  # (NS,) int64 first padded slot of each stratum
    offs_sweep: torch.Tensor  # (n_sweeps,) int64 sid offset per sweep
    nw_arr: torch.Tensor  # (n_sweeps,) int64 windows per sweep


def _sid_arrays(num_users, num_items, su, si, nwin):
    A = -(-num_users // su)
    C = -(-num_items // si)
    n_sweeps = -(-C // nwin)
    nw = np.minimum(nwin, C - np.arange(n_sweeps) * nwin).astype(np.int64)
    offs = np.zeros(n_sweeps + 1, np.int64)
    np.cumsum(A * nw, out=offs[1:])
    return A, C, n_sweeps, nw, offs


def _sid(u, i, offs_sweep, nw_arr, su, si, nwin):
    a = u.long() // su
    cg = i.long() // si
    s = cg // nwin
    return offs_sweep[s] + a * nw_arr[s] + (cg - s * nwin)


def build_plan_skeleton(
    u: torch.Tensor,
    i: torch.Tensor,
    num_users: int,
    num_items: int,
    su: int,
    si: int,
    tile: int,
    tpg: int,
    nwin: int,
) -> PlanSkeleton:
    """Once per run. ``u``/``i`` are the device-resident rating id arrays;
    every returned tensor lives on their device."""
    dev = u.device
    A, C, n_sweeps, nw, offs = _sid_arrays(num_users, num_items, su, si, nwin)
    ns = int(offs[-1])
    offs_dev = torch.as_tensor(offs[:-1], device=dev)
    nw_dev = torch.as_tensor(nw, device=dev)
    sid = _sid(u, i, offs_dev, nw_dev, su, si, nwin)
    counts = torch.bincount(sid, minlength=ns).cpu().numpy().astype(np.int64)

    strat_start = np.zeros(ns + 1, np.int64)
    np.cumsum(counts, out=strat_start[1:])

    tiles_per = -(-counts // tile)  # ceil; 0 for empty strata
    tile_base = np.zeros(ns, np.int64)
    sweeps: list[SweepSlice] = []
    t_cursor = 0
    for s in range(n_sweeps):
        nws = int(nw[s])
        lo, hi = int(offs[s]), int(offs[s + 1])
        tp = tiles_per[lo:hi].reshape(A, nws)
        real_per_a = tp.sum(axis=1)
        padded_per_a = -(-real_per_a // tpg) * tpg
        run_base = np.zeros(A + 1, np.int64)
        np.cumsum(padded_per_a, out=run_base[1:])
        nt = int(run_base[-1])
        within = np.cumsum(tp, axis=1) - tp
        tile_base[lo:hi] = (t_cursor + run_base[:-1, None] + within).reshape(-1)

        # sa: one user block per tpg tiles; tc: window per tile (pad tiles
        # sit at the end of each run with tc = 0 and sentinel slots)
        sa = np.repeat(np.arange(A, dtype=np.int32), padded_per_a // tpg)
        tc = np.zeros(nt, np.int32)
        tpf = tp.reshape(-1)
        strat_of_tile = np.repeat(np.arange(A * nws, dtype=np.int64), tpf)
        starts = np.cumsum(tpf) - tpf
        within_t = (np.arange(strat_of_tile.shape[0], dtype=np.int64)
                    - np.repeat(starts, tpf))
        real_ids = (tile_base[lo:hi] - t_cursor)[strat_of_tile] + within_t
        tc[real_ids] = (strat_of_tile % nws).astype(np.int32)

        sweeps.append(SweepSlice(
            win0=s * nwin, nwin=nws, t0=t_cursor, t1=t_cursor + nt,
            n_real=int(counts[lo:hi].sum()),
            sa=torch.as_tensor(sa, device=dev),
            tc=torch.as_tensor(tc, device=dev),
            deps=sweep_deps(tp, padded_per_a, dev),
        ))
        t_cursor += nt

    # the kernels address the tile stream with int32 offsets
    if t_cursor * tile * 3 >= 2**31:
        raise NotImplementedError(
            f"epoch tile stream ({t_cursor} tiles x {tile}) exceeds int32 "
            "addressing; split the epoch into item-range shards"
        )
    return PlanSkeleton(
        su=su, si=si, tile=tile, tpg=tpg, nwin=nwin, nt_total=t_cursor,
        sweeps=sweeps,
        strat_start=torch.as_tensor(strat_start[:-1], device=dev),
        pos_base=torch.as_tensor(tile_base * tile, device=dev),
        offs_sweep=offs_dev,
        nw_arr=nw_dev,
    )


def epoch_rand(n: int, seed: int, epoch: int, device) -> torch.Tensor:
    """The epoch's within-stratum shuffle key: n signed int32 values from
    a ``torch.Generator`` seeded from (seed, epoch)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(epoch)) & 0x7FFF_FFFF_FFFF)
    return torch.randint(-(2**31), 2**31, (n,), generator=g,
                         dtype=torch.int64, device=device).to(torch.int32)


def epoch_tiles_device(
    skel: PlanSkeleton,
    u: torch.Tensor,
    i: torch.Tensor,
    r: torch.Tensor,
    seed: int,
    epoch: int,
    rand: torch.Tensor | None = None,
    extras: tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """The per-epoch pass: the ``(NT, 3 + len(extras), T)`` int32 tile
    stream on the ids' device. ``rand`` (n int32 values) overrides the
    seeded shuffle key. ``extras`` are int32 per-rating payload rows (f32
    values bit-cast first) that ride the same sort and land as rows 3, 4,
    ... (0 in pads); slots do not depend on them, so rows 0-2 are bitwise
    the 3-row stream's."""
    n = u.shape[0]
    nrows = 3 + len(extras)
    if n and skel.nt_total * skel.tile * nrows >= 2**31:
        raise NotImplementedError(
            "tile stream exceeds int32 addressing; split the epoch into "
            "item-range shards"
        )
    dev = u.device
    su, si, T = skel.su, skel.si, skel.tile
    if rand is None:
        rand = epoch_rand(n, seed, epoch, dev)
    sid = _sid(u, i, skel.offs_sweep, skel.nw_arr, su, si, skel.nwin)
    # (sid, signed rand) as one int64 key; the stable sort breaks ties by
    # input order, as the reference's stable two-key sort does
    key = (sid << 32) | (rand.to(dev, torch.int64) + 2**31)
    order = torch.sort(key, stable=True).indices
    sid_s = sid[order]
    pos = torch.arange(n, device=dev) - skel.strat_start[sid_s]
    d = skel.pos_base[sid_s] + pos  # strictly increasing padded slot
    o = (d // T) * (nrows * T) + d % T
    flat = torch.tensor([su, si] + [0] * (nrows - 2), dtype=torch.int32,
                        device=dev)
    flat = flat[None, :, None].expand(skel.nt_total, nrows, T).reshape(-1)
    flat = flat.clone()
    flat[o] = (u[order] % su).to(torch.int32)
    flat[o + T] = (i[order] % si).to(torch.int32)
    flat[o + 2 * T] = r[order].to(torch.float32).view(torch.int32)
    for k, x in enumerate(extras):
        if x.dtype != torch.int32 or x.shape != (n,):
            raise ValueError(f"extras[{k}] must be int32 ({n},), got "
                             f"{x.dtype} {tuple(x.shape)}")
        flat[o + (3 + k) * T] = x.to(dev)[order]
    return flat.view(skel.nt_total, nrows, T)
