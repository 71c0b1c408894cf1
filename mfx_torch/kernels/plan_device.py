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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["PlanSkeleton", "SweepSlice", "build_plan_skeleton",
           "epoch_tiles_device", "epoch_rand"]


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
) -> torch.Tensor:
    """The per-epoch pass: the ``(NT, 3, T)`` int32 tile stream on the ids'
    device. ``rand`` (n int32 values) overrides the seeded shuffle key."""
    n = u.shape[0]
    if n and skel.nt_total * skel.tile * 3 >= 2**31:
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
    o = (d // T) * (3 * T) + d % T
    flat = torch.tensor([su, si, 0], dtype=torch.int32, device=dev)
    flat = flat[None, :, None].expand(skel.nt_total, 3, T).reshape(-1).clone()
    flat[o] = (u[order] % su).to(torch.int32)
    flat[o + T] = (i[order] % si).to(torch.int32)
    flat[o + 2 * T] = r[order].to(torch.float32).view(torch.int32)
    return flat.view(skel.nt_total, 3, T)
