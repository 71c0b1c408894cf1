"""Device-side epoch planning for the DSGD ring, the counterpart of
``mfx/kernels/plan_ring_device.py``.

A rating's cell is (sub-step t, shard s) with ``s = u // ublock`` and
``t = (block(i) - s) mod S``; inside the cell it stratifies by (local user
block a, local item window c) as the single-device plan does, with the
stratum id prefixed by (segment, t, s). The plan splits into a skeleton
built once per run (per-stratum counts by one device ``bincount``, then
O(strata) host layout: tile counts, user-block runs padded to ``tpg``
tiles, ``sa`` per group of tiles and ``tc`` per tile, and the sorted-stream
bounds of every (segment, sub-step)) and a per-epoch pass: one stable sort
on (stratum, random key) with the ids riding along, then one scatter per
(segment, sub-step) into its ``[S, nt, 3, T]`` slab.

Row 2 of a tile carries ``payload2`` (window-local negatives for BPR, pad
sentinel ``sent2``) or the f32 rating bit-cast to int32. The random key is
a signed int32 compared as such, as the reference's
``lax.sort(num_keys=2, is_stable=True)`` does, so given the reference's
bits (``rand``) the slabs are bitwise the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mfx_torch.kernels.plan_device import SweepDeps, epoch_rand, sweep_deps

__all__ = ["RingSegmentSlice", "RingSkeleton", "build_ring_skeleton",
           "epoch_tiles_ring"]


@dataclasses.dataclass
class RingSegmentSlice:
    """Static per-segment view: one kernel call per (sub-step, shard)."""

    win0: int  # first window of the segment within the held block
    nwin: int
    nt: int  # padded tiles per cell (uniform across cells)
    sa: torch.Tensor  # (S, S, nt / tpg) int32 user block per group of tiles
    tc: torch.Tensor  # (S, S, nt) int32 segment-local window per tile
    # deps[t][s]: what orders the tiles of cell (sub-step t, shard s) on
    # many SMs (kernels.plan_device.sweep_deps)
    deps: list[list[SweepDeps]]


@dataclasses.dataclass
class RingSkeleton:
    S: int
    ublock: int
    iblock: int
    su: int
    si: int
    tile: int
    tpg: int
    nwin: int  # windows per segment
    nt_total: int  # total padded tiles across all slabs
    n_real: int
    segments: list[RingSegmentSlice]
    strat_start: torch.Tensor  # (NS,) int64 exclusive cumsum of counts
    pos_base: torch.Tensor  # (NS,) int64 slab-relative first slot per stratum
    seg_off: torch.Tensor  # (nseg,) int64 sid offset per segment
    nw_arr: torch.Tensor  # (nseg,) int64 windows per segment
    # sorted-stream bounds per (segment, sub-step): sid order is
    # (k, t, s, a, cw), so every (k, t) range is contiguous
    kt_bounds: np.ndarray  # (nseg, S + 1) int64


def _sid_ring(u, ir, seg_off, nw_arr, *, S, ublock, iblock, su, si, nwin, A):
    u = u.to(torch.int64)
    ir = ir.to(torch.int64)
    s = u // ublock
    t = (ir // iblock - s) % S
    a = (u % ublock) // su
    cl = (ir % iblock) // si
    k = cl // nwin
    cw = cl - k * nwin
    return seg_off[k] + ((t * S + s) * A + a) * nw_arr[k] + cw


def build_ring_skeleton(
    u_dev: torch.Tensor,
    ir_dev: torch.Tensor,
    S: int,
    ublock: int,
    iblock: int,
    su: int,
    si: int,
    tile: int,
    tpg: int,
    nwin: int,
) -> RingSkeleton:
    """Once per run: one device bincount + O(num_strata) host layout. Every
    returned tensor lives on the ids' device."""
    dev = u_dev.device
    A = ublock // su
    C = iblock // si
    nseg = -(-C // nwin)
    nw = np.minimum(nwin, C - np.arange(nseg) * nwin).astype(np.int64)
    seg_off = np.zeros(nseg, np.int64)
    np.cumsum(S * S * A * nw[:-1], out=seg_off[1:])
    ns = S * S * A * C
    if ns >= 2**31:
        raise NotImplementedError(
            "ring stratum space exceeds int32; raise su/si or shard planning"
        )
    seg_off_dev = torch.as_tensor(seg_off, device=dev)
    nw_dev = torch.as_tensor(nw, device=dev)
    sid = _sid_ring(u_dev, ir_dev, seg_off_dev, nw_dev, S=S, ublock=ublock,
                    iblock=iblock, su=su, si=si, nwin=nwin, A=A)
    counts = torch.bincount(sid, minlength=ns).cpu().numpy().astype(np.int64)
    del sid

    strat_start = np.zeros(ns + 1, np.int64)
    np.cumsum(counts, out=strat_start[1:])

    tiles_per = -(-counts // tile)
    pos_base = np.zeros(ns, np.int64)
    segments: list[RingSegmentSlice] = []
    f_cursor = 0  # flat tile cursor
    off = 0  # sid cursor
    for k in range(nseg):
        nwk = int(nw[k])
        cnt_k = tiles_per[off:off + S * S * A * nwk].reshape(S, S, A, nwk)
        real_per_a = cnt_k.sum(axis=3)  # (S, S, A)
        padded_per_a = -(-real_per_a // tpg) * tpg
        ng_cells = padded_per_a.sum(axis=2) // tpg  # (S, S)
        ng = max(1, int(ng_cells.max()))
        nt = ng * tpg

        sa = np.zeros((S, S, ng), np.int32)
        tc = np.zeros((S, S, nt), np.int32)
        deps = [[None] * S for _ in range(S)]
        for t in range(S):
            for s in range(S):
                runs = (padded_per_a[t, s] // tpg).astype(np.int64)
                sa_cell = np.repeat(np.arange(A, dtype=np.int32), runs)
                sa[t, s, :sa_cell.shape[0]] = sa_cell
                if sa_cell.shape[0] < ng:  # pad: repeat last visited block
                    sa[t, s, sa_cell.shape[0]:] = (
                        sa_cell[-1] if sa_cell.shape[0] else 0
                    )
                tp = cnt_k[t, s]  # (A, nwk)
                run_base = np.zeros(A + 1, np.int64)
                np.cumsum(padded_per_a[t, s], out=run_base[1:])
                within = np.cumsum(tp, axis=1) - tp
                cell_rel = s * nt  # slot base relative to the (k, t) slab
                sid_lo = off + (t * S + s) * A * nwk
                pos_base[sid_lo:sid_lo + A * nwk] = (
                    (cell_rel + run_base[:-1, None] + within).reshape(-1)
                    * tile
                )
                tpf = tp.reshape(-1)
                strat_of_tile = np.repeat(np.arange(A * nwk, dtype=np.int64),
                                          tpf)
                starts = np.cumsum(tpf) - tpf
                within_t = (np.arange(strat_of_tile.shape[0], dtype=np.int64)
                            - np.repeat(starts, tpf))
                base_local = (run_base[:-1, None] + within).reshape(-1)
                real_ids = base_local[strat_of_tile] + within_t
                tc[t, s, real_ids] = (strat_of_tile % nwk).astype(np.int32)
                # the cell's trailing pad tiles ride at the end of its last
                # run (sa repeats that block there)
                run_len = padded_per_a[t, s].copy()
                run_len[sa[t, s, -1]] += nt - run_base[-1]
                deps[t][s] = sweep_deps(tp, run_len, dev)
        if S * nt * 3 * tile >= 2**31:
            raise NotImplementedError(
                f"a single (segment, sub-step) slab ({S}x{nt} tiles x "
                f"{tile}) exceeds int32 addressing; raise the shard count"
            )
        segments.append(RingSegmentSlice(
            win0=k * nwin, nwin=nwk, nt=nt,
            sa=torch.as_tensor(sa, device=dev),
            tc=torch.as_tensor(tc, device=dev),
            deps=deps,
        ))
        f_cursor += S * S * nt
        off += S * S * A * nwk

    kt_bounds = np.zeros((nseg, S + 1), np.int64)
    off2 = 0
    for k in range(nseg):
        nwk = int(nw[k])
        for t in range(S + 1):
            kt_bounds[k, t] = strat_start[off2 + min(t, S) * S * A * nwk]
        off2 += S * S * A * nwk
    return RingSkeleton(
        S=S, ublock=ublock, iblock=iblock, su=su, si=si, tile=tile,
        tpg=tpg, nwin=nwin, nt_total=f_cursor, n_real=int(counts.sum()),
        segments=segments,
        strat_start=torch.as_tensor(strat_start[:-1], device=dev),
        pos_base=torch.as_tensor(pos_base, device=dev),
        seg_off=seg_off_dev, nw_arr=nw_dev, kt_bounds=kt_bounds,
    )


def _sort_stream(skel: RingSkeleton, u, ir, p2, rand):
    """The seeded two-key sort: (stratum id, signed random key), stable,
    with the block-local ids and the payload riding along."""
    A = skel.ublock // skel.su
    sid = _sid_ring(u, ir, skel.seg_off, skel.nw_arr, S=skel.S,
                    ublock=skel.ublock, iblock=skel.iblock, su=skel.su,
                    si=skel.si, nwin=skel.nwin, A=A)
    key = (sid << 32) | (rand.to(sid.device, torch.int64) + 2**31)
    order = torch.sort(key, stable=True).indices
    del key
    ul = (u[order] % skel.su).to(torch.int32)
    il = (ir[order] % skel.si).to(torch.int32)
    return sid[order], ul, il, p2[order].to(torch.int32)


def _scatter_slab(skel: RingSkeleton, nt: int, sid_s, ul, il, p2, b0: int,
                  m: int, sent2: int) -> torch.Tensor:
    """Scatter one (segment, sub-step)'s contiguous sorted-stream slice
    into its ``[S, nt, 3, T]`` slab; slots left over hold the pad
    sentinels ``(su, si, sent2)``."""
    S, T = skel.S, skel.tile
    dev = sid_s.device
    sl = slice(b0, b0 + m)
    sid_c = sid_s[sl]
    pos = torch.arange(b0, b0 + m, device=dev) - skel.strat_start[sid_c]
    d = skel.pos_base[sid_c] + pos  # slab-relative slot
    o = (d // T) * (3 * T) + d % T
    flat = torch.tensor([skel.su, skel.si, sent2], dtype=torch.int32,
                        device=dev)
    flat = flat[None, :, None].expand(S * nt, 3, T).reshape(-1).clone()
    flat[o] = ul[sl]
    flat[o + T] = il[sl]
    flat[o + 2 * T] = p2[sl]
    return flat.view(S, nt, 3, T)


def epoch_tiles_ring(
    skel: RingSkeleton, u_dev, ir_dev, r_dev, seed: int, epoch: int,
    payload2=None, sent2: int = 0, rand: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """Per-epoch pass: one seeded sort, then per-(segment, sub-step) slab
    scatters, returning one ``(S, S, nt_k, 3, T)`` int32 slab per segment
    (sub-step-major). Row 2 carries ``payload2`` (int32, pad sentinel
    ``sent2``) when given and the bit-cast ratings ``r_dev`` otherwise.
    ``rand`` (n int32 values) overrides the seeded within-stratum key."""
    S = skel.S
    dev = u_dev.device
    n = int(u_dev.shape[0])
    if n == 0:
        # empty stream: all-sentinel slabs, every slot a no-op
        sent = torch.tensor([skel.su, skel.si, sent2], dtype=torch.int32,
                            device=dev)
        return [sent[None, None, None, :, None]
                .expand(S, S, seg.nt, 3, skel.tile).clone()
                for seg in skel.segments]
    if payload2 is None:
        payload2 = torch.as_tensor(r_dev).to(dev, torch.float32).view(
            torch.int32)
    if rand is None:
        rand = epoch_rand(n, seed, epoch, dev)
    sid_s, ul, il, p2 = _sort_stream(skel, u_dev, ir_dev,
                                     torch.as_tensor(payload2).to(dev), rand)
    out = []
    for k, seg in enumerate(skel.segments):
        slabs = []
        for t in range(S):
            b0 = int(skel.kt_bounds[k, t])
            m = int(skel.kt_bounds[k, t + 1]) - b0
            slabs.append(_scatter_slab(skel, seg.nt, sid_s, ul, il, p2, b0,
                                       m, sent2))
        out.append(torch.stack(slabs, dim=0))
    return out
