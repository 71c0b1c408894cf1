"""Measurements of the wavefront kernels (``sgd_sweep``, ``bpr_sweep``,
``sgd_sweep_tile``, ``sgd_sweep_step_u``, ``dense_phase``) beyond
``chip_smoke.py``, on its training cells.

    python -m mfx_torch.measure_wavefront plan   --cell sgd|bpr|tile|step_u
                                  [--cut N]
    python -m mfx_torch.measure_wavefront blocks --cell sgd|bpr|tile|step_u
                                  [--cut N] [--blocks 1,2,4,...]
                                  [--repeats 20]
    python -m mfx_torch.measure_wavefront orders [--cut N] [--repeats 10]
    python -m mfx_torch.measure_wavefront unit   [--cut N] [--repeats 3]

``--cell sgd`` is the ``ml25m_rank64`` preset on the ML-25M-shaped
synthetic (the dense carving applied first, as the trainer does);
``--cell bpr`` the ``billion_bpr_sharded`` preset with
``parallel.model_axis=1`` on the billion-implicit synthetic; ``--cell
tile`` the ``ml1m_rank32_biased`` preset (tile biases, per tile) on the
ML-1M-shaped synthetic; ``--cell step_u`` the same with
``sgd.step_user_batch=true`` (``sgd_sweep_step_u``). ``--cut``
divides the data's users, items and ratings (default 1 for sgd, tile and
step_u, 10 for bpr: ``chip_smoke.py``'s sizes).

``plan`` builds the plan skeleton only and prints, per sparse sweep or
segment, one JSON line: its tiles, runs and windows, the tiles on its
longest dependency chain (the least number of tile steps any schedule
that keeps the plan-order result can take), and the heaviest window's and
the longest run's tiles. For ``--cell sgd`` it also prints the dense
carving (threshold, dense share, strata, R bytes, sparse ratings) and one
line per dense group: its strata, user blocks, the most strata of any
window and the strata on the longest chain of the group's table. It launches no
kernel and also runs with ``--device cpu``.

``blocks`` runs each whole sweep (segment) of epoch 0, from the untrained
tables, through the kernel at each grid size of ``--blocks`` (default 1,
2, 4, ... up to the card's count) and then ``--repeats`` more times at
the card's count; every run must give the tables and the scalar of the
first (one-block) run bit for bit. Per sweep it prints the ``plan`` line,
one JSON line per grid size (CUDA-event ms) and one for the repeats (min,
median, max). For ``--cell sgd`` it then does the same for the dense
phase of epoch 0 (all groups, in order) and for group 0 alone, on one
block, on half the card's count and at the card's count (at least 5
repeats there), and breaks 256 strata of group 0 down under
``torch.profiler``: device time per kernel launch, by kernel name, and
the wall time the kernels leave uncovered. It needs a CUDA device.

``orders`` (the sgd cell) times group 0 and the dense phase of epoch 0
at the card's count with the strata handed out in two orders, the list
schedule the wrapper uses (``SweepDeps.list_order``) and a stable sort
by chain depth (``plan_device.chain_depths``), each with a ring of 16
and of 8 strata in flight: every combination once to warm up, then
``--repeats`` rounds that time each in turn; every run must give the
first run's bits. One JSON line per scope and combination (CUDA-event
ms: min, median, max). It needs a CUDA device.

``unit`` (the sgd cell) breaks ``dense_phase``'s work units down on group
0 at the card's count: it builds the measurement-only library
(``_build.load_library("dense_stamps")``: ``clock64()`` stamps behind
extra barriers), runs group 0 through it ``--repeats`` times after a
warm-up, and prints one JSON line: each phase's share of the blocks'
cycles (``csrc/dense_phase.cu``'s ``ST_*``), cycles per panel piece,
apply unit and chunk, and group 0's time in the default build and in the
stamped one (CUDA events), whose tables and SSE must be the default
build's bit for bit. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json


def _sgd_cell(cut: int, dev):
    """(skeleton, device ids and ratings after the dense carving, cfg,
    train) of the SGD cell."""
    import torch

    from mfx_torch.config import preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML25M_SHAPE, make_synthetic
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers.dense_prep import prepare_dense_full

    cfg = preset("ml25m_rank64")
    sgd, rank = cfg.sgd, cfg.model.rank
    coo = make_synthetic(*(x // cut for x in ML25M_SHAPE), rank=64, seed=102,
                         star_step=0.5, user_zipf_s=0.6)
    train, _ = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    U, I, su, si = coo.num_users, coo.num_items, sgd.ublock, sgd.iblock
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    meta, groups, (u, i, r), info = prepare_dense_full(
        u, i, r, U, I, su, si, chi_min=sgd.dense_chi,
        nwd=blocked.dense_group_windows(rank, si),
        rfmt=blocked.dense_rfmt(sgd, rank, train.rating))
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, sgd.tile, blocked.TPG,
                                   blocked.sweep_geometry(I, rank, si))
    info["sparse_ratings"] = int(u.shape[0])
    return skel, (u, i, r), cfg, train, (meta, groups, info)


def _tile_cell(cut: int, dev, step_u: bool = False):
    """(skeleton, device ids and ratings, cfg, train) of the tile-bias
    cell (no dense phase), with ``sgd.step_user_batch`` or not."""
    import torch

    from mfx_torch.config import preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML1M_SHAPE, make_synthetic
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.solvers import blocked

    cfg = preset("ml1m_rank32_biased")
    sgd, rank = cfg.sgd, cfg.model.rank
    coo = make_synthetic(*(x // cut for x in ML1M_SHAPE), rank=32, seed=101,
                         star_step=1.0, user_zipf_s=0.6)
    train, _ = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    U, I, su, si = coo.num_users, coo.num_items, sgd.ublock, sgd.iblock
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    skel = pdv.build_plan_skeleton(
        u, i, U, I, su, si, sgd.tile, blocked.TPG, blocked.sweep_geometry(
            I, rank, si, step_u=(su, sgd.tile) if step_u else None))
    return skel, (u, i, r), cfg, train


def _bpr_cell(cut: int, dev):
    """(ring state, cfg) of the BPR cell, from the untrained model."""
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import (BILLION_SHAPE,
                                          make_implicit_synthetic)
    from mfx_torch.models.mf import init_model
    from mfx_torch.parallel import bpr_sharded as ring

    cfg = apply_overrides(preset("billion_bpr_sharded"),
                          ["parallel.model_axis=1"])
    coo = make_implicit_synthetic(*(x // cut for x in BILLION_SHAPE),
                                  rank=64, seed=104)
    train, _ = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    del coo
    g = torch.Generator(device=dev).manual_seed(cfg.model.seed)
    model = init_model(g, train.num_users, train.num_items, cfg.model.rank,
                       global_mean=train.global_mean,
                       init_scale=cfg.model.init_scale)
    return ring.ring_state(model, train, cfg.bpr, seed=cfg.data.seed,
                           device=dev), cfg


def _describe(name, deps, tc, nwin):
    """One JSON line for a sweep's dependency table."""
    import numpy as np

    runs, wait = deps.runs.cpu().numpy(), deps.wait.cpu().numpy()
    # a run's real tiles end with its last stratum's published end; the
    # tiles behind it are pads
    ends = runs[:, 0] + runs[:, 1]
    real_end = runs[:, 0].copy()
    pub = np.flatnonzero(wait[:, 2])
    np.maximum.at(real_end, np.searchsorted(ends, pub, side="right"), pub + 1)
    real = np.arange(deps.n_tiles) < np.repeat(real_end, runs[:, 1])
    per_win = np.bincount(tc.cpu().numpy()[real], minlength=nwin)
    print(json.dumps({
        "sweep": name, "tiles": deps.n_tiles, "real_tiles": int(real.sum()),
        "runs": int(runs.shape[0]), "windows": nwin,
        "critical_tiles": deps.critical,
        "tiles_over_critical": deps.n_tiles / max(1, deps.critical),
        "heaviest_window_tiles": int(per_win.max()),
        "longest_run_tiles": int(runs[:, 1].max())}), flush=True)


def _describe_group(g, win0, nw, grp):
    """One JSON line for a dense group's dependency table."""
    import numpy as np

    deps = grp["deps"]
    print(json.dumps({
        "dense_group": g, "win0": win0, "windows": nw,
        "strata": deps.n_tiles, "user_blocks": int(deps.runs.shape[0]),
        "most_strata_in_a_window": int(np.bincount(
            grp["sc"].cpu().numpy(), minlength=nw).max()),
        "critical_strata": deps.critical,
        "strata_over_critical": deps.n_tiles / max(1, deps.critical)}),
        flush=True)


def _sweeps(args, dev, tiles: bool):
    """The cell's sparse sweeps or segments as ``(name, tc, deps, nwin,
    run)``; with ``tiles``, ``run(tables, blocks)`` launches the kernel on
    epoch 0's tile stream and the untrained tables come back too (else
    ``run`` and the tables are None). Also the tile size, and for the
    sgd cell ``(meta, groups, mu, lr, reg, su, si, info)`` of its dense
    phase, ``info`` the carving's (else None)."""
    import torch

    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.models.mf import init_model
    from mfx_torch.solvers.blocked import TPG

    out, tables = [], None
    if args.cell in ("sgd", "tile", "step_u"):
        from mfx_torch.kernels.packing import lane_tables, plain_tables
        from mfx_torch.kernels.sgd_sweep import (sgd_sweep, sgd_sweep_step_u,
                                                 sgd_sweep_tile)

        if args.cell == "sgd":
            skel, (u, i, r), cfg, train, dense = _sgd_cell(args.cut or 1, dev)
        else:
            skel, (u, i, r), cfg, train = _tile_cell(
                args.cut or 1, dev, step_u=args.cell == "step_u")
            dense = None
        sgd, mu = cfg.sgd, float(train.global_mean)
        su, si = sgd.ublock, sgd.iblock
        if tiles:
            g = torch.Generator(device=dev).manual_seed(cfg.model.seed)
            # as chip_smoke.py's phases 3 and 9 make them
            scale = ({} if args.cell == "sgd"
                     else {"init_scale": cfg.model.init_scale})
            model = init_model(g, train.num_users, train.num_items,
                               cfg.model.rank, global_mean=mu, device=dev,
                               **scale)
            tables = (lane_tables(model, su, si, dev) if args.cell == "sgd"
                      else plain_tables(model, su, si, dev))
            tl = pdv.epoch_tiles_device(skel, u, i, r, cfg.data.seed, 0)
        for k, sw in enumerate(s for s in skel.sweeps if s.t1 > s.t0):
            seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
            kw = dict(su=su, si=si, tpg=TPG, deps=sw.deps)

            def run(tabs, n, sw=sw, seg=seg, kw=kw):
                stream = (sw.sa, sw.tc, tl[sw.t0:sw.t1], sgd.lr, sgd.reg, mu)
                if args.cell == "sgd":
                    P, Q = tabs
                    return sgd_sweep(P, Q[seg], *stream, **kw, blocks=n)
                P, Q, bu, bi = tabs
                if args.cell == "step_u":
                    return sgd_sweep_step_u(P, Q[seg], bu, bi[seg], *stream,
                                            **kw, blocks=n)
                return sgd_sweep_tile(P, Q[seg], bu, bi[seg], *stream,
                                      **kw, blocks=n)
            out.append((f"{args.cell} sweep {k}", sw.tc, sw.deps, sw.nwin,
                        run if tiles else None))
        if dense is not None:
            dense = (*dense[:2], mu, sgd.lr, sgd.reg, su, si, dense[2])
        return out, tables, sgd.tile, dense
    from mfx_torch.kernels.bpr_sweep import bpr_sweep
    from mfx_torch.parallel import bpr_sharded as ring

    st, cfg = _bpr_cell(args.cut or 10, dev)
    bpr, si = cfg.bpr, cfg.bpr.iblock
    if tiles:
        tables = (st.P, st.Q)
        tls = ring.ring_epoch_tiles(st, bpr, cfg.data.seed, 0)
    for k, (win0, nw, sa, tc, deps) in enumerate(st.segments()):
        def run(tabs, n, k=k, win0=win0, nw=nw, sa=sa, tc=tc, deps=deps):
            P, Q = tabs
            return bpr_sweep(P, Q[win0 * si:(win0 + nw) * si], sa, tc,
                             tls[k][0, 0], bpr.lr, bpr.reg, su=bpr.ublock,
                             si=si, tpg=TPG, deps=deps, blocks=n)
        out.append((f"bpr segment {k}", tc, deps, nw, run if tiles else None))
    return out, tables, bpr.tile, None


def plan(args) -> int:
    import torch

    sweeps, _, _, dense = _sweeps(args, torch.device(args.device),
                                  tiles=False)
    for name, tc, deps, nwin, _ in sweeps:
        _describe(name, deps, tc, nwin)
    if dense is not None:
        meta, groups = dense[:2]
        print(json.dumps({"dense_carving": dense[-1]}), flush=True)
        for g, ((win0, nw), grp) in enumerate(zip(meta, groups)):
            _describe_group(g, win0, nw, grp)
    return 0


def _timed(run, tables, n):
    """``run(tables, n)`` on clones of ``tables``: ((tables, scalar), ms)."""
    import torch

    tabs = [t.clone() for t in tables]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    s = run(tabs, n)
    end.record()
    end.synchronize()
    return (tabs, float(s)), start.elapsed_time(end)


def _same(a, b):
    import torch

    return a[1] == b[1] and all(torch.equal(x, y) for x, y in zip(a[0], b[0]))


def _grid_runs(name, run, tables, sizes, repeats, grid_max, units, chain):
    """Time ``run`` at each grid size, then ``repeats`` times at
    ``grid_max``; every run must give the first run's bits."""
    import statistics

    import torch

    for n in sorted({grid_max} | set(sizes)):
        _timed(run, tables, n)  # warm-up (and the dense schedule's order)
    want = None
    for n in sizes:
        got, ms = _timed(run, tables, n)
        want = want or got
        ok = _same(got, want)
        print(json.dumps({"sweep": name, "blocks": n, "ms": ms,
                          "us_per_tile": ms * 1e3 / units,
                          "bitwise_equal_to_first": ok}), flush=True)
        if not ok:
            raise SystemExit(f"{name}: {n} blocks differ from {sizes[0]}")
    times = []
    for _ in range(repeats):
        got, ms = _timed(run, tables, grid_max)
        if not _same(got, want):
            raise SystemExit(f"{name}: a repeat at {grid_max} blocks differs")
        times.append(ms)
    if times:
        print(json.dumps({
            "sweep": name, "blocks": grid_max, "repeats": len(times),
            "all_bitwise_equal": True, "ms_min": min(times),
            "ms_median": statistics.median(times), "ms_max": max(times),
            "us_per_critical_tile": statistics.median(times) * 1e3 / chain,
            "card": torch.cuda.get_device_name(0)}), flush=True)


def _dense_blocks(args, tables, dense, card):
    """The dense phase of epoch 0 (every group, in order) and group 0
    alone, on one block and at the card's count; then 256 strata of
    group 0 broken down by kernel under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from mfx_torch.kernels.dense_phase import dense_phase, group_prefix

    meta, groups, mu, lr, reg, su, si, _ = dense
    P, Q = tables[:2]

    def run_groups(grps):
        def run(tabs, n):
            Pt, Qt = tabs
            sse = None
            for (win0, nw), grp in grps:
                s = dense_phase(Pt, Qt[win0 * si:(win0 + nw) * si], grp, lr,
                                reg, mu, su=su, si=si, deps=grp["deps"],
                                blocks=n)
                sse = s if sse is None else sse + s
            return sse
        return run

    every = list(zip(meta, groups))
    strata = sum(g["deps"].n_tiles for g in groups)
    chain = sum(g["deps"].critical for g in groups)
    repeats = max(5, args.repeats)
    for name, grps, units, crit in (
            ("dense phase (all groups)", every, strata, chain),
            ("dense group 0", every[:1], groups[0]["deps"].n_tiles,
             groups[0]["deps"].critical)):
        print(json.dumps({"dense": name, "strata": units,
                          "critical_strata": crit}), flush=True)
        _grid_runs(name, run_groups(grps), (P, Q), [1, card // 2, card],
                   repeats, card, units, crit)

    head = group_prefix(groups[0], min(256, groups[0]["deps"].n_tiles))
    nd = head["deps"].n_tiles
    run = run_groups([(meta[0], head)])
    _timed(run, (P, Q), card)  # warm-up
    tabs = [P.clone(), Q.clone()]
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(tabs, card)
        end.record()
        end.synchronize()
    wall_us = start.elapsed_time(end) * 1e3
    kernels, busy = {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0:
            continue
        kernels[ev.key[:60]] = {"launches": ev.count,
                                "us_per_launch": dev_us / ev.count,
                                "us_per_stratum": dev_us / nd}
        busy += dev_us
    print(json.dumps({
        "dense": "group 0 breakdown", "strata": nd,
        "critical_strata": head["deps"].critical,
        "wall_us_per_stratum": wall_us / nd, "kernels": kernels,
        "uncovered_us_per_stratum": (wall_us - busy) / nd,
        "card": torch.cuda.get_device_name(0)}), flush=True)


def blocks(args) -> int:
    import torch

    from mfx_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("measure_wavefront blocks: needs a CUDA device")
    sweeps, tables, T, dense = _sweeps(args, torch.device("cuda", 0),
                                       tiles=True)
    lib = _build.load_library()
    if args.cell == "tile":
        card = lib.mfx_sgd_sweep_tile_max_blocks(T, tables[0].shape[1])
    elif args.cell == "step_u":
        from mfx_torch.config import preset

        card = lib.mfx_sgd_sweep_step_u_max_blocks(
            T, tables[0].shape[1], preset("ml1m_rank32_biased").sgd.ublock)
    elif args.cell == "sgd":
        card = lib.mfx_sgd_sweep_max_blocks(T, tables[0].shape[1])
    else:
        card = lib.mfx_bpr_sweep_max_blocks(T)

    for name, tc, deps, nwin, run in sweeps:
        _describe(name, deps, tc, nwin)
        grid_max = min(card, deps.runs.shape[0])
        sizes = ([int(x) for x in args.blocks.split(",")] if args.blocks else
                 sorted({min(2 ** k, grid_max) for k in range(9)}
                        | {grid_max}))
        _grid_runs(name, run, tables, sizes, args.repeats, grid_max,
                   deps.n_tiles, deps.critical)
    if dense is not None:
        _dense_blocks(args, tables, dense, _dense_card(lib, tables, dense))
    return 0


def _dense_card(lib, tables, dense) -> int:
    from mfx_torch.kernels.dense_phase import code_format

    card = lib.mfx_dense_phase_max_blocks(
        tables[0].shape[1], int(code_format(dense[1][0]["R"]) == "int8"),
        0)  # the lane form, which the sgd cell runs
    if card < 1:
        raise SystemExit(f"dense_phase: CUDA error {-card} sizing the grid")
    return card


def orders(args) -> int:
    import statistics
    import time

    import numpy as np
    import torch

    from mfx_torch.kernels import _build
    from mfx_torch.kernels import dense_phase as dp
    from mfx_torch.kernels.plan_device import chain_depths

    if not torch.cuda.is_available():
        raise SystemExit("measure_wavefront orders: needs a CUDA device")
    dev = torch.device("cuda", 0)
    args.cell = "sgd"
    _, tables, _, dense = _sweeps(args, dev, tiles=True)
    meta, groups, mu, lr, reg, su, si, _ = dense
    lib = _build.load_library()
    card = _dense_card(lib, tables, dense)
    nq = dp._apply_units(si, tables[0].shape[1])
    # per combination and group: the scheduler arguments of one launch
    combos = {}
    for how in ("list", "depth"):
        for ring in (16, 8):
            per = []
            for grp in groups:
                deps, nd = grp["deps"], grp["sa"].shape[0]
                grid = min(card, nd * (su // 64 * dp._PIECES + nq))
                rg = min(ring, nd)
                t0 = time.perf_counter()
                if how == "list":
                    order = deps.list_order(grid, su // 64 * dp._PIECES, nq,
                                            0.1 * dp._PIECES, rg)
                else:
                    order = torch.as_tensor(np.argsort(chain_depths(
                        deps.runs.cpu().numpy(), deps.wait.cpu().numpy()),
                        kind="stable"), dtype=torch.int32, device=dev)
                host_s = time.perf_counter() - t0
                per.append((deps.runs, deps.wait, order, rg, grid, host_s))
            combos[(how, ring)] = per

    every = list(zip(meta, groups))
    for name, k in (("dense group 0", 1), ("dense phase (all groups)",
                                           len(groups))):
        def run(tabs, combo, k=k):
            Pt, Qt = tabs
            sse = None
            for ((win0, nw), grp), sched in zip(every[:k], combos[combo]):
                s = dp.launch(lib, Pt, Qt[win0 * si:(win0 + nw) * si], grp,
                              lr, reg, mu, su, si, *sched[:5])
                sse = s if sse is None else sse + s
            return sse

        times, want = {c: [] for c in combos}, None
        for rnd in range(1 + args.repeats):
            for c in combos:
                got, ms = _timed(run, tables[:2], c)
                want = want or got
                if not _same(got, want):
                    raise SystemExit(f"{name}: {c} differs from the first run")
                if rnd:
                    times[c].append(ms)
        for (how, ring), ts in times.items():
            print(json.dumps({
                "dense": name, "order": how, "ring": ring, "blocks": card,
                "strata": sum(g["deps"].n_tiles for _, g in every[:k]),
                "critical_strata": sum(g["deps"].critical
                                       for _, g in every[:k]),
                "repeats": len(ts), "all_bitwise_equal": True,
                "ms_min": min(ts), "ms_median": statistics.median(ts),
                "ms_max": max(ts),
                "host_order_s": sum(x[5] for x in combos[(how, ring)][:k]),
                "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


STAMP_PHASES = ("ticket", "wait", "snapshot", "e_and_barrier",
                "fused_products", "partials_and_sums", "piece_end",
                "last_piece", "apply_wait", "apply")


def unit(args) -> int:
    import ctypes

    import torch

    from mfx_torch.kernels import _build
    from mfx_torch.kernels import dense_phase as dp

    if not torch.cuda.is_available():
        raise SystemExit("measure_wavefront unit: needs a CUDA device")
    dev = torch.device("cuda", 0)
    args.cell = "sgd"
    _, tables, _, dense = _sweeps(args, dev, tiles=True)
    meta, groups, mu, lr, reg, su, si, _ = dense
    (win0, nw), grp = meta[0], groups[0]
    rank, rfmt = tables[0].shape[1], dp.code_format(grp["R"])
    out = {}
    for variant in ("", "dense_stamps"):
        lib = _build.load_library(variant)
        card = lib.mfx_dense_phase_max_blocks(rank, int(rfmt == "int8"), 0)
        sched = dp.dense_launch(lib, grp["deps"], grp["sa"].shape[0], su, si,
                                dev, card, rank, rfmt)

        def run(tabs, n, lib=lib, sched=sched):
            Pt, Qt = tabs
            return dp.launch(lib, Pt, Qt[win0 * si:(win0 + nw) * si], grp, lr,
                             reg, mu, su, si, *sched)

        _timed(run, tables[:2], card)  # warm-up
        if variant:
            n = lib.mfx_dense_phase_stamp_count()
            sums = (ctypes.c_ulonglong * n)()
            _build.check(lib.mfx_dense_phase_stamps(sums, 1), "stamps")
        times, got = [], None
        for _ in range(args.repeats):
            got, ms = _timed(run, tables[:2], card)
            times.append(ms)
        out[variant or "default"] = (got, times, card)
    want, base_ms, card = out["default"]
    got, stamped_ms, _ = out["dense_stamps"]
    if not _same(got, want):
        raise SystemExit("dense_phase: the stamped build's bits differ")
    _build.check(lib.mfx_dense_phase_stamps(sums, 0), "stamps")
    cyc = list(sums)[:len(STAMP_PHASES)]
    pieces, applies, chunks = list(sums)[len(STAMP_PHASES):]
    total = sum(cyc)
    print(json.dumps({
        "dense": "group 0 unit breakdown", "strata": grp["sa"].shape[0],
        "blocks": card, "repeats": args.repeats,
        "share": {k: c / total for k, c in zip(STAMP_PHASES, cyc)},
        "cycles_per_piece": sum(cyc[1:8]) / pieces,
        "cycles_per_apply_unit": sum(cyc[8:]) / applies,
        "cycles_per_chunk": {k: c / chunks for k, c in
                             zip(STAMP_PHASES[3:6], cyc[3:6])},
        "panel_pieces": pieces, "apply_units": applies, "chunks": chunks,
        "default_ms": base_ms, "stamped_ms": stamped_ms,
        "bitwise_equal": True, "card": torch.cuda.get_device_name(0)}),
        flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mfx_torch.measure_wavefront")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("plan", plan), ("blocks", blocks), ("orders", orders),
                     ("unit", unit)):
        p = sub.add_parser(name)
        if name not in ("orders", "unit"):
            p.add_argument("--cell", choices=("sgd", "bpr", "tile", "step_u"),
                           required=True)
        p.add_argument("--cut", type=int, default=0)
        p.set_defaults(fn=fn)
    sub.choices["plan"].add_argument("--device", default="cuda")
    sub.choices["blocks"].add_argument("--blocks", default=None)
    sub.choices["blocks"].add_argument("--repeats", type=int, default=20)
    sub.choices["orders"].add_argument("--repeats", type=int, default=10)
    sub.choices["unit"].add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
