"""Measurements of the wavefront sweeps (``sgd_sweep``, ``bpr_sweep``)
beyond ``chip_smoke.py``, on its two training cells.

    python -m mfx_torch.measure_wavefront plan   --cell sgd|bpr [--cut N]
    python -m mfx_torch.measure_wavefront blocks --cell sgd|bpr [--cut N]
                                  [--blocks 1,2,4,...] [--repeats 20]

``--cell sgd`` is the ``ml25m_rank64`` preset on the ML-25M-shaped
synthetic (the dense carving applied first, as the trainer does);
``--cell bpr`` the ``billion_bpr_sharded`` preset with
``parallel.model_axis=1`` on the billion-implicit synthetic; ``--cut``
divides the data's users, items and ratings (default 1 for sgd, 10 for
bpr: ``chip_smoke.py``'s sizes).

``plan`` builds the plan skeleton only and prints, per sparse sweep or
segment, one JSON line: its tiles, runs and windows, the tiles on its
longest dependency chain (the least number of tile steps any schedule
that keeps the plan-order result can take), and the heaviest window's and
the longest run's tiles. It launches no kernel and also runs with
``--device cpu``.

``blocks`` runs each whole sweep (segment) of epoch 0, from the untrained
tables, through the kernel at each grid size of ``--blocks`` (default 1,
2, 4, ... up to the card's count) and then ``--repeats`` more times at
the card's count; every run must give the tables and the scalar of the
first (one-block) run bit for bit. Per sweep it prints the ``plan`` line,
one JSON line per grid size (CUDA-event ms) and one for the repeats (min,
median, max). It needs a CUDA device.
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
    _, _, (u, i, r), _ = prepare_dense_full(
        u, i, r, U, I, su, si, chi_min=sgd.dense_chi,
        nwd=blocked.dense_group_windows(rank, si),
        rfmt=blocked.dense_rfmt(sgd, rank, train.rating))
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, sgd.tile, blocked.TPG,
                                   blocked.sweep_geometry(I, rank, si))
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


def _sweeps(args, dev, tiles: bool):
    """The cell's sparse sweeps or segments as ``(name, tc, deps, nwin,
    run)``; with ``tiles``, ``run(P, Q, blocks)`` launches the kernel on
    epoch 0's tile stream and the untrained tables ``(P, Q)`` come back
    too (else ``run`` and the tables are None)."""
    import torch

    from mfx_torch.solvers.blocked import TPG

    out, P, Q = [], None, None
    if args.cell == "sgd":
        from mfx_torch.kernels import plan_device as pdv
        from mfx_torch.kernels.packing import lane_tables
        from mfx_torch.kernels.sgd_sweep import sgd_sweep
        from mfx_torch.models.mf import init_model

        skel, (u, i, r), cfg, train = _sgd_cell(args.cut or 1, dev)
        sgd, mu = cfg.sgd, float(train.global_mean)
        su, si = sgd.ublock, sgd.iblock
        if tiles:
            g = torch.Generator(device=dev).manual_seed(cfg.model.seed)
            model = init_model(g, train.num_users, train.num_items,
                               cfg.model.rank, global_mean=mu, device=dev)
            P, Q = lane_tables(model, su, si, dev)
            tl = pdv.epoch_tiles_device(skel, u, i, r, cfg.data.seed, 0)
        for k, sw in enumerate(s for s in skel.sweeps if s.t1 > s.t0):
            def run(Pt, Qt, n, sw=sw):
                seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
                return sgd_sweep(Pt, Qt[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1],
                                 sgd.lr, sgd.reg, mu, su=su, si=si, tpg=TPG,
                                 deps=sw.deps, blocks=n)
            out.append((f"sgd sweep {k}", sw.tc, sw.deps, sw.nwin,
                        run if tiles else None))
        return out, P, Q, sgd.tile
    from mfx_torch.kernels.bpr_sweep import bpr_sweep
    from mfx_torch.parallel import bpr_sharded as ring

    st, cfg = _bpr_cell(args.cut or 10, dev)
    bpr, si = cfg.bpr, cfg.bpr.iblock
    if tiles:
        P, Q = st.P, st.Q
        tls = ring.ring_epoch_tiles(st, bpr, cfg.data.seed, 0)
    for k, (win0, nw, sa, tc, deps) in enumerate(st.segments()):
        def run(Pt, Qt, n, k=k, win0=win0, nw=nw, sa=sa, tc=tc, deps=deps):
            return bpr_sweep(Pt, Qt[win0 * si:(win0 + nw) * si], sa, tc,
                             tls[k][0, 0], bpr.lr, bpr.reg, su=bpr.ublock,
                             si=si, tpg=TPG, deps=deps, blocks=n)
        out.append((f"bpr segment {k}", tc, deps, nw, run if tiles else None))
    return out, P, Q, bpr.tile


def plan(args) -> int:
    import torch

    for name, tc, deps, nwin, _ in _sweeps(args, torch.device(args.device),
                                           tiles=False)[0]:
        _describe(name, deps, tc, nwin)
    return 0


def blocks(args) -> int:
    import statistics

    import torch

    from mfx_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("measure_wavefront blocks: needs a CUDA device")
    sweeps, P, Q, T = _sweeps(args, torch.device("cuda", 0), tiles=True)
    card = getattr(_build.load_library(),
                   f"mfx_{args.cell}_sweep_max_blocks")(T)

    def timed(run, n):
        Pt, Qt = P.clone(), Q.clone()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        s = run(Pt, Qt, n)
        end.record()
        end.synchronize()
        return (Pt, Qt, float(s)), start.elapsed_time(end)

    def same(a, b):
        return (a[2] == b[2] and torch.equal(a[0], b[0])
                and torch.equal(a[1], b[1]))

    for name, tc, deps, nwin, run in sweeps:
        _describe(name, deps, tc, nwin)
        grid_max = min(card, deps.runs.shape[0])
        sizes = ([int(x) for x in args.blocks.split(",")] if args.blocks else
                 sorted({min(2 ** k, grid_max) for k in range(9)}
                        | {grid_max}))
        timed(run, grid_max)  # warm-up
        want = None
        for n in sizes:
            got, ms = timed(run, n)
            want = want or got
            ok = same(got, want)
            print(json.dumps({"sweep": name, "blocks": n, "ms": ms,
                              "us_per_tile": ms * 1e3 / deps.n_tiles,
                              "bitwise_equal_to_first": ok}), flush=True)
            if not ok:
                raise SystemExit(f"{name}: {n} blocks differ from {sizes[0]}")
        times = []
        for _ in range(args.repeats):
            got, ms = timed(run, grid_max)
            if not same(got, want):
                raise SystemExit(
                    f"{name}: a repeat at {grid_max} blocks differs")
            times.append(ms)
        if times:
            print(json.dumps({
                "sweep": name, "blocks": grid_max, "repeats": len(times),
                "all_bitwise_equal": True, "ms_min": min(times),
                "ms_median": statistics.median(times), "ms_max": max(times),
                "us_per_critical_tile":
                    statistics.median(times) * 1e3 / deps.critical,
                "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mfx_torch.measure_wavefront")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("plan", plan), ("blocks", blocks)):
        p = sub.add_parser(name)
        p.add_argument("--cell", choices=("sgd", "bpr"), required=True)
        p.add_argument("--cut", type=int, default=0)
        p.set_defaults(fn=fn)
    sub.choices["plan"].add_argument("--device", default="cuda")
    sub.choices["blocks"].add_argument("--blocks", default=None)
    sub.choices["blocks"].add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
