#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (mfx_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and nvcc, and
imports nothing of JAX. Phases, each printed as it ends:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: both kernels from mfx_torch/csrc;
3. kernels against their plain PyTorch versions at the ml25m_rank64
   preset's shapes (su = si = 1024, T = 256, rank 64, int4): the first
   2,048 tiles of the first non-empty sparse sweep and the first 64
   strata of the first dense group, max abs difference <= 1e-4, two
   kernel runs bitwise equal, and the time of each;
4. main path: two epochs of mfx_torch.solvers.blocked.train_epochs_blocked
   on the full ML-25M-shaped synthetic with the preset unchanged, through
   both kernels (launch counters > 0), held-out RMSE (unclipped) <= 0.406
   after epoch 2.

The second-to-last line is a JSON object describing each kernel; the last
is {"ok": true, "device": {...}}. Any failure exits non-zero with no such
line, and so does a machine without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

RMSE_GATE = 0.406  # the reference's quality gate on this synthetic
TOL = 1e-4
SWEEP_TILES = 2048
DENSE_STRATA = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 1) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, run_kernel, run_plain, state):
    """Kernel twice from the same state (bitwise equal), plain once;
    returns (max_abs_err, kernel ms, plain ms)."""
    import torch

    outs = []
    for _ in range(2):
        tabs = [t.clone() for t in state]
        sse = run_kernel(*tabs)
        torch.cuda.synchronize()
        outs.append((tabs, float(sse)))
    (k1, s1), (k2, s2) = outs
    if s1 != s2 or any(not torch.equal(a, b) for a, b in zip(k1, k2)):
        raise AssertionError(f"{name}: two kernel runs differ")
    tabs = [t.clone() for t in state]
    sse_p = float(run_plain(*tabs))
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(k1, tabs))
    if not all(bool(torch.isfinite(t).all()) for t in k1):
        raise AssertionError(f"{name}: non-finite tables")
    if err > TOL or abs(s1 - sse_p) > TOL * max(1.0, abs(sse_p)):
        raise AssertionError(
            f"{name}: max abs err {err} (sse {s1} vs {sse_p}) above {TOL}")
    tabs = [t.clone() for t in state]
    ms = cuda_ms(lambda: run_kernel(*tabs), reps=3)
    tabs = [t.clone() for t in state]
    plain_ms = cuda_ms(lambda: run_plain(*tabs))
    log(f"[kernel] {name}: max_abs_err={err:.3e} (tol {TOL}) sse={s1} "
        f"plain_sse={sse_p} ms={ms:.4f} plain_ms={plain_ms:.4f}")
    return err, ms, plain_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on a GPU")
    from mfx.config import preset
    from mfx.data.split import train_test_split
    from mfx.data.synthetic import ML25M_SHAPE, make_synthetic
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.dense_phase import dense_phase, dense_phase_plain
    from mfx_torch.kernels.packing import lane_tables
    from mfx_torch.kernels.sgd_sweep import sgd_sweep, sgd_sweep_plain
    from mfx_torch.models.mf import init_model
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers.dense_prep import prepare_dense_full

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] both kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({_build.BUILD_DIR})")

    # data: the ml-25m entry of mfx/data/loaders.py (its seeded synthetic)
    cfg = preset("ml25m_rank64")
    sgd = cfg.sgd
    t0 = time.perf_counter()
    coo = make_synthetic(*ML25M_SHAPE, rank=64, seed=102, star_step=0.5,
                         user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    log(f"[data] {coo.num_users} x {coo.num_items}, {coo.n_ratings} ratings "
        f"({train.n_ratings} train / {test.n_ratings} test) in "
        f"{time.perf_counter() - t0:.1f} s")
    U, I, rank = coo.num_users, coo.num_items, cfg.model.rank
    su, si, T, tpg = sgd.ublock, sgd.iblock, sgd.tile, blocked.TPG

    def fresh_model():
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          device=dev)

    # 3. kernels against plain versions at the preset's shapes
    rfmt = blocked.dense_rfmt(sgd, rank, train.rating)
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    meta, groups, (u, i, r), _ = prepare_dense_full(
        u, i, r, U, I, su, si, chi_min=sgd.dense_chi,
        nwd=blocked.dense_group_windows(rank, si), rfmt=rfmt)
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg,
                                   blocked.sweep_geometry(I, rank, si))
    tl = pdv.epoch_tiles_device(skel, u, i, r, cfg.data.seed, 0)
    P, Q = lane_tables(fresh_model(), su, si, dev)
    mu, lr, reg = float(train.global_mean), sgd.lr, sgd.reg
    results = {}

    win0, nw = meta[0]
    grp = {k: v[:DENSE_STRATA].contiguous() for k, v in groups[0].items()}
    seg = slice(win0 * si, (win0 + nw) * si)
    log(f"[kernel] dense_phase: {grp['sa'].shape[0]} strata of group 0 "
        f"({rfmt}, {su}x{si}, rank {rank})")
    results["dense_phase"] = compare(
        "dense_phase",
        lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp, lr, reg, mu, su=su,
                                   si=si),
        lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp, lr, reg, mu,
                                         su=su, si=si),
        (P, Q),
    )

    sw = next(s for s in skel.sweeps if s.t1 > s.t0)
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tc = sw.sa[: nt // tpg].contiguous(), sw.tc[:nt].contiguous()
    tls = tl[sw.t0:sw.t0 + nt]
    seg_s = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    log(f"[kernel] sgd_sweep: {nt} tiles of the first sweep (T={T}, "
        f"rank {rank})")
    results["sgd_sweep"] = compare(
        "sgd_sweep",
        lambda Pt, Qt: sgd_sweep(Pt, Qt[seg_s], sa, tc, tls, lr, reg, mu,
                                 su=su, si=si, tpg=tpg),
        lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg_s], sa, tc, tls, lr, reg,
                                       mu, su=su, si=si, tpg=tpg),
        (P, Q),
    )
    del meta, groups, grp, skel, tl, tls, P, Q, u, i, r
    torch.cuda.empty_cache()

    # 4. the main path, through the kernels
    sgd_sweep.launches = 0
    dense_phase.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    model = fresh_model()
    torch.cuda.synchronize()
    gen = blocked.train_epochs_blocked(
        model, train, dataclasses.replace(sgd, epochs=2), cfg.model.use_bias,
        seed=cfg.data.seed, device=dev, timings=timings)
    test_rmse = None
    plan_seen = 0.0
    t_prev = time.perf_counter()
    for epoch, m, tr in gen:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_prev
        plan_s = timings["plan_s"] - plan_seen
        plan_seen = timings["plan_s"]
        epoch_s = wall - plan_s - (timings["prep_s"] if epoch == 0 else 0.0)
        if epoch == 0:
            info = timings["dense_info"]
            log(f"[main] prep {timings['prep_s']:.3f} s: dense_frac "
                f"{info['dense_frac']:.4f}, {info['num_strata']} strata in "
                f"{info['num_groups']} groups, R image "
                f"{info['r_stream_bytes']} bytes")
        test_rmse, test_mae = rmse_mae(m, test)
        train_rmse = float(tr)
        log(f"[main] epoch {epoch}: epoch_s {epoch_s:.4f} plan_s {plan_s:.4f} "
            f"train_rmse {train_rmse:.5f} test_rmse {test_rmse:.5f} "
            f"test_mae {test_mae:.5f}")
        finite = all(bool(torch.isfinite(getattr(m, k)).all())
                     for k in ("P", "Q", "bu", "bi"))
        if not finite or m.P.shape != (U, rank) or m.Q.shape != (I, rank):
            raise AssertionError("model tables not finite or mis-shaped")
        t_prev = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {"sgd_sweep": sgd_sweep.launches,
                "dense_phase": dense_phase.launches}
    log(f"[main] launches {launches}, peak memory allocated {peak} bytes")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if not test_rmse <= RMSE_GATE:
        raise AssertionError(f"test RMSE {test_rmse} above the {RMSE_GATE} gate")

    replaces = {"sgd_sweep": "mfx/kernels/sgd_pallas.py:63",
                "dense_phase": "mfx/kernels/dense_pallas.py:86"}
    log(f"[card] {card}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"mfx_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, (err, ms, plain_ms) in results.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: report and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr)
        sys.exit(1)
