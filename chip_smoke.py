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
   after epoch 2;
5. tile_topk against its plain version at 1,000,000 items, rank 64,
   B = 256, tile 1024 (seeded random tables): f32 at depth 2 and 8, bf16
   and int8 at depth 2, values within 1e-4, lanes equal except near-ties,
   two kernel runs bitwise equal, and the time of each;
6. serving path: the phase-4 model through a checkpoint (bitwise round
   trip), the stock, fused and certified-exact fused recommenders with
   the training ratings excluded (exact == stock; the fused contract and
   its recall@10), the HTTP server (every endpoint 200, answers equal to
   direct calls) and the CLI, with tile_topk launched (counter > 0).

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
SERVE_ITEMS, SERVE_B, SERVE_TILE = 1_000_000, 256, 1024
TOPK_VARIANTS = (("f32", 2), ("f32", 8), ("bf16", 2), ("int8", 2))
K = 10


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


def _true_scores(P_aug, Q_aug, sb, rows, items):
    """f64 scores of (row, item) pairs of the augmented tables."""
    s = (P_aug[rows].double() * Q_aug[items].double()).sum(1)
    if sb is not None:
        flat = sb.transpose(0, 1).reshape(2, -1).double()
        s = s * flat[0, items] + flat[1, items]
    return s


def topk_phase(dev):
    """Phase 5: tile_topk against its plain version at the serving shape;
    returns (max abs err over the variants, f32 depth-2 ms, its plain ms)."""
    import torch

    from mfx_torch.kernels.serve_topk import (aug_width, tile_topk,
                                              tile_topk_plain)
    from mfx_torch.serve.fused import (_augment_catalog,
                                       _augment_catalog_int8, _augment_rows)

    rank, tile = 64, SERVE_TILE
    g = torch.Generator(device=dev).manual_seed(5)
    P = torch.randn(SERVE_B, rank, device=dev, generator=g)
    Q = torch.randn(SERVE_ITEMS, rank, device=dev, generator=g) / rank ** 0.5
    bi = torch.randn(SERVE_ITEMS, device=dev, generator=g) * 0.3
    ipad = -(-SERVE_ITEMS // tile) * tile
    log(f"[kernel] tile_topk: {SERVE_ITEMS} items, rank {rank}, B {SERVE_B}, "
        f"tile {tile}, augmented width {aug_width(rank)}")
    worst, head = 0.0, None
    for dtype, depth in TOPK_VARIANTS:
        if dtype == "int8":
            Q_aug, sb = _augment_catalog_int8(Q, bi, ipad, tile)
            P_aug = _augment_rows(P, torch.float32, aug_width(rank))
        else:
            dt = torch.bfloat16 if dtype == "bf16" else torch.float32
            Q_aug, sb = _augment_catalog(Q, bi, ipad, dt), None
            P_aug = _augment_rows(P, dt, aug_width(rank))

        def run():
            return tile_topk(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)

        outs = [run(), run()]
        torch.cuda.synchronize()
        if any(not torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"tile_topk {dtype}: two kernel runs differ")
        want = tile_topk_plain(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
        err, swaps, swap_gap = 0.0, 0, 0.0
        for j in range(0, 2 * depth, 2):
            (m_k, a_k), (m_p, a_p) = outs[0][j:j + 2], want[j:j + 2]
            if not bool(torch.isfinite(m_k).all()):
                raise AssertionError(f"tile_topk {dtype}: non-finite values")
            err = max(err, float((m_k - m_p).abs().max()))
            bad = a_k != a_p
            if bool(bad.any()):
                b, t = bad.nonzero(as_tuple=True)
                base = t * tile
                gap = (_true_scores(P_aug, Q_aug, sb, b, base + a_k[bad])
                       - _true_scores(P_aug, Q_aug, sb, b, base + a_p[bad]))
                swaps += int(bad.sum())
                swap_gap = max(swap_gap, float(gap.abs().max()))
        if err > TOL or swap_gap > TOL:
            raise AssertionError(
                f"tile_topk {dtype} depth {depth}: max abs err {err}, lane "
                f"swaps {swaps} with score gap {swap_gap} (tol {TOL})")
        del want
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(lambda: tile_topk_plain(P_aug, Q_aug, tile=tile,
                                                   depth=depth, sb=sb))
        log(f"[kernel] tile_topk {dtype} depth {depth}: max_abs_err={err:.3e} "
            f"(tol {TOL}) lane swaps {swaps} (near-ties, gap <= "
            f"{swap_gap:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f}")
        worst = max(worst, err)
        if head is None:
            head = (ms, plain_ms)
        del outs, Q_aug, P_aug, sb
        torch.cuda.empty_cache()
    return worst, head[0], head[1]


def _post(port, path, body=None):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        raw = r.read()
    return raw.decode() if path == "/metrics" else json.loads(raw)


def _batch_ms(rec, users):
    t0 = time.perf_counter()
    rec.recommend(users, k=K)
    n = -(-len(users) // rec.batch)
    return (time.perf_counter() - t0) * 1e3 / n


def serve_phase(model, train, dev, seed):
    """Phase 6: the trained model through a checkpoint, the recommenders,
    the HTTP server and the CLI. Returns tile_topk's launches."""
    import tempfile
    import threading
    from pathlib import Path

    import numpy as np
    import torch

    from mfx_torch.kernels.serve_topk import tile_topk
    from mfx_torch.serve import (FusedTopKRecommender, TopKRecommender,
                                 recommend_cold, similar_items_fused)
    from mfx_torch.serve.server import RecServer
    from mfx_torch.train.checkpoint import load_checkpoint, save_checkpoint

    tile_topk.launches = 0
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckdir:
        t0 = time.perf_counter()
        save_checkpoint(ckdir, 1, model, seed=seed)
        served, epoch, _ = load_checkpoint(ckdir, device=dev)
        same = all(torch.equal(getattr(served, k), getattr(model, k))
                   for k in ("P", "Q", "bu", "bi"))
        if not same or np.float32(served.mu) != np.float32(model.mu):
            raise AssertionError("checkpoint round trip is not bitwise")
        log(f"[serve] checkpoint saved and loaded bitwise in "
            f"{time.perf_counter() - t0:.2f} s (epoch {epoch})")

        t0 = time.perf_counter()
        stock = TopKRecommender(served, train=train, device=dev)
        approx = FusedTopKRecommender(served, train=train, device=dev)
        exact = FusedTopKRecommender(served, train=train, exact=True,
                                     exact_tiles=16, device=dev)
        log(f"[serve] recommenders built in {time.perf_counter() - t0:.2f} s")

        counts = np.bincount(train.user, minlength=served.num_users)
        p99 = float(np.percentile(counts[counts > 0], 99))
        rng = np.random.default_rng(seed)
        light = rng.choice(np.flatnonzero((counts > 0) & (counts <= p99)),
                           4096, replace=False).astype(np.int32)
        heavy = np.argsort(counts, kind="stable")[-256:].astype(np.int32)
        log(f"[serve] users: 4096 drawn with 1..{p99:g} training ratings "
            f"(the 99th percentile; drawn max {counts[light].max()}), and "
            f"the 256 heaviest ({counts[heavy].min()}..{counts[heavy].max()})"
            " for stock and exact")

        both = np.concatenate([light, heavy])
        si, ss = stock.recommend(both, k=K)
        ei, es = exact.recommend(both, k=K)
        diff = ei != si
        gap = np.abs(es - ss)
        if not np.all(gap <= TOL) or not np.all(np.isfinite(es)):
            raise AssertionError(f"exact != stock: score gap {gap.max()}")
        log(f"[serve] exact == stock on {len(both)} users: {int(diff.sum())} "
            f"item swaps, all near-ties (score gap <= {gap.max():.3e}); "
            f"exact_fallbacks {exact.exact_fallbacks} of "
            f"{-(-len(both) // exact.batch)} batches")

        ai, as_ = approx.recommend(light, k=K)
        csr = stock._seen
        u_t = torch.as_tensor(light, device=dev).long()[:, None]
        i_t = torch.as_tensor(ai, device=dev).long()
        true = (served.mu + served.bu[u_t] + served.bi[i_t]
                + (served.P[u_t] * served.Q[i_t]).sum(-1)).double()
        err = float((true - torch.as_tensor(as_, device=dev)).abs().max())
        seen_hit = sum(np.isin(ai[b], csr.items[csr.offsets[u]:
                                                 csr.offsets[u + 1]]).any()
                       for b, u in enumerate(light))
        if (seen_hit or (ai >= served.num_items).any() or err > TOL
                or (np.diff(as_, axis=1) > 0).any()):
            raise AssertionError(
                f"fused contract broken: {seen_hit} users served seen items, "
                f"score error {err}")
        recall = np.mean([len(set(ai[b]) & set(si[b])) / K
                          for b in range(len(light))])
        log(f"[serve] fused (approximate) contract holds on {len(light)} "
            f"users: no seen or pad items, scores within {err:.3e} of the "
            f"true scores, sorted; recall@{K} against stock {recall:.4f}")
        # the approximate path can miss only where > 2 of a user's true
        # top-K share a tile
        tiles = si[:len(light)] // approx.tile
        crowded = np.mean([np.bincount(t).max() > 2 for t in tiles])
        log(f"[serve] stock top-{K} of those users: {(tiles == 0).mean():.4f} "
            f"of the items in tile 0, {crowded:.4f} of the users with more "
            "than 2 in one tile")
        log(f"[serve] ms per batch of {stock.batch} (host clock, warm): "
            f"stock {_batch_ms(stock, light):.3f}, fused "
            f"{_batch_ms(approx, light):.3f}, exact "
            f"{_batch_ms(exact, light):.3f}")

        srv = RecServer(
            approx,
            similar=lambda q, k: similar_items_fused(served, q, k=k,
                                                     device=dev),
            cold=lambda hs, k: recommend_cold(served, hs, k=k),
            host="127.0.0.1", port=0)
        srv.start()
        try:
            bodies = [{"users": light[:3].tolist(), "k": K},
                      {"users": light[3:5].tolist(), "k": K}]
            answers = [None, None]

            def post(n):
                answers[n] = _post(srv.port, "/recommend", bodies[n])

            threads = [threading.Thread(target=post, args=(n,))
                       for n in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            for body, ans in zip(bodies, answers):
                items, scores = approx.recommend(body["users"], k=K)
                if (ans is None or ans["items"] != items.tolist()
                        or ans["scores"] != scores.tolist()):
                    raise AssertionError("/recommend != a direct call")
            q = [0, 1, 500]
            sim = _post(srv.port, "/similar", {"items": q, "k": K})
            want = similar_items_fused(served, q, k=K, device=dev)
            if sim["similar"] != want[0].tolist():
                raise AssertionError("/similar != a direct call")
            hist = [[[0, 5.0], [3, 4.0], [70, 1.0]], [[12, 3.5]]]
            cold = _post(srv.port, "/recommend_cold",
                         {"histories": hist, "k": K})
            want = recommend_cold(
                served, [(np.array([p[0] for p in h], np.int32),
                          np.array([p[1] for p in h], np.float32))
                         for h in hist], k=K)
            if cold["items"] != want[0].tolist():
                raise AssertionError("/recommend_cold != a direct call")
            health = _post(srv.port, "/healthz")
            metrics = _post(srv.port, "/metrics")
            if 'path="/recommend",code="200"} 2' not in metrics:
                raise AssertionError("/metrics did not count the requests")
        finally:
            srv.stop()
        log(f"[serve] HTTP: /recommend x2 (concurrent), /similar, "
            f"/recommend_cold, /healthz ({health['recommender']}), /metrics "
            "all 200 and equal to direct calls")

        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "mfx_torch.cli", "recommend",
             "--checkpoint", ckdir, "--users", "0,1,2", "--fused",
             "--device", "cuda"],
            capture_output=True, text=True, timeout=300)
        lines = res.stdout.strip().splitlines()
        if res.returncode != 0 or len(lines) != 3 or any(
                len(json.loads(x)["items"]) != K for x in lines):
            raise AssertionError(f"CLI recommend failed:\n{res.stderr[-2000:]}")
        log(f"[serve] CLI recommend --fused --device cuda: 3 users in "
            f"{time.perf_counter() - t0:.1f} s (process included)")
    launches = tile_topk.launches
    log(f"[serve] launches {{'tile_topk': {launches}}}")
    if launches < 1:
        raise AssertionError("tile_topk never launched on the serving path")
    return launches


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
    log(f"[build] all kernels built and loaded in "
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

    # 5. tile_topk against its plain version at the serving shape
    results["tile_topk"] = topk_phase(dev)

    # 6. the serving path, on the model phase 4 trained
    launches["tile_topk"] = serve_phase(m, train, dev, cfg.data.seed)

    replaces = {"sgd_sweep": "mfx/kernels/sgd_pallas.py:63",
                "dense_phase": "mfx/kernels/dense_pallas.py:86",
                "tile_topk": "mfx/kernels/serve_pallas.py:42"}
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
