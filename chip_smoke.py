#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (mfx_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and nvcc, and
imports nothing of JAX and nothing of the JAX package mfx. Phases, each
printed as it ends:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every kernel from mfx_torch/csrc;
3. kernels against their plain PyTorch versions at the ml25m_rank64
   preset's shapes (su = si = 1024, T = 256, rank 64, int4; the rank-64
   instances of the two kernels that phase 11 runs at rank 128): the first
   2,048 tiles of the first non-empty sparse sweep and the first 64
   strata of the first dense group, max abs difference <= 1e-4, two
   kernel runs bitwise equal, and the time of each; then dense_phase on
   the first 256 strata of group 0 twice on one block and twice on the
   card's count (tables and SSE bitwise equal), and the whole of group 0
   and the whole dense phase of an epoch on the card's count; then the
   same 2,048 tiles through sgd_sweep_tile and sgd_sweep_step_u (tpg = 4) on the
   plain tables of the same model, so that the lane, tile-bias and
   step-batched bodies are timed on one tile stream; then sgd_sweep on
   the whole first sweep from the untrained tables, twice on one block
   and twice on as many as the card holds: tables and SSE bitwise equal,
   the times, the sweep's tiles and the tiles on its longest dependency
   chain, and the blocks launched;
4. main path: two epochs of mfx_torch.solvers.blocked.train_epochs_blocked
   on the full ML-25M-shaped synthetic with the preset unchanged, through
   both kernels (launch counters > 0), held-out RMSE (unclipped) <= 0.406
   after epoch 2;
5. tile_topk against its plain version at 1,000,000 items, rank 64,
   B = 256, tile 1024 (seeded random tables): f32 at depth 2 and 8, bf16
   and int8 at depth 2, values within 1e-4, lanes equal except near-ties,
   two kernel runs bitwise equal, and the time of each beside the stock
   path's (matmul_f32, then torch.topk over each tile);
6. serving path: the phase-4 model through a checkpoint (bitwise round
   trip), the stock, fused and certified-exact fused recommenders with
   the training ratings excluded (exact == stock; the fused contract and
   its recall@10), the HTTP server (every endpoint 200, answers equal to
   direct calls) and the CLI, with tile_topk launched (counter > 0);
7. bpr_sweep against its plain version at the BPR cell's shapes (su =
   si = 512, T = 256, rank 64): the first 2,048 tiles of segment 0 of
   epoch 0, max abs difference <= 1e-4, two kernel runs bitwise equal,
   and the time of each; then the whole of segment 0 twice on one block
   and twice on as many as the card holds, as in phase 3;
8. the BPR path: mfx_torch.parallel.bpr_sharded.train_epochs_bpr_ring with
   the billion_bpr_sharded preset unchanged but for parallel.model_axis=1,
   its 5 epochs on the billion-implicit synthetic cut to 1/10 of its users,
   items and positives (seed 104, test_frac 0.001): the loss falls every
   epoch and ends below ln 2, bpr_sweep launched (counter > 0), and as a
   smoke check, not a quality gate (this synthetic is barely learnable at
   the cell's density), the held-out sampled AUC ends above the untrained
   model's; HR/NDCG/MRR@10 (sampled protocol) are printed;
9. sgd_sweep_tile and sgd_sweep_step_u against their plain versions at the
   ml1m_rank32_biased preset's shapes (su = si = 512, T = 256, rank 32,
   tpg = 4): the first 2,048 tiles of epoch 0 of the ML-1M-shaped
   synthetic, same checks and times; then each over the whole sweep
   twice on one block and twice on the card's count (tables, biases and
   SSE bitwise equal);
10. the tile-bias path: train_epochs_blocked with the ml1m_rank32_biased
   preset unchanged, its 30 epochs on the full ML-1M-shaped synthetic
   (seed 101), through sgd_sweep_tile; then again with
   sgd.step_user_batch=true, through sgd_sweep_step_u (each launch counter
   > 0 in its run). The train RMSE falls, the held-out RMSE (unclipped)
   ends <= 0.530 and below the untrained model's, the two runs end within
   1e-3 of each other, and a second step_user_batch run of 2 epochs
   repeats the first's state after 2 epochs bit for bit;
11. sgd_sweep at rank 128 and dense_phase with int8 codes at rank 128
   against their plain versions at the netflix100m_rank128_dp preset's
   shapes (su = si = 512, T = 256, rank 128, lane biases, auto carving)
   on the full netflix synthetic (480,189 x 17,770, 100,480,507 ratings,
   seed 103, whole stars): the first 2,048 tiles of the sparse sweep and
   the first 64 strata of dense group 0, same checks and times; the
   whole sweep and the whole of group 0 twice on one block and twice on
   the card's count (tables and SSE bitwise equal); then each dense group
   and the sweep on the card's count, the split of an epoch;
12. the netflix path: train_epochs_blocked with netflix100m_rank128_dp and
   parallel.mode=single, 3 of its 15 epochs (epochs are depth, cut for
   time): both kernels launched, the train RMSE falls every epoch and the
   held-out RMSE (unclipped) lies below the untrained model's after every
   epoch (the reference's own held-out RMSE on this synthetic is lowest
   after the first epoch: tests/test_torch_slice.py::
   test_netflix_cut_follows_the_reference_trainer), peak memory <= 80 GB,
   and a second run of 1 epoch repeats the first run's state after epoch
   1 bit for bit;
13. Java parity on the card: mfx_torch.solvers.sgd.train_epochs with
   partitioner='fixed' and batch_size = 1, 2 epochs on a seeded synthetic
   of 2,000 ratings (60 x 80, seed 105, rank 8, biases) from tables shared
   through model_from_numpy: the tables and biases within 5e-5 (the
   reference's own tolerance) of the float64 sequential oracle
   (mfx_torch.oracle); a second run bitwise equal; conflict-free batches
   of 32 and 128 give bitwise-equal tables;
14. the minibatch path: the ml100k_rank16 preset unchanged (rank 16, no
   biases, conflict-free batches of 2,048, 30 epochs) on the full
   ML-100K-shaped synthetic (943 x 1,682, 100,000 ratings): one epoch's
   plan (batches, real ratings), the epoch dispatched op by op and replayed
   as a CUDA graph (the trainer's form on the card) bitwise equal, their
   times, a graph-replayed epoch with no host sync (sync debug mode
   'error'), a kernel breakdown of 256 batches; then the 30 epochs through
   mfx_torch.train.driver.train with log_path and checkpoints: the train
   RMSE falls every epoch, the held-out RMSE ends <= 0.533 and below the
   untrained model's, one JSONL record an epoch; the run resumed from its
   epoch-14 checkpoint equals it bit for bit; the CLI's update with a
   seeded delta of 2,000 ratings (10 new users, 10 new items) grows the
   tables by 10 and 10 as step 30, and recommend --fused on it launches
   tile_topk (counter > 0); each of those launches is made again on the
   inputs recommend gave it (rank 16, tile 128, depth 2) and held against
   tile_topk_plain as in phase 5;
15. the time form of sgd_sweep (blocked timeSVD) against its plain
   version on phase 4's ML-25M-shaped synthetic made temporal (the
   reference tests' recipe: seeded timestamps in [0, 1e6), a N(0, 0.35)
   shift per (item, bin) on 30 bins, ratings clipped to [0.5, 5]; seed
   102) at the blocked timeSVD trainer's shapes (rank 64, 30 bins, su = si
   = 512, T = 256, tpg 4): the first 2,048 tiles of the first sweep of
   epoch 0, max abs difference <= 1e-4, two kernel runs bitwise equal, the
   time of each; the whole first sweep twice on one block and twice on
   the card's count (tables and SSE bitwise equal); the rank-128 form on
   the same 2,048 tiles and the whole sweep, checked the same way;
16. the timeSVD path: mfx_torch.train.driver.train with solver='timesvd',
   timesvd.kernel='pallas', rank 64 and TimeSVDConfig's defaults (20
   epochs) but reg_alpha = reg, on phase 15's data handed to the driver
   through data.root as the loader's synthetic cache: the time form
   launched (counter > 0, the lane form not at all), the train RMSE falls
   every epoch, the held-out time-aware RMSE ends below the untrained
   model's and below lane-biased MF's (sgd_sweep, no dense phase) with
   the same storage rank, blocks, epochs, lr and reg on the same split,
   and a second run of 2 epochs repeats the first's state after 2 epochs
   (its checkpoint) bit for bit; then timesvd.kernel='jnp' (the
   snapshot-minibatch trainer, with timesvd.dup_trust=16: without it the
   reference's own trainer reaches NaN on this skew; its 20 epochs)
   through the driver on the ML-1M-shaped synthetic made temporal the
   same way (seed 101):
   the train RMSE falls every epoch, and the held-out RMSE is the
   time-aware one of the trainer's model.

Each phase prints its wall time. The second-to-last line is a JSON object
describing each kernel (times, launches on the main path, and the bound:
the least time the card could take for the same bytes and operations; for
the sweeps also the whole-sweep times on one block and on the card's
count; for dense_phase those of 256 strata and the times of group 0 and
of the epoch's dense phase, for dense_phase_int8_r128 those of the whole
group 0; for tile_topk every variant's times and the stock path's, whose
f32 depth-2 time is its library_ms, and phase 14's launches and check).
The rank-128 forms are entries of
their own (sgd_sweep_r128, dense_phase_int8_r128), their launches from
phase 12; sgd_sweep_time's launches are phase 16's, and its rank-128 form,
which no path runs, is its entry's "r128"; the last is
{"ok": true, "device": {...}}. Any failure
exits non-zero with no such line, and so does a machine without a CUDA
device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

RMSE_GATE = 0.406  # the reference's quality gate on this synthetic
# ML-1M-shaped synthetic, 30 epochs: the reference trainer ends at 0.52532
# from an untrained 0.55114 (whole-star rounding sets a floor near 0.5)
ML1M_RMSE_GATE = 0.530
ML1M_BODIES_TOL = 1e-3  # final held-out RMSE, per tile vs step_user_batch
TOL = 1e-4
# the BPR cell: billion-implicit cut to 1/10 of BILLION_SHAPE, one shard
BPR_CUT = 10
# the card's published peaks (H100 SXM data sheet): HBM bytes/s and f32
# FLOP/s outside the tensor cores; every kernel here does f32 FMA
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
SWEEP_TILES = 2048
DENSE_STRATA = 64
DENSE_WHOLE = 256  # strata of group 0 run on 1 block and on the card's count
NETFLIX_EPOCHS = 3  # of netflix100m_rank128_dp's 15: depth, cut for time
K = 10
# phase 13: the Java-parity synthetic and the reference's own tolerance
# (tests/parity/test_java_parity.py)
JAVA_SHAPE = (60, 80, 2_000)
JAVA_TOL = 5e-5
# ml100k_rank16, 30 epochs: the JAX trainer ends at 0.53151 and the port
# on the CPU at 0.53173 (each from its own seeded init)
ML100K_GATE = 0.533
PROFILE_BATCHES = 256  # phase 14's kernel breakdown
# phases 15-16: the temporal recipe of tests/unit/test_timesvd_blocked.py
# on TimeSVDConfig's 30 bins; the bin shift's spread
TIME_BINS, TIME_SHIFT = 30, 0.35


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what sets it): the least time for ``nbytes`` of device memory
    traffic and ``flops`` f32 operations at the card's peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sweep_bound(tl, sa, tc, su, si, tpg, rank, row_sides, flops_per_slot,
                bias=False, slot_ops=None):
    """Bound of a sparse sweep: the tile stream and ids read once, and every
    distinct table row its real slots touch read once and written once.
    ``row_sides`` lists (table, tile row) pairs: 'P' rows come from tile
    row 0 and the user block, 'Q' rows from the given row and the window.
    A real slot does ``flops_per_slot`` operations a lane, or ``slot_ops``
    in all where that is given.
    ``bias``: each of those rows also has a 4-byte bias, read once and
    written once, and a real slot does 6 more operations (two adds into
    the prediction, two bias deltas of two each)."""
    import torch

    real = tl[:, 0, :] < su
    t_of = torch.arange(tl.shape[0], device=tl.device)[:, None].expand_as(real)
    rows = {"P": [], "Q": []}
    for table, r in row_sides:
        if table == "P":
            ids = sa.long()[t_of // tpg] * su + tl[:, 0, :].long()
        else:
            ids = tc.long()[t_of] * si + tl[:, r, :].long()
        rows[table].append(ids[real])
    n_rows = sum(int(torch.unique(torch.cat(v)).numel())
                 for v in rows.values() if v)
    row_bytes = rank * 4 + (4 if bias else 0)
    nbytes = (tl.numel() + sa.numel() + tc.numel()) * 4 + 2 * n_rows * row_bytes
    if slot_ops is None:
        slot_ops = flops_per_slot * rank + (6 if bias else 0)
    return bound(nbytes, slot_ops * int(real.sum()))


def time_slot_ops(rank, n_bins):
    """Operations a real slot of the time form needs, with L = rank - 3 -
    n_bins factor lanes: the prediction, 2 for each of the L factor lanes
    and of its four scalar terms (bu, bi, bt at the slot's bin, alpha *
    dev); then 4 for each lane the step updates (P: L, alpha, bu; Q: L, the
    n_bins bt, bi). Lanes that hold constants or injections add nothing."""
    L = rank - 3 - n_bins
    return 2 * (L + 4) + 4 * (L + 2) + 4 * (L + n_bins + 1)


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


def whole_sweep(name, run, state, deps, max_blocks, grid=None,
                unit="tiles"):
    """``run(*tables, blocks)`` over a whole sweep (or dense strata) from
    ``state``, twice on one block and then twice on as many as the card
    holds: tables and scalar must be bitwise equal between all four.
    Returns the times, the blocks launched, the sweep's tiles (strata) and
    its critical path. ``grid``: the blocks the wrapper launches at the
    card's count (default: one a run, at most ``max_blocks``)."""
    import torch

    outs = []
    for blocks in (1, 1, None, None):
        tabs = [t.clone() for t in state]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scalar = run(*tabs, blocks)
        end.record()
        end.synchronize()
        outs.append((tabs, float(scalar), start.elapsed_time(end)))
    first = outs[0]
    for k, (tabs, s, _) in enumerate(outs[1:], 1):
        if s != first[1] or any(not torch.equal(a, b)
                                for a, b in zip(tabs, first[0])):
            raise AssertionError(
                f"{name}: run {k} ({'one block' if k < 2 else 'the card'}'s "
                f"grid) differs from the first one-block run ({s} vs "
                f"{first[1]})")
    if not all(bool(torch.isfinite(t).all()) for t in outs[-1][0]):
        raise AssertionError(f"{name}: non-finite tables")
    ms_one, ms_one2, ms_many, ms_again = (o[2] for o in outs)
    if grid is None:
        grid = min(max_blocks, deps.runs.shape[0])
    log(f"[kernel] {name} whole: {deps.n_tiles} {unit} in "
        f"{deps.runs.shape[0]} runs, critical path {deps.critical} {unit} "
        f"(x{deps.n_tiles / deps.critical:.2f} at most); 1 block "
        f"{ms_one:.4f} and {ms_one2:.4f} ms, {grid} blocks {ms_many:.4f} and "
        f"{ms_again:.4f} ms (x{ms_one / ms_many:.2f}); tables and scalar "
        f"bitwise equal across the four runs (scalar {outs[-1][1]})")
    return {"sweep_tiles": deps.n_tiles,
            "sweep_critical_tiles": deps.critical, "sweep_blocks": grid,
            "sweep_ms_1_block": ms_one, "sweep_ms": ms_many,
            "sweep_ms_again": ms_again}


def dense_bound(groups, su, si, rank):
    """Bound of the dense phase over ``groups``: every group tensor read
    once, each distinct P block and Q window of a group read and written
    once, and three (su x si x rank) products a stratum."""
    nbytes = flops = 0.0
    for grp in groups:
        nd = grp["sa"].shape[0]
        nbytes += sum(grp[k].numel() * grp[k].element_size()
                      for k in ("sa", "sc", "R", "du_s", "di_s"))
        nbytes += 2 * rank * 4 * (grp["sa"].unique().numel() * su
                                  + grp["sc"].unique().numel() * si)
        flops += 6.0 * su * si * rank * nd
    return bound(nbytes, flops)


def _true_scores(P_aug, Q_aug, sb, rows, items):
    """f64 scores of (row, item) pairs of the augmented tables."""
    s = (P_aug[rows].double() * Q_aug[items].double()).sum(1)
    if sb is not None:
        flat = sb.transpose(0, 1).reshape(2, -1).double()
        s = s * flat[0, items] + flat[1, items]
    return s


def hold_topk(what, got, P_aug, Q_aug, sb, tile, depth):
    """Holds tile_topk's result ``got`` against its plain version on the
    same inputs: every value within TOL, and a lane that differs only
    where the two lanes' true scores tie within TOL. Returns (max abs
    err, lane swaps, their largest score gap)."""
    import torch

    from mfx_torch.kernels.serve_topk import tile_topk_plain

    want = tile_topk_plain(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
    err, swaps, swap_gap = 0.0, 0, 0.0
    for j in range(0, 2 * depth, 2):
        (m_k, a_k), (m_p, a_p) = got[j:j + 2], want[j:j + 2]
        if not bool(torch.isfinite(m_k).all()):
            raise AssertionError(f"{what}: non-finite values")
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
            f"{what} depth {depth}: max abs err {err}, lane swaps {swaps} "
            f"with score gap {swap_gap} (tol {TOL})")
    return err, swaps, swap_gap


def topk_phase(dev):
    """Phase 5: tile_topk against its plain version at the serving shape;
    returns ((max abs err over the variants, f32 depth-2 ms, its plain
    ms), the f32 depth-2 bound, each variant's record)."""
    import torch

    from mfx_torch.kernels.serve_topk import (aug_width, tile_topk,
                                              tile_topk_plain)
    from mfx_torch.measure_topk import (PHASE5_VARIANTS, RANK, SERVE_B,
                                        SERVE_ITEMS, SERVE_TILE,
                                        serving_tables, stock_topk)

    rank, tile = RANK, SERVE_TILE
    log(f"[kernel] tile_topk: {SERVE_ITEMS} items, rank {rank}, B {SERVE_B}, "
        f"tile {tile}, augmented width {aug_width(rank)}")
    worst, head, variants = 0.0, None, []
    for dtype, depth in PHASE5_VARIANTS:
        P_aug, Q_aug, sb = serving_tables(dev, SERVE_B, SERVE_ITEMS, dtype)

        def run():
            return tile_topk(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)

        def stock():  # the yardstick: two PyTorch calls (three for int8)
            return stock_topk(P_aug, Q_aug, sb, tile, depth)

        outs = [run(), run()]
        torch.cuda.synchronize()
        if any(not torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"tile_topk {dtype}: two kernel runs differ")
        err, swaps, swap_gap = hold_topk(f"tile_topk {dtype}", outs[0], P_aug,
                                         Q_aug, sb, tile, depth)
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(lambda: tile_topk_plain(P_aug, Q_aug, tile=tile,
                                                   depth=depth, sb=sb))
        stock()  # warm-up
        stock_ms = cuda_ms(stock, reps=5)
        log(f"[kernel] tile_topk {dtype} depth {depth}: max_abs_err={err:.3e} "
            f"(tol {TOL}) lane swaps {swaps} (near-ties, gap <= "
            f"{swap_gap:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"stock_ms={stock_ms:.4f}")
        variants.append({"dtype": dtype, "depth": depth, "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms,
                         "stock_ms": stock_ms})
        worst = max(worst, err)
        if head is None:
            # f32 FMA over the rank + 1 lanes that carry a value (the
            # augmented width's zero lanes and the pad items not counted)
            # for every (row, item) pair; the tables read once, each
            # tile's depth (value, lane) written
            out_bytes = sum(x.numel() * x.element_size() for x in outs[0])
            head = (ms, plain_ms, bound(
                P_aug.numel() * P_aug.element_size()
                + Q_aug.numel() * Q_aug.element_size() + out_bytes,
                2.0 * SERVE_B * SERVE_ITEMS * (rank + 1)))
            log(f"[kernel] tile_topk f32 depth {depth} bound "
                f"{head[2][0]:.4f} ms ({head[2][1]})")
        del outs, Q_aug, P_aug, sb
        torch.cuda.empty_cache()
    return (worst, head[0], head[1]), head[2], variants


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


def bpr_phases(dev, results, bounds, sweeps):
    """Phases 7 and 8: bpr_sweep against its plain version at the BPR
    cell's shapes and on a whole segment, then the BPR path's 5 epochs.
    Fills ``results``, ``bounds`` and ``sweeps`` for bpr_sweep; returns its
    launches on the path."""
    import math

    import numpy as np
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.bpr import build_positive_index
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import (BILLION_SHAPE,
                                          make_implicit_synthetic)
    from mfx_torch.eval.metrics import sampled_auc
    from mfx_torch.eval.ranking import hr_ndcg_at_k
    from mfx_torch.kernels import _build
    from mfx_torch.kernels.bpr_sweep import bpr_sweep, bpr_sweep_plain
    from mfx_torch.models.mf import init_model
    from mfx_torch.parallel import bpr_sharded as ring
    from mfx_torch.solvers.blocked import TPG

    cfg = apply_overrides(preset("billion_bpr_sharded"),
                          ["parallel.model_axis=1"])
    bpr, seed = cfg.bpr, cfg.data.seed
    shape = tuple(x // BPR_CUT for x in BILLION_SHAPE)
    log(f"[bpr] cell: billion_bpr_sharded with parallel.model_axis=1 (1 "
        f"shard instead of {preset('billion_bpr_sharded').parallel.model_axis}"
        f"); billion-implicit cut to 1/{BPR_CUT} of BILLION_SHAPE "
        f"{BILLION_SHAPE}: {shape[0]} users x {shape[1]} items x {shape[2]} "
        f"positives; widths unchanged (rank {cfg.model.rank}, su = si = "
        f"{bpr.ublock}, T = {bpr.tile})")
    t0 = time.perf_counter()
    coo = make_implicit_synthetic(*shape, rank=64, seed=104)
    train, test = train_test_split(coo, cfg.data.test_frac, seed=seed)
    del coo
    log(f"[data] {train.num_users} x {train.num_items}, {train.n_ratings} "
        f"train / {test.n_ratings} test positives in "
        f"{time.perf_counter() - t0:.1f} s")
    U, I, rank = train.num_users, train.num_items, cfg.model.rank

    def fresh_model():
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale)

    # 7. bpr_sweep against its plain version: the first tiles of segment
    # 0 of epoch 0, from the untrained tables
    t_phase = time.perf_counter()
    st = ring.ring_state(fresh_model(), train, bpr, seed=seed, device=dev)
    tls = ring.ring_epoch_tiles(st, bpr, seed, 0)
    win0, nw, sa_all, tc_all, deps_all = st.segments()[0]
    nt = min(SWEEP_TILES, tls[0].shape[2])
    tl = tls[0][0, 0, :nt].contiguous()
    sa, tc = sa_all[:nt // TPG].contiguous(), tc_all[:nt].contiguous()
    deps = deps_all.prefix(nt)
    si = bpr.iblock
    seg = slice(win0 * si, (win0 + nw) * si)
    log(f"[kernel] bpr_sweep: {nt} tiles of segment 0 ({len(tls)} segments "
        f"of {[x.shape[2] for x in tls]} tiles; T={bpr.tile}, rank {rank}); "
        f"they hold {deps.runs.shape[0]} runs, critical path "
        f"{deps.critical} tiles")
    kw = dict(su=bpr.ublock, si=si, tpg=TPG)
    results["bpr_sweep"] = compare(
        "bpr_sweep",
        lambda Pt, Qt: bpr_sweep(Pt, Qt[seg], sa, tc, tl, bpr.lr, bpr.reg,
                                 deps=deps, **kw),
        lambda Pt, Qt: bpr_sweep_plain(Pt, Qt[seg], sa, tc, tl, bpr.lr,
                                       bpr.reg, **kw),
        (st.P, st.Q),
    )
    # per real slot: q_i - q_j (rank), the dot (2 rank), three deltas
    # (4 rank each) and three row adds (rank each)
    bounds["bpr_sweep"] = sweep_bound(tl, sa, tc, bpr.ublock, si, TPG, rank,
                                      [("P", 0), ("Q", 1), ("Q", 2)], 18)
    log(f"[kernel] bpr_sweep bound {bounds['bpr_sweep'][0]:.4f} ms "
        f"({bounds['bpr_sweep'][1]})")
    Pt, Qt = st.P.clone(), st.Q.clone()
    ms_one = cuda_ms(lambda: bpr_sweep(Pt, Qt[seg], sa, tc, tl, bpr.lr,
                                       bpr.reg, **kw), reps=3)
    log(f"[kernel] bpr_sweep: the same {nt} tiles on one block in plan "
        f"order (no dependency table) {ms_one:.4f} ms")
    del Pt, Qt
    # the whole of segment 0, on one block and on the card's count
    whole = tls[0][0, 0]
    sweeps["bpr_sweep"] = whole_sweep(
        "bpr_sweep",
        lambda Pt, Qt, blocks: bpr_sweep(Pt, Qt[seg], sa_all, tc_all, whole,
                                         bpr.lr, bpr.reg, deps=deps_all,
                                         blocks=blocks, **kw),
        (st.P, st.Q), deps_all,
        _build.load_library().mfx_bpr_sweep_max_blocks(bpr.tile))
    del st, tls, tl, whole
    torch.cuda.empty_cache()
    log(f"[time] phase 7 {time.perf_counter() - t_phase:.1f} s")

    # 8. the BPR path, through the kernel
    t_phase = time.perf_counter()
    keys = np.concatenate([build_positive_index(train),
                           build_positive_index(test)])
    keys.sort()
    model = fresh_model()
    auc0 = sampled_auc(model, test, seed=seed, pos_keys=keys)
    log(f"[bpr] untrained held-out sampled AUC {auc0:.5f} "
        f"({test.n_ratings} positives; keys built in "
        f"{time.perf_counter() - t_phase:.1f} s)")
    bpr_sweep.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    losses, auc = [], None
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    for epoch, m, loss in ring.train_epochs_bpr_ring(
            model, train, bpr, shards=1, seed=seed, device=dev,
            timings=timings):
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_prev
        if epoch == 0:
            log(f"[bpr] prep {timings['prep_s']:.3f} s (positive index, "
                "window bounds, plan skeleton); (tiles, critical path) of "
                f"each segment {timings['segment_tiles']}")
            wall -= timings["prep_s"]
        t_eval = time.perf_counter()
        auc = sampled_auc(m, test, seed=seed, pos_keys=keys)
        losses.append(loss)
        log(f"[bpr] epoch {epoch}: epoch_s {wall:.4f} (negatives "
            f"{timings['neg_s']:.4f}, plan {timings['plan_s']:.4f}, sweeps "
            f"{wall - timings['neg_s'] - timings['plan_s']:.4f}) mean_loss "
            f"{loss:.6f} test_auc {auc:.5f} (eval "
            f"{time.perf_counter() - t_eval:.1f} s)")
        finite = all(bool(torch.isfinite(getattr(m, k)).all())
                     for k in ("P", "Q"))
        if not finite or m.P.shape != (U, rank) or m.Q.shape != (I, rank):
            raise AssertionError("BPR tables not finite or mis-shaped")
        t_prev = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = bpr_sweep.launches
    # held-out positives whose (user, item) pair also occurs in training
    tk = build_positive_index(train)
    q = test.user.astype(np.int64) * I + test.item
    dup = tk[np.minimum(np.searchsorted(tk, q), len(tk) - 1)] == q
    new = test.select(np.flatnonzero(~dup))
    log(f"[bpr] {dup.mean():.5f} of the held-out positives also occur in "
        f"training; AUC over the others: untrained "
        f"{sampled_auc(model, new, seed=seed, pos_keys=keys):.5f}, final "
        f"{sampled_auc(m, new, seed=seed, pos_keys=keys):.5f}")
    t_eval = time.perf_counter()
    rk = hr_ndcg_at_k(m, test, k=cfg.ranking_k, seed=seed, pos_keys=keys)
    log(f"[bpr] test " + " ".join(f"{n}@{cfg.ranking_k} {v:.5f}"
                                   for n, v in rk.items())
        + f" (sampled protocol, 100 negatives; "
        f"{time.perf_counter() - t_eval:.1f} s)")
    log(f"[bpr] launches {{'bpr_sweep': {launches}}}, peak memory allocated "
        f"{peak} bytes")
    if launches < 1:
        raise AssertionError("bpr_sweep never launched on the BPR path")
    if len(losses) != bpr.epochs or any(
            b >= a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the BPR loss did not fall every epoch: "
                             f"{losses}")
    if not losses[-1] < math.log(2):
        raise AssertionError(f"final BPR loss {losses[-1]} not below ln 2")
    # a smoke check, not a quality gate: on this synthetic the final AUC
    # sits within about one standard error of the untrained model's
    if not auc > auc0:
        raise AssertionError(f"AUC {auc} not above the untrained {auc0}")
    log(f"[bpr] AUC smoke check (not a quality gate): final {auc:.5f} > "
        f"untrained {auc0:.5f}")
    log(f"[time] phase 8 {time.perf_counter() - t_phase:.1f} s")
    return launches


def tile_bias_compare(results, bounds, state, seg, sa, tc, tl, lr, reg, mu,
                      su, si, tpg, tag, deps):
    """sgd_sweep_tile and sgd_sweep_step_u (on the card's count, ordered
    by ``deps``) against their plain versions on one tile stream from the
    plain tables ``state`` = (P, Q, bu, bi); fills ``results`` and
    ``bounds`` under the kernels' names plus ``tag``."""
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep_step_u,
                                             sgd_sweep_step_u_plain,
                                             sgd_sweep_tile,
                                             sgd_sweep_tile_plain)

    rank = state[0].shape[1]
    log(f"[kernel] tile-bias sweeps{tag}: {tl.shape[0]} tiles (T="
        f"{tl.shape[2]}, rank {rank}, su={su}, si={si}, tpg={tpg})")
    kw = dict(su=su, si=si, tpg=tpg)
    for kernel, plain in ((sgd_sweep_tile, sgd_sweep_tile_plain),
                          (sgd_sweep_step_u, sgd_sweep_step_u_plain)):
        name = kernel.__name__ + tag
        results[name] = compare(
            name,
            lambda P, Q, bu, bi: kernel(P, Q[seg], bu, bi[seg], sa, tc, tl,
                                        lr, reg, mu, **kw, deps=deps),
            lambda P, Q, bu, bi: plain(P, Q[seg], bu, bi[seg], sa, tc, tl,
                                       lr, reg, mu, **kw),
            state,
        )
        # per real slot as sgd_sweep (10 rank), plus the bias terms
        bounds[name] = sweep_bound(tl, sa, tc, su, si, tpg, rank,
                                   [("P", 0), ("Q", 1)], 10, bias=True)
        log(f"[kernel] {name} bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})")


def tile_bias_phases(dev, sweeps):
    """Phases 9 and 10: the tile-bias kernels against their plain versions
    at the ml1m_rank32_biased preset's shapes and sgd_sweep_tile over the
    whole sweep (into ``sweeps``), then the preset's 30 epochs per tile and
    with sgd.step_user_batch. Returns the two kernels' launches, each from
    its own run."""
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML1M_SHAPE, make_synthetic
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.packing import plain_tables
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_step_u, sgd_sweep_tile
    from mfx_torch.models.mf import init_model
    from mfx_torch.solvers import blocked

    cfg = preset("ml1m_rank32_biased")
    sgd, seed = cfg.sgd, cfg.data.seed
    t0 = time.perf_counter()
    # the ml-1m entry of mfx_torch/data/loaders.py (its seeded synthetic)
    coo = make_synthetic(*ML1M_SHAPE, rank=32, seed=101, star_step=1.0,
                         user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac, seed=seed)
    log(f"[tile] cell: ml1m_rank32_biased unchanged (rank {cfg.model.rank}, "
        f"bias_mode={sgd.bias_mode!r}, su = si = {sgd.ublock}, T = "
        f"{sgd.tile}, lr {sgd.lr}, decay {sgd.lr_decay}, reg {sgd.reg}, "
        f"{sgd.epochs} epochs, no dense phase) on the ml-1m synthetic")
    log(f"[data] {coo.num_users} x {coo.num_items}, {coo.n_ratings} ratings "
        f"({train.n_ratings} train / {test.n_ratings} test) in "
        f"{time.perf_counter() - t0:.1f} s")
    U, I, rank = coo.num_users, coo.num_items, cfg.model.rank
    su, si, T, tpg = sgd.ublock, sgd.iblock, sgd.tile, blocked.TPG
    mu = float(train.global_mean)

    def fresh_model():
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale, device=dev)

    # 9. the kernels against their plain versions at the preset's shapes
    t_phase = time.perf_counter()
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg,
                                   blocked.sweep_geometry(I, rank, si))
    tl = pdv.epoch_tiles_device(skel, u, i, r, seed, 0)
    sw = next(s for s in skel.sweeps if s.t1 > s.t0)
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    log(f"[tile] plan: {len(skel.sweeps)} sweep(s), {tl.shape[0]} tiles an "
        f"epoch, {sw.nwin} windows in the first")
    state = plain_tables(fresh_model(), su, si, dev)
    seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    tile_bias_compare(
        {}, {}, state, seg, sw.sa[:nt // tpg].contiguous(),
        sw.tc[:nt].contiguous(), tl[sw.t0:sw.t0 + nt], sgd.lr, sgd.reg, mu,
        su, si, tpg, "[rank32]", sw.deps.prefix(nt))
    # the whole first sweep, to set beside phase 10's epoch seconds: each
    # kernel on one block and on the card's count (step_user_batch plans
    # the same sweeps here: sweep_geometry gives 8 windows either way)
    if blocked.sweep_geometry(I, rank, si, step_u=(su, T)) != sw.nwin:
        raise AssertionError("step_user_batch plans other sweeps here")
    lib = _build.load_library()
    for kernel, card in (
            (sgd_sweep_tile, lib.mfx_sgd_sweep_tile_max_blocks(T, rank)),
            (sgd_sweep_step_u,
             lib.mfx_sgd_sweep_step_u_max_blocks(T, rank, su))):
        sweeps[kernel.__name__] = whole_sweep(
            kernel.__name__,
            lambda P, Q, bu, bi, blocks, kernel=kernel: kernel(
                P, Q[seg], bu, bi[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1],
                sgd.lr, sgd.reg, mu, su=su, si=si, tpg=tpg, deps=sw.deps,
                blocks=blocks),
            state, sw.deps, card)
    # the whole sweep's bound, as tile_bias_compare counts it
    whole = sweep_bound(tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
                        [("P", 0), ("Q", 1)], 10, bias=True)
    log(f"[tile] the whole sweep's bound {whole[0]:.4f} ms ({whole[1]})")
    for name in ("sgd_sweep_tile", "sgd_sweep_step_u"):
        sweeps[name]["sweep_bound_ms"] = whole[0]
    del state
    del skel, tl, u, i, r
    torch.cuda.empty_cache()
    log(f"[time] phase 9 {time.perf_counter() - t_phase:.1f} s")

    # 10. the path: 30 epochs per tile, then 30 with step_user_batch
    t_phase = time.perf_counter()
    base_rmse, base_mae = rmse_mae(fresh_model(), test)
    log(f"[tile] untrained held-out rmse {base_rmse:.5f} mae {base_mae:.5f}")
    launches, finals, after2 = {}, {}, None
    for step_u in (False, True):
        kernel = sgd_sweep_step_u if step_u else sgd_sweep_tile
        tag = "step_u" if step_u else "per-tile"
        run_sgd = apply_overrides(
            cfg, [f"sgd.step_user_batch={str(step_u).lower()}"]).sgd
        sgd_sweep_tile.launches = sgd_sweep_step_u.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        timings: dict = {}
        trains, epoch_ss, plan_seen = [], [], 0.0
        torch.cuda.synchronize()
        t_prev = time.perf_counter()
        for epoch, m, tr in blocked.train_epochs_blocked(
                fresh_model(), train, run_sgd, cfg.model.use_bias, seed=seed,
                device=dev, timings=timings):
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_prev
            plan_s = timings["plan_s"] - plan_seen
            plan_seen = timings["plan_s"]
            epoch_ss.append(wall - plan_s
                            - (timings["prep_s"] if epoch == 0 else 0.0))
            trains.append(float(tr))
            if step_u and epoch == 1:
                after2 = m
            t_prev = time.perf_counter()
        counts = {"sgd_sweep_tile": sgd_sweep_tile.launches,
                  "sgd_sweep_step_u": sgd_sweep_step_u.launches}
        launches[kernel.__name__] = kernel.launches
        peak = torch.cuda.max_memory_allocated(dev)
        test_rmse, test_mae = rmse_mae(m, test)
        finals[tag] = test_rmse
        steady = sorted(epoch_ss[1:])[len(epoch_ss[1:]) // 2]
        log(f"[tile] {tag}: prep {timings['prep_s']:.4f} s, plan "
            f"{timings['plan_s']:.4f} s in all, epoch_s first "
            f"{epoch_ss[0]:.4f} median of the others {steady:.4f} sum "
            f"{sum(epoch_ss):.4f}")
        log(f"[tile] {tag}: train_rmse " + " ".join(f"{x:.5f}" for x in trains))
        log(f"[tile] {tag}: held-out rmse {test_rmse:.5f} mae {test_mae:.5f} "
            f"after epoch {len(trains)} (unclipped); launches {counts}, peak "
            f"memory allocated {peak} bytes")
        finite = all(bool(torch.isfinite(getattr(m, k)).all())
                     for k in ("P", "Q", "bu", "bi"))
        if (not finite or m.P.shape != (U, rank) or m.Q.shape != (I, rank)
                or m.bu.shape != (U,) or m.bi.shape != (I,)):
            raise AssertionError(f"{tag}: tables not finite or mis-shaped")
        if kernel.launches < 1:
            raise AssertionError(f"{tag}: {kernel.__name__} never launched")
        if len(trains) != sgd.epochs or not trains[-1] < trains[0]:
            raise AssertionError(f"{tag}: the train RMSE did not fall: {trains}")
        if not (test_rmse <= ML1M_RMSE_GATE and test_rmse < base_rmse):
            raise AssertionError(
                f"{tag}: held-out RMSE {test_rmse} above the {ML1M_RMSE_GATE} "
                f"gate or the untrained {base_rmse}")
    gap = abs(finals["per-tile"] - finals["step_u"])
    if gap > ML1M_BODIES_TOL:
        raise AssertionError(f"the two bodies end {gap} apart: {finals}")
    log(f"[tile] the two bodies end {gap:.3e} apart (tol {ML1M_BODIES_TOL})")
    run_sgd = dataclasses.replace(run_sgd, epochs=2)
    for _, again, _ in blocked.train_epochs_blocked(
            fresh_model(), train, run_sgd, cfg.model.use_bias, seed=seed,
            device=dev):
        pass
    if not all(torch.equal(getattr(again, k), getattr(after2, k))
               for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("step_user_batch: a second run of 2 epochs differs")
    log("[tile] step_u: a second run of 2 epochs repeats the first bit for bit")
    log(f"[time] phase 10 {time.perf_counter() - t_phase:.1f} s")
    return launches


def netflix_phases(dev, results, bounds, sweeps):
    """Phases 11 and 12: the rank-128 lane sgd_sweep and the int8 rank-128
    dense_phase against their plain versions at the netflix100m_rank128_dp
    preset's shapes, each over a whole sweep / group 0 on one block and on
    the card's count, and the epoch's split; then the preset's path, 3
    epochs of its 15 (epochs are depth: cut for time), and a 1-epoch
    repeat. Fills ``results``, ``bounds`` and ``sweeps`` under
    ``sgd_sweep_r128`` and ``dense_phase_int8_r128``; returns their
    launches on the path."""
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import NETFLIX_SHAPE, make_synthetic
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.dense_phase import (dense_phase, dense_phase_plain,
                                               group_prefix, plan_launch)
    from mfx_torch.kernels.packing import lane_tables
    from mfx_torch.kernels.sgd_sweep import sgd_sweep, sgd_sweep_plain
    from mfx_torch.models.mf import init_model
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers.dense_prep import prepare_dense_full

    cfg = apply_overrides(preset("netflix100m_rank128_dp"),
                          ["parallel.mode=single"])
    sgd, seed = cfg.sgd, cfg.data.seed
    U, I, rank = NETFLIX_SHAPE[0], NETFLIX_SHAPE[1], cfg.model.rank
    su, si, T, tpg = sgd.ublock, sgd.iblock, sgd.tile, blocked.TPG
    shards = preset("netflix100m_rank128_dp").parallel.model_axis
    log(f"[netflix] cell: netflix100m_rank128_dp with parallel.mode=single "
        f"(one card instead of the preset's {shards}-shard ring); rank "
        f"{rank}, bias_mode={sgd.bias_mode!r}, su = si = "
        f"{su}, T = {T}, dense_chi={sgd.dense_chi} dense_span="
        f"{sgd.dense_span!r}, lr {sgd.lr}, decay {sgd.lr_decay}, reg "
        f"{sgd.reg}; {NETFLIX_EPOCHS} of its {sgd.epochs} epochs")
    t0 = time.perf_counter()
    # the netflix entry of mfx_torch/data/loaders.py (its seeded synthetic)
    coo = make_synthetic(*NETFLIX_SHAPE, rank=128, seed=103, star_step=1.0,
                         user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac, seed=seed)
    log(f"[data] {coo.num_users} x {coo.num_items}, {coo.n_ratings} ratings "
        f"({train.n_ratings} train / {test.n_ratings} test) in "
        f"{time.perf_counter() - t0:.1f} s")
    del coo
    mu, lr, reg = float(train.global_mean), sgd.lr, sgd.reg

    def fresh_model():
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale, device=dev)

    # 11. the kernels at the preset's shapes
    t_phase = time.perf_counter()
    rfmt = blocked.dense_rfmt(sgd, rank, train.rating)
    nwd = blocked.dense_group_windows(rank, si)
    nwin = blocked.sweep_geometry(I, rank, si)
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    meta, groups, (u, i, r), info = prepare_dense_full(
        u, i, r, U, I, su, si, chi_min=sgd.dense_chi, nwd=nwd, rfmt=rfmt)
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg, nwin)
    tl = pdv.epoch_tiles_device(skel, u, i, r, seed, 0)
    sws = [s for s in skel.sweeps if s.t1 > s.t0]
    A, C = -(-U // su), -(-I // si)
    log(f"[netflix] geometry: {A} user blocks x {C} windows = {A * C} "
        f"strata; {nwin} windows a sparse sweep ({len(sws)} sweep(s)), "
        f"{nwd} a dense group ({len(groups)} groups); {rfmt} codes; "
        f"{info['num_strata']} dense strata "
        f"({[g['sa'].shape[0] for g in groups]} a group), dense_frac "
        f"{info['dense_frac']:.4f}, R image {info['r_stream_bytes']} bytes; "
        f"{tl.shape[0]} tiles an epoch")
    if (A, C, nwin, nwd, rfmt) != (938, 35, 35, 16, "int8"):
        raise AssertionError("the netflix geometry is not the reference's")
    for g in groups:
        plan_launch(g, su, si, rank)  # the launch orders, on the host
    P, Q = lane_tables(fresh_model(), su, si, dev)
    lib = _build.load_library()

    win0, nw = meta[0]
    seg = slice(win0 * si, (win0 + nw) * si)
    grp = group_prefix(groups[0], DENSE_STRATA)
    log(f"[kernel] dense_phase_int8_r128: {grp['sa'].shape[0]} strata of "
        f"group 0 ({rfmt}, {su}x{si}, rank {rank}); critical path "
        f"{grp['deps'].critical} strata")
    results["dense_phase_int8_r128"] = compare(
        "dense_phase_int8_r128",
        lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp, lr, reg, mu, su=su,
                                   si=si, deps=grp["deps"]),
        lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp, lr, reg, mu,
                                         su=su, si=si),
        (P, Q))
    bounds["dense_phase_int8_r128"] = dense_bound([grp], su, si, rank)
    dense_card = lib.mfx_dense_phase_max_blocks(rank, 1)
    g0 = groups[0]
    sweeps["dense_phase_int8_r128"] = whole_sweep(
        "dense_phase_int8_r128 (group 0)",
        lambda Pt, Qt, blocks: dense_phase(Pt, Qt[seg], g0, lr, reg, mu,
                                           su=su, si=si, deps=g0["deps"],
                                           blocks=blocks),
        (P, Q), g0["deps"], dense_card, grid=dense_card, unit="strata")
    sweeps["dense_phase_int8_r128"]["sweep_bound_ms"] = dense_bound(
        [g0], su, si, rank)[0]

    sw = sws[0]
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tc = sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous()
    tls = tl[sw.t0:sw.t0 + nt]
    deps = sw.deps.prefix(nt)
    seg_s = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    log(f"[kernel] sgd_sweep_r128: {nt} tiles of the sweep (T={T}, rank "
        f"{rank}); they hold {deps.runs.shape[0]} runs, critical path "
        f"{deps.critical} tiles")
    results["sgd_sweep_r128"] = compare(
        "sgd_sweep_r128",
        lambda Pt, Qt: sgd_sweep(Pt, Qt[seg_s], sa, tc, tls, lr, reg, mu,
                                 su=su, si=si, tpg=tpg, deps=deps),
        lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg_s], sa, tc, tls, lr, reg,
                                       mu, su=su, si=si, tpg=tpg),
        (P, Q))
    # per real slot, as sgd_sweep: 10 rank
    bounds["sgd_sweep_r128"] = sweep_bound(tls, sa, tc, su, si, tpg, rank,
                                           [("P", 0), ("Q", 1)], 10)
    sweeps["sgd_sweep_r128"] = whole_sweep(
        "sgd_sweep_r128",
        lambda Pt, Qt, blocks: sgd_sweep(
            Pt, Qt[seg_s], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu,
            su=su, si=si, tpg=tpg, deps=sw.deps, blocks=blocks),
        (P, Q), sw.deps, lib.mfx_sgd_sweep_max_blocks(T, rank))
    sweeps["sgd_sweep_r128"]["sweep_bound_ms"] = sweep_bound(
        tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
        [("P", 0), ("Q", 1)], 10)[0]
    for name in ("dense_phase_int8_r128", "sgd_sweep_r128"):
        log(f"[kernel] {name} bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}); whole {sweeps[name]['sweep_bound_ms']:.4f}"
            " ms")

    # where an epoch goes: each dense group, then the sparse sweep(s), in
    # the trainer's order on the card's grid, from the untrained tables
    # (the kernels' work does not depend on the values)
    Pt, Qt = P.clone(), Q.clone()
    split = []
    for k, ((w0, n), g) in enumerate(zip(meta, groups)):
        def run_group(g=g, w0=w0, n=n):
            dense_phase(Pt, Qt[w0 * si:(w0 + n) * si], g, lr, reg, mu, su=su,
                        si=si, deps=g["deps"])
        run_group()  # warm-up
        ms = cuda_ms(run_group, reps=2)
        b = dense_bound([g], su, si, rank)
        split.append((f"dense group {k}", g["deps"].n_tiles,
                      g["deps"].critical, ms, b[0]))
    for k, s in enumerate(sws):
        sg = slice(s.win0 * si, (s.win0 + s.nwin) * si)

        def run_sweep(s=s, sg=sg):
            sgd_sweep(Pt, Qt[sg], s.sa, s.tc, tl[s.t0:s.t1], lr, reg, mu,
                      su=su, si=si, tpg=tpg, deps=s.deps)
        ms = cuda_ms(run_sweep, reps=2)
        b = sweep_bound(tl[s.t0:s.t1], s.sa, s.tc, su, si, tpg, rank,
                        [("P", 0), ("Q", 1)], 10)
        split.append((f"sparse sweep {k}", s.deps.n_tiles, s.deps.critical,
                      ms, b[0]))
    for what, n, crit, ms, b in split:
        unit = "strata" if what.startswith("dense") else "tiles"
        log(f"[netflix] epoch split, {what}: {n} {unit}, critical path "
            f"{crit}: {ms:.4f} ms (mean of 2) against a bound of {b:.4f} ms")
    dense_ms = sum(x[3] for x in split if x[0].startswith("dense"))
    sparse_ms = sum(x[3] for x in split if x[0].startswith("sparse"))
    log(f"[netflix] epoch split: dense {dense_ms:.4f} ms + sparse "
        f"{sparse_ms:.4f} ms = {dense_ms + sparse_ms:.4f} ms of kernels")
    sweeps["dense_phase_int8_r128"]["epoch_dense_ms"] = dense_ms
    sweeps["sgd_sweep_r128"]["epoch_sparse_ms"] = sparse_ms
    del Pt, Qt, P, Q, meta, groups, grp, g0, skel, tl, tls, u, i, r, sws
    torch.cuda.empty_cache()
    log(f"[time] phase 11 {time.perf_counter() - t_phase:.1f} s")

    # 12. the path, through the trainer
    t_phase = time.perf_counter()
    base_rmse, _ = rmse_mae(fresh_model(), test)
    log(f"[netflix] untrained held-out rmse {base_rmse:.5f} (unclipped)")
    run_sgd = dataclasses.replace(sgd, epochs=NETFLIX_EPOCHS)
    sgd_sweep.launches = 0
    dense_phase.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    trains, tests, epoch_ss, after1, plan_seen = [], [], [], None, 0.0
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    for epoch, m, tr in blocked.train_epochs_blocked(
            fresh_model(), train, run_sgd, cfg.model.use_bias, seed=seed,
            device=dev, timings=timings):
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_prev
        plan_s = timings["plan_s"] - plan_seen
        plan_seen = timings["plan_s"]
        epoch_s = wall - plan_s - (timings["prep_s"] if epoch == 0 else 0.0)
        if epoch == 0:
            info = timings["dense_info"]
            log(f"[netflix] prep {timings['prep_s']:.3f} s: dense_frac "
                f"{info['dense_frac']:.4f}, {info['num_strata']} strata in "
                f"{info['num_groups']} groups, R image "
                f"{info['r_stream_bytes']} bytes; (tiles, critical path) "
                f"of each sparse sweep {timings['sweep_tiles']}")
            after1 = {k: getattr(m, k).clone() for k in ("P", "Q", "bu", "bi")}
            after1["train"] = float(tr)
        test_rmse, test_mae = rmse_mae(m, test)
        trains.append(float(tr))
        tests.append(test_rmse)
        epoch_ss.append(epoch_s)
        log(f"[netflix] epoch {epoch}: epoch_s {epoch_s:.4f} plan_s "
            f"{plan_s:.4f} train_rmse {float(tr):.5f} test_rmse "
            f"{test_rmse:.5f} test_mae {test_mae:.5f}")
        finite = all(bool(torch.isfinite(getattr(m, k)).all())
                     for k in ("P", "Q", "bu", "bi"))
        if not finite or m.P.shape != (U, rank) or m.Q.shape != (I, rank):
            raise AssertionError("netflix: tables not finite or mis-shaped")
        t_prev = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {"sgd_sweep_r128": sgd_sweep.launches,
                "dense_phase_int8_r128": dense_phase.launches}
    log(f"[netflix] launches {launches}, peak memory allocated {peak} bytes")
    log(f"[netflix] steady epoch_s {epoch_ss[-1]:.4f} against phase 11's "
        f"kernels {(dense_ms + sparse_ms) / 1e3:.4f} s (dense "
        f"{dense_ms / 1e3:.4f}, sparse {sparse_ms / 1e3:.4f})")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if peak > 80e9:
        raise AssertionError(f"peak memory {peak} above 80 GB")
    # the reference's own held-out RMSE on this synthetic is lowest after
    # the first epoch and rises after it, while the train RMSE falls
    # (tests/test_torch_slice.py::
    # test_netflix_cut_follows_the_reference_trainer, at 1/200 of the
    # shape): so every epoch's held-out RMSE must lie below the untrained
    # model's and the train RMSE must fall every epoch
    if (len(tests) != NETFLIX_EPOCHS or max(tests) >= base_rmse
            or any(b >= a for a, b in zip(trains, trains[1:]))):
        raise AssertionError(
            f"netflix: held-out RMSE {tests} not below the untrained "
            f"{base_rmse} after every epoch, or the train RMSE {trains} "
            "did not fall every epoch")
    log(f"[netflix] held-out RMSE below the untrained {base_rmse:.5f} after "
        f"every epoch ({' '.join(f'{x:.5f}' for x in tests)}; lowest after "
        f"epoch {1 + tests.index(min(tests))}); train RMSE falls every epoch")
    del m
    for _, again, tr in blocked.train_epochs_blocked(
            fresh_model(), train, dataclasses.replace(sgd, epochs=1),
            cfg.model.use_bias, seed=seed, device=dev):
        pass
    if float(tr) != after1["train"] or not all(
            torch.equal(getattr(again, k), after1[k])
            for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("netflix: a second run of 1 epoch differs")
    log("[netflix] a second run of 1 epoch repeats the first run's state "
        "after epoch 1 bit for bit")
    log(f"[time] phase 12 {time.perf_counter() - t_phase:.1f} s")
    return launches


def java_parity_phase(dev):
    """Phase 13: the minibatch trainer with batch_size = 1 on the card
    against the float64 sequential oracle (the Java rule); conflict-free
    rounds chunk-invariant; a second run bitwise equal."""
    import numpy as np
    import torch

    from mfx_torch.config import SGDConfig
    from mfx_torch.convert import model_from_numpy
    from mfx_torch.data.split import epoch_permutation
    from mfx_torch.data.synthetic import make_synthetic
    from mfx_torch.oracle import (init_oracle_from_arrays,
                                  train_epoch_sequential)
    from mfx_torch.solvers.sgd import train_epochs

    t_phase = time.perf_counter()
    coo = make_synthetic(*JAVA_SHAPE, rank=4, seed=105)
    U, I, rank = coo.num_users, coo.num_items, 8
    rng = np.random.default_rng(105)
    arrays = {"P": rng.normal(size=(U, rank)) / np.sqrt(rank),
              "Q": rng.normal(size=(I, rank)) / np.sqrt(rank),
              "bu": np.zeros(U), "bi": np.zeros(I),
              "mu": np.float32(coo.global_mean)}
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    keys = ("P", "Q", "bu", "bi")

    def run(**kw):
        cfg = SGDConfig(epochs=2, **kw)
        model = model_from_numpy(arrays, device=dev)
        for _, model, _ in train_epochs(model, coo, cfg, use_bias=True,
                                        seed=0):
            pass
        return model

    seq = dict(lr=0.02, reg=0.05, batch_size=1, partitioner="fixed")
    t0 = time.perf_counter()
    model = run(**seq)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    oracle = init_oracle_from_arrays(*(arrays[k] for k in keys),
                                     float(arrays["mu"]))
    for epoch in range(2):
        train_epoch_sequential(oracle, coo,
                               epoch_permutation(coo.n_ratings, 0, epoch),
                               lr=seq["lr"], reg=seq["reg"])
    err = max(float(np.abs(getattr(model, k).cpu().numpy()
                           - getattr(oracle, k)).max()) for k in keys)
    log(f"[java] {coo.n_ratings} ratings ({U} x {I}, seed 105), rank "
        f"{rank}, batch_size 1, 2 epochs ({2 * coo.n_ratings} batches) on "
        f"the card in {card_s:.2f} s: max |table - float64 oracle| "
        f"{err:.3e} (tolerance {JAVA_TOL})")
    if not err <= JAVA_TOL:
        raise AssertionError(f"Java parity: {err} > {JAVA_TOL}")
    again = run(**seq)
    if not all(torch.equal(getattr(again, k), getattr(model, k))
               for k in keys):
        raise AssertionError("Java parity: a second run differs")
    chunked = [run(lr=0.03, reg=0.02, batch_size=bs,
                   partitioner="conflict_free") for bs in (32, 128)]
    if not all(torch.equal(getattr(chunked[0], k), getattr(chunked[1], k))
               for k in keys):
        raise AssertionError("conflict-free batches of 32 and 128 differ")
    log("[java] a second run bitwise equal; conflict-free batches of 32 "
        "and 128 give bitwise-equal tables")
    log(f"[time] phase 13 {time.perf_counter() - t_phase:.1f} s")


def ml100k_phase(dev):
    """Phase 14: the ml100k_rank16 preset unchanged through the driver,
    resume, the CLI's update and recommend (tile_topk launched, then held
    against its plain version on the inputs recommend gave it). Returns
    tile_topk's launches in recommend and that check's record."""
    import contextlib
    import io
    import shutil
    import tempfile
    import warnings
    from pathlib import Path

    import numpy as np
    import torch

    from mfx_torch import cli
    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.coo import RatingsCOO
    from mfx_torch.data.loaders import load_dataset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels.serve_topk import tile_topk
    from mfx_torch.models.mf import init_model
    from mfx_torch.serve import fused
    from mfx_torch.solvers import sgd
    from mfx_torch.train.driver import train as drive

    t_phase = time.perf_counter()
    cfg = preset("ml100k_rank16")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded synthetic stand-in
        coo = load_dataset(cfg.data.dataset, cache=False)
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    clip = (0.5, 5.0) if cfg.clip_predictions else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.model.seed)
    m0 = init_model(gen, coo.num_users, coo.num_items, cfg.model.rank,
                    global_mean=train.global_mean)
    base = rmse_mae(m0, test, clip=clip)
    log(f"[ml100k] {coo.num_users} x {coo.num_items}, {coo.n_ratings} "
        f"ratings ({train.n_ratings} train / {test.n_ratings} test); "
        f"untrained held-out RMSE {base[0]:.5f} MAE {base[1]:.5f}")

    # one epoch apart: the plan on the host, then its batches through the
    # step dispatched op by op and replayed as a CUDA graph (the trainer's
    # form on the card), bitwise equal, with the host syncs of each
    t0 = time.perf_counter()
    plan = sgd.plan_epoch(train, cfg.sgd, cfg.data.seed, 0, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    nb = plan.num_batches
    real = int((plan.batches["weights"] > 0).sum())
    log(f"[ml100k] epoch 0 plan: {nb} batches of {plan.batch_size} slots, "
        f"{real} real ratings ({real / (nb * plan.batch_size):.4%} of the "
        f"slots), planned and uploaded in {plan_s:.3f} s on the host")
    fns = {"eager": sgd.make_epoch_fn(cfg.sgd, cfg.model.use_bias,
                                      graph=False),
           "graph": sgd.make_epoch_fn(cfg.sgd, cfg.model.use_bias)}
    out = {}
    for name, fn in fns.items():
        t0 = time.perf_counter()
        fn(m0, plan, cfg.sgd.lr)  # warm-up (the graph: its capture)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        m1, sse = fn(m0, plan, cfg.sgd.lr)
        end.record()
        host_s = time.perf_counter() - t0
        end.synchronize()
        dev_ms = start.elapsed_time(end)
        out[name] = (m1, float(sse))
        log(f"[ml100k] one epoch, {name}: {dev_ms:.1f} ms on the card "
            f"({dev_ms / nb * 1e3:.1f} us a batch), {host_s:.3f} s to dispatch "
            f"on the host (first call {first_s:.3f} s)")
    # the trainer's form makes no host sync inside an epoch: any would
    # raise here
    torch.cuda.set_sync_debug_mode("error")
    try:
        fns["graph"](m0, plan, cfg.sgd.lr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[ml100k] a whole graph-replayed epoch under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")
    (me, se), (mg, sg) = out["eager"], out["graph"]
    if se != sg or not all(torch.equal(getattr(me, k), getattr(mg, k))
                           for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("graph replay and eager loop differ")
    log(f"[ml100k] graph replay == eager loop, tables and sse ({sg:.3f}) "
        "bitwise")
    # the device time of the step by kernel, over the plan's first batches
    from torch.profiler import ProfilerActivity, profile

    head = sgd.EpochPlan({k: v[:PROFILE_BATCHES]
                          for k, v in plan.batches.items()}, real)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fns["graph"](m0, head, cfg.sgd.lr)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0) > 0 and e.device_type.name
           == "CUDA"]
    total = sum(e.device_time_total for e in evs)
    top = sorted(evs, key=lambda e: -e.device_time_total)[:6]
    log(f"[ml100k] profile of {PROFILE_BATCHES} graph-replayed batches: "
        f"{total / PROFILE_BATCHES:.1f} us of kernels a batch; "
        + "; ".join(f"{e.key[:60]} x{e.count // PROFILE_BATCHES} "
                    f"{e.device_time_total / PROFILE_BATCHES:.1f} us"
                    for e in top))

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        run_cfg = apply_overrides(cfg, [
            f"log_path={tmp / 'log.jsonl'}", f"checkpoint_dir={tmp / 'ck'}",
            "checkpoint_every=15"])
        t0 = time.perf_counter()
        res = drive(run_cfg, device=dev)
        wall = time.perf_counter() - t0
        hist = res.history
        trains = [h["train_metric"] for h in hist]
        epoch_s = sorted(h["epoch_s"] for h in hist)
        log(f"[ml100k] driver: {res.epochs_run} epochs in {wall:.1f} s, "
            f"epoch_s median {epoch_s[len(epoch_s) // 2]:.3f} (min "
            f"{epoch_s[0]:.3f}, max {epoch_s[-1]:.3f}), "
            f"{res.updates_per_sec:.0f} updates/s in the last; train RMSE "
            f"{trains[0]:.5f} -> {trains[-1]:.5f}; held-out RMSE "
            f"{res.test_rmse:.5f} MAE {res.test_mae:.5f}")
        if res.epochs_run != cfg.sgd.epochs:
            raise AssertionError(f"{res.epochs_run} epochs run")
        if any(b >= a for a, b in zip(trains, trains[1:])):
            raise AssertionError(f"train RMSE did not fall: {trains}")
        if not res.test_rmse < base[0] or not res.test_rmse <= ML100K_GATE:
            raise AssertionError(
                f"held-out RMSE {res.test_rmse} (untrained {base[0]}, gate "
                f"{ML100K_GATE})")
        recs = (tmp / "log.jsonl").read_text().splitlines()
        if [json.loads(x)["epoch"] for x in recs] != list(range(30)):
            raise AssertionError("the JSONL log is not one record an epoch")
        fin = [getattr(res.model, k) for k in ("P", "Q", "bu", "bi")]
        if not all(bool(torch.isfinite(t).all()) for t in fin):
            raise AssertionError("model tables not finite")

        # resume from the epoch-14 checkpoint
        (tmp / "ck2").mkdir()
        shutil.copy(tmp / "ck" / "14.npz", tmp / "ck2" / "14.npz")
        t0 = time.perf_counter()
        res2 = drive(apply_overrides(run_cfg, [
            f"checkpoint_dir={tmp / 'ck2'}", f"log_path={tmp / 'log2.jsonl'}"
        ]), device=dev)
        if [h["epoch"] for h in res2.history] != list(range(15, 30)):
            raise AssertionError("the resumed run did not start at epoch 15")
        if not all(torch.equal(getattr(res2.model, k), t)
                   for k, t in zip(("P", "Q", "bu", "bi"), fin)):
            raise AssertionError("the resumed run differs from the unbroken")
        log(f"[ml100k] resumed from the epoch-14 checkpoint: epochs 15-29 in "
            f"{time.perf_counter() - t0:.1f} s, tables bitwise those of the "
            "unbroken run")

        # the CLI's update with a seeded delta, then recommend
        rng = np.random.default_rng(106)
        U, I = coo.num_users, coo.num_items
        n = 2000
        du = rng.integers(0, U + 10, n).astype(np.int32)
        di = rng.integers(0, I + 10, n).astype(np.int32)
        du[:10] = np.arange(U, U + 10)
        di[10:20] = np.arange(I, I + 10)
        dr = rng.integers(1, 6, n).astype(np.float32)
        RatingsCOO(user=du, item=di, rating=dr, num_users=U + 10,
                   num_items=I + 10).save_npz(tmp / "delta.npz")

        def cli_run(args):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if cli.main(args) != 0:
                    raise AssertionError(f"cli {args[0]} failed")
            return buf.getvalue().strip().splitlines()

        t0 = time.perf_counter()
        out = json.loads(cli_run([
            "update", "--checkpoint", str(tmp / "ck"), "--delta",
            str(tmp / "delta.npz"), "--device", dev.type])[-1])
        if (out["grew_users"], out["grew_items"], out["step"]) != (10, 10, 30):
            raise AssertionError(f"update: {out}")
        log(f"[ml100k] CLI update in {time.perf_counter() - t0:.2f} s: {out}")
        # the kernel's inputs as the recommender hands them over, kept
        # for the check against its plain version below
        calls = []

        def keep(P_aug, Q_aug, **kw):
            calls.append((P_aug.clone(), Q_aug.clone(), kw))
            return tile_topk(P_aug, Q_aug, **kw)

        tile_topk.launches = 0
        fused.tile_topk = keep
        t0 = time.perf_counter()
        try:
            lines = cli_run(["recommend", "--checkpoint", str(tmp / "ck"),
                             "--users", f"0,1,{U + 9}", "--fused", "--tile",
                             "128", "--device", dev.type])
        finally:
            fused.tile_topk = tile_topk
        rec_s = time.perf_counter() - t0
        launches = tile_topk.launches
        recs = [json.loads(x) for x in lines]
        if len(recs) != 3 or any(len(r["items"]) != K for r in recs) or any(
                max(r["items"]) >= I + 10 for r in recs):
            raise AssertionError(f"CLI recommend: {lines}")
        if launches < 1:
            raise AssertionError("recommend never launched tile_topk")
        log(f"[ml100k] CLI recommend --fused --tile 128 on the updated "
            f"checkpoint ({U + 10} x {I + 10}): 3 users in {rec_s:.2f} s, "
            f"launches {{'tile_topk': {launches}}}")
        # each of those launches again on the same inputs, held against
        # the plain version (these launches are not counted above)
        err = 0.0
        for P_aug, Q_aug, kw in calls:
            got = tile_topk(P_aug, Q_aug, **kw)
            e, swaps, gap = hold_topk("tile_topk (recommend)", got, P_aug,
                                      Q_aug, kw.get("sb"), kw["tile"],
                                      kw["depth"])
            err = max(err, e)
            log(f"[kernel] tile_topk at recommend's shapes: P_aug "
                f"{tuple(P_aug.shape)} {P_aug.dtype}, Q_aug "
                f"{tuple(Q_aug.shape)}, tile {kw['tile']}, depth "
                f"{kw['depth']}: max_abs_err={e:.3e} (tol {TOL}), lane swaps "
                f"{swaps} (gap <= {gap:.3e}); launches on the path "
                f"{launches}")
    log(f"[time] phase 14 {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": err,
            "P_aug": list(calls[0][0].shape), "Q_aug": list(calls[0][1].shape),
            "tile": calls[0][2]["tile"], "depth": calls[0][2]["depth"]}


def temporal(coo, seed, n_bins=TIME_BINS):
    """``coo`` with seeded timestamps in [0, 1e6), each rating shifted by a
    N(0, TIME_SHIFT) draw of its (item, calendar bin) on ``n_bins`` bins,
    and clipped to [0.5, 5]. The JAX package's dataset classes take it
    too: ``tools/timesvd_recipe_check.py`` and the card tests use it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 1_000_000, coo.n_ratings)
    shift = rng.normal(0, TIME_SHIFT, (coo.num_items, n_bins)).astype(
        np.float32)
    r = coo.rating + shift[coo.item, ts * n_bins // 1_000_000]
    return dataclasses.replace(
        coo, rating=np.clip(r, 0.5, 5.0).astype(np.float32),
        timestamp=ts.astype(np.int64))


def timesvd_config(root, *extra):
    """The phase-16 configuration: ml25m_rank64's model and data with
    solver='timesvd', timesvd.kernel='pallas', TimeSVDConfig's defaults but
    reg_alpha = reg, the dataset read from ``root``, no early stop."""
    from mfx_torch.config import TimeSVDConfig, apply_overrides, preset

    reg = TimeSVDConfig().reg
    cfg = apply_overrides(preset("ml25m_rank64"), [
        "solver=timesvd", "timesvd.kernel=pallas", f"timesvd.reg_alpha={reg}",
        f"data.root={root}", *extra])
    return dataclasses.replace(cfg, target_rmse=None)


def time_kernel_phase(dev, tcoo, results, bounds, sweeps):
    """Phase 15: sgd_sweep_time (ranks 64 and 128) against its plain
    version on the first sweep of epoch 0 of the temporal ML-25M-shaped
    synthetic ``tcoo``, at the blocked timeSVD trainer's shapes. Fills
    ``results``, ``bounds`` and ``sweeps`` under sgd_sweep_time."""
    import torch

    from mfx_torch.data.split import train_test_split
    from mfx_torch.kernels import _build
    from mfx_torch.kernels.packing import pad_rows, to_tlane_model
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep, sgd_sweep_plain,
                                             sgd_sweep_time)
    from mfx_torch.models.mf import init_model
    from mfx_torch.models.timesvd import fit_time_features, init_timesvd
    from mfx_torch.solvers import timesvd_blocked as tsb
    from mfx_torch.solvers.blocked import TPG, sweep_geometry

    t_phase = time.perf_counter()
    cfg = timesvd_config(None)
    tc, seed = cfg.timesvd, cfg.data.seed
    train, _ = train_test_split(tcoo, cfg.data.test_frac, seed=seed)
    U, I, nb = tcoo.num_users, tcoo.num_items, tc.n_bins
    su = si = tsb.BLOCK
    T, tpg, lr, reg = tsb.TILE, TPG, tc.lr, tc.reg
    mu = float(train.global_mean)
    feats = fit_time_features(train, n_bins=nb, beta=tc.beta)
    tb, dv = feats.features(train.user, train.timestamp)
    plan = tsb.build_temporal_plan_skeleton(
        train, tb, dv, su=su, si=si, tile=T, tpg=tpg,
        nwin=sweep_geometry(I, cfg.model.rank, si), device=dev)
    tl, sws = tsb.plan_temporal_epoch_device(*plan, seed, 0)
    log(f"[time] cell: blocked timeSVD (rank {cfg.model.rank}, {nb} bins, "
        f"su = si = {su}, T = {T}, tpg {tpg}, lr {lr}, reg {reg}) on the "
        f"ML-25M-shaped synthetic made temporal ({train.n_ratings} train "
        f"ratings); {len(sws)} sweep(s) of {[s.t1 - s.t0 for s in sws]} "
        f"tiles, critical paths {[s.deps.critical for s in sws]}; data, "
        f"features and plan in {time.perf_counter() - t_phase:.1f} s")
    lib = _build.load_library()

    def tables(rank):
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        base = init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale, device=dev)
        lane = to_tlane_model(init_timesvd(None, U, I, rank, nb, base=base),
                              nb)
        return pad_rows(lane.P, su), pad_rows(lane.Q, si)

    sw = sws[0]
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tcs = sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous()
    tls = tl[sw.t0:sw.t0 + nt]
    deps = sw.deps.prefix(nt)
    seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    kw = dict(su=su, si=si, tpg=tpg, n_bins=nb)
    whole = {}
    for rank, name in ((64, "sgd_sweep_time"), (128, "sgd_sweep_time_r128")):
        P, Q = tables(rank)
        log(f"[kernel] {name}: {nt} tiles of the first sweep (T={T}, rank "
            f"{rank}, {nb} bins); they hold {deps.runs.shape[0]} runs, "
            f"critical path {deps.critical} tiles")
        res = compare(
            name,
            lambda Pt, Qt: sgd_sweep_time(Pt, Qt[seg], sa, tcs, tls, lr, reg,
                                          mu, **kw, deps=deps),
            lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg], sa, tcs, tls, lr,
                                           reg, mu, **kw),
            (P, Q))
        # the stream's 5 rows are read once
        bnd = sweep_bound(tls, sa, tcs, su, si, tpg, rank,
                          [("P", 0), ("Q", 1)], None,
                          slot_ops=time_slot_ops(rank, nb))
        card = lib.mfx_sgd_sweep_time_max_blocks(T, rank)
        # the lane form on the same tiles (rows 0-2) and tables: what the
        # two stream rows, the injections and the kept lanes cost
        tl3 = tls[:, :3].contiguous()
        Pt, Qt = P.clone(), Q.clone()
        lane_ms = cuda_ms(lambda: sgd_sweep(Pt, Qt[seg], sa, tcs, tl3, lr,
                                            reg, mu, su=su, si=si, tpg=tpg,
                                            deps=deps), reps=3)
        del Pt, Qt
        log(f"[kernel] {name}: the lane form (sgd_sweep) on the same "
            f"{nt} tiles {lane_ms:.4f} ms")
        if rank == 64:
            results[name], bounds[name] = res, bnd
            whole = whole_sweep(
                name,
                lambda Pt, Qt, blocks: sgd_sweep_time(
                    Pt, Qt[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu,
                    **kw, deps=sw.deps, blocks=blocks),
                (P, Q), sw.deps, card)
            whole["sweep_bound_ms"], whole["sweep_bound_by"] = sweep_bound(
                tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
                [("P", 0), ("Q", 1)], None,
                slot_ops=time_slot_ops(rank, nb))
            whole["lane_form_ms"] = lane_ms
        else:
            # no path runs the rank-128 form: its numbers go in the rank-64
            # entry, with the whole sweep on 1 block and the card's count
            again = whole_sweep(
                name,
                lambda Pt, Qt, blocks: sgd_sweep_time(
                    Pt, Qt[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu,
                    **kw, deps=sw.deps, blocks=blocks),
                (P, Q), sw.deps, card)
            whole["r128"] = {"tiles": nt, "max_abs_err": res[0],
                             "ms": res[1], "plain_ms": res[2],
                             "lane_form_ms": lane_ms,
                             "bound_ms": bnd[0], "bound_by": bnd[1],
                             **again}
        log(f"[kernel] {name} bound {bnd[0]:.4f} ms ({bnd[1]}; "
            f"{time_slot_ops(rank, nb)} operations a real slot)")
        del P, Q
    log(f"[kernel] sgd_sweep_time whole sweep bound "
        f"{whole['sweep_bound_ms']:.4f} ms ({whole['sweep_bound_by']})")
    sweeps["sgd_sweep_time"] = whole
    del plan, tl, sws
    torch.cuda.empty_cache()
    log(f"[time] phase 15 {time.perf_counter() - t_phase:.1f} s")


def time_path_phase(dev, tcoo):
    """Phase 16: blocked timeSVD through the driver on ``tcoo`` (the
    loader's synthetic cache under a data root in build/), its gates
    against the untrained model and lane MF, a 2-epoch repeat; then the
    minibatch timeSVD trainer through the driver on the temporal ML-1M
    synthetic. Returns the time form's launches in the first run."""
    import shutil

    import torch

    from mfx_torch.config import SGDConfig, apply_overrides, preset
    from mfx_torch.data.loaders import GENERATOR_VERSION
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML1M_SHAPE, make_synthetic
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.kernels.sgd_sweep import sgd_sweep, sgd_sweep_time
    from mfx_torch.models.mf import init_model
    from mfx_torch.models.timesvd import fit_time_features, init_timesvd
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers import timesvd_blocked as tsb
    from mfx_torch.solvers.timesvd import rmse_mae_time, train_epochs_timesvd
    from mfx_torch.train.checkpoint import load_checkpoint
    from mfx_torch.train.driver import train as drive

    t_phase = time.perf_counter()
    root = _build.BUILD_DIR.parent / "chip_smoke_timesvd"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tcoo.save_npz(root / f"ml-25m.v{GENERATOR_VERSION}.synthetic.npz")
    ck = root / "ckpt"
    cfg = timesvd_config(root, f"checkpoint_dir={ck}", "checkpoint_every=2")
    tc, seed, clip = cfg.timesvd, cfg.data.seed, (0.5, 5.0)
    train, test = train_test_split(tcoo, cfg.data.test_frac, seed=seed)
    U, I, rank = tcoo.num_users, tcoo.num_items, cfg.model.rank
    feats = fit_time_features(train, n_bins=tc.n_bins, beta=tc.beta)

    def fresh_model():  # the driver's initial model
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale)

    base_rmse, _ = rmse_mae_time(
        init_timesvd(None, U, I, rank, tc.n_bins, base=fresh_model()), feats,
        test, clip=clip)
    log(f"[time] path: solver='timesvd' kernel='pallas', rank {rank}, "
        f"{tc.n_bins} bins, lr {tc.lr} decay {tc.lr_decay} reg {tc.reg} = "
        f"reg_alpha, {tc.epochs} epochs (TimeSVDConfig's), su = si = "
        f"{tsb.BLOCK}, T = {tsb.TILE}; untrained held-out time-aware RMSE "
        f"{base_rmse:.5f} (clipped, as the driver's)")
    sgd_sweep_time.launches = sgd_sweep.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = drive(cfg, device=dev, resume=False)
    wall = time.perf_counter() - t0
    launches = sgd_sweep_time.launches
    trains = [r["train_metric"] for r in res.history]
    epoch_s = [r["epoch_s"] for r in res.history]
    log(f"[time] driver: {res.epochs_run} epochs in {wall:.1f} s (load, "
        f"split, features, plan and evals included); epoch_s first "
        f"{epoch_s[0]} median of the others "
        f"{sorted(epoch_s[1:])[len(epoch_s[1:]) // 2]} (the driver's, "
        f"without the eval); launches sgd_sweep_time {launches} sgd_sweep "
        f"{sgd_sweep.launches}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated(dev)} bytes")
    log("[time] train_rmse " + " ".join(f"{x:.5f}" for x in trains))
    log("[time] held-out time-aware rmse " + " ".join(
        f"{r['test_rmse']:.5f}" for r in res.history))
    if launches < 1 or sgd_sweep.launches:
        raise AssertionError(f"timesvd: launches {launches} of the time form, "
                             f"{sgd_sweep.launches} of the lane form")
    if len(trains) != tc.epochs or any(b >= a for a, b in
                                       zip(trains, trains[1:])):
        raise AssertionError(f"timesvd: the train RMSE did not fall every "
                             f"epoch: {trains}")

    # lane-biased MF: the same storage rank, blocks, epochs, lr and reg on
    # the same split, through sgd_sweep with no dense phase
    mf_cfg = SGDConfig(
        lr=tc.lr, reg=tc.reg, lr_decay=tc.lr_decay, epochs=tc.epochs,
        partitioner="blocked", kernel="pallas", ublock=tsb.BLOCK,
        iblock=tsb.BLOCK, tile=tsb.TILE, bias_mode="lane", dense_chi=0,
        plan_device="device")
    for _, mf, _ in blocked.train_epochs_blocked(fresh_model(), train, mf_cfg,
                                                 True, seed=seed, device=dev):
        pass
    mf_rmse, _ = rmse_mae(mf, test, clip=clip)
    log(f"[time] held-out RMSE: timeSVD (time-aware) {res.test_rmse:.5f}, "
        f"lane MF {mf_rmse:.5f}, untrained {base_rmse:.5f}")
    if not res.test_rmse < min(mf_rmse, base_rmse):
        raise AssertionError(
            f"timesvd: held-out {res.test_rmse} not below lane MF's "
            f"{mf_rmse} and the untrained {base_rmse}")
    del mf
    after2, step, _ = load_checkpoint(ck, step=1, device=dev)
    again = drive(timesvd_config(root, "timesvd.epochs=2"), device=dev,
                  resume=False)
    if step != 1 or not all(torch.equal(getattr(again.model, k),
                                        getattr(after2, k))
                            for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("timesvd: a second run of 2 epochs differs from "
                             "the first run's state after 2 epochs")
    log("[time] a second run of 2 epochs repeats the first run's state "
        "after 2 epochs (its checkpoint) bit for bit")
    t1 = time.perf_counter()

    # the minibatch trainer (timesvd.kernel='jnp') on the temporal ML-1M
    coo1 = temporal(make_synthetic(*ML1M_SHAPE, rank=32, seed=101,
                                   star_step=1.0, user_zipf_s=0.6), 101)
    coo1.save_npz(root / f"ml-1m.v{GENERATOR_VERSION}.synthetic.npz")
    cfg1 = apply_overrides(preset("ml1m_rank32_biased"), [
        "solver=timesvd", "timesvd.dup_trust=16", f"data.root={root}"])
    res1 = drive(cfg1, device=dev, resume=False)
    trains1 = [r["train_metric"] for r in res1.history]
    tr1, te1 = train_test_split(coo1, cfg1.data.test_frac,
                                seed=cfg1.data.seed)
    g = torch.Generator(device=dev)
    g.manual_seed(cfg1.model.seed)
    m1 = init_model(g, coo1.num_users, coo1.num_items, cfg1.model.rank,
                    global_mean=tr1.global_mean,
                    init_scale=cfg1.model.init_scale)
    feats1 = fit_time_features(tr1, n_bins=cfg1.timesvd.n_bins,
                               beta=cfg1.timesvd.beta)
    *_, (_, ts1, _) = train_epochs_timesvd(m1, tr1, cfg1.timesvd,
                                           seed=cfg1.data.seed, feats=feats1)
    want = rmse_mae_time(ts1, feats1, te1, clip=clip)
    static, _ = rmse_mae(res1.model, te1, clip=clip)
    log(f"[time] jnp (ML-1M-shaped, dup_trust 16): {res1.epochs_run} epochs; "
        f"train_rmse " + " ".join(f"{x:.5f}" for x in trains1))
    log(f"[time] jnp: held-out time-aware RMSE {res1.test_rmse:.5f} (the "
        f"trainer's model through rmse_mae_time: {want[0]:.5f}; the MF view "
        f"at the end of the train window: {static:.5f}); "
        f"{time.perf_counter() - t1:.1f} s")
    if any(b >= a for a, b in zip(trains1, trains1[1:])):
        raise AssertionError(f"timesvd jnp: the train RMSE did not fall "
                             f"every epoch: {trains1}")
    if (res1.test_rmse, res1.test_mae) != want:
        raise AssertionError(f"timesvd jnp: the driver's eval "
                             f"{res1.test_rmse} is not the time-aware one "
                             f"{want}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[time] phase 16 {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on a GPU")
    from mfx_torch.config import preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML25M_SHAPE, make_synthetic
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.dense_phase import (dense_phase, dense_phase_plain,
                                               group_prefix, plan_launch)
    from mfx_torch.kernels.packing import lane_tables, plain_tables
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
    meta, groups, (u, i, r), info3 = prepare_dense_full(
        u, i, r, U, I, su, si, chi_min=sgd.dense_chi,
        nwd=blocked.dense_group_windows(rank, si), rfmt=rfmt)
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg,
                                   blocked.sweep_geometry(I, rank, si))
    tl = pdv.epoch_tiles_device(skel, u, i, r, cfg.data.seed, 0)
    P, Q = lane_tables(fresh_model(), su, si, dev)
    mu, lr, reg = float(train.global_mean), sgd.lr, sgd.reg
    results, bounds = {}, {}
    t_phase = time.perf_counter()

    win0, nw = meta[0]
    grp = group_prefix(groups[0], DENSE_STRATA)
    seg = slice(win0 * si, (win0 + nw) * si)
    log(f"[kernel] dense_phase: {grp['sa'].shape[0]} strata of group 0 "
        f"({rfmt}, {su}x{si}, rank {rank}); critical path "
        f"{grp['deps'].critical} strata")
    results["dense_phase"] = compare(
        "dense_phase",
        lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp, lr, reg, mu, su=su,
                                   si=si, deps=grp["deps"]),
        lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp, lr, reg, mu,
                                         su=su, si=si),
        (P, Q),
    )
    bounds["dense_phase"] = dense_bound([grp], su, si, rank)
    # the first DENSE_WHOLE strata of group 0 on one block and on the
    # card's count; then group 0 and the dense phase of an epoch
    head = group_prefix(groups[0], DENSE_WHOLE)
    plan_launch(head, su, si, rank)  # the launch order, on the host, untimed
    dense_card = _build.load_library().mfx_dense_phase_max_blocks(
        rank, int(rfmt == "int8"))
    sweeps = {"dense_phase": whole_sweep(
        "dense_phase",
        lambda Pt, Qt, blocks: dense_phase(Pt, Qt[seg], head, lr, reg, mu,
                                           su=su, si=si, deps=head["deps"],
                                           blocks=blocks),
        (P, Q), head["deps"], dense_card, grid=dense_card, unit="strata")}

    def dense_groups(grps):
        Pt, Qt = P.clone(), Q.clone()
        for (w0, n), g in grps:
            dense_phase(Pt, Qt[w0 * si:(w0 + n) * si], g, lr, reg, mu, su=su,
                        si=si, deps=g["deps"])

    for key, grps in (("group0", list(zip(meta, groups))[:1]),
                      ("epoch_dense", list(zip(meta, groups)))):
        dense_groups(grps)  # warm-up
        ms = cuda_ms(lambda: dense_groups(grps), reps=3)
        b = dense_bound([g for _, g in grps], su, si, rank)
        strata = sum(g["deps"].n_tiles for _, g in grps)
        crit = sum(g["deps"].critical for _, g in grps)
        sweeps["dense_phase"].update({
            f"{key}_strata": strata, f"{key}_critical_strata": crit,
            f"{key}_ms": ms, f"{key}_bound_ms": b[0]})
        log(f"[kernel] dense_phase, {key}: {len(grps)} group(s), {strata} "
            f"strata, critical path {crit} strata, {dense_card} blocks: "
            f"{ms:.4f} ms (mean of 3, tables copied in); bound {b[0]:.4f} "
            f"ms ({b[1]})")

    # the int8 codes' rank-64 instance on the same strata (the int4 run's
    # threshold): no preset's path runs it (ml25m_rank64's half-star
    # ratings take int4), so it is timed here beside int4 and holds no
    # launch count
    _, groups8, _, _ = prepare_dense_full(
        *(torch.as_tensor(x).to(dev) for x in (train.user, train.item,
                                                train.rating)),
        U, I, su, si, chi_min=info3["chi_effective"],
        nwd=blocked.dense_group_windows(rank, si), rfmt="int8")
    grp8 = group_prefix(groups8[0], DENSE_STRATA)
    if not torch.equal(grp8["sa"], grp["sa"]):
        raise AssertionError("the int8 carving took other strata")
    err8, ms8, plain8 = compare(
        "dense_phase int8 rank 64",
        lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp8, lr, reg, mu, su=su,
                                   si=si, deps=grp8["deps"]),
        lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp8, lr, reg, mu,
                                         su=su, si=si),
        (P, Q))
    sweeps["dense_phase"]["int8_rank64"] = {
        "strata": DENSE_STRATA, "max_abs_err": err8, "ms": ms8,
        "plain_ms": plain8, "bound_ms": dense_bound([grp8], su, si, rank)[0]}
    del groups8, grp8

    sw = next(s for s in skel.sweeps if s.t1 > s.t0)
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tc = sw.sa[: nt // tpg].contiguous(), sw.tc[:nt].contiguous()
    tls = tl[sw.t0:sw.t0 + nt]
    deps = sw.deps.prefix(nt)
    seg_s = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    log(f"[kernel] sgd_sweep: {nt} tiles of the first sweep (T={T}, "
        f"rank {rank}); they hold {deps.runs.shape[0]} runs, critical path "
        f"{deps.critical} tiles")
    results["sgd_sweep"] = compare(
        "sgd_sweep",
        lambda Pt, Qt: sgd_sweep(Pt, Qt[seg_s], sa, tc, tls, lr, reg, mu,
                                 su=su, si=si, tpg=tpg, deps=deps),
        lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg_s], sa, tc, tls, lr, reg,
                                       mu, su=su, si=si, tpg=tpg),
        (P, Q),
    )
    # per real slot: the residual's dot (2 rank), two deltas (3 rank each)
    # and two row adds (rank each)
    bounds["sgd_sweep"] = sweep_bound(tls, sa, tc, su, si, tpg, rank,
                                      [("P", 0), ("Q", 1)], 10)
    Pt, Qt = P.clone(), Q.clone()
    ms_one = cuda_ms(lambda: sgd_sweep(Pt, Qt[seg_s], sa, tc, tls, lr, reg,
                                       mu, su=su, si=si, tpg=tpg), reps=3)
    log(f"[kernel] sgd_sweep: the same {nt} tiles on one block in plan "
        f"order (no dependency table) {ms_one:.4f} ms")
    del Pt, Qt
    # the whole first sweep, on one block and on the card's count
    sweeps["sgd_sweep"] = whole_sweep(
        "sgd_sweep",
        lambda Pt, Qt, blocks: sgd_sweep(
            Pt, Qt[seg_s], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu, su=su,
            si=si, tpg=tpg, deps=sw.deps, blocks=blocks),
        (P, Q), sw.deps,
        _build.load_library().mfx_sgd_sweep_max_blocks(T, rank))
    # the same tiles through the tile-bias and step-batched bodies, on
    # the plain tables of the same model
    tile_bias_compare(results, bounds, plain_tables(fresh_model(), su, si, dev),
                      seg_s, sa, tc, tls, lr, reg, mu, su, si, tpg, "", deps)
    for name in ("dense_phase", "sgd_sweep"):
        log(f"[kernel] {name} bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})")
    log(f"[time] phase 3 {time.perf_counter() - t_phase:.1f} s")
    del meta, groups, grp, skel, tl, tls, P, Q, u, i, r
    torch.cuda.empty_cache()

    # 4. the main path, through the kernels
    t_phase = time.perf_counter()
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
                f"{info['r_stream_bytes']} bytes; (tiles, critical path) of "
                f"each sparse sweep {timings['sweep_tiles']}")
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
    log(f"[time] phase 4 {time.perf_counter() - t_phase:.1f} s")

    # 5. tile_topk against its plain version at the serving shape
    t_phase = time.perf_counter()
    results["tile_topk"], bounds["tile_topk"], topk_variants = topk_phase(dev)
    log(f"[time] phase 5 {time.perf_counter() - t_phase:.1f} s")

    # 6. the serving path, on the model phase 4 trained
    t0 = time.perf_counter()
    launches["tile_topk"] = serve_phase(m, train, dev, cfg.data.seed)
    log(f"[time] phase 6 {time.perf_counter() - t0:.1f} s")
    del m, model, train, test  # coo: phases 15-16 make it temporal
    torch.cuda.empty_cache()

    # 7-8. the BPR path
    launches["bpr_sweep"] = bpr_phases(dev, results, bounds, sweeps)

    # 9-10. the tile-bias path
    launches.update(tile_bias_phases(dev, sweeps))

    # 11-12. the netflix path (rank 128, int8 codes)
    launches.update(netflix_phases(dev, results, bounds, sweeps))

    # 13-14. the minibatch path: Java parity, then ml100k_rank16
    java_parity_phase(dev)
    topk_ml100k = ml100k_phase(dev)

    # 15-16. blocked timeSVD, on phase 4's synthetic made temporal
    t0 = time.perf_counter()
    tcoo = temporal(coo, 102)
    del coo
    log(f"[time] the temporal ML-25M-shaped synthetic in "
        f"{time.perf_counter() - t0:.1f} s")
    time_kernel_phase(dev, tcoo, results, bounds, sweeps)
    launches["sgd_sweep_time"] = time_path_phase(dev, tcoo)
    del tcoo

    replaces = {"sgd_sweep": "mfx/kernels/sgd_pallas.py:63",
                "dense_phase": "mfx/kernels/dense_pallas.py:86",
                "tile_topk": "mfx/kernels/serve_pallas.py:42",
                "bpr_sweep": "mfx/kernels/bpr_pallas.py:47",
                "sgd_sweep_tile": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_step_u": "mfx/kernels/sgd_pallas.py:363",
                "sgd_sweep_r128": "mfx/kernels/sgd_pallas.py:63",
                "dense_phase_int8_r128": "mfx/kernels/dense_pallas.py:86",
                "sgd_sweep_time": "mfx/kernels/sgd_pallas.py:63"}
    sources = {"sgd_sweep_r128": "sgd_sweep", "dense_phase_int8_r128":
               "dense_phase", "sgd_sweep_time": "sgd_sweep"}
    variants = {"sgd_sweep": "bias_mode='lane', rank 64",
                "sgd_sweep_tile": "bias_mode='tile'",
                "dense_phase": "lane, int4 codes, rank 64",
                "sgd_sweep_r128": "bias_mode='lane', rank 128",
                "dense_phase_int8_r128": "lane, int8 codes, rank 128",
                "sgd_sweep_time": "time_mode=True (bias_mode='lane'), rank "
                                  f"64, {TIME_BINS} bins"}
    log(f"[card] {card}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"mfx_torch/csrc/{sources.get(name, name)}.cu",
         "replaces": replaces[name],
         **({"variant": variants[name]} if name in variants else {}),
         "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no single PyTorch call computes any of these functions; for
         # tile_topk the stock path's two calls stand in
         "library_ms": (topk_variants[0]["stock_ms"] if name == "tile_topk"
                        else None),
         **({"library": "torch.matmul (TF32 off) then torch.topk over "
                        "each tile", "variants": topk_variants,
             "ml100k_recommend": topk_ml100k}
            if name == "tile_topk" else {}),
         # the sweeps (the tile-bias ones on ML-1M): a whole sweep on 1
         # block and on the card's count; dense_phase: DENSE_WHOLE strata
         # so, then group 0 and the epoch's dense phase on the card's count
         **sweeps.get(name, {})}
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
