"""The sweeps' dependency table (``plan_device.sweep_deps``, built into
both planners' skeletons): it orders every pair of tiles that share a user
block or an item window, replaying the plain versions in any order it
allows gives the plan-order result bit for bit, dropping one wait breaks
that, and the critical path it reports is the longest chain."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mfx_torch.data import synthetic
from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels import plan_ring_device as prd
from mfx_torch.kernels.bpr_sweep import bpr_sweep_plain
from mfx_torch.kernels.sgd_sweep import sgd_sweep_plain, sgd_sweep_tile_plain

# The plain versions are loops of many small tensor ops. When several test
# processes share a machine, each one's intra-op thread pool fights the
# others for the cores and such loops slow down more than tenfold (these
# files: 11 minutes on six processes, 40 s with one thread each). Nothing
# at these sizes gains from a second thread, so one thread a process, and
# through the environment in the child processes the CLI tests start.
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

U, I, RANK = 300, 330, 64
SU = SI = 64
T, TPG = 32, 4
NWIN = 4  # windows per sweep / segment: 6 windows -> sweeps of 4 and 2
LR, REG, MU = 0.05, 0.02, 3.5


def _ids(n=900, seed=3):
    """Skewed ratings: Zipf users and items, so some strata are empty and
    some hold several tiles."""
    coo = synthetic.make_synthetic(U, I, n, rank=4, noise=0.3, seed=seed,
                                   star_step=0.5, user_zipf_s=1.1)
    return (torch.as_tensor(coo.user).int(), torch.as_tensor(coo.item).int(),
            torch.as_tensor(coo.rating).float())


def _sgd_sweeps():
    u, i, r = _ids()
    skel = pdv.build_plan_skeleton(u, i, U, I, SU, SI, T, TPG, NWIN)
    tl = pdv.epoch_tiles_device(skel, u, i, r, 0, 0)
    return [(sw.sa, sw.tc, tl[sw.t0:sw.t1], sw.deps, sw.nwin)
            for sw in skel.sweeps if sw.t1 > sw.t0]


def _bpr_segments(S=1):
    u, i, _ = _ids()
    ub, ib = -(-(-(-U // S)) // SU) * SU, -(-(-(-I // S)) // SI) * SI
    skel = prd.build_ring_skeleton(u, i, S, ub, ib, SU, SI, T, TPG, NWIN)
    j = (torch.arange(u.shape[0]) * 7 % SI).int()  # window-local negatives
    slabs = prd.epoch_tiles_ring(skel, u, i, None, 0, 0, payload2=j,
                                 sent2=SI)
    return [(seg.sa[t, s].contiguous(), seg.tc[t, s].contiguous(),
             slab[t, s], seg.deps[t][s], seg.nwin)
            for seg, slab in zip(skel.segments, slabs)
            for t in range(S) for s in range(S)]


def _cells(kind):
    return {"sgd": _sgd_sweeps, "sgd_r128": _sgd_sweeps, "tile": _sgd_sweeps,
            "bpr": _bpr_segments,
            "bpr_two_shards": lambda: _bpr_segments(2)}[kind]()


def _reaches(deps):
    """before[x, y]: the table (waits, and front to back inside a run)
    puts tile x before tile y, transitively."""
    runs, wait = deps.runs.numpy(), deps.wait.numpy()
    nt = deps.n_tiles
    before = np.zeros((nt, nt), bool)
    for base, n in runs:
        for t in range(base, base + n):  # tiles in plan order
            preds = [t - 1] if t > base else []
            if wait[t, 0] >= 0:
                preds.append(runs[wait[t, 0], 0] + wait[t, 1] - 1)
            for p in preds:
                assert p < t
                before[:, t] |= before[:, p]
                before[p, t] = True
    return before


@pytest.mark.parametrize("kind", ["sgd", "bpr", "bpr_two_shards"])
def test_table_orders_every_conflicting_pair(kind):
    """Against brute force from sa / tc / the stream: every two real tiles
    with the same user block or the same window are ordered, in plan
    order; the runs tile the stream; a published end where one is waited
    for."""
    cells = _cells(kind)
    assert len(cells) >= 2
    waits = empty = multi = 0
    for sa, tc, tl, deps, nwin in cells:
        nt = tl.shape[0]
        runs, wait = deps.runs.numpy(), deps.wait.numpy()
        assert deps.n_tiles == nt and wait.shape == (nt, 3)
        assert runs[0, 0] == 0 and (runs[:, 1] > 0).all()
        assert (runs[:-1, 0] + runs[:-1, 1] == runs[1:, 0]).all()
        assert runs[-1].sum() == nt
        blk = np.repeat(sa.numpy(), TPG)
        win = tc.numpy()
        real = (tl[:, 0] < SU).any(1).numpy()
        run_of = np.repeat(np.arange(len(runs)), runs[:, 1])
        for base, n in runs:  # a run is one user block
            assert (blk[base:base + n] == blk[base]).all()
        before = _reaches(deps)
        x, y = np.triu_indices(nt, 1)
        clash = real[x] & real[y] & ((blk[x] == blk[y]) | (win[x] == win[y]))
        assert before[x[clash], y[clash]].all()
        # nothing else is ordered across runs but through such pairs: a
        # wait names the same window
        for t in np.flatnonzero(wait[:, 0] >= 0):
            dep = runs[wait[t, 0], 0] + wait[t, 1] - 1
            assert real[t] and real[dep] and win[dep] == win[t]
            assert run_of[dep] < run_of[t] and wait[dep, 2] == 1
        waits += int((wait[:, 0] >= 0).sum())
        strata = {(b, w) for b, w in zip(blk[real], win[real])}
        empty += len(set(blk[real])) * nwin - len(strata)
        multi += sum(int(((blk == b) & (win == w) & real).sum()) > 1
                     for b, w in strata)
    assert waits > 0 and empty > 0 and multi > 0


def _replay(kind, sa, tc, tl, order, state):
    """The plain version over the tiles in ``order`` (one user block a
    tile, so tpg = 1), from ``state``; returns the tables (with the bias
    vectors for the tile-bias kind)."""
    tabs = [x.clone() for x in state]
    o = torch.as_tensor(order)
    sa_t = sa.repeat_interleave(TPG)[o].contiguous()
    stream = (sa_t, tc[o].contiguous(), tl[o].contiguous(), LR, REG)
    if kind in ("sgd", "sgd_r128"):
        sgd_sweep_plain(*tabs[:2], *stream, MU, su=SU, si=SI, tpg=1)
    elif kind == "tile":
        sgd_sweep_tile_plain(*tabs, *stream, MU, su=SU, si=SI, tpg=1)
    else:
        bpr_sweep_plain(*tabs[:2], *stream, su=SU, si=SI, tpg=1)
    return tabs


def _tables(seed=0, kind="sgd"):
    """P and Q (rank 128 for the rank-128 lane sweep, else RANK), then the
    bias vectors bu and bi of the same rows."""
    g = torch.Generator().manual_seed(seed)
    nu = -(-U // SU) * SU
    rank = 128 if kind == "sgd_r128" else RANK
    return (torch.randn(nu, rank, generator=g) * 0.3,
            torch.randn(NWIN * SI, rank, generator=g) * 0.3,
            torch.randn(nu, generator=g) * 0.1,
            torch.randn(NWIN * SI, generator=g) * 0.1)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["sgd", "bpr", "tile", "sgd_r128"])
def test_any_allowed_order_gives_the_plan_order_tables(kind, seed):
    state = _tables(kind=kind)
    moved = 0
    for sa, tc, tl, deps, _ in _cells(kind):
        nt = tl.shape[0]
        want = _replay(kind, sa, tc, tl, np.arange(nt), state)
        order = pdv.wavefront_order(deps, seed)
        assert sorted(order.tolist()) == list(range(nt))
        moved += int((order != np.arange(nt)).sum())
        got = _replay(kind, sa, tc, tl, order, state)
        assert _same(got, want)
        assert not torch.equal(want[0], state[0])
        if kind == "tile":  # the biases moved too
            assert not torch.equal(want[2], state[2])
            assert not torch.equal(want[3], state[3])
    assert moved > 0  # the orders tried were not the plan's


@pytest.mark.parametrize("kind", ["sgd", "bpr", "tile", "sgd_r128"])
def test_dropping_one_wait_changes_some_allowed_order(kind):
    """Two user blocks with tiles in one window that share item rows: with
    the second run's wait removed some allowed order runs it first, and
    the tables differ from the plan-order ones."""
    g = torch.Generator().manual_seed(5)
    nt = 2 * TPG
    tl = torch.randint(0, 8, (nt, 3, T), generator=g, dtype=torch.int32)
    if kind != "bpr":
        tl[:, 2] = (torch.rand(nt, T, generator=g) * 4.5 + 0.5).view(
            torch.int32)
    sa = torch.tensor([0, 1], dtype=torch.int32)
    tc = torch.zeros(nt, dtype=torch.int32)
    deps = pdv.sweep_deps(np.array([[TPG], [TPG]]), np.array([TPG, TPG]),
                          "cpu")
    assert deps.wait[TPG].tolist() == [0, TPG, 0]
    assert deps.critical == deps.n_tiles == nt
    state = _tables(kind=kind)
    want = _replay(kind, sa, tc, tl, np.arange(nt), state)
    for seed in range(8):  # the full table: every order agrees
        got = _replay(kind, sa, tc, tl, pdv.wavefront_order(deps, seed),
                      state)
        assert _same(got, want)
    wait = deps.wait.clone()
    wait[TPG, :2] = torch.tensor([-1, 0], dtype=torch.int32)
    loose = dataclasses.replace(deps, wait=wait)
    differs = [not torch.equal(
        _replay(kind, sa, tc, tl, pdv.wavefront_order(loose, seed),
                state)[1], want[1]) for seed in range(8)]
    assert any(differs)


@pytest.mark.parametrize("kind", ["sgd", "bpr", "bpr_two_shards"])
def test_critical_path(kind):
    """The longest chain is at most the sweep, at least its longest run and
    its heaviest window, and what the table's own chains give."""
    for sa, tc, tl, deps, _ in _cells(kind):
        runs = deps.runs.numpy()
        real = (tl[:, 0] < SU).any(1).numpy()
        assert runs[:, 1].max() <= deps.critical <= deps.n_tiles
        assert np.bincount(tc.numpy()[real]).max() <= deps.critical
        before = _reaches(deps)
        depth = np.zeros(deps.n_tiles, np.int64)
        for t in range(deps.n_tiles):
            depth[t] = 1 + max((depth[p] for p in
                                np.flatnonzero(before[:t, t])), default=0)
        assert deps.critical == depth.max()


@pytest.mark.parametrize("kind", ["sgd", "bpr"])
def test_critical_path_of_one_window_is_the_whole_sweep(kind):
    u, i, _ = _ids()
    i = i % SI  # every rating in window 0
    if kind == "sgd":
        skel = pdv.build_plan_skeleton(u, i, U, SI, SU, SI, T, TPG, 1)
        (deps,) = [sw.deps for sw in skel.sweeps]
    else:
        skel = prd.build_ring_skeleton(u, i, 1, -(-U // SU) * SU, SI, SU, SI,
                                       T, TPG, 1)
        (deps,) = [seg.deps[0][0] for seg in skel.segments]
    n_real = int((-(-np.bincount(u.numpy() // SU) // T)).sum())
    assert 4 * TPG < n_real < deps.n_tiles  # some runs end in pad tiles
    # every real tile is on the chain; of the pad tiles (which wait for
    # nothing and are waited for by nothing) at most one run's
    assert n_real <= deps.critical < n_real + TPG


def test_prefix_orders_itself():
    sa, tc, tl, deps, _ = _sgd_sweeps()[0]
    nt = deps.n_tiles // 2 // TPG * TPG
    head = deps.prefix(nt)
    assert head.n_tiles == nt and head.wait.shape == (nt, 3)
    runs = head.runs.numpy()
    assert runs[-1].sum() == nt and (runs[:, 1] > 0).all()
    assert head.critical <= deps.critical
    state = _tables()
    want = _replay("sgd", sa, tc, tl, np.arange(nt), state)
    got = _replay("sgd", sa, tc, tl, pdv.wavefront_order(head, 1), state)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_launch_arguments_are_checked():
    """``wavefront_launch`` (the wrappers' scheduler arguments): no table
    means one run of the whole stream; a table for another stream, of the
    wrong type, or a grid of no blocks is refused."""
    from mfx_torch.kernels.sgd_sweep import wavefront_launch

    sa, tc, tl, deps, _ = _sgd_sweeps()[0]
    nt = deps.n_tiles
    runs, wait, state, sums, grid = wavefront_launch(
        "sgd_sweep", None, None, nt, T, "cpu", 5)
    assert runs.tolist() == [[0, nt]] and wait is None and grid == 1
    assert state.tolist() == [0, 0] and sums.shape == (nt,)
    runs, wait, state, sums, grid = wavefront_launch(
        "sgd_sweep", None, deps, nt, T, torch.device("cpu"), 5)
    assert runs is deps.runs and wait is deps.wait and grid == 5
    assert state.shape == (1 + runs.shape[0],) and not state.any()
    assert wavefront_launch("sgd_sweep", None, deps, nt, T,
                            torch.device("cpu"), 10**6)[4] == runs.shape[0]
    for bad in (dataclasses.replace(deps, n_tiles=nt + TPG),
                dataclasses.replace(deps, wait=deps.wait.long()),
                dataclasses.replace(deps, wait=deps.wait[:, :2]),
                dataclasses.replace(deps, runs=deps.runs.t())):
        with pytest.raises(ValueError, match="deps"):
            wavefront_launch("sgd_sweep", None, bad, nt, T,
                             torch.device("cpu"), 1)
    with pytest.raises(ValueError, match="blocks"):
        wavefront_launch("sgd_sweep", None, deps, nt, T,
                         torch.device("cpu"), 0)


def test_measure_tool_plans_on_the_cpu_and_times_only_on_a_card(capsys):
    """``python -m mfx_torch.measure_wavefront``: ``plan`` prints a sweep's
    tiles and critical path from the skeleton alone; ``blocks`` and
    ``orders`` need a CUDA device."""
    import json

    from mfx_torch.measure_wavefront import main

    assert main(["plan", "--cell", "bpr", "--cut", "5000", "--device",
                 "cpu"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rows and all(
        1 <= r["longest_run_tiles"] <= r["critical_tiles"] <= r["tiles"]
        and r["heaviest_window_tiles"] <= r["critical_tiles"]
        and r["real_tiles"] <= r["tiles"] for r in rows)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main(["blocks", "--cell", "bpr", "--cut", "5000"])
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main(["orders", "--cut", "5000"])


def test_tile_bias_wrappers_take_the_scheduler_arguments():
    """``sgd_sweep_tile`` sizes its grid from the rank's kernel
    (``mfx_sgd_sweep_tile_max_blocks(T, rank)``), ``sgd_sweep_step_u``
    from the rank's and the user block's, which also place its pools
    (``mfx_sgd_sweep_step_u_max_blocks(T, rank, su)``); on the
    CPU both take ``deps`` and ``blocks`` and give the plain version's
    bits whatever the table and grid."""
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep_step_u,
                                             sgd_sweep_step_u_plain,
                                             sgd_sweep_tile,
                                             sgd_sweep_tile_plain,
                                             wavefront_launch)

    class Lib:
        asked = []

        def mfx_sgd_sweep_tile_max_blocks(self, *args):
            self.asked.append(args)
            return 264

        def mfx_sgd_sweep_step_u_max_blocks(self, *args):
            self.asked.append(args)
            return 132

    sa, tc, tl, deps, _ = _sgd_sweeps()[0]
    nt = deps.n_tiles
    grid = wavefront_launch("sgd_sweep_tile", Lib(), deps, nt, T,
                            torch.device("cpu"), None, sizing=(32,))[4]
    assert Lib.asked == [(T, 32)] and grid == deps.runs.shape[0]
    grid = wavefront_launch("sgd_sweep_step_u", Lib(), deps, nt, T,
                            torch.device("cpu"), None,
                            sizing=(32, SU))[4]
    assert Lib.asked[1:] == [(T, 32, SU)] and grid == deps.runs.shape[0]
    state = _tables()
    for wrapper, plain in ((sgd_sweep_tile, sgd_sweep_tile_plain),
                           (sgd_sweep_step_u, sgd_sweep_step_u_plain)):
        tabs = [x.clone() for x in state]
        want = [float(plain(*tabs, sa, tc, tl, LR, REG, MU, su=SU, si=SI,
                            tpg=TPG)), tabs]
        for kw in ({}, {"deps": deps, "blocks": 3}):
            tabs = [x.clone() for x in state]
            sse = wrapper(tabs[0], tabs[1], tabs[2], tabs[3], sa, tc, tl,
                          LR, REG, MU, su=SU, si=SI, tpg=TPG, **kw)
            assert float(sse) == want[0] and _same(tabs, want[1])


@pytest.mark.parametrize("cell,cut", [("sgd", 20), ("tile", 4),
                                      ("step_u", 4)])
def test_measure_tool_plans_the_dense_groups_and_the_tile_cell(capsys, cell,
                                                               cut):
    """``plan --cell sgd`` prints a line per dense group (strata, user
    blocks, the most strata of a window, the chain of its table); ``plan
    --cell tile`` and ``--cell step_u`` the tile-bias cell's sweeps."""
    import json

    from mfx_torch.measure_wavefront import main

    assert main(["plan", "--cell", cell, "--cut", str(cut), "--device",
                 "cpu"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    groups = [r for r in rows if "dense_group" in r]
    carving = [r["dense_carving"] for r in rows if "dense_carving" in r]
    sweeps = [r for r in rows if "sweep" in r]
    if cell != "sgd":
        assert not groups and not carving and sweeps
        assert all(r["sweep"].startswith(f"{cell} sweep") for r in sweeps)
        return
    assert groups and [r["dense_group"] for r in groups] == list(
        range(len(groups)))
    (info,) = carving
    assert info["num_strata"] == sum(r["strata"] for r in groups)
    assert 0 < info["dense_frac"] <= 1 and info["sparse_ratings"] >= 0
    for r in groups:
        assert r["user_blocks"] <= r["strata"]
        assert (r["most_strata_in_a_window"] <= r["critical_strata"]
                <= r["strata"])
