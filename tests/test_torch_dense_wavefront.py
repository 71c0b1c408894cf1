"""The dense groups' dependency table (``plan_device.sweep_deps`` with one
"tile" a stratum, built by ``prepare_dense_full``): it orders every two
strata that share a user block or a window, the plain dense phase
replayed in any order it allows gives the plan-order tables bit for bit,
dropping one wait breaks that, and the kernel's launch arguments are
checked."""

import dataclasses

import numpy as np
import pytest
import torch

from mfx_torch.data import synthetic
from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels.dense_phase import (dense_launch, dense_phase,
                                           dense_phase_plain, dense_scratch,
                                           group_prefix, plan_launch)
from mfx_torch.solvers.dense_prep import prepare_dense_full

U, I, RANK = 400, 420, 8
SU = SI = 64
NWD = 3  # windows a dense group: 7 windows -> groups of 3, 3 and 1
LR, REG, MU = 0.05, 0.02, 3.5


@pytest.fixture
def one_thread():
    """One intra-op thread: the plain version is a loop of small ops, and
    several test processes share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _groups(rfmt="int4"):
    coo = synthetic.make_synthetic(U, I, 12_000, rank=4, noise=0.3, seed=4,
                                   star_step=0.5, user_zipf_s=1.1)
    meta, groups, _, info = prepare_dense_full(
        torch.as_tensor(coo.user).int(), torch.as_tensor(coo.item).int(),
        torch.as_tensor(coo.rating).float(), U, I, SU, SI, chi_min=0.002,
        nwd=NWD, rfmt=rfmt)
    return meta, groups, info


def _tables(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(-(-U // SU) * SU, RANK, generator=g) * 0.3,
            torch.randn(-(-I // SI) * SI, RANK, generator=g) * 0.3)


def _replay(meta, grp, order, state):
    """The plain dense phase over the group's strata in ``order``."""
    P, Q = (x.clone() for x in state)
    o = torch.as_tensor(order)
    win0, nw = meta
    sse = dense_phase_plain(
        P, Q[win0 * SI:(win0 + nw) * SI],
        {k: v[o].contiguous() for k, v in grp.items() if k != "deps"},
        LR, REG, MU, su=SU, si=SI)
    return P, Q, float(sse)


def test_table_orders_every_conflicting_pair():
    """Against brute force from sa / sc: a run is one user block's strata
    in window order; every two strata with the same user block or window
    are ordered, in plan order; a wait names the nearest earlier stratum
    of the same window; the critical path is the longest chain."""
    meta, groups, info = _groups()
    assert len(groups) == 3 and info["num_strata"] >= 24
    shorter = 0
    for grp in groups:
        deps = grp["deps"]
        sa, sc = grp["sa"].numpy(), grp["sc"].numpy()
        nd = sa.shape[0]
        runs, wait = deps.runs.numpy(), deps.wait.numpy()
        assert deps.n_tiles == nd and runs[-1].sum() == nd
        assert (runs[:, 1] > 0).all() and (wait[:, 2] == 1).all()
        first = {int(b): t for t, b in enumerate(runs[:, 0])}
        pred = np.full(nd, -1)  # the stratum each one waits for
        for s in range(nd):
            if wait[s, 0] >= 0:
                pred[s] = runs[wait[s, 0], 0] + wait[s, 1] - 1
            want = max((x for x in range(s) if sc[x] == sc[s]
                        and sa[x] != sa[s]), default=-1)
            assert pred[s] == want
        depth = np.zeros(nd, np.int64)
        before = np.zeros((nd, nd), bool)
        for s in range(nd):
            ps = [p for p in (s - 1 if s not in first else -1, pred[s])
                  if p >= 0]
            for p in ps:
                assert sa[p] == sa[s] or sc[p] == sc[s]
                before[:, s] |= before[:, p]
                before[p, s] = True
            depth[s] = 1 + max((depth[p] for p in ps), default=0)
            for x in range(s):
                if sa[x] == sa[s] or sc[x] == sc[s]:
                    assert before[x, s]
            if s not in first:
                assert sa[s - 1] == sa[s] and sc[s - 1] < sc[s]
        assert deps.critical == depth.max()
        assert np.bincount(sc).max() <= deps.critical <= nd
        shorter += deps.critical < nd
    assert shorter >= 2  # a one-window group is all chain


@pytest.mark.parametrize("rfmt", ["int4", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_any_allowed_order_gives_the_plan_order_tables(one_thread, seed,
                                                       rfmt):
    meta, groups, _ = _groups(rfmt)
    state = _tables()
    moved = 0
    for m, grp in zip(meta, groups):
        nd = grp["sa"].shape[0]
        want = _replay(m, grp, np.arange(nd), state)
        order = pdv.wavefront_order(grp["deps"], seed)
        assert sorted(order.tolist()) == list(range(nd))
        moved += int((order != np.arange(nd)).sum())
        got = _replay(m, grp, order, state)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert not torch.equal(want[0], state[0])
    assert moved > 0


def test_dropping_one_wait_changes_some_allowed_order(one_thread):
    """Two user blocks' strata in one window: with the second's wait
    removed some allowed order runs it first, and Q differs."""
    g = torch.Generator().manual_seed(6)
    grp = {"sa": torch.tensor([0, 1], dtype=torch.int32),
           "sc": torch.zeros(2, dtype=torch.int32),
           "R": torch.randint(0, 256, (2, SU, SI // 2), generator=g,
                              dtype=torch.uint8),
           "du_s": torch.full((2, SU), 20.0), "di_s": torch.full((2, SI), 20.0)}
    deps = pdv.sweep_deps(np.array([[1], [1]]), np.array([1, 1]), "cpu")
    assert deps.wait[1].tolist() == [0, 1, 1] and deps.critical == 2
    state = _tables()
    meta = (0, 1)
    want = _replay(meta, grp, np.arange(2), state)
    for seed in range(6):
        got = _replay(meta, grp, pdv.wavefront_order(deps, seed), state)
        assert torch.equal(got[1], want[1]) and got[2] == want[2]
    wait = deps.wait.clone()
    wait[1, :2] = torch.tensor([-1, 0], dtype=torch.int32)
    loose = dataclasses.replace(deps, wait=wait)
    assert any(not torch.equal(
        _replay(meta, grp, pdv.wavefront_order(loose, seed), state)[1],
        want[1]) for seed in range(8))


def test_group_prefix_orders_itself(one_thread):
    meta, groups, _ = _groups()
    grp = groups[0]
    n = grp["sa"].shape[0] // 2
    head = group_prefix(grp, n)
    assert head["deps"].n_tiles == n and head["R"].shape[0] == n
    assert head["deps"].critical <= grp["deps"].critical
    state = _tables()
    want = _replay(meta[0], head, np.arange(n), state)
    got = _replay(meta[0], head, pdv.wavefront_order(head["deps"], 3), state)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rank,rfmt", [(64, "int4"), (128, "int8")])
def test_launch_arguments_are_checked(rank, rfmt):
    """``dense_launch`` (the wrapper's scheduler arguments): no table means
    one dummy run and no waits; the ring and the grid are sized from the
    group and the kernel's form (an apply unit owns 256 Q rows at rank 64,
    128 at rank 128), and so is the kernel's scratch (``dense_scratch``);
    a table for another group, of the wrong type, or a grid of no blocks
    is refused; the CPU route ignores the table and the grid, and
    ``plan_launch`` has nothing to order there."""
    meta, groups, _ = _groups(rfmt)
    grp, deps = groups[0], groups[0]["deps"]
    nd, cpu = deps.n_tiles, torch.device("cpu")
    runs, wait, order, ring, grid = dense_launch(None, None, nd, 256, 512,
                                                 cpu, 10**6, rank, rfmt)
    assert runs.shape == (1, 2) and wait is None and order is None
    nq = {64: 2, 128: 4}[rank]  # apply units of a 512-row window
    assert ring == min(8, nd) and grid == nd * (4 * 2 + nq)
    state, ring_buf, dp, sums = dense_scratch(nd, 256, 512, ring, cpu, rank)
    assert state.shape == (1 + 3 * nd + 4 * nd,) and not state.any()
    assert ring_buf.shape == (min(8, nd), 4, 512, rank)
    assert dp.shape == (min(8, nd), 4, 8 - 4 + 1, 64, rank)
    assert sums.shape == (nd * 4 * 2,)
    runs, wait, order, ring, grid = dense_launch(None, deps, nd, SU, 128, cpu,
                                                 7, rank, rfmt)
    assert runs is deps.runs and wait is deps.wait and grid == 7
    assert order is deps.list_order(7, 2, 1, 0.2, min(8, nd))
    assert sorted(order.tolist()) == list(range(nd))
    for bad in (dataclasses.replace(deps, n_tiles=nd + 1),
                dataclasses.replace(deps, wait=deps.wait.long()),
                dataclasses.replace(deps, runs=deps.runs.t())):
        with pytest.raises(ValueError, match="deps"):
            dense_launch(None, bad, nd, SU, 128, cpu, 1, rank, rfmt)
    with pytest.raises(ValueError, match="blocks"):
        dense_launch(None, deps, nd, SU, 128, cpu, 0, rank, rfmt)
    known = dict(deps._orders)
    plan_launch(grp, SU, SI, rank)  # nothing to order on the CPU
    assert deps._orders == known
    state0 = _tables()
    a = [x.clone() for x in state0]
    b = [x.clone() for x in state0]
    win0, nw = meta[0]
    seg = slice(win0 * SI, (win0 + nw) * SI)
    sa_ = dense_phase(a[0], a[1][seg], grp, LR, REG, MU, su=SU, si=SI)
    sb_ = dense_phase(b[0], b[1][seg], grp, LR, REG, MU, su=SU, si=SI,
                      deps=deps, blocks=3)
    assert float(sa_) == float(sb_)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("slots", [1, 5, 40])
def test_list_order_is_an_allowed_order(one_thread, slots):
    """The order in which the kernel hands strata out: every stratum after
    its run's previous stratum and the one its wait names, and the plain
    version walked in it gives the plan-order tables."""
    meta, groups, _ = _groups()
    state = _tables()
    for m, grp in zip(meta, groups):
        deps = grp["deps"]
        order = deps.list_order(slots, 16, 4, 0.1, 16)
        assert order is deps.list_order(slots, 16, 4, 0.1, 16)  # cached
        assert order.dtype == torch.int32
        order = order.numpy()
        assert sorted(order.tolist()) == list(range(deps.n_tiles))
        place = np.argsort(order)
        runs, wait = deps.runs.numpy(), deps.wait.numpy()
        starts = set(runs[:, 0].tolist())
        for s in range(deps.n_tiles):
            if s not in starts:
                assert place[s - 1] < place[s]
            if wait[s, 0] >= 0:
                assert place[runs[wait[s, 0], 0] + wait[s, 1] - 1] < place[s]
        want = _replay(m, grp, np.arange(deps.n_tiles), state)
        got = _replay(m, grp, order, state)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
