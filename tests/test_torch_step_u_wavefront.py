"""``sgd_sweep_step_u`` on the wavefront: the sweep's dependency table
(``plan_device.sweep_deps``, the per-tile body's) is enough for the
step-batched body too. Its plain version's math, replayed tile by tile in
any order the table allows, with one pool of pooled user deltas a run
(added to P and bu at each group's end) and Q and bi applied per tile,
gives the plan-order tables and SSE bit for bit; dropping one wait breaks
that."""

import dataclasses

import numpy as np
import pytest
import torch

from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels.packing import row_add
from mfx_torch.kernels.sgd_sweep import sgd_sweep_step_u_plain
from test_torch_wavefront import (LR, MU, REG, SI, SU, T, TPG, _same,
                                  _sgd_sweeps, _tables)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the replays are loops of small ops, which
    only slow down when several test processes' thread pools share the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _plan_order(sa, tc, tl, state):
    tabs = [x.clone() for x in state]
    sse = sgd_sweep_step_u_plain(*tabs, sa, tc, tl, LR, REG, MU, su=SU,
                                 si=SI, tpg=TPG)
    return tabs, sse


def _replay(sa, tc, tl, runs, order, state):
    """``sgd_sweep_step_u_plain``'s math over the tiles in ``order``: the
    item side applied per tile, the user side pooled per run and added at
    the end of each group of TPG tiles; the per-tile SSE added in tile
    order at the end, as the kernel's in-order sum does."""
    P, Q, bu, bi = (x.clone() for x in state)
    run_of = np.repeat(np.arange(runs.shape[0]), runs[:, 1])
    sa_h, tc_h = sa.tolist(), tc.tolist()
    pools = {}  # run -> the open group's rows and user-side deltas
    sums = [None] * tl.shape[0]
    for t in order.tolist():
        u, i = tl[t, 0].long(), tl[t, 1].long()
        real = u < SU
        r = tl[t, 2].view(torch.float32)[real]
        rows_u = sa_h[t // TPG] * SU + u[real]
        rows_i = tc_h[t] * SI + i[real]
        p, q, b_u, b_i = P[rows_u], Q[rows_i], bu[rows_u], bi[rows_i]
        e = r - ((p * q).sum(1) + MU + b_u + b_i)
        rows, d_p, d_bu = pools.setdefault(int(run_of[t]), ([], [], []))
        rows.append(rows_u)
        d_p.append(LR * (e[:, None] * q - REG * p))
        d_bu.append(LR * (e - REG * b_u))
        row_add(Q, rows_i, LR * (e[:, None] * p - REG * q))
        row_add(bi, rows_i, LR * (e - REG * b_i))
        sums[t] = (e * e).sum()
        if (t + 1) % TPG == 0:  # the group's end
            rows, d_p, d_bu = pools.pop(int(run_of[t]))
            rows = torch.cat(rows)
            row_add(P, rows, torch.cat(d_p))
            row_add(bu, rows, torch.cat(d_bu))
    assert not pools  # every run ends a group
    sse = torch.zeros(())
    for s in sums:
        sse = sse + s
    return [P, Q, bu, bi], sse


def test_groups_straddle_strata_but_never_runs():
    """The case the pools must get right is there: a group of TPG tiles
    with real tiles of two strata (windows) of its run; and none crosses
    a run, since the planner pads every run to TPG tiles."""
    straddle = 0
    for sa, tc, tl, deps, _ in _sgd_sweeps():
        runs = deps.runs.numpy()
        assert (runs % TPG == 0).all()
        real = (tl[:, 0] < SU).any(1).numpy()
        win = tc.numpy()
        for g in range(tl.shape[0] // TPG):
            w = win[g * TPG:(g + 1) * TPG][real[g * TPG:(g + 1) * TPG]]
            straddle += len(set(w.tolist())) > 1
    assert straddle > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_any_allowed_order_gives_the_plan_order_tables(seed):
    state = _tables()
    moved = 0
    for sa, tc, tl, deps, _ in _sgd_sweeps():
        nt = tl.shape[0]
        want, sse_want = _plan_order(sa, tc, tl, state)
        runs = deps.runs.numpy()
        same_order, sse_same = _replay(sa, tc, tl, runs, np.arange(nt),
                                       state)
        assert _same(same_order, want)
        assert torch.equal(sse_same, sse_want)
        order = pdv.wavefront_order(deps, seed)
        assert sorted(order.tolist()) == list(range(nt))
        moved += int((order != np.arange(nt)).sum())
        got, sse = _replay(sa, tc, tl, runs, order, state)
        assert _same(got, want) and torch.equal(sse, sse_want)
        for a, b in zip(want, state):  # every table and bias moved
            assert not torch.equal(a, b)
    assert moved > 0  # the orders tried were not the plan's


def test_dropping_one_wait_changes_some_allowed_order():
    """Two user blocks with tiles in one window that share item rows: with
    the second run's wait removed some allowed order runs its tiles first,
    and Q differs from the plan-order one."""
    g = torch.Generator().manual_seed(5)
    nt = 2 * TPG
    tl = torch.randint(0, 8, (nt, 3, T), generator=g, dtype=torch.int32)
    tl[:, 2] = (torch.rand(nt, T, generator=g) * 4.5 + 0.5).view(torch.int32)
    sa = torch.tensor([0, 1], dtype=torch.int32)
    tc = torch.zeros(nt, dtype=torch.int32)
    deps = pdv.sweep_deps(np.array([[TPG], [TPG]]), np.array([TPG, TPG]),
                          "cpu")
    assert deps.wait[TPG].tolist() == [0, TPG, 0]
    state = _tables()
    runs = deps.runs.numpy()
    want, sse_want = _plan_order(sa, tc, tl, state)
    for seed in range(8):  # the full table: every order agrees
        got, sse = _replay(sa, tc, tl, runs,
                           pdv.wavefront_order(deps, seed), state)
        assert _same(got, want) and torch.equal(sse, sse_want)
    wait = deps.wait.clone()
    wait[TPG, :2] = torch.tensor([-1, 0], dtype=torch.int32)
    loose = dataclasses.replace(deps, wait=wait)
    differs = [not torch.equal(
        _replay(sa, tc, tl, runs, pdv.wavefront_order(loose, seed),
                state)[0][1], want[1]) for seed in range(8)]
    assert any(differs)
