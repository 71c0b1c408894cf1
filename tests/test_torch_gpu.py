"""The port's CUDA kernels against their plain PyTorch versions on the card
(small shapes), bitwise run-to-run repeatability, and short training runs
through the kernels (blocked SGD, the BPR ring). Marked ``gpu``; they skip
where there is no CUDA device. Run on the card with
``python -m pytest --noconftest tests/test_torch_gpu.py`` (the conftest
imports JAX, which the port and its card do not need)."""

import dataclasses

import numpy as np
import pytest
import torch

from mfx_torch.config import BPRConfig, SGDConfig
from mfx_torch.data import synthetic, train_test_split
from mfx_torch.kernels import _build
from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels.dense_phase import dense_phase, dense_phase_plain
from mfx_torch.kernels.packing import lane_tables, plain_tables
from mfx_torch.kernels.sgd_sweep import (sgd_sweep, sgd_sweep_plain,
                                         sgd_sweep_step_u,
                                         sgd_sweep_step_u_plain,
                                         sgd_sweep_tile, sgd_sweep_tile_plain,
                                         sgd_sweep_time)
from mfx_torch.models.mf import init_model
from mfx_torch.solvers.blocked import train_epochs_blocked
from mfx_torch.solvers.dense_prep import prepare_dense_full

pytestmark = pytest.mark.gpu

# the time form's bins by rank (30 at ranks 64 and 128): the most that
# rank 16 and rank 8 hold (rank - 4), 16 at rank 32
TIME_BINS = {32: 16, 16: 12, 8: 4}

U, I, RANK = 1500, 1300, 64
SU = SI = 256
T, TPG = 64, 4
LR, REG = 0.012, 0.04
CFG = SGDConfig(
    lr=LR, reg=REG, lr_decay=0.95, epochs=2, partitioner="blocked",
    kernel="pallas", ublock=SU, iblock=SI, tile=T, dense_chi=0.01,
    dense_span="full", bias_mode="lane", plan_device="device",
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _state(dev, n=120_000, users=U, rank=RANK):
    coo = synthetic.make_synthetic(users, I, n, rank=4, noise=0.3, seed=9,
                                   star_step=0.5, user_zipf_s=0.6)
    train, test = train_test_split(coo, test_frac=0.1, seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    model = init_model(g, users, I, rank, global_mean=train.global_mean,
                       device=dev)
    u, i, r = (torch.as_tensor(x).to(dev) for x in
               (train.user, train.item, train.rating))
    return train, test, model, u.int(), i.int(), r.float()


def _check(run, plain, P, Q):
    outs = []
    for _ in range(2):
        Pk, Qk = P.clone(), Q.clone()
        outs.append((run(Pk, Qk), Pk, Qk))
    (s1, P1, Q1), (s2, P2, Q2) = outs
    assert torch.equal(P1, P2) and torch.equal(Q1, Q2) and float(s1) == float(s2)
    Pp, Qp = P.clone(), Q.clone()
    sp = plain(Pp, Qp)
    assert float((P1 - Pp).abs().max()) <= 1e-4
    assert float((Q1 - Qp).abs().max()) <= 1e-4
    assert abs(float(s1) - float(sp)) <= 1e-4 * max(1.0, float(sp))
    assert not torch.equal(P1, P)  # it updated something
    assert bool(torch.isfinite(P1).all()) and bool(torch.isfinite(Q1).all())


@pytest.mark.parametrize("rank", [RANK, 128, 32, 16, 8, 4, 2])
@pytest.mark.parametrize("tile", [T, 200])
def test_sgd_sweep_kernel_matches_plain(cuda, tile, rank):
    train, _, model, u, i, r = _state(cuda, rank=rank)
    skel = pdv.build_plan_skeleton(u, i, U, I, SU, SI, tile, TPG, 3)
    tl = pdv.epoch_tiles_device(skel, u, i, r, 0, 0)
    P, Q = lane_tables(model, SU, SI, cuda)
    for sw in skel.sweeps:
        seg = slice(sw.win0 * SI, (sw.win0 + sw.nwin) * SI)
        args = (sw.sa, sw.tc, tl[sw.t0:sw.t1], LR, REG, model.mu)
        kw = dict(su=SU, si=SI, tpg=TPG)
        before = sgd_sweep.launches
        _check(lambda Pt, Qt: sgd_sweep(Pt, Qt[seg], *args, **kw),
               lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg], *args, **kw), P, Q)
        assert sgd_sweep.launches == before + 2


@pytest.mark.parametrize("rank", [RANK, 128, 32, 16, 8, 4, 2])
@pytest.mark.parametrize("distinct", [4, 64, 1024])
def test_sgd_sweep_kernel_hot_rows_and_pads(cuda, distinct, rank):
    """Random full tiles at blocks of 1024 and T = 256 where every slot
    repeats one of ``distinct`` rows per side, the last tile half pad:
    long duplicate runs exercise the kernel's segment sums (at rank 128
    in both halves of the row, at rank 32 on 8 threads a row, below it on
    4, 2 and 1 of a slot's 8 dot threads; at rank 2 a row of one float2
    in the table)."""
    g = torch.Generator(device=cuda).manual_seed(distinct)
    su = si = 1024
    nt, tile = 32, 256
    P = torch.randn(2 * su, rank, device=cuda, generator=g) * 0.1
    Q = torch.randn(3 * si, rank, device=cuda, generator=g) * 0.1
    sa = torch.randint(0, 2, (nt // TPG,), device=cuda, generator=g,
                       dtype=torch.int32)
    tc = torch.randint(0, 3, (nt,), device=cuda, generator=g,
                       dtype=torch.int32)
    tl = torch.empty(nt, 3, tile, dtype=torch.int32, device=cuda)
    for row in (0, 1):
        tl[:, row] = torch.randint(0, distinct, (nt, tile), device=cuda,
                                   generator=g, dtype=torch.int32)
    tl[:, 2] = (torch.rand(nt, tile, device=cuda, generator=g) * 4.5
                + 0.5).view(torch.int32)
    tl[-1, 0, tile // 2:] = su
    tl[-1, 1, tile // 2:] = si
    args = (sa, tc, tl, LR, REG, 3.5)
    kw = dict(su=su, si=si, tpg=TPG)
    _check(lambda Pt, Qt: sgd_sweep(Pt, Qt, *args, **kw),
           lambda Pt, Qt: sgd_sweep_plain(Pt, Qt, *args, **kw), P, Q)


def test_lane_form_at_rank_1_raises_before_any_launch(cuda):
    """One lane cannot hold both bias lanes: the lane form refuses rank 1
    on the card's tensors as on the CPU's, and launches nothing."""
    P = torch.zeros(SU, 1, device=cuda)
    Q = torch.zeros(SI, 1, device=cuda)
    sa = torch.zeros(1, dtype=torch.int32, device=cuda)
    tc = torch.zeros(TPG, dtype=torch.int32, device=cuda)
    tl = torch.zeros(TPG, 3, T, dtype=torch.int32, device=cuda)
    before = sgd_sweep.launches
    with pytest.raises(ValueError, match="one lane cannot hold both bias"):
        sgd_sweep(P, Q, sa, tc, tl, LR, REG, 3.5, su=SU, si=SI, tpg=TPG)
    assert sgd_sweep.launches == before


@pytest.mark.parametrize("rank,rfmt", [(RANK, "int4"), (RANK, "int8"),
                                       (128, "int8"), (32, "int4"),
                                       (32, "int8")])
def test_dense_phase_kernel_matches_plain(cuda, rank, rfmt):
    train, _, model, u, i, r = _state(cuda, rank=rank)
    meta, groups, _, info = prepare_dense_full(u, i, r, U, I, SU, SI,
                                               chi_min=0.01, nwd=2,
                                               rfmt=rfmt)
    assert info["num_strata"] > 0
    P, Q = lane_tables(model, SU, SI, cuda)
    for (win0, nw), grp in zip(meta, groups):
        seg = slice(win0 * SI, (win0 + nw) * SI)
        before = dense_phase.launches
        _check(lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp, LR, REG, model.mu,
                                          su=SU, si=SI, deps=grp["deps"]),
               lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp, LR, REG,
                                                model.mu, su=SU, si=SI),
               P, Q)
        assert dense_phase.launches == before + 2


@pytest.mark.parametrize("rank", [RANK, 128, 32])
def test_trainer_through_both_kernels_is_repeatable(cuda, rank):
    """Two runs of the trainer (int4 codes at ranks 64 and 32, int8 at rank
    128) bitwise equal, and one epoch on the CPU from the card's plan bits
    within 1e-5 / 1e-4."""
    train, test, model, *_ = _state(cuda, rank=rank)
    runs = []
    for _ in range(2):
        s0, d0 = sgd_sweep.launches, dense_phase.launches
        out = [(float(tr), m.P.clone()) for _, m, tr in train_epochs_blocked(
            model, train, CFG, True, seed=0, device=cuda)]
        assert sgd_sweep.launches > s0 and dense_phase.launches > d0
        runs.append(out)
    for (ta, Pa), (tb, Pb) in zip(*runs):
        assert ta == tb and torch.equal(Pa, Pb)
    assert runs[0][1][0] < runs[0][0][0]
    cpu_model = init_model(torch.Generator().manual_seed(0), U, I, rank)
    cpu_model.P.copy_(model.P.cpu())
    cpu_model.Q.copy_(model.Q.cpu())
    cpu_model.mu = model.mu
    cfg1 = dataclasses.replace(CFG, epochs=1)
    (_, mc, trc), = train_epochs_blocked(cpu_model, train, cfg1, True,
                                         seed=0, device="cpu",
                                         plan_rand=lambda e, n: pdv.epoch_rand(
                                             n, 0, e, cuda).cpu())
    assert abs(float(trc) - runs[0][0][0]) <= 1e-5
    np.testing.assert_allclose(mc.P.numpy(), runs[0][0][1].cpu().numpy(),
                               atol=1e-4)


# ---- sgd_sweep_time (blocked timeSVD) -----------------------------------


def _time_case(dev, rank, n_bins, su, tile, nwin, users=U):
    """A temporal copy of ``_state``'s data (``chip_smoke.temporal``, the
    reference tests' recipe: timestamps, a shift per (item, bin), ratings
    clipped), its 5-row plan and the time-lane tables of a model with
    nonzero temporal terms: ``(train, model, tl, sweeps, P, Q)``."""
    from chip_smoke import temporal
    from mfx_torch.kernels.packing import pad_rows, to_tlane_model
    from mfx_torch.models.timesvd import fit_time_features, init_timesvd
    from mfx_torch.solvers import timesvd_blocked as tsb

    train, _, model, *_ = _state(dev, users=users, rank=rank)
    train = temporal(train, 1, n_bins)
    feats = fit_time_features(train, n_bins=n_bins)
    tb, dv = feats.features(train.user, train.timestamp)
    plan = tsb.build_temporal_plan_skeleton(train, tb, dv, su=su, si=su,
                                            tile=tile, tpg=TPG, nwin=nwin,
                                            device=dev)
    tl, sweeps = tsb.plan_temporal_epoch_device(*plan, 0, 0)
    tsm = init_timesvd(None, users, I, rank, n_bins, base=model)
    tsm.bt.copy_(torch.randn(I, n_bins, device=dev) * 0.1)
    tsm.alpha.copy_(torch.randn(users, device=dev) * 0.1)
    lane = to_tlane_model(tsm, n_bins)
    return (train, tsm, tl, sweeps, pad_rows(lane.P, su),
            pad_rows(lane.Q, su))


def _frozen_unchanged(P, Q, P0, Q0, rank, n_bins):
    L = rank - 3 - n_bins
    assert torch.equal(P[:, L:L + n_bins], P0[:, L:L + n_bins])
    for T_, T0, lane in ((P, P0, rank - 2), (Q, Q0, rank - 3),
                         (Q, Q0, rank - 1)):
        assert torch.equal(T_[:, lane], T0[:, lane])


@pytest.mark.parametrize("rank,n_bins", [(RANK, 8), (RANK, 30), (128, 30),
                                         (128, 70), (32, 16), (32, 28),
                                         (16, 12), (8, 4)])
def test_sgd_sweep_time_kernel_matches_plain(cuda, rank, n_bins):
    """The time form against its plain version on every sweep of a small
    temporal plan (at rank 128 with 70 bins the bin lanes straddle lane
    64, the two halves the kernel holds in turn); the frozen lanes never
    move; only the time form's counter counts."""
    _, tsm, tl, sweeps, P, Q = _time_case(cuda, rank, n_bins, SU, T, 3)
    for sw in sweeps:
        seg = slice(sw.win0 * SI, (sw.win0 + sw.nwin) * SI)
        args = (sw.sa, sw.tc, tl[sw.t0:sw.t1], LR, REG, tsm.mu)
        kw = dict(su=SU, si=SI, tpg=TPG, n_bins=n_bins)
        before, lane_before = sgd_sweep_time.launches, sgd_sweep.launches
        _check(lambda Pt, Qt: sgd_sweep_time(Pt, Qt[seg], *args, **kw),
               lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg], *args, **kw), P, Q)
        assert sgd_sweep_time.launches == before + 2
        assert sgd_sweep.launches == lane_before
        Pt, Qt = P.clone(), Q.clone()
        sgd_sweep_time(Pt, Qt[seg], *args, **kw, deps=sw.deps)
        _frozen_unchanged(Pt, Qt, P, Q, rank, n_bins)


@pytest.mark.parametrize("rank,n_bins", [(RANK, 30), (128, 30), (128, 70),
                                         (32, 16), (32, 28), (16, 12),
                                         (8, 4)])
@pytest.mark.parametrize("distinct", [4, 1024])
def test_sgd_sweep_time_kernel_hot_rows_and_pads(cuda, distinct, rank,
                                                 n_bins):
    """Random full tiles (blocks of 1024, T = 256) where every slot repeats
    one of ``distinct`` rows a side with random bins and deviations, the
    last tile half pad with garbage bins: one row's slots inject other
    bins, and only the table's values may be written back."""
    g = torch.Generator(device=cuda).manual_seed(distinct + rank)
    su = si = 1024
    nt, tile = 32, 256
    P = torch.randn(2 * su, rank, device=cuda, generator=g) * 0.1
    Q = torch.randn(3 * si, rank, device=cuda, generator=g) * 0.1
    L = rank - 3 - n_bins
    P[:, L:L + n_bins] = 0.0
    P[:, rank - 2] = 1.0
    Q[:, rank - 3] = 0.0
    Q[:, rank - 1] = 1.0
    sa = torch.randint(0, 2, (nt // TPG,), device=cuda, generator=g,
                       dtype=torch.int32)
    tc = torch.randint(0, 3, (nt,), device=cuda, generator=g,
                       dtype=torch.int32)
    tl = torch.empty(nt, 5, tile, dtype=torch.int32, device=cuda)
    for row in (0, 1):
        tl[:, row] = torch.randint(0, distinct, (nt, tile), device=cuda,
                                   generator=g, dtype=torch.int32)
    tl[:, 2] = (torch.rand(nt, tile, device=cuda, generator=g) * 4.5
                + 0.5).view(torch.int32)
    tl[:, 3] = torch.randint(0, n_bins, (nt, tile), device=cuda,
                             generator=g, dtype=torch.int32)
    tl[:, 4] = (torch.randn(nt, tile, device=cuda, generator=g)
                * 0.5).view(torch.int32)
    tl[-1, 0, tile // 2:] = su
    tl[-1, 1, tile // 2:] = si
    tl[-1, 3, tile // 2:] = 10 ** 6
    args = (sa, tc, tl, LR, REG, 3.5)
    kw = dict(su=su, si=si, tpg=TPG, n_bins=n_bins)
    _check(lambda Pt, Qt: sgd_sweep_time(Pt, Qt, *args, **kw),
           lambda Pt, Qt: sgd_sweep_plain(Pt, Qt, *args, **kw), P, Q)
    Pt, Qt = P.clone(), Q.clone()
    sgd_sweep_time(Pt, Qt, *args, **kw)
    _frozen_unchanged(Pt, Qt, P, Q, rank, n_bins)


@pytest.mark.parametrize("rank", [RANK, 128, 32, 16])
def test_blocked_timesvd_through_the_kernel_is_repeatable(cuda, rank):
    """Two runs of ``train_epochs_timesvd_blocked`` (2 epochs; 30 bins, 16
    at rank 32, 12 at rank 16) bitwise equal through the time form, never
    its plain version; the train RMSE falls."""
    from mfx_torch.config import TimeSVDConfig
    from mfx_torch.solvers.timesvd_blocked import (
        train_epochs_timesvd_blocked)

    nb = TIME_BINS.get(rank, 30)
    train, tsm, *_ = _time_case(cuda, rank, nb, SU, T, 3)
    cfg = TimeSVDConfig(lr=0.01, reg=0.02, epochs=2, n_bins=nb,
                        kernel="pallas", reg_alpha=0.02)
    base = init_model(torch.Generator(device=cuda).manual_seed(0), U, I,
                      rank, global_mean=train.global_mean)
    runs = []
    for _ in range(2):
        before = sgd_sweep_time.launches
        out = [(float(tr), m) for _, m, tr in train_epochs_timesvd_blocked(
            base, train, cfg, seed=0)]
        assert sgd_sweep_time.launches > before
        runs.append(out)
    for (ta, ma), (tb, mb_) in zip(*runs):
        assert ta == tb
        for k in ("P", "Q", "bu", "bi", "bt", "alpha"):
            assert torch.equal(getattr(ma, k), getattr(mb_, k)), k
    assert runs[0][1][0] < runs[0][0][0]


@pytest.mark.parametrize("rank", [RANK, 32])
def test_blocked_timesvdpp_on_the_card_is_its_cpu_run(cuda, rank):
    """``train_epochs_timesvdpp`` with ``kernel='pallas'`` (30 bins, 16 at
    rank 32): two runs of 2 epochs on the card bitwise equal (tables, Y,
    train RMSE) through the time form, never its plain version; the train
    RMSE falls; its first epoch on the CPU from the card's plan bits
    within 1e-5 (train RMSE) and 1e-4 (tables and Y: the card's sorted
    scatter sums in another order than the CPU's)."""
    from mfx_torch.config import TimeSVDPPConfig
    from mfx_torch.solvers.timesvdpp import train_epochs_timesvdpp

    nb = TIME_BINS.get(rank, 30)
    train, *_ = _time_case(cuda, rank, nb, SU, T, 3)
    cfg = TimeSVDPPConfig(lr=0.01, reg=0.02, epochs=2, n_bins=nb,
                          kernel="pallas", reg_alpha=0.02)
    base = init_model(torch.Generator(device=cuda).manual_seed(0), U, I,
                      rank, global_mean=train.global_mean)
    runs = []
    for _ in range(2):
        before = sgd_sweep_time.launches
        cap = {}
        runs.append([(tr, m, cap["state"].Y) for _, m, tr in
                     train_epochs_timesvdpp(base, train, cfg, seed=0,
                                            capture=cap)])
        assert sgd_sweep_time.launches > before
    a, b = runs
    for (ta, ma, ya), (tb, mb_, yb) in zip(a, b):
        assert ta == tb and np.array_equal(ya, yb) and np.abs(ya).max() > 0
        for k in ("P", "Q", "bu", "bi", "bt", "alpha"):
            assert torch.equal(getattr(ma, k), getattr(mb_, k)), k
    assert a[1][0] < a[0][0]
    cpu = init_model(torch.Generator().manual_seed(0), U, I, rank)
    for k in ("P", "Q", "bu", "bi"):
        getattr(cpu, k).copy_(getattr(base, k).cpu())
    cpu.mu = base.mu
    cap = {}
    (_, mc, trc), = train_epochs_timesvdpp(
        cpu, train, dataclasses.replace(cfg, epochs=1), seed=0, capture=cap,
        plan_rand=lambda e, n: pdv.epoch_rand(n, 0, e, cuda).cpu())
    assert abs(trc - a[0][0]) <= 1e-5
    for k in ("P", "Q", "bu", "bi", "bt", "alpha"):
        np.testing.assert_allclose(getattr(mc, k).numpy(),
                                   getattr(a[0][1], k).cpu().numpy(),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(cap["state"].Y, a[0][2], atol=1e-4)


# ---- sgd_sweep_tile, sgd_sweep_step_u (tile biases) ---------------------

TILE_SWEEPS = {"tile": (sgd_sweep_tile, sgd_sweep_tile_plain),
               "step_u": (sgd_sweep_step_u, sgd_sweep_step_u_plain)}


def _check4(run, plain, state, use_bias=True):
    """As _check, over (P, Q, bu, bi)."""
    outs = []
    for _ in range(2):
        tabs = [x.clone() for x in state]
        outs.append((float(run(*tabs)), tabs))
    (s1, k1), (s2, k2) = outs
    assert s1 == s2 and all(torch.equal(a, b) for a, b in zip(k1, k2))
    tabs = [x.clone() for x in state]
    sp = float(plain(*tabs))
    for a, b in zip(k1, tabs):
        assert float((a - b).abs().max()) <= 1e-4
        assert bool(torch.isfinite(a).all())
    assert abs(s1 - sp) <= 1e-4 * max(1.0, sp)
    moved = [not torch.equal(a, b) for a, b in zip(k1, state)]
    assert moved == [True, True, use_bias, use_bias]


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("rank", [32, 64, 128, 16, 8, 4, 2, 1])
@pytest.mark.parametrize("body", ["tile", "step_u"])
def test_tile_bias_sweep_kernels_match_plain(cuda, body, rank, use_bias):
    kernel, plain = TILE_SWEEPS[body]
    train, _, _, u, i, r = _state(cuda)
    g = torch.Generator(device=cuda).manual_seed(rank)
    model = init_model(g, U, I, rank, global_mean=train.global_mean,
                       device=cuda)
    model.bu.copy_(torch.randn(U, device=cuda, generator=g) * 0.1)
    model.bi.copy_(torch.randn(I, device=cuda, generator=g) * 0.1)
    skel = pdv.build_plan_skeleton(u, i, U, I, SU, SI, T, TPG, 3)
    tl = pdv.epoch_tiles_device(skel, u, i, r, 0, 0)
    state = plain_tables(model, SU, SI, cuda)
    for sw in skel.sweeps:
        seg = slice(sw.win0 * SI, (sw.win0 + sw.nwin) * SI)
        args = (sw.sa, sw.tc, tl[sw.t0:sw.t1], LR, REG, model.mu)
        kw = dict(su=SU, si=SI, tpg=TPG, use_bias=use_bias)
        before = kernel.launches
        _check4(lambda P, Q, bu, bi: kernel(P, Q[seg], bu, bi[seg], *args,
                                            **kw),
                lambda P, Q, bu, bi: plain(P, Q[seg], bu, bi[seg], *args,
                                           **kw), state, use_bias)
        assert kernel.launches == before + 2


@pytest.mark.parametrize("rank,tpg,distinct", [
    (32, 4, 4), (32, 8, 64), (32, 1, 512), (64, 4, 4), (64, 2, 64),
    (64, 8, 1024), (128, 4, 4), (128, 2, 64), (128, 8, 1024), (16, 4, 4),
    (16, 8, 1024), (8, 2, 64), (8, 4, 1024), (4, 4, 4), (4, 1, 512),
    (2, 4, 4), (2, 8, 1024), (1, 2, 64), (1, 4, 1024)])
@pytest.mark.parametrize("body", ["tile", "step_u"])
def test_tile_bias_sweep_kernels_hot_rows_and_pads(cuda, body, rank, tpg,
                                                   distinct):
    """Random full tiles (T = 256, blocks of 1024) where every slot repeats
    one of ``distinct`` rows per side: long duplicate runs inside a tile
    and across the tiles of a group; a tile of 200 slots' worth of pads,
    a whole pad tile in the middle of a group, and every tpg."""
    kernel, plain = TILE_SWEEPS[body]
    g = torch.Generator(device=cuda).manual_seed(distinct + tpg)
    su = si = 1024
    nt, tile = 32, 256
    P = torch.randn(2 * su, rank, device=cuda, generator=g) * 0.1
    Q = torch.randn(3 * si, rank, device=cuda, generator=g) * 0.1
    bu = torch.randn(2 * su, device=cuda, generator=g) * 0.1
    bi = torch.randn(3 * si, device=cuda, generator=g) * 0.1
    sa = torch.randint(0, 2, (nt // tpg,), device=cuda, generator=g,
                       dtype=torch.int32)
    tc = torch.randint(0, 3, (nt,), device=cuda, generator=g,
                       dtype=torch.int32)
    tl = torch.empty(nt, 3, tile, dtype=torch.int32, device=cuda)
    for row in (0, 1):
        tl[:, row] = torch.randint(0, distinct, (nt, tile), device=cuda,
                                   generator=g, dtype=torch.int32)
    tl[:, 2] = (torch.rand(nt, tile, device=cuda, generator=g) * 4.5
                + 0.5).view(torch.int32)
    tl[-1, 0, 56:], tl[-1, 1, 56:] = su, si
    tl[5, 0], tl[5, 1] = su, si
    args = (sa, tc, tl, LR, REG, 3.5)
    kw = dict(su=su, si=si, tpg=tpg)
    _check4(lambda *t: kernel(*t, *args, **kw),
            lambda *t: plain(*t, *args, **kw), (P, Q, bu, bi))


def test_step_u_kernel_with_groups_of_one_is_the_tile_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    su = si = 512
    nt, tile, rank = 16, 256, 32
    state = (torch.randn(su, rank, device=cuda, generator=g) * 0.1,
             torch.randn(si, rank, device=cuda, generator=g) * 0.1,
             torch.randn(su, device=cuda, generator=g) * 0.1,
             torch.randn(si, device=cuda, generator=g) * 0.1)
    tl = torch.randint(0, 300, (nt, 3, tile), device=cuda, generator=g,
                       dtype=torch.int32)
    tl[:, 2] = (torch.rand(nt, tile, device=cuda, generator=g) * 4.5
                + 0.5).view(torch.int32)
    z = torch.zeros(nt, dtype=torch.int32, device=cuda)
    a, b = [x.clone() for x in state], [x.clone() for x in state]
    sa_ = sgd_sweep_step_u(*a, z, z, tl, LR, REG, 3.5, su=su, si=si, tpg=1)
    sb_ = sgd_sweep_tile(*b, z, z, tl, LR, REG, 3.5, su=su, si=si, tpg=1)
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) <= 1e-6
    assert abs(float(sa_) - float(sb_)) <= 1e-6 * float(sb_)


@pytest.mark.parametrize("step_u", [False, True])
def test_tile_bias_trainer_through_the_kernels_is_repeatable(cuda, step_u):
    train, test, _, *_ = _state(cuda)
    cfg = SGDConfig(lr=0.01, reg=0.04, lr_decay=0.92, epochs=2,
                    partitioner="blocked", kernel="pallas", ublock=SU,
                    iblock=SI, tile=T, step_user_batch=step_u)
    kernel = sgd_sweep_step_u if step_u else sgd_sweep_tile
    model = init_model(torch.Generator(device=cuda).manual_seed(0), U, I, 32,
                       global_mean=train.global_mean, device=cuda)
    runs = []
    for _ in range(2):
        before = kernel.launches
        runs.append([(float(tr), m.P.clone(), m.bu.clone())
                     for _, m, tr in train_epochs_blocked(
                         model, train, cfg, True, seed=0, device=cuda)])
        assert kernel.launches > before
    for (ta, Pa, ba), (tb, Pb, bb) in zip(*runs):
        assert ta == tb and torch.equal(Pa, Pb) and torch.equal(ba, bb)
    assert runs[0][1][0] < runs[0][0][0]
    assert float(runs[0][1][2].abs().max()) > 0
    # one epoch on the CPU from the card's plan bits agrees
    cpu_model = init_model(torch.Generator().manual_seed(0), U, I, 32)
    cpu_model.P.copy_(model.P.cpu())
    cpu_model.Q.copy_(model.Q.cpu())
    cpu_model.mu = model.mu
    (_, mc, trc), = train_epochs_blocked(
        cpu_model, train, dataclasses.replace(cfg, epochs=1), True, seed=0,
        device="cpu",
        plan_rand=lambda e, n: pdv.epoch_rand(n, 0, e, cuda).cpu())
    assert abs(float(trc) - runs[0][0][0]) <= 1e-5
    np.testing.assert_allclose(mc.P.numpy(), runs[0][0][1].cpu().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(mc.bu.numpy(), runs[0][0][2].cpu().numpy(),
                               atol=1e-4)


# ---- tile_topk (serving) ----------------------------------------------


def _serve_tables(dev, B, I, rank, tile, dtype="f32", seed=0):
    from mfx_torch.kernels.serve_topk import aug_width
    from mfx_torch.serve.fused import (_augment_catalog,
                                       _augment_catalog_int8, _augment_rows)

    g = torch.Generator(device=dev).manual_seed(seed)
    P = torch.randn(B, rank, device=dev, generator=g)
    Q = torch.randn(I, rank, device=dev, generator=g) / rank ** 0.5
    bi = torch.randn(I, device=dev, generator=g) * 0.3
    ipad = -(-I // tile) * tile
    if dtype == "int8":
        Q_aug, sb = _augment_catalog_int8(Q, bi, ipad, tile)
        return _augment_rows(P, torch.float32, aug_width(rank)), Q_aug, sb
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (_augment_rows(P, dt, aug_width(rank)),
            _augment_catalog(Q, bi, ipad, dt), None)


def _same_candidates(got, want, P_aug, Q_aug, sb, tile, tol=1e-4):
    full = P_aug.double() @ Q_aug.double().T
    if sb is not None:
        full = full * sb[:, 0].reshape(1, -1).double() \
            + sb[:, 1].reshape(1, -1).double()
    for j in range(0, len(got), 2):
        (m_k, a_k), (m_p, a_p) = got[j:j + 2], want[j:j + 2]
        assert a_k.dtype == torch.int32 and m_k.shape == m_p.shape
        assert float((m_k - m_p).abs().max()) <= tol
        bad = a_k != a_p
        if bool(bad.any()):
            b, t = bad.nonzero(as_tuple=True)
            s_k = full[b, t * tile + a_k[bad].long()]
            s_p = full[b, t * tile + a_p[bad].long()]
            assert float((s_k - s_p).abs().max()) <= tol


@pytest.mark.parametrize("dtype,depth,tile,B,rank,items", [
    ("f32", 1, 128, 20, 8, 5000), ("f32", 2, 1024, 256, 64, 5000),
    ("f32", 8, 1024, 40, 64, 5000), ("f32", 32, 2048, 17, 127, 5000),
    ("f32", 3, 256, 16, 31, 5000), ("bf16", 2, 1024, 33, 64, 5000),
    ("int8", 2, 1024, 48, 64, 5000), ("int8", 8, 128, 5, 16, 5000),
    # batches that are not a multiple of a block's users (16 or 64), on
    # either block size; depths 1, 8, 32; tiles 128 and 2048; catalogs
    # of a few tiles
    ("f32", 1, 128, 1, 64, 5000), ("f32", 32, 2048, 300, 64, 5000),
    ("f32", 8, 128, 300, 64, 300), ("f32", 2, 2048, 37, 64, 6000),
    ("bf16", 8, 2048, 37, 64, 5000), ("bf16", 2, 128, 300, 64, 5000),
    ("bf16", 32, 128, 1, 16, 500), ("bf16", 1, 1024, 300, 24, 2500),
    ("int8", 32, 128, 300, 64, 5000), ("int8", 1, 1024, 37, 64, 3000),
    ("int8", 8, 2048, 1, 32, 4000), ("int8", 2, 128, 300, 8, 256),
])
def test_tile_topk_kernel_matches_plain(cuda, dtype, depth, tile, B, rank,
                                        items):
    from mfx_torch.kernels.serve_topk import tile_topk, tile_topk_plain

    P_aug, Q_aug, sb = _serve_tables(cuda, B, items, rank, tile, dtype)
    before = tile_topk.launches
    runs = [tile_topk(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
            for _ in range(2)]
    assert tile_topk.launches == before + 2
    for x, y in zip(*runs):  # bitwise repeatable
        assert torch.equal(x, y)
    want = tile_topk_plain(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
    _same_candidates(runs[0], want, P_aug, Q_aug, sb, tile)


def test_tile_topk_kernel_takes_the_lowest_lane_on_ties(cuda):
    from mfx_torch.kernels.serve_topk import tile_topk

    P_aug, Q_aug, _ = _serve_tables(cuda, 24, 1024, 8, 256)
    best = Q_aug[0].clone()
    best[:8] = 3.0
    for lane in (200, 40, 33, 7, 256 + 255, 256 + 1):
        Q_aug[lane] = best
    P_aug[:, :8] = P_aug[:, :8].abs() + 1.0
    out = tile_topk(P_aug, Q_aug, tile=256, depth=4)
    lanes = [out[j][:, :2].cpu() for j in (1, 3, 5, 7)]
    assert (lanes[0][:, 0] == 7).all() and (lanes[1][:, 0] == 33).all()
    assert (lanes[2][:, 0] == 40).all() and (lanes[3][:, 0] == 200).all()
    assert (lanes[0][:, 1] == 1).all() and (lanes[1][:, 1] == 255).all()
    vals = out[0][:, 0]
    assert torch.equal(out[2][:, 0], vals) and torch.equal(out[6][:, 0], vals)


@pytest.mark.parametrize("dtype,depth,tile,B", [
    ("f32", 2, 1024, 1), ("f32", 2, 1024, 37), ("f32", 8, 2048, 300),
    ("bf16", 1, 128, 37), ("bf16", 8, 1024, 130), ("int8", 32, 256, 130),
    ("int8", 2, 1024, 256),
])
def test_tile_topk_block_forms_give_the_same_bits(cuda, dtype, depth, tile,
                                                  B):
    """Held to 16 or to 128 users a block, the kernel gives the bits of the
    form its launch chooses, whichever that is."""
    from mfx_torch.kernels.serve_topk import _launch, tile_topk

    P_aug, Q_aug, sb = _serve_tables(cuda, B, 3000, 64, tile, dtype)
    want = tile_topk(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
    for ub in (16, 128):
        got = _launch(P_aug, Q_aug, tile, depth, sb, ub)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype,depth,tile,B,rank,items", [
    # depths past 32 on tiles of 128-2048; tiles past 2048 at small and
    # large depths; lists in shared memory and, at depth 1024, in the
    # device scratch; batches of 1, 37 and 300 users
    ("f32", 33, 256, 37, 64, 5000), ("f32", 48, 256, 300, 64, 5000),
    ("f32", 64, 1024, 300, 64, 9000), ("f32", 256, 1024, 37, 64, 9000),
    ("f32", 1024, 1024, 20, 64, 5000), ("f32", 128, 128, 1, 64, 500),
    ("f32", 2, 2304, 300, 64, 9000), ("f32", 40, 2304, 37, 64, 9000),
    ("f32", 2, 4096, 37, 64, 20000), ("f32", 40, 4096, 1, 127, 9000),
    ("f32", 64, 8192, 16, 64, 20000), ("bf16", 64, 1024, 300, 64, 9000),
    ("bf16", 40, 2304, 37, 64, 9000), ("bf16", 2, 4096, 1, 16, 9000),
    ("int8", 64, 1024, 300, 64, 9000), ("int8", 40, 2304, 37, 64, 9000),
    ("int8", 2, 4096, 300, 8, 9000), ("int8", 300, 512, 17, 32, 3000),
])
def test_tile_topk_deep_form_matches_plain(cuda, dtype, depth, tile, B,
                                           rank, items):
    """The deep form (depth > 32 or tile > 2048) against the plain
    version: values within 1e-4, lanes equal but at near-ties, two runs
    bitwise equal; only the deep form's counter moves."""
    from mfx_torch.kernels.serve_topk import tile_topk, tile_topk_plain

    P_aug, Q_aug, sb = _serve_tables(cuda, B, items, rank, tile, dtype)
    before = (tile_topk.launches, tile_topk.deep_launches)
    runs = [tile_topk(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert (tile_topk.launches, tile_topk.deep_launches) == (
        before[0], before[1] + 2)
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    want = tile_topk_plain(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
    _same_candidates(runs[0], want, P_aug, Q_aug, sb, tile)


def _exact_tables(dev, B, items, rank, tile, seed=0):
    """Tables whose every product and sum is exact in f32 (small integers
    and quarters): any summation order gives the kernel's bits, so the
    plain version must equal the kernel bitwise; and many equal scores."""
    from mfx_torch.kernels.serve_topk import aug_width
    from mfx_torch.serve.fused import _augment_catalog, _augment_rows

    g = torch.Generator(device=dev).manual_seed(seed)
    P = torch.randint(-3, 4, (B, rank), device=dev, generator=g).float()
    Q = torch.randint(-3, 4, (items, rank), device=dev,
                      generator=g).float() / 4
    bi = torch.randint(-4, 5, (items,), device=dev, generator=g).float() / 2
    ipad = -(-items // tile) * tile
    return (_augment_rows(P, torch.float32, aug_width(rank)),
            _augment_catalog(Q, bi, ipad, torch.float32))


@pytest.mark.parametrize("depth,tile,B,rank,items,lists", [
    # the serving shapes (15 tiles x 4 user blocks: two pieces a tile)
    (64, 4096, 256, 64, 59_047, 0),
    # few tiles, a small batch: many pieces a tile, merged by a second
    # launch; lists in shared memory and in the device scratch
    (64, 4096, 16, 64, 9_000, 0), (64, 4096, 16, 64, 9_000, 2),
    (300, 512, 17, 32, 3_000, 0), (1024, 1024, 10, 16, 3_000, 0),
    (40, 4096, 1, 127, 9_000, 0), (2, 8192, 37, 8, 20_000, 0),
    (33, 256, 300, 64, 5_000, 2), (128, 128, 1, 64, 500, 0),
])
def test_tile_topk_deep_form_is_the_plain_bits_on_exact_scores(
        cuda, depth, tile, B, rank, items, lists):
    """On tables whose scores are exact in any order, with many ties, the
    deep form (as launched, or held to its lists in the device scratch)
    equals the plain version bitwise: values, and lanes lowest first."""
    from mfx_torch.kernels.serve_topk import (_launch_deep, tile_topk,
                                              tile_topk_plain)

    P_aug, Q_aug = _exact_tables(cuda, B, items, rank, tile, seed=depth)
    got = (tile_topk(P_aug, Q_aug, tile=tile, depth=depth) if lists == 0
           else _launch_deep(P_aug, Q_aug, tile, depth, None, lists))
    want = tile_topk_plain(P_aug, Q_aug, tile=tile, depth=depth)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype,depth,tile,B", [
    ("f32", 32, 1024, 300), ("f32", 2, 2048, 37), ("bf16", 8, 512, 130),
    ("int8", 32, 256, 256), ("int8", 1, 128, 5), ("bf16", 32, 2048, 1),
])
def test_tile_topk_deep_form_is_the_register_forms_bits(cuda, dtype, depth,
                                                        tile, B):
    """Where both forms apply (depth <= 32, tile <= 2048) the deep form
    gives the register-list form's bits: the same FMA chains, the same
    order."""
    from mfx_torch.kernels.serve_topk import _launch, _launch_deep

    P_aug, Q_aug, sb = _serve_tables(cuda, B, 5000, 64, tile, dtype)
    want = _launch(P_aug, Q_aug, tile, depth, sb)
    got = _launch_deep(P_aug, Q_aug, tile, depth, sb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tile_topk_deep_form_takes_the_lowest_lane_on_ties(cuda):
    """Equal scores across chunks and within one: lower lanes first, as
    the reference's max-extract takes them."""
    from mfx_torch.kernels.serve_topk import tile_topk

    P_aug, Q_aug, _ = _serve_tables(cuda, 24, 4096, 8, 4096)
    best = Q_aug[0].clone()
    best[:8] = 3.0
    tied = (4000, 2100, 700, 129, 128, 7, 3)
    for lane in tied:
        Q_aug[lane] = best
    P_aug[:, :8] = P_aug[:, :8].abs() + 1.0
    out = tile_topk(P_aug, Q_aug, tile=4096, depth=40)
    lanes = torch.stack([out[j][:, 0] for j in range(1, 2 * len(tied), 2)])
    assert (lanes.cpu().T == torch.tensor(sorted(tied))).all()
    vals = torch.stack([out[j][:, 0] for j in range(0, 2 * len(tied), 2)])
    assert bool((vals == vals[0]).all())


def test_tile_topk_deep_form_raises_when_the_library_fails(cuda,
                                                           monkeypatch):
    """On the card the deep form launches or raises: with the library
    failing to load, depth 64 raises and never runs the plain version."""
    from mfx_torch.kernels import serve_topk

    def no_library():
        raise RuntimeError("no library")

    def plain(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(serve_topk._build, "load_library", no_library)
    monkeypatch.setattr(serve_topk, "tile_topk_plain", plain)
    P_aug, Q_aug, _ = _serve_tables(cuda, 16, 2048, 64, 1024)
    with pytest.raises(RuntimeError, match="no library"):
        serve_topk.tile_topk(P_aug, Q_aug, tile=1024, depth=64)


@pytest.mark.parametrize("exact,table_dtype", [(False, "f32"),
                                                (False, "bf16"),
                                                (False, "int8"),
                                                (True, "f32")])
def test_fused_recommender_on_the_card_matches_plain(cuda, monkeypatch,
                                                     exact, table_dtype):
    """The fused recommender through the kernel equals the same recommender
    with the kernel's plain version swapped in, on the card; exact mode
    also equals the stock scorer."""
    from mfx_torch.convert import model_from_numpy
    from mfx_torch.kernels import serve_topk
    from mfx_torch.serve import FusedTopKRecommender, TopKRecommender
    from mfx_torch.serve import fused

    rng = np.random.default_rng(1)
    Un, In, r = 300, 9000, 64
    model = model_from_numpy({
        "P": rng.normal(0, 0.3, (Un, r)), "Q": rng.normal(0, 0.3, (In, r)),
        "bu": rng.normal(0, 0.2, Un), "bi": rng.normal(0, 0.2, In),
        "mu": 3.5}, device=cuda)
    coo = synthetic.make_synthetic(Un, In, 20_000, seed=3)
    users = np.arange(Un, dtype=np.int32)
    kw = dict(train=coo, batch=64, tile=1024, table_dtype=table_dtype,
              exact=exact, exact_tiles=9, exact_depth=8)
    before = serve_topk.tile_topk.launches
    got = FusedTopKRecommender(model, **kw).recommend(users, k=10)
    assert serve_topk.tile_topk.launches > before
    monkeypatch.setattr(fused, "tile_topk", serve_topk.tile_topk_plain)
    want = FusedTopKRecommender(model, **kw).recommend(users, k=10)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert (got[0] != want[0]).mean() <= 0.01
    if exact:
        stock = TopKRecommender(model, train=coo, batch=64).recommend(
            users, k=10)
        np.testing.assert_allclose(got[1], stock[1], rtol=1e-5, atol=1e-5)
        assert (got[0] != stock[0]).mean() <= 0.01


# ---- bpr_sweep (the BPR ring) ------------------------------------------


BPR = BPRConfig(lr=0.05, reg=0.002, epochs=2, kernel="pallas", ublock=128,
                iblock=128, tile=64, neg_seed=1)


def _bpr_state(dev, tile=64, rank=RANK):
    from mfx_torch.parallel import bpr_sharded as ring

    coo = synthetic.make_implicit_synthetic(700, 600, 30_000, rank=4, seed=5)
    g = torch.Generator(device=dev).manual_seed(0)
    model = init_model(g, 700, 600, rank)
    cfg = dataclasses.replace(BPR, tile=tile)
    st = ring.ring_state(model, coo, cfg, seed=0, device=dev)
    return coo, model, cfg, st, ring.ring_epoch_tiles(st, cfg, 0, 0)


@pytest.mark.parametrize("rank", [RANK, 32, 128, 16, 8, 4, 2, 1])
@pytest.mark.parametrize("tile", [64, 256])
def test_bpr_sweep_kernel_matches_plain(cuda, tile, rank):
    from mfx_torch.kernels.bpr_sweep import bpr_sweep, bpr_sweep_plain

    _, _, cfg, st, tls = _bpr_state(cuda, tile, rank)
    for (win0, nw, sa, tc, _), slab in zip(st.segments(), tls):
        seg = slice(win0 * cfg.iblock, (win0 + nw) * cfg.iblock)
        args = (sa, tc, slab[0, 0], cfg.lr, cfg.reg)
        kw = dict(su=cfg.ublock, si=cfg.iblock, tpg=TPG)
        before = bpr_sweep.launches
        _check(lambda Pt, Qt: bpr_sweep(Pt, Qt[seg], *args, **kw),
               lambda Pt, Qt: bpr_sweep_plain(Pt, Qt[seg], *args, **kw),
               st.P, st.Q)
        assert bpr_sweep.launches == before + 2


@pytest.mark.parametrize("rank", [RANK, 32, 128, 16, 8, 4, 2, 1])
@pytest.mark.parametrize("distinct", [4, 64, 512])
def test_bpr_sweep_kernel_hot_rows_and_pads(cuda, distinct, rank):
    """Random full tiles at the preset's blocks (512) and tile (256) where
    every slot repeats one of ``distinct`` rows per side (so positives and
    negatives share rows, and the negatives' add reads the positives'),
    the first tile all pad and the last half pad."""
    from mfx_torch.kernels.bpr_sweep import bpr_sweep, bpr_sweep_plain

    g = torch.Generator(device=cuda).manual_seed(distinct)
    su = si = 512
    nt, tile = 32, 256
    P = torch.randn(2 * su, rank, device=cuda, generator=g) * 0.1
    Q = torch.randn(3 * si, rank, device=cuda, generator=g) * 0.1
    sa = torch.randint(0, 2, (nt // TPG,), device=cuda, generator=g,
                       dtype=torch.int32)
    tc = torch.randint(0, 3, (nt,), device=cuda, generator=g,
                       dtype=torch.int32)
    tl = torch.randint(0, distinct, (nt, 3, tile), device=cuda, generator=g,
                       dtype=torch.int32)
    tl[0, 0], tl[0, 1:] = su, si
    tl[-1, 0, tile // 2:] = su
    tl[-1, 1:, tile // 2:] = si
    args = (sa, tc, tl, 0.05, 0.002)
    kw = dict(su=su, si=si, tpg=TPG)
    _check(lambda Pt, Qt: bpr_sweep(Pt, Qt, *args, **kw),
           lambda Pt, Qt: bpr_sweep_plain(Pt, Qt, *args, **kw), P, Q)


def test_bpr_ring_through_the_kernel_is_repeatable(cuda):
    from mfx_torch.data.bpr import uniform_below
    from mfx_torch.kernels.bpr_sweep import bpr_sweep
    from mfx_torch.parallel import bpr_sharded as ring

    coo, model, cfg, _, _ = _bpr_state(cuda)
    runs = []
    for _ in range(2):
        before = bpr_sweep.launches
        runs.append([(loss, m.P.clone(), m.Q.clone()) for _, m, loss in
                     ring.train_epochs_bpr_ring(model, coo, cfg, seed=0,
                                                device=cuda)])
        assert bpr_sweep.launches > before
    for (la, Pa, Qa), (lb, Pb, Qb) in zip(*runs):
        assert la == lb and torch.equal(Pa, Pb) and torch.equal(Qa, Qb)
    assert runs[0][1][0] < runs[0][0][0]
    # one epoch on the CPU from the card's random numbers agrees
    cpu_model = init_model(torch.Generator().manual_seed(0), 700, 600, RANK)
    cpu_model.P.copy_(model.P.cpu())
    cpu_model.Q.copy_(model.Q.cpu())
    (_, mc, lc), = ring.train_epochs_bpr_ring(
        cpu_model, coo, dataclasses.replace(cfg, epochs=1), seed=0,
        device="cpu",
        plan_rand=lambda e, n: pdv.epoch_rand(n, 0, e, cuda).cpu(),
        neg_rand=lambda e, nav: uniform_below(
            nav.to(cuda), ring.neg_generator(0 + cfg.neg_seed, e,
                                             cuda)).cpu())
    assert abs(lc - runs[0][0][0]) <= 1e-5 * runs[0][0][0]
    np.testing.assert_allclose(mc.P.numpy(), runs[0][0][1].cpu().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(mc.Q.numpy(), runs[0][0][2].cpu().numpy(),
                               atol=1e-4)


# ---- the wavefront: sgd_sweep, bpr_sweep, sgd_sweep_tile and dense_phase
# on many SMs -------------------------------------------------------------


def _wavefront_case(kernel, dev):
    """A whole small sweep (blocks of 64, so a few dozen runs and several
    windows) or dense group (blocks of 128: 12 user blocks, 11 windows):
    ``(run(tables, blocks, table=True), plain(tables), tables, deps)``;
    ``table=False`` leaves the dependency table out. ``step_u_su1024``
    takes user blocks of 1,024 (rank 64, as phase 3 of ``chip_smoke.py``
    runs it) over 9,000 users, where the kernel keeps its pools in device
    memory; ``step_u`` keeps them in shared memory."""
    # the rank of a case named ..._r<rank> (rank 64 without); ..._bf16...
    # is the sweep's bf16 form, ..._echo... the dense phase's echo=2
    tail = kernel.rsplit("_r", 1)
    rank = int(tail[1]) if len(tail) == 2 and tail[1].isdigit() else RANK
    bf16 = "_bf16" in kernel
    if kernel.startswith(("sgd", "tile", "step_u", "epoch")):
        users = 9000 if kernel == "step_u_su1024" else U
        train, _, model, u, i, r = _state(dev, users=users, rank=rank)
        su = 1024 if kernel == "step_u_su1024" else 64
        si = 64
        skel = pdv.build_plan_skeleton(u, i, users, I, su, si, T, TPG, 8)
        tl = pdv.epoch_tiles_device(skel, u, i, r, 0, 0)
        sw = skel.sweeps[0]
        seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
        args = (sw.sa, sw.tc, tl[sw.t0:sw.t1], LR, REG, model.mu)
        kw = dict(su=su, si=si, tpg=TPG, bf16=bf16)
        if kernel.startswith("sgd"):
            return (lambda tabs, blocks, table=True: sgd_sweep(
                        tabs[0], tabs[1][seg], *args, **kw, blocks=blocks,
                        deps=sw.deps if table else None),
                    lambda tabs: sgd_sweep_plain(tabs[0], tabs[1][seg], *args,
                                                 **kw),
                    lane_tables(model, su, si, dev), sw.deps)
        model.bu.copy_(torch.randn(users, device=dev) * 0.1)
        model.bi.copy_(torch.randn(I, device=dev) * 0.1)
        if kernel.startswith("epoch"):  # the residuals: a fifth "table"
            from mfx_torch.kernels.sgd_sweep import (sgd_sweep_epoch,
                                                     sgd_sweep_epoch_plain)

            e = torch.zeros(sw.t1 - sw.t0, T, device=dev)
            return (lambda tabs, blocks, table=True: sgd_sweep_epoch(
                        tabs[0], tabs[1][seg], tabs[2], tabs[3][seg],
                        *args[:3], tabs[4], *args[3:], **kw, blocks=blocks,
                        deps=sw.deps if table else None),
                    lambda tabs: sgd_sweep_epoch_plain(
                        tabs[0], tabs[1][seg], tabs[2], tabs[3][seg],
                        *args[:3], tabs[4], *args[3:], **kw),
                    plain_tables(model, su, si, dev) + (e,), sw.deps)
        wrapper, plain = sgd_sweep_tile, sgd_sweep_tile_plain
        if not kernel.startswith("tile"):
            wrapper, plain = sgd_sweep_step_u, sgd_sweep_step_u_plain
            floats = _build.load_library().mfx_sgd_sweep_step_u_pool_floats(
                T, rank, su)  # the pools' device memory a block
            assert floats == (su * (rank + 1) if su == 1024 else 0)
        return (lambda tabs, blocks, table=True: wrapper(
                    tabs[0], tabs[1][seg], tabs[2], tabs[3][seg], *args,
                    **kw, blocks=blocks, deps=sw.deps if table else None),
                lambda tabs: plain(
                    tabs[0], tabs[1][seg], tabs[2], tabs[3][seg], *args,
                    su=su, si=si, tpg=TPG, bf16=bf16),
                plain_tables(model, su, si, dev), sw.deps)
    if kernel.startswith("time"):
        nb = TIME_BINS.get(rank, 30)
        _, tsm, tl, sweeps, P, Q = _time_case(dev, rank, nb, 64, T, 8)
        sw = sweeps[0]
        seg = slice(sw.win0 * 64, (sw.win0 + sw.nwin) * 64)
        args = (sw.sa, sw.tc, tl[sw.t0:sw.t1], LR, REG, tsm.mu)
        kw = dict(su=64, si=64, tpg=TPG, n_bins=nb)
        return (lambda tabs, blocks, table=True: sgd_sweep_time(
                    tabs[0], tabs[1][seg], *args, **kw, blocks=blocks,
                    deps=sw.deps if table else None),
                lambda tabs: sgd_sweep_plain(tabs[0], tabs[1][seg], *args,
                                             **kw),
                (P, Q), sw.deps)
    if kernel.startswith("dense"):
        rfmt = "int8" if "int8" in kernel else "int4"
        train, _, model, u, i, r = _state(dev, rank=rank)
        su = si = 128
        (meta,), (grp,), _, _ = prepare_dense_full(u, i, r, U, I, su, si,
                                                   chi_min=0.01, nwd=11,
                                                   rfmt=rfmt)
        seg = slice(meta[0] * si, (meta[0] + meta[1]) * si)
        kw = dict(su=su, si=si)
        bias = next((b for b in ("frozen", "none") if b in kernel), "lane")
        echo = 2 if "_echo" in kernel else 1
        if echo > 1:  # the lane or bias-free form, the echo slots' table
            deps = grp["deps"].repeat(echo)
            kw.update(bias=bias, echo=echo)
            tabs0 = (lane_tables(model, su, si, dev) if bias == "lane"
                     else plain_tables(model, su, si, dev)[:2])
            return (lambda tabs, blocks, table=True: dense_phase(
                        tabs[0], tabs[1][seg], grp, LR, REG, model.mu, **kw,
                        blocks=blocks, deps=deps if table else None),
                    lambda tabs: dense_phase_plain(
                        tabs[0], tabs[1][seg], grp, LR, REG, model.mu, **kw),
                    tabs0, deps)
        if bias != "lane":  # the frozen form's sums ride as two "tables"
            model.bu.copy_(torch.randn(U, device=dev) * 0.1)
            model.bi.copy_(torch.randn(I, device=dev) * 0.1)
            nd = grp["sa"].shape[0]
            plain = _dense_form_run(bias, grp, seg, model.mu, su, si,
                                    kernel=False)
            return (lambda tabs, blocks, table=True: _dense_form_run(
                        bias, grp, seg, model.mu, su, si, blocks,
                        table)(*tabs),
                    lambda tabs: plain(*tabs),
                    plain_tables(model, su, si, dev)
                    + (torch.zeros(nd, su, device=dev),
                       torch.zeros(nd, si, device=dev)), grp["deps"])
        return (lambda tabs, blocks, table=True: dense_phase(
                    tabs[0], tabs[1][seg], grp, LR, REG, model.mu, **kw,
                    blocks=blocks, deps=grp["deps"] if table else None),
                lambda tabs: dense_phase_plain(tabs[0], tabs[1][seg], grp,
                                               LR, REG, model.mu, **kw),
                lane_tables(model, su, si, dev), grp["deps"])
    from mfx_torch.kernels.bpr_sweep import bpr_sweep, bpr_sweep_plain
    from mfx_torch.parallel import bpr_sharded as ring

    coo = synthetic.make_implicit_synthetic(700, 600, 30_000, rank=4, seed=5)
    model = init_model(torch.Generator(device=dev).manual_seed(0), 700, 600,
                       rank)
    cfg = dataclasses.replace(BPR, ublock=64, iblock=64)
    st = ring.ring_state(model, coo, cfg, seed=0, device=dev)
    tls = ring.ring_epoch_tiles(st, cfg, 0, 0)
    win0, nw, sa, tc, deps = st.segments()[0]
    seg = slice(win0 * 64, (win0 + nw) * 64)
    args = (sa, tc, tls[0][0, 0], cfg.lr, cfg.reg)
    kw = dict(su=64, si=64, tpg=TPG)
    return (lambda tabs, blocks, table=True: bpr_sweep(
                tabs[0], tabs[1][seg], *args, **kw, blocks=blocks,
                deps=deps if table else None),
            lambda tabs: bpr_sweep_plain(tabs[0], tabs[1][seg], *args, **kw),
            (st.P, st.Q), deps)


WAVEFRONT_KERNELS = ["sgd", "sgd_r128", "bpr", "tile", "step_u",
                     "step_u_su1024", "dense", "dense_int8", "dense_int8_r128",
                     "time", "time_r128", "epoch", "dense_frozen",
                     "dense_none", "dense_frozen_int8_r128", "sgd_r32",
                     "time_r32", "dense_r32", "dense_int8_r32",
                     "dense_frozen_r32", "dense_none_r32",
                     "dense_frozen_int8_r32", "tile_r128", "step_u_r128",
                     "epoch_r128", "bpr_r32", "bpr_r128",
                     "sgd_bf16", "sgd_bf16_r32", "sgd_bf16_r128", "tile_bf16",
                     "tile_bf16_r128", "step_u_bf16", "step_u_bf16_r32",
                     "epoch_bf16", "dense_echo", "dense_none_echo",
                     "dense_int8_echo_r128", "dense_echo_r32",
                     "dense_none_int8_echo_r32", "dense_frozen_int8",
                     "dense_none_int8", "dense_none_int8_r128",
                     "dense_none_int8_r32"] + [
    f"{k}_r{rank}" for rank in (16, 8, 4, 2, 1)
    for k in ("sgd", "tile", "step_u", "epoch", "bpr", "sgd_bf16",
              "tile_bf16", "step_u_bf16", "epoch_bf16")
    if rank > 1 or not k.startswith("sgd")] + [
    "time_r16", "time_r8"]


@pytest.mark.parametrize("kernel", WAVEFRONT_KERNELS)
def test_wavefront_kernels_give_the_one_block_bits(cuda, kernel):
    """A whole sweep (dense group) at 1, 2 and 7 blocks and at the card's
    count: tables and scalar bitwise equal; twenty repeats at the card's
    count bitwise equal; within 1e-4 of the plain version."""
    run, plain, state, deps = _wavefront_case(kernel, cuda)
    assert deps.runs.shape[0] >= 8 and deps.critical < deps.n_tiles
    outs = []
    for blocks in (1, 2, 7, None) + (None,) * 19:
        tabs = [x.clone() for x in state]
        s = run(tabs, blocks)
        torch.cuda.synchronize()
        outs.append((float(s), tabs))
    s1, t1 = outs[0]
    for s, tabs in outs[1:]:
        assert s == s1 and all(torch.equal(a, b) for a, b in zip(tabs, t1))
    tabs = [x.clone() for x in state]
    sp = float(plain(tabs))
    for a, b in zip(t1, tabs):
        assert float((a - b).abs().max()) <= 1e-4
    assert abs(s1 - sp) <= 1e-4 * max(1.0, sp)
    assert not torch.equal(t1[0], state[0]) and not torch.equal(t1[1],
                                                                 state[1])


@pytest.mark.parametrize("kernel", WAVEFRONT_KERNELS)
def test_wavefront_kernels_without_a_table_walk_in_plan_order(cuda, kernel):
    """No dependency table: the stream in plan order (the sweeps on one
    block, the dense strata one after another), to the same bits; a table
    for another stream and a grid of no blocks are refused."""
    from mfx_torch.kernels.sgd_sweep import wavefront_launch

    run, _, state, deps = _wavefront_case(kernel, cuda)
    outs = []
    for table in (True, False):
        tabs = [x.clone() for x in state]
        outs.append((float(run(tabs, None, table)), tabs))
    (sa_, ta), (sb_, tb) = outs
    assert sa_ == sb_ and all(torch.equal(a, b) for a, b in zip(ta, tb))
    wrong = dataclasses.replace(deps, n_tiles=deps.n_tiles + TPG)
    with pytest.raises(ValueError, match="deps"):
        wavefront_launch("sgd_sweep", None, wrong, deps.n_tiles, T, cuda, 1)
    with pytest.raises(ValueError, match="blocks"):
        run([x.clone() for x in state], 0)


@pytest.mark.parametrize("partitioner,use_bias,trust", [
    ("conflict_free", False, 0.0), ("fixed", True, 4.0)])
def test_minibatch_graph_replay_is_the_eager_loop(cuda, partitioner,
                                                  use_bias, trust):
    """The minibatch step replayed as a CUDA graph (the trainer's form on
    the card) gives the op-by-op loop's tables and SSE bit for bit, twice
    over, with no host sync inside the epoch (filler batches of sentinel
    pads included); the CPU's loop agrees within 1e-5."""
    from mfx_torch.models.mf import MFModel
    from mfx_torch.solvers import sgd

    coo = synthetic.make_synthetic(400, 300, 8_000, rank=4, seed=3,
                                   user_zipf_s=0.9)
    cfg = SGDConfig(lr=0.03, reg=0.02, batch_size=128,
                    partitioner=partitioner, dup_trust=trust)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = init_model(g, 400, 300, 16, global_mean=coo.global_mean,
                       device=cuda)
    plan = sgd.plan_epoch(coo, cfg, 0, 0, device=cuda)
    me, se = sgd.make_epoch_fn(cfg, use_bias, graph=False)(model, plan,
                                                            cfg.lr)
    graph = sgd.make_epoch_fn(cfg, use_bias)
    mg, sg = graph(model, plan, cfg.lr)
    torch.cuda.set_sync_debug_mode("error")
    try:
        mg2, sg2 = graph(model, plan, cfg.lr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    keys = ("P", "Q", "bu", "bi")
    for other in (mg, mg2):
        assert all(torch.equal(getattr(me, k), getattr(other, k))
                   for k in keys)
    assert float(se) == float(sg) == float(sg2)
    cpu = MFModel(*(getattr(model, k).cpu() for k in keys), model.mu)
    mc, sc = sgd.make_epoch_fn(cfg, use_bias)(
        cpu, sgd.plan_epoch(coo, cfg, 0, 0, device="cpu"), cfg.lr)
    for k in keys:
        torch.testing.assert_close(getattr(me, k).cpu(), getattr(mc, k),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("width", [16, 0])
def test_bf16_row_add_on_the_card_is_the_cpus(cuda, width, shared):
    """bf16 tables (2-D, and 1-D biases): duplicate rows add one bf16
    delta after another in slot order on the card as on the CPU, bit for
    bit, and twice alike; with the rows' order sorted by the wrapper or
    handed in (``bf16_order``, as the minibatch step shares it)."""
    from mfx_torch.kernels.packing import bf16_order, bf16_row_add, row_add

    g = torch.Generator().manual_seed(width)
    shape = (50, width) if width else (50,)
    table = torch.randn(shape, generator=g).bfloat16()
    rows = torch.randint(0, 6, (4096,), generator=g)
    rows[::7] = torch.randint(0, 50, (586,), generator=g)
    delta = (torch.randn((4096,) + shape[1:], generator=g) * 0.01).bfloat16()

    want = table.clone()
    row_add(want, rows, delta)
    assert bf16_order(want, rows) is None
    for _ in range(2):
        got = table.to(cuda)
        before = bf16_row_add.launches
        rc = rows.to(cuda)
        row_add(got, rc, delta.to(cuda),
                bf16_order(got, rc) if shared else None)
        assert bf16_row_add.launches == before + 1
        assert torch.equal(got.cpu().view(torch.int16),
                           want.view(torch.int16))


@pytest.mark.parametrize("partitioner,trust", [("conflict_free", 0.0),
                                               ("fixed", 16.0)])
def test_bf16_minibatch_on_the_card(cuda, partitioner, trust):
    """bf16 tables: the graph-replayed epoch is the eager loop's bit for
    bit and repeatable, its replays' scatter-adds counted; after 2 epochs the card's held-out RMSE is within
    1e-3 of the CPU's (the dot's f32 sum order may differ on the card and
    flip a bf16 rounding)."""
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import packing
    from mfx_torch.models.mf import MFModel
    from mfx_torch.solvers import sgd

    coo = synthetic.make_synthetic(400, 300, 8_000, rank=4, seed=3,
                                   user_zipf_s=0.9)
    train, test = train_test_split(coo, test_frac=0.1, seed=0)
    cfg = SGDConfig(lr=0.03, reg=0.02, batch_size=128, epochs=2,
                    partitioner=partitioner, dup_trust=trust)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = init_model(g, 400, 300, 16, global_mean=train.global_mean,
                       device=cuda, dtype="bfloat16")
    plan = sgd.plan_epoch(train, cfg, 0, 0, device=cuda)
    me, se = sgd.make_epoch_fn(cfg, True, graph=False)(model, plan, cfg.lr)
    graph = sgd.make_epoch_fn(cfg, True)
    replayed = packing.GRAPH_LAUNCHES["replayed"]
    runs = [graph(model, plan, cfg.lr) for _ in range(2)]
    # four scatter-adds a step (P, Q, bu, bi), one replay a batch
    assert (packing.GRAPH_LAUNCHES["replayed"] - replayed
            == 2 * 4 * plan.num_batches)
    keys = ("P", "Q", "bu", "bi")
    for mg, sg in runs:
        assert mg.P.dtype == torch.bfloat16 and float(sg) == float(se)
        assert all(torch.equal(getattr(me, k), getattr(mg, k)) for k in keys)
    card = list(sgd.train_epochs(model, train, cfg, True, seed=0))
    cpu = MFModel(*(getattr(model, k).cpu() for k in keys), model.mu)
    host = list(sgd.train_epochs(cpu, train, cfg, True, seed=0))
    a = rmse_mae(card[-1][1], test)[0]
    b = rmse_mae(host[-1][1], test)[0]
    assert abs(a - b) <= 1e-3 and card[-1][2] < card[0][2]


# the snapshot-minibatch BPR paths through the driver; billion_bpr_sharded's
# batch of 131,072 makes synthetic-small-implicit's 7,920 positives one
# batch an epoch, which the captured loop's warm-up must fit
SNAPSHOT_PATHS = {
    "single": ["parallel.mode=single"],
    "dp": ["parallel.mode=dp"],
    "jnp_ring": ["bpr.kernel=jnp"],
    "single_bf16": ["parallel.mode=single", "model.dtype=bfloat16"],
}


@pytest.mark.parametrize("path", sorted(SNAPSHOT_PATHS))
def test_snapshot_bpr_paths_train_one_batch_epochs_on_the_card(cuda,
                                                               tmp_path,
                                                               path):
    """Each snapshot-minibatch BPR path trains 2 one-batch epochs on the
    card through the driver: the loss falls, the tables stay finite in
    their dtype on the card."""
    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("billion_bpr_sharded"), [
        "parallel.model_axis=1", "data.dataset=synthetic-small-implicit",
        f"data.root={tmp_path}", "bpr.ublock=128", "bpr.iblock=128",
        "bpr.tile=64", "bpr.epochs=2"] + SNAPSHOT_PATHS[path])
    assert cfg.bpr.batch_size >= 8_000
    res = train(cfg, device=cuda)
    assert res.epochs_run == 2
    assert res.history[1]["train_metric"] < res.history[0]["train_metric"]
    dtype = torch.bfloat16 if "bf16" in path else torch.float32
    for t in (res.model.P, res.model.Q):
        assert t.is_cuda and t.dtype == dtype
        assert bool(torch.isfinite(t.float()).all())
    assert 0.0 <= res.test_auc <= 1.0


@pytest.mark.parametrize("batch_size", [16_384, 1_024])
def test_snapshot_bpr_on_the_card_is_the_cpus(cuda, batch_size):
    """``train_epochs_bpr`` with host sampling (the same triples on either
    device), 2 epochs of one batch (16,384) or eight (1,024): the card's
    graph-replayed loop twice bit for bit, and within 1e-5 of the CPU's
    eager loop (tables) and 1e-6 (losses). With device sampling the
    second epoch, sampler and batch loop, makes no host sync."""
    from mfx_torch.config import BPRConfig
    from mfx_torch.solvers import bpr as mb

    coo = synthetic.make_implicit_synthetic(256, 128, 8_000, rank=8, seed=9)
    cfg = BPRConfig(lr=0.05, reg=0.002, epochs=2, batch_size=batch_size,
                    sample_device="host")
    g = torch.Generator().manual_seed(0)
    model = init_model(g, 256, 128, 16, device="cpu")
    card = [list(mb.train_epochs_bpr(model, coo, cfg, device=cuda))
            for _ in range(2)]
    cpu = list(mb.train_epochs_bpr(model, coo, cfg, device="cpu"))
    for (_, m1, l1), (_, m2, l2), (_, mc, lc) in zip(*card, cpu):
        assert l1 == l2 and abs(l1 - lc) <= 1e-6
        for k in ("P", "Q"):
            assert getattr(m1, k).is_cuda
            assert torch.equal(getattr(m1, k), getattr(m2, k))
            torch.testing.assert_close(getattr(m1, k).cpu(), getattr(mc, k),
                                       rtol=0, atol=1e-5)
    tr = mb.SnapshotTrainer(model, coo, dataclasses.replace(
        cfg, sample_device="device"), device=cuda)
    losses = [float(tr.epoch(0))]
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = tr.epoch(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    losses.append(float(loss))
    assert losses[1] < losses[0]


def test_mmr_and_full_ranks_on_the_card_are_the_cpus(cuda):
    """rerank_mmr and the full protocol's ranks on the card against the
    same calls on CPU copies: items equal; ranks equal but where a
    competitor's score lies within 1e-5 of the positive's."""
    from mfx_torch.convert import model_from_numpy
    from mfx_torch.eval.ranking import full_ranks
    from mfx_torch.serve import TopKRecommender, rerank_mmr

    rng = np.random.default_rng(7)
    arrays = {"P": rng.normal(0, 0.4, (300, 32)),
              "Q": rng.normal(0, 0.4, (5000, 32)),
              "bu": rng.normal(0, 0.2, 300), "bi": rng.normal(0, 0.2, 5000),
              "mu": 3.5}
    gpu = model_from_numpy(arrays, device=cuda)
    cpu = model_from_numpy(arrays, device="cpu")
    coo = synthetic.make_synthetic(300, 5000, 20_000, seed=4)
    users = np.arange(300, dtype=np.int32)
    items, scores = TopKRecommender(cpu, train=coo).recommend(users, k=40)
    for lam in (0.0, 0.7, 1.0):
        a = rerank_mmr(gpu, items, scores, k=10, lam=lam)
        b = rerank_mmr(cpu, items, scores, k=10, lam=lam)
        assert (a[0] != b[0]).mean() <= 0.002
    u, p = coo.user[:1000], coo.item[:1000]
    seen = coo.seen_csr()
    rg = full_ranks(gpu, u, p, seen).cpu()
    rc = full_ranks(cpu, u, p, seen)
    s = cpu.P[torch.as_tensor(u).long()] @ cpu.Q.T + cpu.bi
    s_pos = s[torch.arange(1000), torch.as_tensor(p).long()]
    near = ((s - s_pos[:, None]).abs() <= 1e-5).sum(1).double()
    assert bool(((rg - rc).abs() <= near).all())


# ---- sgd_sweep_epoch and the frozen / bias-free dense forms --------------


def _biased_plain_state(dev, rank, seed, users=U):
    """``_state``'s data on canonical plain tables with non-zero biases."""
    train, _, _, u, i, r = _state(dev, users=users)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_model(g, users, I, rank, global_mean=train.global_mean,
                       device=dev)
    model.bu.copy_(torch.randn(users, device=dev, generator=g) * 0.1)
    model.bi.copy_(torch.randn(I, device=dev, generator=g) * 0.1)
    return train, model, u, i, r


def _check_outs(run, plain, state, n_tables, moved):
    """As _check4 over ``state``, whose last entries are outputs (the
    epoch form's residuals, the frozen form's bias sums): two kernel runs
    bitwise equal, within 1e-4 of the plain version; ``moved`` says which
    entries must change."""
    outs = []
    for _ in range(2):
        tabs = [x.clone() for x in state]
        outs.append((float(run(*tabs)), tabs))
    (s1, k1), (s2, k2) = outs
    assert s1 == s2 and all(torch.equal(a, b) for a, b in zip(k1, k2))
    tabs = [x.clone() for x in state]
    sp = float(plain(*tabs))
    for a, b in zip(k1, tabs):
        assert float((a - b).abs().max()) <= 1e-4
        assert bool(torch.isfinite(a).all())
    assert abs(s1 - sp) <= 1e-4 * max(1.0, sp)
    assert [not torch.equal(a, b) for a, b in zip(k1, state)][:n_tables] \
        == moved
    return k1


@pytest.mark.parametrize("rank", [32, 64, 128, 16, 8, 4, 2, 1])
def test_sgd_sweep_epoch_kernel_matches_plain(cuda, rank):
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep_epoch,
                                             sgd_sweep_epoch_plain)

    train, model, u, i, r = _biased_plain_state(cuda, rank, rank)
    skel = pdv.build_plan_skeleton(u, i, U, I, SU, SI, T, TPG, 3)
    tl = pdv.epoch_tiles_device(skel, u, i, r, 0, 0)
    P, Q, bu, bi = plain_tables(model, SU, SI, cuda)
    for sw in skel.sweeps:
        seg = slice(sw.win0 * SI, (sw.win0 + sw.nwin) * SI)
        tls = tl[sw.t0:sw.t1]
        e0 = torch.full((tls.shape[0], T), 7.0, device=cuda)
        args = (sw.sa, sw.tc, tls)
        kw = dict(su=SU, si=SI, tpg=TPG)
        before = sgd_sweep_epoch.launches
        k = _check_outs(
            lambda P_, Q_, bu_, bi_, e: sgd_sweep_epoch(
                P_, Q_[seg], bu_, bi_[seg], *args, e, LR, REG, model.mu,
                **kw, deps=sw.deps),
            lambda P_, Q_, bu_, bi_, e: sgd_sweep_epoch_plain(
                P_, Q_[seg], bu_, bi_[seg], *args, e, LR, REG, model.mu,
                **kw),
            (P, Q, bu, bi, e0), 4, [True, True, False, False])
        assert sgd_sweep_epoch.launches == before + 2
        pads = tls[:, 0] >= SU
        assert bool((k[4][pads] == 0).all()) and bool((k[4][~pads] != 7).all())


@pytest.mark.parametrize("rank,distinct", [(32, 4), (32, 512), (64, 4),
                                           (64, 1024), (128, 4), (128, 1024),
                                           (16, 4), (8, 512), (4, 1024),
                                           (2, 4), (1, 1024)])
def test_sgd_sweep_epoch_kernel_hot_rows_and_pads(cuda, rank, distinct):
    """As the tile-bias kernels' case: full tiles at blocks of 1024, long
    duplicate runs, a half-pad tile and a whole pad tile."""
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep_epoch,
                                             sgd_sweep_epoch_plain)

    g = torch.Generator(device=cuda).manual_seed(distinct)
    su = si = 1024
    nt, tile = 32, 256
    state = (torch.randn(2 * su, rank, device=cuda, generator=g) * 0.1,
             torch.randn(3 * si, rank, device=cuda, generator=g) * 0.1,
             torch.randn(2 * su, device=cuda, generator=g) * 0.1,
             torch.randn(3 * si, device=cuda, generator=g) * 0.1,
             torch.zeros(nt, tile, device=cuda))
    sa = torch.randint(0, 2, (nt // TPG,), device=cuda, generator=g,
                       dtype=torch.int32)
    tc = torch.randint(0, 3, (nt,), device=cuda, generator=g,
                       dtype=torch.int32)
    tl = torch.empty(nt, 3, tile, dtype=torch.int32, device=cuda)
    for row in (0, 1):
        tl[:, row] = torch.randint(0, distinct, (nt, tile), device=cuda,
                                   generator=g, dtype=torch.int32)
    tl[:, 2] = (torch.rand(nt, tile, device=cuda, generator=g) * 4.5
                + 0.5).view(torch.int32)
    tl[-1, 0, 56:], tl[-1, 1, 56:] = su, si
    tl[5, 0], tl[5, 1] = su, si
    kw = dict(su=su, si=si, tpg=TPG)
    k = _check_outs(
        lambda P, Q, bu, bi, e: sgd_sweep_epoch(P, Q, bu, bi, sa, tc, tl, e,
                                                LR, REG, 3.5, **kw),
        lambda P, Q, bu, bi, e: sgd_sweep_epoch_plain(
            P, Q, bu, bi, sa, tc, tl, e, LR, REG, 3.5, **kw),
        state, 4, [True, True, False, False])
    assert bool((k[4][5] == 0).all()) and bool((k[4][-1, 56:] == 0).all())


@pytest.mark.parametrize("rank", [32, 64, 128])
def test_sgd_sweep_epoch_kernel_with_zero_biases_is_the_bias_free_one(
        cuda, rank):
    """The reference's own identity (tests/unit/test_bias_epoch.py): with
    every bias 0 the epoch form's tables are the bias-free tile form's, bit
    for bit, on one block and on the card's count."""
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_epoch

    train, model, u, i, r = _biased_plain_state(cuda, rank, 5)
    model.bu.zero_()
    model.bi.zero_()
    skel = pdv.build_plan_skeleton(u, i, U, I, SU, SI, T, TPG, 3)
    tl = pdv.epoch_tiles_device(skel, u, i, r, 0, 0)
    for blocks in (1, None):
        a = plain_tables(model, SU, SI, cuda)
        b = plain_tables(model, SU, SI, cuda)
        for sw in skel.sweeps:
            seg = slice(sw.win0 * SI, (sw.win0 + sw.nwin) * SI)
            args = (sw.sa, sw.tc, tl[sw.t0:sw.t1])
            kw = dict(su=SU, si=SI, tpg=TPG, deps=sw.deps, blocks=blocks)
            e = torch.empty(sw.t1 - sw.t0, T, device=cuda)
            s1 = sgd_sweep_epoch(a[0], a[1][seg], a[2], a[3][seg], *args, e,
                                 LR, REG, model.mu, **kw)
            s2 = sgd_sweep_tile(b[0], b[1][seg], b[2], b[3][seg], *args, LR,
                                REG, model.mu, use_bias=False, **kw)
            assert float(s1) == float(s2)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


DENSE_FORMS = [("frozen", 64, "int4"), ("none", 64, "int4"),
               ("frozen", 64, "int8"), ("none", 64, "int8"),
               ("frozen", 128, "int8"), ("none", 128, "int8"),
               ("frozen", 32, "int4"), ("none", 32, "int4"),
               ("frozen", 32, "int8"), ("none", 32, "int8")]


def _dense_form_run(bias, grp, seg, mu, su, si, blocks=None, table=True,
                    kernel=True):
    """``chip_smoke.dense_form_run`` at this file's lr and reg."""
    from chip_smoke import dense_form_run

    return dense_form_run(bias, grp, seg, LR, REG, mu, su, si, kernel=kernel,
                          blocks=blocks, table=table)


@pytest.mark.parametrize("bias,rank,rfmt", DENSE_FORMS)
def test_dense_phase_bias_forms_match_plain(cuda, bias, rank, rfmt):
    train, model, u, i, r = _biased_plain_state(cuda, rank, 2)
    meta, groups, _, info = prepare_dense_full(u, i, r, U, I, SU, SI,
                                               chi_min=0.01, nwd=2,
                                               rfmt=rfmt)
    assert info["num_strata"] > 0
    P, Q, bu, bi = plain_tables(model, SU, SI, cuda)
    for (win0, nw), grp in zip(meta, groups):
        seg = slice(win0 * SI, (win0 + nw) * SI)
        nd = grp["sa"].shape[0]
        state = (P, Q, bu, bi, torch.zeros(nd, SU, device=cuda),
                 torch.zeros(nd, SI, device=cuda))
        before = dense_phase.launches
        k = _check_outs(_dense_form_run(bias, grp, seg, model.mu, SU, SI),
                        _dense_form_run(bias, grp, seg, model.mu, SU, SI,
                                        kernel=False),
                        state, 6, [True, True, False, False,
                                   bias == "frozen", bias == "frozen"])
        assert dense_phase.launches == before + 2
        if bias == "frozen":  # every rating's residual is in both sums
            torch.testing.assert_close(k[4].sum(), k[5].sum(), rtol=1e-5,
                                       atol=1e-3)


def _bias_mode_cfg(mode, dense):
    bias_mode = "tile" if mode == "none" else mode
    return dataclasses.replace(CFG, bias_mode=bias_mode,
                               dense_chi=0.01 if dense else 0.0)


@pytest.mark.parametrize("mode,dense", [("epoch", True), ("epoch", False),
                                        ("tile", True), ("none", True)])
def test_bias_mode_trainer_through_the_kernels_is_repeatable(cuda, mode,
                                                             dense):
    """Two runs of the trainer in each bias mode bitwise equal, through the
    kernels of the mode; one epoch on the CPU from the card's plan bits
    within 1e-5 (train RMSE) and 1e-4 (tables); and an epoch-mode run
    resumed at epoch 1 repeats the unbroken one bit for bit."""
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_epoch

    train, model, *_ = _biased_plain_state(cuda, RANK, 0)
    use_bias = mode != "none"
    cfg = _bias_mode_cfg(mode, dense)
    sparse = sgd_sweep_epoch if mode == "epoch" else sgd_sweep_tile
    runs = []
    for _ in range(2):
        s0, d0, l0 = sparse.launches, dense_phase.launches, sgd_sweep.launches
        runs.append([(float(tr), m) for _, m, tr in train_epochs_blocked(
            model, train, cfg, use_bias, seed=0, device=cuda)])
        assert sparse.launches > s0 and sgd_sweep.launches == l0
        assert (dense_phase.launches > d0) == dense
    for (ta, ma), (tb, mb) in zip(*runs):
        assert ta == tb
        assert all(torch.equal(getattr(ma, k), getattr(mb, k))
                   for k in ("P", "Q", "bu", "bi"))
    assert runs[0][1][0] < runs[0][0][0]
    if mode == "epoch":
        m1 = runs[0][0][1]
        (_, again, _), = train_epochs_blocked(m1, train, cfg, use_bias,
                                              seed=0, device=cuda,
                                              start_epoch=1)
        assert all(torch.equal(getattr(again, k), getattr(runs[0][1][1], k))
                   for k in ("P", "Q", "bu", "bi"))
    cpu = init_model(torch.Generator().manual_seed(0), U, I, RANK)
    for k in ("P", "Q", "bu", "bi"):
        getattr(cpu, k).copy_(getattr(model, k).cpu())
    cpu.mu = model.mu
    (_, mc, trc), = train_epochs_blocked(
        cpu, train, dataclasses.replace(cfg, epochs=1), use_bias, seed=0,
        device="cpu",
        plan_rand=lambda e, n: pdv.epoch_rand(n, 0, e, cuda).cpu())
    assert abs(float(trc) - runs[0][0][0]) <= 1e-5
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_allclose(getattr(mc, k).numpy(),
                                   getattr(runs[0][0][1], k).cpu().numpy(),
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("mode", ["tile", "epoch", "step_u", "none"])
def test_rank128_trainer_through_the_kernels_is_repeatable(cuda, mode):
    """Rank 128 with the dense phase on (int8 codes) in each bias form but
    lane: two runs bitwise equal, through the mode's rank-128 sweep form
    and its dense form, and never the lane sweep."""
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_epoch

    train, model, *_ = _biased_plain_state(cuda, 128, 0)
    use_bias = mode != "none"
    cfg = dataclasses.replace(_bias_mode_cfg(
        "tile" if mode == "step_u" else mode, True),
        step_user_batch=mode == "step_u")
    sparse = {"epoch": sgd_sweep_epoch,
              "step_u": sgd_sweep_step_u}.get(mode, sgd_sweep_tile)
    form = "frozen" if use_bias else "none"
    runs = []
    for _ in range(2):
        s0, l0 = sparse.launches, sgd_sweep.launches
        d0 = dense_phase.form_launches[form]
        runs.append([(float(tr), m) for _, m, tr in train_epochs_blocked(
            model, train, cfg, use_bias, seed=0, device=cuda)])
        assert sparse.launches > s0 and sgd_sweep.launches == l0
        assert dense_phase.form_launches[form] > d0
    for (ta, ma), (tb, mb) in zip(*runs):
        assert ta == tb
        assert all(torch.equal(getattr(ma, k), getattr(mb, k))
                   for k in ("P", "Q", "bu", "bi"))
    assert runs[0][1][0] < runs[0][0][0]


# ---- the bf16 sweeps and the dense echo passes ---------------------------

BF16_BODIES = ["lane", "tile", "none", "step_u", "epoch"]


def _hot_tiles(dev, seed, distinct, su=1024, nt=32, tile=256):
    """Random full tiles at blocks of 1024 and T = 256, every slot one of
    ``distinct`` rows a side, the last tile half pad (the hot-row case)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sa = torch.randint(0, 2, (nt // TPG,), device=dev, generator=g,
                       dtype=torch.int32)
    tc = torch.randint(0, 3, (nt,), device=dev, generator=g,
                       dtype=torch.int32)
    tl = torch.empty(nt, 3, tile, dtype=torch.int32, device=dev)
    for row in (0, 1):
        tl[:, row] = torch.randint(0, distinct, (nt, tile), device=dev,
                                   generator=g, dtype=torch.int32)
    tl[:, 2] = (torch.rand(nt, tile, device=dev, generator=g) * 4.5
                + 0.5).view(torch.int32)
    tl[-1, 0, tile // 2:] = su
    tl[-1, 1, tile // 2:] = su
    return g, sa, tc, tl


@pytest.mark.parametrize("distinct", [4, 1024])
@pytest.mark.parametrize("body,rank", [
    (body, rank) for rank in (32, 64, 128, 16, 8, 4, 2, 1)
    for body in BF16_BODIES if body != "lane" or rank > 1])
def test_bf16_sweep_kernels_hot_rows_and_pads(cuda, body, rank, distinct):
    """Each sweep's bf16 form against its plain version (``bf16=True``) on
    hot rows and pads: within 1e-4, bitwise repeatable, and another
    computation than the f32 form on the same inputs. step_u pools a
    group's 4 tiles, up to 256 deltas of one row at 4 distinct rows: at
    the f32 lr that step diverges in f32 as well, so it takes lr / 8."""
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep_epoch,
                                             sgd_sweep_epoch_plain)

    g, sa, tc, tl = _hot_tiles(cuda, rank + distinct, distinct)
    su = si = 1024
    state = tuple(x * 0.1 for x in (
        torch.randn(2 * su, rank, device=cuda, generator=g),
        torch.randn(3 * si, rank, device=cuda, generator=g),
        torch.randn(2 * su, device=cuda, generator=g),
        torch.randn(3 * si, device=cuda, generator=g)))
    args = (sa, tc, tl, LR / 8 if body == "step_u" else LR, REG, 3.5)
    kw = dict(su=su, si=si, tpg=TPG)
    if body == "lane":
        def run(P, Q, bu, bi, fn=sgd_sweep, bf16=True):
            return fn(P, Q, *args, bf16=bf16, **kw)
        plain = lambda *t: run(*t, fn=sgd_sweep_plain)  # noqa: E731
    elif body == "epoch":
        def run(P, Q, bu, bi, fn=sgd_sweep_epoch, bf16=True):
            e = torch.zeros(tl.shape[0], tl.shape[2], device=cuda)
            return fn(P, Q, bu, bi, *args[:3], e, *args[3:], bf16=bf16, **kw)
        plain = lambda *t: run(*t, fn=sgd_sweep_epoch_plain)  # noqa: E731
    else:
        kernel, plain_fn = TILE_SWEEPS["step_u" if body == "step_u" else
                                       "tile"]

        def run(P, Q, bu, bi, fn=kernel, bf16=True):
            return fn(P, Q, bu, bi, *args, use_bias=body != "none",
                      bf16=bf16, **kw)
        plain = lambda *t: run(*t, fn=plain_fn)  # noqa: E731
    biased = body in ("tile", "step_u")
    _check4(run, plain, state, use_bias=biased)
    a = [x.clone() for x in state]
    b = [x.clone() for x in state]
    run(*a)
    run(*b, bf16=False)
    assert not torch.equal(a[0], b[0])


@pytest.mark.parametrize("body,rank", [
    (body, rank) for rank in (16, 8, 4, 2, 1)
    for body in ("sgd", "tile", "step_u", "epoch")
    if body != "sgd" or rank > 1])
def test_bf16_sweep_kernels_below_rank_32_are_the_plain_bits(cuda, body,
                                                             rank):
    """The bf16 forms at ranks 16 to 1 over a whole small sweep: on 1
    block and on the card's count the tables are bit for bit the plain
    version's (it takes every sum in the kernel's order: a dot padded with
    zero lanes to 32), and the f32 form from the same state lands off
    them."""
    run, plain, state, _ = _wavefront_case(f"{body}_bf16_r{rank}", cuda)
    f32, _, _, _ = _wavefront_case(f"{body}_r{rank}", cuda)
    want = [x.clone() for x in state]
    plain(want)
    for blocks in (1, None):
        tabs = [x.clone() for x in state]
        run(tabs, blocks)
        assert all(torch.equal(a, b) for a, b in zip(tabs, want)), blocks
    tabs = [x.clone() for x in state]
    f32(tabs, None)
    assert not torch.equal(tabs[0], want[0])


DENSE_ECHO = [("lane", 64, "int4"), ("none", 64, "int4"),
              ("lane", 64, "int8"), ("lane", 128, "int8"),
              ("none", 128, "int8"), ("lane", 32, "int4"),
              ("none", 32, "int8")]


@pytest.mark.parametrize("bias,rank,rfmt", DENSE_ECHO)
def test_dense_echo_kernel_matches_plain(cuda, bias, rank, rfmt):
    """echo=2 on the card against ``dense_phase_plain(echo=2)``: within
    1e-4, bitwise repeatable, on the slots' table and without one; the
    frozen form refuses echo > 1 on the card too."""
    train, _, model, u, i, r = _state(cuda, rank=rank)
    meta, groups, _, _ = prepare_dense_full(u, i, r, U, I, SU, SI,
                                            chi_min=0.01, nwd=2, rfmt=rfmt)
    tabs = (lane_tables(model, SU, SI, cuda) if bias == "lane"
            else plain_tables(model, SU, SI, cuda)[:2])
    for (win0, nw), grp in zip(meta, groups):
        seg = slice(win0 * SI, (win0 + nw) * SI)
        kw = dict(su=SU, si=SI, bias=bias, echo=2)
        deps = grp["deps"].repeat(2)
        before = dense_phase.echo_launches[bias]
        for table in (deps, None):
            _check(lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp, LR, REG,
                                              model.mu, deps=table, **kw),
                   lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp, LR,
                                                    REG, model.mu, **kw),
                   *tabs)
        assert dense_phase.echo_launches[bias] == before + 4
    with pytest.raises(NotImplementedError, match="echo"):
        P, Q, bu, bi = plain_tables(model, SU, SI, cuda)
        dense_phase(P, Q[seg], grp, LR, REG, model.mu, su=SU, si=SI,
                    bias="frozen", bu=bu, bi=bi[seg], echo=2)


VARIANTS = {"echo": dict(dense_echo=2), "spg": dict(dense_spg=2),
            "bf16": dict(mxu="bf16"),
            "head": dict(dense_span="head", dense_chi=0.0025),
            "bf16_step_u": dict(mxu="bf16", bias_mode="tile",
                                step_user_batch=True)}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_trainer_through_the_kernels_is_repeatable(cuda, name):
    """The trainer with each setting the port took last: two runs bitwise
    equal through the kernels, the spg run bit for bit the spg=1 run, and
    one epoch on the CPU from the card's plan bits within 1e-5 (train
    RMSE) and 1e-4 (tables), 1e-4 and 2e-3 in bf16 (a residual an ulp off
    can move a delta across a bf16 rounding boundary)."""
    train, _, model, *_ = _state(cuda)
    cfg = dataclasses.replace(CFG, **VARIANTS[name])
    use_bias = True
    runs = []
    for _ in range(2):
        e0 = dense_phase.echo_launches["lane"]
        b0 = sgd_sweep.bf16_launches + sgd_sweep_step_u.bf16_launches
        runs.append([(float(tr), m) for _, m, tr in train_epochs_blocked(
            model, train, cfg, use_bias, seed=0, device=cuda)])
        assert (dense_phase.echo_launches["lane"] > e0) == (name == "echo")
        assert (sgd_sweep.bf16_launches + sgd_sweep_step_u.bf16_launches
                > b0) == name.startswith("bf16")
    keys = ("P", "Q", "bu", "bi")
    for (ta, ma), (tb, mb) in zip(*runs):
        assert ta == tb
        assert all(torch.equal(getattr(ma, k), getattr(mb, k)) for k in keys)
    assert runs[0][1][0] < runs[0][0][0]
    if name == "spg":
        once = [(float(tr), m) for _, m, tr in train_epochs_blocked(
            model, train, CFG, use_bias, seed=0, device=cuda)]
        for (ta, ma), (tb, mb) in zip(runs[0], once):
            assert ta == tb
            assert all(torch.equal(getattr(ma, k), getattr(mb, k))
                       for k in keys)
    cpu = init_model(torch.Generator().manual_seed(0), U, I, RANK)
    for k in keys:
        getattr(cpu, k).copy_(getattr(model, k).cpu())
    cpu.mu = model.mu
    (_, mc, trc), = train_epochs_blocked(
        cpu, train, dataclasses.replace(cfg, epochs=1), use_bias, seed=0,
        device="cpu",
        plan_rand=lambda e, n: pdv.epoch_rand(n, 0, e, cuda).cpu())
    bf16 = cfg.mxu == "bf16"
    assert abs(float(trc) - runs[0][0][0]) <= (1e-4 if bf16 else 1e-5)
    for k in keys:
        np.testing.assert_allclose(getattr(mc, k).numpy(),
                                   getattr(runs[0][0][1], k).cpu().numpy(),
                                   atol=2e-3 if bf16 else 1e-4, err_msg=k)
