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


@pytest.mark.parametrize("rank", [RANK, 128])
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


@pytest.mark.parametrize("rank", [RANK, 128])
@pytest.mark.parametrize("distinct", [4, 64, 1024])
def test_sgd_sweep_kernel_hot_rows_and_pads(cuda, distinct, rank):
    """Random full tiles at blocks of 1024 and T = 256 where every slot
    repeats one of ``distinct`` rows per side, the last tile half pad:
    long duplicate runs exercise the kernel's segment sums (at rank 128
    in both halves of the row)."""
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


@pytest.mark.parametrize("rank,rfmt", [(RANK, "int4"), (RANK, "int8"),
                                       (128, "int8")])
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


@pytest.mark.parametrize("rank", [RANK, 128])
def test_trainer_through_both_kernels_is_repeatable(cuda, rank):
    """Two runs of the trainer (int4 codes at rank 64, int8 at rank 128)
    bitwise equal, and one epoch on the CPU from the card's plan bits
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
                                         (128, 70)])
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


@pytest.mark.parametrize("rank,n_bins", [(RANK, 30), (128, 30), (128, 70)])
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


@pytest.mark.parametrize("rank", [RANK, 128])
def test_blocked_timesvd_through_the_kernel_is_repeatable(cuda, rank):
    """Two runs of ``train_epochs_timesvd_blocked`` (2 epochs) bitwise
    equal through the time form, never its plain version; the train RMSE
    falls."""
    from mfx_torch.config import TimeSVDConfig
    from mfx_torch.solvers.timesvd_blocked import (
        train_epochs_timesvd_blocked)

    train, tsm, *_ = _time_case(cuda, rank, 30, SU, T, 3)
    cfg = TimeSVDConfig(lr=0.01, reg=0.02, epochs=2, n_bins=30,
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
@pytest.mark.parametrize("rank", [32, 64])
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
    (64, 8, 1024)])
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


def _bpr_state(dev, tile=64):
    from mfx_torch.parallel import bpr_sharded as ring

    coo = synthetic.make_implicit_synthetic(700, 600, 30_000, rank=4, seed=5)
    g = torch.Generator(device=dev).manual_seed(0)
    model = init_model(g, 700, 600, RANK)
    cfg = dataclasses.replace(BPR, tile=tile)
    st = ring.ring_state(model, coo, cfg, seed=0, device=dev)
    return coo, model, cfg, st, ring.ring_epoch_tiles(st, cfg, 0, 0)


@pytest.mark.parametrize("tile", [64, 256])
def test_bpr_sweep_kernel_matches_plain(cuda, tile):
    from mfx_torch.kernels.bpr_sweep import bpr_sweep, bpr_sweep_plain

    _, _, cfg, st, tls = _bpr_state(cuda, tile)
    for (win0, nw, sa, tc, _), slab in zip(st.segments(), tls):
        seg = slice(win0 * cfg.iblock, (win0 + nw) * cfg.iblock)
        args = (sa, tc, slab[0, 0], cfg.lr, cfg.reg)
        kw = dict(su=cfg.ublock, si=cfg.iblock, tpg=TPG)
        before = bpr_sweep.launches
        _check(lambda Pt, Qt: bpr_sweep(Pt, Qt[seg], *args, **kw),
               lambda Pt, Qt: bpr_sweep_plain(Pt, Qt[seg], *args, **kw),
               st.P, st.Q)
        assert bpr_sweep.launches == before + 2


@pytest.mark.parametrize("distinct", [4, 64, 512])
def test_bpr_sweep_kernel_hot_rows_and_pads(cuda, distinct):
    """Random full tiles at the preset's blocks (512) and tile (256) where
    every slot repeats one of ``distinct`` rows per side (so positives and
    negatives share rows, and the negatives' add reads the positives'),
    the first tile all pad and the last half pad."""
    from mfx_torch.kernels.bpr_sweep import bpr_sweep, bpr_sweep_plain

    g = torch.Generator(device=cuda).manual_seed(distinct)
    su = si = 512
    nt, tile = 32, 256
    P = torch.randn(2 * su, RANK, device=cuda, generator=g) * 0.1
    Q = torch.randn(3 * si, RANK, device=cuda, generator=g) * 0.1
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
    if kernel in ("sgd", "sgd_r128", "tile", "step_u", "step_u_su1024"):
        users = 9000 if kernel == "step_u_su1024" else U
        train, _, model, u, i, r = _state(
            dev, users=users, rank=128 if kernel == "sgd_r128" else RANK)
        su = 1024 if kernel == "step_u_su1024" else 64
        si = 64
        skel = pdv.build_plan_skeleton(u, i, users, I, su, si, T, TPG, 8)
        tl = pdv.epoch_tiles_device(skel, u, i, r, 0, 0)
        sw = skel.sweeps[0]
        seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
        args = (sw.sa, sw.tc, tl[sw.t0:sw.t1], LR, REG, model.mu)
        kw = dict(su=su, si=si, tpg=TPG)
        if kernel in ("sgd", "sgd_r128"):
            return (lambda tabs, blocks, table=True: sgd_sweep(
                        tabs[0], tabs[1][seg], *args, **kw, blocks=blocks,
                        deps=sw.deps if table else None),
                    lambda tabs: sgd_sweep_plain(tabs[0], tabs[1][seg], *args,
                                                 **kw),
                    lane_tables(model, su, si, dev), sw.deps)
        model.bu.copy_(torch.randn(users, device=dev) * 0.1)
        model.bi.copy_(torch.randn(I, device=dev) * 0.1)
        wrapper, plain = sgd_sweep_tile, sgd_sweep_tile_plain
        if kernel != "tile":
            wrapper, plain = sgd_sweep_step_u, sgd_sweep_step_u_plain
            floats = _build.load_library().mfx_sgd_sweep_step_u_pool_floats(
                T, RANK, su)  # the pools' device memory a block
            assert floats == (su * (RANK + 1) if su == 1024 else 0)
        return (lambda tabs, blocks, table=True: wrapper(
                    tabs[0], tabs[1][seg], tabs[2], tabs[3][seg], *args,
                    **kw, blocks=blocks, deps=sw.deps if table else None),
                lambda tabs: plain(
                    tabs[0], tabs[1][seg], tabs[2], tabs[3][seg], *args,
                    su=su, si=si, tpg=TPG),
                plain_tables(model, su, si, dev), sw.deps)
    if kernel in ("time", "time_r128"):
        rank = 128 if kernel == "time_r128" else RANK
        _, tsm, tl, sweeps, P, Q = _time_case(dev, rank, 30, 64, T, 8)
        sw = sweeps[0]
        seg = slice(sw.win0 * 64, (sw.win0 + sw.nwin) * 64)
        args = (sw.sa, sw.tc, tl[sw.t0:sw.t1], LR, REG, tsm.mu)
        kw = dict(su=64, si=64, tpg=TPG, n_bins=30)
        return (lambda tabs, blocks, table=True: sgd_sweep_time(
                    tabs[0], tabs[1][seg], *args, **kw, blocks=blocks,
                    deps=sw.deps if table else None),
                lambda tabs: sgd_sweep_plain(tabs[0], tabs[1][seg], *args,
                                             **kw),
                (P, Q), sw.deps)
    if kernel.startswith("dense"):
        rfmt = "int8" if "int8" in kernel else "int4"
        train, _, model, u, i, r = _state(
            dev, rank=128 if kernel.endswith("r128") else RANK)
        su = si = 128
        (meta,), (grp,), _, _ = prepare_dense_full(u, i, r, U, I, su, si,
                                                   chi_min=0.01, nwd=11,
                                                   rfmt=rfmt)
        seg = slice(meta[0] * si, (meta[0] + meta[1]) * si)
        kw = dict(su=su, si=si)
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
                       RANK)
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
                     "time", "time_r128"]


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
