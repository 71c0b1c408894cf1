"""The port's CUDA kernels against their plain PyTorch versions on the card
(small shapes), bitwise run-to-run repeatability, and a short training run
through both kernels. Marked ``gpu``; they skip where there is no CUDA
device. Run on the card with
``python -m pytest --noconftest tests/test_torch_gpu.py`` (the conftest
imports JAX, which the port and its card do not need)."""

import dataclasses

import numpy as np
import pytest
import torch

from mfx.config import SGDConfig
from mfx.data import synthetic, train_test_split
from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels.dense_phase import dense_phase, dense_phase_plain
from mfx_torch.kernels.packing import lane_tables
from mfx_torch.kernels.sgd_sweep import sgd_sweep, sgd_sweep_plain
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


def _state(dev, n=120_000):
    coo = synthetic.make_synthetic(U, I, n, rank=4, noise=0.3, seed=9,
                                   star_step=0.5, user_zipf_s=0.6)
    train, test = train_test_split(coo, test_frac=0.1, seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    model = init_model(g, U, I, RANK, global_mean=train.global_mean,
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


@pytest.mark.parametrize("tile", [T, 200])
def test_sgd_sweep_kernel_matches_plain(cuda, tile):
    train, _, model, u, i, r = _state(cuda)
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


@pytest.mark.parametrize("distinct", [4, 64, 1024])
def test_sgd_sweep_kernel_hot_rows_and_pads(cuda, distinct):
    """Random full tiles at the preset's blocks (1024) and tile (256) where
    every slot repeats one of ``distinct`` rows per side, the last tile
    half pad: long duplicate runs exercise the kernel's segment sums."""
    g = torch.Generator(device=cuda).manual_seed(distinct)
    su = si = 1024
    nt, tile = 32, 256
    P = torch.randn(2 * su, RANK, device=cuda, generator=g) * 0.1
    Q = torch.randn(3 * si, RANK, device=cuda, generator=g) * 0.1
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


def test_dense_phase_kernel_matches_plain(cuda):
    train, _, model, u, i, r = _state(cuda)
    meta, groups, _, info = prepare_dense_full(u, i, r, U, I, SU, SI,
                                               chi_min=0.01, nwd=2)
    assert info["num_strata"] > 0
    P, Q = lane_tables(model, SU, SI, cuda)
    for (win0, nw), grp in zip(meta, groups):
        seg = slice(win0 * SI, (win0 + nw) * SI)
        before = dense_phase.launches
        _check(lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp, LR, REG, model.mu,
                                          su=SU, si=SI),
               lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp, LR, REG,
                                                model.mu, su=SU, si=SI),
               P, Q)
        assert dense_phase.launches == before + 2


def test_trainer_through_both_kernels_is_repeatable(cuda):
    train, test, model, *_ = _state(cuda)
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
    cpu_model = init_model(torch.Generator().manual_seed(0), U, I, RANK)
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
