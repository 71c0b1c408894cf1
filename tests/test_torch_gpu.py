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


@pytest.mark.parametrize("dtype,depth,tile,B,rank", [
    ("f32", 1, 128, 20, 8), ("f32", 2, 1024, 256, 64),
    ("f32", 8, 1024, 40, 64), ("f32", 32, 2048, 17, 127),
    ("f32", 3, 256, 16, 31), ("bf16", 2, 1024, 33, 64),
    ("int8", 2, 1024, 48, 64), ("int8", 8, 128, 5, 16),
])
def test_tile_topk_kernel_matches_plain(cuda, dtype, depth, tile, B, rank):
    from mfx_torch.kernels.serve_topk import tile_topk, tile_topk_plain

    P_aug, Q_aug, sb = _serve_tables(cuda, B, 5000, rank, tile, dtype)
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
