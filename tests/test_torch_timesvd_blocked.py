"""Blocked timeSVD of the port against the reference: the 5-row tile stream
of the device planner (bitwise), the plain version of the sweep kernel's
time form against ``blocked_sgd_sweep_pallas(time_mode=True)`` in
interpret mode, and two epochs of ``train_epochs_timesvd_blocked`` against
the reference's planner and epoch composed as its trainer runs them on a
TPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import TimeSVDConfig as TimeSVDConfig_j
from mfx.data import synthetic
from mfx.kernels import packing as pk
from mfx.kernels import plan_device as pdv_j
from mfx.kernels.sgd_pallas import blocked_sgd_sweep_pallas
from mfx.models import init_model
from mfx.models.mf import MFModel as JMFModel
from mfx.models.timesvd import fit_time_features as fit_j
from mfx.models.timesvd import init_timesvd as init_timesvd_j
from mfx.solvers import timesvd_blocked as tsb_j
from mfx.solvers.blocked import sweep_geometry as sweep_geometry_j
from mfx_torch.config import TimeSVDConfig
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels import packing as pk_t
from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels.sgd_sweep import (SWEEP_RANKS, check_kernel_limits,
                                         sgd_sweep_plain, sgd_sweep_time)
from mfx_torch.models.mf import MFModel
from mfx_torch.models.timesvd import fit_time_features
from mfx_torch.solvers import timesvd_blocked as tsb
from mfx_torch.solvers.blocked import sweep_geometry

NB = 8  # time bins of the tests' recipe
KEYS = ("P", "Q", "bu", "bi", "bt", "alpha")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain versions loop over many small CPU
    ops, and under a parallel test run the workers' thread pools would
    fight for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def temporal_coo(users, items, n, seed=3, n_bins=NB):
    """The reference tests' recipe (tests/unit/test_timesvd_blocked.py):
    the seeded synthetic, timestamps in [0, 1e6), a N(0, 0.35) shift per
    (item, bin) on ``n_bins`` calendar bins, ratings clipped to [0.5, 5]."""
    rng = np.random.default_rng(seed)
    coo = synthetic.make_synthetic(users, items, n, rank=4, noise=0.25,
                                   seed=seed)
    ts = rng.integers(0, 1_000_000, n)
    shift = rng.normal(0, 0.35, (items, n_bins)).astype(np.float32)
    r = coo.rating + shift[coo.item, ts * n_bins // 1_000_000]
    return dataclasses.replace(coo, rating=np.clip(r, 0.5, 5.0).astype(
        np.float32), timestamp=ts.astype(np.int64))


def _jax_bits(seed):
    def bits(epoch, n):
        key = jax.random.fold_in(jax.random.key(seed), epoch)
        return torch.as_tensor(np.array(
            jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)))
    return bits


def _arrays(m):
    return {k: np.asarray(getattr(m, k)) for k in ("P", "Q", "bu", "bi", "mu")}


def _start(U, I, rank, seed, mu, nb=NB):
    """Shared initial tables with nonzero biases and temporal terms."""
    rng = np.random.default_rng(seed)
    m = init_model(seed, U, I, rank, global_mean=mu)
    ts = init_timesvd_j(0, U, I, rank, nb, base=JMFModel(
        P=m.P, Q=m.Q, bu=jnp.asarray(rng.normal(0, 0.1, U), jnp.float32),
        bi=jnp.asarray(rng.normal(0, 0.1, I), jnp.float32), mu=m.mu))
    return dataclasses.replace(
        ts, bt=jnp.asarray(rng.normal(0, 0.1, (I, nb)), jnp.float32),
        alpha=jnp.asarray(rng.normal(0, 0.1, U), jnp.float32))


def _plans(coo, su, tile, rank, seed=5, nb=NB):
    """Both packages' (NT, 5, T) streams of one epoch on the reference's
    shuffle bits (``nb`` time bins), and the reference's skeleton."""
    feats = fit_j(coo, n_bins=nb)
    tb, dv = feats.features(coo.user, coo.timestamp)
    nwin = sweep_geometry_j(coo.num_items, rank, su)
    skel_j, u, i, r, tb_j, dvb_j = tsb_j.build_temporal_plan_skeleton(
        coo, tb, dv, su=su, si=su, tile=tile, tpg=4, nwin=nwin)
    tl_j = np.array(pdv_j.epoch_tiles_device(skel_j, u, i, r, seed, 0,
                                             extras=(tb_j, dvb_j)))
    plan = tsb.build_temporal_plan_skeleton(
        coo, tb, dv, su=su, si=su, tile=tile, tpg=4,
        nwin=sweep_geometry(coo.num_items, rank, su), device="cpu")
    tl, sweeps = tsb.plan_temporal_epoch_device(
        *plan, seed, 0, rand=_jax_bits(seed)(0, coo.n_ratings))
    return tl_j, skel_j, tl, sweeps, plan


@pytest.mark.parametrize("su,tile", [(128, 64), (256, 32)])
def test_temporal_plan_is_the_reference_plan(su, tile):
    """Bitwise the reference's (NT, 5, T) stream on its shuffle bits; rows
    0-2 bitwise the 3-row stream; rows 3-4 each slotted rating's bin and
    deviation bits, 0 in pads; the same sweeps."""
    coo = temporal_coo(300, 260, 8_000)
    tl_j, skel_j, tl, sweeps, plan = _plans(coo, su, tile, 64)
    np.testing.assert_array_equal(tl.numpy(), tl_j)
    skel, u, i, r, tb, dvb = plan
    tl3 = pdv.epoch_tiles_device(skel, u, i, r, 5, 0,
                                 rand=_jax_bits(5)(0, coo.n_ratings))
    assert torch.equal(tl[:, :3], tl3)
    pad = tl[:, 0] >= su
    assert pad.any() and not tl[:, 3:][pad[:, None].expand(-1, 2, -1)].any()
    assert [(s.t0, s.t1, s.win0, s.nwin) for s in sweeps] == [
        (s.t0, s.t1, s.win0, s.nwin) for s in skel_j.sweeps if s.t1 > s.t0]
    with pytest.raises(ValueError, match="int32"):
        pdv.epoch_tiles_device(skel, u, i, r, 5, 0, extras=(tb.long(),))


# rank 32 packs four slots into a reference lane row, rank 64 two, ranks
# 16 and 8 eight and sixteen: the reference's dot sums 128 lanes where the
# port sums `rank`, and its segment sums associate differently; f32 noise
# only (the lane form's tolerance in tests/test_torch_sgd_sweep.py). Ranks
# 16 and 8 take the most bins, n_bins = rank - 4 (12 and 4; L = 1 latent
# lane); at rank 4 no bin fits.
@pytest.mark.parametrize("rank", [32, 64, 16, 8])
def test_plain_time_sweep_matches_pallas_interpret(rank):
    _time_sweep_against_pallas(rank, {16: 12, 8: 4}.get(rank, NB))


def test_plain_time_sweep_with_the_most_bins_matches_pallas_interpret():
    """n_bins = rank - 4 = 28 at rank 32, the most the lanes hold: L = 1
    latent lane, the bins in lanes 1-28."""
    _time_sweep_against_pallas(32, 28)


def _time_sweep_against_pallas(rank, nb):
    U = I = 600
    su, tile, lr, reg = 256, 64, 0.012, 0.04
    coo = temporal_coo(U, I, 6_000, seed=9, n_bins=nb)
    tl_j, skel_j, tl, sweeps, _ = _plans(coo, su, tile, rank, nb=nb)
    ts0 = _start(U, I, rank, 3, float(coo.global_mean), nb=nb)
    mu = float(ts0.mu)
    Pm, Qm = pk.pack_state(pk.to_tlane_model(ts0, nb), su, su)
    sse_j = 0.0
    for sw in skel_j.sweeps:
        Qs = pk.q_segment(Qm, sw.win0, sw.nwin, rank, su)
        Pm, Qs, s = blocked_sgd_sweep_pallas(
            Pm, Qs, {"sa": sw.sa, "tc": sw.tc,
                     "tl": jnp.asarray(tl_j[sw.t0:sw.t1])},
            lr, reg, mu, su=su, si=su, rank=rank, tpg=4, use_bias=True,
            exact=True, interpret=True, bias_mode="lane", time_mode=True,
            n_bins=nb)
        Qm = pk.q_segment_restore(Qm, Qs, sw.win0, rank, su)
        sse_j += float(s[0, 0])
    ref = pk.from_tlane_model(pk.unpack_state(Pm, Qm, ts0.mu, U, I, rank,
                                              su, su), nb)

    arrays = {k: np.asarray(getattr(ts0, k)) for k in KEYS + ("mu",)}
    from mfx_torch.convert import timesvd_from_numpy

    lane = pk_t.to_tlane_model(timesvd_from_numpy(arrays, device="cpu"), nb)
    P, Q = pk_t.pad_rows(lane.P, su), pk_t.pad_rows(lane.Q, su)
    P0, Q0 = P.clone(), Q.clone()
    sse_t = 0.0
    for sw in sweeps:
        sse_t += float(sgd_sweep_time(
            P, Q[sw.win0 * su:(sw.win0 + sw.nwin) * su], sw.sa, sw.tc,
            tl[sw.t0:sw.t1], lr, reg, mu, su=su, si=su, tpg=4, n_bins=nb))
    got = pk_t.from_tlane_model(MFModel(P[:U], Q[:I], torch.zeros(U),
                                        torch.zeros(I), mu), nb)
    for k in KEYS:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j
    # the frozen lanes never move: P's bin lanes and constant 1, Q's drift
    # lane and constant 1; nor do the pad rows
    L = rank - 3 - nb
    for T_, T0, lanes in ((P, P0, list(range(L, L + nb)) + [rank - 2]),
                          (Q, Q0, [rank - 3, rank - 1])):
        assert torch.equal(T_[:, lanes], T0[:, lanes])
    assert torch.equal(P[U:], P0[U:]) and torch.equal(Q[I:], Q0[I:])
    assert float((P[:U, rank - 3] - P0[:U, rank - 3]).abs().max()) > 0


def test_pads_inject_nothing():
    """A tile whose real slots are all of one (user, item) pair: the pads'
    bins and deviations, set to garbage here, change nothing."""
    rank, su = 64, 128
    g = torch.Generator().manual_seed(0)
    P = torch.randn(su, rank, generator=g) * 0.1
    Q = torch.randn(su, rank, generator=g) * 0.1
    tl = torch.zeros(4, 5, 16, dtype=torch.int32)
    tl[:, 0], tl[:, 1] = su, su
    tl[0, 0, :3], tl[0, 1, :3] = 5, 7
    tl[0, 2, :3] = torch.tensor([4.0, 3.0, 5.0]).view(torch.int32)
    tl[0, 3, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    tl[0, 4, :3] = torch.tensor([0.5, -0.25, 0.1]).view(torch.int32)
    args = (torch.zeros(1, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32))
    outs = []
    for garbage in (False, True):
        t = tl.clone()
        if garbage:
            t[:, 3, 3:] = 5
            t[:, 4, 3:] = torch.tensor(9.0).view(torch.int32)
        Pt, Qt = P.clone(), Q.clone()
        sse = sgd_sweep_plain(Pt, Qt, *args, t, 0.05, 0.02, 3.5, su=su,
                              si=su, tpg=4, n_bins=NB)
        outs.append((Pt, Qt, float(sse)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1]) and outs[0][2] == outs[1][2]


def test_two_epochs_match_the_reference():
    """Two epochs of the trainer (su = si = 512, T = 256, rank 64) against
    the reference's device planner and ``run_temporal_epoch`` in interpret
    mode, composed as its trainer runs them on a TPU (off the TPU it plans
    on the host, with other shuffle bits), one plan for both epochs
    (``replan_every=0``), the same lr decay; from the same tables."""
    U = I = 700
    rank = 64
    coo = temporal_coo(U, I, 12_000, seed=4)
    cfg = TimeSVDConfig(lr=0.02, reg=0.02, epochs=2, n_bins=NB,
                        kernel="pallas", reg_alpha=0.02)
    m0 = init_model(1, U, I, rank, global_mean=coo.global_mean)
    feats_j = fit_j(coo, n_bins=NB)
    tb, dv = feats_j.features(coo.user, coo.timestamp)
    su = tsb.BLOCK
    args, meta = tsb_j.plan_temporal_epoch(
        coo, tb, dv, su=su, si=su, tile=tsb.TILE, tpg=4,
        nwin=sweep_geometry_j(I, rank, su), seed=0, epoch=0, device=True)
    ts = init_timesvd_j(0, U, I, rank, NB, base=m0)
    ref = []
    for epoch in range(2):
        ts, sse = tsb_j.run_temporal_epoch(
            ts, args, meta, cfg.lr * cfg.lr_decay ** epoch, cfg.reg, NB,
            su=su, si=su, tpg=4, interpret=True)
        ref.append((float(np.sqrt(float(sse) / coo.n_ratings)),
                    {k: np.asarray(getattr(ts, k)) for k in KEYS}))

    timings = {}
    got = []
    for epoch, m, tr in tsb.train_epochs_timesvd_blocked(
            model_from_numpy(_arrays(m0), device="cpu"), coo, cfg, seed=0,
            feats=fit_time_features(coo, n_bins=NB), timings=timings,
            plan_rand=_jax_bits(0)):
        got.append((float(tr), {k: getattr(m, k).numpy() for k in KEYS}))
    assert timings["sweep_tiles"] and timings["plan_s"] >= 0
    for (tr_t, tab_t), (tr_j, tab_j) in zip(got, ref, strict=True):
        assert abs(tr_t - tr_j) <= 1e-5
        for k in KEYS:
            np.testing.assert_allclose(tab_t[k], tab_j[k], rtol=0, atol=1e-4,
                                       err_msg=k)
    assert got[1][0] < got[0][0]
    L = rank - 3 - NB
    last = got[-1][1]
    assert not last["P"][:, L:].any() and not last["Q"][:, L:].any()
    assert np.abs(got[-1][1]["bt"]).max() > 0
    assert np.abs(got[-1][1]["alpha"]).max() > 0


def test_run_temporal_epoch_is_the_trainer_epoch():
    """The composition hook (one epoch on a canonical model) gives the
    trainer's first epoch bit for bit."""
    U = I = 300
    coo = temporal_coo(U, I, 4_000, seed=6)
    cfg = TimeSVDConfig(lr=0.02, reg=0.02, epochs=1, n_bins=NB,
                        kernel="pallas", reg_alpha=0.02)
    m0 = model_from_numpy(_arrays(init_model(2, U, I, 64)), device="cpu")
    feats = fit_time_features(coo, n_bins=NB)
    (_, want, _), = tsb.train_epochs_timesvd_blocked(m0, coo, cfg,
                                                     feats=feats)
    tb, dv = feats.features(coo.user, coo.timestamp)
    plan = tsb.build_temporal_plan_skeleton(
        coo, tb, dv, su=tsb.BLOCK, si=tsb.BLOCK, tile=tsb.TILE, tpg=4,
        nwin=sweep_geometry(I, 64, tsb.BLOCK), device="cpu")
    tl, sweeps = tsb.plan_temporal_epoch_device(*plan, 0, 0)
    from mfx_torch.models.timesvd import init_timesvd

    got, _ = tsb.run_temporal_epoch(init_timesvd(None, U, I, 64, NB,
                                                 base=m0),
                                    tl, sweeps, cfg.lr, cfg.reg, NB,
                                    su=tsb.BLOCK, si=tsb.BLOCK)
    for k in KEYS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def _refusals(train_fn, timesvd_cfg, mf_model):
    coo = temporal_coo(300, 260, 2_000)
    out = []
    for cfg, coo_, model, kw in (
            (timesvd_cfg(lr_t=0.001, kernel="pallas", n_bins=NB), coo,
             mf_model(32), {}),
            (timesvd_cfg(kernel="pallas", n_bins=30), coo, mf_model(32), {}),
            (timesvd_cfg(kernel="pallas", n_bins=NB),
             dataclasses.replace(coo, timestamp=None), mf_model(32), {}),
            (timesvd_cfg(kernel="pallas", n_bins=NB), coo, mf_model(48), {}),
            (timesvd_cfg(kernel="pallas", n_bins=NB), coo, mf_model(32),
             {"use_bias": False}),
            (timesvd_cfg(kernel="pallas", n_bins=NB), coo, mf_model(32),
             {"start_epoch": 1})):
        with pytest.raises(Exception) as info:
            next(iter(train_fn(model, coo_, cfg, **kw)))
        out.append(type(info.value))
    return out


def test_refusals_are_the_reference_refusals():
    """lr/reg off the uniform schedule, n_bins > rank - 4, no timestamps,
    a rank that does not divide 128, no biases, a resumed start: the same
    exception types as the reference's trainer, all ValueError."""
    def mf_j(rank):
        return init_model(0, 300, 260, rank, global_mean=3.5)

    def mf_t(rank):
        return model_from_numpy(_arrays(mf_j(rank)), device="cpu")

    want = _refusals(tsb_j.train_epochs_timesvd_blocked, TimeSVDConfig_j,
                     mf_j)
    assert _refusals(tsb.train_epochs_timesvd_blocked, TimeSVDConfig,
                     mf_t) == want == [ValueError] * 6


def test_reg_alpha_none_warns_as_the_reference_does():
    coo = temporal_coo(200, 150, 1_500)
    m0 = model_from_numpy(_arrays(init_model(0, 200, 150, 32)), device="cpu")
    cfg = TimeSVDConfig(kernel="pallas", n_bins=NB, epochs=1)
    with pytest.warns(UserWarning, match="reg_alpha"):
        next(iter(tsb.train_epochs_timesvd_blocked(m0, coo, cfg)))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        next(iter(tsb.train_epochs_timesvd_blocked(
            m0, coo, dataclasses.replace(cfg, reg_alpha=cfg.reg))))


def test_time_form_kernel_limits():
    """The sweep kernels are built for every rank that divides 128; the
    time form's bin rule (n_bins <= rank - 4) refuses ranks 4, 2 and 1 on
    any device, before any kernel check; another rank (12: the plain
    version takes it) is refused on a card's tensors; a bin count the
    lanes cannot hold is refused on any device."""
    tl = torch.zeros(4, 5, 256, dtype=torch.int32)
    assert SWEEP_RANKS == (1, 2, 4, 8, 16, 32, 64, 128)
    for ok in SWEEP_RANKS:
        check_kernel_limits("sgd_sweep_time", torch.zeros(512, ok), tl, 512,
                            512)
    with pytest.raises(NotImplementedError, match="does not divide 128"):
        check_kernel_limits("sgd_sweep_time", torch.zeros(512, 12), tl, 512,
                            512)
    for rank in (4, 2, 1):
        with pytest.raises(ValueError, match="n_bins"):
            Pr = torch.zeros(512, rank)
            sgd_sweep_time(Pr, Pr, torch.zeros(1, dtype=torch.int32),
                           torch.zeros(4, dtype=torch.int32), tl, 0.01, 0.02,
                           3.5, su=512, si=512, tpg=4, n_bins=1)
    P = torch.zeros(512, 64)
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="n_bins"):
        sgd_sweep_time(P, P, torch.zeros(1, **i32), torch.zeros(4, **i32),
                       tl, 0.01, 0.02, 3.5, su=512, si=512, tpg=4, n_bins=61)
    with pytest.raises(ValueError, match=r"\(NT, 5, T\)"):
        sgd_sweep_time(P, P, torch.zeros(1, **i32), torch.zeros(4, **i32),
                       tl[:, :3].contiguous(), 0.01, 0.02, 3.5, su=512,
                       si=512, tpg=4, n_bins=NB)
