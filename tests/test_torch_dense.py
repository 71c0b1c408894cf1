"""The port's dense carving, R image and dense phase (plain version of the
dense_phase kernel) against the reference's prepare_dense_full and
dense_phase_core (Pallas in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import synthetic, train_test_split
from mfx.kernels import packing as pk
from mfx.models import init_model
from mfx.models.mf import MFModel as JMFModel
from mfx.solvers import dense_prep as dp_j
from mfx.solvers.blocked import dense_group_windows as dgw_j
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels import packing as pk_t
from mfx_torch.kernels.dense_phase import decode_codes, dense_phase
from mfx_torch.solvers import dense_prep as dp
from mfx_torch.solvers.blocked import dense_group_windows

U = I = 600
SU = SI = 256
RANK, PACK = 64, 2
LR, REG = 0.012, 0.04


def _train():
    coo = synthetic.make_synthetic(U, I, 25_000, rank=4, noise=0.3, seed=9,
                                   star_step=0.5)
    return train_test_split(coo, test_frac=0.1, seed=0)[0]


def _preps(tr, chi=0.01, nwd=None, rfmt="int4", rank=RANK):
    nwd = nwd or dgw_j(rank, SI)
    j = dp_j.prepare_dense_full(
        jnp.asarray(tr.user), jnp.asarray(tr.item), jnp.asarray(tr.rating),
        U, I, SU, SI, chi_min=chi, nwd=nwd, pack=128 // rank, rfmt=rfmt,
    )
    t = dp.prepare_dense_full(
        torch.as_tensor(tr.user), torch.as_tensor(tr.item),
        torch.as_tensor(tr.rating), U, I, SU, SI, chi_min=chi, nwd=nwd,
        rfmt=rfmt,
    )
    return j, t


def _ref_codes(R, rfmt, pack=PACK):
    """Reference R image (decimated parity blocks; int4 nibble-packed
    pairs) -> plain (ND, su, si) codes."""
    sup, sip = SU // pack, SI // pack
    R = np.asarray(R).astype(np.int32) & 255
    nd = R.shape[0]
    out = np.zeros((nd, SU, SI), np.int32)
    for a in range(pack):
        for b in range(pack):
            p_idx = a * pack + b
            if rfmt == "int8":
                blk = R[:, p_idx * sup:(p_idx + 1) * sup]
            else:
                half = R[:, (p_idx // 2) * sup:(p_idx // 2 + 1) * sup]
                blk = (half >> 4) if p_idx % 2 else (half & 15)
            out[:, a::pack, b::pack] = blk
    return out


def test_group_windows_match_reference():
    for rank in (RANK, 128):
        for si in (128, 256, 512, 1024):
            assert dense_group_windows(rank, si) == dgw_j(rank, si)
    assert dense_group_windows(128, 512) == 16  # the netflix preset


@pytest.mark.parametrize("chi,nwd,rfmt,rank", [(0.01, None, "int4", 64),
                                               (0.01, 1, "int4", 64),
                                               (0.02, 2, "int8", 64),
                                               (0.01, None, "int8", 128)])
def test_prepare_dense_full_matches_reference(chi, nwd, rfmt, rank):
    tr = _train()
    (meta_j, groups_j, sp_j, info_j), (meta, groups, sp, info) = _preps(
        tr, chi=chi, nwd=nwd, rfmt=rfmt, rank=rank)
    assert meta == meta_j and len(meta) >= 1
    assert info["num_strata"] == info_j["num_strata"]
    assert info["dense_frac"] == pytest.approx(info_j["dense_frac"])
    for gj, gt in zip(groups_j, groups):
        nd = gt["sa"].shape[0]
        np.testing.assert_array_equal(gt["sa"].numpy(), np.asarray(gj["sa"]))
        np.testing.assert_array_equal(gt["sc"].numpy(), np.asarray(gj["sc"]))
        np.testing.assert_array_equal(
            gt["du_s"].numpy(), np.asarray(gj["du_s"]).reshape(nd, SU))
        np.testing.assert_array_equal(
            gt["di_s"].numpy(), np.asarray(gj["di_s"]).reshape(nd, SI))
        assert gt["R"].dtype == (torch.int8 if rfmt == "int8" else torch.uint8)
        codes = torch.stack([decode_codes(gt["R"][s], rfmt) for s in range(nd)])
        np.testing.assert_array_equal(codes.numpy(),
                                      _ref_codes(gj["R"], rfmt, 128 // rank))
    for a, b in zip(sp, sp_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_carved_split_covers_both_paths():
    """At chi = 0.01 the test split carves 5 dense strata and leaves 4
    sparse ones, so the slice exercises both kernels."""
    tr = _train()
    _, (meta, groups, (u_sp, i_sp, _), info) = _preps(tr)
    assert info["num_strata"] == 5
    sparse_strata = {(int(a) // SU, int(b) // SI)
                     for a, b in zip(u_sp.tolist(), i_sp.tolist())}
    assert len(sparse_strata) == 4
    assert sum(g["sa"].shape[0] for g in groups) + int(u_sp.shape[0]) > 0
    nd_ratings = sum(int(g["du_s"].sum()) for g in groups)
    assert nd_ratings + int(u_sp.shape[0]) == tr.n_ratings


@pytest.mark.parametrize("counts,block", [
    (np.array([5000] * 10 + [10] * 2000 + [0] * 50), 1024),  # breakeven
    (np.array([5000] * 10 + [10] * 100), 1024),  # all dense: 1.0
    (None, SU),  # the test split's own histogram
])
def test_auto_dense_threshold_matches_reference(counts, block):
    if counts is None:
        tr = _train()
        C = -(-I // SI)
        counts = np.bincount((tr.user // SU) * C + tr.item // SI)
    for rfmt in ("int4", "int8"):
        got = dp.auto_dense_threshold(counts, block, block, rfmt)
        assert got == dp_j.auto_dense_threshold(counts, block, block, rfmt)
    outcomes = {dp.auto_dense_threshold(np.array([5000] * 10 + [10] * k),
                                        1024, 1024, "int4") == 1.0
                for k in (100, 2000)}
    assert outcomes == {True, False}


def _model(tr, rank=RANK):
    rng = np.random.default_rng(5)
    m = init_model(2, U, I, rank, global_mean=tr.global_mean)
    return JMFModel(P=m.P, Q=m.Q,
                    bu=jnp.asarray(rng.normal(0, 0.1, U), jnp.float32),
                    bi=jnp.asarray(rng.normal(0, 0.1, I), jnp.float32),
                    mu=m.mu)


def _pallas_phase(model, meta_j, groups_j, rfmt="int4"):
    """The reference's dense phase (Pallas in interpret mode), strata in
    plan order: (canonical model, SSE)."""
    mu, rank = float(model.mu), model.rank
    Pm, Qm = pk.pack_state(pk.to_lane_model(model), SU, SI)
    sse_j = 0.0
    for (win0, nw), g in zip(meta_j, groups_j):
        Qs = pk.q_segment(Qm, win0, nw, rank, SI)
        Pm, Qs, s = dp_j.dense_phase_core(
            Pm, Qs, g, LR, REG, mu, su=SU, si=SI, rank=rank, use_bias=True,
            exact=True, interpret=True, rfmt=rfmt, lane=True,
        )
        Qm = pk.q_segment_restore(Qm, Qs, win0, rank, SI)
        sse_j += float(s)
    return pk.from_lane_model(pk.unpack_state(Pm, Qm, model.mu, U, I, rank,
                                              SU, SI)), sse_j


def _assert_port_matches(model, ref, sse_j, meta, groups, atol=1e-5):
    """The port's dense_phase (the plain version on the CPU) over
    ``groups`` from ``model``, against the reference's result."""
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in ("P", "Q", "bu", "bi", "mu")}, device="cpu")
    rank = tm.rank
    P, Q = pk_t.lane_tables(tm, SU, SI, "cpu")
    sse_t = 0.0
    for (win0, nw), g in zip(meta, groups):
        sse_t += float(dense_phase(P, Q[win0 * SI:(win0 + nw) * SI], g, LR,
                                   REG, float(model.mu), su=SU, si=SI))
    P_l, Q_l = P[:U], Q[:I]
    np.testing.assert_array_equal(P_l[:, rank - 2].numpy(), 1.0)
    np.testing.assert_array_equal(Q_l[:, rank - 1].numpy(), 1.0)
    got = {"P": P_l[:, :rank - 2], "Q": Q_l[:, :rank - 2],
           "bu": P_l[:, rank - 1], "bi": Q_l[:, rank - 2]}
    for k, v in got.items():
        want = np.asarray(getattr(ref, k))
        if k in ("P", "Q"):
            want = want[:, :rank - 2]
        np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=atol,
                                   err_msg=k)
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j


# int4 at rank 64 (the ml25m_rank64 form) within 1e-5; the int8 forms
# (rank 128 is the netflix100m_rank128_dp form) within the reference's own
# dense-kernel tolerance, 5e-6 (tests/unit/test_dense_path.py)
@pytest.mark.parametrize("rank,rfmt,atol", [(64, "int4", 1e-5),
                                            (64, "int8", 5e-6),
                                            (128, "int8", 5e-6)])
def test_plain_dense_phase_matches_pallas_interpret(rank, rfmt, atol):
    tr = _train()
    (meta_j, groups_j, _, _), (meta, groups, _, _) = _preps(tr, rfmt=rfmt,
                                                            rank=rank)
    assert sum(g["sa"].shape[0] for g in groups) >= 5
    model = _model(tr, rank)
    ref, sse_j = _pallas_phase(model, meta_j, groups_j, rfmt)
    _assert_port_matches(model, ref, sse_j, meta, groups, atol)


def test_an_order_the_table_allows_matches_pallas_interpret():
    """The port's strata walked in a seeded random order that the group's
    dependency table allows (as the kernel may run them) against the
    reference's plan-order walk."""
    from mfx_torch.kernels import plan_device as pdv

    tr = _train()
    (meta_j, groups_j, _, _), (meta, groups, _, _) = _preps(tr, chi=0.005)
    (grp,) = groups
    order = pdv.wavefront_order(grp["deps"], 0)
    assert len(order) == 8 and (order != np.arange(8)).any()
    o = torch.as_tensor(order)
    moved = {k: v[o].contiguous() for k, v in grp.items() if k != "deps"}
    model = _model(tr)
    ref, sse_j = _pallas_phase(model, meta_j, groups_j)
    _assert_port_matches(model, ref, sse_j, meta, [moved])
