"""The dense phase's remaining reference branches in the port: ``echo``
passes (the plain version of the ``dense_phase`` kernel against the
reference's ``run_dense_phase(echo=2)`` in interpret mode, and the
reference's own diagonal-strata identity), the ``spg`` carving of
``prepare_dense_full`` and the head-only split ``prepare_dense_device``
against the reference's, and the slot table of the echo passes
(``SweepDeps.repeat``). The multi-group case of
tests/test_torch_dense_frozen.py: 600 x 600, su = si = 256, one window a
group, chi 0.01."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data.coo import RatingsCOO
from mfx.kernels import packing as pk
from mfx.solvers import dense_prep as dp_j
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels import packing as pk_t
from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels.dense_phase import (decode_codes, dense_phase,
                                           dense_phase_plain)
from mfx_torch.solvers import dense_prep as dp
from test_torch_dense import _ref_codes
from test_torch_dense_frozen import (FORMS, I0, KEYS, LR, NWD, REG, SI, SU,
                                     U0, _coo, _model)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(coo):
    return (torch.as_tensor(coo.user), torch.as_tensor(coo.item),
            torch.as_tensor(coo.rating))


def _jax(coo):
    return (jnp.asarray(coo.user), jnp.asarray(coo.item),
            jnp.asarray(coo.rating))


def _full(coo, rank, rfmt, spg=1, nwd=NWD):
    j = dp_j.prepare_dense_full(*_jax(coo), U0, I0, SU, SI, chi_min=0.01,
                                nwd=nwd, pack=128 // rank, rfmt=rfmt,
                                spg=spg)
    t = dp.prepare_dense_full(*_tensors(coo), U0, I0, SU, SI, chi_min=0.01,
                              nwd=nwd, rfmt=rfmt, spg=spg)
    return j, t


def _echo_reference(model, meta_j, groups_j, rank, rfmt, lane, echo):
    Pm, Qm = pk.pack_state(pk.to_lane_model(model) if lane else model, SU,
                           SI)
    sse = 0.0
    for (win0, nw), g in zip(meta_j, groups_j):
        Qs = pk.q_segment(Qm, win0, nw, rank, SI)
        Pm, Qs, s = dp_j.run_dense_phase(
            Pm, Qs, g, LR, REG, float(model.mu), su=SU, si=SI, rank=rank,
            use_bias=lane, exact=True, interpret=True, rfmt=rfmt, lane=lane,
            echo=echo)
        Qm = pk.q_segment_restore(Qm, Qs, win0, rank, SI)
        sse += float(s)
    got = pk.unpack_state(Pm, Qm, model.mu, U0, I0, rank, SU, SI)
    if lane:
        got = pk.from_lane_model(got)
    return {k: np.asarray(getattr(got, k)) for k in KEYS}, sse


def _echo_port(model, meta, groups, lane, echo, phase=dense_phase):
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in KEYS + ("mu",)}, device="cpu")
    if lane:
        P, Q = pk_t.lane_tables(tm, SU, SI, "cpu")
    else:
        P, Q, _, _ = pk_t.plain_tables(tm, SU, SI, "cpu")
    sse = 0.0
    for (win0, nw), g in zip(meta, groups):
        sse += float(phase(P, Q[win0 * SI:(win0 + nw) * SI], g, LR, REG,
                           tm.mu, su=SU, si=SI,
                           bias="lane" if lane else "none", echo=echo))
    if lane:
        out = pk_t.from_lane_model(model_from_numpy(
            {"P": P[:U0].numpy(), "Q": Q[:I0].numpy(), "bu": np.zeros(U0),
             "bi": np.zeros(I0), "mu": tm.mu}, device="cpu"))
        return {k: getattr(out, k) for k in KEYS}, sse
    return {"P": P[:U0], "Q": Q[:I0], "bu": tm.bu, "bi": tm.bi}, sse


@pytest.mark.parametrize("lane", [True, False])
@pytest.mark.parametrize("rank,rfmt,star", FORMS)
def test_echo_matches_reference(rank, rfmt, star, lane):
    """echo=2 in the lane and bias-free forms, every rank and code format
    of the kernel: tables within 1e-5 (the echo=1 tolerance of
    tests/test_torch_dense_frozen.py; each pass sums as the first), SSE
    (first passes) within 1e-5 relative, and the second passes really
    moved the tables."""
    coo = _coo(star)
    (meta_j, groups_j, _, _), (meta, groups, _, _) = _full(coo, rank, rfmt)
    model = _model(coo, rank)
    ref, sse_j = _echo_reference(model, meta_j, groups_j, rank, rfmt, lane, 2)
    got, sse_t = _echo_port(model, meta, groups, lane, 2)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j
    once, sse_1 = _echo_port(model, meta, groups, lane, 1)
    assert float((once["P"] - got["P"]).abs().max()) > 1e-4
    assert abs(sse_1 - sse_t) > 0  # later strata saw the echoed tables


@pytest.mark.parametrize("lane", [True, False])
def test_echo_equals_sequential_passes_on_diagonal_strata(lane):
    """The reference's own identity (tests/unit/test_dense_path.py): with
    strata on the diagonal (no user block or window shared) one echo=2
    phase is two echo=1 phases, bit for bit, and its SSE is the first
    phase's."""
    rng = np.random.default_rng(7)
    us, its = [], []
    for k in range(2):
        us.append(rng.integers(k * SU, (k + 1) * SU, 3000))
        its.append(rng.integers(k * SI, (k + 1) * SI, 3000))
    coo = RatingsCOO(np.concatenate(us).astype(np.int32),
                     np.concatenate(its).astype(np.int32),
                     rng.integers(1, 11, 6000).astype(np.float32) / 2,
                     2 * SU, 2 * SI)
    _, groups, (u_sp, _, _), info = dp.prepare_dense_full(
        *_tensors(coo), 2 * SU, 2 * SI, SU, SI, chi_min=0.01, nwd=2)
    assert info["num_strata"] == 2 and u_sp.shape[0] == 0
    (grp,) = groups
    rank = 64
    g = torch.Generator().manual_seed(4)
    P0 = torch.randn(2 * SU, rank, generator=g) * 0.1
    Q0 = torch.randn(2 * SI, rank, generator=g) * 0.1
    if lane:
        P0[:, rank - 2], Q0[:, rank - 1] = 1.0, 1.0
    bias = "lane" if lane else "none"
    kw = dict(su=SU, si=SI, bias=bias)
    Pe, Qe = P0.clone(), Q0.clone()
    sse_e = dense_phase_plain(Pe, Qe, grp, 0.01, 0.02, 3.0, echo=2, **kw)
    P1, Q1 = P0.clone(), Q0.clone()
    sse_1 = dense_phase_plain(P1, Q1, grp, 0.01, 0.02, 3.0, **kw)
    P1_once = P1.clone()
    dense_phase_plain(P1, Q1, grp, 0.01, 0.02, 3.0, **kw)
    assert torch.equal(Pe, P1) and torch.equal(Qe, Q1)
    assert torch.equal(sse_e, sse_1)
    assert not torch.equal(Pe, P1_once)


def test_echo_is_refused_with_frozen_biases_and_below_one():
    """As the reference's wrapper: echo > 1 needs lane-carried biases or
    none (NotImplementedError), and echo >= 1 (ValueError)."""
    coo = _coo(0.5)
    _, (meta, groups, _, _) = _full(coo, 64, "int4")
    grp = groups[0]
    P, Q = torch.zeros(3 * SU, 64), torch.zeros(3 * SI, 64)
    bu, bi = torch.zeros(3 * SU), torch.zeros(SI)
    with pytest.raises(NotImplementedError, match="echo"):
        dense_phase(P, Q[:SI], grp, LR, REG, 3.5, su=SU, si=SI,
                    bias="frozen", bu=bu, bi=bi, echo=2)
    with pytest.raises(ValueError, match="echo"):
        dense_phase(P, Q[:SI], grp, LR, REG, 3.5, su=SU, si=SI, echo=0)


def _assert_groups_match(groups_j, groups, rank, rfmt):
    for gj, gt in zip(groups_j, groups):
        nd = gt["sa"].shape[0]
        for k in ("sa", "sc"):
            np.testing.assert_array_equal(gt[k].numpy(), np.asarray(gj[k]))
        np.testing.assert_array_equal(
            gt["du_s"].numpy(), np.asarray(gj["du_s"]).reshape(nd, SU))
        np.testing.assert_array_equal(
            gt["di_s"].numpy(), np.asarray(gj["di_s"]).reshape(nd, SI))
        for k in ("du_tot", "di_tot"):
            np.testing.assert_array_equal(gt[k].numpy(),
                                          np.asarray(gj[k]).reshape(-1))
        codes = torch.stack([decode_codes(gt["R"][s], rfmt)
                             for s in range(nd)])
        np.testing.assert_array_equal(
            codes.numpy(), _ref_codes(gj["R"], rfmt, 128 // rank))


def _reference_layout(grp, spg):
    """The reference's ``spg`` layout of a port group: each user block's
    run of strata padded to a multiple of ``spg`` with null strata (the
    run's user block, window 0, zero codes, zero degrees)."""
    sa = grp["sa"].numpy()
    starts = np.flatnonzero(np.r_[True, np.diff(sa) != 0])
    lens = np.diff(np.r_[starts, sa.size])
    pad = -(-lens // spg) * spg
    new = np.r_[0, np.cumsum(pad)]
    pos = torch.as_tensor(np.arange(sa.size) - np.repeat(starts, lens)
                          + np.repeat(new[:-1], lens))
    out = {"sa": torch.as_tensor(np.repeat(sa[starts], pad)),
           "du_tot": grp["du_tot"], "di_tot": grp["di_tot"]}
    for k in ("sc", "R", "du_s", "di_s"):
        out[k] = grp[k].new_zeros((int(new[-1]),) + grp[k].shape[1:])
        out[k][pos] = grp[k]
    return out


@pytest.mark.parametrize("spg", [2, 4])
@pytest.mark.parametrize("rank,rfmt,star", [(64, "int4", 0.5),
                                            (128, "int8", 1.0)])
def test_spg_prep_matches_reference(rank, rfmt, star, spg):
    """``prepare_dense_full(spg=...)`` carves the spg=1 groups (strata,
    table and sparse remainder) and counts the reference's padding: laid
    out as the reference pads them, the strata (sa, window-local sc,
    codes, degrees, degree totals) equal the reference's, and
    ``dense_info`` does too, but for ``r_stream_bytes``, which counts the
    real strata's image alone."""
    coo = _coo(star)
    for nwd in (NWD, 3):
        (meta_j, groups_j, sp_j, info_j), (meta, groups, sp, info) = _full(
            coo, rank, rfmt, spg, nwd)
        assert meta == meta_j
        padded = [_reference_layout(g, spg) for g in groups]
        _assert_groups_match(groups_j, padded, rank, rfmt)
        for a, b in zip(sp, sp_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for k in ("num_strata", "strata_padded", "spg", "num_groups",
                  "thresh_ratings"):
            assert info[k] == info_j[k], k
        assert info["dense_frac"] == pytest.approx(info_j["dense_frac"])
        assert info["strata_padded"] > info["num_strata"]
        assert sum(g["R"].numel() for g in padded) == info_j["r_stream_bytes"]
        assert info["r_stream_bytes"] == sum(g["R"].numel() for g in groups)
        _, (meta1, ones, _, info1) = _full(coo, rank, rfmt, 1, nwd)
        assert info1["strata_padded"] == info1["num_strata"]
        assert meta1 == meta
        for g, g1 in zip(groups, ones):
            for k in ("sa", "sc", "R", "du_s", "di_s", "du_tot", "di_tot"):
                assert torch.equal(g[k], g1[k]), k
            for k in ("runs", "wait"):
                assert torch.equal(getattr(g["deps"], k),
                                   getattr(g1["deps"], k))


def test_null_strata_are_exact_noops():
    """The plain phase over a group laid out as the reference pads it
    (null strata in its runs) is bit for bit the phase over its real
    strata, in the lane form."""
    coo = _coo(0.5)
    _, (meta, groups, _, _) = _full(coo, 64, "int4", 4, 3)
    model = _model(coo, 64)
    padded, sse_p = _echo_port(model, meta,
                               [_reference_layout(g, 4) for g in groups],
                               True, 1, phase=dense_phase_plain)
    real, sse_r = _echo_port(model, meta, groups, True, 1)
    assert sse_p == sse_r
    for k in KEYS:
        assert torch.equal(padded[k], real[k]), k


@pytest.mark.parametrize("nwin_head", [1, 2, 3])
@pytest.mark.parametrize("rank,rfmt,star", [(64, "int4", 0.5),
                                            (128, "int8", 1.0),
                                            (32, "int4", 1.0)])
def test_head_prep_matches_reference(rank, rfmt, star, nwin_head):
    """``prepare_dense_device`` (``dense_span='head'``): the strata of the
    first ``nwin_head`` windows, their codes, degrees and totals, the
    sparse remainder and ``dense_info`` equal the reference's; the one
    group's table orders its strata."""
    coo = _coo(star)
    tens_j, sp_j, info_j = dp_j.prepare_dense_device(
        *_jax(coo), U0, I0, SU, SI, chi_min=0.01, nwin_head=nwin_head,
        pack=128 // rank, rfmt=rfmt)
    meta, groups, sp, info = dp.prepare_dense_device(
        *_tensors(coo), U0, I0, SU, SI, chi_min=0.01, nwin_head=nwin_head,
        rfmt=rfmt)
    assert info == pytest.approx(info_j)
    assert meta == ((0, nwin_head),)
    _assert_groups_match([tens_j], groups, rank, rfmt)
    for a, b in zip(sp, sp_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    (grp,) = groups
    assert int(grp["sc"].max()) < nwin_head
    assert grp["deps"].n_tiles == grp["sa"].shape[0]


def test_head_prep_with_no_eligible_stratum():
    coo = _coo(0.5)
    meta, groups, sp, info = dp.prepare_dense_device(
        *_tensors(coo), U0, I0, SU, SI, chi_min=0.9, nwin_head=3)
    assert meta == () and groups == () and info == {"dense_frac": 0.0}
    assert sp[0].shape[0] == coo.n_ratings


@pytest.mark.parametrize("k", [1, 2, 3])
def test_repeated_table_is_the_table_of_repeated_tiles(k):
    """``SweepDeps.repeat(k)`` (each tile as k consecutive slots) equals
    the table built from k times the tiles, and its list order puts every
    slot after those it waits for."""
    rng = np.random.default_rng(k)
    tp = (rng.random((6, 5)) < 0.5).astype(np.int64) * rng.integers(1, 3,
                                                                    (6, 5))
    base = pdv.sweep_deps(tp, tp.sum(1), "cpu")
    want = pdv.sweep_deps(tp * k, tp.sum(1) * k, "cpu")
    got = base.repeat(k)
    assert torch.equal(got.runs, want.runs)
    assert torch.equal(got.wait, want.wait)
    assert (got.n_tiles, got.critical) == (want.n_tiles, want.critical)
    order = got.list_order(4, 2, 1, 0.1, 3).numpy()
    assert sorted(order) == list(range(got.n_tiles))
    place = np.argsort(order)
    for t, before in enumerate(pdv._preds(got.runs.numpy(),
                                          got.wait.numpy())):
        assert all(place[p] < place[t] for p in before)
