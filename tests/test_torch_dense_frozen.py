"""The dense phase's frozen-bias and bias-free forms (the plain version of
the ``dense_phase`` kernel, with the trainer's batched bias update after
each group) against the reference's ``dense_prep.run_dense_phase(lane=
False)`` in interpret mode, on the multi-group case of
tests/unit/test_dense_full.py (600 x 600, su = si = 256, one window a
group, chi 0.01, the hot strata scattered over the span), and the groups'
degree totals against the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import synthetic
from mfx.data.coo import RatingsCOO
from mfx.kernels import packing as pk
from mfx.models import init_model
from mfx.solvers import dense_prep as dp_j
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels import packing as pk_t
from mfx_torch.kernels.dense_phase import (dense_bias_update, dense_phase,
                                           dense_phase_plain, group_prefix)
from mfx_torch.solvers import dense_prep as dp

U0 = I0 = 600
SU = SI = 256
NWD = 1
LR, REG = 0.008, 0.02
KEYS = ("P", "Q", "bu", "bi")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coo(star_step=None):
    coo = synthetic.make_synthetic(U0, I0, 40_000, rank=8, seed=3,
                                   star_step=star_step)
    return RatingsCOO(user=coo.user, item=coo.num_items - 1 - coo.item,
                      rating=coo.rating, num_users=U0, num_items=I0)


def _preps(coo, rank, rfmt):
    j = dp_j.prepare_dense_full(
        jnp.asarray(coo.user), jnp.asarray(coo.item),
        jnp.asarray(coo.rating), U0, I0, SU, SI, chi_min=0.01, nwd=NWD,
        pack=128 // rank, rfmt=rfmt)
    t = dp.prepare_dense_full(
        torch.as_tensor(coo.user), torch.as_tensor(coo.item),
        torch.as_tensor(coo.rating), U0, I0, SU, SI, chi_min=0.01, nwd=NWD,
        rfmt=rfmt)
    return j, t


def _model(coo, rank):
    m = init_model(2, U0, I0, rank, global_mean=coo.global_mean)
    return m.__class__(P=m.P, Q=m.Q, bu=m.bu + 0.05, bi=m.bi - 0.03,
                       mu=m.mu)


# int4 (the ml25m_rank64 form) and int8 codes at rank 64; int8 at rank
# 128; int4 (ml1m_rank32_biased's whole stars) and int8 at rank 32
FORMS = [(64, "int4", 0.5), (64, "int8", None), (128, "int8", 1.0),
         (32, "int4", 1.0), (32, "int8", None)]


@pytest.mark.parametrize("rank,rfmt,star", FORMS)
def test_degree_totals_match_reference(rank, rfmt, star):
    """``du_tot`` (every user row) and ``di_tot`` (the group's segment) of
    each group equal the reference's, and a prefix of a group keeps the
    totals of its own strata."""
    coo = _coo(star)
    (meta_j, groups_j, _, _), (meta, groups, _, _) = _preps(coo, rank, rfmt)
    assert meta == meta_j and len(meta) >= 2
    A = -(-U0 // SU)
    for (win0, nw), gj, gt in zip(meta, groups_j, groups):
        assert gt["du_tot"].dtype == gt["di_tot"].dtype == torch.float32
        assert gt["du_tot"].shape == (A * SU,)
        assert gt["di_tot"].shape == (nw * SI,)
        np.testing.assert_array_equal(gt["du_tot"].numpy(),
                                      np.asarray(gj["du_tot"]).reshape(-1))
        np.testing.assert_array_equal(gt["di_tot"].numpy(),
                                      np.asarray(gj["di_tot"]).reshape(-1))
        assert float(gt["du_tot"].sum()) == float(gt["du_s"].sum())
    big = max(groups, key=lambda g: g["sa"].shape[0])
    head = group_prefix(big, 1)
    assert float(head["du_tot"].sum()) == float(big["du_s"][0].sum())
    assert head["di_tot"].shape == big["di_tot"].shape


def _reference(model, meta_j, groups_j, rank, rfmt, use_bias):
    Pm, Qm = pk.pack_state(model, SU, SI)
    sse = 0.0
    for (win0, nw), g in zip(meta_j, groups_j):
        Qs = pk.q_segment(Qm, win0, nw, rank, SI)
        Pm, Qs, s = dp_j.run_dense_phase(
            Pm, Qs, g, LR, REG, float(model.mu), su=SU, si=SI, rank=rank,
            use_bias=use_bias, exact=True, interpret=True, rfmt=rfmt,
            lane=False)
        Qm = pk.q_segment_restore(Qm, Qs, win0, rank, SI)
        sse += float(s)
    got = pk.unpack_state(Pm, Qm, model.mu, U0, I0, rank, SU, SI)
    return {k: np.asarray(getattr(got, k)) for k in KEYS}, sse


def _port(model, meta, groups, use_bias, phase=dense_phase):
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in KEYS + ("mu",)}, device="cpu")
    P, Q, bu, bi = pk_t.plain_tables(tm, SU, SI, "cpu")
    sse = 0.0
    for (win0, nw), g in zip(meta, groups):
        seg = slice(win0 * SI, (win0 + nw) * SI)
        if use_bias:
            s, (dbu, dbi) = phase(P, Q[seg], g, LR, REG, tm.mu, su=SU,
                                  si=SI, bias="frozen", bu=bu, bi=bi[seg])
            dense_bias_update(bu, bi[seg], g, dbu, dbi, LR, REG, su=SU,
                              si=SI)
        else:
            s = phase(P, Q[seg], g, LR, REG, tm.mu, su=SU, si=SI,
                      bias="none")
        sse += float(s)
    return {"P": P[:U0], "Q": Q[:I0], "bu": bu[:U0], "bi": bi[:I0]}, sse


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("rank,rfmt,star", FORMS)
def test_bias_forms_match_reference(rank, rfmt, star, use_bias):
    """Every group in its form, the frozen form followed by its batched
    bias update (which the next group sees): tables and biases within
    1e-5 (tests/test_torch_dense.py's tolerance), SSE within 1e-5
    relative; without biases the biases stay as they were."""
    coo = _coo(star)
    (meta_j, groups_j, _, _), (meta, groups, _, _) = _preps(coo, rank, rfmt)
    model = _model(coo, rank)
    ref, sse_j = _reference(model, meta_j, groups_j, rank, rfmt, use_bias)
    got, sse_t = _port(model, meta, groups, use_bias)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j
    moved = float(np.abs(ref["bu"] - np.asarray(model.bu)).max())
    assert (moved > 1e-4) == use_bias
    if not use_bias:
        assert torch.equal(got["bu"], torch.as_tensor(np.array(model.bu)))


def test_frozen_sums_are_the_residuals_and_biases_stay_frozen():
    """The frozen form reads the biases and never writes them; its row
    and column sums of E hold each rated cell once (both add up to the
    same total), and with every bias 0 its tables are the bias-free
    form's bit for bit."""
    coo = _coo(0.5)
    _, (meta, groups, _, _) = _preps(coo, 64, "int4")
    model = _model(coo, 64)
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in KEYS + ("mu",)}, device="cpu")
    (win0, nw), g = meta[0], groups[0]
    seg = slice(win0 * SI, (win0 + nw) * SI)
    P, Q, bu, bi = pk_t.plain_tables(tm, SU, SI, "cpu")
    bu0, bi0 = bu.clone(), bi.clone()
    _, (dbu, dbi) = dense_phase_plain(P, Q[seg], g, LR, REG, tm.mu, su=SU,
                                      si=SI, bias="frozen", bu=bu,
                                      bi=bi[seg])
    assert torch.equal(bu, bu0) and torch.equal(bi, bi0)
    assert dbu.shape == (g["sa"].shape[0], SU)
    assert dbi.shape == (g["sa"].shape[0], SI)
    torch.testing.assert_close(dbu.sum(), dbi.sum(), rtol=1e-5, atol=1e-3)
    a = pk_t.plain_tables(tm, SU, SI, "cpu")
    b = pk_t.plain_tables(tm, SU, SI, "cpu")
    for x in (a[2], a[3]):
        x.zero_()
    dense_phase_plain(a[0], a[1][seg], g, LR, REG, tm.mu, su=SU, si=SI,
                      bias="frozen", bu=a[2], bi=a[3][seg])
    dense_phase_plain(b[0], b[1][seg], g, LR, REG, tm.mu, su=SU, si=SI,
                      bias="none")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_is_the_plain_version_and_checks_its_biases():
    coo = _coo(0.5)
    _, (meta, groups, _, _) = _preps(coo, 64, "int4")
    model = _model(coo, 64)
    a, sa = _port(model, meta, groups, True)
    b, sb = _port(model, meta, groups, True, phase=dense_phase_plain)
    assert sa == sb and all(torch.equal(a[k], b[k]) for k in KEYS)
    (win0, nw), g = meta[0], groups[0]
    P, Q = torch.zeros(SU * 3, 64), torch.zeros(nw * SI, 64)
    bu, bi = torch.zeros(SU * 3), torch.zeros(nw * SI)
    for kw in (dict(bias="frozen"), dict(bias="none", bu=bu, bi=bi),
               dict(bias="frozen", bu=bu[:5], bi=bi), dict(bias="tile")):
        with pytest.raises((ValueError, TypeError)):
            dense_phase(P, Q, g, LR, REG, 3.5, su=SU, si=SI, **kw)
