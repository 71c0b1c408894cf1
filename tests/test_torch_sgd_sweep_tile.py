"""The port's tile-bias sparse sweep (plain version of the sgd_sweep_tile
kernel) against the reference Pallas kernel with ``bias_mode='tile'`` in
interpret mode, on the same tile plan and the same initial tables. The
helpers here also serve tests/test_torch_sgd_sweep_step_u.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import epoch_permutation, synthetic
from mfx.kernels import blocked_host as bh
from mfx.kernels import packing as pk
from mfx.kernels.sgd_pallas import blocked_sgd_sweep_pallas
from mfx.models import init_model
from mfx.models.mf import MFModel as JMFModel
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels import packing as pk_t
from mfx_torch.kernels.sgd_sweep import sgd_sweep_tile, sgd_sweep_tile_plain

U, I, N = 300, 260, 3000
SU = SI = 128
T, NWIN = 32, 2
LR, REG = 0.05, 0.02
KEYS = ("P", "Q", "bu", "bi")


def sweep_case(rank, tpg):
    """(plans, model): the reference tests' geometry (su = si = 128,
    T = 32, two windows a sweep) on a 300 x 260 x 3000 synthetic, with
    numpy-seeded biases so that the bias terms are live."""
    coo = synthetic.make_synthetic(U, I, N, seed=5)
    plans = bh.build_sweep_plans(coo.user, coo.item, coo.rating, U, I, SU, SI,
                                 T, tpg, NWIN, epoch_permutation(N, 0, 0))
    rng = np.random.default_rng(rank + tpg)
    m = init_model(2, U, I, rank, global_mean=coo.global_mean)
    model = JMFModel(
        P=m.P, Q=m.Q, bu=jnp.asarray(rng.normal(0, 0.1, U), jnp.float32),
        bi=jnp.asarray(rng.normal(0, 0.1, I), jnp.float32), mu=m.mu)
    return plans, model


def run_reference(plans, model, rank, tpg, use_bias, step_u=False):
    """The Pallas sweeps in interpret mode; returns (tables, sse)."""
    Pm, Qm = pk.pack_state(model, SU, SI)
    sse = 0.0
    for p in plans:
        Qs = pk.q_segment(Qm, p.win0, p.nwin, rank, SI)
        Pm, Qs, s = blocked_sgd_sweep_pallas(
            Pm, Qs, pk.sweep_arrays(p), LR, REG, float(model.mu), su=SU,
            si=SI, rank=rank, tpg=tpg, use_bias=use_bias, exact=True,
            interpret=True, bias_mode="tile", step_u=step_u)
        Qm = pk.q_segment_restore(Qm, Qs, p.win0, rank, SI)
        sse += float(s[0, 0])
    got = pk.unpack_state(Pm, Qm, model.mu, U, I, rank, SU, SI)
    return {k: np.asarray(getattr(got, k)) for k in KEYS}, sse


def run_port(fn, plans, model, tpg, use_bias):
    """The port's sweep ``fn`` on CPU tensors; returns (padded tables,
    sse)."""
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in KEYS + ("mu",)}, device="cpu")
    P, Q, bu, bi = pk_t.plain_tables(tm, SU, SI, "cpu")
    sse = 0.0
    for p in plans:
        seg = slice(p.win0 * SI, (p.win0 + p.nwin) * SI)
        sse += float(fn(
            P, Q[seg], bu, bi[seg], torch.as_tensor(p.sa),
            torch.as_tensor(p.tc), torch.as_tensor(p.tl), LR, REG,
            float(model.mu), su=SU, si=SI, tpg=tpg, use_bias=use_bias))
    return {"P": P, "Q": Q, "bu": bu, "bi": bi}, sse


def assert_tables_close(got, ref, atol):
    for k, rows in zip(KEYS, (U, I, U, I)):
        np.testing.assert_allclose(got[k][:rows].numpy(), ref[k], rtol=0,
                                   atol=atol, err_msg=k)


def touched_rows(plans, tpg):
    """Boolean masks over the padded user and item rows: which rows a real
    slot of the plans addresses."""
    tu = np.zeros(-(-U // SU) * SU, bool)
    ti = np.zeros(-(-I // SI) * SI, bool)
    for p in plans:
        for t in range(p.num_tiles):
            real = p.tl[t, 0] < SU
            tu[p.sa[t // tpg] * SU + p.tl[t, 0][real]] = True
            ti[(p.win0 + p.tc[t]) * SI + p.tl[t, 1][real]] = True
    return tu, ti


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("rank", [32, 64])
def test_tile_sweep_matches_pallas_interpret(rank, use_bias):
    plans, model = sweep_case(rank, 4)
    ref, sse_j = run_reference(plans, model, rank, 4, use_bias)
    got, sse_t = run_port(sgd_sweep_tile, plans, model, 4, use_bias)
    # the reference's own tolerance against its oracle: the one-hot
    # matmuls and the 128-lane sums associate differently, f32 noise only
    assert_tables_close(got, ref, 2e-6)
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j
    moved = np.abs(ref["bu"] - np.asarray(model.bu)).max()
    assert (moved > 1e-4) == use_bias  # the biases train only when asked to


@pytest.mark.parametrize("rank", [32, 64])
def test_tile_sweep_pads_are_exact_noops(rank):
    plans, model = sweep_case(rank, 4)
    assert any((p.tl[:, 0] == SU).all(axis=1).any() for p in plans)  # pad tiles
    got, _ = run_port(sgd_sweep_tile, plans, model, 4, True)
    start, _ = run_port(lambda *a, **k: 0.0, plans, model, 4, True)
    tu, ti = touched_rows(plans, 4)
    assert tu.any() and not tu.all() and not ti.all()
    for k, mask in (("P", tu), ("bu", tu), ("Q", ti), ("bi", ti)):
        assert torch.equal(got[k][~mask], start[k][~mask]), k
        assert not torch.equal(got[k][mask], start[k][mask]), k


def test_tile_sweep_of_pad_tiles_changes_nothing():
    rank, tpg = 32, 4
    _, model = sweep_case(rank, tpg)
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in KEYS + ("mu",)}, device="cpu")
    state = pk_t.plain_tables(tm, SU, SI, "cpu")
    before = [x.clone() for x in state]
    tl = torch.empty(tpg, 3, T, dtype=torch.int32)
    tl[:, 0], tl[:, 1] = SU, SI
    tl[:, 2] = torch.full((T,), 9.75).view(torch.int32)  # must not be read
    sse = sgd_sweep_tile(*state, torch.zeros(1, dtype=torch.int32),
                         torch.zeros(tpg, dtype=torch.int32), tl, LR, REG,
                         3.5, su=SU, si=SI, tpg=tpg)
    assert float(sse) == 0.0
    for a, b in zip(state, before):
        assert torch.equal(a, b)


def test_tile_wrapper_is_the_plain_version_on_cpu_tensors():
    plans, model = sweep_case(32, 4)
    a, sa = run_port(sgd_sweep_tile, plans, model, 4, True)
    b, sb = run_port(sgd_sweep_tile_plain, plans, model, 4, True)
    assert sa == sb and all(torch.equal(a[k], b[k]) for k in KEYS)


@pytest.mark.parametrize("bad", ["bias_dtype", "bias_shape", "tl_shape",
                                 "device"])
def test_tile_wrapper_rejects_bad_inputs(bad):
    rank, tpg = 32, 4
    P, Q = torch.zeros(SU, rank), torch.zeros(SI, rank)
    bu, bi = torch.zeros(SU), torch.zeros(SI)
    sa = torch.zeros(1, dtype=torch.int32)
    tc = torch.zeros(tpg, dtype=torch.int32)
    tl = torch.zeros(tpg, 3, T, dtype=torch.int32)
    if bad == "bias_dtype":
        bu = bu.double()
    elif bad == "bias_shape":
        bi = torch.zeros(SI + 1)
    elif bad == "tl_shape":
        tl = torch.zeros(tpg, 2, T, dtype=torch.int32)
    else:
        P, Q, bu, bi, sa, tc, tl = (x.to("meta") for x in
                                    (P, Q, bu, bi, sa, tc, tl))
    with pytest.raises((TypeError, ValueError)):
        sgd_sweep_tile(P, Q, bu, bi, sa, tc, tl, LR, REG, 3.5, su=SU, si=SI,
                       tpg=tpg)
