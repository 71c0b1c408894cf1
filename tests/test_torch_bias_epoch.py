"""``bias_mode='epoch'``: the port's planner slots and its epoch-form sweep
(the plain version of the ``sgd_sweep_epoch`` kernel) against the
reference's ``epoch_tiles_device(with_slots=True)`` and
``blocked_sgd_sweep_pallas(bias_mode='epoch')`` in interpret mode, on the
reference test's shapes (tests/unit/test_bias_epoch.py: 300 x 260, su =
si = 128, T = 64, tpg 4), from the same tables and plan bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import synthetic
from mfx.kernels import packing as pk
from mfx.kernels import plan_device as pdv_j
from mfx.kernels.sgd_pallas import blocked_sgd_sweep_pallas
from mfx.models import init_model
from mfx.models.mf import MFModel as JMFModel
from mfx.solvers.blocked import sweep_geometry
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels import packing as pk_t
from mfx_torch.kernels import plan_device as pdv
from mfx_torch.kernels.sgd_sweep import (sgd_sweep_epoch,
                                         sgd_sweep_epoch_plain,
                                         sgd_sweep_tile)

U, I = 300, 260
SU = SI = 128
TILE, TPG = 64, 4
LR, REG = 0.02, 0.01
KEYS = ("P", "Q", "bu", "bi")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(seed, epoch, n):
    key = jax.random.fold_in(jax.random.key(seed), epoch)
    return torch.as_tensor(np.array(
        jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)))


def _case(rank, zero_bias=False):
    """(coo, reference model, reference plan + slots, port plan + slots),
    the two plans from the same bits."""
    coo = synthetic.make_synthetic(U, I, 9_000, rank=4, noise=0.3, seed=4)
    rng = np.random.default_rng(rank)
    m = init_model(2, U, I, rank, global_mean=coo.global_mean)
    b = (np.zeros, np.zeros) if zero_bias else (
        lambda n: rng.normal(0, 0.1, n), lambda n: rng.normal(0, 0.1, n))
    model = JMFModel(P=m.P, Q=m.Q, bu=jnp.asarray(b[0](U), jnp.float32),
                     bi=jnp.asarray(b[1](I), jnp.float32), mu=m.mu)
    nwin = sweep_geometry(I, rank, SI)
    u, i, r = (jnp.asarray(x) for x in (coo.user, coo.item, coo.rating))
    skel_j = pdv_j.build_plan_skeleton(u, i, U, I, SU, SI, TILE, TPG, nwin)
    plan_j = pdv_j.epoch_tiles_device(skel_j, u, i, r, 0, 0, with_slots=True)
    ut, it_, rt = (torch.as_tensor(x) for x in (coo.user, coo.item,
                                                 coo.rating))
    skel = pdv.build_plan_skeleton(ut, it_, U, I, SU, SI, TILE, TPG, nwin)
    plan = pdv.epoch_tiles_device(skel, ut, it_, rt, 0, 0,
                                  rand=_bits(0, 0, coo.n_ratings),
                                  with_slots=True)
    return coo, model, (skel_j, plan_j), (skel, plan)


def _run_reference(model, skel_j, plan_j, rank):
    """The reference's epoch-mode sweeps, its bias stream built as its
    trainer builds it: (tables, residuals (NT, T), sse)."""
    tl, d, u_s, i_s = plan_j
    Pm, Qm = pk.pack_state(model, SU, SI)
    b_r = model.bu[u_s] + model.bi[i_s]
    nt = tl.shape[0]
    bt = jnp.zeros((nt * TILE,), jnp.float32).at[d].set(b_r).reshape(
        nt, 1, TILE)
    es, sse = [], 0.0
    for p in (p for p in skel_j.sweeps if p.t1 > p.t0):
        arrs = {"sa": p.sa, "tc": p.tc, "tl": tl[p.t0:p.t1],
                "bt": bt[p.t0:p.t1]}
        Qs = pk.q_segment(Qm, p.win0, p.nwin, rank, SI)
        Pm, Qs, e, s = blocked_sgd_sweep_pallas(
            Pm, Qs, arrs, LR, REG, float(model.mu), su=SU, si=SI, rank=rank,
            tpg=TPG, use_bias=True, bias_mode="epoch", interpret=True,
            exact=True)
        Qm = pk.q_segment_restore(Qm, Qs, p.win0, rank, SI)
        es.append(np.asarray(e).reshape(-1, TILE))
        sse += float(s[0, 0])
    got = pk.unpack_state(Pm, Qm, model.mu, U, I, rank, SU, SI)
    return ({k: np.asarray(getattr(got, k)) for k in KEYS},
            np.concatenate(es), sse)


def _run_port(fn, model, skel, tl, **kw):
    """``fn`` (the epoch form, or with ``e=None`` the tile form) over the
    sweeps on CPU tensors: (padded tables, residuals, sse)."""
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in KEYS + ("mu",)}, device="cpu")
    P, Q, bu, bi = pk_t.plain_tables(tm, SU, SI, "cpu")
    e_all = torch.full((skel.nt_total, TILE), 9.0)
    sse = 0.0
    for sw in (s for s in skel.sweeps if s.t1 > s.t0):
        seg = slice(sw.win0 * SI, (sw.win0 + sw.nwin) * SI)
        args = (P, Q[seg], bu, bi[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1])
        if fn is sgd_sweep_tile:
            s = fn(*args, LR, REG, float(model.mu), su=SU, si=SI, tpg=TPG,
                   **kw)
        else:
            s = fn(*args, e_all[sw.t0:sw.t1], LR, REG, float(model.mu),
                   su=SU, si=SI, tpg=TPG)
        sse += float(s)
    return {"P": P, "Q": Q, "bu": bu, "bi": bi}, e_all, sse


@pytest.mark.parametrize("rank", [32, 64, 128])
def test_slots_match_the_reference(rank):
    """``with_slots=True`` gives the reference's tiles, slot of each
    sorted rating and sorted global ids under the same plan bits, and the
    slots cover every rating once."""
    coo, _, (_, (tl_j, d_j, u_j, i_j)), (skel, (tl, d, u_s, i_s)) = _case(
        rank)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(tl_j))
    for a, b in ((d, d_j), (u_s, u_j), (i_s, i_j)):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert d.shape[0] == coo.n_ratings and bool((d[1:] > d[:-1]).all())
    assert int(d.max()) < skel.nt_total * TILE
    flat = tl.permute(0, 2, 1).reshape(-1, 3)  # (slot, row)
    np.testing.assert_array_equal(flat[d, 0].numpy(), u_s.numpy() % SU)
    np.testing.assert_array_equal(flat[d, 1].numpy(), i_s.numpy() % SI)
    real = torch.zeros(skel.nt_total * TILE, dtype=torch.bool)
    real[d] = True
    assert bool((flat[:, 0][real] < SU).all())
    assert bool((flat[:, 0][~real] == SU).all())


@pytest.mark.parametrize("rank", [32, 64, 128, 16, 8, 4, 2, 1])
def test_epoch_sweep_matches_pallas_interpret(rank):
    """Non-zero biases: the tables and each slot's residual within 1e-4
    (the rank-64 tolerance of tests/test_torch_slice.py: the reference's
    dot sums 128 lanes where the port sums the rank's), the biases
    untouched, and pad slots exactly 0 in both."""
    coo, model, (skel_j, plan_j), (skel, (tl, d, _, _)) = _case(rank)
    ref, e_j, sse_j = _run_reference(model, skel_j, plan_j, rank)
    got, e_t, sse_t = _run_port(sgd_sweep_epoch, model, skel, tl)
    for k, rows in zip(KEYS, (U, I, U, I)):
        np.testing.assert_allclose(got[k][:rows].numpy(), ref[k], rtol=0,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["bu"][:U].numpy(),
                                  np.asarray(model.bu))
    np.testing.assert_array_equal(got["bi"][:I].numpy(),
                                  np.asarray(model.bi))
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=0, atol=1e-4)
    pads = torch.ones(e_t.numel(), dtype=torch.bool)
    pads[d] = False
    assert bool((e_t.view(-1)[pads] == 0).all())
    assert (e_j.reshape(-1)[pads.numpy()] == 0).all()
    assert np.isfinite(e_t.view(-1)[d].numpy()).all()
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j
    assert float(e_t.view(-1)[d].abs().max()) > 0.1


@pytest.mark.parametrize("rank", [32, 64, 128])
def test_zero_biases_give_the_bias_free_tile_sweep_bitwise(rank):
    """The reference's own identity (tests/unit/test_bias_epoch.py): with
    all biases 0 the epoch form's factor updates are the bias-free tile
    form's, bit for bit, and so is the SSE."""
    _, model, _, (skel, (tl, _, _, _)) = _case(rank, zero_bias=True)
    a, _, sse_a = _run_port(sgd_sweep_epoch, model, skel, tl)
    b, _, sse_b = _run_port(sgd_sweep_tile, model, skel, tl, use_bias=False)
    assert sse_a == sse_b
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k


def test_pad_tiles_change_nothing_and_write_zero_residuals():
    rank = 32
    _, model, _, _ = _case(rank)
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in KEYS + ("mu",)}, device="cpu")
    state = pk_t.plain_tables(tm, SU, SI, "cpu")
    before = [x.clone() for x in state]
    tl = torch.empty(TPG, 3, TILE, dtype=torch.int32)
    tl[:, 0], tl[:, 1] = SU, SI
    tl[:, 2] = torch.full((TILE,), 9.75).view(torch.int32)
    e = torch.full((TPG, TILE), 5.0)
    sse = sgd_sweep_epoch(*state, torch.zeros(1, dtype=torch.int32),
                          torch.zeros(TPG, dtype=torch.int32), tl, e, LR,
                          REG, 3.5, su=SU, si=SI, tpg=TPG)
    assert float(sse) == 0.0 and bool((e == 0).all())
    for x, y in zip(state, before):
        assert torch.equal(x, y)


def test_epoch_wrapper_is_the_plain_version_and_checks_its_output():
    _, model, _, (skel, (tl, _, _, _)) = _case(32)
    a, ea, sa = _run_port(sgd_sweep_epoch, model, skel, tl)
    b, eb, sb = _run_port(sgd_sweep_epoch_plain, model, skel, tl)
    assert sa == sb and torch.equal(ea, eb)
    assert all(torch.equal(a[k], b[k]) for k in KEYS)
    P, Q = torch.zeros(SU, 32), torch.zeros(SI, 32)
    bu, bi = torch.zeros(SU), torch.zeros(SI)
    z1 = torch.zeros(1, dtype=torch.int32)
    zt = torch.zeros(TPG, dtype=torch.int32)
    tl = torch.zeros(TPG, 3, TILE, dtype=torch.int32)
    for bad in (torch.zeros(TPG, TILE + 1), torch.zeros(TPG, TILE).double()):
        with pytest.raises(ValueError, match="e_out"):
            sgd_sweep_epoch(P, Q, bu, bi, z1, zt, tl, bad, LR, REG, 3.5,
                            su=SU, si=SI, tpg=TPG)


@pytest.mark.parametrize("bias,row_bytes,slot_ops", [
    (None, 0, 0), ("update", 8, 6), ("read", 4, 2)])
def test_sweep_bound_counts_the_bias_traffic_of_each_form(
        bias, row_bytes, slot_ops, monkeypatch):
    """``chip_smoke.sweep_bound``'s bias modes: the tile form reads and
    writes a 4-byte bias a distinct row and does 6 more operations a real
    slot; the epoch form only reads it and does 2 (bu + bi and its add);
    the bias-free form neither."""
    import chip_smoke as cs

    _, _, _, (skel, (tl, _, _, _)) = _case(64)
    sw = next(s for s in skel.sweeps if s.t1 > s.t0)
    t = tl[sw.t0:sw.t1]
    args = (t, sw.sa, sw.tc, SU, SI, TPG, 64, [("P", 0), ("Q", 1)], 10)
    base_ms, by = cs.sweep_bound(*args)
    assert by == "bytes"
    ms, _ = cs.sweep_bound(*args, bias=bias)
    real = t[:, 0, :] < SU
    t_of = torch.arange(t.shape[0])[:, None].expand_as(real)
    n_rows = (torch.unique((sw.sa.long()[t_of // TPG] * SU
                            + t[:, 0, :].long())[real]).numel()
              + torch.unique((sw.tc.long()[t_of] * SI
                              + t[:, 1, :].long())[real]).numel())
    assert (ms - base_ms) * 1e-3 * cs.PEAK_BYTES == pytest.approx(
        row_bytes * n_rows, rel=1e-9, abs=1e-6)
    # with memory taken out, the operations: 10 a lane and the bias's own
    monkeypatch.setattr(cs, "PEAK_BYTES", float("inf"))
    ops_ms, ops_by = cs.sweep_bound(*args, bias=bias)
    assert ops_by == "operations"
    assert ops_ms == pytest.approx(
        (10 * 64 + slot_ops) * int(real.sum()) / cs.PEAK_F32 * 1e3,
        rel=1e-12)
