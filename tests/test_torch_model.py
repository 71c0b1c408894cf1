"""The port's model state, conversion, lane layout and held-out metrics
against the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import synthetic, train_test_split
from mfx.eval.metrics import rmse_mae as rmse_mae_j
from mfx.kernels import packing as pk
from mfx.models import init_model as init_model_j
from mfx.models.mf import MFModel as JMFModel
from mfx_torch.convert import (merged_to_plain, model_from_numpy,
                               model_to_numpy, plain_to_merged)
from mfx_torch.eval.metrics import rmse, rmse_mae
from mfx_torch.kernels import packing as pk_t
from mfx_torch.models.mf import MFModel, init_model

U, I, RANK = 300, 260, 64


def _jax_model(seed=2, rank=RANK):
    rng = np.random.default_rng(seed)
    m = init_model_j(seed, U, I, rank, global_mean=3.4)
    return JMFModel(P=m.P, Q=m.Q,
                    bu=jnp.asarray(rng.normal(0, 0.2, U), jnp.float32),
                    bi=jnp.asarray(rng.normal(0, 0.2, I), jnp.float32),
                    mu=m.mu)


def _np(m):
    return {k: np.asarray(getattr(m, k)) for k in ("P", "Q", "bu", "bi", "mu")}


@pytest.mark.parametrize("rank", [RANK, 128])
def test_convert_round_trip_is_exact(rank):
    arrays = _np(_jax_model(rank=rank))
    t = model_from_numpy(arrays, device="cpu")
    back = model_to_numpy(t)
    for k in ("P", "Q", "bu", "bi", "mu"):
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    assert back["mu"].dtype == np.float32 and t.P.dtype == torch.float32


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_npz_moves_between_packages(tmp_path, direction):
    path = tmp_path / "m.npz"
    jm = _jax_model(3)
    if direction == "jax_to_torch":
        jm.save_npz(path)
        got = model_to_numpy(MFModel.load_npz(path, device="cpu"))
        want = _np(jm)
    else:
        tm = model_from_numpy(_np(jm), device="cpu")
        tm.save_npz(path)
        got = _np(JMFModel.load_npz(path, device=False))
        want = model_to_numpy(tm)
    for k in ("P", "Q", "bu", "bi", "mu"):
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def test_init_model_scale_and_seed():
    g = torch.Generator().manual_seed(5)
    a = init_model(g, 2000, 1500, RANK, global_mean=3.5)
    b = init_model(torch.Generator().manual_seed(5), 2000, 1500, RANK,
                   global_mean=3.5)
    assert torch.equal(a.P, b.P) and torch.equal(a.Q, b.Q)
    assert a.P.shape == (2000, RANK) and a.Q.shape == (1500, RANK)
    assert float(a.P.std()) == pytest.approx(1 / np.sqrt(RANK), rel=0.02)
    assert float(a.bu.abs().sum()) == 0 and a.mu == 3.5


@pytest.mark.parametrize("rank", [RANK, 128])
def test_lane_layout_matches_reference(rank):
    jm = _jax_model(4, rank)
    tm = model_from_numpy(_np(jm), device="cpu")
    lane_j, lane_t = pk.to_lane_model(jm), pk_t.to_lane_model(tm)
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_array_equal(getattr(lane_t, k).numpy(),
                                      np.asarray(getattr(lane_j, k)), err_msg=k)
    back_j, back_t = pk.from_lane_model(lane_j), pk_t.from_lane_model(lane_t)
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_array_equal(getattr(back_t, k).numpy(),
                                      np.asarray(getattr(back_j, k)), err_msg=k)


@pytest.mark.parametrize("rank", [RANK, 128])
def test_lane_tables_pad_to_whole_blocks(rank):
    """Lanes rank-2 and rank-1 (126 and 127 at rank 128) carry P's constant
    1 and bu, Q's bi and constant 1."""
    tm = model_from_numpy(_np(_jax_model(6, rank)), device="cpu")
    P, Q = pk_t.lane_tables(tm, 128, 256, "cpu")
    assert P.shape == (384, rank) and Q.shape == (512, rank)
    assert float(P[U:].abs().sum()) == 0 and float(Q[I:].abs().sum()) == 0
    np.testing.assert_array_equal(P[:U, rank - 1].numpy(), tm.bu.numpy())
    np.testing.assert_array_equal(Q[:I, rank - 2].numpy(), tm.bi.numpy())
    np.testing.assert_array_equal(P[:U, rank - 2].numpy(), 1.0)
    np.testing.assert_array_equal(Q[:I, rank - 1].numpy(), 1.0)
    back = pk_t.from_lane_model(model_from_numpy(
        {"P": P[:U].numpy(), "Q": Q[:I].numpy(), "bu": np.zeros(U),
         "bi": np.zeros(I), "mu": tm.mu}, device="cpu"))
    assert torch.equal(back.bu, tm.bu) and torch.equal(back.bi, tm.bi)
    assert torch.equal(back.P[:, :rank - 2], tm.P[:, :rank - 2])


def test_plain_tables_pad_to_whole_blocks_and_slice_back():
    tm = model_from_numpy(_np(_jax_model(6)), device="cpu")
    P, Q, bu, bi = pk_t.plain_tables(tm, 128, 256, "cpu")
    assert P.shape == (384, RANK) and Q.shape == (512, RANK)
    assert bu.shape == (384,) and bi.shape == (512,)
    for x in (P, Q, bu, bi):
        assert x.is_contiguous() and x.dtype == torch.float32
    assert float(P[U:].abs().sum()) == 0 and float(bi[I:].abs().sum()) == 0
    for got, want in ((P[:U], tm.P), (Q[:I], tm.Q), (bu[:U], tm.bu),
                      (bi[:I], tm.bi)):
        assert torch.equal(got, want)
    P[0, 0] += 1.0  # fresh tensors: the model is not aliased
    assert not torch.equal(P[:U], tm.P)


@pytest.mark.parametrize("rank,su,si", [(32, 128, 256), (64, 256, 128),
                                        (128, 128, 128), (32, 512, 1024)])
def test_merged_layout_conversion_matches_reference(rank, su, si):
    rng = np.random.default_rng(rank)
    jm = JMFModel(P=jnp.asarray(rng.normal(0, 0.3, (U, rank)), jnp.float32),
                  Q=jnp.asarray(rng.normal(0, 0.3, (I, rank)), jnp.float32),
                  bu=jnp.asarray(rng.normal(0, 0.2, U), jnp.float32),
                  bi=jnp.asarray(rng.normal(0, 0.2, I), jnp.float32),
                  mu=jnp.float32(3.4))
    Pm, Qm = pk.pack_state(jm, su, si)
    plain = merged_to_plain(np.asarray(Pm), np.asarray(Qm), rank, su, si)
    want = pk_t.plain_tables(model_from_numpy(_np(jm), device="cpu"), su, si, "cpu")
    for got, w in zip(plain, want):
        assert torch.equal(got, w)
    # and back: the reference unpacks what the port packed
    P, Q, bu, bi = (x + 0.5 for x in plain)
    Pm2, Qm2 = plain_to_merged(P, Q, bu, bi, su, si)
    assert Pm2.shape == Pm.shape and Qm2.shape == Qm.shape
    back = pk.unpack_state(jnp.asarray(Pm2), jnp.asarray(Qm2), jm.mu, U, I,
                           rank, su, si)
    for k, x in (("P", P[:U]), ("Q", Q[:I]), ("bu", bu[:U]), ("bi", bi[:I])):
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), x.numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("clip", [None, (0.5, 5.0)])
def test_rmse_mae_matches_reference(clip):
    coo = synthetic.make_synthetic(U, I, 20_000, rank=4, noise=0.3, seed=9,
                                   star_step=0.5)
    _, test = train_test_split(coo, test_frac=0.1, seed=0)
    jm = _jax_model(7)
    want = rmse_mae_j(jm, test, clip=clip)
    got = rmse_mae(model_from_numpy(_np(jm), device="cpu"), test, chunk=777, clip=clip)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert got[1] == pytest.approx(want[1], rel=1e-6)
    assert rmse(model_from_numpy(_np(jm), device="cpu"), test, clip=clip) == pytest.approx(
        want[0], rel=1e-6)


def test_predict_matches_reference():
    jm = _jax_model(8)
    tm = model_from_numpy(_np(jm), device="cpu")
    u = np.array([0, 5, 299, 17], np.int32)
    i = np.array([259, 0, 3, 17], np.int32)
    np.testing.assert_allclose(
        tm.predict(torch.as_tensor(u).long(), torch.as_tensor(i).long()).numpy(),
        np.asarray(jm.predict(jnp.asarray(u), jnp.asarray(i))), rtol=1e-6)
