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
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.eval.metrics import rmse, rmse_mae
from mfx_torch.kernels import packing as pk_t
from mfx_torch.models.mf import MFModel, init_model

U, I, RANK = 300, 260, 64


def _jax_model(seed=2):
    rng = np.random.default_rng(seed)
    m = init_model_j(seed, U, I, RANK, global_mean=3.4)
    return JMFModel(P=m.P, Q=m.Q,
                    bu=jnp.asarray(rng.normal(0, 0.2, U), jnp.float32),
                    bi=jnp.asarray(rng.normal(0, 0.2, I), jnp.float32),
                    mu=m.mu)


def _np(m):
    return {k: np.asarray(getattr(m, k)) for k in ("P", "Q", "bu", "bi", "mu")}


def test_convert_round_trip_is_exact():
    arrays = _np(_jax_model())
    t = model_from_numpy(arrays)
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
        got = model_to_numpy(MFModel.load_npz(path))
        want = _np(jm)
    else:
        tm = model_from_numpy(_np(jm))
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


def test_lane_layout_matches_reference():
    jm = _jax_model(4)
    tm = model_from_numpy(_np(jm))
    lane_j, lane_t = pk.to_lane_model(jm), pk_t.to_lane_model(tm)
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_array_equal(getattr(lane_t, k).numpy(),
                                      np.asarray(getattr(lane_j, k)), err_msg=k)
    back_j, back_t = pk.from_lane_model(lane_j), pk_t.from_lane_model(lane_t)
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_array_equal(getattr(back_t, k).numpy(),
                                      np.asarray(getattr(back_j, k)), err_msg=k)


def test_lane_tables_pad_to_whole_blocks():
    tm = model_from_numpy(_np(_jax_model(6)))
    P, Q = pk_t.lane_tables(tm, 128, 256, "cpu")
    assert P.shape == (384, RANK) and Q.shape == (512, RANK)
    assert float(P[U:].abs().sum()) == 0 and float(Q[I:].abs().sum()) == 0
    np.testing.assert_array_equal(P[:U, RANK - 1].numpy(), tm.bu.numpy())
    np.testing.assert_array_equal(Q[:I, RANK - 2].numpy(), tm.bi.numpy())


@pytest.mark.parametrize("clip", [None, (0.5, 5.0)])
def test_rmse_mae_matches_reference(clip):
    coo = synthetic.make_synthetic(U, I, 20_000, rank=4, noise=0.3, seed=9,
                                   star_step=0.5)
    _, test = train_test_split(coo, test_frac=0.1, seed=0)
    jm = _jax_model(7)
    want = rmse_mae_j(jm, test, clip=clip)
    got = rmse_mae(model_from_numpy(_np(jm)), test, chunk=777, clip=clip)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert got[1] == pytest.approx(want[1], rel=1e-6)
    assert rmse(model_from_numpy(_np(jm)), test, clip=clip) == pytest.approx(
        want[0], rel=1e-6)


def test_predict_matches_reference():
    jm = _jax_model(8)
    tm = model_from_numpy(_np(jm))
    u = np.array([0, 5, 299, 17], np.int32)
    i = np.array([259, 0, 3, 17], np.int32)
    np.testing.assert_allclose(
        tm.predict(torch.as_tensor(u).long(), torch.as_tensor(i).long()).numpy(),
        np.asarray(jm.predict(jnp.asarray(u), jnp.asarray(i))), rtol=1e-6)
