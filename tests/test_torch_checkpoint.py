"""The port's checkpoints: bitwise round trip, files read by the reference's
``load_checkpoint`` and the reference's files read by the port, the
data-version warning, and the driver's checkpoint cadence and refusal to
resume."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfx.train.checkpoint as ckpt_j
from mfx.config import apply_overrides, preset
from mfx.data.loaders import GENERATOR_VERSION
from mfx.models import init_model as init_model_j
from mfx.models.mf import MFModel as JMFModel
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.models.mf import MFModel
from mfx_torch.train.checkpoint import (latest_step, load_checkpoint,
                                        save_checkpoint)

KEYS = ("P", "Q", "bu", "bi", "mu")


def _model(seed=0, U=50, I=40, r=8):
    rng = np.random.default_rng(seed)
    return model_from_numpy({
        "P": rng.normal(0, 1, (U, r)), "Q": rng.normal(0, 1, (I, r)),
        "bu": rng.normal(0, 0.2, U), "bi": rng.normal(0, 0.2, I),
        "mu": np.float32(3.25),
    })


def _equal(a: dict, b: dict):
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_round_trip_is_bitwise(tmp_path):
    m = _model()
    path = save_checkpoint(tmp_path, 3, m, seed=7)
    assert path == str(tmp_path / "3")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3.npz"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a current stamp warns nothing
        got, epoch, seed = load_checkpoint(tmp_path)
    assert (epoch, seed) == (3, 7)
    _equal(model_to_numpy(got), model_to_numpy(m))
    assert got.P.dtype == torch.float32 and isinstance(got.mu, float)


def test_reference_reads_the_ports_checkpoint(tmp_path):
    m = _model(1)
    save_checkpoint(tmp_path, 5, m, seed=2)
    jm, epoch, seed = ckpt_j.load_checkpoint(tmp_path)
    assert (epoch, seed) == (5, 2)
    _equal({k: getattr(jm, k) for k in KEYS}, model_to_numpy(m))


def test_port_reads_the_references_files(tmp_path):
    """The reference's checkpoint (Orbax when it imports, else npz) and
    its ``save_npz`` export. An Orbax directory is refused with the way
    across: ``mfx.cli export``."""
    jm = init_model_j(4, 30, 20, 8, global_mean=3.0)
    want = {k: np.asarray(getattr(jm, k)) for k in KEYS}
    ckpt_j.save_checkpoint(tmp_path / "ck", 2, jm, seed=9)
    if (tmp_path / "ck" / "2").is_dir():
        with pytest.raises(ValueError, match="mfx.cli export"):
            load_checkpoint(tmp_path / "ck")
    else:
        got, epoch, seed = load_checkpoint(tmp_path / "ck")
        assert (epoch, seed) == (2, 9)
        _equal(model_to_numpy(got), want)
    jm.save_npz(tmp_path / "model.npz")
    _equal(model_to_numpy(MFModel.load_npz(tmp_path / "model.npz")), want)


def test_latest_step(tmp_path):
    assert latest_step(tmp_path / "missing") is None
    assert latest_step(tmp_path) is None
    for step in (0, 12, 3):
        save_checkpoint(tmp_path, step, _model())
    (tmp_path / "notes.txt").write_text("x")
    assert latest_step(tmp_path) == 12
    assert load_checkpoint(tmp_path)[1] == 12
    assert load_checkpoint(tmp_path, step=3)[1] == 3
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "missing")


@pytest.mark.parametrize("stamp", [None, GENERATOR_VERSION - 1])
def test_data_version_mismatch_warns_like_the_reference(tmp_path, stamp):
    state = {k: np.asarray(v) for k, v in model_to_numpy(_model()).items()}
    state.update(epoch=np.int32(1), seed=np.int32(0))
    if stamp is not None:
        state["data_version"] = np.int32(stamp)
    np.savez(tmp_path / "1.npz", **state)
    messages = []
    for load in (load_checkpoint, ckpt_j.load_checkpoint):
        with pytest.warns(UserWarning, match="generator") as rec:
            load(tmp_path)
        messages.append(str(rec[0].message))
    assert messages[0] == messages[1]


def _small_cfg(tmp_path, ckpt, every):
    return apply_overrides(preset("ml25m_rank64"), [
        "data.dataset=synthetic-small", f"data.root={tmp_path}",
        "sgd.ublock=256", "sgd.iblock=256", "sgd.tile=64", "sgd.epochs=3",
        "sgd.dense_chi=0.01", "sgd.dense_int4=on", "target_rmse=0.0",
        f"checkpoint_dir={ckpt}", f"checkpoint_every={every}",
    ])


def test_driver_checkpoints_and_refuses_to_resume(tmp_path):
    from mfx_torch.train.driver import train

    ckpt = tmp_path / "ckpt"
    res = train(_small_cfg(tmp_path, ckpt, every=2), device="cpu")
    assert res.epochs_run == 3
    # epoch 1 (every 2nd) and the final epoch 2
    assert sorted(p.name for p in ckpt.iterdir()) == ["1.npz", "2.npz"]
    got, epoch, _ = load_checkpoint(ckpt)
    assert epoch == 2
    _equal(model_to_numpy(got), model_to_numpy(res.model))
    jm, _, _ = ckpt_j.load_checkpoint(ckpt)
    assert isinstance(jm, JMFModel) and jnp.allclose(jm.P, res.model.P.numpy())
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        train(_small_cfg(tmp_path, ckpt, every=0), device="cpu")
    res2 = train(_small_cfg(tmp_path, ckpt, every=0), device="cpu",
                 resume=False)
    assert res2.epochs_run == 3 and latest_step(ckpt) == 2
