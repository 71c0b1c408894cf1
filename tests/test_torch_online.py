"""Online updates of the port (``mfx_torch/train/online.py``) against
``mfx/train/online.py`` on the same tables and delta: ``grow_model``,
``partial_fit`` with the ``fixed`` partitioner (with ``dup_trust``, with a
replay sample, without fold-in); and the CLI's ``update``, ``datasets``
and ``presets`` against ``mfx.cli``."""

import contextlib
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfx.cli
from mfx.config import SGDConfig as SGDConfigJ
from mfx.data.coo import RatingsCOO as CooJ
from mfx.models.mf import MFModel as JMFModel
from mfx.train import checkpoint as ckpt_j
from mfx.train import online as online_j
from mfx_torch.config import SGDConfig
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.train import online
from mfx_torch.train.checkpoint import load_checkpoint, save_checkpoint

KEYS = ("P", "Q", "bu", "bi")
U, I, RANK = 60, 80, 8
NEW_U, NEW_I = 5, 4


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return {"P": rng.normal(0, 0.3, (U, RANK)).astype(np.float32),
            "Q": rng.normal(0, 0.3, (I, RANK)).astype(np.float32),
            "bu": rng.normal(0, 0.1, U).astype(np.float32),
            "bi": rng.normal(0, 0.1, I).astype(np.float32),
            "mu": np.float32(3.5)}


def _delta(n, seed, users=U + NEW_U, items=I + NEW_I):
    """A seeded delta whose ids reach NEW_U new users and NEW_I new items,
    each of which has ratings."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users, n).astype(np.int32)
    i = rng.integers(0, items, n).astype(np.int32)
    u[:NEW_U] = np.arange(U, U + NEW_U)
    i[NEW_U:NEW_U + NEW_I] = np.arange(I, I + NEW_I)
    r = rng.integers(1, 6, n).astype(np.float32)
    return u, i, r, users, items


def _coos(u, i, r, users, items):
    return (RatingsCOO(user=u, item=i, rating=r, num_users=users,
                       num_items=items),
            CooJ(user=u, item=i, rating=r, num_users=users, num_items=items))


def _jax(arrays):
    return JMFModel(**{k: jnp.asarray(arrays[k]) for k in KEYS},
                    mu=jnp.asarray(arrays["mu"], jnp.float32))


def _close(tm, jm, atol):
    for k in KEYS:
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=0,
                                   atol=atol, err_msg=k)


def test_grow_model_matches_the_reference():
    arrays = _tables()
    tm = model_from_numpy(arrays, device="cpu")
    jm = _jax(arrays)
    got = online.grow_model(tm, U + 3, I + 7)
    want = online_j.grow_model(jm, U + 3, I + 7)
    _close(got, want, 0)
    assert online.grow_model(tm) is tm
    assert online.grow_model(tm, U + 3).num_items == I
    for mod, m in ((online, tm), (online_j, jm)):
        with pytest.raises(ValueError, match="cannot shrink"):
            mod.grow_model(m, U - 1, I)


CASES = {
    "fixed": dict(dup_trust=0.0),
    "dup_trust": dict(dup_trust=16.0),
    "replay": dict(dup_trust=16.0, replay=True),
    "no_foldin": dict(dup_trust=16.0, foldin_new=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_partial_fit_matches_the_reference(case):
    """Grow, fold in the new rows, then 2 epochs of fixed-partitioner SGD
    (batches of 128 over a 600-rating delta, duplicate rows within a
    batch): tables within 1e-5 and the train RMSE within 1e-5 of the
    reference's."""
    kw = dict(CASES[case])
    cfg_kw = dict(lr=0.02, reg=0.02, epochs=2, batch_size=128,
                  partitioner="fixed", dup_trust=kw.pop("dup_trust"))
    arrays = _tables(1)
    delta_t, delta_j = _coos(*_delta(600, 2))
    rt = rj = None
    if kw.pop("replay", False):
        rng = np.random.default_rng(3)
        ru = rng.integers(0, U, 300).astype(np.int32)
        ri = rng.integers(0, I, 300).astype(np.int32)
        rr = rng.integers(1, 6, 300).astype(np.float32)
        rt, rj = _coos(ru, ri, rr, U, I)
    got, tr_t = online.partial_fit(
        model_from_numpy(arrays, device="cpu"), delta_t,
        SGDConfig(**cfg_kw), seed=4, replay=rt, **kw)
    want, tr_j = online_j.partial_fit(_jax(arrays), delta_j,
                                      SGDConfigJ(**cfg_kw), seed=4,
                                      replay=rj, **kw)
    assert got.P.shape == (U + NEW_U, RANK) and got.Q.shape == (I + NEW_I,
                                                                 RANK)
    _close(got, want, 1e-5)
    assert abs(tr_t - tr_j) <= 1e-5


def test_partial_fit_without_epochs_folds_in_only():
    arrays = _tables(1)
    delta_t, delta_j = _coos(*_delta(200, 5))
    cfg = dict(lr=0.02, reg=0.02, epochs=0, batch_size=64,
               partitioner="fixed")
    got, tr = online.partial_fit(model_from_numpy(arrays, device="cpu"),
                                 delta_t, SGDConfig(**cfg))
    want, _ = online_j.partial_fit(_jax(arrays), delta_j, SGDConfigJ(**cfg))
    assert tr != tr  # nan: no epoch ran
    _close(got, want, 1e-5)
    # existing rows are untouched by fold-in alone
    np.testing.assert_array_equal(got.P[:U].numpy(), arrays["P"])
    with pytest.raises(ValueError, match="non-empty"):
        online.partial_fit(
            model_from_numpy(arrays, device="cpu"),
            dataclasses.replace(delta_t, user=delta_t.user[:0],
                                item=delta_t.item[:0],
                                rating=delta_t.rating[:0]),
            SGDConfig(**cfg))


def test_histories_for_new_match_the_reference():
    u, i, r, _, _ = _delta(300, 6)
    for first in (U, U + 2, U + NEW_U):
        a = online._histories_for_new(u, i, r, first)
        b = online_j._histories_for_new(u, i, r, first)
        np.testing.assert_array_equal(a[0], b[0])
        assert len(a[1]) == len(b[1])
        for (x1, y1), (x2, y2) in zip(a[1], b[1]):
            np.testing.assert_array_equal(x1, x2)
            np.testing.assert_array_equal(y1, y2)


def _run(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(args) == 0
    return buf.getvalue()


def test_cli_update_prints_the_references_json(tmp_path):
    """``update`` over a checkpoint the port wrote and a delta .npz: the
    reference's JSON line (train RMSE within 1e-5), the grown tables
    within 1e-5 of the reference's, written as a new step."""
    from mfx_torch.cli import main

    arrays = _tables(7)
    ckpt = tmp_path / "ckpt"
    save_checkpoint(ckpt, 4, model_from_numpy(arrays, device="cpu"), seed=3)
    delta_t, _ = _coos(*_delta(400, 8))
    delta_t.save_npz(tmp_path / "delta.npz")
    flags = ["--delta", str(tmp_path / "delta.npz"), "--epochs", "2",
             "--batch-size", "256"]
    got = json.loads(_run(main, ["update", "--checkpoint", str(ckpt),
                                 "--out", str(tmp_path / "t"), *flags,
                                 "--device", "cpu"]))
    want = json.loads(_run(mfx.cli.main, [
        "update", "--checkpoint", str(ckpt), "--out", str(tmp_path / "j"),
        *flags]))
    assert set(got) == set(want)
    for k in ("step", "delta_ratings", "grew_users", "grew_items"):
        assert got[k] == want[k], k
    assert (got["grew_users"], got["grew_items"]) == (NEW_U, NEW_I)
    assert got["step"] == 5
    assert abs(got["train_rmse"] - want["train_rmse"]) <= 1e-5
    tm, epoch, seed = load_checkpoint(tmp_path / "t", device="cpu")
    jm, _, _ = ckpt_j.load_checkpoint(tmp_path / "j")
    assert (epoch, seed) == (5, 3)
    _close(tm, jm, 1e-5)
    # without --out the step is appended to the checkpoint directory
    again = json.loads(_run(main, ["update", "--checkpoint", str(ckpt),
                                   *flags, "--no-foldin", "--device",
                                   "cpu"]))
    assert again["step"] == 5 and again["checkpoint"] == str(ckpt)
    assert load_checkpoint(ckpt, device="cpu")[1] == 5
    assert model_to_numpy(load_checkpoint(ckpt, 4, device="cpu")[0])[
        "P"].shape == (U, RANK)


@pytest.mark.parametrize("cmd", ["datasets", "presets"])
def test_cli_lists_print_the_references_text(cmd):
    from mfx_torch.cli import main

    assert _run(main, [cmd]) == _run(mfx.cli.main, [cmd])
