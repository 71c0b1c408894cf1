"""bf16 factor tables (``model.dtype='bfloat16'``) and ``profile_phases``
in the port, against the reference on the CPU.

bf16 minibatch epochs: the port's trainer against the reference's
``kernel='jnp'`` trainer from the same bf16 tables, conflict-free and
fixed batches (duplicates, with and without ``dup_trust``), 3 epochs.
Tolerance: 0 bf16 ulps on every table (bitwise). The port reproduces
each rounding of the reference's compiled step on the CPU (the products
summed in f32, the dot and every add but the last rounded to bf16, f32
deltas rounded where they are added, duplicates added one after another);
the train RMSE, a sum of squared errors in another order, is within 1e-6.

Checkpoints and npz files keep bf16 bit for bit, and read the 2-byte
arrays the reference's npz writer leaves; the training driver trains bf16 where
the reference does and ``update`` keeps the dtype. ``profile_phases``
records carry the reference's keys."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import apply_overrides as j_overrides, preset as j_preset
from mfx.data import synthetic as jsyn
from mfx.data.split import train_test_split as j_split
from mfx.models.mf import MFModel as JMFModel, init_model as j_init
from mfx.solvers.sgd import train_epochs as j_train_epochs
from mfx_torch.config import apply_overrides, preset
from mfx_torch.convert import model_from_numpy
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.models.mf import MFModel, init_model
from mfx_torch.solvers.sgd import train_epochs
from mfx_torch.train.checkpoint import load_checkpoint, save_checkpoint


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x, np.float32)


def _port_coo(c):
    return RatingsCOO(user=c.user, item=c.item, rating=c.rating,
                      num_users=c.num_users, num_items=c.num_items)


@pytest.mark.parametrize("partitioner,trust", [("conflict_free", 0.0),
                                               ("fixed", 16.0),
                                               ("fixed", 0.0)])
def test_bf16_minibatch_epochs_match_reference(partitioner, trust):
    coo = jsyn.make_synthetic(300, 200, 12000, rank=4, seed=3, noise=0.3,
                              star_step=0.5, user_zipf_s=0.6)
    tr, _ = j_split(coo, 0.1, seed=0)
    cfg = dataclasses.replace(j_preset("ml100k_rank16").sgd, epochs=3,
                              batch_size=256, partitioner=partitioner,
                              dup_trust=trust)
    jm = j_init(0, coo.num_users, coo.num_items, 16,
                global_mean=tr.global_mean, dtype=jnp.bfloat16)
    jm = dataclasses.replace(
        jm, bu=jnp.asarray(np.random.default_rng(1).normal(0, .1, 300),
                           jnp.bfloat16))
    tm = model_from_numpy({k: _np(getattr(jm, k))
                           for k in ("P", "Q", "bu", "bi", "mu")},
                          device="cpu", dtype="bfloat16")
    assert tm.P.dtype == torch.bfloat16 and tm.mu == float(jm.mu)
    want = list(j_train_epochs(jm, tr, cfg, True, seed=0))
    got = list(train_epochs(tm, _port_coo(tr), cfg, True, seed=0))
    assert len(got) == len(want) == 3
    for (e, gm, gt), (_, wm, wt) in zip(got, want):
        assert gm.P.dtype == torch.bfloat16
        for k in ("P", "Q", "bu", "bi"):
            np.testing.assert_array_equal(getattr(gm, k).float().numpy(),
                                          _np(getattr(wm, k)),
                                          err_msg=f"epoch {e} {k}")
        assert abs(gt - float(wt)) <= 1e-6


def test_table_dtype_and_astype_match_reference():
    rng = np.random.default_rng(5)
    arrays = {"P": rng.normal(0, 1, (7, 4)).astype(np.float32),
              "Q": rng.normal(0, 1, (9, 4)).astype(np.float32),
              "bu": rng.normal(0, 1, 7).astype(np.float32),
              "bi": rng.normal(0, 1, 9).astype(np.float32),
              "mu": np.float32(3.5291)}
    jm = JMFModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = jm.astype(jnp.bfloat16)
    got = model_from_numpy(arrays, device="cpu").astype("bfloat16")
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_array_equal(getattr(got, k).float().numpy(),
                                      _np(getattr(want, k)))
    assert got.mu == float(want.mu)
    fresh = init_model(torch.Generator().manual_seed(0), 6, 5, 4,
                       global_mean=3.5291, dtype="bfloat16")
    assert all(getattr(fresh, k).dtype == torch.bfloat16
               for k in ("P", "Q", "bu", "bi"))
    assert fresh.mu == float(want.mu)
    with pytest.raises(ValueError, match="table dtype"):
        fresh.astype("float16")


def test_bf16_checkpoints_and_npz_keep_the_bits(tmp_path):
    g = torch.Generator().manual_seed(3)
    m = init_model(g, 11, 13, 8, global_mean=3.61, dtype="bfloat16")
    m = MFModel(m.P, m.Q, torch.randn(11, generator=g).bfloat16(),
                torch.randn(13, generator=g).bfloat16(), m.mu)
    save_checkpoint(tmp_path / "ck", 4, m, seed=2)
    m.save_npz(tmp_path / "m.npz")
    for got in (load_checkpoint(tmp_path / "ck", device="cpu")[0],
                MFModel.load_npz(tmp_path / "m.npz", device="cpu")):
        for k in ("P", "Q", "bu", "bi"):
            t = getattr(got, k)
            assert t.dtype == torch.bfloat16
            assert torch.equal(t.view(torch.int16),
                               getattr(m, k).view(torch.int16))
        assert got.mu == m.mu
    # what the reference's npz writer leaves for bf16 tables
    jm = j_init(1, 5, 6, 4, global_mean=3.3, dtype=jnp.bfloat16)
    jm.save_npz(tmp_path / "j.npz")
    got = MFModel.load_npz(tmp_path / "j.npz", device="cpu")
    assert got.P.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.Q.float().numpy(), _np(jm.Q))
    assert got.mu == float(jm.mu)


def _small(root, *extra):
    return apply_overrides(preset("ml100k_rank16"), [
        "data.dataset=synthetic-small", f"data.root={root}", "sgd.epochs=2",
        *extra])


def test_driver_trains_bf16_tables(tmp_path):
    """ml100k_rank16 with model.dtype=bfloat16 through the training driver: bf16
    tables and checkpoint, the train RMSE falls, and a run resumed from
    its epoch-0 checkpoint ends bit for bit where the whole run does."""
    from mfx_torch.train.driver import train

    ck = tmp_path / "ck"
    res = train(_small(tmp_path, "model.dtype=bfloat16",
                       f"checkpoint_dir={ck}", "checkpoint_every=1"),
                device="cpu")
    assert res.model.P.dtype == torch.bfloat16
    assert res.history[1]["train_metric"] < res.history[0]["train_metric"]
    assert np.isfinite(res.test_rmse)
    saved, epoch, _ = load_checkpoint(ck, device="cpu")
    assert epoch == 1 and saved.P.dtype == torch.bfloat16
    assert torch.equal(saved.P, res.model.P)
    ck0 = tmp_path / "ck0"
    ck0.mkdir()
    (ck / "0.npz").rename(ck0 / "0.npz")
    again = train(_small(tmp_path, "model.dtype=bfloat16",
                         f"checkpoint_dir={ck0}"), device="cpu")
    assert again.epochs_run == 2
    assert torch.equal(again.model.P, res.model.P)
    assert torch.equal(again.model.Q, res.model.Q)


def test_update_keeps_the_table_dtype():
    from mfx_torch.config import SGDConfig
    from mfx_torch.train.online import grow_model, partial_fit

    g = torch.Generator().manual_seed(4)
    m = init_model(g, 20, 15, 8, global_mean=3.5, dtype="bfloat16")
    grown = grow_model(m, 22, 18)
    assert grown.P.dtype == grown.bi.dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    n = 200
    delta = RatingsCOO(user=rng.integers(0, 24, n).astype(np.int32),
                       item=rng.integers(0, 19, n).astype(np.int32),
                       rating=rng.uniform(1, 5, n).astype(np.float32),
                       num_users=24, num_items=19)
    cfg = SGDConfig(lr=0.01, reg=0.02, epochs=2, batch_size=64,
                    partitioner="fixed", dup_trust=16.0)
    out, tr = partial_fit(m, delta, cfg, seed=0)
    assert (out.num_users, out.num_items) == (24, 19)
    assert all(getattr(out, k).dtype == torch.bfloat16
               for k in ("P", "Q", "bu", "bi"))
    assert np.isfinite(tr) and bool(torch.isfinite(out.P.float()).all())
    assert torch.equal(out.P[20:].float() != 0,
                       torch.ones_like(out.P[20:], dtype=torch.bool))


PHASE_KEYS = {"plan_ms", "eval_ms"}


def test_profile_phases_records_have_the_references_keys(tmp_path):
    """The minibatch path: each record has exactly the keys of the
    reference driver's records on the same config (plan_ms, eval_ms);
    the blocked trainer adds dense_ms and sparse_ms, as the reference's
    does, and leaves them out in bias_mode='epoch'."""
    from mfx.train.driver import train as j_train
    from mfx_torch.train.driver import train

    ov = ["data.dataset=synthetic-small", f"data.root={tmp_path}",
          "sgd.epochs=2", "profile_phases=true"]
    want = j_train(j_overrides(j_preset("ml100k_rank16"), ov))
    got = train(apply_overrides(preset("ml100k_rank16"), ov), device="cpu")
    assert [set(r) for r in got.history] == [set(r) for r in want.history]
    assert all(PHASE_KEYS <= set(r) for r in got.history)
    assert all(r["plan_ms"] >= 0 for r in got.history)

    base = set(got.history[0])
    for mode, extra in (("tile", {"dense_ms", "sparse_ms"}),
                        ("epoch", set())):
        blocked = train(apply_overrides(preset("ml1m_rank32_biased"), [
            "data.dataset=synthetic-small", f"data.root={tmp_path}",
            "sgd.epochs=2", "profile_phases=true",
            f"sgd.bias_mode={mode}"]), device="cpu")
        for rec in blocked.history:
            assert set(rec) == base | extra
            assert all(rec[k] >= 0 for k in extra)
        if extra:
            assert sum(r["sparse_ms"] for r in blocked.history) > 0
