"""timeSVD of the port against the reference: the time features, the
model (prediction, the MF view, the npz file both ways), the time-lane
layout, the minibatch step and two epochs of the minibatch trainer, the
time-aware eval, and ``solver='timesvd'`` through the driver and the CLI
with both kernels (and the reference's refusals)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import TimeSVDConfig as TimeSVDConfig_j
from mfx.kernels import packing as pk
from mfx.models import init_model
from mfx.models.timesvd import TimeSVDModel as TimeSVDModel_j
from mfx.models.timesvd import fit_time_features as fit_j
from mfx.solvers import timesvd as tsvd_j
from mfx_torch.config import TimeSVDConfig, apply_overrides, preset
from mfx_torch.convert import model_from_numpy, timesvd_from_numpy
from mfx_torch.data import loaders
from mfx_torch.kernels import packing as pk_t
from mfx_torch.models.timesvd import TimeSVDModel, fit_time_features
from mfx_torch.solvers import timesvd as tsvd
from test_torch_timesvd_blocked import NB, temporal_coo

KEYS = ("P", "Q", "bu", "bi", "bt", "alpha")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests loop over many small CPU ops, and
    under a parallel test run the workers' thread pools would fight for
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ts_arrays(U, I, rank, seed=0, n_bins=NB):
    rng = np.random.default_rng(seed)
    return {"P": rng.normal(0, 0.3, (U, rank)).astype(np.float32),
            "Q": rng.normal(0, 0.3, (I, rank)).astype(np.float32),
            "bu": rng.normal(0, 0.1, U).astype(np.float32),
            "bi": rng.normal(0, 0.1, I).astype(np.float32),
            "mu": np.float32(3.5),
            "bt": rng.normal(0, 0.1, (I, n_bins)).astype(np.float32),
            "alpha": rng.normal(0, 0.1, U).astype(np.float32)}


def _jts(a):
    return TimeSVDModel_j(**{k: jnp.asarray(v) for k, v in a.items()})


@pytest.mark.parametrize("n_bins,beta", [(1, 0.4), (8, 0.4), (30, 0.25)])
def test_time_features_match_the_reference(n_bins, beta):
    """Bins equal and deviations within 1e-6, for train times, times
    beyond the train window (they clamp into the edge bins) and users with
    no train rating; the fitted state equal."""
    coo = temporal_coo(300, 260, 5_000, seed=2)
    f_t = fit_time_features(coo, n_bins=n_bins, beta=beta)
    f_j = fit_j(coo, n_bins=n_bins, beta=beta)
    assert (f_t.t0, f_t.t1, f_t.span, f_t.beta, f_t.n_bins) == (
        f_j.t0, f_j.t1, f_j.span, f_j.beta, f_j.n_bins)
    np.testing.assert_array_equal(f_t.edges, f_j.edges)
    np.testing.assert_array_equal(f_t.tu, f_j.tu)
    rng = np.random.default_rng(1)
    users = rng.integers(0, 300, 4_000)
    ts = rng.integers(-200_000, 1_300_000, 4_000)
    b_t, d_t = f_t.features(users, ts)
    b_j, d_j = f_j.features(users, ts)
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-6)
    assert b_t.dtype == np.int32 and d_t.dtype == np.float32
    with pytest.raises(ValueError, match="timestamp"):
        fit_time_features(dataclasses.replace(coo, timestamp=None))
    with pytest.raises(ValueError, match="n_bins"):
        fit_time_features(coo, n_bins=0)


def test_prediction_and_mf_view_match_the_reference():
    U, I = 40, 30
    a = _ts_arrays(U, I, 16)
    coo = temporal_coo(U, I, 600, seed=1)
    feats = fit_time_features(coo, n_bins=NB)
    m_t = timesvd_from_numpy(a, device="cpu")
    m_j = _jts(a)
    rng = np.random.default_rng(0)
    u, i = rng.integers(0, U, 500), rng.integers(0, I, 500)
    tb, dv = feats.features(u, rng.integers(0, 1_000_000, 500))
    got = m_t.predict_t(*(torch.as_tensor(x).long() for x in (u, i, tb)),
                        torch.as_tensor(dv))
    want = np.asarray(m_j.predict_t(u, i, tb, dv))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for at in (None, 123_456):
        v_t, v_j = m_t.as_mf(feats, at=at), m_j.as_mf(fit_j(coo, NB), at=at)
        for k in ("P", "Q", "bu", "bi"):
            np.testing.assert_allclose(getattr(v_t, k).numpy(),
                                       np.asarray(getattr(v_j, k)), rtol=0,
                                       atol=1e-7, err_msg=k)
    assert torch.equal(m_t.as_mf().bu, m_t.bu)


def test_npz_moves_both_ways(tmp_path):
    a = _ts_arrays(12, 9, 8)
    timesvd_from_numpy(a, device="cpu").save_npz(tmp_path / "t.npz")
    back_j = TimeSVDModel_j.load_npz(tmp_path / "t.npz")
    _jts(a).save_npz(tmp_path / "j.npz")
    back_t = TimeSVDModel.load_npz(tmp_path / "j.npz", device="cpu")
    for k in KEYS + ("mu",):
        np.testing.assert_array_equal(np.asarray(getattr(back_j, k)), a[k])
        np.testing.assert_array_equal(
            np.asarray(getattr(back_t, k) if k == "mu"
                       else getattr(back_t, k).numpy()), a[k])


@pytest.mark.parametrize("rank,n_bins", [(32, 8), (64, 30), (128, 30)])
def test_time_lane_layout_is_the_reference_layout(rank, n_bins):
    """``to_tlane_model`` gives the reference's tables bit for bit, and
    ``from_tlane_model`` inverts it exactly (reserved columns zeroed)."""
    a = _ts_arrays(20, 14, rank, n_bins=n_bins)
    lane_t = pk_t.to_tlane_model(timesvd_from_numpy(a, device="cpu"), n_bins)
    lane_j = pk.to_tlane_model(_jts(a), n_bins)
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_array_equal(getattr(lane_t, k).numpy(),
                                      np.asarray(getattr(lane_j, k)))
    back_t = pk_t.from_tlane_model(lane_t, n_bins)
    back_j = pk.from_tlane_model(lane_j, n_bins)
    for k in KEYS:
        np.testing.assert_array_equal(getattr(back_t, k).numpy(),
                                      np.asarray(getattr(back_j, k)))
    L = rank - 3 - n_bins
    np.testing.assert_array_equal(back_t.bt.numpy(), a["bt"])
    np.testing.assert_array_equal(back_t.P[:, :L].numpy(), a["P"][:, :L])
    with pytest.raises(ValueError, match="rank"):
        pk_t.to_tlane_model(timesvd_from_numpy(a, device="cpu"), rank - 3)


@pytest.mark.parametrize("unique,trust", [(False, 0.0), (False, 2.0),
                                          (True, 0.0)])
def test_minibatch_step_matches_the_reference(unique, trust):
    """One step with duplicate users, items and (item, bin) keys (or, with
    ``unique_rows``, none), sentinel pads (weight 0, out-of-range ids),
    against ``timesvd_minibatch_update`` (1e-6)."""
    U, I, B = 30, 25, 64
    a = _ts_arrays(U, I, 8, seed=3)
    rng = np.random.default_rng(4)
    n = 48
    if unique:
        n = 24
        users, items = rng.permutation(U)[:n], rng.permutation(I)[:n]
    else:
        users, items = rng.integers(0, 6, n), rng.integers(0, 5, n)
    slot = np.arange(B)
    u = (U + slot).astype(np.int32)
    i = (I + slot).astype(np.int32)
    u[:n], i[:n] = users, items
    r = np.zeros(B, np.float32)
    w = np.zeros(B, np.float32)
    tb = np.zeros(B, np.int32)
    dv = np.zeros(B, np.float32)
    r[:n] = rng.uniform(1, 5, n)
    w[:n] = 1.0
    tb[:n] = rng.integers(0, NB if unique else 3, n)
    dv[:n] = rng.normal(0, 0.5, n)
    rates = (0.05, 0.03, 0.02, 0.04, 0.01, 0.2)
    new_j, sq_j = tsvd_j.timesvd_minibatch_update(
        _jts(a), *(jnp.asarray(x) for x in (u, i, r, w, tb, dv)), *rates,
        unique_rows=unique, dup_trust=trust)
    new_t, sq_t = tsvd.timesvd_minibatch_update(
        timesvd_from_numpy(a, device="cpu"),
        *(torch.as_tensor(x) for x in (u, i, r, w, tb, dv)), *rates,
        unique_rows=unique, dup_trust=trust)
    for k in KEYS:
        np.testing.assert_allclose(getattr(new_t, k).numpy(),
                                   np.asarray(getattr(new_j, k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert abs(float(sq_t) - float(sq_j)) <= 1e-5 * float(sq_j)


@pytest.mark.parametrize("partitioner,trust", [
    ("fixed", 0.0), ("fixed", 16.0), ("conflict_free", 0.0),
    ("conflict_free", 16.0)])
def test_two_minibatch_epochs_match_the_reference(partitioner, trust):
    """Two epochs of ``train_epochs_timesvd`` against the JAX trainer from
    the same tables and batches (train RMSE 1e-5, tables 1e-5), then the
    time-aware held-out RMSE and MAE (1e-5)."""
    from mfx.data.split import train_test_split as split_j

    coo = temporal_coo(200, 150, 6_000, seed=7)
    train, test = split_j(coo, 0.15, seed=0)
    kw = dict(lr=0.01, reg=0.02, epochs=2, batch_size=256, n_bins=NB,
              partitioner=partitioner, dup_trust=trust)
    m0 = init_model(5, 200, 150, 16, global_mean=train.global_mean)
    arrays = {k: np.asarray(getattr(m0, k)) for k in ("P", "Q", "bu", "bi",
                                                      "mu")}
    ref = [(tr, m) for _, m, tr in tsvd_j.train_epochs_timesvd(
        m0, train, TimeSVDConfig_j(**kw), seed=3,
        feats=fit_j(train, n_bins=NB))]
    feats = fit_time_features(train, n_bins=NB)
    got = [(tr, m) for _, m, tr in tsvd.train_epochs_timesvd(
        model_from_numpy(arrays, device="cpu"), train, TimeSVDConfig(**kw),
        seed=3, feats=feats)]
    for (tr_t, m_t), (tr_j, m_j) in zip(got, ref, strict=True):
        assert abs(tr_t - float(tr_j)) <= 1e-5
        for k in KEYS:
            np.testing.assert_allclose(getattr(m_t, k).numpy(),
                                       np.asarray(getattr(m_j, k)), rtol=0,
                                       atol=1e-5, err_msg=k)
    assert got[1][0] < got[0][0]
    rm_t = tsvd.rmse_mae_time(got[-1][1], feats, test, clip=(0.5, 5.0))
    rm_j = tsvd_j.rmse_mae_time(ref[-1][1], fit_j(train, n_bins=NB), test,
                                clip=(0.5, 5.0))
    np.testing.assert_allclose(rm_t, rm_j, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="timestamp"):
        tsvd.rmse_mae_time(got[-1][1], feats,
                           dataclasses.replace(test, timestamp=None))


def _root(tmp_path, n=6_000):
    """A data root holding a timestamped dataset as the loader's real-data
    cache of ``synthetic-small``."""
    root = tmp_path / "data"
    root.mkdir(exist_ok=True)
    temporal_coo(300, 260, n, seed=11).save_npz(
        root / f"synthetic-small.v{loaders.GENERATOR_VERSION}.npz")
    return root


def _cfg(root, kernel, *extra):
    return apply_overrides(preset("ml1m_rank32_biased"), [
        "solver=timesvd", "data.dataset=synthetic-small", f"data.root={root}",
        "model.rank=32", f"timesvd.kernel={kernel}", f"timesvd.n_bins={NB}",
        "timesvd.epochs=2", "timesvd.lr=0.01", "timesvd.reg_alpha=0.02",
        "timesvd.batch_size=512", *extra])


@pytest.mark.parametrize("kernel", ["pallas", "jnp"])
def test_driver_trains_and_evaluates_time_aware(tmp_path, kernel):
    """``solver='timesvd'`` through the driver on the CPU with either
    kernel: the train RMSE falls, the held-out RMSE is the time-aware one
    of the trained model, the ranking metrics and the checkpoint take the
    MF view, and a directory that holds a step is refused as the reference
    refuses it."""
    from mfx_torch.models.mf import MFModel
    from mfx_torch.train.checkpoint import load_checkpoint
    from mfx_torch.train.driver import train

    root = _root(tmp_path)
    ck = tmp_path / "ck"
    res = train(_cfg(root, kernel, "ranking_k=5", f"checkpoint_dir={ck}",
                     "checkpoint_every=1"), device="cpu")
    assert res.epochs_run == 2 and isinstance(res.model, MFModel)
    trains = [r["train_metric"] for r in res.history]
    assert trains[1] < trains[0]
    assert np.isfinite(res.test_rmse) and 0 < res.test_rmse < 1.5
    assert set(res.test_ranking) == {"hr", "ndcg", "mrr"}
    m, epoch, _ = load_checkpoint(ck, device="cpu")
    assert epoch == 1 and m.P.shape == (300, 32)
    for k in ("P", "Q", "bu", "bi"):
        assert torch.equal(getattr(m, k), getattr(res.model, k))
    with pytest.raises(ValueError, match="resume|MF-view"):
        train(_cfg(root, kernel, f"checkpoint_dir={ck}", "timesvd.epochs=3"),
              device="cpu")


def test_driver_eval_is_the_trainers_time_aware_rmse(tmp_path):
    """The driver's held-out RMSE is ``rmse_mae_time`` of the trainer's last
    TimeSVDModel with the driver's clipping, not the MF view's RMSE."""
    from mfx_torch.data.split import train_test_split
    from mfx_torch.models.mf import init_model as init_t
    from mfx_torch.solvers.timesvd_blocked import train_epochs_timesvd_blocked
    from mfx_torch.train.driver import train

    root = _root(tmp_path)
    cfg = _cfg(root, "pallas")
    res = train(cfg, device="cpu")
    coo = loaders.load_dataset("synthetic-small", root=root)
    tr, te = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    g = torch.Generator().manual_seed(cfg.model.seed)
    m0 = init_t(g, coo.num_users, coo.num_items, 32,
                global_mean=tr.global_mean, init_scale=cfg.model.init_scale)
    feats = fit_time_features(tr, n_bins=NB)
    *_, (_, ts, _) = train_epochs_timesvd_blocked(m0, tr, cfg.timesvd,
                                                  feats=feats)
    want = tsvd.rmse_mae_time(ts, feats, te, clip=(0.5, 5.0))
    assert (res.test_rmse, res.test_mae) == want


def test_cli_trains_timesvd(capsys, tmp_path):
    from mfx_torch.cli import main

    root = _root(tmp_path)
    args = ["train", "--preset", "ml1m_rank32_biased", "--device", "cpu"]
    for ov in ("solver=timesvd", "data.dataset=synthetic-small",
               f"data.root={root}", "model.rank=64", "timesvd.kernel=pallas",
               "timesvd.epochs=1", "timesvd.reg_alpha=0.02"):
        args += ["--set", ov]
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"preset", "epochs_run", "updates_per_sec",
                        "test_rmse", "test_mae"}
    assert out["epochs_run"] == 1 and np.isfinite(out["test_rmse"])


@pytest.mark.parametrize("override,exc", [
    ("parallel.mode=dp", ValueError),
    ("model.use_bias=false", ValueError),
])
def test_driver_refusals_are_the_reference_refusals(tmp_path, override,
                                                    exc):
    """The reference's driver refuses these with the same exception type
    (tests/unit/test_timesvd.py::test_driver_timesvd_validation)."""
    from mfx.config import apply_overrides as apply_j
    from mfx.config import preset as preset_j
    from mfx.train.driver import train as train_j
    from mfx_torch.train.driver import train

    root = _root(tmp_path, n=800)
    extra = [override] + (["parallel.data_axis=2"]
                          if "parallel" in override else [])
    for kernel in ("jnp", "pallas"):
        with pytest.raises(exc):
            train(_cfg(root, kernel, *extra), device="cpu")
    with pytest.raises(exc):
        train_j(apply_j(preset_j("ml1m_rank32_biased"), [
            "solver=timesvd", "data.dataset=synthetic-small",
            f"data.root={root}", "model.rank=32", "timesvd.epochs=1",
            *extra]), resume=False)


def test_ml25m_files_and_their_cache_keep_timestamps(tmp_path):
    """``ratings.csv`` of MovieLens-25M under ``data.root`` loads with its
    timestamps, as the reference's parser reads it, and so does the
    real-data cache the loader writes beside it (``{name}.v{V}.npz``)."""
    from mfx.data.loaders import load_dataset as load_j

    rng = np.random.default_rng(0)
    n = 400
    rows = np.stack([rng.integers(1, 60, n), rng.integers(1, 90, n),
                     rng.integers(1, 11, n) / 2.0,
                     rng.integers(800_000_000, 1_600_000_000, n)], axis=1)
    (tmp_path / "ml-25m").mkdir()
    with open(tmp_path / "ml-25m" / "ratings.csv", "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for u, i, r, t in rows:
            f.write(f"{int(u)},{int(i)},{r},{int(t)}\n")
    got = loaders.load_dataset("ml-25m", root=tmp_path)
    want = load_j("ml-25m", root=tmp_path, cache=False)
    assert got.timestamp is not None and got.timestamp.dtype == np.int64
    np.testing.assert_array_equal(got.timestamp, want.timestamp)
    cache = tmp_path / f"ml-25m.v{loaders.GENERATOR_VERSION}.npz"
    assert cache.exists()
    np.testing.assert_array_equal(
        loaders.load_dataset("ml-25m", root=tmp_path).timestamp,
        got.timestamp)
    assert sorted(got.timestamp) == sorted(rows[:, 3].astype(np.int64))
