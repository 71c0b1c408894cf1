"""The blocked trainer under every bias mode with the dense phase on:
two epochs of the port's ``train_epochs_blocked`` against the reference
trainer (Pallas in interpret mode) from the same tables and plan bits, at
rank 64 with int4 codes, for ``bias_mode`` 'epoch' and 'tile' and for
``use_bias=False``; 'epoch' also with the dense phase off. Then an
epoch-mode run resumed at ``start_epoch``, and the driver and CLI on
``ml25m_rank64 --set sgd.bias_mode=epoch``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import SGDConfig
from mfx.data import synthetic, train_test_split
from mfx.eval.metrics import rmse_mae as rmse_mae_j
from mfx.models import init_model
from mfx.solvers.blocked import train_epochs_blocked as train_j
from mfx_torch.config import apply_overrides, preset
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.eval.metrics import rmse_mae
from mfx_torch.solvers.blocked import train_epochs_blocked

U = I = 600
RANK = 64
KEYS = ("P", "Q", "bu", "bi")
CFG = SGDConfig(
    lr=0.012, reg=0.04, lr_decay=0.95, epochs=2, partitioner="blocked",
    kernel="pallas", ublock=256, iblock=256, tile=64, dense_chi=0.01,
    dense_span="full", plan_device="device",
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split():
    coo = synthetic.make_synthetic(U, I, 25_000, rank=4, noise=0.3, seed=9,
                                   star_step=0.5)
    return train_test_split(coo, test_frac=0.1, seed=0)


def _jax_bits(seed):
    def bits(epoch, n):
        key = jax.random.fold_in(jax.random.key(seed), epoch)
        return torch.as_tensor(np.array(
            jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)))
    return bits


def _arrays(train, use_bias):
    """Shared initial tables: the reference's init, with numpy-seeded
    biases where the run trains them (so the frozen terms are live)."""
    m0 = init_model(1, U, I, RANK, global_mean=train.global_mean)
    out = {k: np.asarray(getattr(m0, k)) for k in KEYS + ("mu",)}
    if use_bias:
        rng = np.random.default_rng(3)
        out["bu"] = rng.normal(0, 0.1, U).astype(np.float32)
        out["bi"] = rng.normal(0, 0.1, I).astype(np.float32)
    return out


# (bias_mode, use_bias, dense phase on)
MODES = {"epoch": ("epoch", True, True), "tile": ("tile", True, True),
         "no_bias": ("tile", False, True),
         "epoch_no_dense": ("epoch", True, False)}


def _cfg(mode):
    bias_mode, use_bias, dense = MODES[mode]
    return dataclasses.replace(CFG, bias_mode=bias_mode,
                               dense_chi=CFG.dense_chi if dense else 0.0)


@pytest.mark.parametrize("mode", list(MODES))
def test_two_epochs_match_reference_trainer(mode):
    """Train and held-out RMSE within 1e-5 each epoch, tables and biases
    within 1e-4 after 2 (tests/test_torch_slice.py's rank-64
    tolerances)."""
    _, use_bias, dense = MODES[mode]
    cfg = _cfg(mode)
    train, test = _split()
    arrays = _arrays(train, use_bias)
    m0 = init_model(1, U, I, RANK, global_mean=train.global_mean)
    m0 = m0.__class__(**{k: jnp.asarray(arrays[k]) for k in KEYS}, mu=m0.mu)
    ref = []
    for _, view, tr in train_j(m0, train, cfg, use_bias=use_bias, seed=0,
                               tpg=4, exact=True, interpret=True):
        m = view.materialize()
        ref.append((float(tr), rmse_mae_j(m, test)[0],
                    {k: np.asarray(getattr(m, k)) for k in KEYS}))
    timings = {}
    got = [(float(tr), rmse_mae(m, test)[0], model_to_numpy(m))
           for _, m, tr in train_epochs_blocked(
               model_from_numpy(arrays, device="cpu"), train, cfg, use_bias,
               seed=0, device="cpu", timings=timings,
               plan_rand=_jax_bits(0))]
    assert len(got) == len(ref) == 2
    assert ("dense_info" in timings) == dense
    assert (timings["bias_s"] > 0) == use_bias
    for (tr_t, te_t, _), (tr_j, te_j, _) in zip(got, ref):
        assert abs(tr_t - tr_j) <= 1e-5 and abs(te_t - te_j) <= 1e-5
    for k in KEYS:
        np.testing.assert_allclose(got[-1][2][k], ref[-1][2][k], rtol=0,
                                   atol=1e-4, err_msg=k)
    moved = float(np.abs(got[-1][2]["bu"] - arrays["bu"]).max())
    assert (moved > 1e-3) == use_bias
    assert got[1][0] < got[0][0]


def test_epoch_mode_resumes_bitwise():
    """A run resumed at epoch 1 from the tables an unbroken run had there
    repeats that run's epoch 1 bit for bit."""
    cfg = dataclasses.replace(_cfg("epoch"), epochs=2)
    train, _ = _split()
    arrays = _arrays(train, True)
    runs = [(m, float(tr)) for _, m, tr in train_epochs_blocked(
        model_from_numpy(arrays, device="cpu"), train, cfg, True, seed=4,
        device="cpu")]
    (_, again, tr), = train_epochs_blocked(runs[0][0], train, cfg, True,
                                           seed=4, device="cpu",
                                           start_epoch=1)
    assert float(tr) == runs[1][1]
    for k in KEYS:
        assert torch.equal(getattr(again, k), getattr(runs[1][0], k)), k


def _small(root, mode):
    # synthetic-small (256 x 512) holds two strata of 256 x 256: at chi 0.1
    # one runs densely and one sparsely
    out = ["data.dataset=synthetic-small", f"data.root={root}",
           "sgd.ublock=256", "sgd.iblock=256", "sgd.tile=64", "sgd.epochs=2",
           "sgd.dense_chi=0.1", "sgd.dense_int4=on", "target_rmse=0.0"]
    # the reference plans 'epoch' on its device planner only
    return out + {"epoch": ["sgd.bias_mode=epoch", "sgd.plan_device=device"],
                  "tile": ["sgd.bias_mode=tile"],
                  "no_bias": ["model.use_bias=false"]}[mode]


@pytest.mark.parametrize("mode", ["epoch", "tile", "no_bias"])
def test_driver_trains_each_mode_on_cpu(tmp_path, mode):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("ml25m_rank64"), _small(tmp_path, mode))
    res = train(cfg, device="cpu")
    assert res.epochs_run == 2
    assert res.history[1]["train_metric"] < res.history[0]["train_metric"]
    assert np.isfinite(res.test_rmse) and 0 < res.test_rmse < 2
    assert (float(res.model.bu.abs().max()) > 0) == (mode != "no_bias")


def test_cli_prints_reference_json_in_epoch_mode(capsys, tmp_path):
    import mfx.cli

    args = ["train", "--preset", "ml25m_rank64"]
    for ov in _small(tmp_path / "ref", "epoch"):
        args += ["--set", ov]
    assert mfx.cli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    from mfx_torch.cli import main

    args = ["train", "--preset", "ml25m_rank64", "--device", "cpu"]
    for ov in _small(tmp_path / "port", "epoch"):
        args += ["--set", ov]
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == set(want) == {"preset", "epochs_run",
                                     "updates_per_sec", "test_rmse",
                                     "test_mae"}
    assert out["preset"] == want["preset"] == "ml25m_rank64"
    assert out["epochs_run"] == want["epochs_run"] == 2
    assert abs(out["test_rmse"] - want["test_rmse"]) < 0.05


def test_epoch_mode_with_every_stratum_dense():
    """With every stratum carved densely there is no sparse sweep: the
    epoch's residual buffer is empty and only the dense groups' batched
    updates move the biases (the reference's trainer raises IndexError
    here, ROADMAP Queue 3)."""
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_epoch

    cfg = dataclasses.replace(_cfg("epoch"), dense_chi=1e-6, epochs=1)
    train, _ = _split()
    arrays = _arrays(train, True)
    timings = {}
    before = sgd_sweep_epoch.launches
    (_, m, tr), = train_epochs_blocked(
        model_from_numpy(arrays, device="cpu"), train, cfg, True, seed=0,
        device="cpu", timings=timings)
    assert timings["dense_info"]["dense_frac"] == 1.0
    assert timings["sweep_tiles"] == [] and sgd_sweep_epoch.launches == before
    assert np.isfinite(float(tr))
    assert float(np.abs(m.bu.numpy() - arrays["bu"]).max()) > 1e-3


# ml1m_rank32_biased on an ML-1M-shaped cut (users and items / 10, ratings
# / 100, the ml-1m synthetic's whole stars and skew) at su = si = 256,
# T = 64, 3 epochs: the dense phase on with the preset's automatic
# carving (every stratum dense here, as on the full data) in each bias
# form, and the lane sweep with the dense phase off
RANK32_RUNS = {
    "lane": ["sgd.bias_mode=lane", "sgd.dense_span=full", "sgd.dense_chi=-1"],
    "tile": ["sgd.dense_span=full", "sgd.dense_chi=-1"],
    "no_bias": ["model.use_bias=false", "sgd.dense_span=full",
                "sgd.dense_chi=-1"],
    "lane_no_dense": ["sgd.bias_mode=lane"],
}


def _run_both(cfg_t, cfg_j, coo, rank):
    """Both packages' trainers on ``coo`` split 0.9 / 0.1 from the
    reference's init (numpy-seeded biases where they train) with the
    reference's plan bits: (port's, reference's) per-epoch (train RMSE,
    held-out RMSE, tables), the port's timings and the initial tables."""
    use_bias = cfg_t.model.use_bias
    train, test = train_test_split(coo, test_frac=0.1, seed=0)
    m0 = init_model(1, coo.num_users, coo.num_items, rank,
                    global_mean=train.global_mean)
    arrays = {k: np.asarray(getattr(m0, k)) for k in KEYS + ("mu",)}
    if use_bias:
        rng = np.random.default_rng(3)
        arrays["bu"] = rng.normal(0, 0.1, coo.num_users).astype(np.float32)
        arrays["bi"] = rng.normal(0, 0.1, coo.num_items).astype(np.float32)
    m0 = m0.__class__(**{k: jnp.asarray(arrays[k]) for k in KEYS}, mu=m0.mu)
    ref = []
    for _, view, tr in train_j(m0, train, cfg_j.sgd, use_bias=use_bias,
                               seed=0, tpg=4, exact=True, interpret=True):
        m = view.materialize()
        ref.append((float(tr), rmse_mae_j(m, test)[0],
                    {k: np.asarray(getattr(m, k)) for k in KEYS}))
    timings = {}
    got = [(float(tr), rmse_mae(m, test)[0], model_to_numpy(m))
           for _, m, tr in train_epochs_blocked(
               model_from_numpy(arrays, device="cpu"), train, cfg_t.sgd,
               use_bias, seed=0, device="cpu", timings=timings,
               plan_rand=_jax_bits(0))]
    return got, ref, timings, arrays


def _close(got, ref, rmse_tol, tab_tol):
    assert len(got) == len(ref)
    for (tr_t, te_t, _), (tr_j, te_j, _) in zip(got, ref):
        assert abs(tr_t - tr_j) <= rmse_tol and abs(te_t - te_j) <= rmse_tol
    for k in KEYS:
        np.testing.assert_allclose(got[-1][2][k], ref[-1][2][k], rtol=0,
                                   atol=tab_tol, err_msg=k)


@pytest.mark.parametrize("run", list(RANK32_RUNS))
def test_rank32_runs_match_reference_trainer(run):
    """The port's CPU run against the reference trainer (Pallas in
    interpret mode) on the reference's plan bits, from the same tables:
    train and held-out RMSE within 1e-5 each epoch, tables and biases
    within 1e-4 after 3 epochs (the rank-64 tolerances above)."""
    from mfx.config import apply_overrides as apply_j
    from mfx.config import preset as preset_j

    over = RANK32_RUNS[run] + ["sgd.ublock=256", "sgd.iblock=256",
                               "sgd.tile=64", "sgd.epochs=3",
                               "sgd.plan_device=device"]
    cfg_t, cfg_j = (apply_overrides(preset("ml1m_rank32_biased"), over),
                    apply_j(preset_j("ml1m_rank32_biased"), over))
    coo = synthetic.make_synthetic(604, 370, 10_002, rank=32, seed=101,
                                   star_step=1.0, user_zipf_s=0.6)
    got, ref, timings, _ = _run_both(cfg_t, cfg_j, coo, cfg_t.model.rank)
    assert len(got) == 3
    dense = "dense_info" in timings
    assert dense == (run != "lane_no_dense")
    if dense:  # the automatic carving leaves no stratum sparse here
        assert timings["dense_info"]["dense_frac"] == 1.0
    _close(got, ref, 1e-5, 1e-4)
    assert got[-1][0] < got[0][0]


# netflix100m_rank128_dp with parallel.mode=single (rank 128, su = si =
# 512, T = 256, int8 codes) in each bias form but lane, on the netflix
# synthetic cut to 1/2000 of its users and ratings (240 users, all 17,770
# items; the full cell's generator, seed and whole stars), 1 epoch. At
# this size the automatic carving takes every stratum dense, so
# sgd.dense_chi=0.002 carves 14 of the 35 strata dense and leaves the rest
# to the sparse sweeps: each run goes through a rank-128 sweep form and a
# rank-128 int8 dense form.
NETFLIX_RUNS = {
    "tile": ["sgd.bias_mode=tile"],
    "epoch": ["sgd.bias_mode=epoch"],
    "step_u": ["sgd.bias_mode=tile", "sgd.step_user_batch=true"],
    "no_bias": ["model.use_bias=false"],
}


@pytest.mark.parametrize("run", list(NETFLIX_RUNS))
def test_netflix_rank128_runs_match_reference_trainer(run):
    """As test_rank32_runs_match_reference_trainer, at the tolerances of
    tests/test_torch_slice.py::test_netflix_cut_follows_the_reference_trainer
    (RMSE 1e-6, tables 1e-5): both packages sum the 128 lanes of a dot."""
    from mfx.config import apply_overrides as apply_j
    from mfx.config import preset as preset_j
    from mfx.data.synthetic import NETFLIX_SHAPE

    over = NETFLIX_RUNS[run] + ["parallel.mode=single", "sgd.epochs=1",
                                "sgd.dense_chi=0.002",
                                "sgd.plan_device=device"]
    cfg_t, cfg_j = (apply_overrides(preset("netflix100m_rank128_dp"), over),
                    apply_j(preset_j("netflix100m_rank128_dp"), over))
    coo = synthetic.make_synthetic(
        NETFLIX_SHAPE[0] // 2000, NETFLIX_SHAPE[1], NETFLIX_SHAPE[2] // 2000,
        rank=128, seed=103, star_step=1.0, user_zipf_s=0.6)
    got, ref, timings, arrays = _run_both(cfg_t, cfg_j, coo, 128)
    info = timings["dense_info"]
    assert info["num_strata"] == 14 and 0 < info["dense_frac"] < 1
    assert info["r_stream_bytes"] == 14 * 512 * 512  # int8 codes
    assert sum(n for n, _ in timings["sweep_tiles"]) > 0  # sparse tiles too
    _close(got, ref, 1e-6, 1e-5)
    moved = float(np.abs(got[-1][2]["bu"] - arrays["bu"]).max())
    assert (moved > 1e-3) == cfg_t.model.use_bias  # biases train when asked
