"""The slice end to end: two epochs of the port's blocked trainer against
the reference trainer (Pallas in interpret mode) from the same initial
tables and the same plan bits, plus the port's driver and CLI."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import SGDConfig, apply_overrides, preset
from mfx.data import synthetic, train_test_split
from mfx.eval.metrics import rmse_mae as rmse_mae_j
from mfx.models import init_model
from mfx.solvers.blocked import train_epochs_blocked as train_j
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.eval.metrics import rmse_mae
from mfx_torch.solvers.blocked import train_epochs_blocked

U = I = 600
RANK = 64
CFG = SGDConfig(
    lr=0.012, reg=0.04, lr_decay=0.95, epochs=2, partitioner="blocked",
    kernel="pallas", ublock=256, iblock=256, tile=64, dense_chi=0.01,
    dense_span="full", bias_mode="lane", plan_device="device",
)


def _split(star_step=0.5):
    coo = synthetic.make_synthetic(U, I, 25_000, rank=4, noise=0.3, seed=9,
                                   star_step=star_step)
    return train_test_split(coo, test_frac=0.1, seed=0)


def _jax_bits(seed):
    def bits(epoch, n):
        key = jax.random.fold_in(jax.random.key(seed), epoch)
        return torch.as_tensor(np.array(
            jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)))
    return bits


# (rank, rating grid, the codes dense_rfmt picks, table tol, RMSE tol).
# Rank 64 on the half-star grid is the ml25m_rank64 form (int4); off the
# grid it takes int8 codes. At rank 64 the reference's sparse dot sums 128
# lanes (two rank-64 slots a lane row) where the port sums 64: 1e-4 on
# the tables, 1e-5 on the RMSE. Rank 128 (netflix100m_rank128_dp, int8
# codes) sums the same 128 lanes in both packages: 1e-5 and 1e-6.
CASES = {"r64_int4": (64, 0.5, "int4", 1e-4, 1e-5),
         "r64_int8_off_grid": (64, None, "int8", 1e-4, 1e-5),
         "r128_int8": (128, 1.0, "int8", 1e-5, 1e-6)}


@pytest.mark.parametrize("case", list(CASES))
def test_two_epochs_match_reference_trainer(case):
    from mfx_torch.solvers.blocked import dense_rfmt

    rank, star, rfmt, tab_tol, rmse_tol = CASES[case]
    train, test = _split(star)
    assert dense_rfmt(CFG, rank, train.rating) == rfmt
    m0 = init_model(1, U, I, rank, global_mean=train.global_mean)
    arrays = {k: np.asarray(getattr(m0, k)) for k in ("P", "Q", "bu", "bi", "mu")}

    ref = []
    for ep, view, tr in train_j(m0, train, CFG, use_bias=True, seed=0, tpg=4,
                                exact=True, interpret=True):
        m = view.materialize()
        ref.append((float(tr), rmse_mae_j(m, test)[0],
                    {k: np.asarray(getattr(m, k)) for k in ("P", "Q", "bu", "bi")}))

    timings = {}
    got = []
    for ep, m, tr in train_epochs_blocked(
        model_from_numpy(arrays, device="cpu"), train, CFG, True, seed=0, device="cpu", timings=timings, plan_rand=_jax_bits(0),
    ):
        got.append((float(tr), rmse_mae(m, test)[0], model_to_numpy(m)))

    assert len(got) == len(ref) == 2
    info = timings["dense_info"]
    assert info["num_strata"] == 5 and 0 < info["dense_frac"] < 1
    assert info["r_stream_bytes"] == 5 * 256 * (256 if rfmt == "int8" else 128)
    for (tr_t, te_t, tab_t), (tr_j, te_j, tab_j) in zip(got, ref):
        assert abs(tr_t - tr_j) <= rmse_tol
        assert abs(te_t - te_j) <= rmse_tol
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_allclose(got[-1][2][k], ref[-1][2][k], rtol=0,
                                   atol=tab_tol, err_msg=k)
    assert got[1][0] < got[0][0]  # it trains


def test_netflix_cut_follows_the_reference_trainer():
    """netflix100m_rank128_dp with parallel.mode=single, unchanged but for
    its depth (3 epochs), on the netflix synthetic cut to 1/200 of its
    users and ratings (2,400 users, all 17,770 items, 452,162 train
    ratings; the generator, seed and whole stars of the full cell): the
    port's per-epoch train and held-out RMSE within 1e-6 of the JAX
    trainer's and the tables within 1e-5. The reference's own held-out
    RMSE is lowest after the first epoch and rises after it while the
    train RMSE falls (the rank-128 model fits this synthetic's noise):
    the trajectory chip_smoke.py's phase 12 sees at full size."""
    from mfx.data.synthetic import NETFLIX_SHAPE

    cfg = apply_overrides(preset("netflix100m_rank128_dp"),
                          ["parallel.mode=single", "sgd.epochs=3"])
    users, items, n = (NETFLIX_SHAPE[0] // 200, NETFLIX_SHAPE[1],
                       NETFLIX_SHAPE[2] // 200)
    coo = synthetic.make_synthetic(users, items, n, rank=128, seed=103,
                                   star_step=1.0, user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    m0 = init_model(1, users, items, 128, global_mean=train.global_mean)
    arrays = {k: np.asarray(getattr(m0, k))
              for k in ("P", "Q", "bu", "bi", "mu")}
    ref = []
    for _, view, tr in train_j(m0, train, cfg.sgd, use_bias=True, seed=0,
                               tpg=4, exact=True, interpret=True):
        m = view.materialize()
        ref.append((float(tr), rmse_mae_j(m, test)[0],
                    {k: np.asarray(getattr(m, k))
                     for k in ("P", "Q", "bu", "bi")}))
    got = []
    for _, m, tr in train_epochs_blocked(
            model_from_numpy(arrays, device="cpu"), train, cfg.sgd, True, seed=0,
            device="cpu", plan_rand=_jax_bits(0)):
        got.append((float(tr), rmse_mae(m, test)[0], model_to_numpy(m)))
    assert len(got) == len(ref) == 3
    for (tr_t, te_t, _), (tr_j, te_j, _) in zip(got, ref):
        assert abs(tr_t - tr_j) <= 1e-6 and abs(te_t - te_j) <= 1e-6
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_allclose(got[-1][2][k], ref[-1][2][k], rtol=0,
                                   atol=1e-5, err_msg=k)
    base = rmse_mae_j(m0, test)[0]
    trains, tests = [x[0] for x in ref], [x[1] for x in ref]
    assert trains[0] > trains[1] > trains[2]
    assert tests[0] < base and tests[0] < tests[1] < tests[2]


@pytest.mark.parametrize("override,what", [
    ("bias_mode=tile", "bias_mode"),
    ("dense_span=head", "dense_span"),
    ("dense_spg=2", "dense_spg"),
    ("dense_echo=2", "dense_echo"),
    ("mxu=bf16", "mxu"),
    ("plan_device=host", "plan_device"),
    ("bias_mode=tile dense_echo=2", "dense_echo"),
])
def test_unported_variants_raise(override, what):
    """What the trainer refuses, naming the field: ``plan_device=host``
    (no kernel form; Queue 1 item 5) and, as the reference trainer does,
    ``dense_echo`` > 1 with tile biases (ValueError). The other variants
    raised until their kernel forms were ported and now train one epoch
    (their parity with the reference: tests/test_torch_bias_modes.py for
    ``bias_mode=tile``, tests/test_torch_dense_variants.py for the rest);
    the card's dense form check takes rank 32 and refuses a rank the
    reference has no dense form for."""
    import dataclasses

    from mfx_torch.kernels.dense_phase import check_kernel_form

    fields = dict(kv.split("=") for kv in override.split())
    cfg = dataclasses.replace(CFG, **{
        k: int(v) if v.isdigit() else v for k, v in fields.items()})
    train, _ = _split()
    model = model_from_numpy({
        "P": np.zeros((U, RANK), np.float32), "Q": np.zeros((I, RANK), np.float32),
        "bu": np.zeros(U, np.float32), "bi": np.zeros(I, np.float32), "mu": 3.5,
    }, device="cpu")
    if override == "plan_device=host":
        with pytest.raises(NotImplementedError, match=what):
            next(train_epochs_blocked(model, train, cfg, True, device="cpu"))
        return
    if len(fields) > 1:
        with pytest.raises(ValueError, match=what):
            next(train_epochs_blocked(model, train, cfg, True, device="cpu"))
        return
    timings = {}
    (_, m, tr), = train_epochs_blocked(
        model, train, dataclasses.replace(cfg, epochs=1), True,
        device="cpu", timings=timings)
    info = timings["dense_info"]
    assert info["num_strata"] == 5 and np.isfinite(float(tr))
    assert float(m.bu.abs().max()) > 0
    if what == "dense_spg":
        assert info["spg"] == 2 and info["strata_padded"] > 5
    if what == "dense_span":  # the reference's head info
        assert set(info) == {"dense_frac", "num_strata", "r_stream_bytes"}
    if override == "bias_mode=tile":
        grp = {"R": torch.zeros((1, 256, 128), dtype=torch.uint8)}
        check_kernel_form(torch.zeros(256, 32), grp, 256, 256)
        with pytest.raises(NotImplementedError, match="no other form"):
            check_kernel_form(torch.zeros(256, 16), grp, 256, 256)


def _small_overrides(root, target=0.0, name="ml25m_rank64"):
    out = [
        "data.dataset=synthetic-small", f"data.root={root}", "sgd.ublock=256",
        "sgd.iblock=256", "sgd.tile=64", "sgd.epochs=2", "sgd.dense_chi=0.01",
        f"target_rmse={target}",
    ]
    if name == "netflix100m_rank128_dp":  # int8 codes at rank 128
        return out + ["parallel.mode=single"]
    return out + ["sgd.dense_int4=on"]


PRESETS = {"ml25m_rank64": 64, "netflix100m_rank128_dp": 128}


@pytest.mark.parametrize("name", list(PRESETS))
def test_driver_trains_and_evaluates_on_cpu(tmp_path, name):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset(name), _small_overrides(tmp_path, name=name))
    res = train(cfg, device="cpu")
    assert res.epochs_run == 2 and len(res.history) == 2
    assert res.history[1]["train_metric"] < res.history[0]["train_metric"]
    assert np.isfinite(res.test_rmse) and 0 < res.test_rmse < 2
    assert res.model.P.shape == (256, PRESETS[name])
    assert res.updates_per_sec > 0


def test_driver_stops_at_target_rmse(tmp_path):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("ml25m_rank64"),
                          _small_overrides(tmp_path, target=10.0))
    assert train(cfg, device="cpu").epochs_run == 1


@pytest.mark.parametrize("mode", ["sharded", "dp"])
def test_driver_refuses_the_sgd_ring(tmp_path, mode):
    """netflix100m_rank128_dp as the preset has it (its 8-shard ring) and
    its data-parallel override are Q1-13; the message says how to train
    on one device."""
    from mfx_torch.train.driver import train

    name = "netflix100m_rank128_dp"
    cfg = apply_overrides(preset(name), _small_overrides(tmp_path, name=name)
                          + [f"parallel.mode={mode}"])
    with pytest.raises(NotImplementedError,
                       match=r"Queue 1 item 13 \(Q1-13\).*parallel.mode=single"):
        train(cfg, device="cpu")


@pytest.mark.parametrize("name", list(PRESETS))
def test_cli_prints_reference_json(capsys, tmp_path, name):
    from mfx_torch.cli import main

    args = ["train", "--preset", name, "--device", "cpu"]
    for ov in _small_overrides(tmp_path, name=name):
        args += ["--set", ov]
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"preset", "epochs_run", "updates_per_sec",
                        "test_rmse", "test_mae"}
    assert out["preset"] == name and out["epochs_run"] == 2
