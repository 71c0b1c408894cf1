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


def test_two_epochs_match_reference_trainer():
    train, test = _split()
    m0 = init_model(1, U, I, RANK, global_mean=train.global_mean)
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
        model_from_numpy(arrays), train, CFG, True, seed=0, device="cpu", timings=timings, plan_rand=_jax_bits(0),
    ):
        got.append((float(tr), rmse_mae(m, test)[0], model_to_numpy(m)))

    assert len(got) == len(ref) == 2
    info = timings["dense_info"]
    assert info["num_strata"] == 5 and 0 < info["dense_frac"] < 1
    for (tr_t, te_t, tab_t), (tr_j, te_j, tab_j) in zip(got, ref):
        assert abs(tr_t - tr_j) <= 1e-5
        assert abs(te_t - te_j) <= 1e-5
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_allclose(got[-1][2][k], ref[-1][2][k], rtol=0,
                                   atol=1e-4, err_msg=k)
    assert got[1][0] < got[0][0]  # it trains


@pytest.mark.parametrize("override,what", [
    ("bias_mode=tile", "bias_mode"),
    ("dense_span=head", "dense_span"),
    ("dense_spg=2", "dense_spg"),
    ("dense_echo=2", "dense_echo"),
    ("mxu=bf16", "mxu"),
    ("plan_device=host", "plan_device"),
])
def test_unported_variants_raise(override, what):
    import dataclasses

    key, val = override.split("=")
    cfg = dataclasses.replace(
        CFG, **{key: int(val) if val.isdigit() else val})
    train, _ = _split()
    model = model_from_numpy({
        "P": np.zeros((U, RANK), np.float32), "Q": np.zeros((I, RANK), np.float32),
        "bu": np.zeros(U, np.float32), "bi": np.zeros(I, np.float32), "mu": 3.5,
    })
    with pytest.raises(NotImplementedError, match=what):
        next(train_epochs_blocked(model, train, cfg, True, device="cpu"))


def _small_overrides(root, target=0.0):
    return [
        "data.dataset=synthetic-small", f"data.root={root}", "sgd.ublock=256",
        "sgd.iblock=256", "sgd.tile=64", "sgd.epochs=2", "sgd.dense_chi=0.01",
        "sgd.dense_int4=on", f"target_rmse={target}",
    ]


def test_driver_trains_and_evaluates_on_cpu(tmp_path):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("ml25m_rank64"), _small_overrides(tmp_path))
    res = train(cfg, device="cpu")
    assert res.epochs_run == 2 and len(res.history) == 2
    assert res.history[1]["train_metric"] < res.history[0]["train_metric"]
    assert np.isfinite(res.test_rmse) and 0 < res.test_rmse < 2
    assert res.model.P.shape == (256, RANK) and res.updates_per_sec > 0


def test_driver_stops_at_target_rmse(tmp_path):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("ml25m_rank64"),
                          _small_overrides(tmp_path, target=10.0))
    assert train(cfg, device="cpu").epochs_run == 1


def test_cli_prints_reference_json(capsys, tmp_path):
    from mfx_torch.cli import main

    args = ["train", "--preset", "ml25m_rank64", "--device", "cpu"]
    for ov in _small_overrides(tmp_path):
        args += ["--set", ov]
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"preset", "epochs_run", "updates_per_sec",
                        "test_rmse", "test_mae"}
    assert out["preset"] == "ml25m_rank64" and out["epochs_run"] == 2
