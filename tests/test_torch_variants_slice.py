"""Two epochs of the port's blocked trainer against the reference trainer
(Pallas in interpret mode) under the dense and MXU settings the port took
last: ``sgd.dense_echo=2``, ``sgd.dense_spg=2``, ``sgd.mxu=bf16`` (lane,
and with tile biases and the step-batched user side) and
``sgd.dense_span=head``, from the same initial tables and the same plan
bits (tests/test_torch_slice.py's case; the head split on a catalog wider
than its 8,192 items), plus the driver and CLI on the preset with each."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mfx.config import apply_overrides, preset
from mfx.data import synthetic, train_test_split
from mfx.eval.metrics import rmse_mae as rmse_mae_j
from mfx.models import init_model
from mfx.solvers.blocked import train_epochs_blocked as train_j
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.eval.metrics import rmse_mae
from mfx_torch.solvers.blocked import train_epochs_blocked
from test_torch_slice import CFG, _jax_bits, _small_overrides

U = 600
KEYS = ("P", "Q", "bu", "bi")
# name: (overrides of CFG, items, table tol, RMSE tol). echo and spg sum
# as the echo=1 run does: test_torch_slice.py's rank-64 tolerances. bf16:
# one bf16 ulp of a delta where an ulp's difference in a residual crosses
# a rounding boundary (tests/test_torch_sgd_bf16.py), carried through two
# epochs. head: the catalog is 8,800 items (35 windows of 256), so the
# head's 32 windows leave strata with more than chi su si ratings sparse.
CASES = {
    "echo": (dict(dense_echo=2), 600, 1e-4, 1e-5),
    "spg": (dict(dense_spg=2), 600, 1e-4, 1e-5),
    "bf16": (dict(mxu="bf16"), 600, 2e-3, 1e-4),
    "bf16_tile_step_u": (dict(mxu="bf16", bias_mode="tile",
                              step_user_batch=True), 600, 2e-3, 1e-4),
    "head": (dict(dense_span="head", dense_chi=0.0005), 8800, 1e-4, 1e-5),
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _split(items):
    coo = synthetic.make_synthetic(U, items, 25_000, rank=4, noise=0.3,
                                   seed=9, star_step=0.5)
    return train_test_split(coo, test_frac=0.1, seed=0)


def _port(arrays, train, test, cfg, timings=None):
    got = []
    for _, m, tr in train_epochs_blocked(
            model_from_numpy(arrays, device="cpu"), train, cfg, True, seed=0,
            device="cpu", timings=timings, plan_rand=_jax_bits(0)):
        got.append((float(tr), rmse_mae(m, test)[0], model_to_numpy(m)))
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_two_epochs_match_reference_trainer(case):
    over, items, tab_tol, rmse_tol = CASES[case]
    cfg = dataclasses.replace(CFG, **over)
    train, test = _split(items)
    m0 = init_model(1, U, items, 64, global_mean=train.global_mean)
    arrays = {k: np.asarray(getattr(m0, k)) for k in KEYS + ("mu",)}
    ref = []
    info_j = {}
    # exact=True would override mxu_bf16 in the reference
    for _, view, tr in train_j(m0, train, cfg, use_bias=True, seed=0, tpg=4,
                               exact=cfg.mxu == "f32", interpret=True,
                               timings=info_j):
        m = view.materialize()
        ref.append((float(tr), rmse_mae_j(m, test)[0],
                    {k: np.asarray(getattr(m, k)) for k in KEYS}))
    timings = {}
    got = _port(arrays, train, test, cfg, timings)
    assert len(got) == len(ref) == 2
    info = timings["dense_info"]
    # the reference streams its spg padding's zero codes; the port carves
    # none, so its image is the real strata's share of the reference's
    real = info["num_strata"] / info.get("strata_padded", info["num_strata"])
    for k, v in info_j["dense_info"].items():
        assert info[k] == pytest.approx(v * (real if k == "r_stream_bytes"
                                             else 1)), k
    for (tr_t, te_t, _), (tr_j, te_j, _) in zip(got, ref):
        assert abs(tr_t - tr_j) <= rmse_tol
        assert abs(te_t - te_j) <= rmse_tol
    for k in KEYS:
        np.testing.assert_allclose(got[-1][2][k], ref[-1][2][k], rtol=0,
                                   atol=tab_tol, err_msg=k)
    assert got[1][0] < got[0][0]  # it trains
    if case == "spg":  # the null strata change nothing: the spg=1 run
        assert info["strata_padded"] > info["num_strata"]
        once = _port(arrays, train, test, dataclasses.replace(cfg,
                                                              dense_spg=1))
        for (a, b) in zip(got, once):
            assert a[0] == b[0] and a[1] == b[1]
            for k in KEYS:
                np.testing.assert_array_equal(a[2][k], b[2][k], err_msg=k)
    if case == "head":  # the head leaves dense-eligible strata sparse
        full = {}
        _port(arrays, train, test, dataclasses.replace(
            cfg, dense_span="full", epochs=1), full)
        assert full["dense_info"]["num_strata"] > info["num_strata"] > 0


@pytest.mark.parametrize("setting", [
    ["sgd.dense_echo=2"], ["sgd.dense_spg=2"], ["sgd.mxu=bf16"],
    ["sgd.dense_chi=0.0025", "sgd.dense_span=head"]])
def test_cli_takes_each_setting(capsys, tmp_path, setting):
    """``python -m mfx_torch.cli train --preset ml25m_rank64`` with each
    setting (on the small synthetic, on the CPU) trains and prints the
    reference's JSON keys."""
    from mfx_torch.cli import main

    args = ["train", "--preset", "ml25m_rank64", "--device", "cpu"]
    for ov in _small_overrides(tmp_path) + setting:
        args += ["--set", ov]
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epochs_run"] == 2 and np.isfinite(out["test_rmse"])


def test_driver_config_keeps_each_setting(tmp_path):
    """The overrides reach the trainer's config unchanged."""
    cfg = apply_overrides(preset("ml25m_rank64"), _small_overrides(tmp_path)
                          + ["sgd.dense_echo=2", "sgd.mxu=bf16"])
    assert (cfg.sgd.dense_echo, cfg.sgd.mxu) == (2, "bf16")
