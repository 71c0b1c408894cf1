"""The tile-bias slice end to end: two epochs of the port's blocked
trainer against the reference trainer (Pallas in interpret mode) from the
same initial tables and the same plan bits, per tile and with
``sgd.step_user_batch``, plus the port's ``train`` entry point and CLI on the
``ml1m_rank32_biased`` preset and the configurations that still raise."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import apply_overrides as apply_overrides_j
from mfx.config import preset as preset_j
from mfx.data import synthetic, train_test_split
from mfx.eval.metrics import rmse_mae as rmse_mae_j
from mfx.models import init_model
from mfx.solvers.blocked import sweep_geometry as sweep_geometry_j
from mfx.solvers.blocked import VMEM_Q_BUDGET
from mfx.solvers.blocked import train_epochs_blocked as train_j
from mfx_torch.config import apply_overrides, preset
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.eval.metrics import rmse_mae
from mfx_torch.models.mf import init_model as init_model_t
from mfx_torch.solvers.blocked import sweep_geometry, train_epochs_blocked

U, I, N = 600, 500, 20_000
CUT = ["sgd.ublock=128", "sgd.iblock=128", "sgd.tile=32", "sgd.epochs=2",
       "sgd.plan_device=device"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a process: the plain sweeps loop over many small
    CPU ops, and under ``pytest -n 6`` the workers' thread pools otherwise
    fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split():
    coo = synthetic.make_synthetic(U, I, N, rank=4, noise=0.3, seed=9,
                                   star_step=1.0)
    return train_test_split(coo, test_frac=0.1, seed=0)


def _jax_bits(seed):
    def bits(epoch, n):
        key = jax.random.fold_in(jax.random.key(seed), epoch)
        return torch.as_tensor(np.array(
            jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)))
    return bits


@pytest.mark.parametrize("step_u", [False, True])
def test_two_epochs_match_reference_trainer(step_u):
    ov = CUT + [f"sgd.step_user_batch={str(step_u).lower()}"]
    cfg_j = apply_overrides_j(preset_j("ml1m_rank32_biased"), ov)
    cfg = apply_overrides(preset("ml1m_rank32_biased"), ov)
    assert dataclasses.asdict(cfg.sgd) == dataclasses.asdict(cfg_j.sgd)
    rank = cfg.model.rank
    train, test = _split()
    m0 = init_model(1, U, I, rank, global_mean=train.global_mean)
    arrays = {k: np.asarray(getattr(m0, k))
              for k in ("P", "Q", "bu", "bi", "mu")}

    ref = []
    for _, view, tr in train_j(m0, train, cfg_j.sgd, use_bias=True, seed=0,
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

    assert len(got) == len(ref) == 2
    for (tr_t, te_t, _), (tr_j, te_j, _) in zip(got, ref):
        assert abs(tr_t - tr_j) <= 1e-5
        assert abs(te_t - te_j) <= 1e-5
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_allclose(got[-1][2][k], ref[-1][2][k], rtol=0,
                                   atol=1e-4, err_msg=k)
    assert np.abs(got[-1][2]["bu"]).max() > 0  # the biases train
    assert got[1][0] < got[0][0]  # it trains
    assert got[-1][2]["P"].shape == (U, rank)


@pytest.mark.parametrize("rank", [16, 8, 2])
def test_one_epoch_below_rank_32_matches_reference_trainer(rank):
    """The preset with ``model.rank`` 16, 8 or 2 (pack 8, 16 or 64 in the
    reference; no dense phase in either package): one epoch of the port's
    trainer against the reference's on the same plan bits, the RMSEs
    within 1e-5."""
    _one_epoch_against_reference(rank, [])


def test_one_lane_epoch_at_rank_2_matches_reference_trainer():
    """The baseline predictor mu + bu + bi: the preset at ``model.rank=2``
    with ``sgd.bias_mode=lane`` (P rows ``[1, bu]``, Q rows ``[bi, 1]``,
    both lanes frozen on one side), one epoch against the reference's."""
    _one_epoch_against_reference(2, ["sgd.bias_mode=lane"])


def _one_epoch_against_reference(rank, extra):
    ov = CUT + ["sgd.epochs=1", f"model.rank={rank}"] + extra
    cfg_j = apply_overrides_j(preset_j("ml1m_rank32_biased"), ov)
    cfg = apply_overrides(preset("ml1m_rank32_biased"), ov)
    assert cfg.model.rank == cfg_j.model.rank == rank
    train, test = _split()
    m0 = init_model(1, U, I, rank, global_mean=train.global_mean)
    arrays = {k: np.asarray(getattr(m0, k))
              for k in ("P", "Q", "bu", "bi", "mu")}
    (_, view, tr_j), = train_j(m0, train, cfg_j.sgd, use_bias=True, seed=0,
                               tpg=4, exact=True, interpret=True)
    ref = view.materialize()
    (_, m, tr_t), = train_epochs_blocked(
        model_from_numpy(arrays, device="cpu"), train, cfg.sgd, True, seed=0,
        device="cpu", plan_rand=_jax_bits(0))
    assert abs(float(tr_t) - float(tr_j)) <= 1e-5
    assert abs(rmse_mae(m, test)[0] - rmse_mae_j(ref, test)[0]) <= 1e-5
    got = model_to_numpy(m)
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(ref, k)),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert got["P"].shape == (U, rank) and np.abs(got["bu"]).max() > 0


def test_the_two_bodies_differ_from_the_first_epoch():
    cfg = apply_overrides(preset("ml1m_rank32_biased"), CUT + ["sgd.epochs=1"])
    train, _ = _split()
    outs = []
    for step_u in (False, True):
        sgd = dataclasses.replace(cfg.sgd, step_user_batch=step_u)
        model = init_model_t(torch.Generator().manual_seed(0), U, I,
                             cfg.model.rank, global_mean=train.global_mean)
        (_, m, tr), = train_epochs_blocked(model, train, sgd, True, seed=0,
                                           device="cpu")
        outs.append((float(tr), m))
    assert 1e-6 < abs(outs[0][0] - outs[1][0]) < 1e-2
    assert not torch.equal(outs[0][1].P, outs[1][1].P)


def test_trainer_without_biases_leaves_them_alone():
    cfg = apply_overrides(preset("ml1m_rank32_biased"), CUT + ["sgd.epochs=1"])
    train, _ = _split()
    rng = np.random.default_rng(0)
    arrays = {"P": rng.normal(0, 0.1, (U, 32)), "Q": rng.normal(0, 0.1, (I, 32)),
              "bu": rng.normal(0, 0.1, U), "bi": rng.normal(0, 0.1, I),
              "mu": train.global_mean}
    model = model_from_numpy(arrays, device="cpu")
    (_, m, _), = train_epochs_blocked(model, train, cfg.sgd, False, seed=0,
                                      device="cpu")
    assert torch.equal(m.bu, model.bu) and torch.equal(m.bi, model.bi)
    assert not torch.equal(m.P, model.P)


@pytest.mark.parametrize("items,rank,su,si,tile", [
    (3706, 32, 512, 512, 256), (59047, 64, 1024, 1024, 256),
    (500, 32, 128, 128, 32), (200_000, 64, 1024, 512, 256)])
def test_sweep_geometry_takes_the_step_u_budget_cut(items, rank, su, si, tile):
    budget = VMEM_Q_BUDGET - 4 * tile * (su // (128 // rank) + 4 * 128) * 4
    want = sweep_geometry_j(items, rank, si, budget=max(1 << 21, budget))
    assert sweep_geometry(items, rank, si, step_u=(su, tile)) == want
    assert sweep_geometry(items, rank, si) == sweep_geometry_j(items, rank, si)


@pytest.mark.parametrize("overrides,what", [
    (["sgd.dense_chi=0.01", "sgd.dense_span=full"], "bias_mode.*dense"),
    (["sgd.dense_chi=0.01", "sgd.dense_span=full",
      "sgd.step_user_batch=true"], "bias_mode.*dense"),
    (["sgd.bias_mode=epoch"], "bias_mode='epoch'"),
    (["sgd.plan_device=host"], "plan_device"),
    (["sgd.mxu=bf16"], "mxu"),
    (["sgd.kernel=blocked_jnp"], "kernel"),
])
def test_unported_variants_raise(overrides, what):
    """Each variant raises, naming its field; except the first three
    (tile biases with the dense phase on, per tile and with
    ``step_user_batch``, and ``bias_mode='epoch'``), which raised until
    the frozen-bias dense form and the epoch form were ported: they now
    train on the CPU (rank 32 through the plain versions; their parity
    with the reference: tests/test_torch_bias_modes.py); the card's dense
    form check takes rank 32 and still refuses a rank it has no instance
    of (the reference's dense path has none either); for 'epoch', the
    reference's own refusal of ``step_user_batch`` stands. ``mxu=bf16``
    raised until the sweeps' bf16 form was ported: it now trains
    (its parity: tests/test_torch_sgd_bf16.py)."""
    from mfx_torch.kernels.dense_phase import check_kernel_form

    cfg = apply_overrides(preset("ml1m_rank32_biased"), CUT + overrides)
    train, _ = _split()
    model = model_from_numpy({
        "P": np.zeros((U, 32), np.float32), "Q": np.zeros((I, 32), np.float32),
        "bu": np.zeros(U, np.float32), "bi": np.zeros(I, np.float32),
        "mu": 3.5}, device="cpu")
    if what in ("bias_mode.*dense", "bias_mode='epoch'", "mxu"):
        timings = {}
        (_, m, tr), = train_epochs_blocked(
            model, train, dataclasses.replace(cfg.sgd, epochs=1), True,
            device="cpu", timings=timings)
        assert np.isfinite(float(tr)) and float(m.bu.abs().max()) > 0
        assert ("dense_info" in timings) == (what == "bias_mode.*dense")
        if what == "mxu":  # the bf16 form differs from the f32 one
            (_, m32, _), = train_epochs_blocked(
                model, train, dataclasses.replace(cfg.sgd, epochs=1,
                                                  mxu="f32"), True,
                device="cpu")
            assert not torch.equal(m.bu, m32.bu)
        elif what == "bias_mode='epoch'":
            with pytest.raises(ValueError, match="step_user_batch"):
                apply_overrides(cfg, ["sgd.step_user_batch=true"])
        else:
            grp = {"R": torch.zeros((1, 128, 64), dtype=torch.uint8)}
            check_kernel_form(torch.zeros(128, 32), grp, 128, 128)
            with pytest.raises(NotImplementedError, match="no other form"):
                check_kernel_form(torch.zeros(128, 16), grp, 128, 128)
        return
    with pytest.raises(NotImplementedError, match=what):
        next(train_epochs_blocked(model, train, cfg.sgd, True, device="cpu"))


def _small_overrides(root, step_u):
    return ["data.dataset=synthetic-small", f"data.root={root}",
            "sgd.epochs=2", f"sgd.step_user_batch={str(step_u).lower()}"]


@pytest.mark.parametrize("step_u", [False, True])
def test_train_runs_the_preset_on_cpu(tmp_path, step_u):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("ml1m_rank32_biased"),
                          _small_overrides(tmp_path, step_u))
    res = train(cfg, device="cpu")
    assert res.epochs_run == 2 and len(res.history) == 2
    assert res.history[1]["train_metric"] < res.history[0]["train_metric"]
    assert np.isfinite(res.test_rmse) and 0 < res.test_rmse < 2
    assert res.model.P.shape[1] == 32 and res.updates_per_sec > 0
    assert float(res.model.bu.abs().max()) > 0


def test_train_refuses_baseline_bias_init(tmp_path):
    """``model.bias_init='baseline'`` is ported: a fresh run starts from
    the baseline predictor's biases. What the driver still refuses beside
    it is bf16 tables for the fused blocked kernel, with the reference's
    own error."""
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("ml1m_rank32_biased"),
                          _small_overrides(tmp_path, False)
                          + ["model.bias_init=baseline"])
    res = train(cfg, device="cpu")
    assert res.epochs_run == 2 and np.isfinite(res.test_rmse)
    with pytest.raises(ValueError, match="keeps factor tables in float32"):
        train(apply_overrides(cfg, ["model.dtype=bfloat16"]), device="cpu")


@pytest.mark.parametrize("step_u", [False, True])
def test_cli_prints_reference_json(capsys, tmp_path, step_u):
    from mfx_torch.cli import main

    args = ["train", "--preset", "ml1m_rank32_biased", "--device", "cpu"]
    for ov in _small_overrides(tmp_path, step_u):
        args += ["--set", ov]
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"preset", "epochs_run", "updates_per_sec",
                        "test_rmse", "test_mae"}
    assert out["preset"] == "ml1m_rank32_biased" and out["epochs_run"] == 2
