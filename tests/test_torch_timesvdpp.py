"""timeSVD++ of the port against the reference: the time-aware Y step,
two ``'jnp'`` epochs of ``train_epochs_timesvdpp`` against the JAX
trainer, one ``'pallas'`` epoch against the reference's pieces composed as
its trainer runs them on a TPU, the collapses onto the port's timeSVD
(``lr_y = 0``) and SVD++ (``lr_t = lr_alpha = 0``) trainers, warm starts,
the state's npz file both ways, and ``solver='timesvdpp'`` through the
driver and the CLI (and the reference's refusals)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import TimeSVDPPConfig as TimeSVDPPConfig_j
from mfx.models.mf import init_model
from mfx.models.svdpp import implicit_sums as implicit_sums_j
from mfx.models.timesvd import TimeSVDModel as TimeSVDModel_j
from mfx.models.timesvd import fit_time_features as fit_j
from mfx.solvers import timesvd_blocked as tsb_j
from mfx.solvers import timesvdpp as tpp_j
from mfx.solvers.blocked import sweep_geometry as sweep_geometry_j
from mfx.solvers.svdpp import svdpp_run_constants as run_constants_j
from mfx_torch.config import (SVDPPConfig, TimeSVDConfig, TimeSVDPPConfig,
                              apply_overrides, preset)
from mfx_torch.convert import model_from_numpy, timesvdpp_state_from_numpy
from mfx_torch.data import loaders
from mfx_torch.models.timesvd import fit_time_features
from mfx_torch.solvers import svdpp
from mfx_torch.solvers import timesvdpp as tpp
from mfx_torch.solvers.timesvd_blocked import BLOCK, TILE
from test_torch_timesvd_blocked import _jax_bits, temporal_coo

NB = 8  # time bins
U, I, N = 300, 200, 8_000  # the reference tests' shapes
KEYS = ("P", "Q", "bu", "bi", "bt", "alpha")
STATE = ("P", "Q", "Y", "bu", "bi", "mu", "bt", "alpha", "nu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the trainers and the plain sweeps loop over
    many small CPU ops, and under a parallel test run the workers' thread
    pools would fight for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def coo():
    return temporal_coo(U, I, N, seed=7)


def _arrays(m):
    return {k: np.asarray(getattr(m, k)) for k in ("P", "Q", "bu", "bi",
                                                   "mu")}


def _state(rank, seed=0):
    """Full trainer state with every table nonzero (so S != 0 from the
    start), as numpy arrays in the reference's keys."""
    rng = np.random.default_rng(seed)
    m = init_model(seed, U, I, rank, global_mean=3.5)
    st = {k: np.asarray(getattr(m, k), np.float32) for k in ("P", "Q", "mu")}
    st.update(Y=rng.normal(0, 0.05, (I, rank)), bu=rng.normal(0, 0.1, U),
              bi=rng.normal(0, 0.1, I), bt=rng.normal(0, 0.05, (I, NB)),
              alpha=rng.normal(0, 0.05, U), nu=np.zeros(U))
    return {k: np.asarray(v, np.float32) for k, v in st.items()}


@pytest.mark.parametrize("tr_eta", [None, 0.0])
def test_y_step_t_matches_the_reference(coo, tr_eta):
    """The time-aware Y step on the reference's padded chunks (1,024
    ratings, with ``tbins`` and ``devs``): Y within 1e-6, the SSE 1e-6
    relative."""
    feats = fit_j(coo, n_bins=NB)
    tb, dv = feats.features(coo.user, coo.timestamp)
    chunks_j = tpp_j._coo_chunks_t(coo, 1024, tb, dv)
    chunks_t = svdpp.coo_chunks(coo, 1024, "cpu",
                                extras={"tbins": tb, "devs": dv})
    for k, v in chunks_t.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(chunks_j[k]))
    a = _state(16, seed=1)
    rng = np.random.default_rng(2)
    nu = rng.uniform(0.1, 1.0, U).astype(np.float32)
    deg_i = np.bincount(coo.item, minlength=I).astype(np.float32)
    y_scale = rng.uniform(0.3, 1.0, I).astype(np.float32)
    names = ("Y", "P", "Q", "bu", "bi", "mu", "bt", "alpha")
    Y_j, sse_j = tpp_j.y_gradient_step_t(
        *(jnp.asarray(a[k]) for k in names), jnp.asarray(nu),
        jnp.asarray(deg_i), jnp.asarray(y_scale), chunks_j, 0.01, 0.05,
        tr_eta=tr_eta)
    Y_t, sse_t = tpp.y_gradient_step_t(
        *(torch.tensor(a[k]) if k != "mu" else float(a[k])
          for k in names), torch.as_tensor(nu), torch.as_tensor(deg_i),
        torch.as_tensor(y_scale), chunks_t, 0.01, 0.05, tr_eta=tr_eta)
    np.testing.assert_allclose(Y_t.numpy(), np.asarray(Y_j), rtol=0,
                               atol=1e-6)
    assert abs(float(sse_t) - float(sse_j)) <= 1e-6 * float(sse_j)


@pytest.mark.parametrize("partitioner", ["fixed", "conflict_free"])
def test_two_jnp_epochs_match_the_reference(coo, partitioner):
    """Two ``'jnp'`` epochs against the JAX trainer from the same tables
    on the same batches: the train RMSE and the views' tables within
    1e-5; the train RMSE falls."""
    kw = dict(lr=0.01, reg=0.02, epochs=2, batch_size=256, n_bins=NB,
              partitioner=partitioner)
    m0 = init_model(5, U, I, 16, global_mean=coo.global_mean)
    ref = [(tr, m) for _, m, tr in tpp_j.train_epochs_timesvdpp(
        m0, coo, TimeSVDPPConfig_j(**kw), seed=3,
        feats=fit_j(coo, n_bins=NB))]
    got = [(tr, m) for _, m, tr in tpp.train_epochs_timesvdpp(
        model_from_numpy(_arrays(m0), device="cpu"), coo,
        TimeSVDPPConfig(**kw), seed=3,
        feats=fit_time_features(coo, n_bins=NB))]
    for (tr_t, m_t), (tr_j, m_j) in zip(got, ref, strict=True):
        assert abs(tr_t - float(tr_j)) <= 1e-5
        for k in KEYS:
            np.testing.assert_allclose(getattr(m_t, k).numpy(),
                                       np.asarray(getattr(m_j, k)), rtol=0,
                                       atol=1e-5, err_msg=k)
    assert got[1][0] < got[0][0]


PALLAS = dict(lr=0.02, reg=0.02, lr_y=0.02, reg_y=0.02, epochs=1,
              n_bins=NB, kernel="pallas", reg_alpha=0.02)
RANK, SEED = 32, 4  # rank 32: four slots a reference lane row


@pytest.fixture(scope="module")
def pallas_reference(coo):
    """One ``'pallas'`` epoch of the reference from :func:`_state`, its
    pieces composed as its trainer composes them on a TPU: the device
    planner (epoch id 0), ``run_temporal_epoch`` in interpret mode, and the
    tile-plan Y step ``y_gradient_step_tiles``. Returns the train RMSE,
    the view's tables and Y."""
    st = _state(RANK)
    feats = fit_j(coo, n_bins=NB)
    tb, dv = feats.features(coo.user, coo.timestamp)
    su = BLOCK
    args, meta = tsb_j.plan_temporal_epoch(
        coo, tb, dv, su=su, si=su, tile=TILE, tpg=4,
        nwin=sweep_geometry_j(I, RANK, su), seed=SEED, epoch=0, device=True)
    m0 = init_model(0, U, I, RANK, global_mean=3.5)
    _, _, nu, deg_i, y_scale, _ = run_constants_j(
        m0, coo, TimeSVDPPConfig_j(**PALLAS), None)
    u, i, Y = jnp.asarray(coo.user), jnp.asarray(coo.item), jnp.asarray(
        st["Y"])
    S = implicit_sums_j(Y, u, i, nu)
    ts = TimeSVDModel_j(P=jnp.asarray(st["P"]) + S, **{
        k: jnp.asarray(st[k]) for k in ("Q", "bu", "bi", "mu", "bt",
                                        "alpha")})
    ts, sse = tsb_j.run_temporal_epoch(ts, args, meta, PALLAS["lr"],
                                       PALLAS["reg"], NB, su=su, si=su,
                                       tpg=4, interpret=True)
    Y1, _ = tpp_j.y_gradient_step_tiles(
        Y, ts.P, ts.Q, ts.bu, ts.bi, ts.mu, ts.bt, ts.alpha, nu, deg_i,
        y_scale, tuple(args), jnp.float32(PALLAS["lr_y"]),
        jnp.float32(PALLAS["reg_y"]), su=su, si=su, tpg=4, n_bins=NB,
        sweep_meta=tuple(meta))
    P = ts.P - S + implicit_sums_j(Y1, u, i, nu)
    tables = {k: np.asarray(getattr(ts, k)) for k in KEYS}
    tables["P"] = np.asarray(P)
    return float(np.sqrt(float(sse) / coo.n_ratings)), tables, np.asarray(Y1)


def _pallas_run(coo, cfg=None, **kw):
    cap = {}
    out = list(tpp.train_epochs_timesvdpp(
        model_from_numpy(_state(RANK), device="cpu"), coo,
        cfg or TimeSVDPPConfig(**PALLAS), seed=SEED,
        feats=fit_time_features(coo, n_bins=NB),
        init_state=timesvdpp_state_from_numpy(_state(RANK)), capture=cap,
        plan_rand=_jax_bits(SEED), **kw))
    return out, cap["state"]


def test_one_pallas_epoch_matches_the_reference_pieces(coo,
                                                       pallas_reference):
    """One ``'pallas'`` epoch on the CPU (the sweep's plain version) on the
    reference's shuffle bits, from a state whose S is not 0: the train
    RMSE within 1e-5 and the view's tables within 1e-4 (the blocked
    timeSVD trainer's tolerance); Y within rtol 2e-4 / atol 2e-5 of the
    reference's tile-plan Y step, which sums in another order (the
    reference holds its two forms to that)."""
    rmse_j, tables_j, Y_j = pallas_reference
    timings = {}
    ((_, m, rmse_t),), state = _pallas_run(coo, timings=timings)
    assert abs(rmse_t - rmse_j) <= 1e-5
    for k in KEYS:
        np.testing.assert_allclose(getattr(m, k).numpy(), tables_j[k],
                                   rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(state.Y, Y_j, rtol=2e-4, atol=2e-5)
    assert np.abs(state.Y - _state(RANK)["Y"]).max() > 1e-3
    assert timings["prep_s"] > 0 and len(timings["y_ms"]) == 1


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_lr_y_zero_is_the_timesvd_trainer(coo, kernel):
    """With the Y step off, ``kernel='jnp'`` is the port's minibatch
    timeSVD trainer and ``'pallas'`` its blocked one bit for bit (tables
    and train RMSE)."""
    from mfx_torch.solvers.timesvd import train_epochs_timesvd
    from mfx_torch.solvers.timesvd_blocked import train_epochs_timesvd_blocked

    rank = 16 if kernel == "jnp" else RANK
    kw = dict(lr=0.02, reg=0.02, lr_decay=0.9, epochs=2, batch_size=512,
              n_bins=NB, partitioner="conflict_free", kernel=kernel,
              reg_alpha=0.02)
    m0 = model_from_numpy(_arrays(init_model(0, U, I, rank,
                                             global_mean=coo.global_mean)),
                          device="cpu")
    feats = fit_time_features(coo, n_bins=NB)
    parent = (train_epochs_timesvd if kernel == "jnp"
              else train_epochs_timesvd_blocked)
    a = [(float(tr), m) for _, m, tr in parent(
        m0, coo, TimeSVDConfig(**kw), seed=5, feats=feats)]
    b = [(tr, m) for _, m, tr in tpp.train_epochs_timesvdpp(
        m0, coo, TimeSVDPPConfig(lr_y=0.0, **kw), seed=5, feats=feats)]
    for (tr_a, x), (tr_b, y) in zip(a, b, strict=True):
        assert tr_a == tr_b
        for k in KEYS:
            assert torch.equal(getattr(x, k), getattr(y, k)), k


def test_temporal_rates_zero_is_the_svdpp_trainer(coo):
    """With ``lr_t = lr_alpha = 0`` the temporal tables stay 0 and every
    prediction adds exact zeros: the SVD++ trainer's trajectory bit for
    bit (the same seed and partitioner give the same batches and Y
    steps)."""
    common = dict(lr=0.05, reg=0.02, lr_decay=0.9, epochs=2, batch_size=512,
                  partitioner="conflict_free", lr_y=0.01, reg_y=0.02,
                  y_trust=16.0)
    m0 = model_from_numpy(_arrays(init_model(0, U, I, 4,
                                             global_mean=coo.global_mean)),
                          device="cpu")
    a = [(tr, m) for _, m, tr in tpp.train_epochs_timesvdpp(
        m0, coo, TimeSVDPPConfig(lr_t=0.0, lr_alpha=0.0, n_bins=4, **common),
        seed=9)]
    b = [(tr, m) for _, m, tr in svdpp.train_epochs_svdpp(
        m0, coo, SVDPPConfig(**common), True, seed=9)]
    assert not a[-1][1].bt.any() and not a[-1][1].alpha.any()
    for (tr_a, x), (tr_b, y) in zip(a, b, strict=True):
        assert tr_a == tr_b
        for k in ("P", "Q", "bu", "bi"):
            assert torch.equal(getattr(x, k), getattr(y, k)), k


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_warm_start_continues_bitwise(tmp_path, coo, kernel):
    """capture -> save_npz -> load_npz (the reference's loader too) ->
    init_state: 2 epochs and a resumed one equal 3 straight epochs bit
    for bit; a state of other bins is refused."""
    kw = dict(lr=0.05, reg=0.02, lr_decay=0.9, batch_size=512, n_bins=NB,
              partitioner="conflict_free", kernel=kernel, reg_alpha=0.02)
    base = model_from_numpy(_arrays(init_model(
        0, U, I, 16, global_mean=coo.global_mean)), device="cpu")

    def run(epochs, **extra):
        return list(tpp.train_epochs_timesvdpp(
            base, coo, TimeSVDPPConfig(epochs=epochs, **kw), seed=3,
            **extra))

    straight = run(3)
    cap = {}
    run(2, capture=cap)
    cap["state"].save_npz(tmp_path / "st.npz")
    st = tpp.TimeSVDppState.load_npz(tmp_path / "st.npz")
    back_j = tpp_j.TimeSVDppState.load_npz(tmp_path / "st.npz")
    for k in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(back_j, k)),
                                      getattr(st, k))
    resumed = run(3, start_epoch=2, init_state=st)
    assert [e for e, _, _ in resumed] == [2]
    for (_, x, tr_x), (_, y, tr_y) in zip(straight[2:], resumed, strict=True):
        assert tr_x == tr_y
        for k in KEYS:
            assert torch.equal(getattr(x, k), getattr(y, k)), k
    with pytest.raises(ValueError, match="bins"):
        next(tpp.train_epochs_timesvdpp(
            base, coo, TimeSVDPPConfig(epochs=3, **{**kw, "n_bins": 7}),
            start_epoch=2, init_state=st))


def test_state_npz_moves_both_ways(tmp_path):
    a = _state(8, seed=3)
    st_t = timesvdpp_state_from_numpy(a)
    st_t.save_npz(tmp_path / "t.npz")
    back_j = tpp_j.TimeSVDppState.load_npz(tmp_path / "t.npz")
    tpp_j.TimeSVDppState(**a).save_npz(tmp_path / "j.npz")
    back_t = tpp.TimeSVDppState.load_npz(tmp_path / "j.npz")
    for k in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(back_j, k)), a[k])
        np.testing.assert_array_equal(getattr(back_t, k), a[k])


def _root(tmp_path, n=6_000):
    """A data root holding a timestamped dataset as the loader's real-data
    cache of ``synthetic-small``."""
    root = tmp_path / "data"
    root.mkdir(exist_ok=True)
    temporal_coo(U, I, n, seed=11).save_npz(
        root / f"synthetic-small.v{loaders.GENERATOR_VERSION}.npz")
    return root


def _cfg(root, kernel, *extra):
    return apply_overrides(preset("ml1m_rank32_biased"), [
        "solver=timesvdpp", "data.dataset=synthetic-small",
        f"data.root={root}", "model.rank=32", f"timesvdpp.kernel={kernel}",
        f"timesvdpp.n_bins={NB}", "timesvdpp.epochs=2", "timesvdpp.lr=0.01",
        "timesvdpp.reg_alpha=0.02", "timesvdpp.batch_size=512", *extra])


@pytest.mark.parametrize("kernel", ["pallas", "jnp"])
def test_driver_and_cli_train_timesvdpp(tmp_path, capsys, kernel):
    """``solver='timesvdpp'`` through the driver on the CPU with either
    kernel: the train RMSE falls, the held-out RMSE is the time-aware one
    of the trainer's last model, the result and the checkpoint take its
    MF view; the CLI prints the reference's JSON."""
    from mfx_torch.cli import main
    from mfx_torch.data.split import train_test_split
    from mfx_torch.models.mf import MFModel
    from mfx_torch.models.mf import init_model as init_t
    from mfx_torch.solvers.timesvd import rmse_mae_time
    from mfx_torch.train.checkpoint import load_checkpoint
    from mfx_torch.train.driver import train

    root = _root(tmp_path)
    ck = tmp_path / "ck"
    cfg = _cfg(root, kernel, f"checkpoint_dir={ck}")
    res = train(cfg, device="cpu")
    trains = [r["train_metric"] for r in res.history]
    assert res.epochs_run == 2 and trains[1] < trains[0]
    assert isinstance(res.model, MFModel)
    coo = loaders.load_dataset("synthetic-small", root=root)
    tr, te = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    g = torch.Generator().manual_seed(cfg.model.seed)
    m0 = init_t(g, U, I, 32, global_mean=tr.global_mean,
                init_scale=cfg.model.init_scale)
    feats = fit_time_features(tr, n_bins=NB)
    *_, (_, ts, _) = tpp.train_epochs_timesvdpp(m0, tr, cfg.timesvdpp,
                                                seed=cfg.data.seed,
                                                feats=feats)
    assert (res.test_rmse, res.test_mae) == rmse_mae_time(ts, feats, te,
                                                          clip=(0.5, 5.0))
    m, epoch, _ = load_checkpoint(ck, device="cpu")
    assert epoch == 1 and torch.equal(m.bu, ts.as_mf(feats).bu)
    args = ["train", "--preset", "ml1m_rank32_biased", "--device", "cpu"]
    for ov in ("solver=timesvdpp", "data.dataset=synthetic-small",
               f"data.root={root}", "model.rank=32",
               f"timesvdpp.kernel={kernel}", f"timesvdpp.n_bins={NB}",
               "timesvdpp.epochs=1", "timesvdpp.reg_alpha=0.02"):
        args += ["--set", ov]
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epochs_run"] == 1 and np.isfinite(out["test_rmse"])


@pytest.mark.parametrize("override", ["parallel.mode=dp",
                                      "model.use_bias=false"])
def test_driver_refusals_are_the_reference_refusals(tmp_path, override):
    """The reference's driver refuses these with ValueError
    (tests/unit/test_timesvdpp.py), and so does the port's, with either
    kernel."""
    from mfx.config import apply_overrides as apply_j
    from mfx.config import preset as preset_j
    from mfx.train.driver import train as train_j
    from mfx_torch.train.driver import train

    root = _root(tmp_path, n=800)
    extra = [override] + (["parallel.data_axis=2"]
                          if "parallel" in override else [])
    for kernel in ("jnp", "pallas"):
        with pytest.raises(ValueError):
            train(_cfg(root, kernel, *extra), device="cpu")
    with pytest.raises(ValueError):
        train_j(apply_j(preset_j("ml1m_rank32_biased"), [
            "solver=timesvdpp", "data.dataset=synthetic-small",
            f"data.root={root}", "model.rank=4", "timesvdpp.epochs=1",
            *extra]), resume=False)


def _refusals(train_fn, cfg_cls, mf_model, state):
    """The trainer's refusals: no biases, a resume without a state, a
    state of other bins, and on 'pallas' a schedule off the uniform one, a
    rank that does not divide 128, more bins than rank - 4."""
    coo = temporal_coo(U, I, 2_000)
    cases = (
        (cfg_cls(n_bins=NB), mf_model(32), {"use_bias": False}),
        (cfg_cls(n_bins=NB), mf_model(32), {"start_epoch": 1}),
        (cfg_cls(n_bins=7), mf_model(32), {"start_epoch": 1,
                                           "init_state": state}),
        (cfg_cls(kernel="pallas", n_bins=NB, lr_t=0.001), mf_model(32), {}),
        (cfg_cls(kernel="pallas", n_bins=NB), mf_model(48), {}),
        (cfg_cls(kernel="pallas", n_bins=30), mf_model(32), {}),
    )
    out = []
    for cfg, model, kw in cases:
        with pytest.raises(Exception) as info:
            next(iter(train_fn(model, coo, cfg, **kw)))
        out.append((type(info.value), str(info.value).split(";")[0]))
    return out


def test_trainer_refusals_are_the_reference_refusals():
    """The same exception types as the reference's trainer (all
    ValueError), with the same first clause."""
    st = _state(32)

    def mf_j(rank):
        return init_model(0, U, I, rank, global_mean=3.5)

    want = _refusals(tpp_j.train_epochs_timesvdpp, TimeSVDPPConfig_j, mf_j,
                     tpp_j.TimeSVDppState(**st))
    got = _refusals(
        tpp.train_epochs_timesvdpp, TimeSVDPPConfig,
        lambda rank: model_from_numpy(_arrays(mf_j(rank)), device="cpu"),
        timesvdpp_state_from_numpy(st))
    assert [t for t, _ in want] == [ValueError] * 6
    assert [t for t, _ in got] == [t for t, _ in want]
    assert [m for _, m in got] == [m for _, m in want]
    assert dataclasses.asdict(TimeSVDPPConfig()) == dataclasses.asdict(
        TimeSVDPPConfig_j())
