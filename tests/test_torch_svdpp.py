"""SVD++ of the port against the reference: the implicit sums and the run
constants, the Y step (both its forms), two epochs of
``train_epochs_svdpp`` under both partitioners, the collapse onto the
plain minibatch trainer at ``lr_y = 0``, the model and its npz file both
ways, and ``solver='svdpp'`` through the driver and the CLI (and the
reference's refusals)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import SVDPPConfig as SVDPPConfig_j
from mfx.data.split import train_test_split as split_j
from mfx.data.synthetic import make_synthetic
from mfx.models.mf import init_model
from mfx.models.svdpp import SVDppModel as SVDppModel_j
from mfx.models.svdpp import implicit_scale as implicit_scale_j
from mfx.models.svdpp import implicit_sums as implicit_sums_j
from mfx.solvers import svdpp as svdpp_j
from mfx_torch.config import SGDConfig, SVDPPConfig, apply_overrides, preset
from mfx_torch.convert import (model_from_numpy, svdpp_from_numpy,
                               svdpp_to_numpy)
from mfx_torch.data import loaders
from mfx_torch.models.svdpp import (SVDppModel, implicit_scale,
                                    implicit_sums, init_svdpp)
from mfx_torch.solvers import svdpp

KEYS = ("P", "Q", "bu", "bi")
U, I, N = 300, 200, 8_000  # the reference test's shapes


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the trainers loop over many small CPU ops, and
    under a parallel test run the workers' thread pools would fight for
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def split():
    coo = make_synthetic(U, I, N, rank=6, noise=0.3, seed=11)
    return split_j(coo, 0.1, seed=1)


def _arrays(m):
    return {k: np.asarray(getattr(m, k)) for k in KEYS + ("mu",)}


def _svdpp_arrays(rank=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"P": rng.normal(0, 0.3, (U, rank)).astype(np.float32),
            "Q": rng.normal(0, 0.3, (I, rank)).astype(np.float32),
            "Y": rng.normal(0, 0.2, (I, rank)).astype(np.float32),
            "bu": rng.normal(0, 0.1, U).astype(np.float32),
            "bi": rng.normal(0, 0.1, I).astype(np.float32),
            "mu": np.float32(3.4),
            "nu": rng.uniform(0.1, 1.0, U).astype(np.float32)}


def test_implicit_sums_and_run_constants_match_the_reference(split):
    """``implicit_scale``, ``implicit_sums`` (in chunks of 1,000 ratings)
    and the degrees and trust cap of ``svdpp_run_constants`` within 1e-6
    of the reference's; a user with no rating has scale 0."""
    train, _ = split
    a = _svdpp_arrays()
    u, i = train.user, train.item
    nu_t = implicit_scale(u, U + 1, device="cpu")
    nu_j = np.asarray(implicit_scale_j(jnp.asarray(u), U + 1))
    np.testing.assert_allclose(nu_t.numpy(), nu_j, rtol=0, atol=1e-6)
    assert float(nu_t[U]) == 0.0 and nu_t.dtype == torch.float32
    S_t = implicit_sums(torch.as_tensor(a["Y"]), u, i,
                        torch.as_tensor(a["nu"]), chunk=1_000)
    S_j = implicit_sums_j(jnp.asarray(a["Y"]), jnp.asarray(u), jnp.asarray(i),
                          jnp.asarray(a["nu"]))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=0,
                               atol=1e-6)
    m0 = init_model(0, U, I, 8, global_mean=3.5)
    for trust in (16.0, 0.0):
        cfg = SVDPPConfig(y_trust=trust)
        got = svdpp.svdpp_run_constants(train, cfg, "cpu")
        want = svdpp_j.svdpp_run_constants(
            m0, train, SVDPPConfig_j(y_trust=trust), None)
        for g, w in zip(got, want[:5], strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
    assert float(got[4].min()) == 1.0  # y_trust 0: all ones


@pytest.mark.parametrize("tr_eta,use_bias", [(None, True), (0.0, True),
                                             (None, False)])
def test_y_step_matches_the_reference(split, tr_eta, use_bias):
    """The Y step at the production trust-region form (``tr_eta=None``)
    and the linear full-batch gradient (``tr_eta=0``), on the reference's
    padded chunks of 1,024 ratings (the port's are the same arrays):
    Y within 1e-6, the SSE within 1e-6 relative."""
    train, _ = split
    a = _svdpp_arrays(seed=3)
    chunks_j = svdpp_j._coo_chunks(train, 1024)
    chunks_t = svdpp.coo_chunks(train, 1024, "cpu")
    assert set(chunks_t) == set(chunks_j)
    for k, v in chunks_t.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(chunks_j[k]))
    rng = np.random.default_rng(4)
    deg_i = np.bincount(train.item, minlength=I).astype(np.float32)
    y_scale = rng.uniform(0.3, 1.0, I).astype(np.float32)
    lr_y, reg_y = 0.01, 0.05
    names = ("Y", "P", "Q", "bu", "bi")
    Y_j, sse_j = svdpp_j.y_gradient_step(
        *(jnp.asarray(a[k]) for k in names), jnp.asarray(a["mu"]),
        jnp.asarray(a["nu"]), jnp.asarray(deg_i), jnp.asarray(y_scale),
        chunks_j, jnp.float32(lr_y), jnp.float32(reg_y), tr_eta=tr_eta,
        use_bias=use_bias)
    Y_t, sse_t = svdpp.y_gradient_step(
        *(torch.as_tensor(a[k]) for k in names), float(a["mu"]),
        torch.as_tensor(a["nu"]), torch.as_tensor(deg_i),
        torch.as_tensor(y_scale), chunks_t, lr_y, reg_y, tr_eta=tr_eta,
        use_bias=use_bias)
    np.testing.assert_allclose(Y_t.numpy(), np.asarray(Y_j), rtol=0,
                               atol=1e-6)
    assert abs(float(sse_t) - float(sse_j)) <= 1e-6 * float(sse_j)
    assert float((Y_t - torch.as_tensor(a["Y"])).abs().max()) > 1e-4


@pytest.mark.parametrize("partitioner", ["fixed", "conflict_free"])
def test_two_epochs_match_the_reference(split, partitioner):
    """Two epochs of ``train_epochs_svdpp`` against the JAX trainer from
    the same tables on the same batches: train RMSE and the MF views'
    tables within 1e-5; the train RMSE falls."""
    train, _ = split
    kw = dict(lr=0.02, reg=0.04, lr_decay=0.95, epochs=2, batch_size=512,
              partitioner=partitioner)
    m0 = init_model(2, U, I, 8, global_mean=train.global_mean)
    ref = [(tr, m) for _, m, tr in svdpp_j.train_epochs_svdpp(
        m0, train, SVDPPConfig_j(**kw), True, seed=2)]
    got = [(tr, m) for _, m, tr in svdpp.train_epochs_svdpp(
        model_from_numpy(_arrays(m0), device="cpu"), train,
        SVDPPConfig(**kw), True, seed=2)]
    for (tr_t, m_t), (tr_j, m_j) in zip(got, ref, strict=True):
        assert abs(tr_t - float(tr_j)) <= 1e-5
        for k in KEYS:
            np.testing.assert_allclose(getattr(m_t, k).numpy(),
                                       np.asarray(getattr(m_j, k)), rtol=0,
                                       atol=1e-5, err_msg=k)
    assert got[1][0] < got[0][0]


def test_lr_y_zero_is_the_plain_minibatch_trainer(split):
    """With the Y step off every epoch is the port's plain biased-MF
    epoch bit for bit (Y stays 0, so S = 0 and X = P)."""
    from mfx_torch.solvers.sgd import train_epochs

    train, _ = split
    kw = dict(lr=0.02, reg=0.05, lr_decay=0.9, epochs=3, batch_size=256,
              partitioner="fixed")
    m0 = model_from_numpy(_arrays(init_model(7, U, I, 8, global_mean=3.5)),
                          device="cpu")
    mf = [(tr, m) for _, m, tr in train_epochs(m0, train, SGDConfig(**kw),
                                               True, seed=5)]
    pp = [(tr, m) for _, m, tr in svdpp.train_epochs_svdpp(
        m0, train, SVDPPConfig(lr_y=0.0, **kw), True, seed=5)]
    for (tr_a, a), (tr_b, b) in zip(mf, pp, strict=True):
        assert tr_a == tr_b
        for k in KEYS:
            assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_model_and_npz_move_both_ways(tmp_path, split):
    """``as_mf`` from S or from the training columns, the npz file written
    by either package read by the other bit for bit, ``init_svdpp`` (Y
    zero, nu the reference's ``implicit_scale``), and the converters."""
    train, _ = split
    a = _svdpp_arrays(seed=5)
    m_t = svdpp_from_numpy(a, device="cpu")
    m_j = SVDppModel_j(**{k: jnp.asarray(v) for k, v in a.items()})
    v_t = m_t.as_mf(user=train.user, item=train.item)
    v_j = m_j.as_mf(user=jnp.asarray(train.user), item=jnp.asarray(train.item))
    for k in KEYS:
        np.testing.assert_allclose(getattr(v_t, k).numpy(),
                                   np.asarray(getattr(v_j, k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    S = implicit_sums(m_t.Y, train.user, train.item, m_t.nu)
    assert torch.equal(m_t.as_mf(S).P, m_t.P + S)
    with pytest.raises(ValueError, match="as_mf needs S"):
        m_t.as_mf()
    m_t.save_npz(tmp_path / "t.npz")
    back_j = SVDppModel_j.load_npz(tmp_path / "t.npz")
    m_j.save_npz(tmp_path / "j.npz")
    back_t = SVDppModel.load_npz(tmp_path / "j.npz", device="cpu")
    out = svdpp_to_numpy(back_t)
    for k, v in a.items():
        np.testing.assert_array_equal(np.asarray(getattr(back_j, k)), v)
        np.testing.assert_array_equal(out[k], v)
    assert back_t.mu == float(a["mu"]) and back_t.rank == 8
    g = torch.Generator().manual_seed(0)
    st = init_svdpp(g, U, I, 8, train_user=train.user, train_item=train.item,
                    global_mean=3.1)
    assert not st.Y.any() and st.Y.shape == (I, 8) and st.mu == 3.1
    np.testing.assert_allclose(
        st.nu.numpy(), np.asarray(implicit_scale_j(jnp.asarray(train.user),
                                                   U)), rtol=0, atol=1e-6)


def _root(tmp_path, n=6_000):
    """A data root holding a seeded dataset as the loader's real-data cache
    of ``synthetic-small``."""
    root = tmp_path / "data"
    root.mkdir(exist_ok=True)
    make_synthetic(U, I, n, rank=6, noise=0.3, seed=13).save_npz(
        root / f"synthetic-small.v{loaders.GENERATOR_VERSION}.npz")
    return root


def _cfg(root, *extra):
    return apply_overrides(preset("ml1m_rank32_biased"), [
        "solver=svdpp", "data.dataset=synthetic-small", f"data.root={root}",
        "model.rank=8", "svdpp.epochs=2", "svdpp.lr=0.02",
        "svdpp.batch_size=512", *extra])


def test_driver_and_cli_train_svdpp(tmp_path, capsys):
    """``solver='svdpp'`` through the driver on the CPU: the train RMSE
    falls, the held-out RMSE is that of the trainer's last MF view with
    the driver's clipping, the checkpoint holds that view; a directory
    that holds a step is refused as the reference refuses a resume; the
    CLI prints the reference's JSON."""
    from mfx_torch.cli import main
    from mfx_torch.data.split import train_test_split
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.models.mf import init_model as init_t
    from mfx_torch.train.checkpoint import load_checkpoint
    from mfx_torch.train.driver import train

    root = _root(tmp_path)
    ck = tmp_path / "ck"
    cfg = _cfg(root, f"checkpoint_dir={ck}")
    res = train(cfg, device="cpu")
    trains = [r["train_metric"] for r in res.history]
    assert res.epochs_run == 2 and trains[1] < trains[0]
    coo = loaders.load_dataset("synthetic-small", root=root)
    tr, te = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    g = torch.Generator().manual_seed(cfg.model.seed)
    m0 = init_t(g, U, I, 8, global_mean=tr.global_mean,
                init_scale=cfg.model.init_scale)
    *_, (_, view, _) = svdpp.train_epochs_svdpp(m0, tr, cfg.svdpp, True,
                                                seed=cfg.data.seed)
    assert (res.test_rmse, res.test_mae) == rmse_mae(view, te,
                                                     clip=(0.5, 5.0))
    m, epoch, _ = load_checkpoint(ck, device="cpu")
    assert epoch == 1 and all(torch.equal(getattr(m, k), getattr(view, k))
                              for k in KEYS)
    with pytest.raises(ValueError, match="resume"):
        train(_cfg(root, f"checkpoint_dir={ck}", "svdpp.epochs=3"),
              device="cpu")
    args = ["train", "--preset", "ml1m_rank32_biased", "--device", "cpu"]
    for ov in ("solver=svdpp", "data.dataset=synthetic-small",
               f"data.root={root}", "model.rank=8", "svdpp.epochs=1"):
        args += ["--set", ov]
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"preset", "epochs_run", "updates_per_sec",
                        "test_rmse", "test_mae"}
    assert out["epochs_run"] == 1 and np.isfinite(out["test_rmse"])


@pytest.mark.parametrize("override,exc,what", [
    # the reference's own refusal
    ("parallel.mode=sharded", ValueError, "single-device or data-parallel"),
    # the reference trains these through svdpp_dp; the port names Q1-13
    ("parallel.mode=dp", NotImplementedError,
     r"svdpp_dp\) is ROADMAP Queue 1 item 13 \(Q1-13\)"),
    ("parallel.mode=hybrid", NotImplementedError, r"Queue 1 item 13"),
    ("model.dtype=bfloat16", NotImplementedError,
     r"SVD\+\+, timeSVD\+\+.*float32 tables"),
])
def test_driver_refusals_are_the_reference_refusals(tmp_path, override, exc,
                                                    what):
    """The driver refuses ``svdpp`` on the row-sharded ring as the
    reference does (the same type and text), and names what the port still
    lacks: the data-parallel trainer (Q1-13), bf16 tables. The catch-all
    refusal names SVD++ and timeSVD++ among the ported solvers and no
    longer Queue 1 item 12."""
    from mfx_torch.train.driver import train

    root = _root(tmp_path, n=800)
    extra = [override, "sgd.kernel=jnp"]
    if override == "parallel.mode=sharded":
        from mfx.config import apply_overrides as apply_j
        from mfx.config import preset as preset_j
        from mfx.train.driver import _make_epoch_iter

        cfg_j = apply_j(preset_j("ml1m_rank32_biased"),
                        ["solver=svdpp", override])
        m0 = init_model(0, U, I, 4, global_mean=3.0)
        with pytest.raises(exc, match=what):
            _make_epoch_iter(cfg_j, m0, make_synthetic(U, I, 800, seed=1), 0,
                             0, None)
    with pytest.raises(exc, match=what):
        train(_cfg(root, *extra), device="cpu")
    with pytest.raises(NotImplementedError) as info:
        train(apply_overrides(preset("ml1m_rank32_biased"), [
            "parallel.mode=dp"]), device="cpu")
    msg = str(info.value)
    assert "SVD++, timeSVD and timeSVD++" in msg and "item 12" not in msg
    assert "Queue 1 item 13 (Q1-13)" in msg


def test_resume_is_refused_as_the_reference_refuses_it(split):
    train, _ = split
    m0 = model_from_numpy(_arrays(init_model(0, U, I, 4, global_mean=3.0)),
                          device="cpu")
    with pytest.raises(ValueError, match="resume") as info:
        next(svdpp.train_epochs_svdpp(m0, train, SVDPPConfig(epochs=1), True,
                                      start_epoch=1))
    with pytest.raises(ValueError) as info_j:
        next(iter(svdpp_j.train_epochs_svdpp(
            init_model(0, U, I, 4, global_mean=3.0), train,
            SVDPPConfig_j(epochs=1), True, start_epoch=1)))
    assert str(info.value) == str(info_j.value)
    assert dataclasses.asdict(SVDPPConfig()) == dataclasses.asdict(
        SVDPPConfig_j())
