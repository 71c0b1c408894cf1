"""The port's weighted NMF (``mfx_torch/solvers/nmf.py``) against the
reference's (``mfx/solvers/nmf.py``) on the same numpy inputs, at the
reference tests' shapes (``tests/unit/test_nmf.py``): one half-sweep
within rtol 3e-5 / atol 3e-6 and non-negative, the multiplicative update
alone, sweeps that never raise the objective, rows without ratings
unchanged, run-to-run bitwise and resumed bit for bit on the CPU, the
refusals; three sweeps through both drivers from the same tables
(held-out RMSE within 1e-4) and the CLI."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import NMFConfig
from mfx.data.coo import RatingsCOO
from mfx.models.mf import init_model
from mfx.solvers import nmf as jn
from mfx_torch.config import NMFConfig as TNMFConfig
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.solvers import nmf as tn
from test_torch_als import both_drivers, one_thread, overrides, port  # noqa


def toy(U=25, I=18, n=300, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    r = rng.uniform(0.5, 5.0, n).astype(np.float32)
    return RatingsCOO(user=u, item=i, rating=r, num_users=U, num_items=I)


def objective(m, coo, reg):
    P = np.asarray(m["P"], np.float64)
    Q = np.asarray(m["Q"], np.float64)
    e = coo.rating - (P[coo.user] * Q[coo.item]).sum(1)
    deg_u = np.bincount(coo.user, minlength=coo.num_users)
    deg_i = np.bincount(coo.item, minlength=coo.num_items)
    return (float((e * e).sum()) + reg * float((deg_u[:, None] * P * P).sum())
            + reg * float((deg_i[:, None] * Q * Q).sum()))


@pytest.mark.parametrize("inner_iters", [1, 3])
def test_half_sweep_matches_the_reference(inner_iters):
    coo = toy()
    rng = np.random.default_rng(1)
    k = 5
    P = rng.uniform(0.1, 1.0, (coo.num_users, k)).astype(np.float32)
    Q = rng.uniform(0.1, 1.0, (coo.num_items, k)).astype(np.float32)
    by = np.argsort(coo.user, kind="stable")
    args = (coo.user[by], coo.item[by], coo.rating[by])
    want = np.asarray(jn.nmf_half_sweep(jnp.asarray(P), jnp.asarray(Q), *args,
                                        reg=0.05, row_chunk=8,
                                        inner_iters=inner_iters))
    got = tn.nmf_half_sweep(torch.as_tensor(P), torch.as_tensor(Q), *args,
                            reg=0.05, row_chunk=8, inner_iters=inner_iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)
    assert bool((got >= 0).all())


def test_mu_update_matches_the_reference():
    rng = np.random.default_rng(2)
    # non-negative factor rows, as NMF's Grams see them
    X = rng.uniform(0.0, 1.0, (9, 7, 5)).astype(np.float32)
    A = np.einsum("rmd,rme->rde", X, X)
    b = rng.uniform(0, 3, (9, 5)).astype(np.float32)
    cnt = np.array([0, 1, 2, 7, 7, 3, 0, 1, 4], np.float32)
    old = rng.uniform(0.1, 1, (9, 5)).astype(np.float32)
    want = np.asarray(jn.mu_update(*(jnp.asarray(x) for x in (A, b, cnt, old)),
                                   jnp.float32(0.05), inner_iters=3))
    got = tn.mu_update(*(torch.as_tensor(x) for x in (A, b, cnt, old)), 0.05,
                       inner_iters=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)
    np.testing.assert_array_equal(got.numpy()[[0, 6]], old[[0, 6]])


def test_sweeps_never_raise_the_objective_and_match_the_reference():
    """tests/unit/test_nmf.py:88 on the port, from the reference's init:
    non-negative, the objective never rises (1e-6 relative), each sweep's
    tables within 3e-5 / 3e-6 of the reference's, two runs bitwise."""
    coo = toy(U=60, I=40, n=1500, seed=3)
    m0 = init_model(0, coo.num_users, coo.num_items, rank=6, global_mean=2.5)
    cfg_j, cfg = NMFConfig(reg=0.05, sweeps=6), TNMFConfig(reg=0.05, sweeps=6)
    want = [{k: np.asarray(getattr(m, k)) for k in ("P", "Q", "mu")}
            for _, m in jn.train_sweeps_nmf(m0, coo, cfg_j)]
    runs = [[model_to_numpy(m) for _, m in tn.train_sweeps_nmf(port(m0), coo,
                                                               cfg)]
            for _ in range(2)]
    objs = []
    for a, b, w in zip(*runs, want):
        for k in ("P", "Q"):
            np.testing.assert_array_equal(a[k], b[k])
            assert (a[k] >= 0).all()
            np.testing.assert_allclose(a[k], w[k], rtol=3e-5, atol=3e-6)
        assert float(a["mu"]) == float(w["mu"]) == 0.0
        objs.append(objective(a, coo, cfg.reg))
    assert all(y <= x * (1 + 1e-6) for x, y in zip(objs, objs[1:])), objs


def test_rows_without_ratings_unchanged_and_resume_is_bitwise():
    coo = toy(U=30, I=20, n=400, seed=4)
    coo = coo.select(np.flatnonzero(coo.user != 4))
    m0 = port(init_model(1, 30, 20, rank=4, global_mean=2.0))
    cfg = TNMFConfig(reg=0.02, sweeps=3)
    states = [model_to_numpy(m) for _, m in tn.train_sweeps_nmf(m0, coo, cfg)]
    folded = tn.fold_nonneg(m0)
    np.testing.assert_array_equal(states[-1]["P"][4], folded.P[4].numpy())
    mid = model_from_numpy(states[0], device="cpu")
    rest = [model_to_numpy(m) for _, m in
            tn.train_sweeps_nmf(mid, coo, cfg, start_sweep=1)]
    for a, b in zip(rest, states[1:]):
        for k in ("P", "Q"):
            np.testing.assert_array_equal(a[k], b[k])


def test_refusals_are_the_reference_refusals():
    coo = toy()
    m0 = init_model(0, coo.num_users, coo.num_items, rank=4, global_mean=2.0)
    neg = RatingsCOO(user=coo.user, item=coo.item,
                     rating=(coo.rating - 10).astype(np.float32),
                     num_users=coo.num_users, num_items=coo.num_items)
    for mod, cfg, m in ((jn, NMFConfig(sweeps=1), m0),
                        (tn, TNMFConfig(sweeps=1), port(m0))):
        with pytest.raises(ValueError, match="bias-free"):
            list(mod.train_sweeps_nmf(m, coo, cfg, use_bias=True))
        with pytest.raises(ValueError, match="non-negative"):
            list(mod.train_sweeps_nmf(m, neg, cfg))


def test_three_sweeps_through_both_drivers(tmp_path, monkeypatch, capsys):
    import mfx.cli
    from mfx_torch.cli import main

    ov = overrides(tmp_path, "nmf", extra=("model.use_bias=false",
                                           "nmf.sweeps=3"))
    res_j, res = both_drivers(monkeypatch, tmp_path, "nmf", ov, "test_rmse")
    assert res.epochs_run == 3
    assert abs(res.test_rmse - res_j.test_rmse) <= 1e-4
    assert bool((res.model.P >= 0).all()) and bool((res.model.Q >= 0).all())
    monkeypatch.undo()
    outs = []
    for m, extra in ((main, ["--device", "cpu"]), (mfx.cli.main, [])):
        args = ["train", "--preset", "netflix100m_rank128_dp", *extra]
        for o in ov[:-1] + ["nmf.sweeps=1"]:
            args += ["--set", o]
        assert m(args) == 0
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert set(outs[0]) == set(outs[1]) == {
        "preset", "epochs_run", "updates_per_sec", "test_rmse", "test_mae"}
