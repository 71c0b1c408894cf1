"""The port's iALS (``mfx_torch/solvers/ials.py``) against the reference's
(``mfx/solvers/ials.py``) on the same numpy inputs, at the reference
tests' shapes (``tests/unit/test_ials.py``): the weighted Gram of one
chunk, one half-sweep within rtol 2e-4 / atol 2e-5 (also with a hot row
cut into pieces), the touched-row rule (``any(b != 0)``), run-to-run
bitwise on the CPU, the refusals; three sweeps through both drivers from
the same tables (held-out AUC within 1e-4) and the CLI."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import IALSConfig
from mfx.data.coo import RatingsCOO
from mfx.models import init_model
from mfx.solvers import als as ja
from mfx.solvers import ials as ji
from mfx_torch.config import IALSConfig as TIALSConfig
from mfx_torch.convert import model_to_numpy
from mfx_torch.solvers import ials as ti
from test_torch_als import both_drivers, one_thread, overrides, port  # noqa

ALPHA, REG = 12.0, 0.3


def implicit_coo(U=48, I=36, n=400, seed=3, hot_user=None):
    """tests/unit/test_ials.py's data: de-duplicated pairs with small
    positive counts; ``hot_user = (u, n)`` adds a user who observes the
    first n items."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, size=n).astype(np.int32)
    i = rng.integers(0, I, size=n).astype(np.int32)
    if hot_user is not None:
        uu, ii = hot_user
        u = np.concatenate([u, np.full(ii, uu, np.int32)])
        i = np.concatenate([i, np.arange(ii, dtype=np.int32)])
    key = u.astype(np.int64) * I + i
    _, first = np.unique(key, return_index=True)
    u, i = u[first], i[first]
    r = rng.integers(1, 6, size=u.shape[0]).astype(np.float32)
    return RatingsCOO(u, i, r, U, I, synthetic=True)


def sorted_args(coo):
    by = np.argsort(coo.user, kind="stable")
    return coo.user[by], coo.item[by], coo.rating[by]


def test_weighted_gram_matches_the_reference():
    coo = implicit_coo()
    m = init_model(0, coo.num_users, coo.num_items, rank=6)
    u, i, r = sorted_args(coo)
    plan, _ = ja.build_bucket_plan(u, coo.num_users)
    nseg = coo.num_users + 1
    cap, rows_rel, starts, lens = next(ja.iter_bucket_chunks(
        plan, 0, coo.num_users, nseg))
    # the jitted wrapper of weighted_gram_accumulate (one compile)
    want = ji._wgram_bucket(
        m.Q, jnp.float32(ALPHA), jnp.asarray(i), jnp.asarray(r), rows_rel,
        starts, lens, jnp.zeros((nseg, 6, 6)), jnp.zeros((nseg, 6)), cap=cap)
    got = ti.weighted_gram_accumulate(
        port(m).Q, ALPHA, torch.as_tensor(i), torch.as_tensor(r),
        np.asarray(rows_rel), np.asarray(starts), np.asarray(lens),
        torch.zeros(nseg, 6, 6), torch.zeros(nseg, 6), cap=cap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("hot,row_chunk", [(None, 8192), ("hot", 8192),
                                           (None, 16)])
def test_half_sweep_matches_the_reference(hot, row_chunk):
    if hot:
        # degree 2200 > BUCKET_CAPS[-1]: the hot row's partial weighted
        # Grams from its pieces add up
        coo = implicit_coo(U=24, I=2200, n=300, hot_user=(0, 2200))
    else:
        coo = implicit_coo()
    m = init_model(0, coo.num_users, coo.num_items, rank=6)
    args = sorted_args(coo)
    want = np.asarray(ji.ials_half_sweep(m.P, m.Q, *args, ALPHA, REG,
                                         row_chunk=row_chunk))
    pm = port(m)
    got = ti.ials_half_sweep(pm.P, pm.Q, *args, ALPHA, REG,
                             row_chunk=row_chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_untouched_rows_keep_their_factors():
    """The reference's rule, a row is solved where any(b != 0): a user with
    no interactions keeps its factors, and so does one with interactions
    whose items' factor rows are all zero (its b is zero; ALS's degree
    rule would solve it)."""
    import dataclasses

    coo = implicit_coo()
    coo = coo.select(np.flatnonzero(coo.user != 5))
    m = init_model(1, coo.num_users, coo.num_items, rank=4)
    zero = np.unique(coo.item[coo.user == 7])
    Q = np.asarray(m.Q).copy()
    Q[zero] = 0.0
    m = dataclasses.replace(m, Q=jnp.asarray(Q))
    args = sorted_args(coo)
    pm = port(m)
    got = ti.ials_half_sweep(pm.P, pm.Q, *args, 8.0, 0.2)
    want = np.asarray(ji.ials_half_sweep(m.P, m.Q, *args, 8.0, 0.2))
    for u in (5, 7):
        assert torch.equal(got[u], pm.P[u])
        np.testing.assert_array_equal(want[u], np.asarray(m.P)[u])
    assert not torch.equal(got[0], pm.P[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_sweeps_repeat_bitwise_and_match_the_reference():
    coo = implicit_coo(U=80, I=50, n=900, seed=5)
    m = init_model(2, coo.num_users, coo.num_items, rank=8)
    for _, want in ji.train_sweeps_ials(m, coo, IALSConfig(
            alpha=20.0, reg=0.5, sweeps=2)):
        pass
    runs = []
    for _ in range(2):
        for _, got in ti.train_sweeps_ials(port(m), coo, TIALSConfig(
                alpha=20.0, reg=0.5, sweeps=2)):
            pass
        runs.append(model_to_numpy(got))
    for k in ("P", "Q"):
        np.testing.assert_array_equal(runs[0][k], runs[1][k])
        np.testing.assert_allclose(runs[0][k], np.asarray(getattr(want, k)),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rating,use_bias,what", [
    (1.0, True, "bias-free"), (-1.0, False, "non-negative feedback")])
def test_refusals_are_the_reference_refusals(rating, use_bias, what):
    coo = RatingsCOO(user=np.array([0, 1, 2], np.int32),
                     item=np.array([0, 1, 0], np.int32),
                     rating=np.array([1.0, rating, 2.0], np.float32),
                     num_users=3, num_items=2)
    m = init_model(0, 3, 2, 4)
    for mod, cfg in ((ji, IALSConfig(sweeps=1)), (ti, TIALSConfig(sweeps=1))):
        model = m if mod is ji else port(m)
        with pytest.raises(ValueError, match=what):
            list(mod.train_sweeps_ials(model, coo, cfg, use_bias=use_bias))


def test_three_sweeps_through_both_drivers(tmp_path, monkeypatch):
    """iALS through both drivers from the same tables: implicit
    evaluation (the sampled AUC) after every sweep within 1e-4."""
    res_j, res = both_drivers(
        monkeypatch, tmp_path, "ials",
        overrides(tmp_path, "ials", "synthetic-small-implicit",
                  ("model.use_bias=false", "ials.sweeps=3",
                   "ials.alpha=20.0", "ials.reg=0.5")),
        "test_auc")
    assert res.epochs_run == 3 and res.test_rmse is None
    assert abs(res.test_auc - res_j.test_auc) <= 1e-4


def test_cli_prints_the_reference_keys(tmp_path, capsys):
    import mfx.cli
    from mfx_torch.cli import main

    outs = []
    for m, extra in ((main, ["--device", "cpu"]), (mfx.cli.main, [])):
        args = ["train", "--preset", "netflix100m_rank128_dp", *extra]
        for ov in overrides(tmp_path, "ials", "synthetic-small-implicit",
                            ("model.use_bias=false", "ials.sweeps=1")):
            args += ["--set", ov]
        assert m(args) == 0
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert set(outs[0]) == set(outs[1]) == {
        "preset", "epochs_run", "updates_per_sec", "test_auc"}
    assert outs[0]["epochs_run"] == outs[1]["epochs_run"] == 1
