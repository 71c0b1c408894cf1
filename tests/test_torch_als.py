"""The port's ALS and Gram engine (``mfx_torch/solvers/als.py``) against
the reference's (``mfx/solvers/als.py``) on the same numpy inputs, at the
reference tests' shapes (``tests/unit/test_als.py``): bucket plans and
chunks exactly equal, one half-sweep within 2e-4 (rank 128 with bias
3e-3, the reference's own tolerance there), rows without ratings
unchanged, run-to-run bitwise on the CPU; three sweeps through both
drivers from the same tables (held-out RMSE within 1e-4), the CLI, resume,
and the refusals of the modes the port does not have. The driver helpers
here also serve ``test_torch_ials.py`` and ``test_torch_nmf.py``."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import ALSConfig
from mfx.data import synthetic
from mfx.models import init_model
from mfx.solvers import als as ja
from mfx_torch.config import ALSConfig as TALSConfig
from mfx_torch.config import apply_overrides, preset
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.solvers import als as ta

KEYS = ("P", "Q", "bu", "bi", "mu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests loop over many small CPU ops, and
    under a parallel test run the workers' thread pools would fight for
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def arrays(m):
    return {k: np.asarray(getattr(m, k)) for k in KEYS}


def port(m):
    """The reference model ``m`` as a port model on the CPU."""
    return model_from_numpy(arrays(m), device="cpu")


def zipf_rows(num_rows=50, seed=0):
    """Sorted row ids with Zipf-ish degrees, one row hotter than the
    largest cap (three pieces) and empty rows."""
    rng = np.random.default_rng(seed)
    degs = rng.integers(0, 60, num_rows)
    degs[3] = ja.BUCKET_CAPS[-1] * 2 + 17
    degs[7] = 0
    degs[-1] = 0
    return np.repeat(np.arange(num_rows), degs).astype(np.int32), num_rows


def test_constants_equal_the_reference():
    assert ta.BUCKET_CAPS == ja.BUCKET_CAPS
    assert ta.BUCKET_CELLS == ja.BUCKET_CELLS
    assert ta.GRAM_ROWCHUNK_BUDGET == ja.GRAM_ROWCHUNK_BUDGET
    for d in (4, 9, 64, 65, 128, 129):
        for rc in (8, 1000, 8192):
            assert ta.gram_rowchunk(d, rc) == ja.gram_rowchunk(d, rc)


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_plans_equal_the_reference(seed):
    rows, n = zipf_rows(seed=seed)
    want, want_starts = ja.build_bucket_plan(rows, n)
    got, got_starts = ta.build_bucket_plan(rows, n)
    np.testing.assert_array_equal(got_starts, want_starts)
    again = ta.bucket_plan_from_row_starts(want_starts)
    for plan in (got, again):
        assert list(plan) == list(want)
        for cap in want:
            for g, w in zip(plan[cap], want[cap]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    # the padded chunks, range by range, in the reference's order
    for r0, r1 in ((0, 8), (0, n), (3, 4), (40, n)):
        nseg = r1 - r0 + 1
        want_c = list(ja.iter_bucket_chunks(want, r0, r1, nseg))
        got_c = list(ta.iter_bucket_chunks(got, r0, r1, nseg))
        assert len(got_c) == len(want_c) > 0
        for (gc, *g), (wc, *w) in zip(got_c, want_c):
            assert gc == wc
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, np.asarray(b))


def test_sort_side_and_device_chunks_equal_the_host_plan():
    """The device sort and bincount give the reference's stable argsort
    and plan; device_chunks packs every range's chunks in order."""
    rows, n = zipf_rows(seed=2)
    rng = np.random.default_rng(3)
    perm = rng.permutation(rows.shape[0])
    u = rows[perm]
    cols = rng.integers(0, 90, u.shape[0]).astype(np.int32)
    vals = rng.uniform(1, 5, u.shape[0]).astype(np.float32)
    c, v, (plan, starts) = ta.sort_side(u, cols, vals, n, "cpu")
    by = np.argsort(u, kind="stable")
    np.testing.assert_array_equal(c.numpy(), cols[by])
    np.testing.assert_array_equal(v.numpy(), vals[by])
    want, want_starts = ja.build_bucket_plan(u[by], n)
    np.testing.assert_array_equal(starts, want_starts)
    for cap in want:
        for g, w in zip(plan[cap], want[cap]):
            np.testing.assert_array_equal(g, w)
    ranges = ta.device_chunks(plan, n, 8, "cpu")
    assert [(r0, r1) for r0, r1, _ in ranges] == [
        (r0, min(r0 + 8, n)) for r0 in range(0, n, 8)]
    for r0, r1, chunks in ranges:
        want_c = list(ja.iter_bucket_chunks(want, r0, r1, r1 - r0 + 1))
        assert len(chunks) == len(want_c)
        for (cap, rr, ss, ll), (wc, wr, ws, wl) in zip(chunks, want_c):
            assert cap == wc
            np.testing.assert_array_equal(rr.numpy(), np.asarray(wr))
            np.testing.assert_array_equal(ss.numpy(), np.asarray(ws))
            np.testing.assert_array_equal(ll.numpy(), np.asarray(wl))


def test_gram_accumulate_matches_the_reference():
    """One chunk's (A, b, cnt), with the bias column and pad pieces."""
    coo = synthetic.make_synthetic(17, 23, 500, rank=4, seed=1)
    m = init_model(0, 17, 23, 6, global_mean=coo.global_mean)
    by = np.argsort(coo.user, kind="stable")
    plan, _ = ja.build_bucket_plan(coo.user[by], 17)
    nseg = 18
    cap, rows_rel, starts, lens = next(ja.iter_bucket_chunks(plan, 0, 17,
                                                             nseg))
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    # the jitted wrapper of gram_accumulate (one compile, not op by op)
    want = ja._gram_bucket(
        m.Q, m.bi, m.mu, jnp.asarray(coo.item[by]),
        jnp.asarray(coo.rating[by]), rows_rel, starts, lens, z(nseg, 7, 7),
        z(nseg, 7), z(nseg), cap=cap, nseg=nseg, use_bias=True)
    pm = port(m)
    zt = lambda *s: torch.zeros(s)  # noqa: E731
    got = ta.gram_accumulate(
        pm.Q, pm.bi, pm.mu, torch.as_tensor(coo.item[by]),
        torch.as_tensor(coo.rating[by]), np.asarray(rows_rel),
        np.asarray(starts), np.asarray(lens), zt(nseg, 7, 7), zt(nseg, 7),
        zt(nseg), cap=cap, use_bias=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("use_bias", [False, True])
def test_accumulate_range_matches_the_reference(use_bias):
    """Every range's (A, b, cnt), a hot row's pieces summed in one
    segment, over the device chunks against the reference's host loop."""
    m, (u, i, r) = half_sweep_case(24, 40, 300, 6, 4, 7, use_bias, hot=True)
    d = 7 if use_bias else 6
    plan, _ = ja.build_bucket_plan(u, 24)
    pm = port(m)
    cols, vals = torch.as_tensor(i), torch.as_tensor(r)
    Fg = ta._gather_table(pm.Q, use_bias)
    resid = ta._targets(vals, cols, pm.mu, pm.bi, use_bias)
    cnts = []
    for r0, r1, chunks in ta.device_chunks(plan, 24, 8, "cpu"):
        want = ja.accumulate_range(
            m.Q, m.bi, m.mu, jnp.asarray(i), jnp.asarray(r), plan, r0, r1,
            d=d, dtype=jnp.float32, use_bias=use_bias)
        got = ta.accumulate_range(Fg, resid, cols, chunks, r1 - r0,
                                  torch.float32)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        cnts.append(got[2].numpy())
    np.testing.assert_array_equal(np.concatenate(cnts),
                                  np.bincount(u, minlength=24))
    assert cnts[0][0] > ja.BUCKET_CAPS[-1]  # row 0 summed from its pieces


def half_sweep_case(U, I, n, k, data_rank, seed, use_bias, hot=False):
    coo = synthetic.make_synthetic(U, I, n, rank=data_rank, seed=seed)
    if hot:  # user 0 rates beyond the largest cap: pieces of one row
        extra = ja.BUCKET_CAPS[-1] + 300
        rng = np.random.default_rng(seed)
        coo = dataclasses.replace(
            coo, user=np.concatenate([coo.user, np.zeros(extra, np.int32)]),
            item=np.concatenate([coo.item, rng.integers(
                0, I, extra).astype(np.int32)]),
            rating=np.concatenate([coo.rating, rng.uniform(
                1, 5, extra).astype(np.float32)]))
    m = init_model(seed + 1, U, I, k,
                   global_mean=coo.global_mean if use_bias else 0.0)
    by = np.argsort(coo.user, kind="stable")
    return m, (coo.user[by], coo.item[by], coo.rating[by])


@pytest.mark.parametrize("U,I,n,k,use_bias,row_chunk,tol,hot", [
    (17, 23, 500, 4, False, 8, 2e-4, False),  # test_als.py:17
    (60, 40, 1500, 8, True, 32, 2e-4, False),
    (24, 40, 300, 6, True, 8192, 2e-4, True),  # a hot row in pieces
    (40, 60, 2000, 128, True, 16, 3e-3, False),  # test_als.py:74, d=129
])
def test_half_sweep_matches_the_reference(U, I, n, k, use_bias, row_chunk,
                                          tol, hot):
    m, (u, i, r) = half_sweep_case(U, I, n, k, 4, 7, use_bias, hot)
    P, bu = ja.als_half_sweep(m.P, m.bu, m.Q, m.bi, m.mu, u, i, r, reg=0.3,
                              use_bias=use_bias, row_chunk=row_chunk)
    pm = port(m)
    P2, bu2 = ta.als_half_sweep(pm.P, pm.bu, pm.Q, pm.bi, pm.mu, u, i, r,
                                reg=0.3, use_bias=use_bias,
                                row_chunk=row_chunk)
    np.testing.assert_allclose(P2.numpy(), np.asarray(P), rtol=tol, atol=tol)
    np.testing.assert_allclose(bu2.numpy(), np.asarray(bu), rtol=tol,
                               atol=tol)
    assert not np.array_equal(P2.numpy(), arrays(m)["P"])


def test_rows_without_ratings_unchanged():
    U, I, k = 10, 10, 4
    coo = synthetic.make_synthetic(U, I, 60, rank=k, seed=2)
    coo = coo.select(np.flatnonzero(coo.user != 3))
    m = init_model(1, U, I, k, global_mean=coo.global_mean)
    by = np.argsort(coo.user, kind="stable")
    pm = port(m)
    P, bu = ta.als_half_sweep(pm.P, pm.bu, pm.Q, pm.bi, pm.mu, coo.user[by],
                              coo.item[by], coo.rating[by], reg=0.1,
                              use_bias=True, row_chunk=4)
    assert torch.equal(P[3], pm.P[3]) and torch.equal(bu[3], pm.bu[3])
    assert not torch.equal(P[0], pm.P[0])


@pytest.mark.parametrize("use_bias", [False, True])
def test_sweeps_repeat_bitwise_and_match_the_reference(use_bias):
    """Two sweeps of train_sweeps_als: two port runs bitwise equal, and
    within 2e-4 of the reference's sweeps from the same tables."""
    coo = synthetic.make_synthetic(100, 80, 3000, rank=4, seed=4)
    m = init_model(5, 100, 80, 4, global_mean=coo.global_mean)
    cfg = ALSConfig(reg=0.2, sweeps=2, user_chunk=64)
    for _, want in ja.train_sweeps_als(m, coo, cfg, use_bias=use_bias):
        pass
    tcfg = TALSConfig(reg=0.2, sweeps=2, user_chunk=64)
    runs = []
    for _ in range(2):
        for _, got in ta.train_sweeps_als(port(m), coo, tcfg,
                                          use_bias=use_bias):
            pass
        runs.append(model_to_numpy(got))
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_array_equal(runs[0][k], runs[1][k])
        np.testing.assert_allclose(runs[0][k], np.asarray(getattr(want, k)),
                                   rtol=2e-4, atol=2e-4)


def test_resumed_sweeps_equal_the_unbroken_run():
    coo = synthetic.make_synthetic(60, 50, 1500, rank=4, seed=6)
    m = port(init_model(2, 60, 50, 6, global_mean=coo.global_mean))
    cfg = TALSConfig(reg=0.1, sweeps=3)
    states = [model_to_numpy(x) for _, x in ta.train_sweeps_als(m, coo, cfg)]
    mid = model_from_numpy(states[0], device="cpu")
    rest = [model_to_numpy(x) for _, x in
            ta.train_sweeps_als(mid, coo, cfg, start_sweep=1)]
    assert len(rest) == 2
    for a, b in zip(rest, states[1:]):
        for k in ("P", "Q", "bu", "bi"):
            np.testing.assert_array_equal(a[k], b[k])


# -- the driver and the CLI, against the reference's ----------------------

def overrides(root, solver, dataset="synthetic-small", extra=()):
    return ["parallel.mode=single", f"solver={solver}",
            f"data.dataset={dataset}", f"data.root={root}", "model.rank=8",
            *extra]


def reference_init(cfg_j):
    """The tables the reference's driver starts from (its ``init_model``
    with the config's seed), as numpy arrays."""
    from mfx.data.loaders import load_dataset
    from mfx.data.split import train_test_split

    coo = load_dataset(cfg_j.data.dataset, root=cfg_j.data.root)
    tr, _ = train_test_split(coo, cfg_j.data.test_frac, seed=cfg_j.data.seed)
    return arrays(init_model(cfg_j.model.seed, coo.num_users, coo.num_items,
                             cfg_j.model.rank, global_mean=tr.global_mean,
                             init_scale=cfg_j.model.init_scale))


def both_drivers(monkeypatch, root, solver, ov, metric):
    """``solver`` through the reference's driver and the port's (on the
    CPU), the port started from the reference's initial tables (through
    ``model_from_numpy``). Returns (reference result, port result)."""
    import mfx.config as mc
    from mfx.train.driver import train as train_j
    from mfx_torch.train import driver

    cfg_j = mc.apply_overrides(mc.preset("netflix100m_rank128_dp"), ov)
    res_j = train_j(cfg_j)
    init = reference_init(cfg_j)
    monkeypatch.setattr(driver, "init_model",
                        lambda *a, **kw: model_from_numpy(init, device="cpu"))
    cfg = apply_overrides(preset("netflix100m_rank128_dp"), ov)
    res = driver.train(cfg, device="cpu")
    assert res.epochs_run == res_j.epochs_run == len(res.history)
    for rec, rec_j in zip(res.history, res_j.history):
        assert set(rec) == set(rec_j)
        assert np.isnan(rec["train_metric"]) and np.isnan(
            rec_j["train_metric"])
        assert abs(rec[metric] - rec_j[metric]) <= 1e-4, (rec, rec_j)
    return res_j, res


@pytest.mark.parametrize("use_bias", ["true", "false"])
def test_three_sweeps_through_both_drivers(tmp_path, monkeypatch, use_bias):
    res_j, res = both_drivers(
        monkeypatch, tmp_path, "als",
        overrides(tmp_path, "als",
                  extra=(f"model.use_bias={use_bias}", "als.sweeps=3")),
        "test_rmse")
    assert res.epochs_run == 3
    assert abs(res.test_rmse - res_j.test_rmse) <= 1e-4
    assert abs(res.test_mae - res_j.test_mae) <= 1e-4


def test_cli_trains_als_and_resumes(tmp_path, capsys):
    """``train --set solver=als`` prints the reference's keys; a second
    call on the same checkpoint directory resumes and has nothing left;
    a third with more sweeps goes on bit for bit the unbroken run."""
    import mfx.cli
    from mfx_torch.cli import main
    from mfx_torch.train.checkpoint import load_checkpoint

    outs = []
    for m, extra in ((main, ["--device", "cpu"]), (mfx.cli.main, [])):
        args = ["train", "--preset", "netflix100m_rank128_dp", *extra]
        for ov in overrides(tmp_path, "als", extra=("als.sweeps=2",)):
            args += ["--set", ov]
        assert m(args) == 0
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert set(outs[0]) == set(outs[1]) == {
        "preset", "epochs_run", "updates_per_sec", "test_rmse", "test_mae"}
    assert outs[0]["epochs_run"] == 2

    def run(sweeps, ck, resume=True):
        args = ["train", "--preset", "netflix100m_rank128_dp", "--device",
                "cpu"] + (["--no-resume"] if not resume else [])
        for ov in overrides(tmp_path, "als", extra=(
                f"als.sweeps={sweeps}", f"checkpoint_dir={ck}")):
            args += ["--set", ov]
        assert main(args) == 0
        capsys.readouterr()
        return load_checkpoint(ck, device="cpu")

    whole, ep, _ = run(3, tmp_path / "a")
    assert ep == 2
    run(2, tmp_path / "b")
    resumed, ep, _ = run(3, tmp_path / "b")
    assert ep == 2
    for k in ("P", "Q", "bu", "bi"):
        assert torch.equal(getattr(resumed, k), getattr(whole, k))


@pytest.mark.parametrize("solver", ["als", "ials", "nmf"])
@pytest.mark.parametrize("mode", ["dp", "sharded", "hybrid"])
def test_parallel_modes_are_refused(tmp_path, solver, mode):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("netflix100m_rank128_dp"),
                          overrides(tmp_path, solver, extra=(
                              f"parallel.mode={mode}",)))
    with pytest.raises(NotImplementedError,
                       match=r"Queue 1 item 13 \(Q1-13\).*parallel.mode="
                             "single"):
        train(cfg, device="cpu")


@pytest.mark.parametrize("solver", ["svdpp", "timesvdpp"])
def test_other_solvers_still_refused(tmp_path, solver):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("netflix100m_rank128_dp"),
                          overrides(tmp_path, solver))
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        train(cfg, device="cpu")
