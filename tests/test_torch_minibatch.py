"""The minibatch SGD path of the port against the reference: the step
(``mfx_torch/kernels/minibatch.py`` against ``mfx/kernels/jnp_ref.py``),
the epoch plans (``mfx_torch/solvers/sgd.py`` against
``mfx/solvers/sgd.py``), three epochs of the ``ml100k_rank16`` preset on
the full ML-100K-shaped synthetic against the JAX trainer, the baseline
biases, resume of every ported trainer, and the driver and CLI on the
preset."""

import dataclasses
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import preset as preset_j
from mfx.data import synthetic as syn_j
from mfx.data.loaders import load_dataset as load_j
from mfx.data.split import epoch_permutation
from mfx.data.split import train_test_split as split_j
from mfx.eval.metrics import rmse_mae as rmse_mae_j
from mfx.kernels import jnp_ref
from mfx.models.mf import MFModel as JMFModel
from mfx.models.mf import baseline_biases as baseline_biases_j
from mfx.models.mf import init_model as init_j
from mfx.solvers import sgd as sgd_j
from mfx_torch.config import SGDConfig, apply_overrides, preset
from mfx_torch.convert import model_from_numpy
from mfx_torch.data import partition
from mfx_torch.data import synthetic as syn_t
from mfx_torch.data.split import train_test_split
from mfx_torch.eval.metrics import rmse_mae
from mfx_torch.kernels import minibatch as mb
from mfx_torch.models.mf import baseline_biases
from mfx_torch.solvers import sgd

KEYS = ("P", "Q", "bu", "bi")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests loop over many small CPU ops, and
    under a parallel test run the workers' thread pools would fight for
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tables(U, I, rank, seed):
    rng = np.random.default_rng(seed)
    return {"P": rng.normal(0, 0.3, (U, rank)).astype(np.float32),
            "Q": rng.normal(0, 0.3, (I, rank)).astype(np.float32),
            "bu": rng.normal(0, 0.1, U).astype(np.float32),
            "bi": rng.normal(0, 0.1, I).astype(np.float32),
            "mu": np.float32(3.5)}


def _jax_model(arrays):
    return JMFModel(**{k: jnp.asarray(arrays[k]) for k in KEYS},
                    mu=jnp.asarray(arrays["mu"], jnp.float32))


U, I, RANK, B = 30, 40, 8, 64


def _batch(case, seed=0):
    """(users, items, ratings, weights, unique_rows, dup_trust) of one
    batch: duplicate rows, a conflict-free batch, legacy id-0 pads under
    dup_trust, or sentinel pads (``num_rows + slot``)."""
    rng = np.random.default_rng(seed)
    real = 24  # a conflict-free batch: 24 distinct rows, then sentinels
    if case == "unique":
        u = rng.permutation(U)[:real].astype(np.int32)
        i = rng.permutation(I)[:real].astype(np.int32)
        u = np.concatenate([u, U + np.arange(B - real, dtype=np.int32)])
        i = np.concatenate([i, I + np.arange(B - real, dtype=np.int32)])
    else:
        u = rng.integers(0, U, B).astype(np.int32)
        i = (rng.zipf(1.5, B) % I).astype(np.int32)
    r = rng.uniform(1, 5, B).astype(np.float32)
    w = np.ones(B, np.float32)
    if case == "unique":
        w[real:] = 0.0
        r[real:] = 0.0
    if case == "trust_pads":
        u[-12:] = 0
        i[-12:] = 0
        w[-12:] = 0.0
    if case == "sentinel_pads":
        u[-12:] = U + np.arange(12)
        i[-12:] = I + np.arange(12)
        w[-12:] = 0.0
    return (u, i, r, w, case == "unique",
            2.0 if case in ("trust_pads", "dup_trust") else 0.0)


CASES = ["dups", "unique", "dup_trust", "trust_pads", "sentinel_pads"]


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_step_matches_jnp_ref(case, use_bias):
    """``sgd_compute_deltas``, ``sgd_apply_deltas``,
    ``sgd_minibatch_update`` and ``batch_sq_error`` against the
    reference's on the same batch: within 1e-6."""
    arrays = _tables(U, I, RANK, 1)
    u, i, r, w, unique, trust = _batch(case)
    jm, tm = _jax_model(arrays), model_from_numpy(arrays, device="cpu")
    lr, reg = 0.05, 0.04
    want = jnp_ref.sgd_compute_deltas(jm, jnp.asarray(u), jnp.asarray(i),
                                      jnp.asarray(r), jnp.asarray(w),
                                      jnp.float32(lr), jnp.float32(reg),
                                      use_bias=use_bias)
    tu, ti = torch.from_numpy(u), torch.from_numpy(i)
    tr, tw = torch.from_numpy(r), torch.from_numpy(w)
    got = mb.sgd_compute_deltas(tm, tu, ti, tr, tw, lr, reg,
                                use_bias=use_bias)
    for g, x in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=0,
                                   atol=1e-6)
    # the batch's summed squared error: 1e-6 relative
    assert abs(float(got[4]) - float(want[4])) <= 1e-6 * float(want[4])
    kw = dict(use_bias=use_bias, unique_rows=unique, dup_trust=trust)
    jn = jnp_ref.sgd_apply_deltas(jm, jnp.asarray(u), jnp.asarray(i),
                                  *want[:4], weights=jnp.asarray(w), **kw)
    tn = mb.sgd_apply_deltas(tm, tu, ti, *got[:4], weights=tw, **kw)
    jn2, jsq = jnp_ref.sgd_minibatch_update(
        jm, jnp.asarray(u), jnp.asarray(i), jnp.asarray(r), jnp.asarray(w),
        jnp.float32(lr), jnp.float32(reg), **kw)
    tn2, tsq = mb.sgd_minibatch_update(tm, tu, ti, tr, tw, lr, reg, **kw)
    assert abs(float(tsq) - float(jsq)) <= 1e-6 * float(jsq)
    for k in KEYS:
        for t, j in ((tn, jn), (tn2, jn2)):
            np.testing.assert_allclose(getattr(t, k).numpy(),
                                       np.asarray(getattr(j, k)), rtol=0,
                                       atol=1e-6, err_msg=k)
        # the input model is left as it was
        np.testing.assert_array_equal(getattr(tm, k).numpy(), arrays[k])
    err_j = jnp_ref.batch_sq_error(jm, jnp.asarray(u), jnp.asarray(i),
                                   jnp.asarray(r), jnp.asarray(w))
    err_t = mb.batch_sq_error(tm, tu, ti, tr, tw)
    assert abs(float(err_t) - float(err_j)) <= 1e-6 * float(err_j)


def test_dup_counts_count_pads_apart():
    ids = torch.tensor([3, 1, 3, 0, 0, 0], dtype=torch.int32)
    w = torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32)
    got = mb._dup_counts(mb.count_ids(ids, w))
    assert got.tolist() == [2, 1, 2, 1, 2, 2]
    want = jnp_ref._dup_counts(jnp.asarray(
        np.where(w.numpy() <= 0, 0x3FFFFFFF, ids.numpy())))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cfg(partitioner, **kw):
    return SGDConfig(**{"lr": 0.03, "reg": 0.02, "epochs": 2,
                        "batch_size": 128, "partitioner": partitioner, **kw})


@pytest.mark.parametrize("partitioner", ["fixed", "conflict_free"])
@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("batch_size", [128, 37])
def test_plan_epoch_arrays_are_equal(partitioner, epoch, batch_size):
    """The port plans an epoch as the reference does without its filler
    batches (``bucket=False``), which only bound XLA recompiles."""
    coo = syn_j.make_synthetic(300, 200, 6_000, rank=4, seed=3,
                               user_zipf_s=0.9)
    cfg = _cfg(partitioner, batch_size=batch_size)
    want = sgd_j.plan_epoch(coo, cfg, seed=4, epoch=epoch, bucket=False)
    got = sgd.plan_epoch(coo, cfg, seed=4, epoch=epoch, device="cpu")
    assert got.n_real == want.n_real
    assert (got.num_batches, got.batch_size) == (want.num_batches,
                                                 want.batch_size)
    assert sorted(got.batches) == sorted(want.batches)
    for k, v in want.batches.items():
        np.testing.assert_array_equal(got.batches[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_ml100k_rank16_follows_the_reference_trainer():
    """Three of the preset's 30 epochs, unchanged otherwise, on the full
    ML-100K-shaped synthetic from the JAX trainer's initial tables: the
    train RMSE within 1e-5 of the JAX trainer's every epoch, the held-out
    RMSE and MAE within 1e-4 after each epoch."""
    cfg = preset_j("ml100k_rank16")
    sgd_cfg = dataclasses.replace(cfg.sgd, epochs=3)
    coo = load_j("ml-100k", cache=False)
    train, test = split_j(coo, cfg.data.test_frac, seed=cfg.data.seed)
    clip = (0.5, 5.0) if cfg.clip_predictions else None
    m0 = init_j(cfg.model.seed, coo.num_users, coo.num_items,
                cfg.model.rank, global_mean=train.global_mean)
    ref = [(tr, *rmse_mae_j(m, test, clip=clip)) for _, m, tr in
           sgd_j.train_epochs(m0, train, sgd_cfg, use_bias=False,
                              seed=cfg.data.seed)]
    arrays = {k: np.asarray(getattr(m0, k)) for k in (*KEYS, "mu")}
    got = [(tr, *rmse_mae(m, test, clip=clip)) for _, m, tr in
           sgd.train_epochs(model_from_numpy(arrays, device="cpu"), train,
                            dataclasses.replace(preset("ml100k_rank16").sgd,
                                                epochs=3),
                            use_bias=False, seed=cfg.data.seed)]
    assert len(got) == len(ref) == 3
    for (tr_t, rmse_t, mae_t), (tr_j, rmse_j, mae_j) in zip(got, ref):
        assert abs(tr_t - tr_j) <= 1e-5
        assert abs(rmse_t - rmse_j) <= 1e-4
        assert abs(mae_t - mae_j) <= 1e-4
    assert got[0][0] > got[1][0] > got[2][0]


def test_conflict_free_plan_of_ml100k_is_fast():
    """The partition copy plans the ML-100K synthetic's 90,000 training
    ratings (6,244 rounds under its skew) in under 0.5 s on a CPU (about
    0.05 s unloaded), where the reference's NumPy fallback takes about a
    minute; its batches are the native planner's. Best of five, so that a
    loaded runner does not decide the time."""
    from mfx import native
    from mfx.data import partition as part_j

    cfg = preset("ml100k_rank16")
    coo = load_j("ml-100k", cache=False)
    train, _ = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    perm = epoch_permutation(train.n_ratings, cfg.data.seed, 0)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        batches = partition.partition_conflict_free(
            train.user, train.item, cfg.sgd.batch_size, perm,
            num_users=train.num_users, num_items=train.num_items)
        best = min(best, time.perf_counter() - t0)
    assert native.available()
    want = part_j.partition_conflict_free(
        train.user, train.item, cfg.sgd.batch_size, perm,
        num_users=train.num_users, num_items=train.num_items)
    assert len(batches) == len(want) == 6244
    for a, b in zip(batches, want):
        np.testing.assert_array_equal(a, b)
    assert best < 0.5, best


@pytest.mark.parametrize("damping", [10.0, 0.5])
def test_baseline_biases_match_the_reference(damping):
    coo = syn_j.make_synthetic(300, 200, 6_000, rank=4, seed=6,
                               user_zipf_s=0.6)
    bu_j, bi_j = baseline_biases_j(coo, damping=damping)
    bu, bi = baseline_biases(coo, damping=damping, device="cpu")
    np.testing.assert_allclose(bu.numpy(), np.asarray(bu_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bi.numpy(), np.asarray(bi_j), rtol=0,
                               atol=1e-6)
    bu_j, bi_j = baseline_biases_j(coo, mu=3.0, damping=damping)
    bu, bi = baseline_biases(coo, mu=3.0, damping=damping, device="cpu")
    np.testing.assert_allclose(bi.numpy(), np.asarray(bi_j), rtol=0,
                               atol=1e-6)


def _resume_run(trainer):
    """(unbroken run's last tables, resumed run's last tables) of one
    trainer: 4 epochs unbroken, then from the epoch-1 tables again from
    epoch 2."""
    from mfx_torch.config import BPRConfig
    from mfx_torch.parallel.bpr_sharded import train_epochs_bpr_ring

    if trainer == "bpr":
        coo = syn_t.make_implicit_synthetic(300, 256, 5_000, rank=4, seed=5)
        cfg = BPRConfig(lr=0.05, reg=0.002, epochs=4, kernel="pallas",
                        ublock=128, iblock=128, tile=64, neg_seed=1)

        def run(m, start):
            return train_epochs_bpr_ring(m, coo, cfg, shards=1, seed=3,
                                         device="cpu", start_epoch=start)
        arrays = _tables(300, 256, 64, 7)
    elif trainer == "blocked":
        coo = syn_t.make_synthetic(600, 600, 12_000, rank=4, noise=0.3,
                                   seed=9, star_step=0.5)
        # replan_every=4 (the default): the resumed run's first epoch must
        # use the tile stream planned for epoch 0
        cfg = SGDConfig(lr=0.012, reg=0.04, lr_decay=0.95, epochs=4,
                        partitioner="blocked", kernel="pallas", ublock=256,
                        iblock=256, tile=64, dense_chi=0.01,
                        dense_span="full", bias_mode="lane")

        def run(m, start):
            return sgd.train_epochs(m, coo, cfg, True, seed=0,
                                    start_epoch=start, device="cpu")
        arrays = _tables(600, 600, 64, 7)
    else:
        coo = syn_t.make_synthetic(300, 200, 6_000, rank=4, seed=3,
                                   user_zipf_s=0.9)
        cfg = _cfg("fixed", epochs=4, lr_decay=0.9, dup_trust=4.0)

        def run(m, start):
            return sgd.train_epochs(m, coo, cfg, True, seed=2,
                                    start_epoch=start)
        arrays = _tables(300, 200, 8, 7)
    models = {ep: m for ep, m, _ in run(model_from_numpy(arrays,
                                                         device="cpu"), 0)}
    resumed = [(ep, m) for ep, m, _ in run(models[1], 2)]
    assert [ep for ep, _ in resumed] == [2, 3]
    return models[3], resumed[-1][1]


@pytest.mark.parametrize("trainer", ["minibatch", "blocked", "bpr"])
def test_resumed_run_equals_the_unbroken_run(trainer):
    want, got = _resume_run(trainer)
    for k in KEYS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def _small(root, *extra):
    return apply_overrides(preset("ml100k_rank16"), [
        "data.dataset=synthetic-small", f"data.root={root}", "sgd.epochs=2",
        *extra])


def test_driver_trains_the_preset_logs_and_resumes(tmp_path):
    """The preset through the driver on the CPU (2 epochs, the small
    synthetic): one JSONL record an epoch with the reference's fields, a
    profiler trace, the checkpoint; then resumed to 3 epochs, bit for bit
    a 3-epoch run."""
    from mfx_torch.train.driver import train

    log = tmp_path / "log.jsonl"
    res = train(_small(tmp_path, f"log_path={log}",
                       f"profile_dir={tmp_path / 'prof'}",
                       f"checkpoint_dir={tmp_path / 'ck'}"), device="cpu")
    assert res.epochs_run == 2
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1] and recs == res.history
    assert set(recs[0]) == {"t", "epoch", "train_metric", "epoch_s",
                            "updates_per_sec", "updates_per_sec_per_chip",
                            "test_rmse", "test_mae"}
    assert recs[1]["train_metric"] < recs[0]["train_metric"]
    assert np.isfinite(res.test_rmse) and 0 < res.test_rmse < 2
    assert len(list((tmp_path / "prof").glob("trace_*.json"))) == 1
    more = train(_small(tmp_path, "sgd.epochs=3",
                        f"checkpoint_dir={tmp_path / 'ck'}"), device="cpu")
    assert more.epochs_run == 3 and [r["epoch"] for r in more.history] == [2]
    whole = train(_small(tmp_path, "sgd.epochs=3"), device="cpu")
    for k in KEYS:
        assert torch.equal(getattr(more.model, k), getattr(whole.model, k))


def test_driver_ranking_and_baseline_biases(tmp_path):
    """``ranking_k`` on the SGD path (the sampled protocol), and
    ``bias_init='baseline'`` for a fresh biased run: epoch 0 starts from
    the baseline predictor's biases."""
    from mfx_torch.train.driver import train

    res = train(_small(tmp_path, "ranking_k=5", "model.use_bias=true",
                       "model.bias_init=baseline", "sgd.epochs=1",
                       "sgd.partitioner=fixed", "sgd.dup_trust=16"),
                device="cpu")
    assert set(res.test_ranking) == {"hr", "ndcg", "mrr"}
    assert set(res.history[0]) >= {"test_hr@5", "test_ndcg@5",
                                   "test_mrr@5"}
    assert 0 <= res.test_ranking["hr"] <= 1
    assert float(res.model.bu.abs().max()) > 0


@pytest.mark.parametrize("override,what", [
    ("profile_phases=true", "profile_phases.*Queue 1 item 9"),
    ("model.dtype=bfloat16", "model.dtype.*Queue 1 item 9"),
    ("ranking_protocol=full", "ranking_protocol.*Queue 1 item 11"),
    ("ranking_protocol=user", "ranking_protocol.*Queue 1 item 11"),
    ("sgd.partitioner=blocked", "blocked_jnp.*Queue 1 item 5"),
])
def test_driver_still_refuses(tmp_path, override, what):
    from mfx_torch.train.driver import train

    extra = [override]
    if "ranking_protocol" in override:
        extra.append("ranking_k=5")
    if "partitioner" in override:
        extra.append("sgd.kernel=blocked_jnp")
    with pytest.raises(NotImplementedError, match=what):
        train(_small(tmp_path, *extra), device="cpu")


def test_cli_trains_the_preset(capsys, tmp_path):
    from mfx_torch.cli import main

    args = ["train", "--preset", "ml100k_rank16", "--device", "cpu"]
    for ov in ("data.dataset=synthetic-small", f"data.root={tmp_path}",
               "sgd.epochs=2"):
        args += ["--set", ov]
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"preset", "epochs_run", "updates_per_sec",
                        "test_rmse", "test_mae"}
    assert out["preset"] == "ml100k_rank16" and out["epochs_run"] == 2


def test_train_epochs_needs_the_card_by_default():
    """``plan_epoch`` puts its batches on the card unless told otherwise;
    here, with no card, it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    coo = syn_t.make_synthetic(30, 20, 300, rank=4, seed=1)
    with pytest.raises((RuntimeError, AssertionError)):
        sgd.plan_epoch(coo, _cfg("fixed"), 0, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        baseline_biases(coo)
