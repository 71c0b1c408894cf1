"""The BPR slice end to end: two epochs of the reference's fused ring
(``mfx.parallel.bpr_sharded``, a mesh of one, Pallas in interpret mode)
against the port's, from the same tables with the reference's plan bits
and negative draws; the port's refusals; and its driver and CLI on the
``billion_bpr_sharded`` preset cut to one shard."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import BPRConfig
from mfx.data import synthetic, train_test_split
from mfx.data.bpr import build_positive_index as build_positive_index_j
from mfx.eval.metrics import sampled_auc as sampled_auc_j
from mfx.eval.ranking import hr_ndcg_at_k as hr_ndcg_at_k_j
from mfx.models import init_model
from mfx.parallel import bpr_sharded as ring_j
from mfx.runtime.mesh import make_mesh
from mfx_torch.config import apply_overrides, preset
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.eval.metrics import sampled_auc
from mfx_torch.eval.ranking import hr_ndcg_at_k
from mfx_torch.kernels.bpr_sweep import bpr_sweep
from mfx_torch.parallel import bpr_sharded as ring

ROOT = Path(__file__).resolve().parent.parent
U, I, RANK = 300, 256, 64
SEED, NEG_SEED = 3, 1
CFG = BPRConfig(lr=0.05, reg=0.002, epochs=2, kernel="pallas", ublock=128,
                iblock=128, tile=64, neg_seed=NEG_SEED)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a process: under ``pytest -n 6`` the workers'
    thread pools otherwise fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split():
    coo = synthetic.make_implicit_synthetic(U, I, 5_000, rank=4, seed=5)
    return train_test_split(coo, test_frac=0.05, seed=SEED)


def _plan_bits(seed):
    def bits(epoch, n):
        key = jax.random.fold_in(jax.random.key(seed), epoch)
        return torch.as_tensor(np.array(
            jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)))
    return bits


def _neg_bits(seed):
    def draw(epoch, navail):
        base = jax.random.key(seed)
        kn = jax.random.fold_in(jax.random.fold_in(base, 0xB9), epoch)
        nav = jnp.asarray(navail.cpu().numpy())
        return torch.as_tensor(np.array(jax.random.randint(
            kn, nav.shape, 0, jnp.maximum(nav, 1), dtype=jnp.int32)))
    return draw


def _two_epochs_against_the_reference_ring(rank):
    """Two epochs of both rings from the same tables: losses within 1e-5
    relative, tables within 1e-4, sampled AUC and HR / NDCG / MRR@10
    within 1e-6."""
    train, test = _split()
    m0 = init_model(1, U, I, rank, global_mean=0.0)
    arrays = {k: np.asarray(getattr(m0, k))
              for k in ("P", "Q", "bu", "bi", "mu")}

    ref = [(loss, m) for _, m, loss in ring_j.train_epochs_bpr_ring_fused(
        m0, train, CFG, make_mesh(model=1), seed=SEED, interpret=True)]

    before = bpr_sweep.launches
    got = [(loss, m) for _, m, loss in ring.train_epochs_bpr_ring(
        model_from_numpy(arrays, device="cpu"), train, CFG, shards=1, seed=SEED,
        device="cpu", plan_rand=_plan_bits(SEED),
        neg_rand=_neg_bits(SEED + NEG_SEED))]
    assert bpr_sweep.launches == before  # CPU tensors: the plain version

    assert len(got) == len(ref) == 2
    for (lt, _), (lj, _) in zip(got, ref):
        assert lt == pytest.approx(lj, rel=1e-5)
    assert got[1][0] < got[0][0] < np.log(2) + 0.05  # it trains
    mt = model_to_numpy(got[-1][1])
    mj = ref[-1][1]
    for k in ("P", "Q"):
        np.testing.assert_allclose(mt[k], np.asarray(getattr(mj, k)),
                                   rtol=0, atol=1e-4, err_msg=k)

    keys = np.sort(np.concatenate([build_positive_index_j(train),
                                   build_positive_index_j(test)]))
    auc_t = sampled_auc(got[-1][1], test, seed=SEED, pos_keys=keys)
    auc_j = sampled_auc_j(mj, test, seed=SEED, pos_keys=keys)
    assert abs(auc_t - auc_j) <= 1e-6
    rk_t = hr_ndcg_at_k(got[-1][1], test, k=10, seed=SEED, pos_keys=keys)
    rk_j = hr_ndcg_at_k_j(mj, test, k=10, seed=SEED, pos_keys=keys)
    assert set(rk_t) == set(rk_j) == {"hr", "ndcg", "mrr"}
    for name in rk_j:
        assert abs(rk_t[name] - rk_j[name]) <= 1e-6, name


def test_two_epochs_match_the_reference_ring():
    _two_epochs_against_the_reference_ring(RANK)


@pytest.mark.parametrize("rank", [32, 128])
def test_two_epochs_match_the_reference_ring_at_other_ranks(rank):
    """``billion_bpr_sharded`` with ``model.rank=32`` or ``=128``: the
    bpr_sweep kernel's other forms, through the same ring."""
    _two_epochs_against_the_reference_ring(rank)


@pytest.mark.parametrize("change,exc,what", [
    ({"kernel": "jnp"}, NotImplementedError, "Queue 1 item 12"),
    ({"kernel": "jnp", "neg_weighting": "popularity"}, ValueError,
     "uniform-exact"),
    ("shards=2", NotImplementedError, "Queue 1 item 13"),
])
def test_ring_refusals(change, exc, what):
    train, _ = _split()
    model = model_from_numpy({"P": np.zeros((U, RANK)),
                              "Q": np.zeros((I, RANK)), "bu": np.zeros(U),
                              "bi": np.zeros(I), "mu": 1.0}, device="cpu")
    shards, cfg = 1, CFG
    if change == "shards=2":
        shards = 2
    else:
        cfg = dataclasses.replace(CFG, **change)
    with pytest.raises(exc, match=what):
        next(ring.train_epochs_bpr_ring(model, train, cfg, shards=shards,
                                        device="cpu"))


def _overrides(root):
    return ["parallel.model_axis=1", "data.dataset=synthetic-small-implicit",
            f"data.root={root}", "bpr.ublock=128", "bpr.iblock=128",
            "bpr.tile=64", "bpr.epochs=2"]


@pytest.mark.parametrize("override,what", [
    (["parallel.model_axis=32"], "Queue 1 item 13"),
    (["parallel.model_axis=1", "parallel.data_axis=2"], "Queue 1 item 13"),
    (["parallel.mode=single"], "Queue 1 item 12"),
    (["parallel.mode=dp"], "Queue 1 item 12"),
    (["parallel.model_axis=1", "model.dtype=bfloat16"], "Queue 1 item 12"),
])
def test_driver_refusals(override, what):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("billion_bpr_sharded"), override)
    with pytest.raises(NotImplementedError, match=what):
        train(cfg, device="cpu")


def test_driver_trains_and_evaluates_bpr_on_cpu(tmp_path):
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("billion_bpr_sharded"), _overrides(tmp_path))
    res = train(cfg, device="cpu")
    assert res.epochs_run == 2 and len(res.history) == 2
    assert res.history[1]["train_metric"] < res.history[0]["train_metric"]
    assert 0.0 <= res.test_auc <= 1.0 and res.test_rmse is None
    assert set(res.test_ranking) == {"hr", "ndcg", "mrr"}
    for rec in res.history:
        assert {"test_auc", "test_hr@10", "test_ndcg@10",
                "test_mrr@10"} <= set(rec)
    assert res.model.P.shape == (256, RANK)
    assert res.model.Q.shape == (128, RANK)


def test_cli_prints_the_reference_json_keys(tmp_path):
    outs = []
    for pkg, extra in (("mfx_torch.cli", ["--device", "cpu"]),
                       ("mfx.cli", [])):
        args = [sys.executable, "-m", pkg, "train", "--preset",
                "billion_bpr_sharded", *extra]
        for ov in _overrides(tmp_path):
            args += ["--set", ov]
        res = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        outs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert set(outs[0]) == set(outs[1]) == {
        "preset", "epochs_run", "updates_per_sec", "test_auc",
        "test_hr@10", "test_ndcg@10", "test_mrr@10"}
    assert outs[0]["preset"] == outs[1]["preset"] == "billion_bpr_sharded"
    assert outs[0]["epochs_run"] == outs[1]["epochs_run"] == 2


def test_ring_on_its_own_generators_repeats_and_reports_times():
    """With no ``plan_rand`` / ``neg_rand`` the ring draws from its seeded
    torch generators: two runs agree bitwise and fill ``timings``."""
    train, _ = _split()
    m0 = init_model(1, U, I, RANK, global_mean=0.0)
    arrays = {k: np.asarray(getattr(m0, k))
              for k in ("P", "Q", "bu", "bi", "mu")}
    runs = []
    for _ in range(2):
        timings = {}
        runs.append([(loss, model_to_numpy(m)) for _, m, loss in
                     ring.train_epochs_bpr_ring(
                         model_from_numpy(arrays, device="cpu"), train, CFG, seed=SEED,
                         device="cpu", timings=timings)])
        tiles = timings.pop("segment_tiles")
        assert set(timings) == {"prep_s", "neg_s", "plan_s"}
        assert all(v >= 0.0 for v in timings.values())
        # per segment: its tiles and the tiles on its longest chain
        assert tiles and all(1 <= crit <= n for n, crit in tiles)
    assert len(runs[0]) == CFG.epochs
    for (la, ma), (lb, mb) in zip(*runs):
        assert la == lb
        for k in ("P", "Q"):
            np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)
    assert runs[0][1][0] < runs[0][0][0]
