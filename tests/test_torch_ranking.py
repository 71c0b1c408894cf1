"""The ranking protocols of the port against the reference's on the CPU,
on seeded random models (no near-ties among a user's scores) and seeded
synthetic splits: ``full_hr_ndcg_at_k`` (with and without train
exclusions), ``user_topk_metrics``, ``mfx_torch.api.evaluate`` in every
protocol and the implicit AUC, and the training driver with
``ranking_protocol`` 'full' and 'user'. Every metric within 1e-6."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfx.api as japi
from mfx.data import synthetic as jsyn
from mfx.data.split import train_test_split as j_split
from mfx.eval.ranking import (full_hr_ndcg_at_k as j_full,
                              user_topk_metrics as j_user)
from mfx.models.mf import MFModel as JMFModel
from mfx_torch import api
from mfx_torch.config import apply_overrides, preset
from mfx_torch.convert import model_from_numpy, model_to_numpy
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.eval.ranking import full_hr_ndcg_at_k, user_topk_metrics

TOL = 1e-6
U, I, RANK = 120, 700, 8


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_coo(c):
    return RatingsCOO(user=c.user, item=c.item, rating=c.rating,
                      num_users=c.num_users, num_items=c.num_items,
                      timestamp=c.timestamp)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(12)
    arrays = {"P": rng.normal(0, 0.4, (U, RANK)).astype(np.float32),
              "Q": rng.normal(0, 0.4, (I, RANK)).astype(np.float32),
              "bu": rng.normal(0, 0.2, U).astype(np.float32),
              "bi": rng.normal(0, 0.2, I).astype(np.float32),
              "mu": np.float32(3.5)}
    jm = JMFModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tm = model_from_numpy(arrays, device="cpu")
    coo = jsyn.make_synthetic(U, I, 9000, rank=4, seed=13)
    jtr, jte = j_split(coo, 0.2, seed=0)
    return jm, tm, (jtr, jte), (_port_coo(jtr), _port_coo(jte))


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= TOL, (k, got[k], want[k])


@pytest.mark.parametrize("k", [1, 10, 50])
@pytest.mark.parametrize("exclude", [True, False])
def test_full_protocol_matches_reference(case, k, exclude):
    jm, tm, (jtr, jte), (ttr, tte) = case
    want = j_full(jm, jte, train=jtr if exclude else None, k=k)
    got = full_hr_ndcg_at_k(tm, tte, train=ttr if exclude else None, k=k,
                            chunk=256)
    _close(got, want)


@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("exclude", [True, False])
def test_user_protocol_matches_reference(case, k, exclude):
    jm, tm, (jtr, jte), (ttr, tte) = case
    want = j_user(jm, jte, train=jtr if exclude else None, k=k, batch=64)
    got = user_topk_metrics(tm, tte, train=ttr if exclude else None, k=k,
                            batch=64)
    _close(got, want)


@pytest.mark.parametrize("protocol", ["sampled", "full", "user", None,
                                      "implicit"])
def test_evaluate_matches_reference(case, protocol):
    jm, tm, (jtr, jte), (ttr, tte) = case
    kw = dict(ranking_k=10, ranking_protocol=protocol)
    if protocol is None:
        kw = {}
    elif protocol == "implicit":
        kw = dict(implicit=True)
    want = japi.evaluate(jm, jte, train=jtr, **kw)
    got = api.evaluate(tm, tte, train=ttr, **kw)
    _close(got, want)
    with pytest.raises(ValueError, match="ranking_protocol must be"):
        api.evaluate(tm, tte, ranking_k=5, ranking_protocol="bogus")


@pytest.mark.parametrize("protocol", ["full", "user"])
def test_driver_reports_the_protocol(tmp_path, protocol):
    """The driver on the ml100k_rank16 preset (2 epochs, the small
    synthetic): each record carries the reference's keys for the
    protocol, and the result's metrics are the reference's functions on
    the trained model and the training driver's split."""
    from mfx.data.loaders import load_dataset as j_load
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset("ml100k_rank16"), [
        "data.dataset=synthetic-small", f"data.root={tmp_path}",
        "sgd.epochs=2", "ranking_k=10", f"ranking_protocol={protocol}"])
    res = train(cfg, device="cpu")
    names = ({"hr", "ndcg", "mrr"} if protocol == "full" else
             {"recall", "precision", "ndcg", "map", "coverage", "novelty"})
    assert set(res.test_ranking) == names
    assert all(f"test_{n}@10" in rec for rec in res.history for n in names)
    coo = j_load("synthetic-small", root=str(tmp_path))
    jtr, jte = j_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    arrays = model_to_numpy(res.model)
    jm = JMFModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    fn = j_full if protocol == "full" else j_user
    _close(res.test_ranking, fn(jm, jte, train=jtr, k=10))
