"""MMR re-ranking (``mfx_torch.serve.rerank``) against the reference's
``mfx/serve/rerank.py`` on the CPU: ``rerank_mmr`` on the same candidate
pools at lam = 0, 0.7 and 1 (rows with skipped -inf slots and a row whose
finite candidates run out among them), ``MMRRecommender`` over the stock
and the fused recommenders (its pool clamped to the fused pool), and
``serve --mmr`` over HTTP against a direct call. Items are equal and
scores within 1e-6 (each is a pool score passed through)."""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from mfx.data import synthetic
from mfx.models import init_model as init_model_j
from mfx.models.mf import MFModel as JMFModel
from mfx.serve import (FusedTopKRecommender as JFused,
                       MMRRecommender as JMMR, TopKRecommender as JTopK,
                       rerank_mmr as j_rerank)
from mfx_torch.convert import model_from_numpy
from mfx_torch.serve import (FusedTopKRecommender, MMRRecommender,
                             TopKRecommender, rerank_mmr)
from mfx_torch.train.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parent.parent
U, I, RANK = 30, 1500, 8
TOL = 1e-6
USERS = np.arange(U, dtype=np.int32)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(4)
    m = init_model_j(9, U, I, RANK, global_mean=3.5)
    jm = JMFModel(P=m.P, Q=m.Q,
                  bu=jnp.asarray(rng.normal(0, 0.2, U), jnp.float32),
                  bi=jnp.asarray(rng.normal(0, 0.2, I), jnp.float32),
                  mu=m.mu)
    tm = model_from_numpy({k: np.asarray(getattr(jm, k))
                           for k in ("P", "Q", "bu", "bi", "mu")},
                          device="cpu")
    coo = synthetic.make_synthetic(U, I, 3000, seed=6)
    return jm, tm, coo


def _same(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("lam", [0.0, 0.7, 1.0])
def test_rerank_matches_reference(pair, lam):
    jm, tm, coo = pair
    items, scores = JTopK(jm, train=coo).recommend(USERS, k=40)
    items, scores = np.array(items), np.array(scores)
    scores[3, 5:9] = -np.inf   # skipped slots
    scores[4, 6:] = -np.inf    # 6 finite candidates for k = 10
    want = j_rerank(jm, items, scores, k=10, lam=lam)
    got = rerank_mmr(tm, items, scores, k=10, lam=lam)
    _same(got, want)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    if lam == 1.0:  # pure relevance: the pool's own order
        np.testing.assert_array_equal(got[0][:3], items[:3, :10])


@pytest.mark.parametrize("fused", [False, True])
def test_mmr_recommender_matches_reference(pair, fused):
    """Over the stock scorer (pool 4 x k), and over the fused one, whose
    pool of 2 x 12 tiles clamps the over-fetch to its max_k."""
    jm, tm, coo = pair
    if fused:
        # no exclusions: a pool of 24 cannot absorb a user's seen items
        jin = JFused(jm, batch=8, tile=128, interpret=True)
        tin = FusedTopKRecommender(tm, batch=8, tile=128, device="cpu")
        assert tin.max_k == jin.max_k == 24
    else:
        jin, tin = JTopK(jm, train=coo), TopKRecommender(tm, train=coo)
    k = 10
    want = JMMR(jin, lam=0.7, pool=4).recommend(USERS, k=k)
    got = MMRRecommender(tin, lam=0.7, pool=4).recommend(USERS, k=k)
    _same(got, want)
    with pytest.raises(ValueError, match="exceeds the inner"):
        MMRRecommender(tin, pool=1).recommend(USERS, k=25 if fused else
                                              I + 1)


@pytest.mark.parametrize("bad,match", [
    (dict(lam=1.5), r"lam must be in \[0, 1\]"),
    (dict(pool=0), "pool must be >= 1"),
])
def test_mmr_validation(pair, bad, match):
    _, tm, _ = pair
    with pytest.raises(ValueError, match=match):
        MMRRecommender(TopKRecommender(tm), **bad)


def test_serve_mmr_over_http(pair, tmp_path):
    """``python -m mfx_torch.cli serve --mmr 0.7 --device cpu`` on port 0:
    /recommend answers the lists a direct MMRRecommender call gives."""
    _, tm, coo = pair
    save_checkpoint(tmp_path / "ck", 2, tm, seed=0)
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mfx_torch.cli", "serve", "--checkpoint",
         str(tmp_path / "ck"), "--port", "0", "--mmr", "0.7", "--mmr-pool",
         "3", "--device", "cpu"], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        head = json.loads(proc.stdout.readline())
        assert head["recommender"] == "MMRRecommender"
        req = urllib.request.Request(
            head["serving"] + "/recommend",
            data=json.dumps({"users": [0, 5, 29], "k": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            ans = json.loads(r.read())
    finally:
        proc.kill()
        proc.wait(timeout=30)
    items, scores = MMRRecommender(TopKRecommender(tm), lam=0.7,
                                   pool=3).recommend([0, 5, 29], k=6)
    assert ans["items"] == items.tolist()
    np.testing.assert_allclose(ans["scores"], scores, rtol=TOL, atol=TOL)
