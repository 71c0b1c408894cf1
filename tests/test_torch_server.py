"""The port's HTTP endpoint and cold-start fold-in against the reference's:
the port's ``RecServer`` over the port's fused recommender and the
reference's over the reference's, the same small model, on the CPU and on
OS-assigned ports. Every endpoint answers 200 and the two answer alike
(items equal modulo near-ties, scores within 1e-5); fold-in agrees within
1e-4."""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from mfx.data import synthetic
from mfx.models import init_model as init_model_j
from mfx.models.mf import MFModel as JMFModel
from mfx.serve import (FusedTopKRecommender as JFused,
                       similar_items_fused as j_similar_fused)
from mfx.serve import foldin as foldin_j
from mfx.serve.server import RecServer as JRecServer
from mfx_torch.convert import model_from_numpy
from mfx_torch.serve import (FusedTopKRecommender, fold_in, recommend_cold,
                             similar_items_fused)
from mfx_torch.serve.server import RecServer

U, I, RANK, TILE = 24, 700, 8, 128
TOL = 1e-5
HISTORIES = [[[3, 4.5], [17, 2.0], [640, 5.0]], [[1, 3.0]], []]


def _models(seed):
    rng = np.random.default_rng(seed)
    m = init_model_j(seed, U, I, RANK, global_mean=3.5)
    jm = JMFModel(P=m.P, Q=m.Q,
                  bu=jnp.asarray(rng.normal(0, 0.2, U), jnp.float32),
                  bi=jnp.asarray(rng.normal(0, 0.2, I), jnp.float32),
                  mu=m.mu)
    return jm, model_from_numpy({k: np.asarray(getattr(jm, k))
                                 for k in ("P", "Q", "bu", "bi", "mu")}, device="cpu")


def _build(model, coo, fused, sim, cold):
    def build():
        return {
            "recommender": fused(model, train=coo, batch=8, tile=TILE),
            "similar": lambda q, k: sim(model, q, k=k, tile=TILE),
            "cold": lambda hs, k: cold(model, hs, k=k),
            "info": {"checkpoint_epoch": 1},
        }
    return build


@pytest.fixture(scope="module")
def servers():
    coo = synthetic.make_synthetic(U, I, 900, seed=2)
    (jm0, tm0), (jm1, tm1) = _models(0), _models(1)
    out = []
    for cls, m0, m1, fused, sim, cold in (
        (RecServer, tm0, tm1, FusedTopKRecommender, similar_items_fused,
         recommend_cold),
        (JRecServer, jm0, jm1, JFused, j_similar_fused,
         foldin_j.recommend_cold),
    ):
        first = _build(m0, coo, fused, sim, cold)()
        srv = cls(first["recommender"], similar=first["similar"],
                  cold=first["cold"], reload=_build(m1, coo, fused, sim, cold),
                  port=0)
        srv.start()
        out.append(srv)
    yield out
    for srv in out:
        srv.stop()


def _call(srv, path, body=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        raw = r.read()
    return raw.decode() if path == "/metrics" else json.loads(raw)


def _agree(got, want, items_key, scores_key):
    assert set(got) == set(want)
    gi, wi = np.asarray(got[items_key]), np.asarray(want[items_key])
    gs = np.asarray(got[scores_key], np.float64)
    ws = np.asarray(want[scores_key], np.float64)
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    assert gi.shape == wi.shape and (gi != wi).mean() <= 0.05


def test_endpoints_answer_like_the_reference(servers):
    port_srv, ref_srv = servers
    h = [_call(s, "/healthz") for s in servers]
    assert h[0] == {**h[1], "recommender": "FusedTopKRecommender"}
    assert h[0]["num_items"] == I and h[0]["rank"] == RANK
    body = {"users": [0, 5, 23], "k": 6, "exclude": [[], [1, 2], [3]]}
    _agree(_call(port_srv, "/recommend", body),
           _call(ref_srv, "/recommend", body), "items", "scores")
    body = {"items": [0, 9, I - 1], "k": 5}
    _agree(_call(port_srv, "/similar", body),
           _call(ref_srv, "/similar", body), "similar", "cosine")
    body = {"histories": HISTORIES, "k": 7}
    _agree(_call(port_srv, "/recommend_cold", body),
           _call(ref_srv, "/recommend_cold", body), "items", "scores")


def test_concurrent_requests_micro_batch_and_match_direct_calls(servers):
    port_srv = servers[0]
    rec = port_srv._rec
    bodies = [{"users": [u, u + 1], "k": 4} for u in (0, 2, 4, 6)]
    answers = [None] * len(bodies)

    def post(n):
        answers[n] = _call(port_srv, "/recommend", bodies[n])

    threads = [threading.Thread(target=post, args=(n,))
               for n in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for body, ans in zip(bodies, answers):
        items, scores = rec.recommend(body["users"], k=4)
        assert ans["items"] == items.tolist()
        assert ans["scores"] == [[float(s) for s in row] for row in scores]
    metrics = _call(port_srv, "/metrics")
    assert 'mfx_requests_total{path="/recommend",code="200"}' in metrics
    assert "mfx_batch_dispatches_total" in metrics


def test_bad_requests_are_400(servers):
    for srv in servers:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/recommend",
            data=json.dumps({"users": [U + 5], "k": 3}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400


def test_reload_swaps_in_the_new_model(servers):
    body = {"users": [1, 2], "k": 5}
    before = [_call(s, "/recommend", body) for s in servers]
    out = [_call(s, "/reload", {}) for s in servers]
    assert out[0] == out[1] and out[0]["status"] == "reloaded"
    assert out[0]["checkpoint_epoch"] == 1
    after = [_call(s, "/recommend", body) for s in servers]
    _agree(after[0], after[1], "items", "scores")
    assert after[0]["scores"] != before[0]["scores"]


def test_fold_in_matches_reference():
    jm, tm = _models(3)
    hs = [(np.array(ids, np.int32), np.array(r, np.float32))
          for ids, r in ([[3, 17, 640, 3], [4.5, 2.0, 5.0, 1.0]],
                         [[1], [3.0]], [[], []])]
    for use_bias in (True, False):
        got = fold_in(tm, hs, reg=0.05, use_bias=use_bias)
        want = foldin_j.fold_in(jm, hs, reg=0.05, use_bias=use_bias)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
    got = fold_in(tm, hs[:2], reg=0.1, transpose=True)
    want = foldin_j.fold_in(jm, hs[:2], reg=0.1, transpose=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    gi, gs = recommend_cold(tm, hs, k=9)
    wi, ws = foldin_j.recommend_cold(jm, hs, k=9)
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-4)
    assert (gi != wi).mean() <= 0.05
    assert not np.isin(gi[0], hs[0][0]).any()  # the history is excluded
