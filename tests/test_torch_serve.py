"""The port's recommenders against the reference's on the same model (handed
across with ``mfx_torch.convert``), on the CPU: the stock scorer in f32,
bf16 and int8, related items, the fused recommender (approximate, exact,
bf16, int8; the reference's kernel in Pallas interpret mode), exact-mode
overflow, pool exhaustion and the validation errors.

Scores agree within rtol = atol = 1e-5 position by position; items are
equal except at near-ties (a differing item's score is within that
tolerance of the reference's item at the same position)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mfx.data import synthetic
from mfx.data.coo import RatingsCOO
from mfx.models import init_model as init_model_j
from mfx.models.mf import MFModel as JMFModel
from mfx.serve import (FusedTopKRecommender as JFused,
                       TopKRecommender as JTopK, similar_items as j_similar,
                       similar_items_fused as j_similar_fused)
from mfx_torch.convert import model_from_numpy
from mfx_torch.serve import (FusedTopKRecommender, TopKRecommender,
                             similar_items, similar_items_fused)

U, I, RANK = 32, 2000, 8  # 16 tiles at tile=128, the last one partial
TOL = 1e-5
USERS = np.arange(U, dtype=np.int32)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    m = init_model_j(3, U, I, RANK, global_mean=3.5)
    jm = JMFModel(P=m.P, Q=m.Q,
                  bu=jnp.asarray(rng.normal(0, 0.2, U), jnp.float32),
                  bi=jnp.asarray(rng.normal(0, 0.2, I), jnp.float32),
                  mu=m.mu)
    arrays = {k: np.asarray(getattr(jm, k))
              for k in ("P", "Q", "bu", "bi", "mu")}
    coo = synthetic.make_synthetic(U, I, 2000, seed=7)
    return jm, model_from_numpy(arrays), coo


def _agree(got, want, max_swaps=0.05):
    (gi, gs), (wi, ws) = got, want
    assert gi.shape == wi.shape and gi.dtype == np.int32
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    assert (gi != wi).mean() <= max_swaps


@pytest.mark.parametrize("table_dtype", ["f32", "bf16", "int8"])
def test_stock_recommender_matches_reference(pair, table_dtype):
    jm, tm, coo = pair
    want = JTopK(jm, train=coo, batch=8,
                 table_dtype=table_dtype).recommend(USERS, k=10)
    got = TopKRecommender(tm, train=coo, batch=8,
                          table_dtype=table_dtype).recommend(USERS, k=10)
    _agree(got, want)
    for u in range(U):  # exclusions hold
        assert not np.isin(got[0][u], coo.item[coo.user == u]).any()


def test_similar_items_matches_reference(pair):
    jm, tm, _ = pair
    q = [0, 5, 77, I - 1]
    _agree(similar_items(tm, q, k=6, batch=4),
           j_similar(jm, q, k=6, batch=4))


@pytest.mark.parametrize("table_dtype", ["f32", "bf16", "int8"])
def test_fused_approximate_matches_reference(pair, table_dtype):
    jm, tm, coo = pair
    want = JFused(jm, train=coo, batch=8, tile=128,
                  table_dtype=table_dtype).recommend(USERS, k=8)
    got = FusedTopKRecommender(tm, train=coo, batch=8, tile=128,
                               table_dtype=table_dtype).recommend(USERS, k=8)
    _agree(got, want)


def test_fused_exact_matches_reference_and_stock(pair):
    """k = 12 of a 32-candidate pool forces tile collisions: the plain
    fused path differs from the stock one, the exact one must not."""
    jm, tm, coo = pair
    kw = dict(train=coo, batch=8, tile=128, exact=True, exact_tiles=16,
              exact_depth=2)
    rec = FusedTopKRecommender(tm, **kw)
    got = rec.recommend(USERS, k=12)
    _agree(got, JFused(jm, **kw).recommend(USERS, k=12))
    stock = TopKRecommender(tm, train=coo, batch=8).recommend(USERS, k=12)
    _agree(got, stock, max_swaps=0.0)
    approx = FusedTopKRecommender(tm, train=coo, batch=8,
                                  tile=128).recommend(USERS, k=12)
    assert (approx[0] != stock[0]).any()
    assert rec.exact_fallbacks == 0


def test_fused_exact_overflow_serves_the_stock_result(pair):
    jm, tm, coo = pair
    kw = dict(train=coo, batch=8, tile=128, exact=True, exact_tiles=2,
              exact_depth=2)
    rec = FusedTopKRecommender(tm, **kw)
    jrec = JFused(jm, **kw)
    got = rec.recommend(USERS, k=12)
    _agree(got, jrec.recommend(USERS, k=12))
    stock = TopKRecommender(tm, train=coo, batch=8).recommend(USERS, k=12)
    _agree(got, stock, max_swaps=0.0)
    assert rec.exact_fallbacks > 0
    assert rec.exact_fallbacks == jrec.exact_fallbacks


@pytest.mark.parametrize("exact", [False, True])
def test_similar_items_fused_matches_reference(pair, exact):
    jm, tm, _ = pair
    q = [0, 5, 77, 1500, I - 1]
    kw = dict(k=6, batch=8, tile=128, exact=exact, exact_tiles=4,
              exact_depth=2)
    got = similar_items_fused(tm, q, **kw)
    _agree(got, j_similar_fused(jm, q, **kw))
    if exact:
        _agree(got, similar_items(tm, q, k=6), max_swaps=0.0)


def _one_hot_model(U_, I_, r, pairs):
    """Reference and port models with P[0, 0] = 1 and Q[i, 0] = v for
    each (i, v) in ``pairs``, everything else zero."""
    P = np.zeros((U_, r), np.float32)
    P[0, 0] = 1.0
    Q = np.zeros((I_, r), np.float32)
    for i, v in pairs:
        Q[i, 0] = v
    arrays = dict(P=P, Q=Q, bu=np.zeros(U_, np.float32),
                  bi=np.zeros(I_, np.float32), mu=np.float32(0.0))
    jm = JMFModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jm, model_from_numpy(arrays)


def test_pool_exhaustion_raises_in_both(pair):
    """One tile of 200 items; user 0 has seen the tile's top 2, k = 1."""
    jm, tm = _one_hot_model(4, 200, 4, [(7, 10.0), (9, 9.0), (50, 5.0)])
    seen = RatingsCOO(np.array([0, 0], np.int32), np.array([7, 9], np.int32),
                      np.array([5.0, 4.0], np.float32), 4, 200)
    for rec in (FusedTopKRecommender(tm, train=seen, batch=4, tile=256),
                JFused(jm, train=seen, batch=4, tile=256)):
        with pytest.raises(ValueError, match="exhausted"):
            rec.recommend([0], k=1)
        items, scores = rec.recommend([1], k=1)
        assert items[0, 0] < 200 and np.isfinite(scores[0, 0])


def test_runner_up_rescues_a_seen_tile_winner():
    jm, tm = _one_hot_model(4, 256, 4, [(7, 10.0), (9, 9.0), (200, 5.0)])
    seen = RatingsCOO(np.array([0], np.int32), np.array([7], np.int32),
                      np.array([5.0], np.float32), 4, 256)
    items, scores = FusedTopKRecommender(tm, train=seen, batch=4,
                                         tile=128).recommend([0], k=2)
    assert items[0].tolist() == [9, 200]
    np.testing.assert_allclose(scores[0], [9.0, 5.0], atol=1e-5)


_BAD = {
    "table_dtype": (lambda F, m: F(m, table_dtype="int4"), None),
    "tile": (lambda F, m: F(m, tile=100), None),
    "int8_exact": (lambda F, m: F(m, table_dtype="int8", exact=True), None),
    "exact_tiles": (lambda F, m: F(m, exact=True, exact_tiles=0), None),
    "pool": (lambda F, m: F(m, tile=128).recommend([0], k=40), None),
    "k": (lambda F, m: F(m, tile=128).recommend([0], k=0), None),
    "user": (lambda F, m: F(m, tile=128).recommend([U], k=2), None),
    "sim_int8": (None, lambda s, m: s(m, [0], k=2, table_dtype="int8")),
    "sim_k": (None, lambda s, m: s(m, [0], k=0)),
    "sim_item": (None, lambda s, m: s(m, [I], k=2)),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_validation_errors_match_reference(pair, case):
    jm, tm, _ = pair
    rec_case, sim_case = _BAD[case]
    msgs = []
    for m, F, s in ((jm, JFused, j_similar_fused),
                    (tm, FusedTopKRecommender, similar_items_fused)):
        with pytest.raises(ValueError) as err:
            rec_case(F, m) if rec_case else sim_case(s, m)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_fused_rank_limit_matches_reference():
    arrays = dict(P=np.zeros((4, 128), np.float32),
                  Q=np.zeros((16, 128), np.float32),
                  bu=np.zeros(4, np.float32), bi=np.zeros(16, np.float32),
                  mu=np.float32(0.0))
    jm = JMFModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    msgs = []
    for F, m in ((JFused, jm), (FusedTopKRecommender,
                                model_from_numpy(arrays))):
        with pytest.raises(ValueError, match="rank") as err:
            F(m)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
