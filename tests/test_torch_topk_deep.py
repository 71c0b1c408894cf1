"""The deep forms of the per-tile top-K (depth > 32, tiles > 2,048 items:
``csrc/tile_topk.cu``'s deep kernel on the card, ``tile_topk_plain`` on
the CPU) and the fused recommenders that reach them through
``exact_depth`` and ``tile``, against the reference's Pallas ``tile_topk``
and ``FusedTopKRecommender`` in interpret mode.

Values agree within 1e-5; lanes are equal except where the two lanes'
scores lie within 1e-5 of each other (a near-tie the two summation orders
may break either way). The recommenders' items and ``max_k`` are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import synthetic
from mfx.kernels.serve_pallas import AUG_LANES, tile_topk as tile_topk_j
from mfx.models import init_model as init_model_j
from mfx.models.mf import MFModel as JMFModel
from mfx.serve import (FusedTopKRecommender as JFused,
                       similar_items_fused as j_similar_fused)
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels.serve_topk import aug_width, tile_topk_plain
from mfx_torch.serve import FusedTopKRecommender, similar_items_fused

TOL = 1e-5


def _tables(B, I, r, tile, seed, dtype):
    """Seeded augmented tables for both packages (the reference's 128
    lanes, the port's aug_width) and the f64 scores; int8 catalogs with
    their scale/bias stream."""
    rng = np.random.default_rng(seed)
    ipad = -(-I // tile) * tile
    P = rng.normal(0, 1, (B, r)).astype(np.float32)
    bi = rng.normal(0, 0.3, I).astype(np.float32)
    sb = None
    if dtype == "int8":
        Q = rng.integers(-127, 128, (I, r)).astype(np.int8)
        scale = np.zeros(ipad, np.float32)
        scale[:I] = rng.uniform(0.001, 0.02, I)
        bias = np.full(ipad, -1e30, np.float32)
        bias[:I] = bi
        tn = ipad // tile
        sb = np.stack([scale.reshape(tn, tile), bias.reshape(tn, tile)],
                      axis=1)
    else:
        Q = rng.normal(0, 1, (I, r)).astype(np.float32)

    def aug(width):
        P_aug = np.zeros((B, width), np.float32)
        P_aug[:, :r] = P
        P_aug[:, r] = 1.0
        Q_aug = np.zeros((ipad, width), Q.dtype)
        Q_aug[:I, :r] = Q
        if dtype != "int8":
            Q_aug[:, r] = -1e30
            Q_aug[:I, r] = bi
        return P_aug, Q_aug

    (Pj, Qj), (Pt, Qt) = aug(AUG_LANES), aug(aug_width(r))
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    j_args = (jnp.asarray(Pj, jnp.bfloat16 if dtype == "bf16"
                          else jnp.float32), jnp.asarray(Qj, jdt))
    Pt_t, Qt_t = torch.from_numpy(Pt), torch.from_numpy(Qt)
    if dtype == "bf16":
        Pt_t, Qt_t = Pt_t.to(torch.bfloat16), Qt_t.to(torch.bfloat16)
    full = Pt_t.double().numpy() @ Qt_t.double().numpy().T
    if sb is not None:
        full = full * sb[:, 0].reshape(1, -1) + sb[:, 1].reshape(1, -1)
    sbt = torch.from_numpy(sb) if sb is not None else None
    sbj = jnp.asarray(sb) if sb is not None else None
    return j_args, sbj, (Pt_t, Qt_t), sbt, full


@pytest.mark.parametrize("dtype,depth,tile", [
    ("f32", 33, 256), ("f32", 48, 256), ("bf16", 33, 256),
    ("int8", 48, 256),
    ("f32", 2, 2304), ("f32", 40, 2304), ("f32", 2, 4096),
    ("f32", 40, 4096), ("bf16", 40, 2304), ("int8", 2, 4096),
])
def test_deep_forms_match_reference(dtype, depth, tile):
    B, I, r = 6, 2 * tile - 37, 8
    (Pj, Qj), sbj, (Pt, Qt), sbt, full = _tables(B, I, r, tile,
                                                 seed=depth + tile, dtype=dtype)
    want = tile_topk_j(Pj, Qj, tile=tile, depth=depth, interpret=True,
                       sb=sbj)
    got = tile_topk_plain(Pt, Qt, tile=tile, depth=depth, sb=sbt)
    assert len(got) == len(want) == 2 * depth
    for j in range(0, 2 * depth, 2):
        m_t, a_t = (np.asarray(x) for x in got[j:j + 2])
        m_j, a_j = (np.asarray(x) for x in want[j:j + 2])
        assert m_t.shape == m_j.shape and a_t.dtype == np.int32
        np.testing.assert_allclose(m_t, m_j, rtol=TOL, atol=TOL)
        bad = a_t != a_j
        if bad.any():
            b, t = np.nonzero(bad)
            np.testing.assert_allclose(full[b, t * tile + a_t[bad]],
                                       full[b, t * tile + a_j[bad]],
                                       rtol=TOL, atol=TOL)


U, I, RANK = 24, 5000, 8


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(2)
    m = init_model_j(5, U, I, RANK, global_mean=3.5)
    jm = JMFModel(P=m.P, Q=m.Q,
                  bu=jnp.asarray(rng.normal(0, 0.2, U), jnp.float32),
                  bi=jnp.asarray(rng.normal(0, 0.2, I), jnp.float32),
                  mu=m.mu)
    arrays = {k: np.asarray(getattr(jm, k))
              for k in ("P", "Q", "bu", "bi", "mu")}
    coo = synthetic.make_synthetic(U, I, 3000, seed=8)
    return jm, model_from_numpy(arrays, device="cpu"), coo


@pytest.mark.parametrize("kw,k", [
    (dict(exact=True, exact_depth=40, tile=256, exact_tiles=4), 50),
    (dict(exact=False, tile=2304), 5),
    (dict(exact=True, exact_depth=40, tile=2304, exact_tiles=2), 50),
])
def test_fused_recommender_at_deep_settings(pair, kw, k):
    """exact_depth 40 (k = 50) and tile 2304 (three tiles: the approximate
    pool holds 6): the same items and max_k as
    the reference's recommender, and the same exact-mode fallbacks."""
    jm, tm, coo = pair
    users = np.arange(U, dtype=np.int32)
    jrec = JFused(jm, train=coo, batch=8, interpret=True, **kw)
    trec = FusedTopKRecommender(tm, train=coo, batch=8, device="cpu", **kw)
    assert trec.max_k == jrec.max_k
    wi, ws = jrec.recommend(users, k=k)
    gi, gs = trec.recommend(users, k=k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    assert trec.exact_fallbacks == jrec.exact_fallbacks


def test_similar_items_fused_at_depth_40(pair):
    jm, tm, _ = pair
    q = np.array([0, 7, 4999], np.int32)
    want = j_similar_fused(jm, q, k=30, tile=256, exact=True,
                           exact_depth=40, exact_tiles=4, interpret=True)
    got = similar_items_fused(tm, q, k=30, tile=256, exact=True,
                              exact_depth=40, exact_tiles=4, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=TOL,
                               atol=TOL)
