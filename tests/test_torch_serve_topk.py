"""The port's per-tile top-K candidates (``tile_topk_plain``, what
``tile_topk`` runs on CPU tensors) against the reference's Pallas
``tile_topk`` in interpret mode, on the same augmented tables.

Values agree within rtol = atol = 1e-5; lanes are equal except where the
two lanes' scores are within that tolerance of each other (a near-tie the
two summation orders may break either way). The constructed exact tie
must pick the lowest lane in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.kernels.serve_pallas import AUG_LANES, tile_topk as tile_topk_j
from mfx_torch.kernels.serve_topk import (aug_width, tile_topk, tile_topk2,
                                          tile_topk_plain)

TOL = 1e-5


def _tables(B, I, r, tile, seed, ipad_extra_tiles=1):
    rng = np.random.default_rng(seed)
    ipad = (-(-I // tile) + ipad_extra_tiles) * tile
    P = rng.normal(0, 1, (B, r)).astype(np.float32)
    Q = rng.normal(0, 1, (I, r)).astype(np.float32)
    bi = rng.normal(0, 0.3, I).astype(np.float32)
    return P, Q, bi, ipad


def _aug(P, Q, bi, ipad, width):
    B, r = P.shape
    I = Q.shape[0]
    P_aug = np.zeros((B, width), np.float32)
    P_aug[:, :r] = P
    P_aug[:, r] = 1.0
    Q_aug = np.zeros((ipad, width), np.float32)
    Q_aug[:I, :r] = Q
    Q_aug[:, r] = -1e30
    Q_aug[:I, r] = bi
    return P_aug, Q_aug


def _check(got, want, full, tile, exact_lanes=False):
    """got/want: flattened (m_j, a_j) tuples; full: (B, ipad) f64 scores."""
    assert len(got) == len(want)
    B = full.shape[0]
    for j in range(0, len(got), 2):
        m_t, a_t = (np.asarray(x) for x in got[j:j + 2])
        m_j, a_j = (np.asarray(x) for x in want[j:j + 2])
        assert m_t.shape == m_j.shape and a_t.dtype == np.int32
        np.testing.assert_allclose(m_t, m_j, rtol=TOL, atol=TOL)
        if exact_lanes:
            np.testing.assert_array_equal(a_t, a_j)
            continue
        bad = a_t != a_j
        if bad.any():
            b, t = np.nonzero(bad)
            s_t = full[b, t * tile + a_t[bad]]
            s_j = full[b, t * tile + a_j[bad]]
            np.testing.assert_allclose(s_t, s_j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tile,depth", [(128, 1), (128, 2), (128, 8),
                                        (256, 2)])
def test_f32_matches_reference(tile, depth):
    B, I, r = 12, 600, 6
    P, Q, bi, ipad = _tables(B, I, r, tile, seed=tile + depth)
    Pj, Qj = _aug(P, Q, bi, ipad, AUG_LANES)
    Pt, Qt = _aug(P, Q, bi, ipad, aug_width(r))
    want = tile_topk_j(jnp.asarray(Pj), jnp.asarray(Qj), tile=tile,
                       depth=depth, interpret=True)
    got = tile_topk(torch.from_numpy(Pt), torch.from_numpy(Qt), tile=tile,
                    depth=depth)
    full = Pt.astype(np.float64) @ Qt.astype(np.float64).T
    _check(got, want, full, tile)
    # the whole pad tile's winners are pad lanes with the pad bias
    assert np.all(np.asarray(got[0])[:, -1] < -1e29)
    if depth == 2:  # the top-2 entry point is the same selection
        two = tile_topk2(torch.from_numpy(Pt), torch.from_numpy(Qt), tile=tile)
        assert all(torch.equal(x, y) for x, y in zip(two, got))


def test_bf16_matches_reference():
    B, I, r, tile = 8, 500, 8, 128
    P, Q, bi, ipad = _tables(B, I, r, tile, seed=3)
    Pt, Qt = _aug(P, Q, bi, ipad, aug_width(r))
    Pj, Qj = _aug(P, Q, bi, ipad, AUG_LANES)
    want = tile_topk_j(jnp.asarray(Pj, jnp.bfloat16),
                       jnp.asarray(Qj, jnp.bfloat16), tile=tile, depth=2,
                       interpret=True)
    Pb = torch.from_numpy(Pt).to(torch.bfloat16)
    Qb = torch.from_numpy(Qt).to(torch.bfloat16)
    got = tile_topk(Pb, Qb, tile=tile, depth=2)
    full = Pb.double().numpy() @ Qb.double().numpy().T
    _check(got, want, full, tile)


def test_int8_with_scale_bias_stream_matches_reference():
    B, I, r, tile = 8, 700, 6, 128
    rng = np.random.default_rng(5)
    _, _, bi, ipad = _tables(B, I, r, tile, seed=5)
    tn = ipad // tile
    P = rng.normal(0, 1, (B, r)).astype(np.float32)
    q8 = rng.integers(-127, 128, (I, r)).astype(np.int8)
    scale = np.zeros(ipad, np.float32)
    scale[:I] = rng.uniform(0.001, 0.02, I)
    bias = np.full(ipad, -1e30, np.float32)
    bias[:I] = bi
    sb = np.stack([scale.reshape(tn, tile), bias.reshape(tn, tile)], axis=1)

    def tables(width):
        P_aug = np.zeros((B, width), np.float32)
        P_aug[:, :r] = P
        P_aug[:, r] = 1.0
        Q_aug = np.zeros((ipad, width), np.int8)
        Q_aug[:I, :r] = q8
        return P_aug, Q_aug

    Pj, Qj = tables(AUG_LANES)
    Pt, Qt = tables(aug_width(r))
    want = tile_topk_j(jnp.asarray(Pj), jnp.asarray(Qj), tile=tile, depth=2,
                       interpret=True, sb=jnp.asarray(sb))
    got = tile_topk(torch.from_numpy(Pt), torch.from_numpy(Qt), tile=tile,
                    depth=2, sb=torch.from_numpy(sb))
    full = (Pt.astype(np.float64) @ Qt.astype(np.float64).T) * scale + bias
    _check(got, want, full, tile)


def test_equal_scores_take_the_lowest_lane():
    """Items with identical rows tie exactly: lanes 5, 40 and 100 of tile
    0 and lanes 3 and 90 of tile 1 share the best score; the reference's
    max-extract (and the port) return them lowest lane first."""
    B, r, tile, ipad = 4, 6, 128, 256
    rng = np.random.default_rng(11)
    P = rng.normal(0, 1, (B, r)).astype(np.float32)
    P[:, 0] = np.abs(P[:, 0]) + 1.0
    Q = rng.normal(0, 0.1, (ipad, r)).astype(np.float32)
    best = np.zeros(r, np.float32)
    best[0] = 5.0
    for lane in (100, 40, 5, 128 + 90, 128 + 3):
        Q[lane] = best
    bi = np.zeros(ipad, np.float32)
    Pt, Qt = _aug(P, Q, bi, ipad, aug_width(r))
    Pj, Qj = _aug(P, Q, bi, ipad, AUG_LANES)
    want = tile_topk_j(jnp.asarray(Pj), jnp.asarray(Qj), tile=tile, depth=3,
                       interpret=True)
    got = tile_topk_plain(torch.from_numpy(Pt), torch.from_numpy(Qt),
                          tile=tile, depth=3)
    full = Pt.astype(np.float64) @ Qt.astype(np.float64).T
    _check(got, want, full, tile, exact_lanes=True)
    lanes = [np.asarray(got[j])[0].tolist() for j in (1, 3, 5)]
    assert lanes[0] == [5, 3] and lanes[1] == [40, 90] and lanes[2][0] == 100


@pytest.mark.parametrize("case", ["width", "pad", "depth", "sb", "dtype"])
def test_validation_errors(case):
    P = torch.zeros(4, 8)
    Q = torch.zeros(256, 8)
    kw = dict(tile=128, depth=2)
    if case == "width":
        P = torch.zeros(4, 16)
        err, match = ValueError, "width"
    elif case == "pad":
        kw["tile"] = 100
        err, match = ValueError, "not a multiple of tile"
    elif case == "depth":
        kw["depth"] = 129
        err, match = ValueError, "depth must be in"
    elif case == "sb":
        Q = Q.to(torch.int8)
        err, match = ValueError, "int8 Q_aug needs sb"
    else:
        Q = Q.to(torch.bfloat16)
        err, match = TypeError, "takes"
    with pytest.raises(err, match=match):
        tile_topk(P, Q, **kw)
