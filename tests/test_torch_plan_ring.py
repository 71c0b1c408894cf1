"""The port's ring planner against the reference's
(``mfx.kernels.plan_ring_device``): the same skeleton, and bitwise the same
tile slabs when fed the reference's random bits, for one shard with one
and several segments, two shards, and an empty stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import synthetic
from mfx.kernels import plan_ring_device as prd_j
from mfx_torch.kernels import plan_ring_device as prd

SU = SI = 128
T, TPG = 64, 4


def _ids(S, n=6_000, U=600, I=700):
    coo = synthetic.make_implicit_synthetic(U, I, n, rank=4, seed=S)
    ublock = -(-(-(-U // S)) // SU) * SU
    iblock = -(-(-(-I // S)) // SI) * SI
    return coo.user, coo.item, ublock, iblock


def _bits(seed, epoch, n):
    key = jax.random.fold_in(jax.random.key(seed), epoch)
    return np.array(jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32))


def _skeletons(u, i, S, ublock, iblock, nwin):
    sj = prd_j.build_ring_skeleton(jnp.asarray(u), jnp.asarray(i), S, ublock,
                                   iblock, SU, SI, T, TPG, nwin)
    st = prd.build_ring_skeleton(torch.as_tensor(u), torch.as_tensor(i), S,
                                 ublock, iblock, SU, SI, T, TPG, nwin)
    return sj, st


@pytest.mark.parametrize("S,nwin", [(1, 1), (1, 2), (1, 9), (2, 1), (2, 3)])
def test_skeleton_matches_reference(S, nwin):
    u, i, ublock, iblock = _ids(S)
    sj, st = _skeletons(u, i, S, ublock, iblock, nwin)
    assert (st.nt_total, st.n_real) == (sj.nt_total, sj.n_real)
    assert len(st.segments) == len(sj.segments) > 0
    if nwin < iblock // SI:
        assert len(st.segments) > 1
    for a, b in zip(st.segments, sj.segments):
        assert (a.win0, a.nwin, a.nt) == (b.win0, b.nwin, b.nt)
        np.testing.assert_array_equal(a.sa.numpy(), np.asarray(b.sa))
        np.testing.assert_array_equal(a.tc.numpy(), np.asarray(b.tc))
    for name in ("strat_start", "pos_base", "seg_off", "nw_arr"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)), name)
    np.testing.assert_array_equal(st.kt_bounds, sj.kt_bounds)


@pytest.mark.parametrize("S,nwin,epoch", [(1, 1, 0), (1, 2, 1), (2, 3, 2)])
def test_slabs_bitwise_equal_given_reference_bits(S, nwin, epoch):
    u, i, ublock, iblock = _ids(S)
    sj, st = _skeletons(u, i, S, ublock, iblock, nwin)
    neg = (np.arange(u.shape[0]) * 7 % SI).astype(np.int32)
    want = prd_j.epoch_tiles_ring(sj, jnp.asarray(u), jnp.asarray(i), None, 5,
                                  epoch, payload2=jnp.asarray(neg), sent2=SI)
    got = prd.epoch_tiles_ring(st, torch.as_tensor(u), torch.as_tensor(i),
                               None, 5, epoch, payload2=torch.as_tensor(neg),
                               sent2=SI, rand=torch.as_tensor(
                                   _bits(5, epoch, u.shape[0])))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # every triple lands once
    real = sum(int((a[:, :, :, 0, :] < SU).sum()) for a in got)
    assert real == u.shape[0]


def test_rating_payload_and_seeded_key():
    u, i, ublock, iblock = _ids(1)
    r = np.linspace(0.5, 5.0, u.shape[0]).astype(np.float32)
    sj, st = _skeletons(u, i, 1, ublock, iblock, 2)
    want = prd_j.epoch_tiles_ring(sj, jnp.asarray(u), jnp.asarray(i),
                                  jnp.asarray(r), 0, 0)
    got = prd.epoch_tiles_ring(st, torch.as_tensor(u), torch.as_tensor(i),
                               torch.as_tensor(r), 0, 0,
                               rand=torch.as_tensor(_bits(0, 0, u.shape[0])))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ut, it = torch.as_tensor(u), torch.as_tensor(i)
    a = prd.epoch_tiles_ring(st, ut, it, torch.as_tensor(r), 0, 0)
    b = prd.epoch_tiles_ring(st, ut, it, torch.as_tensor(r), 0, 0)
    c = prd.epoch_tiles_ring(st, ut, it, torch.as_tensor(r), 0, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_empty_stream():
    u, i, ublock, iblock = _ids(1)
    sj, st = _skeletons(u, i, 1, ublock, iblock, 2)
    e32 = np.zeros(0, np.int32)
    want = prd_j.epoch_tiles_ring(sj, jnp.asarray(e32), jnp.asarray(e32),
                                  None, 0, 0, payload2=jnp.asarray(e32),
                                  sent2=SI)
    got = prd.epoch_tiles_ring(st, torch.as_tensor(e32), torch.as_tensor(e32),
                               None, 0, 0, payload2=torch.as_tensor(e32),
                               sent2=SI)
    assert len(got) == len(want) == len(st.segments)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
