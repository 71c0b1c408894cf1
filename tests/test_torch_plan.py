"""The port's device planner against the reference's: the same skeleton,
and the same tile stream bit for bit when fed the reference's random
bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import synthetic, train_test_split
from mfx.kernels import plan_device as pdv_j
from mfx_torch.kernels import plan_device as pdv

U = I = 600
SU = SI = 256
T, TPG = 64, 4


def _train():
    coo = synthetic.make_synthetic(U, I, 25_000, rank=4, noise=0.3, seed=9,
                                   star_step=0.5)
    return train_test_split(coo, test_frac=0.1, seed=0)[0]


def _jax_bits(seed, epoch, n):
    key = jax.random.fold_in(jax.random.key(seed), epoch)
    return np.array(jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32))


@pytest.mark.parametrize("nwin", [1, 2, 3])
def test_skeleton_matches_reference(nwin):
    tr = _train()
    sj = pdv_j.build_plan_skeleton(jnp.asarray(tr.user), jnp.asarray(tr.item),
                                   U, I, SU, SI, T, TPG, nwin)
    st = pdv.build_plan_skeleton(torch.as_tensor(tr.user),
                                 torch.as_tensor(tr.item),
                                 U, I, SU, SI, T, TPG, nwin)
    assert st.nt_total == sj.nt_total
    assert len(st.sweeps) == len(sj.sweeps)
    for a, b in zip(st.sweeps, sj.sweeps):
        assert (a.win0, a.nwin, a.t0, a.t1, a.n_real) == (
            b.win0, b.nwin, b.t0, b.t1, b.n_real)
        np.testing.assert_array_equal(a.sa.numpy(), np.asarray(b.sa))
        np.testing.assert_array_equal(a.tc.numpy(), np.asarray(b.tc))
    np.testing.assert_array_equal(st.strat_start.numpy(),
                                  np.asarray(sj.strat_start))
    np.testing.assert_array_equal(st.pos_base.numpy(), np.asarray(sj.pos_base))


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (7, 3)])
def test_tile_stream_bitwise_equal_given_reference_bits(seed, epoch):
    tr = _train()
    u, i, r = jnp.asarray(tr.user), jnp.asarray(tr.item), jnp.asarray(tr.rating)
    sj = pdv_j.build_plan_skeleton(u, i, U, I, SU, SI, T, TPG, 2)
    tl_j = np.asarray(pdv_j.epoch_tiles_device(sj, u, i, r, seed, epoch))
    ut, it_, rt = (torch.as_tensor(tr.user), torch.as_tensor(tr.item),
                   torch.as_tensor(tr.rating))
    st = pdv.build_plan_skeleton(ut, it_, U, I, SU, SI, T, TPG, 2)
    bits = torch.as_tensor(_jax_bits(seed, epoch, tr.n_ratings))
    tl_t = pdv.epoch_tiles_device(st, ut, it_, rt, seed, epoch, rand=bits)
    assert tl_t.dtype == torch.int32
    np.testing.assert_array_equal(tl_t.numpy(), tl_j)


def test_seeded_tile_stream_is_a_valid_reshuffle():
    """With the port's own seeded key: deterministic per (seed, epoch),
    different across epochs, and every rating lands once, in its stratum
    (same per-tile multiset of windows as the reference plan)."""
    tr = _train()
    ut, it_, rt = (torch.as_tensor(tr.user), torch.as_tensor(tr.item),
                   torch.as_tensor(tr.rating))
    st = pdv.build_plan_skeleton(ut, it_, U, I, SU, SI, T, TPG, 3)
    a = pdv.epoch_tiles_device(st, ut, it_, rt, 0, 0)
    b = pdv.epoch_tiles_device(st, ut, it_, rt, 0, 0)
    c = pdv.epoch_tiles_device(st, ut, it_, rt, 0, 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    real = a[:, 0, :] < SU
    assert int(real.sum()) == tr.n_ratings
    # rebuild global ids per tile and compare the rating multiset
    tiles = torch.arange(a.shape[0])[:, None].expand(-1, T)[real]
    sw = st.sweeps[0]
    ga = sw.sa.long()[tiles // TPG] * SU + a[:, 0, :][real].long()
    gi = (sw.win0 + sw.tc.long()[tiles]) * SI + a[:, 1, :][real].long()
    rv = a[:, 2, :][real].view(torch.float32)
    got = np.lexsort((rv.numpy(), gi.numpy(), ga.numpy()))
    want = np.lexsort((tr.rating, tr.item, tr.user))
    np.testing.assert_array_equal(ga.numpy()[got], tr.user[want])
    np.testing.assert_array_equal(gi.numpy()[got], tr.item[want])
    np.testing.assert_array_equal(rv.numpy()[got], tr.rating[want])
