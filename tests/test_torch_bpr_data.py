"""The port's BPR sampling against the reference's: the device sampler
functions on the same inputs and the same uniform draws, the window
negatives given JAX's ``randint`` draws, and the item relabel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import bpr as bpr_j
from mfx.data import synthetic
from mfx.parallel import bpr_sharded as ring_j
from mfx_torch.data import bpr
from mfx_torch.parallel import bpr_sharded as ring

U, I, SI = 40, 300, 64


def _pairs(seed=0):
    """Positive pairs with duplicates, and user 0 holding every item of
    window 1 plus the last (partial) window."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, 3_000).astype(np.int32)
    i = rng.integers(0, I, 3_000).astype(np.int32)
    full = np.concatenate([np.arange(SI, 2 * SI), np.arange(4 * SI, I)])
    u = np.concatenate([u, np.zeros(full.size, np.int32), u[:50]])
    i = np.concatenate([i, full.astype(np.int32), i[:50]])
    return u, i


def _index_both(u, i):
    pu_j, pi_j = bpr_j.build_positive_index_device(jnp.asarray(u),
                                                   jnp.asarray(i))
    pu, pi = bpr.build_positive_index_device(torch.as_tensor(u),
                                             torch.as_tensor(i))
    return (pu_j, pi_j), (pu, pi)


def test_positive_index_keeps_duplicate_sentinels():
    u, i = _pairs()
    (pu_j, pi_j), (pu, pi) = _index_both(u, i)
    assert pu.dtype == pi.dtype == torch.int32
    np.testing.assert_array_equal(pu.numpy(), np.asarray(pu_j))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(pi_j))
    assert int((pu == 2**31 - 1).sum()) > 50  # the duplicates


def test_lowerbound_and_members_match():
    u, i = _pairs(1)
    (pu_j, pi_j), (pu, pi) = _index_both(u, i)
    rng = np.random.default_rng(2)
    qu = rng.integers(-1, U + 1, 4_000).astype(np.int32)
    qi = rng.integers(-1, I + 2, 4_000).astype(np.int32)
    qu[:100], qi[:100] = u[:100], i[:100]  # members for sure
    want = np.asarray(bpr_j.lowerbound_2key(pu_j, pi_j, jnp.asarray(qu),
                                            jnp.asarray(qi)))
    got = bpr.lowerbound_2key(pu, pi, torch.as_tensor(qu),
                              torch.as_tensor(qi))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(bpr_j.members_2key(pu_j, pi_j, jnp.asarray(qu),
                                         jnp.asarray(qi)))
    got = bpr.members_2key(pu, pi, torch.as_tensor(qu), torch.as_tensor(qi))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:100].all()


@pytest.mark.parametrize("epoch", [0, 3])
def test_window_negatives_match_given_jax_draws(epoch):
    u, i = _pairs(3)
    (pu_j, pi_j), (pu, pi) = _index_both(u, i)
    uj, ij = jnp.asarray(u), jnp.asarray(i)
    bj = ring_j.window_negative_bounds(uj, ij, pu_j, pi_j, si=SI,
                                       num_items=I)
    bt = ring.window_negative_bounds(torch.as_tensor(u), torch.as_tensor(i),
                                     pu, pi, si=SI, num_items=I)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    navail = np.asarray(bj[3])
    # user 0 rated all of window 1 and all of the partial last window
    for w in (1, 4):
        cell = (u == 0) & (i // SI == w)
        assert cell.any() and (navail[cell] == 0).all()
    key = jax.random.fold_in(jax.random.key(epoch), 11)
    want = np.asarray(ring_j.window_negatives(key, ij, pi_j, *bj, si=SI))
    x = jax.random.randint(key, navail.shape, 0, jnp.maximum(bj[3], 1),
                           dtype=jnp.int32)
    got = ring.window_negatives(torch.as_tensor(i), pi, *bt, si=SI,
                                x=torch.as_tensor(np.array(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    # navail == 0 -> the positive itself; otherwise an in-window
    # non-positive item
    zero = navail == 0
    np.testing.assert_array_equal(want[zero], i[zero])
    keys = set(zip(u.tolist(), i.tolist()))
    assert not any((a, b) in keys for a, b in zip(u[~zero], want[~zero]))
    assert (want // SI == i // SI).all() and (want < I).all()


def test_seeded_window_negatives_are_exact():
    u, i = _pairs(4)
    _, (pu, pi) = _index_both(u, i)
    ut, it = torch.as_tensor(u), torch.as_tensor(i)
    bt = ring.window_negative_bounds(ut, it, pu, pi, si=SI, num_items=I)
    draws = [ring.window_negatives(it, pi, *bt, si=SI,
                                   generator=ring.neg_generator(7, e, "cpu"))
             for e in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0],
                                                               draws[2])
    j = draws[0].numpy()
    keys = set(zip(u.tolist(), i.tolist()))
    real = bt[3].numpy() > 0
    assert not any((a, b) in keys for a, b in zip(u[real], j[real]))
    assert (j // SI == i // SI).all()


def test_catalog_negatives_match_given_the_same_draws():
    u, i = _pairs(5)
    (pu_j, pi_j), (pu, pi) = _index_both(u, i)
    users = np.concatenate([np.arange(U), np.zeros(5)]).astype(np.int32)
    key = jax.random.key(9)
    want = np.asarray(bpr_j.sample_negatives_device(
        key, jnp.asarray(users), pu_j, pi_j, I))
    # the reference's randint inside complement_draw, reproduced
    start = np.asarray(bpr_j.lowerbound_2key(pu_j, pi_j, jnp.asarray(users),
                                             jnp.zeros(users.shape,
                                                       jnp.int32)))
    end = np.asarray(bpr_j.lowerbound_2key(pu_j, pi_j, jnp.asarray(users),
                                           jnp.full(users.shape, I,
                                                    jnp.int32)))
    navail = jnp.asarray(I - (end - start))
    x = jax.random.randint(key, navail.shape, 0, jnp.maximum(navail, 1),
                           dtype=jnp.int32)
    got = bpr.sample_negatives_device(torch.as_tensor(users), pu, pi, I,
                                      x=torch.as_tensor(np.array(x)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_host_sampling_is_the_references():
    coo = synthetic.make_implicit_synthetic(200, 150, 6_000, rank=4, seed=1)
    keys = bpr.build_positive_index(coo)
    np.testing.assert_array_equal(keys, bpr_j.build_positive_index(coo))
    for args in ((coo.n_ratings, 150, 3, 0), (500, 150, 1, 7)):
        kw = dict(users=coo.user[:args[0]], pos_keys=keys)
        np.testing.assert_array_equal(bpr.sample_negatives(*args, **kw),
                                      bpr_j.sample_negatives(*args, **kw))
    for a, b in zip(bpr.bpr_epoch_triples(coo, 2, 1, pos_keys=keys),
                    bpr_j.bpr_epoch_triples(coo, 2, 1, pos_keys=keys)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,seed", [(1, 0), (300, 4), (100_000, 104)])
def test_item_shuffle_is_bitwise_the_references(n, seed):
    for a, b in zip(ring.item_shuffle(n, seed), ring_j.item_shuffle(n, seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
