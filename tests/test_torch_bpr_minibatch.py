"""The snapshot-minibatch BPR trainers of the port against the JAX
package's on the CPU, at the reference's own small shapes
(``tests/unit/test_bpr_weighted.py``: 150 users x 60 items x 4,000
positives, rank 8, batches of 1,024): ``train_epochs_bpr`` with host
sampling (the reference's own triples) and with device sampling (fed the
reference's ``jax.random`` permutation and draws through the hooks), with
uniform and popularity negatives; the weighted device sampler given the
reference's uniforms, down to sub-ulp tail items; the data-parallel
trainer of one shard; the ring's ``bpr.kernel='jnp'`` path of one shard
on the host and on the device; the ring planner's copy; bf16 tables; and
resuming from ``start_epoch``.

Tolerances: f32 tables within 1e-5 of the reference's after two epochs
and the mean loss within 1e-6 relative (the dot's f32 sum order may
differ); bf16 tables and losses, the samplers' draws, the plans and the
data-parallel run against the port's single one bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.config import BPRConfig
from mfx.data import bpr as bpr_j
from mfx.data import synthetic
from mfx.models import init_model
from mfx.parallel import bpr_sharded as ring_j
from mfx.parallel import data_parallel as dp_j
from mfx.runtime.mesh import make_mesh
from mfx.solvers import bpr as solver_j
from mfx_torch.config import BPRConfig as BPRConfigT
from mfx_torch.convert import model_from_numpy
from mfx_torch.data import bpr
from mfx_torch.parallel import bpr_sharded as ring
from mfx_torch.parallel import data_parallel as dp
from mfx_torch.solvers import bpr as solver

SEED, NEG_SEED, RANK = 3, 1, 8
TABLE_TOL, LOSS_RTOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a process: under ``pytest -n 6`` the workers'
    thread pools otherwise fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coo():
    return synthetic.make_implicit_synthetic(150, 60, 4000, rank=4, seed=2)


def _cfg(**kw):
    base = dict(lr=0.05, reg=0.002, epochs=2, batch_size=1024,
                neg_seed=NEG_SEED, kernel="jnp")
    return BPRConfig(**{**base, **kw})


def _port_cfg(cfg):
    return BPRConfigT(**dataclasses.asdict(cfg))


def _models(coo, dtype="float32"):
    """The reference's seeded init and the same tables in the port."""
    m0 = init_model(0, coo.num_users, coo.num_items, RANK, global_mean=0.0,
                    dtype=jnp.dtype(dtype))
    arrays = {k: np.asarray(getattr(m0, k).astype(jnp.float32))
              for k in ("P", "Q", "bu", "bi", "mu")}
    return m0, lambda: model_from_numpy(arrays, device="cpu", dtype=dtype)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _hold(got, ref, exact=False):
    assert len(got) == len(ref)
    for (lt, mt), (lj, mj) in zip(got, ref):
        for k in ("P", "Q"):
            a, b = getattr(mt, k).float().numpy(), _f32(getattr(mj, k))
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=TABLE_TOL,
                                           err_msg=k)
        if exact:
            assert lt == lj
        else:
            assert lt == pytest.approx(lj, rel=LOSS_RTOL)
    assert got[-1][0] < got[0][0]  # it trains


# the reference's jax.random numbers, as train_epochs_bpr draws them with
# sample_device='device' (mfx/solvers/bpr.py:_epoch_triples_device)
def _key(name, epoch):
    base = jax.random.key(SEED + NEG_SEED)
    return jax.random.fold_in(jax.random.fold_in(base, name), epoch)


def _perm_rand(epoch, n):
    return torch.as_tensor(np.array(jax.random.permutation(
        _key(0xBE, epoch), n))).long()


def _neg_rand(epoch, navail):
    nav = jnp.asarray(navail.numpy())
    return torch.as_tensor(np.array(jax.random.randint(
        _key(0xB1, epoch), nav.shape, 0, jnp.maximum(nav, 1),
        dtype=jnp.int32)))


def _uniforms(key, n):
    """A weighted-sampler round's (u, u2), as the reference draws them."""
    u = jax.random.uniform(key, (n,), dtype=jnp.float32)
    u2 = jax.random.uniform(jax.random.fold_in(key, 0x10), (n,),
                            dtype=jnp.float32)
    return torch.as_tensor(np.array(u)), torch.as_tensor(np.array(u2))


def _cdf_rand(epoch, r, n):
    return _uniforms(jax.random.fold_in(_key(0xB1, epoch), r), n)


@pytest.mark.parametrize("weighting", ["uniform", "popularity"])
def test_host_sampling_trains_on_the_reference_triples(weighting):
    coo = _coo()
    cfg = _cfg(sample_device="host", neg_weighting=weighting)
    m0, fresh = _models(coo)
    ref = [(loss, m) for _, m, loss in solver_j.train_epochs_bpr(
        m0, coo, cfg, seed=SEED)]
    got = [(loss, m) for _, m, loss in solver.train_epochs_bpr(
        fresh(), coo, _port_cfg(cfg), seed=SEED, device="cpu")]
    _hold(got, ref)


@pytest.mark.parametrize("weighting", ["uniform", "popularity"])
def test_device_sampling_given_the_reference_draws(weighting):
    coo = _coo()
    cfg = _cfg(sample_device="device", neg_weighting=weighting)
    m0, fresh = _models(coo)
    ref = [(loss, m) for _, m, loss in solver_j.train_epochs_bpr(
        m0, coo, cfg, seed=SEED)]
    got = [(loss, m) for _, m, loss in solver.train_epochs_bpr(
        fresh(), coo, _port_cfg(cfg), seed=SEED, device="cpu",
        perm_rand=_perm_rand, neg_rand=_neg_rand, cdf_rand=_cdf_rand)]
    _hold(got, ref)


@pytest.mark.parametrize("weighting", ["uniform", "popularity"])
def test_device_epoch_triples_equal_the_reference(weighting):
    """One epoch's padded device batches, bit for bit."""
    coo = _coo()
    u, i = coo.user.astype(np.int32), coo.item.astype(np.int32)
    pu_j, pi_j = bpr_j.build_positive_index_device(jnp.asarray(u),
                                                   jnp.asarray(i))
    cdf = (bpr_j.popularity_cdf(coo.item, coo.num_items, 0.75)
           if weighting == "popularity" else None)
    want = solver_j._epoch_triples_device(
        jnp.asarray(u), jnp.asarray(i), pu_j, pi_j, _key(0xBE, 1),
        _key(0xB1, 1), batch_size=1024, num_items=coo.num_items,
        cdf=None if cdf is None else bpr_j.split_cdf_f32(cdf))
    ut, it = torch.as_tensor(u), torch.as_tensor(i)
    pu, pi = bpr.build_positive_index_device(ut, it)
    got = solver.epoch_triples_device(
        ut, it, pu, pi, _perm_rand(1, coo.n_ratings), 1024, coo.num_items,
        cdf=None if cdf is None else bpr.split_cdf_f32(cdf),
        x=lambda navail: _neg_rand(1, navail),
        draw=lambda r: _cdf_rand(1, r, coo.n_ratings))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _tail_catalog():
    """One mega-hit and 1,000 count-1 items (tail masses ~1e-9, far below
    the f32 ulp near 1.0), and users who hold the hit and tail items."""
    w = np.concatenate([[1e9], np.ones(1000)])
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    rng = np.random.default_rng(4)
    u = np.repeat(np.arange(40, dtype=np.int32), 30)
    i = rng.integers(0, 1001, u.size).astype(np.int32)
    i[::30] = 0  # every user holds the hit: most first draws collide
    return cdf, u, i


@pytest.mark.parametrize("form", ["pair", "plain_f32"])
def test_weighted_sampler_picks_the_reference_items(form):
    """Given the reference's uniforms, the same negatives: 16 redraw
    rounds, the positive as the fallback, sub-ulp tail items reached."""
    cdf, u, i = _tail_catalog()
    pu_j, pi_j = bpr_j.build_positive_index_device(jnp.asarray(u),
                                                   jnp.asarray(i))
    pu, pi = bpr.build_positive_index_device(torch.as_tensor(u),
                                             torch.as_tensor(i))
    key = jax.random.key(9)
    if form == "pair":
        cdf_j, cdf_t = bpr_j.split_cdf_f32(cdf), bpr.split_cdf_f32(cdf)
    else:
        cdf_j = jnp.asarray(cdf, jnp.float32)
        cdf_t = torch.as_tensor(cdf.astype(np.float32))
    want = np.asarray(bpr_j.sample_negatives_weighted_device(
        key, jnp.asarray(u), pu_j, pi_j, cdf_j, fallback=jnp.asarray(i)))
    got = bpr.sample_negatives_weighted_device(
        torch.as_tensor(u), pu, pi, cdf_t, fallback=torch.as_tensor(i),
        draw=lambda r: _uniforms(jax.random.fold_in(key, r), u.size))
    np.testing.assert_array_equal(got.numpy(), want)
    if form == "pair":
        assert (want > 0).sum() > u.size // 2  # the tail is drawn


def test_pair_search_matches_the_reference_at_binade_edges():
    """The int64-key search against the reference's lexicographic binary
    search, on queries crowded at the edges where a float64 sum of the
    pair would order them differently."""
    cdf, _, _ = _tail_catalog()
    rng = np.random.default_rng(5)
    n = 50_000
    q_hi = rng.random(n).astype(np.float32)
    q_hi[: n // 2] = np.float32(1.0) - rng.integers(
        0, 4_000, n // 2).astype(np.float32) * np.float32(2.0**-24)
    q_hi[n // 2: 3 * n // 4] = np.float32(0.5)  # a binade edge
    q_lo = ((rng.random(n).astype(np.float32) - 0.5)
            * np.float32(2.0**-24)).astype(np.float32)
    hi, lo = bpr_j.split_cdf_f32(cdf)
    want = np.asarray(bpr_j._upperbound_cdf2(hi, lo, jnp.asarray(q_hi),
                                             jnp.asarray(q_lo)))
    got = bpr.upperbound_cdf2(*bpr.split_cdf_f32(cdf),
                              torch.as_tensor(q_hi), torch.as_tensor(q_lo))
    np.testing.assert_array_equal(got.numpy(), want)


def test_data_parallel_is_the_single_host_run():
    """parallel.mode='dp' on one data shard: the reference's on a
    one-device mesh within the tolerance, the port's single trainer with
    host sampling bit for bit; more data shards are refused."""
    coo = _coo()
    cfg = _cfg(neg_weighting="popularity")  # sample_device 'auto'
    m0, fresh = _models(coo)
    ref = [(loss, m) for _, m, loss in dp_j.train_epochs_bpr_dp(
        m0, coo, cfg, make_mesh(data=1), seed=SEED)]
    got = [(loss, m) for _, m, loss in dp.train_epochs_bpr_dp(
        fresh(), coo, _port_cfg(cfg), seed=SEED, device="cpu")]
    _hold(got, ref)
    single = [(loss, m) for _, m, loss in solver.train_epochs_bpr(
        fresh(), coo, dataclasses.replace(_port_cfg(cfg),
                                          sample_device="host"),
        seed=SEED, device="cpu")]
    for (lt, mt), (ls, ms) in zip(got, single):
        assert lt == ls
        assert torch.equal(mt.P, ms.P) and torch.equal(mt.Q, ms.Q)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        next(dp.train_epochs_bpr_dp(fresh(), coo, _port_cfg(cfg),
                                    data_axis=2, device="cpu"))


# the reference ring's jax.random numbers (mfx/parallel/bpr_sharded.py:
# bpr_ring_epoch_device)
def _ring_plan_rand(epoch, n):
    return torch.as_tensor(np.array(jax.random.bits(
        _key(0x5F, epoch), (n,), dtype=jnp.uint32).astype(jnp.int32)))


def _ring_neg_rand(epoch, navail):
    nav = jnp.asarray(navail.numpy())
    return torch.as_tensor(np.array(jax.random.randint(
        _key(0xBB5D, epoch), nav.shape, 0, jnp.maximum(nav, 1),
        dtype=jnp.int32)))


@pytest.mark.parametrize("sample_device", ["host", "device"])
def test_ring_jnp_path_matches_the_reference(sample_device):
    coo = _coo()
    cfg = _cfg(sample_device=sample_device)
    m0, fresh = _models(coo)
    ref = [(loss, m) for _, m, loss in ring_j.train_epochs_bpr_ring(
        m0, coo, cfg, make_mesh(model=1), seed=SEED)]
    got = [(loss, m) for _, m, loss in ring.train_epochs_bpr_ring(
        fresh(), coo, _port_cfg(cfg), seed=SEED, device="cpu",
        plan_rand=_ring_plan_rand, neg_rand=_ring_neg_rand)]
    _hold(got, ref)


@pytest.mark.parametrize("S", [1, 2])
def test_ring_planner_copy_is_the_original(S):
    coo = _coo()
    fwd, _ = ring_j.item_shuffle(coo.num_items, SEED)
    keys = np.sort(coo.user.astype(np.int64) * coo.num_items
                   + fwd[coo.item])
    want = ring_j.plan_bpr_ring_epoch(coo, S, 512, SEED, 2, item_map=fwd,
                                      pos_keys=keys)
    got = ring.plan_bpr_ring_epoch(coo, S, 512, SEED, 2, item_map=fwd,
                                   pos_keys=keys)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


def test_ring_device_epoch_equals_the_reference():
    """One epoch of the ring's device batches at S = 1, bit for bit."""
    coo = _coo()
    fwd, _ = ring_j.item_shuffle(coo.num_items, SEED)
    u = coo.user.astype(np.int32)
    irel = fwd[coo.item].astype(np.int32)
    skel_j = ring_j.build_bpr_ring_skeleton(
        jnp.asarray(u), jnp.asarray(irel), 1, coo.num_users, coo.num_items,
        1024)
    want = ring_j.bpr_ring_epoch_device(skel_j, jnp.asarray(u),
                                        jnp.asarray(irel), SEED + NEG_SEED,
                                        1, 1024)
    ut, it = torch.as_tensor(u), torch.as_tensor(irel)
    skel = ring.build_bpr_ring_skeleton(ut, it, 1, coo.num_users,
                                        coo.num_items, 1024)
    assert (skel.nb, skel.width, skel.n_real) == (skel_j.nb, skel_j.width,
                                                  skel_j.n_real)
    got = ring.bpr_ring_epoch_device(skel, ut, it, SEED + NEG_SEED, 1, 1024,
                                     plan_rand=_ring_plan_rand,
                                     neg_rand=_ring_neg_rand)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("path", ["single", "ring"])
def test_bf16_tables_match_the_reference_bf16_run(path):
    """bf16 tables, host sampling: the reference's compiled bf16 step
    (each delta rounded and added on its own) bit for bit."""
    coo = _coo()
    cfg = _cfg(sample_device="host")
    m0, fresh = _models(coo, dtype="bfloat16")
    if path == "single":
        ref = [(loss, m) for _, m, loss in solver_j.train_epochs_bpr(
            m0, coo, cfg, seed=SEED)]
        got = [(loss, m) for _, m, loss in solver.train_epochs_bpr(
            fresh(), coo, _port_cfg(cfg), seed=SEED, device="cpu")]
    else:
        ref = [(loss, m) for _, m, loss in ring_j.train_epochs_bpr_ring(
            m0, coo, cfg, make_mesh(model=1), seed=SEED)]
        got = [(loss, m) for _, m, loss in ring.train_epochs_bpr_ring(
            fresh(), coo, _port_cfg(cfg), seed=SEED, device="cpu")]
    assert got[-1][1].P.dtype == torch.bfloat16
    _hold(got, ref, exact=True)


def test_bf16_deltas_equal_the_reference_step():
    """One bf16 batch's deltas and loss against the reference's jitted
    ``bpr_compute_deltas`` (f32 outputs), pad triples included."""
    rng = np.random.default_rng(6)
    U, I, B = 50, 40, 512
    bf = jnp.bfloat16
    P = jnp.asarray(rng.normal(0, 0.3, (U, RANK)), bf)
    Q = jnp.asarray(rng.normal(0, 0.3, (I, RANK)), bf)
    ids = [rng.integers(0, n, B).astype(np.int32) for n in (U, I, I)]
    w = np.ones(B, np.float32)
    w[-9:] = 0.0
    m = solver_j.MFModel(P=P, Q=Q, bu=jnp.zeros(U, bf), bi=jnp.zeros(I, bf),
                         mu=jnp.zeros((), bf))
    want = jax.jit(solver_j.bpr_compute_deltas)(
        m, *ids, w, jnp.asarray(0.05, bf), jnp.asarray(0.002, bf))
    got = solver.bpr_compute_deltas(
        torch.tensor(_f32(P)).bfloat16(), torch.tensor(_f32(Q)).bfloat16(),
        *(torch.as_tensor(x).long() for x in ids), torch.as_tensor(w),
        torch.tensor(0.05).bfloat16(), torch.tensor(0.002).bfloat16())
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)
    assert float(got[3]) == float(want[3])


@pytest.mark.parametrize("run", ["host", "device", "ring_device"])
def test_resume_from_start_epoch_repeats_the_unbroken_run(run):
    coo = _coo()
    cfg = _port_cfg(_cfg(epochs=3, neg_weighting="popularity"
                         if run == "device" else "uniform",
                         sample_device="host" if run == "host"
                         else "device"))
    _, fresh = _models(coo)
    trainer = (ring.train_epochs_bpr_ring if run == "ring_device"
               else solver.train_epochs_bpr)
    full = list(trainer(fresh(), coo, cfg, seed=SEED, device="cpu"))
    resumed = list(trainer(full[1][1], coo, cfg, seed=SEED, device="cpu",
                           start_epoch=2))
    assert [e for e, _, _ in resumed] == [2]
    assert resumed[0][2] == full[2][2]
    for k in ("P", "Q"):
        assert torch.equal(getattr(resumed[0][1], k), getattr(full[2][1], k))


def test_device_sampling_on_its_own_generators():
    """With no hooks the device sampler draws from seeded torch
    generators: two runs agree bit for bit, no uniform negative is a
    positive of its user, and a popularity draw is one only as the
    positive itself (the fallback)."""
    coo = _coo()
    keys = bpr_j.build_positive_index(coo)
    u, i = torch.as_tensor(coo.user), torch.as_tensor(coo.item)
    pu, pi = bpr.build_positive_index_device(u, i)
    for cdf in (None, bpr.split_cdf_f32(bpr.popularity_cdf(
            coo.item, coo.num_items))):
        runs = [solver.epoch_triples_device(
            u, i, pu, pi, torch.randperm(coo.n_ratings, generator=(
                torch.Generator().manual_seed(1))), 1024, coo.num_items,
            cdf=cdf, generator=solver.seeded_generator(7, 0xB1, 0, "cpu"))
            for _ in range(2)]
        for k in runs[0]:
            assert torch.equal(runs[0][k], runs[1][k])
        b = runs[0]
        real = b["weights"].reshape(-1) > 0
        uu, ii, jj = (b[k].reshape(-1)[real].numpy().astype(np.int64)
                      for k in ("users", "pos", "neg"))
        hit = np.isin(uu * coo.num_items + jj, keys)
        if cdf is None:
            assert not hit.any()
        else:
            assert (jj[hit] == ii[hit]).all()
