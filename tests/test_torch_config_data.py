"""The port's own copies of ``mfx.config`` and ``mfx.data`` against the
originals: the same presets, overrides and validation, and bitwise the
same generated data, splits and indexes."""

import dataclasses

import numpy as np
import pytest

import mfx.config as cfg_j
from mfx.data import loaders as loaders_j
from mfx.data import split as split_j
from mfx.data import synthetic as syn_j
import mfx_torch.config as cfg_t
from mfx_torch.data import loaders as loaders_t
from mfx_torch.data import split as split_t
from mfx_torch.data import synthetic as syn_t


def _coo_equal(a, b):
    assert (a.num_users, a.num_items, a.synthetic) == (
        b.num_users, b.num_items, b.synthetic)
    for k in ("user", "item", "rating", "item_raw_ids", "user_raw_ids",
              "timestamp"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("name", sorted(cfg_j.PRESETS))
def test_presets_are_equal(name):
    assert sorted(cfg_t.PRESETS) == sorted(cfg_j.PRESETS)
    assert (dataclasses.asdict(cfg_t.preset(name))
            == dataclasses.asdict(cfg_j.preset(name)))


@pytest.mark.parametrize("overrides", [
    ["parallel.model_axis=1", "data.dataset=synthetic-small-implicit"],
    ["bpr.epochs=2", "bpr.lr=0.1", "ranking_k=5", "model.init_scale=0.1"],
    ["sgd.dense_chi=0", "sgd.plan_device=host", "clip_predictions=false"],
])
def test_apply_overrides_is_equal(overrides):
    for name in ("billion_bpr_sharded", "ml25m_rank64"):
        a = cfg_t.apply_overrides(cfg_t.preset(name), overrides)
        b = cfg_j.apply_overrides(cfg_j.preset(name), overrides)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("bad,exc", [
    (["bpr.nope=1"], KeyError), (["nosuch.field=1"], KeyError),
    (["bpr.kernel=cuda"], ValueError), (["no_equals_sign"], ValueError),
    (["bpr.neg_weighting=popularity"], ValueError),
    (["bpr.sample_device=tpu"], ValueError),
])
def test_apply_overrides_rejects_alike(bad, exc):
    msgs = []
    for mod in (cfg_t, cfg_j):
        with pytest.raises(exc) as info:
            mod.apply_overrides(mod.preset("billion_bpr_sharded"), bad)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw", [
    {"kernel": "cuda"}, {"sample_device": "gpu"}, {"neg_weighting": "pop"},
    {"neg_weighting": "popularity", "kernel": "pallas"},
])
def test_bpr_config_rejects_alike(kw):
    msgs = []
    for mod in (cfg_t, cfg_j):
        with pytest.raises(ValueError) as info:
            mod.BPRConfig(**kw)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert cfg_t.BPRConfig(neg_weighting="popularity") == cfg_t.BPRConfig(
        **dataclasses.asdict(cfg_j.BPRConfig(neg_weighting="popularity")))


@pytest.mark.parametrize("gen", ["explicit", "explicit_skewed", "implicit"])
def test_synthetic_generators_are_bitwise_equal(gen):
    if gen == "implicit":
        args, kw = (300, 200, 9_000), dict(rank=8, seed=4, chunk=4_000)
        fn = "make_implicit_synthetic"
    else:
        args = (400, 300, 12_000)
        kw = dict(rank=4, seed=3, star_step=0.5)
        if gen == "explicit_skewed":
            kw["user_zipf_s"] = 0.6
        fn = "make_synthetic"
    _coo_equal(getattr(syn_t, fn)(*args, **kw),
               getattr(syn_j, fn)(*args, **kw))
    assert syn_t.BILLION_SHAPE == syn_j.BILLION_SHAPE
    assert syn_t.ML25M_SHAPE == syn_j.ML25M_SHAPE


@pytest.mark.parametrize("name", ["synthetic-small",
                                  "synthetic-small-implicit"])
def test_load_dataset_is_bitwise_equal(name, tmp_path):
    assert loaders_t.dataset_names() == loaders_j.dataset_names()
    assert loaders_t.GENERATOR_VERSION == loaders_j.GENERATOR_VERSION
    a = loaders_t.load_dataset(name, root=tmp_path / "t", cache=False)
    b = loaders_j.load_dataset(name, root=tmp_path / "j", cache=False)
    _coo_equal(a, b)
    # the port reads the reference's cache file, and the reverse
    loaders_j.load_dataset(name, root=tmp_path / "j")
    _coo_equal(loaders_t.load_dataset(name, root=tmp_path / "j"), b)


def test_splits_are_equal():
    coo_t = syn_t.make_synthetic(500, 300, 10_000, rank=4, seed=1)
    coo_j = syn_j.make_synthetic(500, 300, 10_000, rank=4, seed=1)
    for a, b in zip(split_t.train_test_split(coo_t, 0.1, seed=5),
                    split_j.train_test_split(coo_j, 0.1, seed=5)):
        _coo_equal(a, b)
    for a, b in zip(split_t.leave_one_out_split(coo_t, seed=2),
                    split_j.leave_one_out_split(coo_j, seed=2)):
        _coo_equal(a, b)
    np.testing.assert_array_equal(split_t.epoch_permutation(1000, 3, 4),
                                  split_j.epoch_permutation(1000, 3, 4))
    ts = np.arange(coo_j.n_ratings, dtype=np.int64)[::-1].copy()
    stamped = dataclasses.replace(coo_j, timestamp=ts)
    stamped_t = dataclasses.replace(coo_t, timestamp=stamped.timestamp)
    for fn in ("chronological_split", "user_chronological_split"):
        for a, b in zip(getattr(split_t, fn)(stamped_t, 0.2),
                        getattr(split_j, fn)(stamped, 0.2)):
            _coo_equal(a, b)


def test_seen_csr_is_equal():
    coo_t = syn_t.make_implicit_synthetic(300, 200, 5_000, rank=4, seed=2)
    coo_j = syn_j.make_implicit_synthetic(300, 200, 5_000, rank=4, seed=2)
    a, b = coo_t.seen_csr(), coo_j.seen_csr()
    np.testing.assert_array_equal(a.items, b.items)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    users = np.array([0, 5, 5, 299, 17], np.int32)
    for x, y in zip(a.batch(users, pad_row=8), b.batch(users, pad_row=8)):
        np.testing.assert_array_equal(x, y)


def _skewed(seed):
    # Zipf-skewed users and items: hot rows force many conflict-free rounds
    return syn_j.make_synthetic(400, 300, 6_000, rank=4, seed=seed,
                                user_zipf_s=0.9)


@pytest.mark.parametrize("seed,batch_size", [(3, 64), (5, 2048), (7, 1)])
def test_conflict_free_batches_are_the_references(seed, batch_size):
    """The partition copy's O(n) loop returns exactly the batches of the
    reference's native greedy and of its NumPy fallback, conflict-free,
    in the same order."""
    from mfx import native
    from mfx.data import partition as part_j
    from mfx_torch.data import partition as part_t

    coo = _skewed(seed)
    perm = split_j.epoch_permutation(coo.n_ratings, seed, 2)
    got = part_t.partition_conflict_free(
        coo.user, coo.item, batch_size, perm, num_users=coo.num_users,
        num_items=coo.num_items)
    assert native.available()
    ref = part_j.partition_conflict_free(
        coo.user, coo.item, batch_size, perm, num_users=coo.num_users,
        num_items=coo.num_items)
    others = (ref,
              part_j._partition_conflict_free_numpy(coo.user, coo.item,
                                                    batch_size, perm))
    for want in others:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    part_t.validate_conflict_free(coo.user, coo.item, got)
    rounds, n = part_t.conflict_free_rounds(coo.user, coo.item, perm,
                                            coo.num_users, coo.num_items)
    want_rounds, want_n = native.conflict_free_rounds(
        coo.user, coo.item, perm, coo.num_users, coo.num_items)
    np.testing.assert_array_equal(rounds, want_rounds)
    assert n == want_n


@pytest.mark.parametrize("order", ["flat", "batches"])
def test_pad_to_batches_is_equal(order):
    from mfx.data import partition as part_j
    from mfx_torch.data import partition as part_t

    coo = _skewed(1)
    perm = split_j.epoch_permutation(coo.n_ratings, 1, 0)
    if order == "batches":
        perm = part_j.partition_conflict_free(coo.user, coo.item, 96, perm)
    extras = {"bin": np.arange(coo.n_ratings, dtype=np.int16)}
    for sizes in ((coo.num_users, coo.num_items), (None, None)):
        a = part_t.pad_to_batches(coo.user, coo.item, coo.rating, perm, 96,
                                  *sizes, extras=extras)
        b = part_j.pad_to_batches(coo.user, coo.item, coo.rating, perm, 96,
                                  *sizes, extras=extras)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert part_t.PAD_ID == part_j.PAD_ID
    np.testing.assert_array_equal(
        part_t.partition_fixed(coo.n_ratings, 96, perm if order == "flat"
                               else np.arange(coo.n_ratings)),
        part_j.partition_fixed(coo.n_ratings, 96, perm if order == "flat"
                               else np.arange(coo.n_ratings)))


def test_validate_conflict_free_rejects_alike():
    from mfx.data import partition as part_j
    from mfx_torch.data import partition as part_t

    user = np.array([0, 1, 0, 2], np.int32)
    item = np.array([0, 1, 2, 1], np.int32)
    for bad, what in (([np.array([0, 2])], "user"),
                      ([np.array([1, 3])], "item")):
        msgs = []
        for mod in (part_t, part_j):
            with pytest.raises(AssertionError, match=what) as info:
                mod.validate_conflict_free(user, item, bad)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("use_bias", [True, False])
def test_java_oracle_copy_is_bitwise_equal(use_bias):
    """The oracle copy runs the same float64 arithmetic as the original:
    tables, biases and both RMSEs bit for bit, from a shared init and from
    each package's own seeded init."""
    from mfx.oracle import java_oracle as oj
    from mfx_torch.data.coo import RatingsCOO as CooT
    from mfx_torch.oracle import java_oracle as ot

    coo_j = syn_j.make_synthetic(40, 50, 900, rank=4, seed=9)
    coo_t = CooT(user=coo_j.user, item=coo_j.item, rating=coo_j.rating,
                 num_users=40, num_items=50)
    a = ot.init_oracle(40, 50, 4, coo_j.global_mean, seed=2)
    b = oj.init_oracle(40, 50, 4, coo_j.global_mean, seed=2)
    rng = np.random.default_rng(0)
    shared = [rng.normal(size=(40, 4)), rng.normal(size=(50, 4)),
              rng.normal(size=40), rng.normal(size=50), 3.25]
    c = ot.init_oracle_from_arrays(*shared)
    d = oj.init_oracle_from_arrays(*shared)
    for x, y in ((a, b), (c, d)):
        for epoch in range(2):
            order = split_j.epoch_permutation(coo_j.n_ratings, 0, epoch)
            rx = ot.train_epoch_sequential(x, coo_t, order, lr=0.02,
                                           reg=0.05, use_bias=use_bias)
            ry = oj.train_epoch_sequential(y, coo_j, order, lr=0.02,
                                           reg=0.05, use_bias=use_bias)
            assert rx == ry
        for k in ("P", "Q", "bu", "bi"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
        assert ot.oracle_rmse(x, coo_t) == oj.oracle_rmse(y, coo_j)
