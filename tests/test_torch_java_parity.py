"""The Java-parity gate of ``tests/parity/test_java_parity.py``, mirrored
for the port with the reference's own tolerances: the port's minibatch
trainer (``mfx_torch.solvers.sgd``) against the port's copy of the
float64 sequential oracle (``mfx_torch.oracle``), from tables drawn once
with numpy.

1. Trajectory parity: with ``batch_size=1`` the minibatch update is the
   sequential Java rule; the tables track the oracle to 5e-5, and the
   held-out RMSE of a full sequential-mode run lands within 1e-3 of it.
2. Minibatch quality: conflict-free minibatch SGD converges to within
   2e-2 of the sequential oracle's held-out RMSE.
3. Conflict-free rounds are chunk-invariant: batches of 32 and 128 give
   bitwise-equal tables.
"""

import numpy as np
import pytest
import torch

from mfx.data import synthetic as syn_j
from mfx.oracle import java_oracle as oracle_j
from mfx_torch.config import SGDConfig
from mfx_torch.convert import model_from_numpy
from mfx_torch.data import synthetic
from mfx_torch.data.split import epoch_permutation, train_test_split
from mfx_torch.eval.metrics import rmse
from mfx_torch.oracle import (init_oracle, init_oracle_from_arrays,
                              oracle_rmse, train_epoch_sequential)
from mfx_torch.solvers.sgd import make_epoch_fn, plan_epoch, train_epochs


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _init(U, I, rank, mu, seed):
    """Shared initial tables: the scaled normal of ``init_model``, drawn
    with numpy."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(rank)
    return {"P": (rng.normal(size=(U, rank)) * s).astype(np.float32),
            "Q": (rng.normal(size=(I, rank)) * s).astype(np.float32),
            "bu": np.zeros(U, np.float32), "bi": np.zeros(I, np.float32),
            "mu": np.float32(mu)}


def test_stepwise_parity_batch_size_1():
    """The port reproduces the oracle's factor tables update for update;
    the reference's oracle, run beside it, gives the same tables."""
    coo = synthetic.make_synthetic(25, 30, 300, rank=4, seed=11)
    arrays = _init(25, 30, 4, coo.global_mean, 3)
    model = model_from_numpy(arrays, device="cpu")
    oracle = init_oracle_from_arrays(arrays["P"], arrays["Q"], arrays["bu"],
                                     arrays["bi"], float(arrays["mu"]))
    ref = oracle_j.init_oracle_from_arrays(arrays["P"], arrays["Q"],
                                           arrays["bu"], arrays["bi"],
                                           float(arrays["mu"]))
    coo_j = syn_j.make_synthetic(25, 30, 300, rank=4, seed=11)
    cfg = SGDConfig(lr=0.02, reg=0.05, epochs=2, batch_size=1,
                    partitioner="fixed")
    epoch_fn = make_epoch_fn(cfg, use_bias=True)
    for epoch in range(2):
        order = epoch_permutation(coo.n_ratings, seed=0, epoch=epoch)
        plan = plan_epoch(coo, cfg, seed=0, epoch=epoch, device="cpu")
        model, _ = epoch_fn(model, plan, cfg.lr)
        train_epoch_sequential(oracle, coo, order, lr=cfg.lr, reg=cfg.reg)
        oracle_j.train_epoch_sequential(ref, coo_j, order, lr=cfg.lr,
                                        reg=cfg.reg)
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_allclose(getattr(model, k).numpy(),
                                   getattr(oracle, k), atol=5e-5)
        np.testing.assert_array_equal(getattr(oracle, k), getattr(ref, k))


def test_rmse_parity_sequential_semantics():
    """North-star 1e-3 gate: full training in Java-equivalent sequential
    mode lands within 1e-3 held-out RMSE of the oracle."""
    coo = synthetic.make_synthetic(80, 100, 4000, rank=4, noise=0.25,
                                   seed=13)
    train, test = train_test_split(coo, test_frac=0.15, seed=1)
    epochs, lr, reg = 8, 0.02, 0.05
    arrays = _init(80, 100, 4, train.global_mean, 5)
    oracle = init_oracle_from_arrays(arrays["P"], arrays["Q"], arrays["bu"],
                                     arrays["bi"], float(arrays["mu"]))
    for epoch in range(epochs):
        order = epoch_permutation(train.n_ratings, seed=0, epoch=epoch)
        train_epoch_sequential(oracle, train, order, lr=lr, reg=reg,
                               use_bias=False)
    oracle_test = oracle_rmse(oracle, test)

    cfg = SGDConfig(lr=lr, reg=reg, epochs=epochs, batch_size=1,
                    partitioner="fixed")
    model = model_from_numpy(arrays, device="cpu")
    for _, model, _ in train_epochs(model, train, cfg, use_bias=False,
                                    seed=0):
        pass
    ours = rmse(model, test)
    assert abs(ours - oracle_test) <= 1e-3, (ours, oracle_test)


def test_minibatch_quality_matches_oracle():
    """Conflict-free minibatch SGD converges to oracle-equivalent quality
    (a small stationary-point tolerance; the exact 1e-3 path is the
    sequential semantics above)."""
    coo = synthetic.make_synthetic(200, 250, 12_000, rank=4, noise=0.2,
                                   seed=21)
    train, test = train_test_split(coo, test_frac=0.15, seed=1)
    mu = train.global_mean
    epochs, lr0, reg, decay = 25, 0.04, 0.1, 0.85

    oracle = init_oracle(200, 250, 4, mu, seed=7)
    for epoch in range(epochs):
        order = epoch_permutation(train.n_ratings, seed=0, epoch=epoch)
        train_epoch_sequential(oracle, train, order, lr=lr0 * decay**epoch,
                               reg=reg, use_bias=False)
    oracle_test = oracle_rmse(oracle, test)

    cfg = SGDConfig(lr=lr0, reg=reg, lr_decay=decay, epochs=epochs,
                    batch_size=64, partitioner="conflict_free")
    model = model_from_numpy(_init(200, 250, 4, mu, 7), device="cpu")
    for _, model, _ in train_epochs(model, train, cfg, use_bias=False,
                                    seed=0):
        pass
    ours = rmse(model, test)
    assert abs(ours - oracle_test) <= 2e-2, (ours, oracle_test)


def test_chunking_invariance_of_conflict_free_rounds():
    """Within a conflict-free round all rows are disjoint, so the tables
    are bitwise identical however rounds are chunked into batches; a
    second run repeats the first bit for bit."""
    coo = synthetic.make_synthetic(100, 120, 4000, rank=4, seed=3)
    arrays = _init(100, 120, 4, coo.global_mean, 9)
    results = []
    for bs in (32, 128, 128):
        model = model_from_numpy(arrays, device="cpu")
        cfg = SGDConfig(lr=0.03, reg=0.02, epochs=2, batch_size=bs,
                        partitioner="conflict_free")
        for _, model, _ in train_epochs(model, coo, cfg, use_bias=True,
                                        seed=0):
            pass
        results.append(model)
    for other in results[1:]:
        for k in ("P", "Q", "bu", "bi"):
            assert torch.equal(getattr(results[0], k), getattr(other, k)), k
