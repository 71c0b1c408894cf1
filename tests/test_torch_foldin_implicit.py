"""The port's ``fold_in_implicit`` (``mfx_torch/serve/foldin.py``) against
the reference's (``mfx/serve/foldin.py``) on the same tables and
histories (2e-4), with and without a precomputed Gram, ``max_deg`` cuts,
pad slots, empty histories and ``transpose``; and against the port's own
iALS half-sweep rows of existing users (``tests/unit/test_foldin.py``'s
check, 2e-4 / 2e-5)."""

import numpy as np
import pytest
import torch

from mfx.models import init_model
from mfx.serve.foldin import fold_in_implicit as fold_j
from mfx_torch.serve import fold_in_implicit
from mfx_torch.solvers.ials import ials_half_sweep
from test_torch_als import one_thread, port  # noqa: F401

U, I, K, ALPHA, REG = 12, 40, 6, 15.0, 0.4


def histories(seed=7, lens=(5, 0, 1, 9, 30, 3)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, I, n).astype(np.int32),
             rng.integers(1, 4, n).astype(np.float32)) for n in lens]


@pytest.mark.parametrize("transpose,max_deg,gram", [
    (False, 4096, False), (False, 4, False), (False, 4096, True),
    (True, 4096, False)])
def test_matches_the_reference(transpose, max_deg, gram):
    m = init_model(3, U, I, K)
    hs = histories()
    if transpose:  # new items against the user table
        hs = [(ids % U, r) for ids, r in hs]
    pm = port(m)
    F = np.asarray(m.P if transpose else m.Q)
    g = F.T @ F if gram else None
    want = np.asarray(fold_j(m, hs, ALPHA, REG, transpose=transpose,
                             max_deg=max_deg,
                             gram=None if g is None else np.asarray(g)))
    got = fold_in_implicit(pm, hs, ALPHA, REG, transpose=transpose,
                           max_deg=max_deg,
                           gram=None if g is None else torch.as_tensor(g))
    assert got.shape == (len(hs), K) and got.device == pm.device
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert torch.equal(got[1], torch.zeros(K))  # the empty history


def test_existing_users_equal_their_half_sweep_rows():
    from mfx.data.coo import RatingsCOO

    rng = np.random.default_rng(7)
    u = np.repeat(np.arange(U, dtype=np.int32), 5)
    i = rng.integers(0, I, size=u.shape[0]).astype(np.int32)
    key = u.astype(np.int64) * I + i
    _, first = np.unique(key, return_index=True)
    u, i = u[first], i[first]
    r = rng.integers(1, 4, size=u.shape[0]).astype(np.float32)
    coo = RatingsCOO(u, i, r, U, I, synthetic=True)
    pm = port(init_model(3, U, I, K))
    by = np.argsort(coo.user, kind="stable")
    rows = ials_half_sweep(pm.P, pm.Q, coo.user[by], coo.item[by],
                           coo.rating[by], ALPHA, REG)
    hs = [(coo.item[coo.user == x], coo.rating[coo.user == x])
          for x in range(U)]
    got = fold_in_implicit(pm, hs, ALPHA, REG, gram=pm.Q.T @ pm.Q)
    np.testing.assert_allclose(got.numpy(), rows.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_refuses_no_histories():
    with pytest.raises(ValueError, match="at least one history"):
        fold_in_implicit(port(init_model(0, U, I, K)), [], ALPHA, REG)
