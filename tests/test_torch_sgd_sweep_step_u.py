"""The port's step-batched sparse sweep (plain version of the
sgd_sweep_step_u kernel) against the reference Pallas kernel with
``step_u=True`` in interpret mode, on the same tile plan and the same
initial tables, and against the port's per-tile sweep."""

import numpy as np
import pytest
import torch

from mfx_torch.kernels.sgd_sweep import (sgd_sweep_step_u,
                                         sgd_sweep_step_u_plain,
                                         sgd_sweep_tile)
from test_torch_sgd_sweep_tile import (KEYS, LR, REG, SI, SU, T,
                                       assert_tables_close, run_port,
                                       run_reference, sweep_case,
                                       touched_rows)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a process: under ``pytest -n 6`` the workers'
    thread pools otherwise fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ranks 16 to 1 at the trainers' tpg only, and 2 and 1 with biases only:
# the reference's interpret mode compiles its unrolled pack loop (8 to 128
# slots a lane row) once a case, 10-50 s at ranks 16 to 4 and minutes at
# rank 1, and neither tpg nor the bias terms are rank-dependent parts of
# the form. Ranks from 1 up: a run spread over workers ends sooner when
# its longest cases start first
@pytest.mark.parametrize("rank,use_bias,tpg", [
    (rank, use_bias, tpg) for tpg in (4, 2) for use_bias in (True, False)
    for rank in (1, 2, 4, 8, 16, 32, 64, 128)
    if (tpg == 4 or rank >= 32) and (use_bias or rank >= 4)])
def test_step_u_sweep_matches_pallas_interpret(rank, use_bias, tpg):
    plans, model = sweep_case(rank, tpg)
    ref, sse_j = run_reference(plans, model, rank, tpg, use_bias, step_u=True)
    got, sse_t = run_port(sgd_sweep_step_u, plans, model, tpg, use_bias)
    # a group's user-side sum holds up to tpg*T terms, associated
    # differently by the reference's one-hot matmul: f32 noise only
    assert_tables_close(got, ref, 5e-6)
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j
    moved = np.abs(ref["bu"] - np.asarray(model.bu)).max()
    assert (moved > 1e-4) == use_bias


@pytest.mark.parametrize("rank", [32, 64, 128])
def test_step_u_with_groups_of_one_tile_is_the_per_tile_sweep(rank):
    plans, model = sweep_case(rank, 1)
    a, sa = run_port(sgd_sweep_step_u, plans, model, 1, True)
    b, sb = run_port(sgd_sweep_tile, plans, model, 1, True)
    for k in KEYS:
        assert float((a[k] - b[k]).abs().max()) <= 1e-6, k
    assert abs(sa - sb) <= 1e-6 * sb


@pytest.mark.parametrize("rank", [32, 64, 128])
def test_step_u_differs_from_per_tile_within_the_staleness_envelope(rank):
    plans, model = sweep_case(rank, 4)
    a, _ = run_port(sgd_sweep_step_u, plans, model, 4, True)
    b, _ = run_port(sgd_sweep_tile, plans, model, 4, True)
    diffs = {k: float((a[k] - b[k]).abs().max()) for k in KEYS}
    # the user side is stale inside a group: a real difference, bounded
    # as the reference bounds it (atol 0.05 at lr 0.05)
    assert max(diffs.values()) > 1e-6
    assert all(d < 0.05 for d in diffs.values()), diffs


def test_step_u_reads_the_item_side_fresh_inside_a_group():
    """Two tiles of one group that hit the same item: the second reads Q
    and bi as the first left them, and P and bu as the group found them."""
    rank, su, si, t = 32, 128, 128, 32
    g = torch.Generator().manual_seed(3)
    P = torch.randn(su, rank, generator=g) * 0.2
    Q = torch.randn(si, rank, generator=g) * 0.2
    bu = torch.randn(su, generator=g) * 0.1
    bi = torch.randn(si, generator=g) * 0.1
    tl = torch.empty(2, 3, t, dtype=torch.int32)
    tl[:, 0], tl[:, 1] = su, si
    tl[:, 2] = 0
    tl[:, 0, 0], tl[:, 1, 0] = 7, 5  # user 7 rates item 5 in both tiles
    tl[:, 2, 0] = torch.tensor([4.0, 2.0]).view(torch.int32)
    sa = torch.zeros(1, dtype=torch.int32)
    tc = torch.zeros(2, dtype=torch.int32)
    mu, lr, reg = 3.0, 0.05, 0.02
    p, q, b_u, b_i = P[7].clone(), Q[5].clone(), bu[7].clone(), bi[5].clone()
    e0 = 4.0 - (p @ q + mu + b_u + b_i)
    q1 = q + lr * (e0 * p - reg * q)
    bi1 = b_i + lr * (e0 - reg * b_i)
    e1 = 2.0 - (p @ q1 + mu + b_u + bi1)
    want_p = p + lr * (e0 * q - reg * p) + lr * (e1 * q1 - reg * p)
    want_bu = b_u + lr * (e0 - reg * b_u) + lr * (e1 - reg * b_u)
    want_q = q1 + lr * (e1 * p - reg * q1)
    sse = sgd_sweep_step_u(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, su=su,
                           si=si, tpg=2)
    torch.testing.assert_close(P[7], want_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(Q[5], want_q, rtol=0, atol=1e-6)
    torch.testing.assert_close(bu[7], want_bu, rtol=0, atol=1e-6)
    torch.testing.assert_close(sse, e0 * e0 + e1 * e1, rtol=1e-6, atol=0)


@pytest.mark.parametrize("rank", [32, 64, 128])
def test_step_u_pads_are_exact_noops(rank):
    plans, model = sweep_case(rank, 4)
    got, _ = run_port(sgd_sweep_step_u, plans, model, 4, True)
    start, _ = run_port(lambda *a, **k: 0.0, plans, model, 4, True)
    tu, ti = touched_rows(plans, 4)
    for k, mask in (("P", tu), ("bu", tu), ("Q", ti), ("bi", ti)):
        assert torch.equal(got[k][~mask], start[k][~mask]), k
        assert not torch.equal(got[k][mask], start[k][mask]), k


def test_step_u_wrapper_is_the_plain_version_on_cpu_tensors():
    plans, model = sweep_case(32, 4)
    a, sa = run_port(sgd_sweep_step_u, plans, model, 4, True)
    b, sb = run_port(sgd_sweep_step_u_plain, plans, model, 4, True)
    assert sa == sb and all(torch.equal(a[k], b[k]) for k in KEYS)


def test_step_u_wrapper_rejects_a_ragged_group():
    rank = 32
    with pytest.raises(ValueError, match="tpg"):
        sgd_sweep_step_u(
            torch.zeros(SU, rank), torch.zeros(SI, rank), torch.zeros(SU),
            torch.zeros(SI), torch.zeros(1, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32),
            torch.zeros(3, 3, T, dtype=torch.int32), LR, REG, 3.5, su=SU,
            si=SI, tpg=2)
