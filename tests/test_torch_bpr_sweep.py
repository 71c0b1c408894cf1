"""The fused BPR sweep's plain version against the reference's Pallas
kernel (``bpr_sweep_pallas``, exact f32, interpret mode) on a tile stream
from the reference's ring planner, segment by segment; and the wrapper's
validation and CPU routing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import synthetic
from mfx.kernels import packing as pk
from mfx.kernels import plan_ring_device as prd_j
from mfx.kernels.bpr_pallas import bpr_sweep_pallas
from mfx.models import init_model
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels.bpr_sweep import bpr_sweep, bpr_sweep_plain
from mfx_torch.kernels.packing import pad_rows

U, I = 300, 250
SU = SI = 128
T, TPG, RANK = 64, 4, 64
LR, REG = 0.05, 0.01
UB, IB = 384, 256  # whole blocks: 3 user blocks, 2 windows (last partial)


def _stream(n=2_500):
    """Two one-window segments of a one-shard ring plan, with negatives
    drawn inside each positive's (possibly partial) window."""
    coo = synthetic.make_implicit_synthetic(U, I, n, rank=4, seed=2)
    rng = np.random.default_rng(0)
    span = np.minimum(SI, I - (coo.item // SI) * SI)
    j_neg = (rng.random(coo.n_ratings) * span).astype(np.int32)
    u, ir = jnp.asarray(coo.user), jnp.asarray(coo.item)
    skel = prd_j.build_ring_skeleton(u, ir, 1, UB, IB, SU, SI, T, TPG, 1)
    slabs = prd_j.epoch_tiles_ring(skel, u, ir, None, 0, 0,
                                   payload2=jnp.asarray(j_neg), sent2=SI)
    assert len(slabs) == 2
    return [(seg.win0, seg.nwin, np.array(seg.sa[0, 0]),
             np.array(seg.tc[0, 0]), np.array(slab[0, 0]))
            for seg, slab in zip(skel.segments, slabs)]


def _hold_plain_to_the_pallas_kernel(rank, n):
    """Both packages' sweeps over the two segments of ``_stream(n)`` from
    the same tables: tables within 2e-6 (+ 1e-5 relative), losses within
    1e-4 relative."""
    segs = _stream(n)
    m0 = init_model(3, U, I, rank, global_mean=0.0)
    Pm, Qm = pk.pack_state(m0, SU, SI)
    want_loss = []
    for win0, nw, sa, tc, tl in segs:
        Qs = pk.q_segment(Qm, win0, nw, rank, SI)
        Pm, Qs, loss = bpr_sweep_pallas(
            Pm, Qs, {"sa": jnp.asarray(sa), "tc": jnp.asarray(tc),
                     "tl": jnp.asarray(tl)},
            LR, REG, su=SU, si=SI, rank=rank, tpg=TPG, exact=True,
            interpret=True)
        Qm = pk.q_segment_restore(Qm, Qs, win0, rank, SI)
        want_loss.append(float(loss[0, 0]))
    want = pk.unpack_state(Pm, Qm, 0.0, U, I, rank, SU, SI)

    m = model_from_numpy({k: np.asarray(getattr(m0, k))
                          for k in ("P", "Q", "bu", "bi", "mu")}, device="cpu")
    P, Q = pad_rows(m.P, UB), pad_rows(m.Q, IB)
    got_loss = []
    for win0, nw, sa, tc, tl in segs:
        got_loss.append(float(bpr_sweep_plain(
            P, Q[win0 * SI:(win0 + nw) * SI], torch.as_tensor(sa),
            torch.as_tensor(tc), torch.as_tensor(tl), LR, REG, su=SU, si=SI,
            tpg=TPG)))
    np.testing.assert_allclose(P[:U].numpy(), np.asarray(want.P), atol=2e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(Q[:I].numpy(), np.asarray(want.Q), atol=2e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    assert not torch.equal(P[:U], m.P)
    assert float(Q[I:].abs().max()) == 0.0  # pad rows untouched


def test_plain_matches_the_pallas_kernel():
    _hold_plain_to_the_pallas_kernel(RANK, 2_500)


# ranks from 1 up: the reference's interpret mode compiles longest at rank
# 1, and a run spread over workers ends sooner when its longest cases
# start first
@pytest.mark.parametrize("rank", [1, 2, 4, 8, 16, 32, 128])
def test_plain_matches_the_pallas_kernel_at_other_ranks(rank):
    """The kernel's other forms: pack 4 and pack 1 in the reference. Rank
    128 on 1,000 triples, as the reference's own test keeps its interpret
    mode cheap (tests/unit/test_bpr_pallas.py)."""
    _hold_plain_to_the_pallas_kernel(rank, 1_000 if rank == 128 else 2_500)


def _args(nt=8):
    g = torch.Generator().manual_seed(0)
    P = torch.randn(2 * SU, RANK, generator=g) * 0.1
    Q = torch.randn(2 * SI, RANK, generator=g) * 0.1
    sa = torch.randint(0, 2, (nt // TPG,), generator=g, dtype=torch.int32)
    tc = torch.randint(0, 2, (nt,), generator=g, dtype=torch.int32)
    tl = torch.randint(0, 8, (nt, 3, T), generator=g, dtype=torch.int32)
    tl[-1, 0, T // 2:] = SU  # half a pad tile
    tl[-1, 1:, T // 2:] = SI
    return P, Q, sa, tc, tl


def test_cpu_tensors_run_the_plain_version():
    P, Q, sa, tc, tl = _args()
    P2, Q2 = P.clone(), Q.clone()
    before = bpr_sweep.launches
    loss = bpr_sweep(P, Q, sa, tc, tl, LR, REG, su=SU, si=SI, tpg=TPG)
    assert bpr_sweep.launches == before
    want = bpr_sweep_plain(P2, Q2, sa, tc, tl, LR, REG, su=SU, si=SI, tpg=TPG)
    assert loss.dim() == 0 and loss.dtype == torch.float32
    assert float(loss) == float(want) > 0
    assert torch.equal(P, P2) and torch.equal(Q, Q2)


@pytest.mark.parametrize("bad,exc", [
    ("tl_dtype", TypeError), ("tc_len", ValueError), ("sa_len", ValueError),
    ("unpadded", ValueError), ("ranks", ValueError), ("tl_shape", ValueError),
    ("noncontig", ValueError),
])
def test_wrapper_validation(bad, exc):
    P, Q, sa, tc, tl = _args()
    if bad == "tl_dtype":
        tl = tl.long()
    elif bad == "tc_len":
        tc = tc[:-1]
    elif bad == "sa_len":
        sa = torch.cat([sa, sa])
    elif bad == "unpadded":
        Q = Q[:-1]
    elif bad == "ranks":
        Q = Q[:, :16].contiguous()
    elif bad == "tl_shape":
        tl = tl[:, :2].contiguous()
    else:
        P = P.t().contiguous().t()
    with pytest.raises(exc):
        bpr_sweep(P, Q, sa, tc, tl, LR, REG, su=SU, si=SI, tpg=TPG)


@pytest.fixture
def four_threads():
    """Several intra-op threads, whatever the process was set to: a
    scatter-add that splits its slots between threads must have them to
    show an order that changes from run to run."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def test_plain_repeats_bitwise_with_many_duplicate_rows(four_threads):
    """Two CPU runs of the plain version at T = 256 where every slot
    repeats one of 8 rows per side give the same bits: every duplicate
    row's deltas are added in slot order (``packing.row_add``), not by
    several threads in an order that changes from run to run."""
    g = torch.Generator().manual_seed(1)
    nt, tile = 64, 256
    P0 = torch.randn(2 * SU, RANK, generator=g) * 0.1
    Q0 = torch.randn(2 * SI, RANK, generator=g) * 0.1
    sa = torch.randint(0, 2, (nt // TPG,), generator=g, dtype=torch.int32)
    tc = torch.randint(0, 2, (nt,), generator=g, dtype=torch.int32)
    tl = torch.randint(0, 8, (nt, 3, tile), generator=g, dtype=torch.int32)
    runs = []
    for _ in range(4):
        P, Q = P0.clone(), Q0.clone()
        loss = bpr_sweep_plain(P, Q, sa, tc, tl, LR, REG, su=SU, si=SI,
                               tpg=TPG)
        runs.append((P, Q, float(loss)))
    for P, Q, loss in runs[1:]:
        assert torch.equal(P, runs[0][0]) and torch.equal(Q, runs[0][1])
        assert loss == runs[0][2]
    assert not torch.equal(runs[0][0], P0)


@pytest.mark.parametrize("slots", [1024, 4096])
def test_minibatch_update_repeats_bitwise(slots, four_threads):
    """The plain version's tile step at more slots than a tile holds, where
    ``index_put_(accumulate=True)`` on the CPU splits the slots between
    threads: ``bpr_apply_deltas`` still gives the same bits every run."""
    from mfx_torch.solvers.bpr import bpr_minibatch_update

    g = torch.Generator().manual_seed(slots)
    P0 = torch.randn(16, RANK, generator=g) * 0.1
    Q0 = torch.randn(16, RANK, generator=g) * 0.1
    u, i, j = (torch.randint(0, 8, (slots,), generator=g) for _ in range(3))
    w = torch.ones(slots)
    runs = []
    for _ in range(6):
        P, Q = P0.clone(), Q0.clone()
        loss = bpr_minibatch_update(P, Q, u, i, j, w, LR, REG)
        runs.append((P, Q, float(loss)))
    for P, Q, loss in runs[1:]:
        assert torch.equal(P, runs[0][0]) and torch.equal(Q, runs[0][1])
        assert loss == runs[0][2]
