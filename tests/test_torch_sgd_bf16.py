"""The sparse sweeps' bf16 form (``sgd.mxu='bf16'``): each plain version
with ``bf16=True`` against the reference Pallas kernel with
``mxu_bf16=True, exact=False`` in interpret mode (``exact`` wins over
``mxu_bf16`` in the reference), in every body the trainer runs (lane,
tile biases, no biases, the step-batched user side, epoch-frozen biases)
at ranks 1 to 128 (the lane form from 2), on the same tile plans and
initial tables; and the kernels' dot order that those plain versions
take."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.kernels import packing as pk
from mfx.kernels.sgd_pallas import blocked_sgd_sweep_pallas
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels import packing as pk_t
from mfx_torch.kernels.sgd_sweep import (bf16_round, kernel_dot, sgd_sweep,
                                         sgd_sweep_epoch, sgd_sweep_plain,
                                         sgd_sweep_step_u, sgd_sweep_tile)
from test_torch_bias_epoch import TILE, TPG
from test_torch_bias_epoch import _case as epoch_case
from test_torch_sgd_sweep_tile import (I, KEYS, LR, REG, SI, SU, U,
                                       sweep_case)

BODIES = ("lane", "tile", "none", "step_u", "epoch")
# Most values agree to f32 noise, but an ulp's difference in a residual
# (the two packages sum the dot in different orders) can move a delta
# across a bf16 rounding boundary, one bf16 ulp of the delta: up to 2.1e-4
# on these tables after a sweep (a bias delta at rank 128, step_u). So:
# each value within 5e-4, 1/40 of the reference's own 0.02 envelope
# (tests/unit/test_pallas_kernel.py), and the mean difference of P and Q
# under 1/20 of the port's f32 form's from the same reference (measured
# ratios 2e-7 .. 7e-3), which shows the rounding is the reference's.
ATOL = 5e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(body, rank, bf16):
    """The reference's sweeps over the body's plans: (tables, sse)."""
    if body == "epoch":
        _, model, (skel_j, (tl, d, u_s, i_s)), _ = epoch_case(rank)
        nt = tl.shape[0]
        bt = jnp.zeros((nt * TILE,), jnp.float32).at[d].set(
            model.bu[u_s] + model.bi[i_s]).reshape(nt, 1, TILE)
        sweeps = [({"sa": p.sa, "tc": p.tc, "tl": tl[p.t0:p.t1],
                    "bt": bt[p.t0:p.t1]}, p.win0, p.nwin)
                  for p in skel_j.sweeps if p.t1 > p.t0]
    else:
        plans, model = sweep_case(rank, TPG)
        sweeps = [(pk.sweep_arrays(p), p.win0, p.nwin) for p in plans]
    lane = body == "lane"
    users, items = model.P.shape[0], model.Q.shape[0]
    Pm, Qm = pk.pack_state(pk.to_lane_model(model) if lane else model, SU,
                           SI)
    sse = 0.0
    for arrs, win0, nwin in sweeps:
        Qs = pk.q_segment(Qm, win0, nwin, rank, SI)
        out = blocked_sgd_sweep_pallas(
            Pm, Qs, arrs, LR, REG, float(model.mu), su=SU, si=SI, rank=rank,
            tpg=TPG, use_bias=body != "none", exact=False, interpret=True,
            mxu_bf16=bf16, step_u=body == "step_u",
            bias_mode={"lane": "lane", "epoch": "epoch"}.get(body, "tile"))
        Pm, Qs, s = out[0], out[1], out[-1]
        Qm = pk.q_segment_restore(Qm, Qs, win0, rank, SI)
        sse += float(s[0, 0])
    got = pk.unpack_state(Pm, Qm, model.mu, users, items, rank, SU, SI)
    if lane:
        got = pk.from_lane_model(got)
    return {k: np.asarray(getattr(got, k)) for k in KEYS}, sse


def _port(body, rank, bf16):
    """The port's wrapper of the body (its plain version on the CPU) over
    the same plans: (tables cut to the real rows, sse)."""
    if body == "epoch":
        _, model, _, (skel, (tl, _, _, _)) = epoch_case(rank)
        sweeps = [(s.sa, s.tc, tl[s.t0:s.t1], s.win0, s.nwin)
                  for s in skel.sweeps if s.t1 > s.t0]
    else:
        plans, model = sweep_case(rank, TPG)
        sweeps = [(torch.as_tensor(p.sa), torch.as_tensor(p.tc),
                   torch.as_tensor(p.tl), p.win0, p.nwin) for p in plans]
    users, items = model.P.shape[0], model.Q.shape[0]
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in KEYS + ("mu",)}, device="cpu")
    mu, kw = float(model.mu), dict(su=SU, si=SI, tpg=TPG, bf16=bf16)
    sse = 0.0
    if body == "lane":
        P, Q = pk_t.lane_tables(tm, SU, SI, "cpu")
        for sa, tc, tl, win0, nwin in sweeps:
            sse += float(sgd_sweep(P, Q[win0 * SI:(win0 + nwin) * SI], sa,
                                   tc, tl, LR, REG, mu, **kw))
        out = pk_t.from_lane_model(model_from_numpy(
            {"P": P[:users].numpy(), "Q": Q[:items].numpy(),
             "bu": np.zeros(users), "bi": np.zeros(items), "mu": mu},
            device="cpu"))
        return {k: getattr(out, k) for k in KEYS}, sse
    P, Q, bu, bi = pk_t.plain_tables(tm, SU, SI, "cpu")
    for sa, tc, tl, win0, nwin in sweeps:
        seg = slice(win0 * SI, (win0 + nwin) * SI)
        args = (P, Q[seg], bu, bi[seg], sa, tc, tl)
        if body == "epoch":
            e = torch.zeros(tl.shape[0], tl.shape[2])
            s = sgd_sweep_epoch(*args, e, LR, REG, mu, **kw)
        else:
            fn = sgd_sweep_step_u if body == "step_u" else sgd_sweep_tile
            s = fn(*args, LR, REG, mu, use_bias=body != "none", **kw)
        sse += float(s)
    return {"P": P[:users], "Q": Q[:items], "bu": bu[:users],
            "bi": bi[:items]}, sse


@pytest.mark.parametrize("body,rank", [
    # ranks from 1 up: the reference's interpret mode compiles longest at
    # rank 1 (128 slots a lane row), and a run spread over workers ends
    # sooner when its longest cases start first
    (body, rank) for rank in (1, 2, 4, 8, 16, 32, 64, 128) for body in BODIES
    if body != "lane" or rank > 1])  # no lane model at rank 1
def test_bf16_sweep_matches_pallas_interpret(body, rank):
    """Tables within ATOL of the reference's bf16 form, their mean
    difference under 1/20 of the f32 form's (module note), the SSE within
    1e-5 relative. The mean difference is taken over the trained factor
    tables P and Q; the lane form at rank 2 has no latent lane (P rows
    ``[1, bu]``, Q rows ``[bi, 1]``), so there it is taken over the
    biases its two lanes train."""
    ref, sse_j = _reference(body, rank, True)
    got, sse_t = _port(body, rank, True)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j
    f32, _ = _port(body, rank, False)
    trained = ("bu", "bi") if (body, rank) == ("lane", 2) else ("P", "Q")

    def mean_diff(tabs):
        return np.mean([np.abs(tabs[k].numpy() - ref[k]).mean()
                        for k in trained])

    assert mean_diff(got) < mean_diff(f32) / 20
    if body in ("none", "epoch"):  # no bias vector is written
        for k in ("bu", "bi"):
            assert torch.equal(got[k], f32[k]), k


def _dot_part_and_butterfly(p, q):
    """The sweep kernels' dot of one row pair as csrc/sweep_common.cuh
    takes it, written out thread by thread: 8 threads, thread k an fma
    chain (exact product, one rounding) over float4 k, k + 8, ... of the
    row, which is empty and stays 0 past the row's float4 (below rank 4
    the row is one float4 whose lanes past the rank hold 0); then the
    butterfly (xor 4, 2, 1) read on thread 0."""
    f32 = np.float32
    q4 = -(-len(p) // 4)
    pad = 4 * q4 - len(p)
    p, q = np.pad(p, (0, pad)), np.pad(q, (0, pad))
    chains = []
    for k in range(8):
        acc = f32(0)
        for kk in range(k, q4, 8):
            for c in range(4):
                acc = f32(np.float64(p[4 * kk + c]) * np.float64(q[4 * kk + c])
                          + np.float64(acc))
        chains.append(acc)
    for mask in (4, 2, 1):
        chains = [f32(chains[k] + chains[k ^ mask]) for k in range(8)]
    return chains[0]


@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64, 128, 2, 1])
def test_kernel_dot_is_the_kernels_order_at_every_rank(rank):
    """kernel_dot at every rank the sweep kernels take against the
    kernels' own order written out thread by thread; below rank 32 the
    threads past the row's float4 add zeros."""
    g = torch.Generator().manual_seed(rank)
    p = torch.randn(6, rank, generator=g)
    q = torch.randn(6, rank, generator=g)
    want = torch.tensor([_dot_part_and_butterfly(a.numpy(), b.numpy())
                         for a, b in zip(p, q)])
    assert torch.equal(kernel_dot(p, q), want)


def test_bf16_round_is_round_to_nearest_even():
    x = torch.tensor([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -9,
                      -(1.0 + 2 ** -8), 3.14159, 0.0])
    want = torch.tensor([1.0, 1.0, 1.0 + 2 ** -6, 1.0, -1.0, 3.140625, 0.0])
    assert torch.equal(bf16_round(x), want)
    assert bf16_round(x, False) is x


def test_bf16_time_form_is_refused():
    """The reference's time form takes no ``mxu`` (its blocked timeSVD
    passes none): the plain version refuses the combination."""
    P, Q = torch.zeros(SU, 64), torch.zeros(SI, 64)
    tl = torch.full((TPG, 5, 8), SU, dtype=torch.int32)
    with pytest.raises(ValueError, match="time form"):
        sgd_sweep_plain(P, Q, torch.zeros(1, dtype=torch.int32),
                        torch.zeros(TPG, dtype=torch.int32), tl, LR, REG,
                        3.5, su=SU, si=SI, tpg=TPG, n_bins=4, bf16=True)


def test_bf16_pads_and_frozen_lanes_stay_exact():
    """The lane form in bf16: the constant-1 lanes and every row no real
    slot addresses keep their bits."""
    plans, model = sweep_case(64, TPG)
    tm = model_from_numpy({k: np.asarray(getattr(model, k))
                           for k in KEYS + ("mu",)}, device="cpu")
    P, Q = pk_t.lane_tables(tm, SU, SI, "cpu")
    P0, Q0 = P.clone(), Q.clone()
    for p in plans:
        sgd_sweep(P, Q[p.win0 * SI:(p.win0 + p.nwin) * SI],
                  torch.as_tensor(p.sa), torch.as_tensor(p.tc),
                  torch.as_tensor(p.tl), LR, REG, float(model.mu), su=SU,
                  si=SI, tpg=TPG, bf16=True)
    assert torch.equal(P[:, 62], P0[:, 62]) and torch.equal(Q[:, 63], Q0[:, 63])
    assert torch.equal(P[U:], P0[U:]) and torch.equal(Q[I:], Q0[I:])
    assert not torch.equal(P[:U], P0[:U])
