"""The port's sparse sweep (plain version of the sgd_sweep kernel) against
the reference Pallas kernel in interpret mode, on the same tile stream
and the same initial tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfx.data import synthetic, train_test_split
from mfx.kernels import packing as pk
from mfx.kernels import plan_device as pdv_j
from mfx.kernels.sgd_pallas import blocked_sgd_sweep_pallas
from mfx.models import init_model
from mfx.models.mf import MFModel as JMFModel
from mfx.solvers.blocked import sweep_geometry as sweep_geometry_j
from mfx_torch.convert import model_from_numpy
from mfx_torch.kernels import packing as pk_t
from mfx_torch.kernels.sgd_sweep import sgd_sweep, sgd_sweep_plain
from mfx_torch.solvers.blocked import sweep_geometry

U = I = 600
SU = SI = 256
T, TPG, RANK = 64, 4, 64
LR, REG = 0.012, 0.04
# rank 128 (pack 1, the netflix100m_rank128_dp geometry) at the shapes of
# tests/unit/test_pallas_kernel.py::test_pallas_rank128_pack1_interpret
GEOM = {64: dict(users=U, items=I, n=6000, su=SU, tile=T, seed=9, lr=LR,
                 reg=REG, atol=1e-5),
        128: dict(users=300, items=260, n=3000, su=128, tile=32, seed=5,
                  lr=0.05, reg=0.02, atol=2e-6)}


def _setup(n=6000, seed=0, epoch=0, rank=RANK):
    g = GEOM[rank]
    users, items, su = g["users"], g["items"], g["su"]
    n = n if rank == RANK else g["n"]
    coo = synthetic.make_synthetic(users, items, n, rank=4, noise=0.3,
                                   seed=g["seed"], star_step=0.5)
    nwin = sweep_geometry_j(items, rank, su)
    u, i, r = (jnp.asarray(coo.user), jnp.asarray(coo.item),
               jnp.asarray(coo.rating))
    skel = pdv_j.build_plan_skeleton(u, i, users, items, su, su, g["tile"],
                                     TPG, nwin)
    tl = pdv_j.epoch_tiles_device(skel, u, i, r, seed, epoch)
    rng = np.random.default_rng(4)
    m = init_model(3, users, items, rank, global_mean=coo.global_mean)
    model = JMFModel(
        P=m.P, Q=m.Q,
        bu=jnp.asarray(rng.normal(0, 0.1, users), jnp.float32),
        bi=jnp.asarray(rng.normal(0, 0.1, items), jnp.float32), mu=m.mu,
    )
    return coo, skel, np.array(tl), model


def _numpy(m):
    return {k: np.asarray(getattr(m, k)) for k in ("P", "Q", "bu", "bi", "mu")}


def test_sweep_geometry_matches_reference():
    for items, si in ((600, 256), (59047, 1024), (3000, 128)):
        assert sweep_geometry(items, RANK, si) == sweep_geometry_j(items, RANK, si)
    for items, si in ((17770, 512), (260, 128)):
        assert sweep_geometry(items, 128, si) == sweep_geometry_j(items, 128, si)
    assert sweep_geometry(17770, 128, 512) == 35  # the netflix preset


@pytest.mark.parametrize("rank", [64, 128])
def test_plain_sweep_matches_pallas_interpret(rank):
    g = GEOM[rank]
    users, items, su, lr, reg = (g["users"], g["items"], g["su"], g["lr"],
                                 g["reg"])
    coo, skel, tl, model = _setup(rank=rank)
    mu = float(model.mu)
    lane = pk.to_lane_model(model)
    Pm, Qm = pk.pack_state(lane, su, su)
    sse_j = 0.0
    for sw in skel.sweeps:
        Qs = pk.q_segment(Qm, sw.win0, sw.nwin, rank, su)
        Pm, Qs, s = blocked_sgd_sweep_pallas(
            Pm, Qs, {"sa": sw.sa, "tc": sw.tc, "tl": jnp.asarray(tl[sw.t0:sw.t1])},
            lr, reg, mu, su=su, si=su, rank=rank, tpg=TPG, use_bias=True,
            exact=True, interpret=True, bias_mode="lane", pack_path="roll",
        )
        Qm = pk.q_segment_restore(Qm, Qs, sw.win0, rank, su)
        sse_j += float(s[0, 0])
    ref = pk.from_lane_model(pk.unpack_state(Pm, Qm, model.mu, users, items,
                                             rank, su, su))

    tm = model_from_numpy(_numpy(model), device="cpu")
    P, Q = pk_t.lane_tables(tm, su, su, "cpu")
    tl_t = torch.as_tensor(tl)
    sse_t = 0.0
    for sw in skel.sweeps:
        sse_t += float(sgd_sweep(
            P, Q[sw.win0 * su:(sw.win0 + sw.nwin) * su],
            torch.as_tensor(np.asarray(sw.sa)), torch.as_tensor(np.asarray(sw.tc)),
            tl_t[sw.t0:sw.t1], lr, reg, mu, su=su, si=su, tpg=TPG,
        ))
    got = pk_t.from_lane_model(model_from_numpy(
        {"P": P[:users].numpy(), "Q": Q[:items].numpy(),
         "bu": np.zeros(users), "bi": np.zeros(items), "mu": mu}, device="cpu"))
    # rank 64: the TPU path sums 128 lanes (two rank-64 slots) where the
    # port sums 64, and the segment sums associate differently: f32 noise
    # only; rank 128 (one slot a lane row) within the reference kernel
    # test's own 2e-6
    for k in ("P", "Q", "bu", "bi"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=g["atol"], err_msg=k)
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j


def test_plain_sweep_freezes_constant_lanes_and_skips_pads():
    coo, skel, tl, model = _setup(n=3000)
    tm = model_from_numpy(_numpy(model), device="cpu")
    P, Q = pk_t.lane_tables(tm, SU, SI, "cpu")
    P0, Q0 = P.clone(), Q.clone()
    sw = skel.sweeps[0]
    sse = sgd_sweep_plain(
        P, Q[sw.win0 * SI:(sw.win0 + sw.nwin) * SI],
        torch.as_tensor(np.asarray(sw.sa)), torch.as_tensor(np.asarray(sw.tc)),
        torch.as_tensor(tl[sw.t0:sw.t1]), LR, REG, float(model.mu),
        su=SU, si=SI, tpg=TPG,
    )
    assert float(sse) > 0
    torch.testing.assert_close(P[:, RANK - 2], P0[:, RANK - 2], rtol=0, atol=0)
    torch.testing.assert_close(Q[:, RANK - 1], Q0[:, RANK - 1], rtol=0, atol=0)
    # pad rows (beyond the real users/items) never move
    torch.testing.assert_close(P[U:], P0[U:], rtol=0, atol=0)
    torch.testing.assert_close(Q[I:], Q0[I:], rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_sweep_wrapper_rejects_bad_inputs(bad):
    P = torch.zeros(SU, RANK)
    Q = torch.zeros(SI, RANK)
    sa = torch.zeros(1, dtype=torch.int32)
    tc = torch.zeros(TPG, dtype=torch.int32)
    tl = torch.zeros(TPG, 3, T, dtype=torch.int32)
    if bad == "dtype":
        tl = tl.float()
    elif bad == "shape":
        tc = torch.zeros(TPG + 1, dtype=torch.int32)
    else:
        P, Q, sa, tc, tl = (x.to("meta") for x in (P, Q, sa, tc, tl))
    with pytest.raises((TypeError, ValueError)):
        sgd_sweep(P, Q, sa, tc, tl, LR, REG, 3.5, su=SU, si=SI, tpg=TPG)
