"""Dense-stratum SGD phase: wrapper of ``csrc/dense_phase.cu`` and its
plain PyTorch version.

Replaces ``mfx/kernels/dense_pallas.py::_kernel_body`` on the lane-bias
int4 path (``lane=True``, ``rfmt='int4'``, echo 1, spg 1; the int8 codes
are ROADMAP Queue 2 item 3). One call runs one dense group: its strata in
order, each a snapshot minibatch

    S = P_blk Q_winᵀ,  E = [R > 0] ∘ (R − S − μ)
    P_blk += lr·s_u ∘ (E Q_win − reg·Du ∘ P_blk)    (lane rank-2 frozen)
    Q_win += lr·s_i ∘ (Eᵀ P_blk − reg·Di ∘ Q_win)   (lane rank-1 frozen)

with s = min(1, DSTAR / max(deg, 1)) over the per-stratum degrees.

On CUDA tensors the wrapper launches the kernel (or raises); on CPU
tensors it runs :func:`dense_phase_plain`. Nothing falls back.
"""

from __future__ import annotations

import torch

from mfx_torch.kernels import _build

__all__ = ["dense_phase", "dense_phase_plain", "decode_codes", "DSTAR",
           "R_SCALE", "R4_SCALE"]

# the reference's rating codes (mfx/kernels/dense_pallas.py): int8 holds
# round(r * R_SCALE), int4 round(r * R4_SCALE); 0 = absent
R_SCALE = 25.0
R4_SCALE = 2.0
# per-row trust scaling of a whole-stratum batch step (the reference's)
DSTAR = 16.0

_RANK = 64


def decode_codes(R: torch.Tensor, rfmt: str) -> torch.Tensor:
    """One stratum's R image -> (su, si) integer codes (int32)."""
    if rfmt == "int8":
        return R.to(torch.int32)
    # int4: (su, si/2) bytes, even column in the low nibble
    b = R.to(torch.int32)
    return torch.stack([b & 15, b >> 4], dim=-1).reshape(R.shape[0], -1)


def _validate(P, Q, grp, su, si):
    dev = P.device
    nd = grp["sa"].shape[0]
    spec = {
        "P": (P, torch.float32, None), "Q": (Q, torch.float32, None),
        "sa": (grp["sa"], torch.int32, (nd,)),
        "sc": (grp["sc"], torch.int32, (nd,)),
        "R": (grp["R"], torch.uint8, (nd, su, si // 2)),
        "du_s": (grp["du_s"], torch.float32, (nd, su)),
        "di_s": (grp["di_s"], torch.float32, (nd, si)),
    }
    for name, (x, dt, shape) in spec.items():
        if x.device != dev:
            raise ValueError(f"dense_phase: {name} is on {x.device}, P on {dev}")
        if x.dtype != dt:
            raise TypeError(f"dense_phase: {name} must be {dt}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(
                f"dense_phase: {name} must be {shape}, got {tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"dense_phase: {name} must be contiguous")
    if P.shape[0] % su or Q.shape[0] % si or P.shape[1] != Q.shape[1]:
        raise ValueError("dense_phase: tables must be padded to whole blocks")


def dense_phase_plain(P, Q, grp, lr, reg, mu, *, su, si):
    """Plain PyTorch version: the same strata, one by one. Updates P and
    the group's item segment Q in place; returns the phase's SSE."""
    rank = P.shape[1]
    dev = P.device
    mP = torch.ones(rank, dtype=P.dtype, device=dev)
    mQ = torch.ones(rank, dtype=P.dtype, device=dev)
    mP[rank - 2] = 0.0
    mQ[rank - 1] = 0.0
    sse = torch.zeros((), dtype=torch.float32, device=dev)
    for s, (a, c) in enumerate(zip(grp["sa"].tolist(), grp["sc"].tolist())):
        Pb = P[a * su:(a + 1) * su]
        Qw = Q[c * si:(c + 1) * si]
        code = decode_codes(grp["R"][s], "int4")
        S = Pb @ Qw.T
        E = torch.where(code > 0, (code.to(torch.float32) / R4_SCALE - S) - mu,
                        torch.zeros((), dtype=torch.float32, device=dev))
        sse = sse + (E * E).sum()
        du = grp["du_s"][s][:, None]
        di = grp["di_s"][s][:, None]
        s_u = torch.clamp(DSTAR / torch.clamp(du, min=1.0), max=1.0)
        s_i = torch.clamp(DSTAR / torch.clamp(di, min=1.0), max=1.0)
        newP = Pb + lr * s_u * ((E @ Qw - reg * du * Pb) * mP)
        newQ = Qw + lr * s_i * ((E.T @ Pb - reg * di * Qw) * mQ)
        Pb.copy_(newP)
        Qw.copy_(newQ)
    return sse


def dense_phase(P, Q, grp, lr, reg, mu, *, su, si):
    """One dense group. ``P`` is the padded lane-form user table; ``Q`` the
    group's item segment (a contiguous row range of the padded item
    table); ``grp`` holds ``sa``/``sc`` (ND,) int32 (``sc`` window-local),
    ``R`` the int4 codes (ND, su, si/2) uint8 and the per-stratum degrees
    ``du_s`` (ND, su), ``di_s`` (ND, si).
    Updates P and Q in place; returns the phase's SSE (0-d f32)."""
    _validate(P, Q, grp, su, si)
    if P.device.type == "cpu":
        return dense_phase_plain(P, Q, grp, lr, reg, mu, su=su, si=si)
    if P.device.type != "cuda":
        raise ValueError(f"dense_phase: no kernel for device {P.device}")
    if P.shape[1] != _RANK or su % 64 or si % 64:
        raise NotImplementedError(
            "dense_phase kernel is built for rank 64 and blocks that are "
            f"multiples of 64 (got rank {P.shape[1]}, su={su}, si={si}); "
            "see ROADMAP Queue 2"
        )
    nd = grp["sa"].shape[0]
    dev = P.device
    f32 = torch.float32
    dP_part = torch.empty((si // 64, su, _RANK), dtype=f32, device=dev)
    dQ_part = torch.empty((su // 64, si, _RANK), dtype=f32, device=dev)
    sse_part = torch.empty((su // 64) * (si // 64), dtype=f32, device=dev)
    sse = torch.zeros(1, dtype=f32, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.mfx_dense_phase(
        P.data_ptr(), Q.data_ptr(), grp["sa"].data_ptr(),
        grp["sc"].data_ptr(), grp["R"].data_ptr(), grp["du_s"].data_ptr(),
        grp["di_s"].data_ptr(), dP_part.data_ptr(), dQ_part.data_ptr(),
        sse_part.data_ptr(), sse.data_ptr(), nd, su, si, _RANK,
        float(lr), float(reg), float(mu), stream,
    ), "dense_phase")
    dense_phase.launches += 1
    return sse[0]


dense_phase.launches = 0
