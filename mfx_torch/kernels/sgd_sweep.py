"""Sparse blocked-SGD sweep: wrapper of ``csrc/sgd_sweep.cu`` and its plain
PyTorch version.

Replaces ``mfx/kernels/sgd_pallas.py::_kernel_body`` on the lane-bias path
(``bias_mode='lane'``, rank 64). One call runs one item-sweep: the tiles of
``tl`` in plan order, each a snapshot minibatch (gather, residuals, exact
segment-summed scatter), on the plain ``(rows, rank)`` f32 tables.

On CUDA tensors the wrapper launches the kernel (or raises); on CPU
tensors it runs :func:`sgd_sweep_plain`. Nothing falls back.
"""

from __future__ import annotations

import torch

from mfx_torch.kernels import _build

__all__ = ["sgd_sweep", "sgd_sweep_plain", "check_sweep_args",
           "check_kernel_limits"]

_RANK = 64


def check_sweep_args(who, P, Q, sa, tc, tl, su, si, tpg):
    """The sweep wrappers' common argument check (``who`` names the
    wrapper in the message): devices, dtypes, contiguity, whole blocks,
    and a tile stream that matches ``sa`` / ``tc``."""
    dev = P.device
    for name, x, dt in (("P", P, torch.float32), ("Q", Q, torch.float32),
                        ("sa", sa, torch.int32), ("tc", tc, torch.int32),
                        ("tl", tl, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{who}: {name} is on {x.device}, P on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{who}: {name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if P.dim() != 2 or Q.dim() != 2 or P.shape[1] != Q.shape[1]:
        raise ValueError(f"{who}: bad table shapes {P.shape}, {Q.shape}")
    if P.shape[0] % su or Q.shape[0] % si:
        raise ValueError(f"{who}: tables must be padded to whole blocks")
    if tl.dim() != 3 or tl.shape[1] != 3:
        raise ValueError(f"{who}: tl must be (NT, 3, T), got {tl.shape}")
    nt = tl.shape[0]
    if tc.shape != (nt,) or sa.shape != (nt // tpg,) or nt % tpg:
        raise ValueError(
            f"{who}: tc {tuple(tc.shape)} / sa {tuple(sa.shape)} do not "
            f"match {nt} tiles at tpg={tpg}"
        )


def check_kernel_limits(who, P, tl, su, si):
    """What the sweep kernels are built for: rank 64, T <= 256, blocks
    <= 1024."""
    if P.shape[1] != _RANK:
        raise NotImplementedError(
            f"{who} kernel is built for rank {_RANK}, got {P.shape[1]}"
        )
    if tl.shape[2] > 256 or su > 1024 or si > 1024:
        raise NotImplementedError(
            f"{who} kernel takes tile <= 256 and blocks <= 1024"
        )


def sgd_sweep_plain(P, Q, sa, tc, tl, lr, reg, mu, *, su, si, tpg):
    """Plain PyTorch version: the same sweep, tile by tile. Updates P and
    the item segment Q in place; returns the sweep's SSE (0-d f32)."""
    rank = P.shape[1]
    dev = P.device
    mP = torch.ones(rank, dtype=P.dtype, device=dev)
    mQ = torch.ones(rank, dtype=P.dtype, device=dev)
    mP[rank - 2] = 0.0  # P's constant-1 lane
    mQ[rank - 1] = 0.0  # Q's constant-1 lane
    sa_h = sa.tolist()
    tc_h = tc.tolist()
    sse = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(tl.shape[0]):
        u, i = tl[t, 0].long(), tl[t, 1].long()
        real = u < su
        r = tl[t, 2].view(torch.float32)[real]
        rows_u = sa_h[t // tpg] * su + u[real]
        rows_i = tc_h[t] * si + i[real]
        p, q = P[rows_u], Q[rows_i]  # the tile's snapshot
        e = r - ((p * q).sum(1) + mu)
        dp = lr * (e[:, None] * q - reg * p) * mP
        dq = lr * (e[:, None] * p - reg * q) * mQ
        P.index_put_((rows_u,), dp, accumulate=True)
        Q.index_put_((rows_i,), dq, accumulate=True)
        sse = sse + (e * e).sum()
    return sse


def sgd_sweep(P, Q, sa, tc, tl, lr, reg, mu, *, su, si, tpg):
    """One item-sweep. ``P`` is the padded lane-form user table
    (A·su, rank); ``Q`` the sweep's item segment (nwin·si, rank), a
    contiguous row range of the padded item table; ``sa`` (NT/tpg,) the
    user block of each group of tpg tiles; ``tc`` (NT,) each tile's
    sweep-local window; ``tl`` the (NT, 3, T) tile stream. Updates P and
    Q in place and returns the sweep's SSE as a 0-d f32 tensor."""
    check_sweep_args("sgd_sweep", P, Q, sa, tc, tl, su, si, tpg)
    if P.device.type == "cpu":
        return sgd_sweep_plain(P, Q, sa, tc, tl, lr, reg, mu,
                               su=su, si=si, tpg=tpg)
    if P.device.type != "cuda":
        raise ValueError(f"sgd_sweep: no kernel for device {P.device}")
    check_kernel_limits("sgd_sweep", P, tl, su, si)
    T = tl.shape[2]
    lib = _build.load_library()
    sse = torch.empty(1, dtype=torch.float32, device=P.device)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    _build.check(lib.mfx_sgd_sweep(
        P.data_ptr(), Q.data_ptr(), sa.data_ptr(), tc.data_ptr(),
        tl.data_ptr(), sse.data_ptr(), tl.shape[0], tpg, T, su, si,
        P.shape[1], float(lr), float(reg), float(mu), stream,
    ), "sgd_sweep")
    sgd_sweep.launches += 1
    return sse[0]


sgd_sweep.launches = 0
