"""Fused BPR sweep: wrapper of ``csrc/bpr_sweep.cu`` and its plain PyTorch
version.

Replaces ``mfx/kernels/bpr_pallas.py::_kernel_body`` (driven by
``bpr_sweep_pallas`` / ``_chunk_call``), at the ranks of
``kernels.sgd_sweep.SWEEP_RANKS`` (1 to 128). One call
runs one whole segment of the ring: the tiles of ``tl``, each a snapshot
minibatch of T (user, positive, negative) triples of one stratum, on the
plain ``(rows, rank)`` f32 tables, with the result of walking them in
plan order. Given the plan's dependency table the kernel walks the
segment's user-block runs on many SMs and gives the same bits. The
reference chunks the stream only to bound the TPU's scalar-prefetch
memory; here one launch takes it all.

On CUDA tensors the wrapper launches the kernel (or raises); on CPU
tensors it runs :func:`bpr_sweep_plain`. Nothing falls back.
"""

from __future__ import annotations

import torch

from mfx_torch.kernels import _build
from mfx_torch.kernels.sgd_sweep import (check_kernel_limits,
                                         check_sweep_args, wavefront_launch)
from mfx_torch.solvers.bpr import bpr_minibatch_update

__all__ = ["bpr_sweep", "bpr_sweep_plain"]


def bpr_sweep_plain(P, Q, sa, tc, tl, lr, reg, *, su, si, tpg):
    """Plain PyTorch version: the same sweep, each tile one
    :func:`mfx_torch.solvers.bpr.bpr_minibatch_update` on its real slots.
    Updates P and the segment Q in place; returns the loss sum (0-d f32)."""
    sa_h = sa.tolist()
    tc_h = tc.tolist()
    loss = torch.zeros((), dtype=torch.float32, device=P.device)
    for t in range(tl.shape[0]):
        u, i, j = tl[t, 0].long(), tl[t, 1].long(), tl[t, 2].long()
        real = u < su
        rows_u = sa_h[t // tpg] * su + u[real]
        qbase = tc_h[t] * si
        w = torch.ones(rows_u.shape, dtype=P.dtype, device=P.device)
        loss = loss + bpr_minibatch_update(
            P, Q, rows_u, qbase + i[real], qbase + j[real], w, lr, reg)
    return loss


def bpr_sweep(P, Q, sa, tc, tl, lr, reg, *, su, si, tpg, deps=None,
              blocks=None):
    """One segment of fused BPR. ``P`` is the padded user table
    (A·su, rank); ``Q`` the segment's item rows (nwin·si, rank), a
    contiguous row range of the padded item table; ``sa`` (NT/tpg,) the
    user block of each group of tpg tiles; ``tc`` (NT,) each tile's
    segment-local window; ``tl`` the (NT, 3, T) stream of block-local user,
    window-local positive and window-local negative ids (pad slots hold
    ``u = su``, ``i = j = si``). Updates P and Q in place and returns the
    loss sum over real slots as a 0-d f32 tensor. ``deps`` (the cell's
    ``RingSegmentSlice.deps[t][s]``) and ``blocks`` as in
    :func:`mfx_torch.kernels.sgd_sweep.sgd_sweep`."""
    check_sweep_args("bpr_sweep", P, Q, sa, tc, tl, su, si, tpg)
    if P.device.type == "cpu":
        return bpr_sweep_plain(P, Q, sa, tc, tl, lr, reg,
                               su=su, si=si, tpg=tpg)
    if P.device.type != "cuda":
        raise ValueError(f"bpr_sweep: no kernel for device {P.device}")
    check_kernel_limits("bpr_sweep", P, tl, su, si)
    nt, T = tl.shape[0], tl.shape[2]
    lib = _build.load_library()
    runs, wait, state, sums, grid = wavefront_launch(
        "bpr_sweep", lib, deps, nt, T, P.device, blocks,
        sizing=(P.shape[1],))
    loss = torch.empty(1, dtype=torch.float32, device=P.device)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    _build.check(lib.mfx_bpr_sweep(
        P.data_ptr(), Q.data_ptr(), sa.data_ptr(), tc.data_ptr(),
        tl.data_ptr(), runs.data_ptr(),
        None if wait is None else wait.data_ptr(), state.data_ptr(),
        sums.data_ptr(), loss.data_ptr(), nt, runs.shape[0], grid, tpg, T,
        su, si, P.shape[1], float(lr), float(reg), stream,
    ), "bpr_sweep")
    bpr_sweep.launches += 1
    return loss[0]


bpr_sweep.launches = 0
