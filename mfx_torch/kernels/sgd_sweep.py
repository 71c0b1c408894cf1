"""Sparse blocked-SGD sweeps: wrappers of ``csrc/sgd_sweep.cu``,
``csrc/sgd_sweep_tile.cu`` and ``csrc/sgd_sweep_step_u.cu``, each with its
plain PyTorch version.

They replace the two bodies of ``mfx/kernels/sgd_pallas.py``'s sweep call:

- :func:`sgd_sweep`: ``_kernel_body`` with ``bias_mode='lane'`` (ranks 64
  and 128; the biases ride in two factor lanes that the update freezes);
- :func:`sgd_sweep_tile`: ``_kernel_body`` with ``bias_mode='tile'`` or
  with no biases (ranks 32 and 64; ``bu`` / ``bi`` are vectors beside the
  tables and every lane updates);
- :func:`sgd_sweep_step_u`: ``_kernel_body_step_u``
  (``sgd.step_user_batch``): the same, with the user side batched over
  each group of ``tpg`` tiles.

One call runs one item-sweep: the tiles of ``tl``, each a snapshot
minibatch (gather, residuals, exact segment-summed scatter), on plain
``(rows, rank)`` f32 tables updated in place. The result is that of
walking the tiles in plan order. Every wrapper here (and
``kernels.bpr_sweep``), given the plan's dependency table
(``plan_device.SweepDeps``), walks them on as many SMs as the table
allows and gives the same bits.

On CUDA tensors a wrapper launches its kernel (or raises); on CPU tensors
it runs its plain version. Nothing falls back.
"""

from __future__ import annotations

import torch

from mfx_torch.kernels import _build
from mfx_torch.kernels.packing import row_add

__all__ = ["sgd_sweep", "sgd_sweep_plain", "sgd_sweep_tile",
           "sgd_sweep_tile_plain", "sgd_sweep_step_u",
           "sgd_sweep_step_u_plain", "check_sweep_args",
           "check_kernel_limits", "check_deps", "wavefront_launch"]


def check_sweep_args(who, P, Q, sa, tc, tl, su, si, tpg, bu=None, bi=None):
    """The sweep wrappers' common argument check (``who`` names the
    wrapper in the message): devices, dtypes, contiguity, whole blocks,
    a tile stream that matches ``sa`` / ``tc``, and, where given, bias
    vectors as long as their tables."""
    dev = P.device
    biases = () if bu is None else (("bu", bu, torch.float32),
                                    ("bi", bi, torch.float32))
    for name, x, dt in (("P", P, torch.float32), ("Q", Q, torch.float32),
                        ("sa", sa, torch.int32), ("tc", tc, torch.int32),
                        ("tl", tl, torch.int32)) + biases:
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
    if bu is not None and (bu.shape != P.shape[:1] or bi.shape != Q.shape[:1]):
        raise ValueError(
            f"{who}: bu {tuple(bu.shape)} / bi {tuple(bi.shape)} must have "
            f"one entry a row of P {tuple(P.shape)} / Q {tuple(Q.shape)}"
        )


def check_kernel_limits(who, P, tl, su, si, ranks=(64,)):
    """What the sweep kernels are built for: the ranks in ``ranks``
    (64 and 128 for the lane-bias sweep, 64 for BPR, 32 and 64 for the
    tile-bias ones), T <= 256, blocks <= 1024."""
    if P.shape[1] not in ranks:
        raise NotImplementedError(
            f"{who} kernel is built for rank "
            f"{' or '.join(map(str, ranks))}, got {P.shape[1]} (other "
            "ranks: ROADMAP Queue 2 item 2)"
        )
    if tl.shape[2] > 256 or su > 1024 or si > 1024:
        raise NotImplementedError(
            f"{who} kernel takes tile <= 256 and blocks <= 1024"
        )


def check_deps(who, deps, nt, dev):
    """A dependency table (``plan_device.SweepDeps``) for a stream of
    ``nt`` tiles (strata, for ``dense_phase``) on ``dev``: contiguous
    int32 ``runs`` (R, 2) and ``wait`` (nt, 3); raises ValueError."""
    runs, wait = deps.runs, deps.wait
    for name, x, shape in (("runs", runs, (runs.shape[0], 2)),
                           ("wait", wait, (nt, 3))):
        if (x.device != dev or x.dtype != torch.int32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{who}: deps.{name} must be a contiguous int32 "
                f"{shape} tensor on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if deps.n_tiles != nt:
        raise ValueError(f"{who}: deps order {deps.n_tiles} tiles, the "
                         f"stream holds {nt}")


def wavefront_launch(who, lib, deps, nt, T, dev, blocks, sizing=()):
    """What a wavefront sweep kernel takes beside the tile stream:
    ``(runs, wait, state, sums, grid)``. ``runs`` / ``wait`` are the
    dependency table's (with ``deps=None`` one run of all ``nt`` tiles and
    no waits: one block then walks the stream in plan order); ``state``
    is the launch's zeroed scheduler memory (the run ticket, then the
    tiles finished of each run), ``sums`` the per-tile SSE / loss that
    the kernel adds up in tile order at its end; ``grid`` the thread
    blocks to launch: ``blocks``, or with ``blocks=None`` as many as the
    card holds at once (``mfx_<who>_max_blocks(T, *sizing)``), and never
    more than there are runs."""
    if deps is None or nt == 0:
        runs = torch.tensor([[0, nt]], dtype=torch.int32, device=dev)
        wait = None
    else:
        check_deps(who, deps, nt, dev)
        runs, wait = deps.runs, deps.wait
    if blocks is None:
        blocks = getattr(lib, f"mfx_{who}_max_blocks")(T, *sizing)
        if blocks < 1:
            raise RuntimeError(f"{who}: CUDA error {-blocks} sizing the grid")
    elif blocks < 1:
        raise ValueError(f"{who}: blocks must be >= 1, got {blocks}")
    state = torch.zeros(1 + runs.shape[0], dtype=torch.int32, device=dev)
    sums = torch.empty(max(nt, 1), dtype=torch.float32, device=dev)
    return runs, wait, state, sums, min(int(blocks), max(runs.shape[0], 1))


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
        row_add(P, rows_u, dp)
        row_add(Q, rows_i, dq)
        sse = sse + (e * e).sum()
    return sse


def sgd_sweep(P, Q, sa, tc, tl, lr, reg, mu, *, su, si, tpg, deps=None,
              blocks=None):
    """One item-sweep. ``P`` is the padded lane-form user table
    (A·su, rank), rank 64 or 128; ``Q`` the sweep's item segment
    (nwin·si, rank), a contiguous row range of the padded item table;
    ``sa`` (NT/tpg,) the user block of each group of tpg tiles; ``tc``
    (NT,) each tile's sweep-local window; ``tl`` the (NT, 3, T) tile
    stream. Updates P and Q in place and returns the sweep's SSE as a 0-d
    f32 tensor.

    ``deps`` is the sweep's dependency table from the plan skeleton
    (``SweepSlice.deps``): with it the kernel walks the sweep's runs on
    ``blocks`` thread blocks (default: as many as the card holds at once)
    and the tables and the SSE are bit for bit those of ``blocks=1``, the
    plan-order walk. Without it one block walks the stream in plan order.
    The CPU route ignores both."""
    check_sweep_args("sgd_sweep", P, Q, sa, tc, tl, su, si, tpg)
    if P.device.type == "cpu":
        return sgd_sweep_plain(P, Q, sa, tc, tl, lr, reg, mu,
                               su=su, si=si, tpg=tpg)
    if P.device.type != "cuda":
        raise ValueError(f"sgd_sweep: no kernel for device {P.device}")
    check_kernel_limits("sgd_sweep", P, tl, su, si, ranks=(64, 128))
    nt, T = tl.shape[0], tl.shape[2]
    lib = _build.load_library()
    runs, wait, state, sums, grid = wavefront_launch(
        "sgd_sweep", lib, deps, nt, T, P.device, blocks,
        sizing=(P.shape[1],))
    sse = torch.empty(1, dtype=torch.float32, device=P.device)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    _build.check(lib.mfx_sgd_sweep(
        P.data_ptr(), Q.data_ptr(), sa.data_ptr(), tc.data_ptr(),
        tl.data_ptr(), runs.data_ptr(),
        None if wait is None else wait.data_ptr(), state.data_ptr(),
        sums.data_ptr(), sse.data_ptr(), nt, runs.shape[0], grid, tpg, T,
        su, si, P.shape[1], float(lr), float(reg), float(mu), stream,
    ), "sgd_sweep")
    sgd_sweep.launches += 1
    return sse[0]


sgd_sweep.launches = 0


def _tile_terms(P, Q, bu, bi, tl, t, rows_u0, rows_i0, su, mu, use_bias):
    """One tile's real slots against the given state: global row ids,
    snapshots, and the residual e = r - (((p.q + mu) + bu) + bi)."""
    u, i = tl[t, 0].long(), tl[t, 1].long()
    real = u < su
    r = tl[t, 2].view(torch.float32)[real]
    rows_u, rows_i = rows_u0 + u[real], rows_i0 + i[real]
    p, q = P[rows_u], Q[rows_i]
    pred = (p * q).sum(1) + mu
    b_u = b_i = None
    if use_bias:
        b_u, b_i = bu[rows_u], bi[rows_i]
        pred = pred + b_u + b_i
    return rows_u, rows_i, p, q, b_u, b_i, r - pred


def sgd_sweep_tile_plain(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, *, su, si,
                         tpg, use_bias=True):
    """Plain PyTorch version of :func:`sgd_sweep_tile`: tile by tile,
    gather from the current tables, then segment-summed row and bias
    updates on all lanes. Updates P, Q (and bu, bi) in place; returns the
    sweep's SSE (0-d f32)."""
    sa_h, tc_h = sa.tolist(), tc.tolist()
    sse = torch.zeros((), dtype=torch.float32, device=P.device)
    for t in range(tl.shape[0]):
        rows_u, rows_i, p, q, b_u, b_i, e = _tile_terms(
            P, Q, bu, bi, tl, t, sa_h[t // tpg] * su, tc_h[t] * si, su, mu,
            use_bias)
        row_add(P, rows_u, lr * (e[:, None] * q - reg * p))
        row_add(Q, rows_i, lr * (e[:, None] * p - reg * q))
        if use_bias:
            row_add(bu, rows_u, lr * (e - reg * b_u))
            row_add(bi, rows_i, lr * (e - reg * b_i))
        sse = sse + (e * e).sum()
    return sse


def sgd_sweep_step_u_plain(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, *, su, si,
                           tpg, use_bias=True):
    """Plain PyTorch version of :func:`sgd_sweep_step_u`: per group of
    ``tpg`` tiles the user rows and user biases are read from the state
    at the group's start (nothing writes them inside the group); each
    tile reads and updates the current Q and bi; the user side's deltas
    of the whole group are segment-summed and applied at its end."""
    sa_h, tc_h = sa.tolist(), tc.tolist()
    sse = torch.zeros((), dtype=torch.float32, device=P.device)
    for g in range(tl.shape[0] // tpg):
        rows, d_p, d_bu = [], [], []
        for t in range(g * tpg, (g + 1) * tpg):
            rows_u, rows_i, p, q, b_u, b_i, e = _tile_terms(
                P, Q, bu, bi, tl, t, sa_h[g] * su, tc_h[t] * si, su, mu,
                use_bias)
            rows.append(rows_u)
            d_p.append(lr * (e[:, None] * q - reg * p))
            row_add(Q, rows_i, lr * (e[:, None] * p - reg * q))
            if use_bias:
                d_bu.append(lr * (e - reg * b_u))
                row_add(bi, rows_i, lr * (e - reg * b_i))
            sse = sse + (e * e).sum()
        rows = torch.cat(rows)
        row_add(P, rows, torch.cat(d_p))
        if use_bias:
            row_add(bu, rows, torch.cat(d_bu))
    return sse


def _tile_bias_sweep(wrapper, plain, P, Q, bu, bi, sa, tc, tl, lr, reg, mu,
                     su, si, tpg, use_bias, deps, blocks, step_u=False):
    """The two tile-bias wrappers' common body: both kernels are wavefront
    sweeps and take ``deps`` and ``blocks`` as :func:`sgd_sweep` does.
    ``step_u`` (``sgd_sweep_step_u``) adds the pools of pooled user deltas
    and their grid sizing by the user block."""
    who = wrapper.__name__
    check_sweep_args(who, P, Q, sa, tc, tl, su, si, tpg, bu, bi)
    if P.device.type == "cpu":
        return plain(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, su=su, si=si,
                     tpg=tpg, use_bias=use_bias)
    if P.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {P.device}")
    check_kernel_limits(who, P, tl, su, si, ranks=(32, 64))
    nt, T, rank = tl.shape[0], tl.shape[2], P.shape[1]
    if step_u and not 1 <= tpg <= 8:
        raise NotImplementedError(f"{who} kernel takes tpg 1..8, got {tpg}")
    lib = _build.load_library()
    runs, wait, state, sums, grid = wavefront_launch(
        who, lib, deps, nt, T, P.device, blocks,
        sizing=(rank, su) if step_u else (rank,))
    pools, head = None, []  # step_u: one pool a block, in device memory
    if step_u:  # where the kernel does not keep it in shared memory
        per_block = lib.mfx_sgd_sweep_step_u_pool_floats(T, rank, su)
        if per_block < 0:
            raise RuntimeError(f"{who}: CUDA error {-per_block} placing the "
                               "pools")
        if per_block:
            pools = torch.zeros(grid * per_block, dtype=torch.float32,
                                device=P.device)
        head = [None if pools is None else pools.data_ptr()]
    sse = torch.empty(1, dtype=torch.float32, device=P.device)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    _build.check(getattr(lib, f"mfx_{who}")(
        P.data_ptr(), Q.data_ptr(), bu.data_ptr(), bi.data_ptr(), *head,
        sa.data_ptr(), tc.data_ptr(), tl.data_ptr(), runs.data_ptr(),
        None if wait is None else wait.data_ptr(), state.data_ptr(),
        sums.data_ptr(), sse.data_ptr(), nt, runs.shape[0], grid, tpg, T, su,
        si, rank, int(bool(use_bias)), float(lr), float(reg), float(mu),
        stream,
    ), who)
    wrapper.launches += 1
    return sse[0]


def sgd_sweep_tile(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, *, su, si, tpg,
                   use_bias=True, deps=None, blocks=None):
    """One item-sweep with per-tile biases (``bias_mode='tile'``) or, with
    ``use_bias=False``, none. ``P`` (A·su, rank) and ``Q`` (nwin·si, rank)
    are the padded canonical tables (``Q`` the sweep's item segment),
    ``bu`` (A·su,) and ``bi`` (nwin·si,) the biases of the same rows;
    ``sa``, ``tc``, ``tl`` as in :func:`sgd_sweep`. Per tile: gather
    p, q, bu[u], bi[i] from the current state; e = r - (p.q + mu + bu +
    bi); row deltas lr (e q - reg p), lr (e p - reg q) on all lanes and
    bias deltas lr (e - reg b), summed exactly over duplicate rows. Updates
    the tables (and the biases) in place and returns the sweep's SSE over
    real slots as a 0-d f32 tensor. ``deps`` and ``blocks`` as in
    :func:`sgd_sweep`: the same bits on any grid."""
    return _tile_bias_sweep(sgd_sweep_tile, sgd_sweep_tile_plain, P, Q, bu,
                            bi, sa, tc, tl, lr, reg, mu, su, si, tpg,
                            use_bias, deps, blocks)


def sgd_sweep_step_u(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, *, su, si, tpg,
                     use_bias=True, deps=None, blocks=None):
    """One item-sweep with the user side batched per group of ``tpg`` tiles
    (``sgd.step_user_batch``); arguments and result as
    :func:`sgd_sweep_tile`. Here ``tpg`` is part of the math: a group's
    tiles read P and bu as the group found them, update Q and bi tile by
    tile, and the user rows' and user biases' deltas of all tpg·T slots
    are summed and applied once at the group's end. ``deps`` and
    ``blocks`` as in :func:`sgd_sweep`: the same bits on any grid (a group
    never straddles two runs: the planner pads each run to ``tpg``
    tiles). Each block's pooled deltas (su·(rank + 1) floats) live in
    shared memory where they fit beside the tile's buffers, else in
    device memory; the kernel decides, and the bits are the same either
    way. The CPU route ignores ``deps`` and ``blocks``."""
    return _tile_bias_sweep(sgd_sweep_step_u, sgd_sweep_step_u_plain, P, Q,
                            bu, bi, sa, tc, tl, lr, reg, mu, su, si, tpg,
                            use_bias, deps, blocks, step_u=True)


sgd_sweep_tile.launches = 0
sgd_sweep_step_u.launches = 0
