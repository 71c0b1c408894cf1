"""Sparse blocked-SGD sweeps: wrappers of ``csrc/sgd_sweep.cu``,
``csrc/sgd_sweep_tile.cu`` and ``csrc/sgd_sweep_step_u.cu``, each with its
plain PyTorch version.

They replace the two bodies of ``mfx/kernels/sgd_pallas.py``'s sweep call:

- :func:`sgd_sweep`: ``_kernel_body`` with ``bias_mode='lane'`` (the
  biases ride in two factor lanes that the update freezes);
- :func:`sgd_sweep_time`: the same body with ``time_mode=True`` (blocked
  timeSVD): the lane form with each slot's time bin and deviation
  injected into its snapshot rows;
- :func:`sgd_sweep_tile`: ``_kernel_body`` with ``bias_mode='tile'`` or
  with no biases (``bu`` / ``bi`` are vectors beside the tables and every
  lane updates);
- :func:`sgd_sweep_epoch`: the same kernel with ``bias_mode='epoch'``:
  the biases frozen for the sweep, every lane updates, and each slot's
  residual is written out for the trainer's batched bias update at the
  epoch's end;
- :func:`sgd_sweep_step_u`: ``_kernel_body_step_u``
  (``sgd.step_user_batch``): the same, with the user side batched over
  each group of ``tpg`` tiles.

The kernels are built for the ranks of :data:`SWEEP_RANKS`, every rank
that divides 128, as the reference packs 128 // rank rows a lane row and
takes each of them; the time form from rank 8 (at rank 4 no bin fits) and
the lane form from rank 2 (:func:`check_lane_rank`: one lane cannot hold
both bias lanes).

One call runs one item-sweep: the tiles of ``tl``, each a snapshot
minibatch (gather, residuals, exact segment-summed scatter), on plain
``(rows, rank)`` f32 tables updated in place. The result is that of
walking the tiles in plan order. Every wrapper here (and
``kernels.bpr_sweep``), given the plan's dependency table
(``plan_device.SweepDeps``), walks them on as many SMs as the table
allows and gives the same bits.

``bf16=True`` (``sgd.mxu='bf16'``; every wrapper but
:func:`sgd_sweep_time`, whose reference form takes no ``mxu``) is the
reference's ``mxu_bf16`` branch: the gathered factor rows (and, with tile
biases, the gathered biases) enter the residual and the deltas rounded to
bf16 (round to nearest even), each slot's delta is rounded to bf16 before
the run's sum, and the sum is taken in f32. The tables stay f32: a row's
new value is its f32 value plus the sum of its rounded deltas. A rounding
to bf16 is a step of 2^-8 of the value, so an ulp's difference in a
residual can move a delta by a whole bf16 step; the plain versions of the
bf16 form therefore take every sum in the kernels' order (the dot's fma
chains, :func:`kernel_dot`; each row's deltas from 0 in slot order, then
added to the row, :func:`run_add`; step_u's pool, :func:`_pool_add`) and
so give the kernels' values.

The f32 plain versions keep the plain sums (``(p * q).sum(1)``,
``packing.row_add``): the fork is ``_dot`` / ``_add`` and step_u's pool.
Their tests against the reference pass in the kernels' order too, but
that order walks each row's run one occurrence at a time and each dot in
f64 steps: 3-6 times the plain sums' time on the card's 2,048-tile check,
and more on hot tiles, on every CPU trainer run. An f32 delta is not
rounded again, so a one-ulp difference in a sum stays one ulp, and the
f32 forms are held to a tolerance, not to the bits.

On CUDA tensors a wrapper launches its kernel (or raises); on CPU tensors
it runs its plain version. Nothing falls back.
"""

from __future__ import annotations

import torch

from mfx_torch.kernels import _build
from mfx_torch.kernels.packing import row_add

__all__ = ["SWEEP_RANKS", "bf16_round", "kernel_dot", "run_sums", "run_add",
           "sgd_sweep", "sgd_sweep_plain", "sgd_sweep_time", "sgd_sweep_tile",
           "sgd_sweep_tile_plain", "sgd_sweep_epoch", "sgd_sweep_epoch_plain",
           "sgd_sweep_step_u", "sgd_sweep_step_u_plain", "check_sweep_args",
           "check_kernel_limits", "check_lane_rank", "check_deps",
           "wavefront_launch"]

# the ranks every sweep kernel is built for: csrc/sgd_sweep.cu (lane and
# time forms; the time form's n_bins <= rank - 4 leaves rank 4 none, the
# lane form's two bias lanes leave rank 1 none), sgd_sweep_tile.cu,
# sgd_sweep_step_u.cu and bpr_sweep.cu. Below rank 4 a row is less than a
# float4: the kernels read and write it as a float2 or a float
SWEEP_RANKS = (1, 2, 4, 8, 16, 32, 64, 128)


def bf16_round(x: torch.Tensor, on: bool = True) -> torch.Tensor:
    """``x`` rounded to bf16 (round to nearest even) and widened back to
    f32 where ``on``; ``x`` itself otherwise."""
    return x.to(torch.bfloat16).to(torch.float32) if on else x


def kernel_dot(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Each row's dot of ``p`` and ``q`` (n, rank) in the sweep kernels'
    order (``csrc/sweep_common.cuh``, ``dot_part``): 8 chains, chain k an
    fma over lanes 4 (k + 8 j) .. 4 (k + 8 j) + 3 for j ascending (each fma
    one rounding: the product is exact in f64 and the f64 sum is rounded
    to f32), then ((c0 + c4) + (c2 + c6)) + ((c1 + c5) + (c3 + c7)). Below
    rank 32 a row has fewer than 8 float4 and the threads past them keep
    a chain of 0: the rows are padded with zero lanes to 32, which gives
    the same chains and the same adds."""
    n, rank = p.shape
    pad = -rank % 32
    if pad:
        p = torch.nn.functional.pad(p, (0, pad))
        q = torch.nn.functional.pad(q, (0, pad))
    width = (rank + pad) // 32
    a = p.double().reshape(n, width, 8, 4)
    b = q.double().reshape(n, width, 8, 4)
    c = torch.zeros(n, 8, dtype=torch.float32, device=p.device)
    for j in range(width):
        for x in range(4):
            c = (a[:, j, :, x] * b[:, j, :, x] + c.double()).float()
    return (((c[:, 0] + c[:, 4]) + (c[:, 2] + c[:, 6]))
            + ((c[:, 1] + c[:, 5]) + (c[:, 3] + c[:, 7])))


def run_sums(rows: torch.Tensor, delta: torch.Tensor):
    """``(uniq, sums)``: the distinct ``rows`` (ascending) and each one's
    ``delta`` rows summed from 0 in slot order, as a kernel sums a row's
    run, on either device."""
    uniq, inv = torch.unique(rows, return_inverse=True)
    sums = torch.zeros((uniq.shape[0],) + delta.shape[1:],
                       dtype=delta.dtype, device=delta.device)
    if rows.numel() == 0:
        return uniq, sums
    by_row = torch.sort(inv, stable=True).indices
    counts = torch.bincount(inv, minlength=uniq.shape[0])
    starts = torch.cumsum(counts, 0) - counts
    occ = torch.empty_like(inv)  # each slot's place in its row's run
    occ[by_row] = (torch.arange(inv.shape[0], device=inv.device)
                   - starts[inv[by_row]])
    # the slots by their place in their runs: one host read of the bounds,
    # then slices, so no step waits on the device
    by_occ = torch.sort(occ, stable=True).indices
    lo = 0
    for hi in torch.bincount(occ).cumsum(0).tolist():
        at = by_occ[lo:hi]  # at most one slot a row
        r = inv[at]
        sums[r] = sums[r] + delta[at]
        lo = hi
    return uniq, sums


def run_add(table: torch.Tensor, rows: torch.Tensor,
            delta: torch.Tensor) -> None:
    """``table[rows] += delta`` as a kernel writes a tile's runs: each
    distinct row becomes its value plus its deltas' :func:`run_sums`."""
    uniq, sums = run_sums(rows, delta)
    table[uniq] = table[uniq] + sums


def _dot(p, q, bf16):
    return kernel_dot(p, q) if bf16 else (p * q).sum(1)


def _add(table, rows, delta, bf16):
    if bf16:
        run_add(table, rows, delta)
    else:
        row_add(table, rows, delta)


def check_sweep_args(who, P, Q, sa, tc, tl, su, si, tpg, bu=None, bi=None,
                     rows=3):
    """The sweep wrappers' common argument check (``who`` names the
    wrapper in the message): devices, dtypes, contiguity, whole blocks,
    a tile stream of ``rows`` rows a tile that matches ``sa`` / ``tc``,
    and, where given, bias vectors as long as their tables."""
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
    if tl.dim() != 3 or tl.shape[1] != rows:
        raise ValueError(f"{who}: tl must be (NT, {rows}, T), got {tl.shape}")
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


def check_kernel_limits(who, P, tl, su, si):
    """What the sweep kernels are built for: the ranks of SWEEP_RANKS,
    T <= 256, blocks <= 1024."""
    if P.shape[1] not in SWEEP_RANKS:
        raise NotImplementedError(
            f"{who} kernel is built for rank "
            f"{' or '.join(map(str, SWEEP_RANKS))}, got {P.shape[1]}: a rank "
            "that does not divide 128, or one above 128, has no form in the "
            "reference either"
        )
    if tl.shape[2] > 256 or su > 1024 or si > 1024:
        raise NotImplementedError(
            f"{who} kernel takes tile <= 256 and blocks <= 1024"
        )


def check_lane_rank(who, rank):
    """The lane form needs rank >= 2: P rows ``[p, 1, bu]`` and Q rows
    ``[q, bi, 1]`` end in two bias lanes. Raises ValueError at rank 1, on
    every device."""
    if rank < 2:
        raise ValueError(
            f"{who}: the lane form needs rank >= 2, got {rank}: one lane "
            "cannot hold both bias lanes (the reference's to_lane_model "
            "writes lane rank-2 = -1, which is lane 0, and then lane 0 "
            "again, so it drops b_i); use sgd.bias_mode='tile' or 'epoch'")


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


def wavefront_launch(who, lib, deps, nt, T, dev, blocks, sizing=(),
                     kernel=None):
    """What a wavefront sweep kernel takes beside the tile stream:
    ``(runs, wait, state, sums, grid)``. ``runs`` / ``wait`` are the
    dependency table's (with ``deps=None`` one run of all ``nt`` tiles and
    no waits: one block then walks the stream in plan order); ``state``
    is the launch's zeroed scheduler memory (the run ticket, then the
    tiles finished of each run), ``sums`` the per-tile SSE / loss that
    the kernel adds up in tile order at its end; ``grid`` the thread
    blocks to launch: ``blocks``, or with ``blocks=None`` as many as the
    card holds at once (``mfx_<kernel>_max_blocks(T, *sizing)``, the
    kernel's C name defaulting to ``who``), and never more than there are
    runs."""
    if deps is None or nt == 0:
        runs = torch.tensor([[0, nt]], dtype=torch.int32, device=dev)
        wait = None
    else:
        check_deps(who, deps, nt, dev)
        runs, wait = deps.runs, deps.wait
    if blocks is None:
        blocks = getattr(lib, f"mfx_{kernel or who}_max_blocks")(T, *sizing)
        if blocks < 1:
            raise RuntimeError(f"{who}: CUDA error {-blocks} sizing the grid")
    elif blocks < 1:
        raise ValueError(f"{who}: blocks must be >= 1, got {blocks}")
    state = torch.zeros(1 + runs.shape[0], dtype=torch.int32, device=dev)
    sums = torch.empty(max(nt, 1), dtype=torch.float32, device=dev)
    return runs, wait, state, sums, min(int(blocks), max(runs.shape[0], 1))


def sgd_sweep_plain(P, Q, sa, tc, tl, lr, reg, mu, *, su, si, tpg,
                    n_bins=0, bf16=False):
    """Plain PyTorch version: the same sweep, tile by tile. Updates P and
    the item segment Q in place; returns the sweep's SSE (0-d f32).
    ``bf16``: the rounded form (module docstring); not with ``n_bins``.

    ``n_bins`` > 0: the time form (``tl`` of 5 rows). With L = rank - 3 -
    n_bins, each real slot's snapshot takes 1 more in P lane L + bin and
    dev more in Q lane rank-3 before the residual and the deltas; P's bin
    lanes and Q's lane rank-3 are frozen beside the constant-1 lanes."""
    if n_bins and bf16:
        raise ValueError("sgd_sweep_plain: the time form takes no bf16")
    rank = P.shape[1]
    dev = P.device
    mP = torch.ones(rank, dtype=P.dtype, device=dev)
    mQ = torch.ones(rank, dtype=P.dtype, device=dev)
    mP[rank - 2] = 0.0  # P's constant-1 lane
    mQ[rank - 1] = 0.0  # Q's constant-1 lane
    L = rank - 3 - n_bins
    if n_bins:
        mP[L:L + n_bins] = 0.0  # P's bin lanes
        mQ[rank - 3] = 0.0  # Q's drift lane
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
        if n_bins:
            slots = torch.arange(p.shape[0], device=dev)
            p[slots, L + tl[t, 3][real].long()] += 1.0
            q[:, rank - 3] += tl[t, 4].view(torch.float32)[real]
        p, q = bf16_round(p, bf16), bf16_round(q, bf16)
        e = r - (_dot(p, q, bf16) + mu)
        dp = bf16_round(lr * (e[:, None] * q - reg * p), bf16) * mP
        dq = bf16_round(lr * (e[:, None] * p - reg * q), bf16) * mQ
        _add(P, rows_u, dp, bf16)
        _add(Q, rows_i, dq, bf16)
        sse = sse + (e * e).sum()
    return sse


def _lane_sweep(wrapper, P, Q, sa, tc, tl, lr, reg, mu, su, si, tpg, deps,
                blocks, n_bins=0, bf16=False):
    """The lane wrappers' common body: :func:`sgd_sweep` and, with
    ``n_bins`` > 0, :func:`sgd_sweep_time`."""
    who = wrapper.__name__
    check_sweep_args(who, P, Q, sa, tc, tl, su, si, tpg,
                     rows=5 if n_bins else 3)
    if n_bins and not 1 <= n_bins <= P.shape[1] - 4:
        raise ValueError(f"{who}: needs 1 <= n_bins <= rank-4, got {n_bins} "
                         f"at rank {P.shape[1]}")
    if not n_bins:
        check_lane_rank(who, P.shape[1])
    if P.device.type == "cpu":
        return sgd_sweep_plain(P, Q, sa, tc, tl, lr, reg, mu, su=su, si=si,
                               tpg=tpg, n_bins=n_bins, bf16=bf16)
    if P.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {P.device}")
    check_kernel_limits(who, P, tl, su, si)
    nt, T = tl.shape[0], tl.shape[2]
    lib = _build.load_library()
    runs, wait, state, sums, grid = wavefront_launch(
        who, lib, deps, nt, T, P.device, blocks, sizing=(P.shape[1],))
    sse = torch.empty(1, dtype=torch.float32, device=P.device)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    form_arg = (n_bins,) if n_bins else (int(bf16),)
    _build.check(getattr(lib, f"mfx_{who}")(
        P.data_ptr(), Q.data_ptr(), sa.data_ptr(), tc.data_ptr(),
        tl.data_ptr(), runs.data_ptr(),
        None if wait is None else wait.data_ptr(), state.data_ptr(),
        sums.data_ptr(), sse.data_ptr(), nt, runs.shape[0], grid, tpg, T,
        su, si, P.shape[1], float(lr), float(reg), float(mu), *form_arg,
        stream,
    ), who)
    wrapper.launches += 1
    if bf16:
        wrapper.bf16_launches += 1
    return sse[0]


def sgd_sweep(P, Q, sa, tc, tl, lr, reg, mu, *, su, si, tpg, deps=None,
              blocks=None, bf16=False):
    """One item-sweep. ``P`` is the padded lane-form user table
    (A·su, rank), a rank of SWEEP_RANKS; ``Q`` the sweep's item segment
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
    The CPU route ignores both. ``bf16``: the rounded form (``sgd.mxu=
    'bf16'``, module docstring)."""
    return _lane_sweep(sgd_sweep, P, Q, sa, tc, tl, lr, reg, mu, su, si,
                       tpg, deps, blocks, bf16=bf16)


def sgd_sweep_time(P, Q, sa, tc, tl, lr, reg, mu, *, su, si, tpg, n_bins,
                   deps=None, blocks=None):
    """One item-sweep of blocked timeSVD (the reference's ``time_mode``):
    :func:`sgd_sweep` on the time-lane tables
    (``kernels.packing.to_tlane_model``: P rows ``[p(L), 0 x n_bins,
    alpha, 1, bu]``, Q rows ``[q(L), bt(n_bins), 0, bi, 1]``, L = rank - 3
    - n_bins) and a (NT, 5, T) tile stream whose rows 3 and 4 hold each
    slot's time bin and deviation (f32 bits; 0 in pads). Each real slot
    adds 1 to its P snapshot's lane L + bin and dev to its Q snapshot's
    lane rank-3, so one lr and one reg train bt, alpha and the factors;
    those injections never reach the tables, whose bin lanes and drift
    lane stay as they were. ``deps`` and ``blocks`` as in
    :func:`sgd_sweep`: the same bits on any grid."""
    return _lane_sweep(sgd_sweep_time, P, Q, sa, tc, tl, lr, reg, mu, su, si,
                       tpg, deps, blocks, n_bins=n_bins)


sgd_sweep.launches = 0
sgd_sweep_time.launches = 0
# the launches of the bf16 form (sgd.mxu='bf16'), counted in launches too
sgd_sweep.bf16_launches = 0


def _tile_terms(P, Q, bu, bi, tl, t, rows_u0, rows_i0, su, mu, use_bias,
                bf16=False):
    """One tile's real slots against the given state: global row ids,
    snapshots (rounded to bf16 with ``bf16``), and the residual e = r -
    (((p.q + mu) + bu) + bi)."""
    u, i = tl[t, 0].long(), tl[t, 1].long()
    real = u < su
    r = tl[t, 2].view(torch.float32)[real]
    rows_u, rows_i = rows_u0 + u[real], rows_i0 + i[real]
    p, q = bf16_round(P[rows_u], bf16), bf16_round(Q[rows_i], bf16)
    pred = _dot(p, q, bf16) + mu
    b_u = b_i = None
    if use_bias:
        b_u, b_i = bf16_round(bu[rows_u], bf16), bf16_round(bi[rows_i], bf16)
        pred = pred + b_u + b_i
    return rows_u, rows_i, p, q, b_u, b_i, r - pred


def sgd_sweep_tile_plain(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, *, su, si,
                         tpg, use_bias=True, bf16=False):
    """Plain PyTorch version of :func:`sgd_sweep_tile`: tile by tile,
    gather from the current tables, then segment-summed row and bias
    updates on all lanes. Updates P, Q (and bu, bi) in place; returns the
    sweep's SSE (0-d f32). ``bf16``: the rounded form (module
    docstring)."""
    sa_h, tc_h = sa.tolist(), tc.tolist()
    sse = torch.zeros((), dtype=torch.float32, device=P.device)
    for t in range(tl.shape[0]):
        rows_u, rows_i, p, q, b_u, b_i, e = _tile_terms(
            P, Q, bu, bi, tl, t, sa_h[t // tpg] * su, tc_h[t] * si, su, mu,
            use_bias, bf16)
        _add(P, rows_u, bf16_round(lr * (e[:, None] * q - reg * p), bf16),
             bf16)
        _add(Q, rows_i, bf16_round(lr * (e[:, None] * p - reg * q), bf16),
             bf16)
        if use_bias:
            _add(bu, rows_u, bf16_round(lr * (e - reg * b_u), bf16), bf16)
            _add(bi, rows_i, bf16_round(lr * (e - reg * b_i), bf16), bf16)
        sse = sse + (e * e).sum()
    return sse


def sgd_sweep_epoch_plain(P, Q, bu, bi, sa, tc, tl, e_out, lr, reg, mu, *,
                          su, si, tpg, bf16=False):
    """Plain PyTorch version of :func:`sgd_sweep_epoch`, in the reference's
    form: the per-slot bias stream bt = bu[u] + bi[i] is built first from
    the biases as they stand, then tile by tile e = r - ((p.q + mu) + bt)
    and segment-summed row updates on all lanes. Updates P and Q in place,
    writes each slot's residual (0 in pads) to ``e_out`` (NT, T); returns
    the sweep's SSE (0-d f32). ``bf16``: the factor rows and the deltas
    rounded (module docstring); bt is the reference's f32 stream, not
    rounded."""
    nt, T = tl.shape[0], tl.shape[2]
    t_of = torch.arange(nt, device=P.device)[:, None]
    real = tl[:, 0] < su
    rows_u = sa.long()[t_of // tpg] * su + tl[:, 0].long()
    rows_i = tc.long()[t_of] * si + tl[:, 1].long()
    bt = torch.zeros(nt, T, dtype=torch.float32, device=P.device)
    bt[real] = bu[rows_u[real]] + bi[rows_i[real]]
    e_out.zero_()
    sse = torch.zeros((), dtype=torch.float32, device=P.device)
    for t in range(nt):
        m = real[t]
        ru, ri = rows_u[t][m], rows_i[t][m]
        p, q = bf16_round(P[ru], bf16), bf16_round(Q[ri], bf16)
        e = tl[t, 2].view(torch.float32)[m] - ((_dot(p, q, bf16) + mu)
                                               + bt[t][m])
        _add(P, ru, bf16_round(lr * (e[:, None] * q - reg * p), bf16), bf16)
        _add(Q, ri, bf16_round(lr * (e[:, None] * p - reg * q), bf16), bf16)
        e_out[t, m] = e
        sse = sse + (e * e).sum()
    return sse


def sgd_sweep_step_u_plain(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, *, su, si,
                           tpg, use_bias=True, bf16=False):
    """Plain PyTorch version of :func:`sgd_sweep_step_u`: per group of
    ``tpg`` tiles the user rows and user biases are read from the state
    at the group's start (nothing writes them inside the group); each
    tile reads and updates the current Q and bi; the user side's deltas
    of the whole group are segment-summed and applied at its end.
    ``bf16``: the rounded form (module docstring)."""
    sa_h, tc_h = sa.tolist(), tc.tolist()
    sse = torch.zeros((), dtype=torch.float32, device=P.device)
    for g in range(tl.shape[0] // tpg):
        rows, d_p, d_bu = [], [], []
        for t in range(g * tpg, (g + 1) * tpg):
            rows_u, rows_i, p, q, b_u, b_i, e = _tile_terms(
                P, Q, bu, bi, tl, t, sa_h[g] * su, tc_h[t] * si, su, mu,
                use_bias, bf16)
            rows.append(rows_u)
            d_p.append(bf16_round(lr * (e[:, None] * q - reg * p), bf16))
            _add(Q, rows_i, bf16_round(lr * (e[:, None] * p - reg * q), bf16),
                 bf16)
            if use_bias:
                d_bu.append(bf16_round(lr * (e - reg * b_u), bf16))
                _add(bi, rows_i, bf16_round(lr * (e - reg * b_i), bf16), bf16)
            sse = sse + (e * e).sum()
        if bf16:  # the kernel's pool: each tile's run sums, tile by tile
            _pool_add(P, rows, d_p)
            if use_bias:
                _pool_add(bu, rows, d_bu)
            continue
        rows = torch.cat(rows)
        row_add(P, rows, torch.cat(d_p))
        if use_bias:
            row_add(bu, rows, torch.cat(d_bu))
    return sse


def _pool_add(table, rows, deltas):
    """A group's user side as the step_u kernel pools it: each tile's
    :func:`run_sums` added, tile by tile, to a pool that starts at 0; then
    each touched row becomes its value plus its pool."""
    touched = torch.unique(torch.cat(rows))
    pool = torch.zeros((touched.shape[0],) + deltas[0].shape[1:],
                       dtype=deltas[0].dtype, device=table.device)
    for r, d in zip(rows, deltas):
        uniq, sums = run_sums(r, d)
        at = torch.searchsorted(touched, uniq)
        pool[at] = pool[at] + sums
    table[touched] = table[touched] + pool


def _tile_bias_sweep(wrapper, plain, P, Q, bu, bi, sa, tc, tl, lr, reg, mu,
                     su, si, tpg, use_bias, deps, blocks, step_u=False,
                     e_out=None, bf16=False):
    """The three bias-vector wrappers' common body: the kernels are
    wavefront sweeps and take ``deps`` and ``blocks`` as :func:`sgd_sweep`
    does. ``step_u`` (``sgd_sweep_step_u``) adds the pools of pooled user
    deltas and their grid sizing by the user block; ``e_out``
    (``sgd_sweep_epoch``) the residuals' output and frozen biases."""
    who = wrapper.__name__
    check_sweep_args(who, P, Q, sa, tc, tl, su, si, tpg, bu, bi)
    shape = (tl.shape[0], tl.shape[2])
    if e_out is not None and (
            e_out.device != P.device or e_out.dtype != torch.float32
            or tuple(e_out.shape) != shape or not e_out.is_contiguous()):
        raise ValueError(
            f"{who}: e_out must be a contiguous f32 {shape} tensor on "
            f"{P.device}, got {e_out.dtype} {tuple(e_out.shape)} on "
            f"{e_out.device}")
    if P.device.type == "cpu":
        if e_out is not None:
            return plain(P, Q, bu, bi, sa, tc, tl, e_out, lr, reg, mu, su=su,
                         si=si, tpg=tpg, bf16=bf16)
        return plain(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, su=su, si=si,
                     tpg=tpg, use_bias=use_bias, bf16=bf16)
    if P.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {P.device}")
    check_kernel_limits(who, P, tl, su, si)
    nt, T, rank = tl.shape[0], tl.shape[2], P.shape[1]
    if step_u and not 1 <= tpg <= 8:
        raise NotImplementedError(f"{who} kernel takes tpg 1..8, got {tpg}")
    lib = _build.load_library()
    kernel = "sgd_sweep_step_u" if step_u else "sgd_sweep_tile"
    runs, wait, state, sums, grid = wavefront_launch(
        who, lib, deps, nt, T, P.device, blocks,
        sizing=(rank, su) if step_u else (rank,), kernel=kernel)
    # the pointer after bi: step_u's pools (one a block, in device memory
    # where the kernel does not keep it in shared memory), the tile
    # kernel's residual output (use_bias 2, the epoch form)
    extra = None if e_out is None else e_out.data_ptr()
    if step_u:
        per_block = lib.mfx_sgd_sweep_step_u_pool_floats(T, rank, su)
        if per_block < 0:
            raise RuntimeError(f"{who}: CUDA error {-per_block} placing the "
                               "pools")
        if per_block:
            pools = torch.zeros(grid * per_block, dtype=torch.float32,
                                device=P.device)
            extra = pools.data_ptr()
    mode = 2 if e_out is not None else int(bool(use_bias))
    sse = torch.empty(1, dtype=torch.float32, device=P.device)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    _build.check(getattr(lib, f"mfx_{kernel}")(
        P.data_ptr(), Q.data_ptr(), bu.data_ptr(), bi.data_ptr(), extra,
        sa.data_ptr(), tc.data_ptr(), tl.data_ptr(), runs.data_ptr(),
        None if wait is None else wait.data_ptr(), state.data_ptr(),
        sums.data_ptr(), sse.data_ptr(), nt, runs.shape[0], grid, tpg, T, su,
        si, rank, mode, int(bf16), float(lr), float(reg), float(mu), stream,
    ), who)
    wrapper.launches += 1
    if bf16:
        wrapper.bf16_launches += 1
    return sse[0]


def sgd_sweep_tile(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, *, su, si, tpg,
                   use_bias=True, deps=None, blocks=None, bf16=False):
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
    :func:`sgd_sweep`: the same bits on any grid. ``bf16``: the rounded
    form, the gathered biases rounded too (module docstring)."""
    return _tile_bias_sweep(sgd_sweep_tile, sgd_sweep_tile_plain, P, Q, bu,
                            bi, sa, tc, tl, lr, reg, mu, su, si, tpg,
                            use_bias, deps, blocks, bf16=bf16)


def sgd_sweep_epoch(P, Q, bu, bi, sa, tc, tl, e_out, lr, reg, mu, *, su, si,
                    tpg, deps=None, blocks=None, bf16=False):
    """One item-sweep with epoch-frozen biases (``bias_mode='epoch'``).
    Arguments as :func:`sgd_sweep_tile`, plus ``e_out``, an (NT, T) f32
    output. Per tile: gather p, q from the current tables and bu[u], bi[i]
    from the bias vectors, which the sweep never writes; e = r - ((p.q +
    mu) + (bu + bi)), the reference's order with its per-slot stream bt =
    bu + bi; row deltas lr (e q - reg p), lr (e p - reg q) on all lanes,
    summed exactly over duplicate rows; e_out[t, s] = e of slot s of tile
    t, 0 in pad slots. Updates P and Q in place (bu and bi stay as they
    are) and returns the sweep's SSE over real slots as a 0-d f32 tensor.
    ``deps`` and ``blocks`` as in :func:`sgd_sweep`: the same bits on any
    grid. With all biases 0 the tables are bit for bit those of
    :func:`sgd_sweep_tile` with ``use_bias=False``. ``bf16``: the factor
    rows and the deltas rounded, the frozen biases not (the reference's
    f32 stream)."""
    return _tile_bias_sweep(sgd_sweep_epoch, sgd_sweep_epoch_plain, P, Q, bu,
                            bi, sa, tc, tl, lr, reg, mu, su, si, tpg, True,
                            deps, blocks, e_out=e_out, bf16=bf16)


def sgd_sweep_step_u(P, Q, bu, bi, sa, tc, tl, lr, reg, mu, *, su, si, tpg,
                     use_bias=True, deps=None, blocks=None, bf16=False):
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
    way. The CPU route ignores ``deps`` and ``blocks``. ``bf16``: the
    rounded form (module docstring): the group-start gather of user rows
    and biases rounded, and every pooled delta rounded before its sum."""
    return _tile_bias_sweep(sgd_sweep_step_u, sgd_sweep_step_u_plain, P, Q,
                            bu, bi, sa, tc, tl, lr, reg, mu, su, si, tpg,
                            use_bias, deps, blocks, step_u=True, bf16=bf16)


sgd_sweep_tile.launches = 0
sgd_sweep_epoch.launches = 0
sgd_sweep_step_u.launches = 0
for _wrapper in (sgd_sweep_tile, sgd_sweep_epoch, sgd_sweep_step_u):
    _wrapper.bf16_launches = 0
