"""Dense-stratum SGD phase: wrapper of ``csrc/dense_phase.cu`` and its
plain PyTorch version.

Replaces ``mfx/kernels/dense_pallas.py::_kernel_body`` in its three bias
forms, each with int4 codes at ranks 32 and 64 and int8 codes at ranks 32,
64 and 128 (the reference has no other dense rank), with its ``echo``
passes (lane and bias-free forms, as the reference); its ``spg``
batching has no form here (the null strata it pads with are exact no-ops,
:func:`mfx_torch.solvers.dense_prep.prepare_dense_full`):

- ``bias='lane'`` (``lane=True``; ``bias_mode='lane'``): the biases ride
  in two factor lanes of the tables, which the update freezes;
- ``bias='frozen'`` (``use_bias=True, lane=False``; ``bias_mode`` 'tile'
  or 'epoch'): ``bu`` / ``bi`` vectors beside canonical tables, read at
  the group's start and fixed for it; the phase returns each stratum's
  row and column sums of E, and :func:`dense_bias_update` applies one
  batched bias step after the group;
- ``bias='none'`` (``use_bias=False``): no biases.

One call runs one dense group: its strata in plan order, each a snapshot
minibatch

    S = P_blk Q_winᵀ,  E = [code > 0] ∘ ((((code·c − S) − bu) − bi) − μ)
    P_blk += lr·s_u ∘ (E Q_win − reg·Du ∘ P_blk)
    Q_win += lr·s_i ∘ (Eᵀ P_blk − reg·Di ∘ Q_win)

(bu, bi only in the frozen form; the lane form freezes P's lane rank-2
and Q's lane rank-1) with s = min(1, DSTAR / max(deg, 1))
over the per-stratum degrees and c = 1 / R4_SCALE (int4) or f32(1 /
R_SCALE) (int8), as the reference decodes. The group's ``R`` says its
format: uint8 ``(ND, su, si/2)`` is int4, int8 ``(ND, su, si)`` is int8.

``echo`` > 1 (``sgd.dense_echo``) repeats that step ``echo`` times on each
stratum before the next, each pass reading the tables the pass before it
wrote; the SSE counts the first pass only. The reference refuses it with
frozen biases (their batched update takes one pass's E sums), and so does
this wrapper. On the card the passes are ``echo`` consecutive *slots* of
the launch: slot k runs data stratum k // echo, and the group's
dependency table, repeated per slot (``SweepDeps.repeat``), chains them.

A stratum with no codes and no degrees (the reference's ``spg`` padding)
is an exact no-op: E = 0 and reg·deg = 0.

On CUDA tensors the wrapper launches the kernel (or raises); on CPU
tensors it runs :func:`dense_phase_plain`. Nothing falls back.
"""

from __future__ import annotations

import torch

from mfx_torch.kernels import _build
from mfx_torch.kernels.packing import row_add
from mfx_torch.kernels.sgd_sweep import check_deps

__all__ = ["dense_phase", "dense_phase_plain", "dense_bias_update",
           "check_echo",
           "bias_step", "dense_launch", "dense_scratch", "bias_scratch",
           "launch",
           "plan_launch", "check_kernel_form", "code_format", "decode_codes",
           "group_prefix", "group_totals", "BIAS_FORMS", "DSTAR", "R_SCALE",
           "R4_SCALE"]

# the reference's rating codes (mfx/kernels/dense_pallas.py): int8 holds
# round(r * R_SCALE), int4 round(r * R4_SCALE); 0 = absent
R_SCALE = 25.0
R4_SCALE = 2.0
# per-row trust scaling of a whole-stratum batch step (the reference's)
DSTAR = 16.0

# (rank, code format) of the kernel's instances, each built in every bias
# form (csrc/dense_phase.cu's LANE, FROZEN, NONE)
_FORMS = {(32, "int4"), (32, "int8"), (64, "int4"), (64, "int8"),
          (128, "int8")}
BIAS_FORMS = ("lane", "frozen", "none")
# strata whose dQ partials the kernel keeps at once (su/64 x si x rank f32
# each: 4 MB at 1024² and rank 64, 2 MB at 512² and rank 128); a stratum
# waits for the one handed out this many
# places before it. 8 runs the ml25m_rank64 dense phase as fast as 16
# with half the scratch (measure_wavefront orders).
_RING = 8
# pieces a row panel is cut into (csrc/dense_phase.cu's PIECES)
_PIECES = 2


def code_format(R: torch.Tensor) -> str:
    """The format of a group's R image: 'int8' for int8 codes (ND, su, si),
    'int4' for nibble pairs (ND, su, si/2) uint8."""
    return "int8" if R.dtype == torch.int8 else "int4"


def decode_codes(R: torch.Tensor, rfmt: str) -> torch.Tensor:
    """One stratum's R image -> (su, si) integer codes (int32)."""
    if rfmt == "int8":
        return R.to(torch.int32)
    # int4: (su, si/2) bytes, even column in the low nibble
    b = R.to(torch.int32)
    return torch.stack([b & 15, b >> 4], dim=-1).reshape(R.shape[0], -1)


def _validate(P, Q, grp, su, si, bias="lane", bu=None, bi=None, echo=1):
    if bias not in BIAS_FORMS:
        raise ValueError(f"dense_phase: bias must be one of {BIAS_FORMS}, "
                         f"got {bias!r}")
    check_echo(echo, bias)
    if (bias == "frozen") != (bu is not None and bi is not None):
        raise ValueError("dense_phase: bu and bi are given with "
                         "bias='frozen' and only then")
    dev = P.device
    nd = grp["sa"].shape[0]
    int8 = code_format(grp["R"]) == "int8"
    spec = {
        "P": (P, torch.float32, None), "Q": (Q, torch.float32, None),
        "sa": (grp["sa"], torch.int32, (nd,)),
        "sc": (grp["sc"], torch.int32, (nd,)),
        "R": (grp["R"], torch.int8 if int8 else torch.uint8,
              (nd, su, si if int8 else si // 2)),
        "du_s": (grp["du_s"], torch.float32, (nd, su)),
        "di_s": (grp["di_s"], torch.float32, (nd, si)),
    }
    if bias == "frozen":
        spec["bu"] = (bu, torch.float32, (P.shape[0],))
        spec["bi"] = (bi, torch.float32, (Q.shape[0],))
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


def check_echo(echo, bias):
    """The reference's checks of ``echo``: >= 1, and 1 in the frozen form
    (ValueError, NotImplementedError)."""
    if echo < 1:
        raise ValueError(f"dense_phase: echo must be >= 1, got {echo}")
    if echo > 1 and bias == "frozen":
        raise NotImplementedError(
            "dense echo > 1 requires lane-carried biases "
            "(sgd.bias_mode='lane') or use_bias=False: the frozen-bias "
            "post-phase update consumes single-pass E sums")


def dense_phase_plain(P, Q, grp, lr, reg, mu, *, su, si, bias="lane",
                      bu=None, bi=None, echo=1):
    """Plain PyTorch version: the same strata, one by one, each ``echo``
    times. Updates P and the group's item segment Q in place; returns the
    phase's SSE (first passes only), and in the frozen form ``(sse, (dbu,
    dbi))``: each stratum's row sums (ND, su) and column sums (ND, si) of
    E. ``bu`` and ``bi`` (frozen form) are read, never written."""
    check_echo(echo, bias)
    rank = P.shape[1]
    dev = P.device
    lane = bias == "lane"
    frozen = bias == "frozen"
    if lane:
        mP = torch.ones(rank, dtype=P.dtype, device=dev)
        mQ = torch.ones(rank, dtype=P.dtype, device=dev)
        mP[rank - 2] = 0.0
        mQ[rank - 1] = 0.0
    rfmt = code_format(grp["R"])
    inv = 1.0 / (R_SCALE if rfmt == "int8" else R4_SCALE)  # f32 in the op
    nd = grp["sa"].shape[0]
    if frozen:
        dbu = torch.empty(nd, su, dtype=torch.float32, device=dev)
        dbi = torch.empty(nd, si, dtype=torch.float32, device=dev)
    sse = torch.zeros((), dtype=torch.float32, device=dev)
    for s, (a, c) in enumerate(zip(grp["sa"].tolist(), grp["sc"].tolist())):
        Pb = P[a * su:(a + 1) * su]
        Qw = Q[c * si:(c + 1) * si]
        code = decode_codes(grp["R"][s], rfmt)
        du = grp["du_s"][s][:, None]
        di = grp["di_s"][s][:, None]
        s_u = torch.clamp(DSTAR / torch.clamp(du, min=1.0), max=1.0)
        s_i = torch.clamp(DSTAR / torch.clamp(di, min=1.0), max=1.0)
        for it in range(echo):
            S = Pb @ Qw.T
            X = code.to(torch.float32) * inv - S
            if frozen:  # the reference's: (((c·code − S) − bu) − bi) − μ
                X = ((X - bu[a * su:(a + 1) * su, None])
                     - bi[None, c * si:(c + 1) * si])
            E = torch.where(code > 0, X - mu,
                            torch.zeros((), dtype=torch.float32, device=dev))
            if it == 0:
                sse = sse + (E * E).sum()
            if frozen:
                dbu[s] = E.sum(1)
                dbi[s] = E.sum(0)
            gP = E @ Qw - reg * du * Pb
            gQ = E.T @ Pb - reg * di * Qw
            if lane:
                gP, gQ = gP * mP, gQ * mQ
            newP = Pb + lr * s_u * gP
            newQ = Qw + lr * s_i * gQ
            Pb.copy_(newP)
            Qw.copy_(newQ)
    return (sse, (dbu, dbi)) if frozen else sse


def bias_step(b, esum, deg, lr, reg):
    """One batched, trust-scaled bias step in place, the reference's
    ``b + lr·s·(ΣE − reg·deg·b)`` with s = min(1, DSTAR / max(deg, 1)):
    ``esum`` is each row's sum of residuals and ``deg`` its count of
    them. Rows with no residual keep their value."""
    s = torch.clamp(DSTAR / torch.clamp(deg, min=1.0), max=1.0)
    b.copy_(b + lr * s * (esum - reg * deg * b))


def dense_bias_update(bu, bi, grp, dbu, dbi, lr, reg, *, su, si):
    """The frozen form's batched bias update after a group: each stratum's
    row and column sums of E (:func:`dense_phase`'s ``(dbu, dbi)``) added
    per user row of ``bu`` (every user block) and per row of ``bi`` (the
    group's item segment) in stratum order, with
    :func:`kernels.packing.row_add` (strata share user blocks and
    windows), then :func:`bias_step` with the group's degree totals
    ``du_tot`` / ``di_tot``. Updates ``bu`` and ``bi`` in place."""
    esum_u = torch.zeros_like(bu)
    esum_i = torch.zeros_like(bi)
    row_add(esum_u, _block_rows(grp["sa"], su), dbu.reshape(-1))
    row_add(esum_i, _block_rows(grp["sc"], si), dbi.reshape(-1))
    bias_step(bu, esum_u, grp["du_tot"], lr, reg)
    bias_step(bi, esum_i, grp["di_tot"], lr, reg)


def group_totals(grp, user_rows, item_rows):
    """``{"du_tot", "di_tot"}``: the group's rating degrees per user row
    (``user_rows`` of them: every user block) and per row of its item
    segment (``item_rows``; ``sc`` is window-local), summed over its
    strata's ``du_s`` / ``di_s``: the degrees of the batched bias update
    after a frozen-bias group. Integer counts, exact in f32."""
    su, si = grp["du_s"].shape[1], grp["di_s"].shape[1]
    dev = grp["du_s"].device
    du_tot = torch.zeros(user_rows, dtype=torch.float32, device=dev)
    di_tot = torch.zeros(item_rows, dtype=torch.float32, device=dev)
    row_add(du_tot, _block_rows(grp["sa"], su), grp["du_s"].reshape(-1))
    row_add(di_tot, _block_rows(grp["sc"], si), grp["di_s"].reshape(-1))
    return {"du_tot": du_tot, "di_tot": di_tot}


def _block_rows(blocks, size):
    """Row ids of every row of each block in ``blocks``, flattened."""
    return (blocks.long()[:, None] * size
            + torch.arange(size, device=blocks.device)).reshape(-1)


def group_prefix(grp, n):
    """The group's first ``n`` strata, with the table that orders them and
    their degree totals."""
    per_group = ("deps", "du_tot", "di_tot")
    out = {k: v[:n].contiguous() for k, v in grp.items() if k not in per_group}
    if "deps" in grp:
        out["deps"] = grp["deps"].prefix(n)
    if "du_tot" in grp:
        out.update(group_totals(out, grp["du_tot"].shape[0],
                                grp["di_tot"].shape[0]))
    return out


def _apply_units(si, rank):
    """Q-apply units a stratum (csrc/dense_phase.cu's ``apply_rows``:
    256 rows a unit at ranks 32 and 64, 128 at rank 128; half where that
    does not divide si)."""
    rows = min(256, 256 * 64 // rank)
    return si // (rows if si % rows == 0 else rows // 2)


def dense_launch(lib, deps, nd, su, si, dev, blocks, rank, rfmt,
                 bias="lane"):
    """What the kernel takes beside the group and its scratch: ``(runs,
    wait, order, ring, grid)``. ``nd`` counts the launch's slots (strata
    times echo passes).

    ``runs`` / ``wait`` are the dependency table's and ``order`` the order
    in which the kernel hands the strata out, a list schedule of the table
    for the grid (``deps.list_order``); ``deps=None`` gives one dummy run,
    no waits and plan order, so each stratum waits for the one before.
    ``ring`` is the strata in flight the scratch holds; ``grid`` is
    ``blocks`` or, with ``blocks=None``, as many as the card holds at
    once of the (``rank``, ``rfmt``, ``bias``) instance, never more than
    there are units."""
    if deps is None:
        runs = torch.zeros((1, 2), dtype=torch.int32, device=dev)
        wait = order = None
    else:
        check_deps("dense_phase", deps, nd, dev)
        runs, wait = deps.runs, deps.wait
    if blocks is None:
        blocks = lib.mfx_dense_phase_max_blocks(
            rank, int(rfmt == "int8"), BIAS_FORMS.index(bias))
        if blocks < 1:
            raise RuntimeError(
                f"dense_phase: CUDA error {-blocks} sizing the grid")
    elif blocks < 1:
        raise ValueError(f"dense_phase: blocks must be >= 1, got {blocks}")
    nb = su // 64
    nq = _apply_units(si, rank)
    grid = min(int(blocks), max(1, nd * (nb * _PIECES + nq)))
    ring = max(1, min(_RING, nd))
    if deps is not None:
        # an apply unit reads 1/nq of the stratum's partials: ~1/10 of a
        # whole panel's time at 1024²
        order = deps.list_order(grid, nb * _PIECES, nq, 0.1 * _PIECES, ring)
    return runs, wait, order, ring, grid


def plan_launch(grp, su, si, rank, bias="lane", echo=1):
    """Work out, on the host, the order in which the kernel will hand out
    the group's strata at the card's grid (``deps.list_order``, kept on
    the table, which orders ``echo`` slots a stratum), as the first
    :func:`dense_phase` call on the card would: the trainer calls it at
    prep so that no epoch pays for it. Nothing to do on the CPU or without
    a table."""
    if grp["R"].device.type == "cuda" and "deps" in grp:
        dense_launch(_build.load_library(), grp["deps"],
                     grp["sa"].shape[0] * echo, su, si, grp["R"].device,
                     None, rank, code_format(grp["R"]), bias)


def dense_scratch(nd, su, si, ring, dev, rank):
    """The kernel's scratch for a group of ``nd`` strata at ``rank``:
    ``(state, ring_buf, dp_buf, sums)``. ``state`` is zeroed: the ticket,
    then per stratum its panels done, its apply units done and its end,
    then per panel its pieces done; ``ring_buf`` the ring of dQ partials
    and ``dp_buf`` that of the second pieces' dP (one slot a stratum in
    flight); ``sums`` the per-piece SSE, added up in unit order."""
    nb, nch, f32 = su // 64, si // 64, torch.float32
    state = torch.zeros(1 + 3 * nd + nd * nb, dtype=torch.int32, device=dev)
    ring_buf = torch.empty((ring, nb, si, rank), dtype=f32, device=dev)
    dp_buf = torch.empty((ring, nb, nch - nch // _PIECES + 1, 64, rank),
                         dtype=f32, device=dev)
    sums = torch.empty(max(1, nd * nb * _PIECES), dtype=f32, device=dev)
    return state, ring_buf, dp_buf, sums


def bias_scratch(nd, su, si, ring, dev):
    """The frozen form's outputs and scratch: ``(dbu, dbi, rs_buf,
    cs_buf)``, each stratum's row sums (ND, su) and column sums (ND, si)
    of E, then each panel piece's row sums and each panel's column sums,
    in the ring of strata in flight."""
    nb, f32 = su // 64, torch.float32
    return (torch.empty((nd, su), dtype=f32, device=dev),
            torch.empty((nd, si), dtype=f32, device=dev),
            torch.empty((ring, nb, _PIECES, 64), dtype=f32, device=dev),
            torch.empty((ring, nb, si), dtype=f32, device=dev))


def launch(lib, P, Q, grp, lr, reg, mu, su, si, runs, wait, order, ring,
           grid, bias="lane", bu=None, bi=None, echo=1):
    """One launch of the kernel on the group with the scheduler arguments
    of :func:`dense_launch` (``measure_wavefront`` also passes others) and
    fresh scratch. Returns the SSE (0-d f32), and in the frozen form
    ``(sse, (dbu, dbi))`` as :func:`dense_phase`."""
    nd, dev, rank = grp["sa"].shape[0], P.device, P.shape[1]
    state, ring_buf, dp_buf, sums = dense_scratch(nd * echo, su, si, ring,
                                                  dev, rank)
    frozen = bias == "frozen"
    dbu, dbi, rs_buf, cs_buf = (bias_scratch(nd, su, si, ring, dev)
                                if frozen else (None,) * 4)

    def ptr(x):
        return None if x is None else x.data_ptr()

    sse = torch.empty(1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.mfx_dense_phase(
        P.data_ptr(), Q.data_ptr(), grp["sa"].data_ptr(),
        grp["sc"].data_ptr(), grp["R"].data_ptr(), grp["du_s"].data_ptr(),
        grp["di_s"].data_ptr(), ptr(bu), ptr(bi), ptr(dbu), ptr(dbi),
        ptr(rs_buf), ptr(cs_buf), runs.data_ptr(), ptr(wait), ptr(order),
        state.data_ptr(), ring_buf.data_ptr(), dp_buf.data_ptr(),
        sums.data_ptr(), sse.data_ptr(), nd * echo, runs.shape[0], ring,
        grid, su, si, rank, int(code_format(grp["R"]) == "int8"),
        BIAS_FORMS.index(bias), echo, float(lr), float(reg), float(mu),
        stream,
    ), "dense_phase")
    return (sse[0], (dbu, dbi)) if frozen else sse[0]


def check_kernel_form(P, grp, su, si):
    """What the kernel is built for, in each of its bias forms: ranks 32
    and 64 with int4 or int8 codes, rank 128 with int8 codes (the
    reference's forms: it has no other dense rank and takes int8 only at
    rank 128), user blocks that are multiples of 64 and item windows that
    are multiples of 128; raises NotImplementedError otherwise."""
    rank, rfmt = P.shape[1], code_format(grp["R"])
    if (rank, rfmt) not in _FORMS or su % 64 or si % 128:
        raise NotImplementedError(
            "dense_phase kernel is built for ranks 32 and 64 (int4 or int8 "
            "codes) and rank 128 (int8), user blocks that are multiples of "
            "64 and item windows that are multiples of 128 (got rank "
            f"{rank}, {rfmt}, su={su}, si={si}); the reference's dense "
            "path has no other form"
        )


def dense_phase(P, Q, grp, lr, reg, mu, *, su, si, bias="lane", bu=None,
                bi=None, deps=None, blocks=None, echo=1):
    """One dense group. ``P`` is the padded user table (lane form for
    ``bias='lane'``, canonical otherwise); ``Q`` the group's item segment
    (a contiguous row range of the padded item table); ``grp`` holds
    ``sa``/``sc`` (ND,) int32 (``sc`` window-local), ``R`` the codes
    (int4: (ND, su, si/2) uint8; int8: (ND, su, si) int8) and the
    per-stratum degrees ``du_s`` (ND, su), ``di_s`` (ND, si). Updates P
    and Q in place; returns the phase's SSE (0-d f32).

    ``bias='frozen'`` takes the biases ``bu`` (one a row of P) and ``bi``
    (one a row of Q, the same segment), reads them and never writes them,
    and returns ``(sse, (dbu, dbi))``: each stratum's row sums (ND, su)
    and column sums (ND, si) of E, for :func:`dense_bias_update`.
    ``bias='none'``: no biases and no lane frozen.

    On the card the whole group is one launch on ``blocks`` thread blocks
    (default: as many as the card holds at once). ``deps`` is the group's
    dependency table (``grp["deps"]``, built at prep): with it strata
    that share neither a user block nor a window run at once; without it
    each stratum waits for the one before (its units still spread over
    the blocks). Tables and SSE are bit for bit the same either way and
    on any grid. The CPU route ignores both and walks the strata in plan
    order.

    ``echo`` (lane and bias-free forms): SGD passes a stratum, the SSE of
    the first. With ``deps`` the table must order ``echo`` slots a
    stratum (``grp["deps"].repeat(echo)``)."""
    _validate(P, Q, grp, su, si, bias, bu, bi, echo)
    if P.device.type == "cpu":
        return dense_phase_plain(P, Q, grp, lr, reg, mu, su=su, si=si,
                                 bias=bias, bu=bu, bi=bi, echo=echo)
    if P.device.type != "cuda":
        raise ValueError(f"dense_phase: no kernel for device {P.device}")
    check_kernel_form(P, grp, su, si)
    lib = _build.load_library()
    sched = dense_launch(lib, deps, grp["sa"].shape[0] * echo, su, si,
                         P.device, blocks, P.shape[1], code_format(grp["R"]),
                         bias)
    out = launch(lib, P, Q, grp, lr, reg, mu, su, si, *sched, bias=bias,
                 bu=bu, bi=bi, echo=echo)
    dense_phase.launches += 1
    dense_phase.form_launches[bias] += 1
    if echo > 1:
        dense_phase.echo_launches[bias] += 1
    return out


dense_phase.launches = 0
# the same launches by bias form, so that a run can show which form it took
dense_phase.form_launches = dict.fromkeys(BIAS_FORMS, 0)
# the launches with echo > 1, by bias form (counted above too)
dense_phase.echo_launches = dict.fromkeys(BIAS_FORMS, 0)
