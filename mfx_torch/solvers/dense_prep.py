"""Dense-stratum carving and the R image, the counterpart of
``auto_dense_threshold``, ``prepare_dense_full`` (full item span) and
``prepare_dense_device`` (the head-only split) in
``mfx/solvers/dense_prep.py``.

Once per run, the strata whose rating count reaches the threshold are
carved out of the training set and densified on the device into an image
of rating codes; each epoch runs them densely (``kernels.dense_phase``)
before the sparse sweeps take the remainder. Strata are grouped by
segments of ``nwd`` item windows and ordered group, then user block, then
window, as the reference orders them; the sparse remainder keeps its
original order (the planner's random key is indexed by position in it).

The image keeps the reference's codes — int4 ``round(2 r)`` clipped to
0..15, int8 ``round(25 r)`` clipped to 0..127, 0 = absent, duplicate
(u, i) cells averaged first — in a plain layout: ``(ND, su, si/2)`` uint8
for int4 with the even column in the low nibble, ``(ND, su, si)`` int8 for
int8. The reference's decimated parity layout is TPU layout and is gone.
"""

from __future__ import annotations

import numpy as np
import torch

from mfx_torch.kernels.dense_phase import R4_SCALE, R_SCALE, group_totals
from mfx_torch.kernels.plan_device import sweep_deps

__all__ = ["auto_dense_threshold", "prepare_dense_full",
           "prepare_dense_device"]

# The reference's carving policy (mfx/solvers/dense_prep.py), copied so
# that both packages carve the same strata. They model the reference's
# dense and sparse phases, not this port's kernels: they are to be
# re-measured for the port (ROADMAP, Queue 1 item 8).
AUTO_STREAM_GBPS = 122.0
AUTO_FIXED_US = 4.5
AUTO_SPARSE_NS = 7.0
AUTO_SPARSE_FIXED_MS = 6.5
_SLOT_BYTES = {"int4": 0.5, "int8": 1.0}


def auto_dense_threshold(counts: np.ndarray, su: int, si: int, rfmt: str) -> float:
    """Cost-model eligibility threshold (ratings per stratum): a stratum
    runs densely iff its count exceeds the breakeven between streaming
    its R image and running its ratings sparsely; if the strata below
    breakeven would save less than the sparse phase's fixed cost, every
    non-empty stratum goes dense (threshold 1.0)."""
    slot = _SLOT_BYTES.get(rfmt, 4.0)
    t_dense = su * si * slot / (AUTO_STREAM_GBPS * 1e9) + AUTO_FIXED_US * 1e-6
    t_sparse = AUTO_SPARSE_NS * 1e-9
    breakeven = t_dense / t_sparse
    nz = counts[counts > 0]
    below = nz[nz < breakeven]
    savings = float((t_dense - below * t_sparse).sum())
    if savings <= AUTO_SPARSE_FIXED_MS * 1e-3:
        return 1.0
    return float(breakeven)


def _dense_thresh(chi_min: float, counts, su, si, rfmt) -> float:
    if chi_min < 0:
        return auto_dense_threshold(counts, su, si, rfmt)
    return max(1.0, chi_min * su * si)


def _build_r_image(st, lu, li, rd, nd, su, si, rfmt):
    """Dedup-averaged code image of the dense ratings (stratum ``st``,
    block-local ``lu``/``li``). Cells are sorted, duplicates summed by a
    float64 prefix sum (exact for star-scale ratings) and averaged in
    f32, as the reference's segment mean does."""
    dev = st.device
    key = (st * su + lu) * si + li
    key_s, order = torch.sort(key, stable=True)
    cell, cnt = torch.unique_consecutive(key_s, return_counts=True)
    cs = torch.cumsum(rd[order].to(torch.float64), 0)
    ends = torch.cumsum(cnt, 0) - 1
    rsum = cs[ends] - torch.cat([cs.new_zeros(1), cs[ends[:-1]]])
    avg = rsum.to(torch.float32) / cnt.to(torch.float32)
    if rfmt == "int8":
        img = torch.zeros(nd * su * si, dtype=torch.int8, device=dev)
        img[cell] = torch.clamp(torch.round(avg * R_SCALE), 0, 127).to(torch.int8)
        return img.view(nd, su, si)
    code = torch.clamp(torch.round(avg * R4_SCALE), 0, 15).to(torch.uint8)
    byte = cell // 2  # si is even: a byte never straddles two rows
    odd = (cell % 2) == 1
    img = torch.zeros(nd * su * (si // 2), dtype=torch.uint8, device=dev)
    img[byte[~odd]] = code[~odd]
    b_odd = byte[odd]
    img[b_odd] = img[b_odd] | (code[odd] << 4)
    return img.view(nd, su, si // 2)


def prepare_dense_full(
    u: torch.Tensor,
    i: torch.Tensor,
    r: torch.Tensor,
    num_users: int,
    num_items: int,
    su: int,
    si: int,
    chi_min: float,
    nwd: int,
    rfmt: str = "int4",
    spg: int = 1,
):
    """Full-item-span dense split on the ratings' device.

    Returns ``(dense_meta, dense_groups, (u_sp, i_sp, r_sp), info)``:
    ``dense_meta`` a tuple of (win0, nwin) per non-empty group,
    ``dense_groups`` the matching dicts {``sa``, ``sc`` (window-local),
    ``R``, ``du_s``, ``di_s``, ``du_tot``, ``di_tot``, ``deps``}, and the
    sparse remainder in its original order. ``du_s``/``di_s`` count raw
    ratings, duplicates included, per stratum; ``du_tot`` (A·su,) and
    ``di_tot`` (nw·si,) count the group's ratings per user row and per row
    of its item segment (the frozen-bias update after the group). ``deps`` is the group's dependency table
    (``plan_device.sweep_deps`` with one "tile" a stratum): two strata
    conflict only if they share a user block or a window, and the group's
    strata lie in (user block, window) order, the runs' layout, so the
    table orders what ``kernels.dense_phase`` may run at once.

    ``spg`` (``sgd.dense_spg``) changes no stratum. The reference pads
    each (group, user block) run of strata to a multiple of ``spg`` with
    null strata (no codes, no degrees: exact no-ops) for its grid steps of
    ``spg`` strata; the kernel here takes one stratum a unit, so the
    groups are the ``spg=1`` groups and ``info`` only counts the slots the
    reference's padding would hold (``strata_padded``) and holds ``spg``.
    ``r_stream_bytes`` counts the image carved here, without padding. The
    threshold does not depend on ``spg`` (the reference's measured cost
    model)."""
    if rfmt not in ("int4", "int8"):
        raise ValueError(f"rfmt must be 'int4' or 'int8', got {rfmt!r}")
    if spg < 1:
        raise ValueError(f"spg must be >= 1, got {spg}")
    A, C, strat, counts = _strata_counts(u, i, num_users, num_items, su, si)
    thresh = _dense_thresh(chi_min, counts, su, si, rfmt)
    idx = np.flatnonzero(counts >= thresh)
    out = _carve(u, i, r, strat, idx, A, C, su, si, nwd, rfmt)
    if out[1]:
        # each (group, user block) run of strata rounded up to spg
        _, runs = np.unique((idx % C) // nwd * A + idx // C,
                            return_counts=True)
        out[3].update({
            "strata_padded": int((-(-runs // spg) * spg).sum()),
            "spg": spg,
            "thresh_ratings": float(thresh),
            "chi_effective": float(thresh) / (su * si),
        })
    return out


def prepare_dense_device(
    u: torch.Tensor,
    i: torch.Tensor,
    r: torch.Tensor,
    num_users: int,
    num_items: int,
    su: int,
    si: int,
    chi_min: float,
    nwin_head: int,
    rfmt: str = "int4",
):
    """The head-only dense split (``sgd.dense_span='head'``), the
    counterpart of the reference's ``prepare_dense_device``: the strata of
    at least ``max(1, chi_min·su·si)`` ratings whose window is one of the
    first ``nwin_head`` (the trainer's ``ceil(8192 / si)``, at most the
    item windows), one dense group over those windows, strata in (user
    block, window) order. Returns what :func:`prepare_dense_full` returns
    (one group, or none), with ``info`` {``dense_frac``, ``num_strata``,
    ``r_stream_bytes``} as the reference's."""
    if rfmt not in ("int4", "int8"):
        raise ValueError(f"rfmt must be 'int4' or 'int8', got {rfmt!r}")
    A, C, strat, counts = _strata_counts(u, i, num_users, num_items, su, si)
    nwin_head = min(nwin_head, C)
    eligible = (counts >= max(1.0, chi_min * su * si)).reshape(A, C)
    eligible[:, nwin_head:] = False
    idx = np.flatnonzero(eligible.reshape(-1))
    meta, groups, sparse, info = _carve(u, i, r, strat, idx, A, C, su, si,
                                        nwin_head, rfmt)
    keep = ("dense_frac", "num_strata", "r_stream_bytes")
    return meta, groups, sparse, {k: v for k, v in info.items() if k in keep}


def _strata_counts(u, i, num_users, num_items, su, si):
    """Blocks, windows, each rating's stratum and the ratings a stratum."""
    if su != si:
        raise ValueError("dense path requires su == si")
    A = -(-num_users // su)
    C = -(-num_items // si)
    strat = (u.long() // su) * C + i.long() // si
    counts = torch.bincount(strat, minlength=A * C).cpu().numpy()
    return A, C, strat, counts


def _carve(u, i, r, strat, idx, A, C, su, si, nwd, rfmt):
    """Carve the strata ``idx`` (flat ids a·C + c) out of the ratings into
    groups of ``nwd`` windows (see :func:`prepare_dense_full`)."""
    if idx.size == 0:
        return (), (), (u, i, r), {"dense_frac": 0.0}
    dev = u.device
    a_s, c_s = idx // C, idx % C
    g_s = c_s // nwd
    order = np.lexsort((c_s, a_s, g_s))  # groups contiguous, (a, c) inside
    idx, a_s, c_s, g_s = idx[order], a_s[order], c_s[order], g_s[order]
    nd = len(idx)
    ngr = -(-C // nwd)
    gb = np.searchsorted(g_s, np.arange(ngr + 1))

    remap = np.full(A * C, -1, np.int64)
    remap[idx] = np.arange(nd)
    st_full = torch.as_tensor(remap, device=dev)[strat]
    dense_mask = st_full >= 0
    dpos = torch.nonzero(dense_mask).squeeze(1)  # ascending: stable split
    spos = torch.nonzero(~dense_mask).squeeze(1)
    u_sp, i_sp, r_sp = u[spos], i[spos], r[spos]

    st = st_full[dpos]
    lu = u.long()[dpos] % su
    li = i.long()[dpos] % si
    du_s = torch.bincount(st * su + lu, minlength=nd * su).view(nd, su)
    di_s = torch.bincount(st * si + li, minlength=nd * si).view(nd, si)
    R = _build_r_image(st, lu, li, r[dpos], nd, su, si, rfmt)

    sa_all = torch.as_tensor(a_s.astype(np.int32), device=dev)
    sc_all = torch.as_tensor((c_s - g_s * nwd).astype(np.int32), device=dev)
    dense_meta, dense_groups = [], []
    for g in range(ngr):
        lo, hi = int(gb[g]), int(gb[g + 1])
        if hi == lo:
            continue
        win0 = g * nwd
        nw = min(nwd, C - win0)
        tp = np.zeros((A, nw), np.int64)
        tp[a_s[lo:hi], c_s[lo:hi] - win0] = 1
        dense_meta.append((win0, nw))
        dense_groups.append({
            "sa": sa_all[lo:hi],
            "sc": sc_all[lo:hi],
            "R": R[lo:hi],
            "du_s": du_s[lo:hi].to(torch.float32),
            "di_s": di_s[lo:hi].to(torch.float32),
            "deps": sweep_deps(tp, tp.sum(1), dev),
        })
        dense_groups[-1].update(group_totals(dense_groups[-1], A * su,
                                             nw * si))
    n_dense = int(dpos.shape[0])
    info = {
        "dense_frac": n_dense / max(1, int(u.shape[0])),
        "num_strata": nd,
        "num_groups": len(dense_groups),
        "r_stream_bytes": int(R.numel() * R.element_size()),
    }
    return tuple(dense_meta), tuple(dense_groups), (u_sp, i_sp, r_sp), info
