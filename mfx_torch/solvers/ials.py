"""iALS, implicit-feedback weighted ALS (Hu, Koren, Volinsky 2008), the
counterpart of ``mfx/solvers/ials.py``.

Objective (bias-free): with binary preference ``p_ui = 1`` iff observed
and confidence ``c_ui = 1 + alpha·r_ui`` (unobserved cells c = 1, p = 0),

    min Σ_{u,i} c_ui (p_ui − x_uᵀ y_i)² + λ (Σ‖x_u‖² + Σ‖y_i‖²)

whose per-row normal equations split into a catalog term and the
observed entries only:

    A_u = YᵀY + Σ_{i∈Ω(u)} (c_ui − 1) y_i y_iᵀ + λI,   b_u = Σ_{i∈Ω(u)} c_ui y_i

``YᵀY`` is one (k, k) product a half-sweep; the observed-entry
corrections reuse the Gram engine of ``solvers/als.py`` (bucketed pieces,
``torch.bmm``, the sorted scatter-add through ``row_add``, the device
chunks built once a run) with the gathered rows scaled by sqrt(alpha·r),
so the same self-product gives the weighted Gram. Rows solve in bounded
ranges with a batched Cholesky (``cholesky_ex``, no host sync). A row is
solved when its ``b`` has any non-zero entry (the reference's rule, which
differs from ALS's degree > 0); other rows keep their factors.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch.profiler import record_function

from mfx_torch.config import IALSConfig
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.kernels.packing import row_add
from mfx_torch.models.mf import MFModel
from mfx_torch.solvers.als import (SPANS, _side_inputs, gram_rowchunk,
                                   sort_sides)

__all__ = ["ials_half_sweep", "train_sweeps_ials",
           "weighted_gram_accumulate", "check_ials_inputs"]


def _wgram_chunk(F_other, alpha, cols, vals, rows_rel, starts, lens, A, b,
                 cap):
    with record_function(SPANS[0]):
        nb = rows_rel.shape[0]
        k = F_other.shape[1]
        lane = torch.arange(cap, dtype=starts.dtype, device=starts.device)
        idx = (starts[:, None] + lane[None, :]).clamp_(0, cols.shape[0] - 1)
        mask = (lane[None, :] < lens[:, None]).to(F_other.dtype)
        y = F_other[cols[idx].reshape(-1)].reshape(nb, cap, k)
        w = alpha * vals[idx] * mask  # c_ui − 1, masked
        yw = y * torch.sqrt(w)[:, :, None]
        A_p = torch.bmm(yw.transpose(1, 2), yw)
        b_p = torch.bmm(((1.0 + w) * mask)[:, None, :],
                        y * mask[:, :, None])[:, 0, :]
    with record_function(SPANS[1]):
        row_add(A, rows_rel, A_p)
        row_add(b, rows_rel, b_p)


def weighted_gram_accumulate(F_other, alpha, cols, vals, rows_rel, starts,
                             lens, A, b, *, cap: int):
    """Observed-entry corrections of one chunk, in place: with confidence
    c = 1 + alpha·v, ``A += Σ (c−1) y yᵀ`` (a sqrt-scaled self-product,
    exact for v >= 0) and ``b += Σ c·y``. Returns (A, b)."""
    dev = A.device
    rows_rel = torch.as_tensor(rows_rel).to(dev, torch.int64)
    starts = torch.as_tensor(starts).to(dev, torch.int64)
    lens = torch.as_tensor(lens).to(dev, A.dtype)
    _wgram_chunk(F_other, float(alpha), cols, vals, rows_rel, starts, lens,
                 A, b, cap)
    return A, b


def _solve_wgram(A, b, G, old, reg):
    """x = (G + A + λI)⁻¹ b a row; rows whose ``b`` is all zero keep
    ``old``. ``A`` is consumed (G and λ added in place). As in the ALS
    solve, ``cholesky_ex`` without its check: a NaN comes through to the
    caller rather than raising."""
    with record_function(SPANS[2]):
        A.add_(G[None])
        A.diagonal(dim1=-2, dim2=-1).add_(reg)
        L, _ = torch.linalg.cholesky_ex(A)
        sol = torch.cholesky_solve(b[..., None], L)[..., 0]
        touched = (b != 0.0).any(dim=1)
        return torch.where(touched[:, None], sol, old)


def ials_half_sweep(
    F_target,  # (rows, k) table being solved
    F_other,  # (rows_other, k) fixed table
    coo_rows,  # target-side id per rating (sorted by this)
    coo_cols,  # fixed-side id per rating (tensor or NumPy)
    coo_vals,  # feedback strengths
    alpha: float,
    reg: float,
    row_chunk: int = 8192,
    plan=None,
    chunks=None,
):
    """Solve one table against the other (confidence-weighted) on the
    tables' device (``plan`` / ``chunks`` as for ``als.als_half_sweep``)."""
    num_rows, k = F_target.shape
    row_chunk = gram_rowchunk(k, row_chunk)
    cols, vals, chunks = _side_inputs(F_target, coo_rows, coo_cols, coo_vals,
                                      row_chunk, plan, chunks)
    f = F_target.dtype
    dev = F_target.device
    alpha = float(alpha)  # a Python scalar: no host-to-device copy
    G = F_other.T @ F_other
    out = torch.empty_like(F_target)
    for r0, r1, ch in chunks:
        nseg = (r1 - r0) + 1  # +1: pad pieces target the spare last segment
        A = torch.zeros((nseg, k, k), dtype=f, device=dev)
        b = torch.zeros((nseg, k), dtype=f, device=dev)
        for cap, rows_rel, starts, lens in ch:
            _wgram_chunk(F_other, alpha, cols, vals, rows_rel, starts, lens,
                         A, b, cap)
        out[r0:r1] = _solve_wgram(A[: r1 - r0], b[: r1 - r0], G,
                                  F_target[r0:r1], reg)
    return out


def check_ials_inputs(train: RatingsCOO, use_bias: bool) -> None:
    """The reference's validation of the iALS trainers."""
    if use_bias:
        raise ValueError(
            "iALS is bias-free (binary preference target); set "
            "model.use_bias=false or use solver='als' for explicit ratings"
        )
    if float(np.min(train.rating)) < 0.0:
        raise ValueError(
            "iALS needs non-negative feedback strengths (confidence "
            "c = 1 + alpha*r is accumulated via sqrt(alpha*r); a negative "
            "r would silently produce NaN factors) — shift/clip the "
            "ratings or use solver='als'/'sgd' for signed explicit data"
        )


def train_sweeps_ials(
    model: MFModel,
    train: RatingsCOO,
    cfg: IALSConfig,
    use_bias: bool = False,
    row_chunk: int | None = None,
    start_sweep: int = 0,
) -> Iterator[tuple[int, MFModel]]:
    """Alternate P and Q confidence-weighted solves on the model's device;
    yields ``(sweep, model)`` from ``start_sweep`` (a resumed run repeats
    the unbroken run bit for bit). ``use_bias`` must be False."""
    check_ials_inputs(train, use_bias)
    row_chunk = row_chunk or cfg.user_chunk
    (uc, uv, up, uch), (ic, iv, ip, ich) = sort_sides(
        model, train, gram_rowchunk(model.rank, row_chunk))
    for sweep in range(start_sweep, cfg.sweeps):
        P = ials_half_sweep(model.P, model.Q, None, uc, uv, cfg.alpha,
                            cfg.reg, row_chunk=row_chunk, plan=up,
                            chunks=uch)
        model = MFModel(P, model.Q, model.bu, model.bi, model.mu)
        Q = ials_half_sweep(model.Q, model.P, None, ic, iv, cfg.alpha,
                            cfg.reg, row_chunk=row_chunk, plan=ip,
                            chunks=ich)
        model = MFModel(model.P, Q, model.bu, model.bi, model.mu)
        yield sweep, model
