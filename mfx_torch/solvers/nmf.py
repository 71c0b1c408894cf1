"""Weighted NMF (non-negative MF on the observed ratings), the counterpart
of ``mfx/solvers/nmf.py``.

Objective (no biases, no mean-centering: NMF models the raw ratings):

    min_{P,Q >= 0}  Σ_{(u,i)∈Ω} (r_ui − p_u·q_i)²
                    + reg Σ_u deg_u ‖p_u‖² + reg Σ_i deg_i ‖q_i‖²

The multiplicative update of a row needs exactly the ALS normal-equation
blocks, numerator ``b_u = Σ r_ui q_i`` and the Gram ``A_u = Σ q_i q_iᵀ``,
so each half-sweep reuses the Gram engine of ``solvers/als.py`` (the
degree-bucketed batched products, the sorted scatter-add, the device
chunks built once a run) and replaces the Cholesky solve with

    p  <-  p * b / (A p + lam p + eps)        (elementwise; lam = reg*deg)

a batched (rows, k, k) x (rows, k) product, ``inner_iters`` times on the
same (A, b). The update keeps the factors non-negative and never raises
the objective (A is PSD and b >= 0 for non-negative ratings).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch.profiler import record_function

from mfx_torch.config import NMFConfig
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.models.mf import MFModel
from mfx_torch.solvers.als import (SPANS, _side_inputs, accumulate_range,
                                   gram_rowchunk, sort_sides)

__all__ = ["nmf_half_sweep", "train_sweeps_nmf", "mu_update", "fold_nonneg",
           "check_nmf_inputs"]

_EPS = 1e-9


def mu_update(A, b, cnt, old, reg, *, inner_iters: int):
    """``inner_iters`` multiplicative updates on the fixed (A, b) blocks;
    rows with no ratings keep their factors."""
    lam = reg * cnt.clamp_min(1.0)
    p = old
    for _ in range(inner_iters):
        denom = torch.bmm(A, p[:, :, None])[:, :, 0] + lam[:, None] * p \
            + _EPS
        p = p * b / denom
    return torch.where(cnt[:, None] > 0, p, old)


def check_nmf_inputs(train: RatingsCOO, use_bias: bool) -> None:
    if use_bias:
        raise ValueError(
            "NMF is bias-free (it factorizes the raw non-negative ratings); "
            "set model.use_bias=false or use solver='als'/'sgd'"
        )
    if float(np.min(train.rating)) < 0.0:
        raise ValueError("NMF needs non-negative ratings")


def fold_nonneg(model: MFModel) -> MFModel:
    """Fold an MF init onto the non-negative orthant (floored at a small
    positive value so multiplicative updates can move every coordinate)
    and zero the mean and biases: NMF predicts ``p_u · q_i`` directly."""
    return MFModel(model.P.abs().clamp_min(1e-3),
                   model.Q.abs().clamp_min(1e-3),
                   torch.zeros_like(model.bu), torch.zeros_like(model.bi),
                   0.0)


def nmf_half_sweep(
    F_target,
    F_other,
    coo_rows,  # target-side id per rating (sorted by this)
    coo_cols,  # fixed-side id per rating (tensor or NumPy)
    coo_vals,  # ratings, >= 0
    reg: float,
    row_chunk: int = 8192,
    inner_iters: int = 2,
    plan=None,
    chunks=None,
):
    """Multiplicatively update one table against the other on the tables'
    device (``plan`` / ``chunks`` as for ``als.als_half_sweep``)."""
    num_rows, k = F_target.shape
    row_chunk = gram_rowchunk(k, row_chunk)
    cols, vals, chunks = _side_inputs(F_target, coo_rows, coo_cols, coo_vals,
                                      row_chunk, plan, chunks)
    f = F_target.dtype
    out = torch.empty_like(F_target)
    for r0, r1, ch in chunks:
        # mu = 0, no bias column: the targets are the raw ratings
        A, b, cnt = accumulate_range(F_other, vals, cols, ch, r1 - r0, f)
        with record_function(SPANS[2]):
            out[r0:r1] = mu_update(A, b, cnt, F_target[r0:r1], reg,
                                   inner_iters=inner_iters)
    return out


def train_sweeps_nmf(
    model: MFModel,
    train: RatingsCOO,
    cfg: NMFConfig,
    use_bias: bool = False,
    row_chunk: int | None = None,
    start_sweep: int = 0,
) -> Iterator[tuple[int, MFModel]]:
    """Alternate non-negative P and Q updates on the model's device; yields
    ``(sweep, model)`` from ``start_sweep``.

    A fresh run (``start_sweep == 0``) folds the incoming init onto the
    non-negative orthant and zeroes the mean and biases
    (:func:`fold_nonneg`); a resumed run takes its tables as they are, so
    it repeats the unbroken run bit for bit. ``use_bias`` must be False.
    """
    check_nmf_inputs(train, use_bias)
    row_chunk = row_chunk or cfg.user_chunk
    if start_sweep == 0:
        model = fold_nonneg(model)
    (uc, uv, up, uch), (ic, iv, ip, ich) = sort_sides(
        model, train, gram_rowchunk(model.rank, row_chunk))
    for sweep in range(start_sweep, cfg.sweeps):
        P = nmf_half_sweep(model.P, model.Q, None, uc, uv, cfg.reg,
                           row_chunk=row_chunk, inner_iters=cfg.inner_iters,
                           plan=up, chunks=uch)
        model = MFModel(P, model.Q, model.bu, model.bi, model.mu)
        Q = nmf_half_sweep(model.Q, model.P, None, ic, iv, cfg.reg,
                           row_chunk=row_chunk, inner_iters=cfg.inner_iters,
                           plan=ip, chunks=ich)
        model = MFModel(model.P, Q, model.bu, model.bi, model.mu)
        yield sweep, model
