"""The kernels' table forms, the counterpart of ``pack_state``,
``to_lane_model`` and ``from_lane_model`` in ``mfx/kernels/packing.py``.

The kernels keep plain ``(rows, rank)`` f32 tables, padded with zero rows
to a whole number of blocks, so that a block-local id plus its block
offset always addresses a row. Two forms:

- lane (``bias_mode='lane'``, :func:`lane_tables`): the biases ride in the
  factor lanes: P rows become ``[p(rank-2), 1, bu]`` and Q rows
  ``[q(rank-2), bi, 1]``, so the plain factor dot carries ``bu + bi`` and
  the bias lane's SGD step is the bias update;
- plain (``bias_mode='tile'`` or no biases, :func:`plain_tables`): the
  canonical P and Q, with ``bu`` and ``bi`` as padded vectors beside them;
- time-lane (blocked timeSVD, :func:`to_tlane_model`): with L = rank - 3 -
  n_bins latent dims, P rows ``[p(L), 0 x n_bins, alpha, 1, bu]`` and Q
  rows ``[q(L), bt(n_bins), 0, bi, 1]``.

The reference's rank packing to 128 lanes and its merged bias rows are TPU
layout and have no counterpart (``mfx_torch.convert`` reads and writes
that layout for the tests).
"""

from __future__ import annotations

import torch

from mfx_torch.models.mf import MFModel
from mfx_torch.models.timesvd import TimeSVDModel

__all__ = ["to_lane_model", "from_lane_model", "to_tlane_model",
           "from_tlane_model", "pad_rows", "lane_tables", "plain_tables",
           "row_add"]


def to_lane_model(model: MFModel) -> MFModel:
    """Canonical model -> lane form (bu/bi zeroed, the two reserved factor
    columns' values discarded)."""
    r = model.rank
    P = model.P.clone()
    Q = model.Q.clone()
    P[:, r - 2] = 1.0
    P[:, r - 1] = model.bu
    Q[:, r - 2] = model.bi
    Q[:, r - 1] = 1.0
    return MFModel(P, Q, torch.zeros_like(model.bu),
                   torch.zeros_like(model.bi), mu=model.mu)


def from_lane_model(model: MFModel) -> MFModel:
    """Inverse of :func:`to_lane_model`: biases out of the reserved lanes,
    which are zeroed in the returned factor tables."""
    r = model.rank
    bu = model.P[:, r - 1].clone()
    bi = model.Q[:, r - 2].clone()
    P = model.P.clone()
    Q = model.Q.clone()
    P[:, r - 2:] = 0.0
    Q[:, r - 2:] = 0.0
    return MFModel(P, Q, bu, bi, mu=model.mu)


def to_tlane_model(ts_model, n_bins: int) -> MFModel:
    """``TimeSVDModel`` -> the time-lane form (bu/bi zeroed; the reserved
    columns' values discarded: the form trains L = rank - 3 - n_bins latent
    dims). :func:`from_tlane_model` inverts it exactly."""
    r = ts_model.rank
    L = r - 3 - n_bins
    if L < 1:
        raise ValueError(f"time-lane layout needs rank > n_bins + 3 (rank "
                         f"{r}, n_bins {n_bins})")
    P = ts_model.P.clone()
    Q = ts_model.Q.clone()
    P[:, L:L + n_bins] = 0.0
    P[:, r - 3] = ts_model.alpha
    P[:, r - 2] = 1.0
    P[:, r - 1] = ts_model.bu
    Q[:, L:L + n_bins] = ts_model.bt
    Q[:, r - 3] = 0.0
    Q[:, r - 2] = ts_model.bi
    Q[:, r - 1] = 1.0
    return MFModel(P, Q, torch.zeros_like(ts_model.bu),
                   torch.zeros_like(ts_model.bi), mu=ts_model.mu)


def from_tlane_model(model: MFModel, n_bins: int):
    """Inverse of :func:`to_tlane_model`: bu, bi, alpha and bt out of the
    reserved lanes into a ``TimeSVDModel`` whose reserved factor columns
    are zero (its full-rank dot is the L-dim one)."""
    r = model.rank
    L = r - 3 - n_bins
    P = model.P.clone()
    Q = model.Q.clone()
    P[:, L:] = 0.0
    Q[:, L:] = 0.0
    return TimeSVDModel(P, Q, model.P[:, r - 1].clone(),
                        model.Q[:, r - 2].clone(), model.mu,
                        model.Q[:, L:L + n_bins].clone(),
                        model.P[:, r - 3].clone())


def pad_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad the leading dim of ``x`` up to a multiple of ``block``."""
    rows = -(-x.shape[0] // block) * block
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    out[: x.shape[0]] = x
    return out


def lane_tables(model: MFModel, su: int, si: int, device):
    """Canonical model -> the kernels' state on ``device``: lane-form P
    padded to A·su rows and Q to C·si rows (fresh, contiguous tensors)."""
    lane = to_lane_model(model)
    return pad_rows(lane.P.to(device), su), pad_rows(lane.Q.to(device), si)


def plain_tables(model: MFModel, su: int, si: int, device):
    """Canonical model -> the tile-bias kernels' state on ``device``:
    ``(P, Q, bu, bi)`` with P and bu padded to A·su rows, Q and bi to C·si
    (fresh, contiguous f32 tensors; no lane is rewritten). The inverse is
    the slice ``[:U]`` / ``[:I]``."""
    return (pad_rows(model.P.to(device), su), pad_rows(model.Q.to(device), si),
            pad_rows(model.bu.to(device), su), pad_rows(model.bi.to(device), si))


def row_add(table, rows, delta):
    """``table[rows] += delta``, duplicate rows summed, in an order that
    repeats from run to run on either device: on the CPU ``index_add_``
    walks the slots in order (``index_put_`` accumulates from several
    threads there); on CUDA ``index_put_(accumulate=True)`` sorts, where
    ``index_add_`` uses float atomics. The sweeps' plain versions add
    every delta with it."""
    if table.device.type == "cpu":
        table.index_add_(0, rows, delta)
    else:
        table.index_put_((rows,), delta, accumulate=True)
