"""Lane-bias table layout, the counterpart of ``to_lane_model`` and
``from_lane_model`` in ``mfx/kernels/packing.py``.

With ``bias_mode='lane'`` the biases ride in the factor lanes: P rows
become ``[p(rank-2), 1, bu]`` and Q rows ``[q(rank-2), bi, 1]``, so the
plain factor dot carries ``bu + bi`` and the bias lane's SGD step is the
bias update. The kernels keep plain ``(rows, rank)`` f32 tables, padded
with zero rows to a whole number of blocks, so that a block-local id plus
its block offset always addresses a row. The reference's rank packing to
128 lanes and its merged bias rows are TPU layout and have no counterpart.
"""

from __future__ import annotations

import torch

from mfx_torch.models.mf import MFModel

__all__ = ["to_lane_model", "from_lane_model", "pad_rows", "lane_tables"]


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
