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
           "row_add", "segment_row_add", "bf16_order", "bf16_row_add",
           "GRAPH_LAUNCHES"]


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


def row_add(table, rows, delta, order=None):
    """``table[rows] += delta``, duplicate rows summed, in an order that
    repeats from run to run on either device: on the CPU ``index_add_``
    walks the slots in order (``index_put_`` accumulates from several
    threads there); on CUDA ``index_put_(accumulate=True)`` sorts, where
    ``index_add_`` uses float atomics. The sweeps' plain versions add
    every delta with it.

    bf16 tables go through :func:`bf16_row_add` (``order``: the rows'
    :func:`bf16_order`, where the caller shares it between tables)."""
    if table.dtype == torch.bfloat16:
        bf16_row_add(table, rows, delta, order)
        return
    if table.device.type == "cpu":
        table.index_add_(0, rows, delta)
    else:
        table.index_put_((rows,), delta, accumulate=True)


def segment_row_add(table, rows, delta):
    """:func:`row_add` for deltas that share few rows many times (a COO's
    user or item column), in the order ``index_add_`` takes on the CPU:
    each row's value, then its deltas in slot order. The rows are sorted
    stably; each row's current value and its deltas are laid out as one
    segment and summed in order (``torch.segment_reduce``: on the card one
    thread a lane of a row, no float atomics), and the sums are written
    back once a row. On the card ``index_put_`` walks a run of one row
    serially, and a Zipf-hot item holds tens of thousands of ratings; here
    no row repeats in a scatter. Each device repeats its bits; a 2-D
    table gets ``index_add_``'s bits on either (the card sums a lane in
    order), a 1-D one may sum another way on the card. f32 tables."""
    srows, order = torch.sort(rows, stable=True)
    uniq, counts = torch.unique_consecutive(srows, return_counts=True)
    m, n = uniq.shape[0], rows.shape[0]
    seg = torch.repeat_interleave(
        torch.arange(m, device=rows.device), counts, output_size=n)
    starts = torch.cumsum(counts + 1, 0) - (counts + 1)
    ext = delta.new_empty((n + m,) + tuple(delta.shape[1:]))
    ext[starts] = table.index_select(0, uniq)
    ext[torch.arange(n, device=rows.device) + seg + 1] = delta.index_select(
        0, order)
    table.index_copy_(0, uniq, torch.segment_reduce(ext, "sum",
                                                     lengths=counts + 1))


def bf16_order(table, rows):
    """The order in which :func:`bf16_row_add` adds into ``table`` on the
    card: ``(rows sorted stably, their slots)``, to be shared by the
    tables that take the same rows (P and bu, Q and bi); None where no
    kernel takes it (f32 tables, the CPU)."""
    if table.dtype != torch.bfloat16 or table.device.type != "cuda":
        return None
    return torch.sort(rows.long(), stable=True)


def bf16_row_add(table, rows, delta, order=None):
    """``row_add`` of a bf16 table: each delta added on its own, the sum
    rounded to bf16, duplicate rows in slot order, as the reference's bf16
    scatter adds them. On the CPU, the plain version: ``index_add_`` on
    the table's flat view, one element a delta (on a 2-D table it would
    sum duplicate rows in f32 and round once). On CUDA it launches
    ``csrc/row_add_bf16.cu`` (``index_put_`` does not keep the order
    there) on the rows sorted stably (``order``, else sorted here), or
    raises."""
    width = table.shape[1] if table.dim() > 1 else 1
    if table.device.type == "cpu":
        if table.dim() > 1:
            lanes = torch.arange(width, device=rows.device)
            rows = (rows[:, None] * width + lanes).reshape(-1)
            table, delta = table.view(-1), delta.reshape(-1)
        table.index_add_(0, rows, delta)
        return
    if table.device.type != "cuda":
        raise ValueError(f"bf16_row_add: no kernel for device {table.device}")
    from mfx_torch.kernels import _build

    if (table.dim() > 2 or not table.is_contiguous()
            or delta.dtype != torch.bfloat16):
        raise ValueError("bf16_row_add: a contiguous 1-D or 2-D bf16 table "
                         "and bf16 deltas")
    srows, slots = order if order is not None else torch.sort(
        rows.long(), stable=True)
    delta = delta.contiguous()
    _build.check(_build.load_library().mfx_row_add_bf16(
        table.data_ptr(), srows.data_ptr(), slots.data_ptr(),
        delta.data_ptr(), srows.shape[0], width,
        torch.cuda.current_stream(table.device).cuda_stream),
        "bf16_row_add")
    bf16_row_add.launches += 1


bf16_row_add.launches = 0

# bf16_row_add's launches in captured steps (bf16 tables on the card,
# ``solvers.capture.CapturedLoop``): the wrapper counts a launch as it
# records it into a graph ("captured"); each replay of the graph launches
# the kernel again, unseen by the wrapper ("replayed", counted where the
# step is replayed). The kernel's launches are the wrapper's count -
# captured + replayed.
GRAPH_LAUNCHES = {"captured": 0, "replayed": 0}
