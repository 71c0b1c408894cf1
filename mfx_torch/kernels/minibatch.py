"""Minibatch SGD step, the counterpart of ``mfx/kernels/jnp_ref.py``
(``sgd_compute_deltas``, ``sgd_apply_deltas``, ``sgd_minibatch_update``,
``batch_sq_error``).

The reference writes this step in plain XLA, not Pallas, so stock torch
ops are its port: gather the factor rows, the dot-product residual with
bias and L2 terms, rank-1 deltas, and a segment-summed scatter-add.
Minibatch semantics: every read comes from the batch-entry snapshot of
``(P, Q, bu, bi)``; per-row deltas are summed and applied once. With
``batch_size=1`` this is the sequential update of the Java oracle
(``mfx_torch.oracle``).

Padded slots (weight 0) may carry out-of-range sentinel ids
(``num_rows + slot``, ``mfx_torch.data.partition.pad_to_batches``). The
reference gathers with ``mode='clip'`` and scatters with ``mode='drop'``.
Here the scatter goes into the tables extended by ``B`` zero sink rows,
which are cut off again: a pad's delta lands in a row of its own (no
long run of duplicates for the sorted scatter to walk, and no boolean
filtering, which on the card would be a host sync a batch). The
trainer's loop also gathers a pad's row from its sink; a pad's weight 0
makes its error, squared error and deltas exactly zero whatever row it
reads. Every scatter-add goes through ``kernels.packing.row_add``, whose
order repeats from run to run on either device (``partitioner='fixed'``
puts duplicate rows in a batch).

The tables are updated in place; the functions that take an ``MFModel``
clone them first and return a new one, as the reference's return new
arrays.
"""

from __future__ import annotations

import torch

from mfx_torch.kernels.packing import row_add
from mfx_torch.models.mf import MFModel

__all__ = [
    "sgd_minibatch_update",
    "sgd_compute_deltas",
    "sgd_apply_deltas",
    "batch_sq_error",
    "PAD_COUNT_ID",
]

# the id a padded slot counts as in ``dup_trust``'s duplicate counts (the
# reference's ``0x3FFFFFFF``): pads must not inflate a real row's count
PAD_COUNT_ID = 0x3FFFFFFF


def as_f32(x, device) -> torch.Tensor:
    """A Python float (or 0-d tensor) as an f32 0-d tensor on ``device``:
    the reference's ``jnp.asarray(lr, P.dtype)``. A float is filled in on
    the device (rounded to f32 as that does), so that no host copy, and
    on the card no host sync, is made."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def clamp_ids(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """Ids as int64 clamped to ``rows``: with the table's row count the
    reference's ``mode='clip'`` (sentinel pads land on the last row)."""
    return ids.clamp(max=rows - 1).long()


def with_sinks(tables, extra: int):
    """Copies of ``tables`` extended by ``extra`` zero rows each."""
    return [torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))])
            for t in tables]


def deltas(P, Q, bu, bi, mu, u, i, ratings, weights, lr, reg,
           use_bias: bool):
    """Per-slot deltas from the tables' current values, on int64 row ids
    ``u`` / ``i`` of the tables; returns ``(d_pu, d_qi, d_bu, d_bi,
    sq_err)``, with ``d_bu`` / ``d_bi`` None without biases. The
    reference's order of operations throughout."""
    pu = P.index_select(0, u)
    qi = Q.index_select(0, i)
    pred = (pu * qi).sum(-1) + mu
    if use_bias:
        bu_ = bu.index_select(0, u)
        bi_ = bi.index_select(0, i)
        pred = pred + bu_ + bi_
    err = (ratings - pred) * weights
    e = err[:, None]
    w = weights[:, None]
    d_pu = lr * (e * qi - reg * w * pu)
    d_qi = lr * (e * pu - reg * w * qi)
    d_bu = d_bi = None
    if use_bias:
        d_bu = lr * (err - reg * weights * bu_)
        d_bi = lr * (err - reg * weights * bi_)
    return d_pu, d_qi, d_bu, d_bi, (err * err).sum()


def _dup_counts(ids: torch.Tensor) -> torch.Tensor:
    """Occurrences of each id within the batch (sort + binary search; no
    table-sized temporaries)."""
    s = torch.sort(ids).values
    left = torch.searchsorted(s, ids, side="left")
    right = torch.searchsorted(s, ids, side="right")
    return (right - left).to(torch.float32)


def apply(P, Q, bu, bi, u, i, d_pu, d_qi, d_bu, d_bi, *, use_bias: bool,
          unique_rows: bool, dup_trust: float, cu=None, ci=None) -> None:
    """Scatter-add the deltas into the tables in place at int64 row ids
    ``u`` / ``i``. ``cu`` / ``ci``: the ids ``dup_trust`` counts (pads as
    :data:`PAD_COUNT_ID`); needed only when it is on."""
    if dup_trust > 0.0 and not unique_rows:
        su = torch.clamp(dup_trust / _dup_counts(cu), max=1.0)[:, None]
        si = torch.clamp(dup_trust / _dup_counts(ci), max=1.0)[:, None]
        d_pu = d_pu * su
        d_qi = d_qi * si
        if use_bias:
            d_bu = d_bu * su[:, 0]
            d_bi = d_bi * si[:, 0]
    row_add(P, u, d_pu)
    row_add(Q, i, d_qi)
    if use_bias:
        row_add(bu, u, d_bu)
        row_add(bi, i, d_bi)


def count_ids(ids: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    """The ids ``dup_trust`` counts: padded slots (weight ≤ 0) as
    :data:`PAD_COUNT_ID`."""
    if weights is None:
        return ids
    return torch.where(weights <= 0.0, PAD_COUNT_ID, ids)


def sgd_compute_deltas(model: MFModel, users, items, ratings, weights, lr,
                       reg, *, use_bias: bool = True):
    """Per-rating factor/bias deltas from the batch-entry snapshot.

    Returns ``(d_pu [B,k], d_qi [B,k], d_bu [B], d_bi [B], sq_err)``;
    ``lr`` and ``reg`` are Python floats or f32 0-d tensors."""
    dev = model.device
    d_pu, d_qi, d_bu, d_bi, sq = deltas(
        model.P, model.Q, model.bu, model.bi, model.mu,
        clamp_ids(users, model.num_users), clamp_ids(items, model.num_items),
        ratings, weights, as_f32(lr, dev), as_f32(reg, dev), use_bias)
    if not use_bias:
        d_bu = torch.zeros_like(ratings, dtype=torch.float32)
        d_bi = torch.zeros_like(d_bu)
    return d_pu, d_qi, d_bu, d_bi, sq


def sgd_apply_deltas(model: MFModel, users, items, d_pu, d_qi, d_bu, d_bi, *,
                     use_bias: bool = True, unique_rows: bool = False,
                     dup_trust: float = 0.0, weights=None) -> MFModel:
    """Scatter-add (segment-sum) deltas into copies of the factor tables.

    ``dup_trust`` > 0 enables per-row trust scaling: when a row appears d
    times in the batch, its summed delta is scaled by min(1, dup_trust/d)
    (padded slots, weight 0, are not counted against a real row)."""
    U, I, B = model.num_users, model.num_items, users.shape[0]
    P, Q, bu, bi = with_sinks((model.P, model.Q, model.bu, model.bi), B)
    # mode='drop': an out-of-range id adds into a sink row, cut off below
    apply(P, Q, bu, bi, clamp_ids(users, U + B), clamp_ids(items, I + B),
          d_pu, d_qi, d_bu, d_bi, use_bias=use_bias, unique_rows=unique_rows,
          dup_trust=dup_trust, cu=count_ids(users, weights),
          ci=count_ids(items, weights))
    return MFModel(P[:U], Q[:I], bu[:U], bi[:I], model.mu)


def sgd_minibatch_update(model: MFModel, users, items, ratings, weights, lr,
                         reg, *, use_bias: bool = True,
                         unique_rows: bool = False, dup_trust: float = 0.0):
    """One minibatch SGD update; returns ``(new_model, batch_sq_err)``.

    users/items: int [B]; ratings/weights: f32 [B]. Padded slots carry
    weight 0.0 and change nothing. ``unique_rows=True`` promises the batch
    is conflict-free (no duplicate user or item row)."""
    d_pu, d_qi, d_bu, d_bi, sq = sgd_compute_deltas(
        model, users, items, ratings, weights, lr, reg, use_bias=use_bias)
    new = sgd_apply_deltas(model, users, items, d_pu, d_qi, d_bu, d_bi,
                           use_bias=use_bias, unique_rows=unique_rows,
                           dup_trust=dup_trust, weights=weights)
    return new, sq


def batch_sq_error(model: MFModel, users, items, ratings, weights):
    """Weighted squared prediction error of a batch (no update)."""
    pred = model.predict(clamp_ids(users, model.num_users),
                         clamp_ids(items, model.num_items))
    err = (ratings - pred) * weights
    return (err * err).sum()
