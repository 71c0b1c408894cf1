"""Online model updates, the counterpart of ``mfx/train/online.py``
(``grow_model``, ``_histories_for_new``, ``partial_fit``): absorb a delta
batch of ratings into a trained model without a full retrain.

Three steps, all batched:

1. **Grow** the factor tables to cover new ids (``grow_model``): zero
   rows, so existing predictions are bitwise unchanged and a new row
   predicts the global mean until it learns.
2. **Fold in** genuinely new rows (users first against the frozen item
   table, then new items against the UPDATED user table) through
   ``mfx_torch.serve.foldin.fold_in``: one batched regularized
   least-squares solve for the whole cohort.
3. **Fine-tune** with a few SGD epochs over the delta ratings (plus an
   optional replay sample of old ratings) through
   ``mfx_torch.solvers.sgd.train_epochs``, so ``dup_trust``, the
   partitioners and determinism all carry over.

The tables stay on the model's device throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mfx_torch.config import SGDConfig
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.models.mf import MFModel

__all__ = ["grow_model", "partial_fit"]


def grow_model(
    model: MFModel,
    num_users: int | None = None,
    num_items: int | None = None,
) -> MFModel:
    """Enlarge the factor tables to (num_users, num_items) with zero
    rows. Predictions for existing ids are bitwise unchanged; a new row
    predicts ``mu`` until it is folded in or trained. No-op when the
    model is already large enough."""
    U = model.num_users if num_users is None else int(num_users)
    I = model.num_items if num_items is None else int(num_items)
    if U < model.num_users or I < model.num_items:
        raise ValueError(
            f"grow_model cannot shrink: model is "
            f"({model.num_users}, {model.num_items}), asked ({U}, {I})"
        )
    if U == model.num_users and I == model.num_items:
        return model
    du, di = U - model.num_users, I - model.num_items

    def pad(a, n):
        if n == 0:
            return a
        return torch.cat([a, a.new_zeros((n,) + tuple(a.shape[1:]))])

    return MFModel(pad(model.P, du), pad(model.Q, di), pad(model.bu, du),
                   pad(model.bi, di), model.mu)


def _histories_for_new(
    ids: np.ndarray, other: np.ndarray, vals: np.ndarray, first_new: int
) -> tuple[np.ndarray, list[tuple[np.ndarray, np.ndarray]]]:
    """Group the delta's ratings by the NEW ids (>= first_new) on one
    side; returns (new_ids, histories aligned with them) for fold_in.
    O(|delta| log |delta|) host work — deltas are small by contract."""
    m = ids >= first_new
    if not m.any():
        return np.zeros(0, np.int32), []
    ids, other, vals = ids[m], other[m], vals[m]
    order = np.argsort(ids, kind="stable")
    ids, other, vals = ids[order], other[order], vals[order]
    uniq, starts = np.unique(ids, return_index=True)
    bounds = np.append(starts, len(ids))
    hists = [
        (other[bounds[j]:bounds[j + 1]], vals[bounds[j]:bounds[j + 1]])
        for j in range(len(uniq))
    ]
    return uniq.astype(np.int32), hists


def partial_fit(
    model: MFModel,
    delta: RatingsCOO,
    cfg: SGDConfig,
    *,
    use_bias: bool = True,
    seed: int = 0,
    foldin_new: bool = True,
    foldin_reg: float = 0.05,
    replay: RatingsCOO | None = None,
) -> tuple[MFModel, float]:
    """Absorb ``delta`` (new ratings; ids may exceed the model's current
    table sizes) into a trained model: grow → fold-in new rows →
    ``cfg.epochs`` SGD epochs over delta ∪ replay, on the model's
    device. Returns ``(updated_model, last_train_rmse)``.

    ``replay``: optional sample of older ratings trained alongside the
    delta, anchoring the rows the delta touches. Must use the same id
    space; its table sizes may lag the delta's (both are grown to the
    union).

    Deterministic for a fixed (model, delta, replay, cfg, seed).
    """
    from mfx_torch.solvers.sgd import train_epochs

    old_U, old_I = model.num_users, model.num_items
    U = max(old_U, delta.num_users)
    I = max(old_I, delta.num_items)
    if replay is not None:
        U, I = max(U, replay.num_users), max(I, replay.num_items)
    if delta.n_ratings == 0:
        raise ValueError("partial_fit needs a non-empty delta")
    model = grow_model(model, U, I)

    if foldin_new:
        from mfx_torch.serve.foldin import fold_in

        dev = model.device
        # new users against the (frozen, grown) item table …
        new_u, hists = _histories_for_new(
            delta.user, delta.item, delta.rating, old_U
        )
        if len(new_u):
            P_new, bu_new = fold_in(model, hists, foldin_reg,
                                    use_bias=use_bias)
            rows = torch.as_tensor(new_u, device=dev).long()
            P, bu = model.P.clone(), model.bu.clone()
            P[rows] = P_new.to(P.dtype)
            bu[rows] = bu_new.to(bu.dtype)
            model = MFModel(P, model.Q, bu, model.bi, model.mu)
        # … then new items against the UPDATED user table, so an item
        # rated only by new users still gets a meaningful row
        new_i, hists = _histories_for_new(
            delta.item, delta.user, delta.rating, old_I
        )
        if len(new_i):
            Q_new, bi_new = fold_in(model, hists, foldin_reg,
                                    use_bias=use_bias, transpose=True)
            rows = torch.as_tensor(new_i, device=dev).long()
            Q, bi = model.Q.clone(), model.bi.clone()
            Q[rows] = Q_new.to(Q.dtype)
            bi[rows] = bi_new.to(bi.dtype)
            model = MFModel(model.P, Q, model.bu, bi, model.mu)

    train = dataclasses.replace(delta, num_users=U, num_items=I)
    if replay is not None:
        train = train.concat(
            dataclasses.replace(replay, num_users=U, num_items=I)
        )
    tr = float("nan")
    if cfg.epochs > 0:
        for _ep, model, tr in train_epochs(
            model, train, cfg, use_bias=use_bias, seed=seed
        ):
            pass
        tr = float(tr)  # the blocked path yields a 0-d tensor
    return model, tr
