"""BPR minibatch math, the counterpart of ``mfx/solvers/bpr.py:33-63``.

Bayesian Personalized Ranking: the pairwise loss
``-ln σ(p_u·(q_i − q_j)) + λ‖·‖²`` over (user, positive, negative)
triples. One minibatch is a snapshot update: every delta comes from the
tables as they were before the batch, then the user deltas are added to
P and the positive-item deltas and the negative-item deltas are added to
Q in that order, duplicates summed. ``kernels.bpr_sweep``'s plain version
runs each tile through :func:`bpr_minibatch_update`.

The snapshot-minibatch trainers (``train_epochs_bpr``, ``parallel.mode``
'single', and the data-parallel one) are not ported yet (ROADMAP Queue 1
item 12).
"""

from __future__ import annotations

import torch

from mfx_torch.kernels.packing import row_add

__all__ = ["bpr_compute_deltas", "bpr_apply_deltas", "bpr_minibatch_update"]


def bpr_compute_deltas(P, Q, users, pos, neg, weights, lr, reg):
    """Per-triple deltas from the snapshot. Returns
    ``(d_pu, d_qi, d_qj, loss_sum)``; ``weights`` zero out pad triples."""
    pu, qi, qj = P[users], Q[pos], Q[neg]
    diff = qi - qj
    x = (pu * diff).sum(-1)
    e = torch.sigmoid(-x) * weights  # d(-ln σ(x))/dx = -σ(-x)
    w = weights[:, None]
    d_pu = lr * (e[:, None] * diff - reg * w * pu)
    d_qi = lr * (e[:, None] * pu - reg * w * qi)
    d_qj = lr * (-e[:, None] * pu - reg * w * qj)
    loss = (-torch.log(torch.sigmoid(x) + 1e-12) * weights).sum()
    return d_pu, d_qi, d_qj, loss


def bpr_apply_deltas(P, Q, users, pos, neg, d_pu, d_qi, d_qj) -> None:
    """Scatter-add the deltas in place: P rows, then Q at the positives,
    then Q at the negatives (duplicate rows summed, each add in an order
    that repeats from run to run)."""
    row_add(P, users, d_pu.to(P.dtype))
    row_add(Q, pos, d_qi.to(Q.dtype))
    row_add(Q, neg, d_qj.to(Q.dtype))


def bpr_minibatch_update(P, Q, users, pos, neg, weights, lr, reg):
    """One BPR minibatch step on P and Q in place; returns the batch's
    loss sum (0-d)."""
    d_pu, d_qi, d_qj, loss = bpr_compute_deltas(P, Q, users, pos, neg,
                                                weights, lr, reg)
    bpr_apply_deltas(P, Q, users, pos, neg, d_pu, d_qi, d_qj)
    return loss
