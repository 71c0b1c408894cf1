"""SVD++ trainer (``solver='svdpp'``), the counterpart of
``mfx/solvers/svdpp.py``: Koren's SVD++ (KDD 2008) restructured around
epoch-frozen implicit sums.

1. refresh ``S_u = nu_u * sum_{j in N(u)} y_j`` (``models.svdpp.
   implicit_sums``);
2. one minibatch SGD epoch of the biased MF over ``X = P + S``: the port's
   own minibatch path (``solvers.sgd.plan_epoch`` and ``make_epoch_fn``,
   one CUDA-graph replay a batch on the card), the same partitioners and
   snapshot semantics; d/dp == d/dx, so updating X updates P;
3. one exact full-batch gradient step on Y at the epoch-end snapshot
   (:func:`y_gradient_step`):

       A_u  = sum_{i in R(u)} e_ui q_i
       y_j += lr_y * (sum_{u: j in N(u)} nu_u A_u  -  reg_y deg_j y_j)

   two passes over the training COO in padded chunks, every scatter-add
   through ``kernels.packing.segment_row_add`` (each row's sum in slot
   order, then ``row_add``: no float atomics, no one-hot matmuls), with
   the reference's trust cap and its production stabilization
   (:func:`_apply_y_step`).

With ``Y = 0`` at init, epoch 0 is the plain biased-MF epoch bit for bit,
and with ``lr_y = 0`` every epoch is. The reference writes all of this in
XLA, not Pallas, so stock torch ops are its port.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from mfx_torch.config import SGDConfig, SVDPPConfig
from mfx_torch.data import partition as part
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.kernels import minibatch as mb
from mfx_torch.kernels.packing import segment_row_add
from mfx_torch.models.mf import MFModel
from mfx_torch.models.svdpp import CHUNK, implicit_scale, implicit_sums
from mfx_torch.solvers.sgd import make_epoch_fn, plan_epoch

__all__ = ["train_epochs_svdpp", "y_gradient_step", "svdpp_run_constants",
           "Y_TR_ETA"]

# The production stabilization of the full-batch Y step (the reference's,
# mfx/solvers/svdpp.py): at multi-million-rating Zipf scale the linear
# step diverges. (1) The L2 term applies the exact sequential shrink
# 1 - (1 - lr reg)^deg_j, which stays in [0, 1] at any degree, where the
# linear -lr reg deg_j y_j flips sign for hot items. (2) A trust-region
# clip scales the whole pull (direction kept) so that no row moves more
# than Y_TR_ETA (1 + the largest row norm of Y) an epoch. tr_eta=0 selects
# the pure full-batch gradient (linear L2, no clip).
Y_TR_ETA = 0.1


def _apply_y_step(Y, pull, deg_i, lr_y, reg_y, eta):
    """``Y`` after one step along ``pull`` (the trust-capped residual
    pull), in the reference's order of operations; ``lr_y`` and ``reg_y``
    0-d f32 tensors. The clip's maxima are f32, as the reference's."""
    if eta and eta > 0.0:
        sn = torch.sqrt((pull * pull).sum(1).max())
        yn = torch.sqrt((Y * Y).sum(1).max())
        cap = eta * (1.0 + yn)
        factor = torch.clamp(cap / torch.clamp(lr_y * sn, min=1e-30),
                             max=1.0)
        base = torch.clamp(1.0 - lr_y * reg_y, 1e-12, 1.0)
        shrink = 1.0 - torch.exp(deg_i * torch.log(base))
        return Y + lr_y * factor * pull - shrink[:, None] * Y
    return Y + lr_y * (pull - reg_y * deg_i[:, None] * Y)


def y_step_pull(Y, X, Q, nu, batches, residual):
    """The Y step's two passes over the padded COO chunks ``batches``
    ([nc, C] tensors; pads carry weight 0 and out-of-range sentinel ids):

        A_u = sum_{i in R(u)} e_ui q_i,   G_j = sum_{u: j in N(u)} nu_u A_u

    ``residual(c, u, i, q)`` gives chunk ``c``'s residuals r - pred at ids
    clamped to the tables (the reference's clipped gathers), ``q`` the
    gathered Q rows; they are weighted here. Pads scatter into one sink
    row past each table's end, which is cut off: the reference drops them.
    Returns ``(G, sse)``, the sse a 0-d f32 tensor."""
    U, I = X.shape[0], Y.shape[0]
    w = batches["weights"]
    users, items = batches["users"].long(), batches["items"].long()
    A = X.new_zeros((U + 1, X.shape[1]))
    sse = torch.zeros((), dtype=torch.float32, device=X.device)
    for c in range(users.shape[0]):
        u, i = users[c].clamp(max=U - 1), items[c].clamp(max=I - 1)
        q = Q.index_select(0, i)
        e = residual(c, u, i, q) * w[c]
        segment_row_add(A, users[c].clamp(max=U), e[:, None] * q)
        sse = sse + (e * e).sum()
    contrib = A[:U] * nu[:, None]
    G = Y.new_zeros((I + 1, Y.shape[1]))
    for c in range(users.shape[0]):
        u = users[c].clamp(max=U - 1)
        segment_row_add(G, items[c].clamp(max=I),
                        contrib.index_select(0, u) * w[c][:, None])
    return G[:I], sse


def y_gradient_step(Y, X, Q, bu, bi, mu, nu, deg_i, y_scale, batches, lr_y,
                    reg_y, tr_eta=None, *, use_bias: bool):
    """One full-batch gradient step on Y at frozen (X, Q, biases); returns
    ``(Y_new, sse)``. ``batches`` holds the whole training COO as padded
    [nc, C] chunks (:func:`coo_chunks`). The repo-wide step convention
    ``y += lr (-dL/dy / 2)``: per-occurrence residual pull minus
    per-occurrence L2 (deg_j-scaled). ``y_scale`` (I,) preconditions the
    pull per item: all ones is the exact gradient; the trainer passes the
    ``min(1, y_trust / c_j)`` trust cap (:func:`svdpp_run_constants`).
    ``tr_eta``: None is ``Y_TR_ETA``, 0 the linear step."""
    dev = X.device

    def residual(c, u, i, q):
        pred = (X.index_select(0, u) * q).sum(-1) + mu
        if use_bias:
            pred = pred + bu.index_select(0, u)
            pred = pred + bi.index_select(0, i)
        return batches["ratings"][c] - pred

    G, sse = y_step_pull(Y, X, Q, nu, batches, residual)
    eta = Y_TR_ETA if tr_eta is None else tr_eta
    return _apply_y_step(Y, y_scale[:, None] * G, deg_i,
                         mb.as_scalar(lr_y, dev), mb.as_scalar(reg_y, dev),
                         eta), sse


def coo_chunks(train: RatingsCOO, chunk: int, device,
               extras: dict[str, np.ndarray] | None = None
               ) -> dict[str, torch.Tensor]:
    """The whole COO (and ``extras`` columns) in rating order as padded
    [nc, C] chunk tensors on ``device``, C = min(chunk, max(1024, nnz)):
    the reference's chunks."""
    C = min(chunk, max(1024, train.n_ratings))
    order = np.arange(train.n_ratings, dtype=np.int64)
    arrays = part.pad_to_batches(
        train.user, train.item, train.rating, order, C,
        num_users=train.num_users, num_items=train.num_items, extras=extras)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def svdpp_run_constants(train: RatingsCOO, cfg, device):
    """Degree-derived run constants shared by the SVD++ and timeSVD++
    trainers: ``(user, item, nu, deg_i, y_scale)`` on ``device`` (int64
    ids, f32 vectors). ``cfg`` needs only ``y_trust``. The trust cap:
    item j takes c_j = sum_{u: j in N(u)} sqrt(deg_u) same-snapshot
    contributions, and its pull is scaled by min(1, y_trust / c_j) (all
    ones with y_trust 0)."""
    f32 = torch.float32
    user = torch.as_tensor(train.user).to(device, torch.int64)
    item = torch.as_tensor(train.item).to(device, torch.int64)
    ones = torch.ones(user.shape[0], dtype=f32, device=device)
    nu = implicit_scale(user, train.num_users, device=device)
    deg_i = torch.zeros(train.num_items, dtype=f32, device=device)
    segment_row_add(deg_i, item, ones)
    if cfg.y_trust > 0:
        deg_u = torch.zeros(train.num_users, dtype=f32, device=device)
        segment_row_add(deg_u, user, ones)
        c = torch.zeros(train.num_items, dtype=f32, device=device)
        segment_row_add(c, item, torch.sqrt(deg_u).index_select(0, user))
        y_scale = torch.clamp(cfg.y_trust / torch.clamp(c, min=1e-9),
                              max=1.0)
    else:
        y_scale = torch.ones(train.num_items, dtype=f32, device=device)
    return user, item, nu, deg_i, y_scale


def train_epochs_svdpp(
    model: MFModel,
    train: RatingsCOO,
    cfg: SVDPPConfig,
    use_bias: bool,
    seed: int = 0,
    start_epoch: int = 0,
    chunk: int = CHUNK,
    device: torch.device | str | None = None,
) -> Iterator[tuple[int, MFModel, float]]:
    """Generator yielding ``(epoch, mf_view, train_rmse)``, the RMSE a
    float read once an epoch. ``model`` is the usual MF init (the
    driver's); Y starts at zeros. The yielded model is the post-epoch MF
    view ``X = P + S`` with S refreshed after the Y step, which eval,
    serving and checkpoints take unchanged. Resuming needs the full state
    (Y), which the view does not hold. ``device`` defaults to the
    model's."""
    if start_epoch != 0:
        raise ValueError(
            "svdpp cannot resume from an MF-view checkpoint (the implicit "
            "Y table is not in it); save/restore SVDppModel.save_npz for "
            "warm starts, or rerun from epoch 0"
        )
    dev = torch.device(device) if device is not None else model.device
    user, item, nu, deg_i, y_scale = svdpp_run_constants(train, cfg, dev)
    chunks = coo_chunks(train, chunk, dev)
    sgd_cfg = SGDConfig(
        lr=cfg.lr, reg=cfg.reg, lr_decay=cfg.lr_decay, epochs=cfg.epochs,
        batch_size=cfg.batch_size, partitioner=cfg.partitioner,
        dup_trust=cfg.dup_trust,
    )
    epoch_fn = make_epoch_fn(sgd_cfg, use_bias)
    lr_y = cfg.lr if cfg.lr_y is None else cfg.lr_y
    reg_y = cfg.reg if cfg.reg_y is None else cfg.reg_y
    P, Q, bu, bi = (getattr(model, k).to(dev) for k in ("P", "Q", "bu", "bi"))
    mu = model.mu
    Y = torch.zeros_like(Q)
    S = implicit_sums(Y, user, item, nu, chunk)  # zeros at init
    for epoch in range(cfg.epochs):
        lr = cfg.lr * (cfg.lr_decay ** epoch)
        plan = plan_epoch(train, sgd_cfg, seed, epoch, device=dev)
        mf, sse = epoch_fn(MFModel(P + S, Q, bu, bi, mu), plan, lr)
        lr_y_t = lr_y * (cfg.lr_decay ** epoch)  # the same decay
        Y, _ = y_gradient_step(Y, mf.P, mf.Q, mf.bu, mf.bi, mu, nu, deg_i,
                               y_scale, chunks, lr_y_t, reg_y,
                               use_bias=use_bias)
        P, Q, bu, bi = mf.P - S, mf.Q, mf.bu, mf.bi
        # the next epoch's start and this epoch's eval-consistent view
        S = implicit_sums(Y, user, item, nu, chunk)
        train_rmse = float(torch.sqrt(sse / max(1, plan.n_real)))
        yield epoch, MFModel(P + S, Q, bu, bi, mu), train_rmse
