"""BPR trainer, the counterpart of ``mfx/solvers/bpr.py``.

Bayesian Personalized Ranking: the pairwise loss
``-ln σ(p_u·(q_i − q_j)) + λ‖·‖²`` over (user, positive, negative)
triples. One minibatch is a snapshot update: every delta comes from the
tables as they were before the batch, then the user deltas are added to
P and the positive-item deltas and the negative-item deltas are added to
Q in that order, duplicates summed (``kernels.packing.row_add``: the
CPU's ``index_add_`` walks them in slot order, the card's sorted
``index_put_`` in an order that repeats from run to run; bf16 tables one
rounded add a delta through ``bf16_row_add``). ``kernels.bpr_sweep``'s
plain version runs each tile through :func:`bpr_minibatch_update`.

:func:`train_epochs_bpr` is the snapshot-minibatch trainer
(``parallel.mode='single'``; the data-parallel trainer of one device,
``parallel.data_parallel``, is its host-sampled run, and the ring's
``bpr.kernel='jnp'`` path of one shard runs its batch loop,
:class:`EpochRunner`). An epoch's triples are the reference's:
``sample_device='host'`` (and ``'auto'`` on the CPU) draws them with the
reference's NumPy sampler, so the port trains on the reference's own
triples; ``'device'`` (and ``'auto'`` on the card) draws the permutation,
the exact uniform negatives (``data.bpr.sample_negatives_device``) or the
popularity-weighted ones and the padding on the device, with no host work
that grows with the data. The batches then run in order, each a handful
of stock torch ops, as the reference's are XLA ops, not Pallas: on the
card one CUDA-graph replay a batch over static epoch buffers (no host
sync inside an epoch), on the CPU dispatched op by op.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch

from mfx_torch.config import BPRConfig
from mfx_torch.data.bpr import (bpr_epoch_triples, build_positive_index,
                                build_positive_index_device, popularity_cdf,
                                sample_negatives_device,
                                sample_negatives_weighted_device,
                                split_cdf_f32)
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.data.split import epoch_permutation
from mfx_torch.kernels.minibatch import as_scalar
from mfx_torch.kernels.packing import row_add
from mfx_torch.models.mf import MFModel
from mfx_torch.solvers.capture import CapturedLoop

__all__ = ["bpr_compute_deltas", "bpr_apply_deltas", "bpr_minibatch_update",
           "pad_triples", "epoch_triples_device", "EpochRunner",
           "samples_on_device", "seeded_generator", "SnapshotTrainer",
           "train_epochs_bpr"]

# the reference's ``+ 1e-12`` inside the loss's log, as a bf16 add sees it
_EPS_BF16 = float(torch.tensor(1e-12).to(torch.bfloat16))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and widened again."""
    return x.to(torch.bfloat16).float()


def bpr_compute_deltas(P, Q, users, pos, neg, weights, lr, reg):
    """Per-triple deltas from the snapshot. Returns
    ``(d_pu, d_qi, d_qj, loss_sum)``; ``weights`` zero out pad triples.

    bf16 tables follow the reference's step as its compiled program rounds
    it on the CPU (``lr`` and ``reg`` rounded to bf16 by the caller):
    ``q_i − q_j`` rounded to bf16 in the dot, whose products are summed in
    f32 and rounded once; ``σ(−x) = 1 / (1 + e^x)`` with ``e^x`` and the
    sum rounded and the quotient not (its only consumer widens it); the
    deltas f32 from the unrounded rows; the loss's every step rounded."""
    pu, qi, qj = P[users], Q[pos], Q[neg]
    w = weights[:, None]
    if P.dtype == torch.bfloat16:
        x = _bf16((pu.float() * (qi - qj).float()).sum(-1))
        e = (1.0 / _bf16(1.0 + _bf16(torch.exp(x)))) * weights
        pu, qi, qj = pu.float(), qi.float(), qj.float()
        lr = as_scalar(lr, P.device, P.dtype).float()
        reg = as_scalar(reg, P.device, P.dtype).float()
        s = _bf16(1.0 / _bf16(1.0 + _bf16(torch.exp(-x))))
        loss = (-_bf16(torch.log(_bf16(s + _EPS_BF16))) * weights).sum()
        diff = qi - qj
    else:
        diff = qi - qj
        x = (pu * diff).sum(-1)
        e = torch.sigmoid(-x) * weights  # d(-ln σ(x))/dx = -σ(-x)
        loss = (-torch.log(torch.sigmoid(x) + 1e-12) * weights).sum()
    d_pu = lr * (e[:, None] * diff - reg * w * pu)
    d_qi = lr * (e[:, None] * pu - reg * w * qi)
    d_qj = lr * (-e[:, None] * pu - reg * w * qj)
    return d_pu, d_qi, d_qj, loss


def bpr_apply_deltas(P, Q, users, pos, neg, d_pu, d_qi, d_qj) -> None:
    """Scatter-add the deltas in place: P rows, then Q at the positives,
    then Q at the negatives (duplicate rows summed, each add in an order
    that repeats from run to run), each delta in the table's dtype."""
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


def pad_triples(u, i, j, batch_size: int, device=None) -> dict:
    """Triples (NumPy or tensors) as ``(nb, B)`` tensors on ``device``:
    int32 ``users``, ``pos``, ``neg`` and f32 ``weights``, the pad slots
    (after the last triple) id 0 and weight 0, as the reference's
    ``_pad_triples``."""
    cols = [torch.as_tensor(x).to(device, torch.int32) for x in (u, i, j)]
    n = cols[0].shape[0]
    nb = max(1, -(-n // batch_size))
    pad = nb * batch_size - n
    out = {k: torch.nn.functional.pad(c, (0, pad)).view(nb, batch_size)
           for k, c in zip(("users", "pos", "neg"), cols)}
    w = torch.ones(n, dtype=torch.float32, device=cols[0].device)
    out["weights"] = torch.nn.functional.pad(w, (0, pad)).view(nb,
                                                               batch_size)
    return out


def epoch_triples_device(u_dev, i_dev, pu, pi, perm, batch_size: int,
                         num_items: int, cdf=None, x=None, draw=None,
                         generator: torch.Generator | None = None) -> dict:
    """One epoch's padded triple batches built on the ids' device: the
    positives in the order of ``perm``, their exact uniform negatives
    (``x`` ~ U[0, navail): given, or a function of navail, else drawn from
    ``generator``) or, with ``cdf`` (a ``split_cdf_f32`` pair),
    popularity-weighted ones (each round's uniforms from ``draw(r)`` or
    ``generator``) with the positive as the fallback; then
    :func:`pad_triples`' padding."""
    u, i = u_dev[perm], i_dev[perm]
    if cdf is not None:
        j = sample_negatives_weighted_device(u, pu, pi, cdf, fallback=i,
                                             draw=draw, generator=generator)
    else:
        j = sample_negatives_device(u, pu, pi, num_items, x=x,
                                    generator=generator)
    return pad_triples(u, i, j, batch_size)


class EpochRunner:
    """The snapshot-minibatch batch loop over tables it holds: ``P`` and
    ``Q`` (copies of the given tables on their device, updated in place),
    ``lr`` and ``reg`` in the tables' dtype, as the reference's
    ``jnp.asarray(cfg.lr, model.P.dtype)``. :meth:`run` takes one epoch's
    ``(nb, B)`` batches (:func:`pad_triples`) in order and returns their
    loss sum, a 0-d f32 tensor on the device (reading it waits for the
    epoch). On the card it replays one captured step a batch
    (``solvers.capture.CapturedLoop``, captured at the first epoch, again
    if the batches no longer fit its buffers); on the CPU each batch's ops
    are dispatched from the host. Both run the same kernels in the same
    order."""

    def __init__(self, P: torch.Tensor, Q: torch.Tensor, lr: float,
                 reg: float):
        dev = P.device
        self.P, self.Q = P.contiguous().clone(), Q.to(dev).contiguous().clone()
        self.lr = as_scalar(lr, dev, P.dtype)
        self.reg = as_scalar(reg, dev, P.dtype)
        self.loss = torch.zeros((), dtype=torch.float32, device=dev)
        self._loop: CapturedLoop | None = None

    def step(self, b: dict) -> torch.Tensor:
        """One batch on the tables in place; its loss sum."""
        return bpr_minibatch_update(
            self.P, self.Q, b["users"].long(), b["pos"].long(),
            b["neg"].long(), b["weights"], self.lr, self.reg)

    def run(self, batches: dict) -> torch.Tensor:
        if not self.P.is_cuda:
            loss = torch.zeros((), dtype=torch.float32, device=self.P.device)
            for k in range(batches["users"].shape[0]):
                loss = loss + self.step({n: v[k] for n, v in batches.items()})
            return loss
        if self._loop is None or not self._loop.fits(batches):
            # captured on zero tables, which the warm-up's zero-weight
            # steps leave as they were; then the tables come back
            tables = self.P.clone(), self.Q.clone()
            self.P.zero_()
            self.Q.zero_()
            self._loop = CapturedLoop(
                lambda b: self.loss.add_(self.step(b)), batches,
                self.P.device)
            self.P.copy_(tables[0])
            self.Q.copy_(tables[1])
            del tables
        self.loss.zero_()
        self._loop.run(batches)
        return self.loss.clone()


def samples_on_device(cfg: BPRConfig, device: torch.device) -> bool:
    """Whether an epoch's triples are drawn on ``device``:
    ``cfg.sample_device`` 'device', or 'auto' on the card."""
    return cfg.sample_device == "device" or (
        cfg.sample_device == "auto" and device.type == "cuda")


def seeded_generator(seed: int, stream: int, epoch: int,
                     device) -> torch.Generator:
    """A torch generator seeded from (seed, stream, epoch)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919 + int(epoch))
                  & 0x7FFF_FFFF_FFFF)
    return g


class SnapshotTrainer:
    """The state of :func:`train_epochs_bpr`'s run, built once: the
    tables (an :class:`EpochRunner` on ``device``) and the sampler's index
    (the host's sorted positive keys, or the device's sorted positive
    pairs and popularity CDF). :meth:`batches` draws an epoch's triples and
    :meth:`epoch` trains on them; with device sampling on the card neither
    makes a host sync (the loss comes back as a 0-d device tensor)."""

    def __init__(self, model: MFModel, train: RatingsCOO, cfg: BPRConfig,
                 seed: int = 0, device: torch.device | str | None = None,
                 perm_rand=None, neg_rand=None, cdf_rand=None):
        dev = torch.device(device) if device is not None else model.device
        self.train, self.cfg, self.seed, self.device = train, cfg, seed, dev
        self.rand = (perm_rand, neg_rand, cdf_rand)
        self.on_device = samples_on_device(cfg, dev)
        self.cdf = None
        if cfg.neg_weighting == "popularity":
            self.cdf = popularity_cdf(train.item, train.num_items,
                                      cfg.neg_beta)
        if self.on_device:
            self.u = torch.as_tensor(train.user).to(dev, torch.int32)
            self.i = torch.as_tensor(train.item).to(dev, torch.int32)
            self.pu, self.pi = build_positive_index_device(self.u, self.i)
            # double-single pair: a plain f32 cast would zero out long-tail
            # item mass at large-catalog scale
            self.cdf_dev = (split_cdf_f32(self.cdf, dev)
                            if self.cdf is not None else None)
        else:
            self.pos_keys = build_positive_index(train)  # exact negatives
        self.run = EpochRunner(model.P.to(dev), model.Q, cfg.lr, cfg.reg)
        self.rest = model.bu.to(dev), model.bi.to(dev), model.mu

    def batches(self, epoch: int) -> dict:
        """Epoch ``epoch``'s padded ``(nb, B)`` triples on the device."""
        train, cfg, dev = self.train, self.cfg, self.device
        n, B = train.n_ratings, cfg.batch_size
        if not self.on_device:
            perm = epoch_permutation(n, self.seed, epoch)
            u, i, j = bpr_epoch_triples(train, cfg.neg_seed + self.seed,
                                        epoch, perm, pos_keys=self.pos_keys,
                                        cdf=self.cdf)
            return pad_triples(u, i, j, B, dev)
        perm_rand, neg_rand, cdf_rand = self.rand
        nseed = self.seed + cfg.neg_seed
        if perm_rand is not None:
            perm = perm_rand(epoch, n).to(dev)
        else:
            perm = torch.randperm(n, device=dev, generator=(
                seeded_generator(nseed, 0xBE, epoch, dev)))
        x = None if neg_rand is None else (
            lambda navail: neg_rand(epoch, navail))
        draw = None if cdf_rand is None else (
            lambda r: cdf_rand(epoch, r, n))
        return epoch_triples_device(
            self.u, self.i, self.pu, self.pi, perm, B, train.num_items,
            cdf=self.cdf_dev, x=x, draw=draw,
            generator=seeded_generator(nseed, 0xB1, epoch, dev))

    def epoch(self, epoch: int) -> torch.Tensor:
        """Train epoch ``epoch`` in place; its loss sum (0-d f32)."""
        return self.run.run(self.batches(epoch))

    def model(self) -> MFModel:
        """The tables now, as a model of fresh tensors."""
        return MFModel(self.run.P.clone(), self.run.Q.clone(), *self.rest)


def train_epochs_bpr(
    model: MFModel,
    train: RatingsCOO,
    cfg: BPRConfig,
    seed: int = 0,
    start_epoch: int = 0,
    device: torch.device | str | None = None,
    perm_rand: Callable[[int, int], torch.Tensor] | None = None,
    neg_rand: Callable[[int, torch.Tensor], torch.Tensor] | None = None,
    cdf_rand: Callable[[int, int, int], tuple] | None = None,
) -> Iterator[tuple[int, MFModel, float]]:
    """Snapshot-minibatch BPR epochs from ``start_epoch``; yields
    ``(epoch, model, mean_pairwise_loss)``, the model's tables fresh
    tensors on ``device`` (default the model's) in its dtype.

    Host sampling (``cfg.sample_device`` 'host', or 'auto' on the CPU):
    the reference's ``epoch_permutation`` and ``bpr_epoch_triples`` (exact
    rejection, popularity-weighted with ``cfg.neg_weighting``), the same
    triples as the reference's. Device sampling ('device', or 'auto' on
    the card): the permutation, the negatives and the padding on the
    device; ``perm_rand(epoch, n)`` may supply the permutation (an int64
    tensor), ``neg_rand(epoch, navail)`` the uniform negatives' draws
    x ~ U[0, max(navail, 1)) and ``cdf_rand(epoch, r, n)`` round ``r``'s
    uniforms ``(u, u2)`` of the weighted sampler, instead of torch
    generators seeded from ``(seed + cfg.neg_seed, epoch)``; the parity
    tests pass the reference's ``jax.random`` numbers this way. Either way
    every epoch's triples follow from the epoch number, so a run resumed at
    ``start_epoch`` from the tables an unbroken run had repeats it bit for
    bit. The batches run through :class:`EpochRunner`."""
    tr = SnapshotTrainer(model, train, cfg, seed=seed, device=device,
                         perm_rand=perm_rand, neg_rand=neg_rand,
                         cdf_rand=cdf_rand)
    for epoch in range(start_epoch, cfg.epochs):
        loss = tr.epoch(epoch)
        yield epoch, tr.model(), float(loss) / max(1, train.n_ratings)
