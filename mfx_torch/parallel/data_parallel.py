"""Data-parallel BPR, the counterpart of the BPR half of
``mfx/parallel/data_parallel.py`` (``make_bpr_dp_epoch_fn``,
``train_epochs_bpr_dp``) on one device.

The reference replicates the tables over the mesh's 'data' axis, shards
each batch over it, all-gathers every shard's (ids, deltas) in device
order and applies the gathered batch's scatter on every replica, so that
it equals the single-device run on the same batches. It always samples on
the host (``bpr_epoch_triples``), in batches rounded up to a multiple of
the data axis. With a data axis of 1 the batch is not rounded and the
all-gather and the loss's psum are the identity: the epoch is
``solvers.bpr.train_epochs_bpr``'s with ``sample_device='host'``, and this
module runs exactly that. A mesh's 'model' axis only replicates the
tables further and changes no bit. More than one data shard is ROADMAP
Queue 1 item 13, as is the SGD half (``train_epochs_dp``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from mfx_torch.config import BPRConfig
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.models.mf import MFModel
from mfx_torch.solvers.bpr import train_epochs_bpr

__all__ = ["train_epochs_bpr_dp"]


def train_epochs_bpr_dp(
    model: MFModel,
    train: RatingsCOO,
    cfg: BPRConfig,
    data_axis: int = 1,
    seed: int = 0,
    start_epoch: int = 0,
    device: torch.device | str | None = None,
) -> Iterator[tuple[int, MFModel, float]]:
    """Data-parallel BPR epochs over ``data_axis`` (one) data shard;
    yields ``(epoch, model, mean_loss)``, bit for bit the single-device
    trainer's with host sampling on the same triples."""
    if data_axis != 1:
        raise NotImplementedError(
            f"mfx_torch BPR data-parallel: parallel.data_axis={data_axis}; "
            "only one data shard is ported (ROADMAP Queue 1 item 13); set "
            "parallel.data_axis=1"
        )
    # one shard: the batch is not rounded, the all-gather and psum are the
    # identity, and the reference samples on the host
    yield from train_epochs_bpr(
        model, train, dataclasses.replace(cfg, sample_device="host"),
        seed=seed, start_epoch=start_epoch, device=device)
