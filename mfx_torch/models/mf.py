"""MFModel — factor-model state, the counterpart of ``mfx/models/mf.py``.

``P (U, rank)``, ``Q (I, rank)``, ``bu (U,)``, ``bi (I,)`` are f32 buffers
of an ``nn.Module``; ``mu`` is a Python float. No autograd: the trainers
write their updates by hand. ``save_npz``/``load_npz`` use the reference's
npz format, so a model moves between the two packages through one file.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

__all__ = ["MFModel", "init_model"]


class MFModel(nn.Module):
    """Matrix-factorization state: ``r̂(u, i) = μ + bu[u] + bi[i] + p_u·q_i``."""

    def __init__(self, P: torch.Tensor, Q: torch.Tensor, bu: torch.Tensor,
                 bi: torch.Tensor, mu: float):
        super().__init__()
        self.register_buffer("P", P)
        self.register_buffer("Q", Q)
        self.register_buffer("bu", bu)
        self.register_buffer("bi", bi)
        self.mu = float(mu)

    @property
    def rank(self) -> int:
        return self.P.shape[1]

    @property
    def num_users(self) -> int:
        return self.P.shape[0]

    @property
    def num_items(self) -> int:
        return self.Q.shape[0]

    @property
    def device(self) -> torch.device:
        return self.P.device

    def predict(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """Batched prediction ``μ + bu + bi + p·q`` for id vectors."""
        return (
            (self.P[users] * self.Q[items]).sum(-1)
            + self.bu[users] + self.bi[items] + self.mu
        )

    def save_npz(self, path) -> None:
        """Write the reference's npz format (``mfx.models.mf.MFModel.load_npz``
        reads it)."""
        np.savez_compressed(
            path,
            P=self.P.cpu().numpy(), Q=self.Q.cpu().numpy(),
            bu=self.bu.cpu().numpy(), bi=self.bi.cpu().numpy(),
            mu=np.asarray(self.mu, np.float32),
        )

    @staticmethod
    def load_npz(path, device: torch.device | str = "cpu") -> "MFModel":
        """Inverse of :meth:`save_npz`; reads files the reference wrote."""
        with np.load(path) as z:
            arrs = {k: z[k] for k in ("P", "Q", "bu", "bi", "mu")}
        return MFModel(
            *(torch.as_tensor(arrs[k], dtype=torch.float32, device=device)
              for k in ("P", "Q", "bu", "bi")),
            mu=float(arrs["mu"]),
        )


def init_model(
    generator: torch.Generator,
    num_users: int,
    num_items: int,
    rank: int,
    global_mean: float = 0.0,
    init_scale: float | None = None,
    device: torch.device | str = "cpu",
) -> MFModel:
    """Scaled-normal init with the reference's scale, 1/sqrt(rank) by
    default. ``generator`` must live on ``device``. The draws differ from
    the reference's ``jax.random`` ones; tests hand tables across with
    ``mfx_torch.convert.model_from_numpy`` instead."""
    if init_scale is None:
        init_scale = 1.0 / math.sqrt(rank)
    f32 = torch.float32
    P = torch.randn(num_users, rank, generator=generator, dtype=f32,
                    device=device) * init_scale
    Q = torch.randn(num_items, rank, generator=generator, dtype=f32,
                    device=device) * init_scale
    return MFModel(
        P, Q,
        torch.zeros(num_users, dtype=f32, device=device),
        torch.zeros(num_items, dtype=f32, device=device),
        mu=global_mean,
    )
