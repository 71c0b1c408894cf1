"""SVD++ — biased MF extended with implicit-feedback item factors, the
counterpart of ``mfx/models/svdpp.py``.

Koren's SVD++ (KDD 2008) models who rated what on top of the ratings:
each item gets a second factor row ``y_j`` and a user's representation
becomes

    x_u = p_u + |N(u)|^{-1/2} * sum_{j in N(u)} y_j

with prediction ``mu + b_u + b_i + q_i . x_u`` (N(u) = the items u rated).
The implicit sums are one gather and scatter-add over the training COO a
refresh, after which the model is a biased MF over the effective table
``X = P + S``: training, eval, serving and checkpoints reuse the MF code
through :meth:`SVDppModel.as_mf`.

The scatter-adds go through ``kernels.packing.segment_row_add`` (each
row's value and deltas summed in slot order, the sum written once with
``index_copy_``: an order that repeats from run to run, no float
atomics), in chunks of ratings, so that no gather of
every rating's row is held at once (at ML-25M scale one full gather of
rank-64 rows is 5.8 GB). ``SVDppModel`` holds the tables as
buffers of an ``nn.Module``; ``save_npz`` / ``load_npz`` use the
reference's keys, so one file loads in both packages.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mfx_torch.kernels.packing import segment_row_add
from mfx_torch.models.mf import MFModel, init_model

__all__ = ["SVDppModel", "init_svdpp", "implicit_scale", "implicit_sums",
           "CHUNK"]

CHUNK = 1 << 22  # ratings a gather, the reference trainer's chunk
_KEYS = ("P", "Q", "Y", "bu", "bi", "mu", "nu")


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device, torch.int64)


def implicit_scale(user, num_users: int,
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """Per-user ``|N(u)|^{-1/2}`` from the training COO's user column, f32
    on ``device`` (the card unless told otherwise); 0 for users with no
    ratings."""
    u = _ids(user, device)
    deg = torch.zeros(num_users, dtype=torch.float32, device=u.device)
    segment_row_add(deg, u, torch.ones(u.shape[0], dtype=torch.float32,
                                       device=u.device))
    return torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1.0)),
                       torch.zeros_like(deg))


def implicit_sums(Y: torch.Tensor, user, item, nu: torch.Tensor,
                  chunk: int = CHUNK) -> torch.Tensor:
    """``S[u] = nu_u * sum_{j in N(u)} Y[j]``: the rows of ``Y`` gathered and
    scatter-added by user, ``chunk`` ratings at a time, on Y's device."""
    u, i = _ids(user, Y.device), _ids(item, Y.device)
    S = torch.zeros((nu.shape[0], Y.shape[1]), dtype=Y.dtype,
                    device=Y.device)
    for s in range(0, u.shape[0], chunk):
        segment_row_add(S, u[s:s + chunk],
                        Y.index_select(0, i[s:s + chunk]))
    return nu[:, None] * S


class SVDppModel(nn.Module):
    """SVD++ state: the ``MFModel`` tables plus implicit item factors.

    P: (U, rank) explicit user factors; Q: (I, rank) item factors; Y: (I,
    rank) implicit item factors (zeros at init: the model then starts at
    the biased-MF point); bu / bi: biases; mu: the global mean, a Python
    float; nu: (U,) the cached ``|N(u)|^{-1/2}`` of the training set."""

    def __init__(self, P, Q, Y, bu, bi, mu: float, nu):
        super().__init__()
        for k, v in (("P", P), ("Q", Q), ("Y", Y), ("bu", bu), ("bi", bi),
                     ("nu", nu)):
            self.register_buffer(k, v)
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

    def as_mf(self, S: torch.Tensor | None = None, *, user=None,
              item=None) -> MFModel:
        """The equivalent biased-MF view ``X = P + S``, S passed in or
        computed from the training COO's (user, item) columns. Eval,
        serving and checkpoints take this view unchanged."""
        if S is None:
            if user is None or item is None:
                raise ValueError(
                    "as_mf needs S, or the training (user, item) columns")
            S = implicit_sums(self.Y, user, item, self.nu)
        return MFModel(self.P + S, self.Q, self.bu, self.bi, self.mu)

    def save_npz(self, path) -> None:
        """Full-state single-file export in the reference's keys (the MF
        view alone cannot resume training: Y would be lost)."""
        arrs = {k: getattr(self, k).cpu().numpy() for k in _KEYS
                if k != "mu"}
        np.savez_compressed(path, mu=np.asarray(self.mu, np.float32), **arrs)

    @staticmethod
    def load_npz(path, device: torch.device | str = "cuda") -> "SVDppModel":
        """Inverse of :meth:`save_npz`; reads files the reference wrote.
        The tables land on the card unless ``device`` says otherwise."""
        with np.load(path) as z:
            arrs = {k: z[k] for k in _KEYS}
        t = {k: torch.as_tensor(arrs[k], dtype=torch.float32, device=device)
             for k in _KEYS if k != "mu"}
        return SVDppModel(mu=float(arrs["mu"]), **t)


def init_svdpp(
    generator: torch.Generator,
    num_users: int,
    num_items: int,
    rank: int,
    *,
    train_user,
    train_item,
    global_mean: float = 0.0,
    init_scale: float | None = None,
    device: torch.device | str | None = None,
) -> SVDppModel:
    """Scaled-normal P/Q (``models.mf.init_model``), zero Y (the start is
    biased MF), nu from the training COO's user column, on the generator's
    device unless ``device`` names it. The draws differ from the
    reference's ``jax.random`` ones; tests hand tables across with
    ``mfx_torch.convert.svdpp_from_numpy``."""
    base = init_model(generator, num_users, num_items, rank,
                      global_mean=global_mean, init_scale=init_scale,
                      device=device)
    del train_item  # only the user column defines the N(u) sizes
    nu = implicit_scale(train_user, num_users, device=base.device)
    return SVDppModel(base.P, base.Q, torch.zeros_like(base.Q), base.bu,
                      base.bi, base.mu, nu)
