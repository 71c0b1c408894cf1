"""MFModel — factor-model state, the counterpart of ``mfx/models/mf.py``.

``P (U, rank)``, ``Q (I, rank)``, ``bu (U,)``, ``bi (I,)`` are buffers of
an ``nn.Module``, float32 or, as the reference's ``model.dtype`` allows,
bfloat16 (:meth:`MFModel.astype`, ``init_model(dtype=)``); ``mu`` is a
Python float (for bf16 tables the bf16 value of the global mean, as the
reference rounds its ``mu``). No autograd: the trainers write their
updates by hand. ``save_npz``/``load_npz`` use the reference's npz format,
so a model moves between the two packages through one file. numpy has no
bfloat16: bf16 arrays are stored as their 2-byte values (``|V2``), as
numpy writes the reference's ``ml_dtypes`` bfloat16 arrays, and read back
bit for bit (:func:`to_numpy`, :func:`from_numpy`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

__all__ = ["MFModel", "init_model", "baseline_biases", "to_numpy",
           "from_numpy", "TABLE_DTYPES"]

# the reference's model.dtype names and their torch dtypes
TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def table_dtype(dtype) -> torch.dtype:
    """A table dtype given as the reference's name or a torch dtype."""
    if isinstance(dtype, torch.dtype) and dtype in TABLE_DTYPES.values():
        return dtype
    if dtype in TABLE_DTYPES:
        return TABLE_DTYPES[dtype]
    raise ValueError(f"table dtype must be one of {sorted(TABLE_DTYPES)}, "
                     f"got {dtype!r}")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 as its 2-byte values (``|V2``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """Inverse of :func:`to_numpy`: ``|V2`` arrays are bfloat16 bits;
    other arrays become float32 (the reference's f32 tables)."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _round_mu(mu: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(mu, dtype=torch.float32).to(dtype))


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

    @property
    def dtype(self) -> torch.dtype:
        return self.P.dtype

    def astype(self, dtype) -> "MFModel":
        """The model with every table (and ``mu``) rounded to ``dtype``
        (``'float32'`` / ``'bfloat16'`` or the torch dtype)."""
        dt = table_dtype(dtype)
        mu = self.mu if dt == torch.float32 else _round_mu(self.mu, dt)
        return MFModel(self.P.to(dt), self.Q.to(dt), self.bu.to(dt),
                       self.bi.to(dt), mu)

    def predict(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """Batched prediction ``μ + bu + bi + p·q`` for id vectors."""
        return (
            (self.P[users] * self.Q[items]).sum(-1)
            + self.bu[users] + self.bi[items] + self.mu
        )

    def save_npz(self, path) -> None:
        """Write the reference's npz format (``mfx.models.mf.MFModel.load_npz``
        reads it)."""
        np.savez_compressed(path, **self.state_arrays())

    def state_arrays(self) -> dict:
        """Host copies of the five arrays of the npz format: the tables in
        their dtype (:func:`to_numpy`), ``mu`` in the tables' dtype."""
        out = {k: to_numpy(getattr(self, k)) for k in ("P", "Q", "bu", "bi")}
        out["mu"] = to_numpy(torch.tensor(self.mu, dtype=self.dtype))
        return out

    @staticmethod
    def from_arrays(arrs: dict, device) -> "MFModel":
        """Inverse of :meth:`state_arrays` on ``device``."""
        return MFModel(*(from_numpy(arrs[k], device)
                         for k in ("P", "Q", "bu", "bi")),
                       mu=float(from_numpy(arrs["mu"], "cpu")))

    @staticmethod
    def load_npz(path, device: torch.device | str = "cuda") -> "MFModel":
        """Inverse of :meth:`save_npz`; reads files the reference wrote.
        The tables land on the card unless ``device`` says otherwise, in
        the dtype they were saved in."""
        with np.load(path) as z:
            arrs = {k: z[k] for k in ("P", "Q", "bu", "bi", "mu")}
        return MFModel.from_arrays(arrs, device)


def init_model(
    generator: torch.Generator,
    num_users: int,
    num_items: int,
    rank: int,
    global_mean: float = 0.0,
    init_scale: float | None = None,
    device: torch.device | str | None = None,
    dtype="float32",
) -> MFModel:
    """Scaled-normal init with the reference's scale, 1/sqrt(rank) by
    default, on the generator's device unless ``device`` names it (the
    two must agree), in table ``dtype`` (``'float32'`` or ``'bfloat16'``:
    drawn in f32, then rounded, ``mu`` too). The draws differ from the
    reference's ``jax.random`` ones; tests hand tables across with
    ``mfx_torch.convert.model_from_numpy`` instead."""
    if device is None:
        device = generator.device
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
    ).astype(dtype)


def baseline_biases(
    coo, mu: float | None = None, damping: float = 10.0,
    device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Damped-mean bias initialization (Koren's baseline predictor), the
    counterpart of ``mfx/models/mf.py::baseline_biases``: item biases are
    the damped mean residual against the global mean, user biases the
    damped mean of the item-corrected residual —

        b_i = Σ_{u∈R(i)} (r_ui − μ) / (λ + |R(i)|)
        b_u = Σ_{i∈R(u)} (r_ui − μ − b_i) / (λ + |R(u)|)

    Four scatter-adds on ``device`` (the card unless told otherwise),
    each through ``kernels.packing.row_add``. Returns ``(bu, bi)`` as
    float32; the driver wires it for ``model.bias_init='baseline'``."""
    from mfx_torch.kernels.packing import row_add

    f = torch.float32
    u = torch.as_tensor(coo.user).to(device).long()
    i = torch.as_tensor(coo.item).to(device).long()
    r = torch.as_tensor(coo.rating).to(device, f)
    mu = float(coo.global_mean) if mu is None else float(mu)
    res = r - mu
    ones = torch.ones_like(res)
    cnt_i = torch.zeros(coo.num_items, dtype=f, device=device)
    row_add(cnt_i, i, ones)
    bi = torch.zeros(coo.num_items, dtype=f, device=device)
    row_add(bi, i, res)
    bi = bi / (damping + cnt_i)
    res_u = res - bi[i]
    cnt_u = torch.zeros(coo.num_users, dtype=f, device=device)
    row_add(cnt_u, u, ones)
    bu = torch.zeros(coo.num_users, dtype=f, device=device)
    row_add(bu, u, res_u)
    return bu / (damping + cnt_u), bi
