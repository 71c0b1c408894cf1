"""Carry model tables between the JAX reference and the port as numpy.

``init_model`` in the reference draws from ``jax.random``, whose bits torch
cannot reproduce; the parity tests therefore hand the same initial tables
to both packages through ``model_from_numpy`` / ``model_to_numpy``.

``merged_to_plain`` / ``plain_to_merged`` read and write the reference
kernels' merged table layout (``mfx/kernels/packing.py::pack_state``), so
that the kernel tests can run one state through both packages' sweeps.
"""

from __future__ import annotations

import numpy as np
import torch

from mfx_torch.models.mf import MFModel
from mfx_torch.models.timesvd import TimeSVDModel

__all__ = ["model_from_numpy", "model_to_numpy", "timesvd_from_numpy",
           "merged_to_plain", "plain_to_merged"]

_LANES = 128     # lanes of a merged row
_BIAS_ROWS = 8   # bias rows behind each block's factor rows


def model_from_numpy(arrays: dict,
                     device: torch.device | str = "cuda") -> MFModel:
    """``{"P", "Q", "bu", "bi", "mu"}`` numpy arrays (e.g. the reference
    ``MFModel``'s fields through ``np.asarray``) -> an ``MFModel`` on
    ``device``, the card unless told otherwise. The tables are copied."""
    t = {
        k: torch.tensor(np.asarray(arrays[k]), dtype=torch.float32,
                        device=device)
        for k in ("P", "Q", "bu", "bi")
    }
    return MFModel(t["P"], t["Q"], t["bu"], t["bi"],
                   mu=float(np.asarray(arrays["mu"])))


def model_to_numpy(model: MFModel) -> dict:
    """Inverse of :func:`model_from_numpy`: host numpy copies of the
    tables, ``mu`` as a 0-d float32 array (the reference's dtype)."""
    out = {k: getattr(model, k).detach().cpu().numpy().copy()
           for k in ("P", "Q", "bu", "bi")}
    out["mu"] = np.asarray(model.mu, np.float32)
    return out


def timesvd_from_numpy(arrays: dict,
                       device: torch.device | str = "cuda") -> TimeSVDModel:
    """``{"P", "Q", "bu", "bi", "mu", "bt", "alpha"}`` numpy arrays (the
    reference ``TimeSVDModel``'s fields through ``np.asarray``) -> a
    ``TimeSVDModel`` on ``device``, the card unless told otherwise. The
    tables are copied."""
    m = model_from_numpy(arrays, device=device)
    t = {k: torch.tensor(np.asarray(arrays[k]), dtype=torch.float32,
                         device=device) for k in ("bt", "alpha")}
    return TimeSVDModel(m.P, m.Q, m.bu, m.bi, m.mu, t["bt"], t["alpha"])


def _split_merged(M: np.ndarray, rank: int, block: int):
    """One merged table ``(nb * (block/pack + 8), 128)`` -> padded
    ``(nb * block, rank)`` factors and ``(nb * block,)`` biases. Factor
    row x of a block sits at packed row ``x // pack``, lanes
    ``(x % pack) * rank ...``; its bias at bias row ``x // 128``, lane
    ``x % 128``."""
    pack = _LANES // rank
    sup = block // pack
    M = np.asarray(M, np.float32).reshape(-1, sup + _BIAS_ROWS, _LANES)
    nb = M.shape[0]
    F = M[:, :sup].reshape(nb * block, rank)
    b = M[:, sup:sup + block // _LANES].reshape(nb * block)
    return F.copy(), b.copy()


def _join_merged(F: np.ndarray, b: np.ndarray, rank: int, block: int):
    """Inverse of :func:`_split_merged` (unused bias rows zero)."""
    pack = _LANES // rank
    sup = block // pack
    nb = F.shape[0] // block
    M = np.zeros((nb, sup + _BIAS_ROWS, _LANES), np.float32)
    M[:, :sup] = np.asarray(F, np.float32).reshape(nb, sup, _LANES)
    M[:, sup:sup + block // _LANES] = np.asarray(b, np.float32).reshape(
        nb, block // _LANES, _LANES)
    return M.reshape(nb * (sup + _BIAS_ROWS), _LANES)


def merged_to_plain(Pm, Qm, rank: int, su: int, si: int):
    """The reference's merged kernel tables (numpy) -> the port's plain
    padded ``(P, Q, bu, bi)`` as CPU tensors (what
    ``mfx_torch.kernels.packing.plain_tables`` gives for the same model).
    ``su`` and ``si`` are multiples of 128, at most 1024, and ``rank``
    divides 128, as ``pack_state`` demands."""
    P, bu = _split_merged(Pm, rank, su)
    Q, bi = _split_merged(Qm, rank, si)
    return tuple(torch.from_numpy(x) for x in (P, Q, bu, bi))


def plain_to_merged(P, Q, bu, bi, su: int, si: int):
    """Inverse of :func:`merged_to_plain`: padded plain tensors -> the
    merged ``(Pm, Qm)`` numpy arrays."""
    rank = P.shape[1]
    P, Q, bu, bi = (x.detach().cpu().numpy() for x in (P, Q, bu, bi))
    return _join_merged(P, bu, rank, su), _join_merged(Q, bi, rank, si)
