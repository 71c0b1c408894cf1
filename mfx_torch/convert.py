"""Carry model tables between the JAX reference and the port as numpy.

``init_model`` in the reference draws from ``jax.random``, whose bits torch
cannot reproduce; the parity tests therefore hand the same initial tables
to both packages through these two functions.
"""

from __future__ import annotations

import numpy as np
import torch

from mfx_torch.models.mf import MFModel

__all__ = ["model_from_numpy", "model_to_numpy"]


def model_from_numpy(arrays: dict, device: torch.device | str = "cpu") -> MFModel:
    """``{"P", "Q", "bu", "bi", "mu"}`` numpy arrays (e.g. the reference
    ``MFModel``'s fields through ``np.asarray``) -> an ``MFModel`` on
    ``device``. The tables are copied."""
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
