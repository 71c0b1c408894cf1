"""Checkpoints, the counterpart of ``mfx/train/checkpoint.py`` in the
reference's own ``.npz`` layout: ``<dir>/<step>.npz`` holding ``P, Q, bu,
bi, mu, epoch, seed, data_version``. The reference's ``load_checkpoint``
reads these files unchanged (it falls back to npz when ``<dir>/<step>`` is
not an Orbax directory), and this module reads the reference's npz
checkpoints. Orbax directories are not read here: export them first
(``python -m mfx.cli export``).

Saves are synchronous and atomic (written to a temporary file, then
renamed), so a reader never sees a half-written step.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np
import torch

from mfx_torch.data.loaders import GENERATOR_VERSION
from mfx_torch.models.mf import MFModel

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


def save_checkpoint(ckpt_dir, step: int, model: MFModel, seed: int = 0) -> str:
    """Write ``<ckpt_dir>/<step>.npz``; returns ``<ckpt_dir>/<step>``. The
    state carries the dataset generator version its ids were trained
    under (``data_version``), which :func:`load_checkpoint` checks."""
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"{step}"
    state = {k: getattr(model, k).detach().cpu().numpy()
             for k in ("P", "Q", "bu", "bi")}
    state.update(
        mu=np.asarray(model.mu, np.float32),
        epoch=np.asarray(step, np.int32),
        seed=np.asarray(seed, np.int32),
        data_version=np.asarray(GENERATOR_VERSION, np.int32),
    )
    tmp = ckpt_dir / f".{step}.npz.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **state)
    os.replace(tmp, str(path) + ".npz")
    return str(path)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        name = p.name.removesuffix(".npz")
        if name.isdigit():
            steps.append(int(name))
    return max(steps) if steps else None


def load_checkpoint(
    ckpt_dir, step: int | None = None, device: torch.device | str = "cuda"
) -> tuple[MFModel, int, int]:
    """Returns (model on ``device``, the card unless told otherwise, epoch,
    seed). Raises FileNotFoundError if absent, and ValueError for an Orbax
    checkpoint directory."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = ckpt_dir / f"{step}"
    if path.is_dir():
        raise ValueError(
            f"{path} is an Orbax checkpoint, which mfx_torch does not read: "
            f"export it with `python -m mfx.cli export --checkpoint "
            f"{ckpt_dir} --out model.npz` and load that with "
            "mfx_torch.models.mf.MFModel.load_npz"
        )
    with np.load(str(path) + ".npz") as z:
        state = {k: z[k] for k in z.files}

    saved_ver = int(state.get("data_version", 0)) or None
    if saved_ver != GENERATOR_VERSION:
        warnings.warn(
            f"checkpoint {path} was trained under dataset generator "
            f"version {saved_ver or '<pre-v6 (unstamped)>'} but this "
            f"build parses datasets at version {GENERATOR_VERSION}; "
            "dense user/item ids are frequency-relabeled per version, so "
            "serving/eval against a re-parsed dataset may index the "
            "WRONG rows. Re-train, or evaluate against the npz cache "
            "written by the same version.",
            stacklevel=2,
        )
    model = MFModel(
        *(torch.as_tensor(state[k], dtype=torch.float32, device=device)
          for k in ("P", "Q", "bu", "bi")),
        mu=float(state["mu"]),
    )
    return model, int(state["epoch"]), int(state["seed"])
