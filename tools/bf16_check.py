"""The JAX reference's minibatch trainer with bf16 and f32 factor tables
on the full ``ml100k_rank16`` cell, on the CPU, beside ``chip_smoke.py``
phase 24, which runs the port's trainer with ``model.dtype=bfloat16`` at
the same size on the card.

    JAX_PLATFORMS=cpu python tools/bf16_check.py [--epochs 30]

The preset unchanged (rank 16, no biases, conflict-free batches of 2,048,
its 30 epochs) on the ML-100K-shaped synthetic (``load_dataset('ml-100k')``
without a cache) and the preset's split, through the training driver's own
calls: ``init_model(model.seed, dtype=...)`` and
``mfx.solvers.sgd.train_epochs`` (``kernel='jnp'``), the held-out RMSE
clipped to [0.5, 5] as the training driver reports it. Prints, for each
table dtype, the train RMSE and held-out RMSE after every epoch, one JSON
line a dtype.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mfx.config import preset  # noqa: E402
from mfx.data.loaders import load_dataset  # noqa: E402
from mfx.data.split import train_test_split  # noqa: E402
from mfx.eval.metrics import rmse_mae  # noqa: E402
from mfx.models.mf import init_model  # noqa: E402
from mfx.solvers.sgd import train_epochs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=None,
                    help="depth (default: the preset's 30)")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    cfg = preset("ml100k_rank16")
    sgd = cfg.sgd if args.epochs is None else dataclasses.replace(
        cfg.sgd, epochs=args.epochs)
    coo = load_dataset(cfg.data.dataset, cache=False)
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    clip = (0.5, 5.0) if cfg.clip_predictions else None
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        model = init_model(cfg.model.seed, coo.num_users, coo.num_items,
                           cfg.model.rank, global_mean=train.global_mean,
                           init_scale=cfg.model.init_scale,
                           dtype=jnp.dtype(dtype))
        trains, tests = [], []
        for _ep, model, tr in train_epochs(model, train, sgd,
                                           cfg.model.use_bias,
                                           seed=cfg.data.seed):
            trains.append(round(float(tr), 6))
            tests.append(round(rmse_mae(model, test, clip=clip)[0], 6))
        print(json.dumps({
            "preset": cfg.name, "dtype": dtype, "epochs": sgd.epochs,
            "train_rmse": trains, "test_rmse": tests,
            "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
