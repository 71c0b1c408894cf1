"""The JAX reference's SVD++ trainer through its own driver on the CPU,
beside ``chip_smoke.py`` phase 30 (a), which runs the port's through the
CLI on the card.

    JAX_PLATFORMS=cpu python tools/svdpp_check.py [--epochs 20] \
        [--dup-trust 16]

``ml1m_rank32_biased`` unchanged but for ``solver=svdpp`` (the preset's
``svdpp`` section, ``SVDPPConfig``'s defaults), ``svdpp.epochs`` and
``svdpp.dup_trust``: the loader's ML-1M-shaped synthetic (seed 101, whole
stars, user Zipf 0.6), the preset's split and the reference's seeded init.
Then the preset's minibatch biased MF on the same data and split,
``solver=sgd sgd.partitioner=fixed sgd.kernel=jnp`` with the same epochs
and ``sgd.dup_trust``. Prints each run's train RMSE after every epoch and
its held-out RMSE and MAE (clipped to [0.5, 5], as the driver reports
them), and the seconds each run took.

Without ``dup_trust`` both of the reference's trainers reach NaN in the
first epoch on this synthetic (its user Zipf skew puts hot rows many times
in a batch of 8,192: the duplicate deltas add up), so the default is 16,
as ``chip_smoke.py`` phase 16 sets it for the minibatch timeSVD trainer.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from mfx.config import apply_overrides, preset  # noqa: E402
from mfx.train.driver import train  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--dup-trust", type=float, default=16.0)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    e, d = args.epochs, args.dup_trust
    for name, ov in (
        ("svdpp", ["solver=svdpp", f"svdpp.epochs={e}",
                   f"svdpp.dup_trust={d}"]),
        ("minibatch MF", ["solver=sgd", "sgd.partitioner=fixed",
                          "sgd.kernel=jnp", f"sgd.epochs={e}",
                          f"sgd.dup_trust={d}"]),
    ):
        cfg = apply_overrides(preset("ml1m_rank32_biased"), ov)
        t0 = time.perf_counter()
        res = train(cfg, resume=False)
        trains = [r["train_metric"] for r in res.history]
        print(f"{name} ({' '.join(ov)}): {res.epochs_run} epochs in "
              f"{time.perf_counter() - t0:.1f} s; train_rmse "
              + " ".join(f"{x:.5f}" for x in trains)
              + f"; held-out rmse {res.test_rmse:.6f} mae "
              f"{res.test_mae:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
