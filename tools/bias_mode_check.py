"""The JAX reference's blocked trainer on a CPU cut of the ``ml25m_rank64``
cell in each bias mode, beside ``chip_smoke.py`` phase 18, which
runs the port's trainer at full size.

    JAX_PLATFORMS=cpu python tools/bias_mode_check.py --cut 5

The ML-25M-shaped synthetic (seed 102, half stars, user Zipf 0.6) with
users and ratings divided by ``--cut`` and every item kept, so that a
stratum of the preset's 1024 x 1024 blocks holds about the ratings it
holds at full size; the preset's split; ``train_epochs_blocked`` (Pallas
in interpret mode) with ``ml25m_rank64`` unchanged but for its depth
(``--epochs``, 2) and its carving threshold, in four runs: ``bias_mode``
'lane' (the preset), 'epoch', 'tile', and ``model.use_bias=false``, each
from the same seeded model (biases at 0, as the preset starts). The
preset's automatic threshold (``sgd.dense_chi=-1``) would carve every
stratum of a cut densely (its fixed sparse cost outweighs the few strata
below break-even), so the cut takes the threshold that the automatic
rule sets at full size, computed here from the full-size training split's
histogram, and carves the same kind of strata as the full cell. Prints
the threshold, each epoch's train RMSE and held-out RMSE (unclipped), the
untrained model's, and the dense share.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from mfx.config import preset  # noqa: E402
from mfx.data.split import train_test_split  # noqa: E402
from mfx.data.synthetic import ML25M_SHAPE, make_synthetic  # noqa: E402
from mfx.eval.metrics import rmse_mae  # noqa: E402
from mfx.models.mf import init_model  # noqa: E402
from mfx.solvers.dense_prep import auto_dense_threshold  # noqa: E402
from mfx.solvers.blocked import train_epochs_blocked  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cut", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    cfg = preset("ml25m_rank64")
    b = cfg.sgd.ublock
    full, _ = train_test_split(
        make_synthetic(*ML25M_SHAPE, rank=64, seed=102, star_step=0.5,
                       user_zipf_s=0.6), cfg.data.test_frac,
        seed=cfg.data.seed)
    C = -(-ML25M_SHAPE[1] // b)
    counts = np.bincount((full.user // b).astype(np.int64) * C
                         + full.item // b)
    thresh = auto_dense_threshold(counts, b, b, "int4")
    chi = thresh / (b * b)
    print(f"full size: automatic threshold {thresh:.4f} ratings a stratum "
          f"(chi {chi:.7f}), dense share "
          f"{counts[counts >= thresh].sum() / counts.sum():.4f}", flush=True)
    del full, counts
    U, N = ML25M_SHAPE[0] // args.cut, ML25M_SHAPE[2] // args.cut
    I = ML25M_SHAPE[1]
    coo = make_synthetic(U, I, N, rank=64, seed=102, star_step=0.5,
                         user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    model = init_model(cfg.model.seed, U, I, cfg.model.rank,
                       global_mean=train.global_mean)
    print(f"cut 1/{args.cut}: {U} x {I}, {train.n_ratings} train / "
          f"{test.n_ratings} test; untrained held-out rmse "
          f"{rmse_mae(model, test)[0]:.5f}", flush=True)
    for mode, use_bias in (("lane", True), ("epoch", True), ("tile", True),
                           ("tile", False)):
        sgd = dataclasses.replace(cfg.sgd, bias_mode=mode,
                                  epochs=args.epochs, plan_device="device",
                                  dense_chi=chi)
        t0 = time.time()
        timings: dict = {}
        trains, tests = [], []
        for _, view, tr in train_epochs_blocked(model, train, sgd, use_bias,
                                                seed=cfg.data.seed,
                                                timings=timings):
            trains.append(float(tr))
            tests.append(rmse_mae(view.materialize(), test)[0])
        name = f"bias_mode={mode}" if use_bias else "use_bias=false"
        print(f"{name}: dense_frac "
              f"{timings.get('dense_info', {}).get('dense_frac', 0.0):.4f}; "
              f"train_rmse {' '.join(f'{x:.5f}' for x in trains)}; held-out "
              f"rmse {' '.join(f'{x:.5f}' for x in tests)} "
              f"({time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
