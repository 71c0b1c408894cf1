"""The JAX reference's blocked trainer on a CPU cut of a preset's cell in
the settings that reach each form of the training kernels, beside
``chip_smoke.py``, which runs the port's trainer at full size.

    JAX_PLATFORMS=cpu python tools/bias_mode_check.py --cut 5
    JAX_PLATFORMS=cpu python tools/bias_mode_check.py \\
        --preset ml1m_rank32_biased --cut 1
    JAX_PLATFORMS=cpu python tools/bias_mode_check.py \\
        --preset ml1m_rank32_biased --cut 1 --rank 16

The preset's synthetic with users and ratings divided by ``--cut`` and
every item kept, so that a stratum of the preset's blocks holds about the
ratings it holds at full size; the preset's split; ``train_epochs_blocked``
(Pallas in interpret mode, the device planner) with the preset unchanged
but for its depth (``--epochs``) and each run's overrides, every run from
the same seeded model (biases at 0, as the presets start).

``ml25m_rank64`` (phase 18; the ML-25M-shaped synthetic, seed 102, half
stars, user Zipf 0.6; 2 epochs): ``bias_mode`` 'lane' (the preset),
'epoch', 'tile', and 'tile' with ``model.use_bias=false``. The preset's
automatic threshold (``sgd.dense_chi=-1``) would carve every stratum of a
cut densely (its fixed sparse cost outweighs the few strata below
break-even), so the cut takes the threshold that the automatic rule sets
at full size, computed here from the full-size training split's
histogram, and carves the same kind of strata as the full cell.

``ml1m_rank32_biased`` (phase 20; the ML-1M-shaped synthetic, seed 101,
whole stars, user Zipf 0.6; 30 epochs): (a) ``sgd.bias_mode=lane`` (no
dense phase), (b) ``sgd.dense_span=full sgd.dense_chi=-1`` (tile biases,
every stratum dense on the full data), (c) (b) with
``sgd.bias_mode=lane``, (d) (b) with ``model.use_bias=false``.

``--rank R`` runs the preset unchanged but for ``model.rank=R`` instead
(phase 28 (a)-(c) at ranks 16, 8 and 4, (a2) and (a1) at ranks 2 and 1:
tile biases, no dense phase, which needs 128 // rank in (1, 2, 4)).

Prints the threshold where it is fixed, each run's train RMSE and
held-out RMSE (unclipped) after every epoch, the untrained model's, and
the dense share.
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

from mfx.config import apply_overrides, preset  # noqa: E402
from mfx.data.split import train_test_split  # noqa: E402
from mfx.data.synthetic import ML1M_SHAPE, ML25M_SHAPE, make_synthetic  # noqa: E402
from mfx.eval.metrics import rmse_mae  # noqa: E402
from mfx.models.mf import init_model  # noqa: E402
from mfx.solvers.dense_prep import auto_dense_threshold  # noqa: E402
from mfx.solvers.blocked import train_epochs_blocked  # noqa: E402

DENSE = ["sgd.dense_span=full", "sgd.dense_chi=-1"]
# per preset: its synthetic (shape, rank, seed, star step), the default
# cut and depth, whether the cut takes the full size's threshold, and the
# runs' overrides
CELLS = {
    "ml25m_rank64": (ML25M_SHAPE, 64, 102, 0.5, 5, 2, True, {
        "bias_mode=lane": [],
        "bias_mode=epoch": ["sgd.bias_mode=epoch"],
        "bias_mode=tile": ["sgd.bias_mode=tile"],
        "use_bias=false": ["sgd.bias_mode=tile", "model.use_bias=false"]}),
    "ml1m_rank32_biased": (ML1M_SHAPE, 32, 101, 1.0, 4, 30, False, {
        "(a)": ["sgd.bias_mode=lane"], "(b)": DENSE,
        "(c)": ["sgd.bias_mode=lane"] + DENSE,
        "(d)": ["model.use_bias=false"] + DENSE}),
}


def full_size_chi(shape, rank, seed, star_step, cfg) -> float:
    """The automatic rule's threshold on the full-size training split, as
    a fraction of a stratum."""
    b = cfg.sgd.ublock
    full, _ = train_test_split(
        make_synthetic(*shape, rank=rank, seed=seed, star_step=star_step,
                       user_zipf_s=0.6), cfg.data.test_frac,
        seed=cfg.data.seed)
    C = -(-shape[1] // b)
    counts = np.bincount((full.user // b).astype(np.int64) * C
                         + full.item // b)
    thresh = auto_dense_threshold(counts, b, b, "int4")
    chi = thresh / (b * b)
    print(f"full size: automatic threshold {thresh:.4f} ratings a stratum "
          f"(chi {chi:.7f}), dense share "
          f"{counts[counts >= thresh].sum() / counts.sum():.4f}", flush=True)
    return chi


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(CELLS), default="ml25m_rank64")
    ap.add_argument("--cut", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None,
                    help="run the preset unchanged but for model.rank")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    shape, rank, seed, star, cut, epochs, fixed_chi, runs = CELLS[args.preset]
    if args.rank is not None:
        runs = {f"rank {args.rank}": [f"model.rank={args.rank}"]}
    cut, epochs = args.cut or cut, args.epochs or epochs
    base = preset(args.preset)
    chi = (full_size_chi(shape, rank, seed, star, base) if fixed_chi
           else None)
    U, N, I = shape[0] // cut, shape[2] // cut, shape[1]
    coo = make_synthetic(U, I, N, rank=rank, seed=seed, star_step=star,
                         user_zipf_s=0.6)
    train, test = train_test_split(coo, base.data.test_frac,
                                   seed=base.data.seed)
    model = init_model(base.model.seed, U, I, args.rank or base.model.rank,
                       global_mean=train.global_mean)
    print(f"cut 1/{cut}: {U} x {I}, {train.n_ratings} train / "
          f"{test.n_ratings} test; untrained held-out rmse "
          f"{rmse_mae(model, test)[0]:.5f}", flush=True)
    for name, over in runs.items():
        cfg = apply_overrides(base, over + [f"sgd.epochs={epochs}",
                                            "sgd.plan_device=device"])
        if chi is not None:
            cfg = dataclasses.replace(
                cfg, sgd=dataclasses.replace(cfg.sgd, dense_chi=chi))
        t0 = time.time()
        timings: dict = {}
        trains, tests = [], []
        for _, view, tr in train_epochs_blocked(
                model, train, cfg.sgd, cfg.model.use_bias,
                seed=cfg.data.seed, timings=timings):
            trains.append(float(tr))
            tests.append(rmse_mae(view.materialize(), test)[0])
        print(f"{name} {' '.join(over)}: dense_frac "
              f"{timings.get('dense_info', {}).get('dense_frac', 0.0):.4f}; "
              f"train_rmse {' '.join(f'{x:.5f}' for x in trains)}; held-out "
              f"rmse {' '.join(f'{x:.5f}' for x in tests)} "
              f"({time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
