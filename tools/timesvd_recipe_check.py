"""The JAX reference's timeSVD trainers on a CPU cut of the temporal recipe
that ``chip_smoke.py`` phases 15-16 run at full size on the port.

    JAX_PLATFORMS=cpu python tools/timesvd_recipe_check.py blocked --cut 200
    JAX_PLATFORMS=cpu python tools/timesvd_recipe_check.py jnp --cut 4 \
        [--dup-trust 16]
    JAX_PLATFORMS=cpu python tools/timesvd_recipe_check.py windows --cut 20

The recipe is ``chip_smoke.temporal`` itself (tests/unit/
test_timesvd_blocked.py's, on TimeSVDConfig's 30 bins): the seeded
synthetic, timestamps in [0, 1e6), a N(0, 0.35) shift per (item, calendar
bin), ratings clipped to [0.5, 5].

- ``blocked``: the ML-25M-shaped synthetic (seed 102) with users, items and
  ratings all divided by ``--cut`` (so ratings per item and per (item, bin)
  stay those of the full size); ``train_epochs_timesvd_blocked`` (Pallas in
  interpret mode) with TimeSVDConfig's defaults and reg_alpha = reg, then
  lane-biased MF (``train_epochs_blocked``, no dense phase) with the same
  rank, blocks, epochs, lr and reg; prints each epoch's train RMSE and
  held-out RMSE (time-aware for timeSVD), unclipped, and the untrained
  model's. Phase 16's gate is that timeSVD ends below both.
- ``jnp``: the ML-1M-shaped synthetic (seed 101) with users and ratings
  divided by ``--cut`` (items kept, so each item's share of a batch is the
  full size's); ``train_epochs_timesvd`` with TimeSVDConfig's defaults and
  ``--dup-trust``; prints each epoch's train RMSE and clipped time-aware
  held-out RMSE.
- ``windows``: the ML-25M-shaped synthetic with users and ratings divided
  by ``--cut`` (items kept); the share of the ratings in each of the five
  fullest windows of 512 items (the blocked timeSVD trainer's si), whose
  first sets the sweep's critical path.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import temporal  # noqa: E402
from mfx.config import SGDConfig, TimeSVDConfig  # noqa: E402
from mfx.data.split import train_test_split  # noqa: E402
from mfx.data.synthetic import ML1M_SHAPE, ML25M_SHAPE, make_synthetic  # noqa: E402
from mfx.eval.metrics import rmse_mae  # noqa: E402
from mfx.models.mf import init_model  # noqa: E402
from mfx.models.timesvd import fit_time_features  # noqa: E402
from mfx.solvers.blocked import train_epochs_blocked  # noqa: E402
from mfx.solvers.timesvd import rmse_mae_time, train_epochs_timesvd  # noqa: E402
from mfx.solvers.timesvd_blocked import train_epochs_timesvd_blocked  # noqa: E402


def blocked(cut: int, epochs: int) -> None:
    U, I, N = (x // cut for x in ML25M_SHAPE)
    coo = temporal(make_synthetic(U, I, N, rank=64, seed=102, star_step=0.5,
                                  user_zipf_s=0.6), 102)
    train, test = train_test_split(coo, 0.1, seed=0)
    cfg = TimeSVDConfig(kernel="pallas", reg_alpha=TimeSVDConfig().reg,
                        epochs=epochs)
    feats = fit_time_features(train, n_bins=cfg.n_bins, beta=cfg.beta)
    m0 = init_model(0, U, I, 64, global_mean=train.global_mean)
    print(f"cut {cut}: {U} x {I}, {N} ratings; untrained held-out RMSE "
          f"{rmse_mae(m0, test)[0]:.5f}", flush=True)
    t0 = time.time()
    for ep, m, tr in train_epochs_timesvd_blocked(m0, train, cfg, seed=0,
                                                  interpret=True,
                                                  feats=feats):
        print(f"timesvd epoch {ep}: train {float(tr):.5f} held-out "
              f"(time-aware) {rmse_mae_time(m, feats, test)[0]:.5f} "
              f"[{time.time() - t0:.1f} s]", flush=True)
    mf_cfg = SGDConfig(lr=cfg.lr, reg=cfg.reg, lr_decay=cfg.lr_decay,
                       epochs=epochs, partitioner="blocked", kernel="pallas",
                       ublock=512, iblock=512, tile=256, bias_mode="lane",
                       dense_chi=0)
    for ep, m, tr in train_epochs_blocked(m0, train, mf_cfg, use_bias=True,
                                          seed=0, interpret=True):
        m = m.materialize() if hasattr(m, "materialize") else m
        print(f"lane MF epoch {ep}: train {float(tr):.5f} held-out "
              f"{rmse_mae(m, test)[0]:.5f} [{time.time() - t0:.1f} s]",
              flush=True)


def minibatch(cut: int, epochs: int, dup_trust: float) -> None:
    U, I, N = ML1M_SHAPE[0] // cut, ML1M_SHAPE[1], ML1M_SHAPE[2] // cut
    coo = temporal(make_synthetic(U, I, N, rank=32, seed=101, star_step=1.0,
                                  user_zipf_s=0.6), 101)
    train, test = train_test_split(coo, 0.1, seed=0)
    cfg = TimeSVDConfig(dup_trust=dup_trust, epochs=epochs)
    feats = fit_time_features(train, n_bins=cfg.n_bins, beta=cfg.beta)
    m0 = init_model(0, U, I, 32, global_mean=train.global_mean)
    top = np.sort(np.bincount(coo.item))[::-1][0] / N
    print(f"cut {cut}: {U} x {I}, {N} ratings; the top item's share "
          f"{top:.4f}; untrained held-out RMSE "
          f"{rmse_mae(m0, test, clip=(0.5, 5.0))[0]:.5f}", flush=True)
    for ep, m, tr in train_epochs_timesvd(m0, train, cfg, seed=0,
                                          feats=feats):
        rm = rmse_mae_time(m, feats, test, clip=(0.5, 5.0))[0]
        print(f"jnp epoch {ep}: train {tr:.5f} held-out (time-aware, "
              f"clipped) {rm:.5f}", flush=True)


def windows(cut: int) -> None:
    U, I, N = ML25M_SHAPE[0] // cut, ML25M_SHAPE[1], ML25M_SHAPE[2] // cut
    coo = make_synthetic(U, I, N, rank=64, seed=102, star_step=0.5,
                         user_zipf_s=0.6)
    share = np.sort(np.bincount(coo.item // 512))[::-1][:5] / N
    print(f"cut {cut}: {U} x {I}, {N} ratings; the fullest windows of 512 "
          f"items hold {' '.join(f'{x:.4f}' for x in share)} of them")


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", choices=("blocked", "jnp", "windows"))
    ap.add_argument("--cut", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=TimeSVDConfig().epochs)
    ap.add_argument("--dup-trust", type=float, default=0.0)
    args = ap.parse_args()
    if args.which == "blocked":
        blocked(args.cut, args.epochs)
    elif args.which == "windows":
        windows(args.cut)
    else:
        minibatch(args.cut, args.epochs, args.dup_trust)


if __name__ == "__main__":
    main()
