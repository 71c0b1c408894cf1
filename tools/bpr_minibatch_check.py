"""The JAX reference's snapshot-minibatch BPR trainer on the CPU, beside
``chip_smoke.py`` phase 31, which runs the port's on the card.

    JAX_PLATFORMS=cpu python tools/bpr_minibatch_check.py [--cut 10] \
        [--epochs 2]

The cell is phase 31 (b)-(d)'s learnable synthetic with its users and
positives cut to 1/``cut`` (the catalog and the density kept):
``make_implicit_synthetic(50_000 // cut, 5_000, 10_000_000 // cut,
rank=8, seed=107)``, 1% held out (split seed 0). The model is
``billion_bpr_sharded``'s (rank 64, no biases, its ``init_scale``), its
``bpr`` section with ``sample_device='host'``: batch 131,072, lr 0.05,
reg 0.002. The tables start from the port's seeded init on the CPU
(``mfx_torch.models.mf.init_model`` with ``torch.Generator().manual_seed
(model.seed)``), handed to both packages, so the card can start from the
same bits. For f32 and bf16 tables with uniform negatives and f32 with
popularity ones: ``mfx.solvers.bpr.train_epochs_bpr``, then the port's
``train_epochs_bpr`` on the CPU from the same tables; prints, one JSON
line a run, each epoch's mean loss of both, the largest table difference
between them after each epoch, the held-out sampled AUC before and after
(the reference's model) and the seconds each trainer took.
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
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mfx.config import BPRConfig  # noqa: E402
from mfx.data.bpr import build_positive_index  # noqa: E402
from mfx.data.split import train_test_split  # noqa: E402
from mfx.data.synthetic import make_implicit_synthetic  # noqa: E402
from mfx.eval.metrics import sampled_auc  # noqa: E402
from mfx.models.mf import MFModel  # noqa: E402
from mfx.solvers.bpr import train_epochs_bpr  # noqa: E402
from mfx_torch.config import BPRConfig as BPRConfigT  # noqa: E402
from mfx_torch.config import preset  # noqa: E402
from mfx_torch.convert import model_from_numpy  # noqa: E402
from mfx_torch.models.mf import init_model as init_model_t  # noqa: E402
from mfx_torch.solvers.bpr import train_epochs_bpr as train_t  # noqa: E402

LEARN = (50_000, 5_000, 10_000_000, 8)  # chip_smoke.py IALS_LEARN


def cell(cut: int):
    U, I, n, true_rank = LEARN
    coo = make_implicit_synthetic(U // cut, I, n // cut, rank=true_rank,
                                  seed=107)
    return train_test_split(coo, 0.01, seed=0)


def init_tables(num_users: int, num_items: int) -> dict:
    """The port's seeded init on the CPU, as NumPy arrays."""
    cfg = preset("billion_bpr_sharded")
    g = torch.Generator()
    g.manual_seed(cfg.model.seed)
    m = init_model_t(g, num_users, num_items, cfg.model.rank,
                     init_scale=cfg.model.init_scale, device="cpu")
    return {"P": m.P.numpy(), "Q": m.Q.numpy()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cut", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    train, test = cell(args.cut)
    U, I = train.num_users, train.num_items
    keys = np.sort(np.concatenate([build_positive_index(train),
                                   build_positive_index(test)]))
    tabs = init_tables(U, I)
    base = preset("billion_bpr_sharded").bpr
    print(json.dumps({"cell": [U, I, train.n_ratings, test.n_ratings],
                      "made_s": round(time.perf_counter() - t0, 1)}),
          flush=True)
    for dtype, weighting in (("float32", "uniform"), ("bfloat16", "uniform"),
                             ("float32", "popularity")):
        cfg = BPRConfig(lr=base.lr, reg=base.reg, epochs=args.epochs,
                        batch_size=base.batch_size, kernel="jnp",
                        sample_device="host", neg_weighting=weighting)
        dt = jnp.dtype(dtype)
        m0 = MFModel(P=jnp.asarray(tabs["P"], dt), Q=jnp.asarray(tabs["Q"], dt),
                     bu=jnp.zeros(U, dt), bi=jnp.zeros(I, dt),
                     mu=jnp.zeros((), dt))
        auc0 = sampled_auc(m0, test, seed=0, pos_keys=keys)
        t1 = time.perf_counter()
        ref = [(loss, m) for _, m, loss in train_epochs_bpr(m0, train, cfg)]
        t2 = time.perf_counter()
        mt = model_from_numpy({**tabs, "bu": np.zeros(U), "bi": np.zeros(I),
                               "mu": 0.0}, device="cpu", dtype=dtype)
        got = [(loss, m) for _, m, loss in train_t(
            mt, train, BPRConfigT(**dataclasses.asdict(cfg)), device="cpu")]
        t3 = time.perf_counter()
        diff = [max(float(np.abs(np.asarray(getattr(mj, k).astype(
            jnp.float32)) - getattr(mp, k).float().numpy()).max())
            for k in ("P", "Q")) for (_, mj), (_, mp) in zip(ref, got)]
        print(json.dumps({
            "dtype": dtype, "neg_weighting": weighting,
            "loss_ref": [lj for lj, _ in ref],
            "loss_port": [lt for lt, _ in got],
            "max_table_diff": diff,
            "auc_untrained": auc0,
            "auc_ref": sampled_auc(ref[-1][1], test, seed=0, pos_keys=keys),
            "ref_s": round(t2 - t1, 1), "port_s": round(t3 - t2, 1)}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
