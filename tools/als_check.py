"""ALS on a cut of the ``netflix100m_rank128_dp`` cell on the CPU, sweep
by sweep, in either package: the JAX reference
(``mfx.solvers.als.train_sweeps_als``) or the port
(``mfx_torch.solvers.als.train_sweeps_als``), each in a process of its
own. ``chip_smoke.py`` phase 29(a) runs the port on the full cell on the
card.

    JAX_PLATFORMS=cpu python tools/als_check.py --package jax \\
        --cut 50 --item-cut 50 --tables ref.npz
    python tools/als_check.py --package torch --cut 50 --item-cut 50 \\
        --against ref.npz

The netflix synthetic of ``mfx/data/loaders.py`` (480,189 x 17,770,
100,480,507 ratings, seed 103, whole stars, user Zipf 0.6) with its users
and ratings divided by ``--cut`` and its items by ``--item-cut`` (1 keeps
them all). Cutting users, items and ratings by the same factor keeps
both sides' degree distributions, so the item rows keep the full cell's
degrees (thousands of ratings, many pieces of ``BUCKET_CAPS[-1]``, ALS-WR's
λ·n at that degree). The preset's split, rank 128 with biases and its
``als`` block (reg 0.05, 8 sweeps).

The JAX run starts from the reference's ``init_model`` with the preset's
seed and writes its initial tables and each sweep's tables to
``--tables``. The port's run reads them back from ``--against`` (so both
start from the same numpy tables) and prints beside each sweep the
largest absolute difference of each table from the reference's. Each
prints after every sweep the train and held-out RMSE (unclipped) and
ALS-WR's regularized objective

    Σ (r − μ − b_u − b_i − p_u·q_i)² + reg Σ_u n_u (‖p_u‖² + b_u²)
                                     + reg Σ_i n_i (‖q_i‖² + b_i²)

(each half-sweep is its exact block minimizer), in float64 on the host,
one JSON line a sweep.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

TABLES = ("P", "Q", "bu", "bi")


def objective(t, coo, reg) -> tuple[float, float]:
    """(ALS-WR's regularized objective, RMSE) of numpy tables ``t`` on
    ``coo``, in float64 on the host."""
    P, Q = t["P"].astype(np.float64), t["Q"].astype(np.float64)
    bu, bi = t["bu"].astype(np.float64), t["bi"].astype(np.float64)
    sse = 0.0
    for s in range(0, coo.n_ratings, 1 << 20):  # bounded float64 gathers
        u, i = coo.user[s:s + (1 << 20)], coo.item[s:s + (1 << 20)]
        e = (coo.rating[s:s + (1 << 20)] - float(t["mu"]) - bu[u] - bi[i]
             - np.einsum("nk,nk->n", P[u], Q[i]))
        sse += float(e @ e)
    nu = np.bincount(coo.user, minlength=P.shape[0])
    ni = np.bincount(coo.item, minlength=Q.shape[0])
    obj = sse + reg * float(nu @ ((P * P).sum(1) + bu * bu)
                            + ni @ ((Q * Q).sum(1) + bi * bi))
    return obj, float(np.sqrt(sse / max(coo.n_ratings, 1)))


def data_digest(coo) -> np.ndarray:
    """A cheap fingerprint of a split, to check that both packages made
    the same data."""
    return np.array([coo.n_ratings, coo.user.astype(np.int64).sum(),
                     coo.item.astype(np.int64).sum(),
                     coo.rating.astype(np.float64).sum()])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), default="jax")
    ap.add_argument("--cut", type=int, default=200,
                    help="divide the users and the ratings by this")
    ap.add_argument("--item-cut", type=int, default=1,
                    help="divide the items by this (1: keep them all)")
    ap.add_argument("--sweeps", type=int, default=None,
                    help="depth (default: the preset's als.sweeps)")
    ap.add_argument("--tables", default=None,
                    help="(jax) write the initial and each sweep's tables "
                         "to this .npz")
    ap.add_argument("--against", default=None,
                    help="(torch, required) the jax run's --tables file: "
                         "its initial tables, and each sweep's to compare")
    args = ap.parse_args(argv)
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from mfx.config import preset
        from mfx.data.split import train_test_split
        from mfx.data.synthetic import NETFLIX_SHAPE, make_synthetic
        from mfx.models.mf import init_model
        from mfx.solvers.als import train_sweeps_als

        def to_numpy(m):
            return {k: np.asarray(getattr(m, k), np.float32)
                    for k in TABLES} | {"mu": np.float32(m.mu)}
    else:
        if args.against is None:
            ap.error("--package torch needs --against (the jax run's "
                     "--tables)")
        from mfx_torch.config import preset
        from mfx_torch.convert import model_from_numpy, model_to_numpy
        from mfx_torch.data.split import train_test_split
        from mfx_torch.data.synthetic import NETFLIX_SHAPE, make_synthetic
        from mfx_torch.solvers.als import train_sweeps_als

        to_numpy = model_to_numpy
    cfg = preset("netflix100m_rank128_dp")
    acfg = cfg.als if args.sweeps is None else dataclasses.replace(
        cfg.als, sweeps=args.sweeps)
    U, I, n = NETFLIX_SHAPE
    coo = make_synthetic(U // args.cut, I // args.item_cut, n // args.cut,
                         rank=128, seed=103, star_step=1.0, user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    if args.package == "jax":
        model = init_model(cfg.model.seed, coo.num_users, coo.num_items,
                           cfg.model.rank, global_mean=train.global_mean,
                           init_scale=cfg.model.init_scale)
        saved = {f"init_{k}": v for k, v in to_numpy(model).items()}
        saved["digest"] = data_digest(train)
        ref = None
    else:
        ref = dict(np.load(args.against))
        if not np.array_equal(ref["digest"], data_digest(train)):
            raise SystemExit("the reference's training split differs from "
                             "this one: run both with the same --cut, "
                             "--item-cut")
        model = model_from_numpy(
            {k: ref[f"init_{k}"] for k in TABLES + ("mu",)}, device="cpu")
    init = to_numpy(model)
    obj0, train0 = objective(init, train, acfg.reg)
    degs = np.bincount(train.item, minlength=coo.num_items)
    print(json.dumps({
        "package": args.package, "cut": args.cut, "item_cut": args.item_cut,
        "users": coo.num_users, "items": coo.num_items,
        "train": train.n_ratings, "item_degree_max": int(degs.max()),
        "item_degree_median": float(np.median(degs)),
        "untrained_train_rmse": train0,
        "untrained_test_rmse": objective(init, test, acfg.reg)[1],
        "objective": obj0}), flush=True)
    t0 = time.perf_counter()
    for sweep, model in train_sweeps_als(model, train, acfg,
                                         use_bias=cfg.model.use_bias):
        t = to_numpy(model)
        obj, tr = objective(t, train, acfg.reg)
        line = {"sweep": sweep, "train_rmse": tr,
                "test_rmse": objective(t, test, acfg.reg)[1],
                "objective": obj, "s": round(time.perf_counter() - t0, 1)}
        if ref is None:
            saved.update({f"s{sweep}_{k}": t[k] for k in TABLES})
        else:
            line["max_abs_diff"] = {
                k: float(np.abs(t[k] - ref[f"s{sweep}_{k}"]).max())
                for k in TABLES}
        print(json.dumps(line), flush=True)
    if ref is None and args.tables:
        np.savez(args.tables, **saved)
    return 0


if __name__ == "__main__":
    sys.exit(main())
