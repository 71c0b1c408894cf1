"""CLI of the port.

    python -m mfx_torch.cli train --preset ml25m_rank64 [--set k=v ...] [--device cuda]
    python -m mfx_torch.cli train --preset netflix100m_rank128_dp \
        --set parallel.mode=single
    python -m mfx_torch.cli train --preset billion_bpr_sharded \
        --set parallel.model_axis=1 [--set data.dataset=...]
    python -m mfx_torch.cli train --preset ml1m_rank32_biased \
        --set model.rank=64 --set solver=timesvd --set timesvd.kernel=pallas \
        --set data.root=DIR
    python -m mfx_torch.cli train --preset netflix100m_rank128_dp \
        --set solver=als --set parallel.mode=single
        (solver=ials or nmf: also --set model.use_bias=false)
    python -m mfx_torch.cli eval --checkpoint ckpt/ --dataset ml-25m \
        [--split loo] [--ranking-k 10 --ranking-protocol full]
    python -m mfx_torch.cli recommend --checkpoint ckpt/ --users 3,17 [--fused]
    python -m mfx_torch.cli similar --checkpoint ckpt/ --items 1,7 [--fused]
    python -m mfx_torch.cli serve --checkpoint ckpt/ --port 8080 [--fused] \
        [--fused-exact --exact-depth 64 --tile 4096] [--mmr 0.7]
    python -m mfx_torch.cli export --checkpoint ckpt/ --out model.npz
    python -m mfx_torch.cli update --checkpoint ckpt/ --delta delta.npz
    python -m mfx_torch.cli datasets
    python -m mfx_torch.cli presets

Configs come from the ``mfx_torch.config`` presets (the reference's) and
``--set`` overrides. Each subcommand takes the reference's flags
(``mfx.cli``) and prints the same JSON, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions). Datasets named with ``--dataset`` are read
from ``--root`` (and cached there) when it is given; otherwise their
seeded synthetic stand-in is generated in memory. timeSVD needs a
dataset with timestamps: a real one's cache under ``data.root``
(``{name}.v{V}.npz``) keeps them; the synthetic stand-ins have none.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_train(args) -> int:
    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset(args.preset), args.overrides)
    result = train(cfg, device=args.device, resume=not args.no_resume)
    out = {
        "preset": cfg.name,
        "epochs_run": result.epochs_run,
        "updates_per_sec": result.updates_per_sec,
    }
    if result.test_rmse is not None:
        out["test_rmse"] = result.test_rmse
        out["test_mae"] = result.test_mae
    if result.test_auc is not None:
        out["test_auc"] = result.test_auc
    if result.test_ranking is not None:
        out.update({
            f"test_{n}@{cfg.ranking_k}": round(v, 5)
            for n, v in result.test_ranking.items()
        })
    print(json.dumps(out, sort_keys=True))
    return 0


def _load_dataset(args):
    from mfx_torch.data.loaders import load_dataset

    return load_dataset(args.dataset, root=args.root,
                        cache=args.root is not None)


def cmd_eval(args) -> int:
    """Held-out metrics of a checkpoint on a split of ``--dataset``: one
    JSON line, the reference's keys (``mfx_torch.api.evaluate``) and
    ``checkpoint_epoch``. The uniform and leave-one-out splits take the
    checkpoint's seed, as the reference's do."""
    from mfx_torch.api import (chronological_split, evaluate,
                               leave_one_out_split, train_test_split,
                               user_chronological_split)
    from mfx_torch.train.checkpoint import load_checkpoint

    model, epoch, seed = load_checkpoint(args.checkpoint, device=args.device)
    coo = _load_dataset(args)
    if args.split == "loo":
        tr, test = leave_one_out_split(coo, seed=seed)
    elif args.split == "loo-time":
        tr, test = leave_one_out_split(coo, by="time")
    elif args.split == "time":
        tr, test = chronological_split(coo, test_frac=args.test_frac)
    elif args.split == "user-time":
        tr, test = user_chronological_split(coo, test_frac=args.test_frac)
    else:
        tr, test = train_test_split(coo, test_frac=args.test_frac, seed=seed)
    print(json.dumps({
        "checkpoint_epoch": epoch,
        **evaluate(model, test, args.implicit, ranking_k=args.ranking_k,
                   ranking_protocol=args.ranking_protocol, train=tr),
    }, sort_keys=True))
    return 0


def _recommender(args, model, exclude):
    from mfx_torch.serve import FusedTopKRecommender, TopKRecommender

    if not args.fused:
        return TopKRecommender(
            model, train=exclude, batch=args.batch,
            table_dtype=args.table_dtype, recall_target=args.recall_target,
            device=args.device,
        )
    if args.recall_target is not None:
        raise SystemExit(
            "--fused has its own selection scheme (drop --recall-target)"
        )
    kw = {}
    if hasattr(args, "fused_exact"):  # serve's exact-mode flags
        kw = dict(exact=args.fused_exact, exact_tiles=args.exact_tiles,
                  exact_depth=args.exact_depth)
    return FusedTopKRecommender(
        model, train=exclude, batch=args.batch, table_dtype=args.table_dtype,
        tile=args.tile, device=args.device, **kw,
    )


def cmd_recommend(args) -> int:
    """Top-K serving from a checkpoint — one JSON line per user: dense
    item ids, scores, and raw dataset ids when the loader relabeled."""
    import numpy as np

    from mfx_torch.train.checkpoint import load_checkpoint

    model, _epoch, _seed = load_checkpoint(args.checkpoint,
                                           device=args.device)
    exclude = raw_ids = raw_uids = None
    if args.dataset is not None:
        coo = _load_dataset(args)
        if not args.no_exclude:
            exclude = coo
        raw_ids = coo.item_raw_ids
        raw_uids = coo.user_raw_ids
    users = np.array([int(u) for u in args.users.split(",")], np.int32)
    rec = _recommender(args, model, exclude)
    items, scores = rec.recommend(users, k=args.k)
    for u, it, sc in zip(users, items, scores):
        out = {
            "user": int(u),
            "items": it.tolist(),
            "scores": [float(s) for s in sc],
        }
        if raw_ids is not None:
            out["raw_items"] = [int(raw_ids[i]) for i in it]
        if raw_uids is not None:
            out["raw_user"] = int(raw_uids[u])
        print(json.dumps(out))
    return 0


def cmd_similar(args) -> int:
    """Related items from a checkpoint: top-K nearest items by factor
    cosine — one JSON line per query item."""
    import numpy as np

    from mfx_torch.serve import similar_items, similar_items_fused
    from mfx_torch.train.checkpoint import load_checkpoint

    model, _epoch, _seed = load_checkpoint(args.checkpoint,
                                           device=args.device)
    raw_ids = None
    if args.dataset is not None:
        raw_ids = _load_dataset(args).item_raw_ids
    items = np.array([int(i) for i in args.items.split(",")], np.int32)
    sim = similar_items_fused if args.fused else similar_items
    nbrs, cos = sim(model, items, k=args.k, batch=args.batch,
                    device=args.device)
    for q, it, sc in zip(items, nbrs, cos):
        out = {
            "item": int(q),
            "similar": it.tolist(),
            "cosine": [float(s) for s in sc],
        }
        if raw_ids is not None:
            out["raw_item"] = int(raw_ids[q])
            out["raw_similar"] = [int(raw_ids[i]) for i in it]
        print(json.dumps(out))
    return 0


def cmd_serve(args) -> int:
    """Run the HTTP endpoint (``mfx_torch/serve/server.py``) over a
    checkpoint: POST /recommend, /similar, /recommend_cold, /reload,
    GET /healthz, /metrics. POST /reload re-reads the NEWEST checkpoint
    step and swaps it in without a restart."""
    import dataclasses
    import functools

    import numpy as np

    from mfx_torch.serve import (recommend_cold, similar_items,
                                 similar_items_fused)
    from mfx_torch.serve.server import RecServer
    from mfx_torch.train.checkpoint import load_checkpoint

    exclude = raw_ids = None
    if args.dataset is not None:
        coo = _load_dataset(args)
        if not args.no_exclude:
            exclude = coo
        raw_ids = coo.item_raw_ids

    def build() -> dict:
        model, epoch, _seed = load_checkpoint(args.checkpoint,
                                              device=args.device)
        # a model grown past the dataset's id space (the reference's
        # 'update'): widen the exclusion COO's declared shape and extend
        # the raw-id map with identity for the new dense ids
        exclude_b, raw_b = exclude, raw_ids
        if exclude is not None and (
            model.num_users > exclude.num_users
            or model.num_items > exclude.num_items
        ):
            exclude_b = dataclasses.replace(
                exclude,
                num_users=max(model.num_users, exclude.num_users),
                num_items=max(model.num_items, exclude.num_items),
            )
        if raw_b is not None and model.num_items > len(raw_b):
            raw_b = np.concatenate([
                raw_b,
                np.arange(len(raw_b), model.num_items, dtype=raw_b.dtype),
            ])
        rec = _recommender(args, model, exclude_b)
        if args.mmr is not None:
            from mfx_torch.serve import MMRRecommender

            rec = MMRRecommender(rec, model=model, lam=args.mmr,
                                 pool=args.mmr_pool)
        if args.fused:
            sim = functools.partial(
                similar_items_fused, model, tile=args.tile,
                exact=args.fused_exact, exact_tiles=args.exact_tiles,
                exact_depth=args.exact_depth, device=args.device,
            )
        else:
            sim = functools.partial(similar_items, model, device=args.device)
        cold = functools.partial(recommend_cold, model, reg=args.foldin_reg)
        return {
            "recommender": rec,
            "similar": lambda q, k: sim(q, k=k),
            "cold": lambda hs, k: cold(hs, k=k),
            "raw_item_ids": raw_b,
            "info": {"checkpoint_epoch": epoch},
        }

    first = build()
    srv = RecServer(
        first["recommender"], similar=first["similar"],
        cold=first["cold"], raw_item_ids=first["raw_item_ids"],
        reload=build, host=args.host, port=args.port,
    )
    model = first["recommender"].model
    print(json.dumps({
        "serving": f"http://{args.host}:{srv.port}",
        "recommender": type(first["recommender"]).__name__,
        "num_users": model.num_users, "num_items": model.num_items,
    }), flush=True)
    srv.serve_forever()
    return 0


def cmd_export(args) -> int:
    """Checkpoint -> portable .npz model file (the reference's format)."""
    from mfx_torch.train.checkpoint import load_checkpoint

    model, epoch, _seed = load_checkpoint(args.checkpoint, device="cpu")
    model.save_npz(args.out)
    print(json.dumps({
        "out": args.out, "checkpoint_epoch": epoch,
        "num_users": model.num_users, "num_items": model.num_items,
        "rank": model.rank,
    }, sort_keys=True))
    return 0


def cmd_update(args) -> int:
    """Online update: checkpoint + delta-ratings .npz -> new checkpoint
    step (grow the tables for new ids, fold-in init, a few SGD epochs over
    the delta through ``mfx_torch.train.online.partial_fit``; no full
    retrain)."""
    from mfx_torch.config import SGDConfig
    from mfx_torch.data.coo import RatingsCOO
    from mfx_torch.train.checkpoint import (latest_step, load_checkpoint,
                                            save_checkpoint)
    from mfx_torch.train.online import partial_fit

    model, epoch, seed = load_checkpoint(args.checkpoint, device=args.device)
    delta = RatingsCOO.load_npz(args.delta)
    replay = (RatingsCOO.load_npz(args.replay)
              if args.replay is not None else None)
    old_shape = (model.num_users, model.num_items)
    cfg = SGDConfig(
        lr=args.lr, reg=args.reg, epochs=args.epochs,
        batch_size=args.batch_size, partitioner="fixed",
        dup_trust=args.dup_trust,
    )
    model, tr = partial_fit(
        model, delta, cfg, seed=seed,
        foldin_new=not args.no_foldin, foldin_reg=args.foldin_reg,
        replay=replay,
    )
    out_dir = args.out if args.out is not None else args.checkpoint
    step = (latest_step(out_dir) or epoch) + 1
    save_checkpoint(out_dir, step, model, seed=seed)
    print(json.dumps({
        "checkpoint": str(out_dir), "step": step,
        "delta_ratings": delta.n_ratings,
        "grew_users": model.num_users - old_shape[0],
        "grew_items": model.num_items - old_shape[1],
        "train_rmse": None if tr != tr else round(tr, 6),
    }, sort_keys=True))
    return 0


def cmd_datasets(args) -> int:
    from mfx_torch.data.loaders import dataset_names

    print("\n".join(dataset_names()))
    return 0


def cmd_presets(args) -> int:
    from mfx_torch.config import PRESETS

    for name, cfg in sorted(PRESETS.items()):
        print(f"{name}: solver={cfg.solver} dataset={cfg.data.dataset} "
              f"rank={cfg.model.rank} parallel={cfg.parallel.mode}")
    return 0


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")


def _add_checkpoint_source(p) -> None:
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--dataset", default=None,
                   help="dataset whose raw id maps are reported (and, for "
                        "recommend and serve, whose interactions are "
                        "excluded from results)")
    p.add_argument("--root", default=None, help="dataset root directory")
    p.add_argument("--batch", type=int, default=256)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="mfx_torch", description="matrix factorization on PyTorch/CUDA"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("train", help="train a preset config")
    p.add_argument("--preset", default="ml25m_rank64",
                   help="named config from mfx_torch.config.PRESETS")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dot-path config override")
    p.add_argument("--no-resume", action="store_true",
                   help="train from scratch over an existing checkpoint "
                        "directory")
    _add_device(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--root", default=None, help="dataset root directory")
    p.add_argument("--test-frac", type=float, default=0.1)
    p.add_argument("--implicit", action="store_true")
    p.add_argument("--split",
                   choices=("uniform", "loo", "time", "user-time",
                            "loo-time"),
                   default="uniform",
                   help="held-out protocol: uniform fraction, "
                        "leave-one-out, global chronological cut, "
                        "per-user timeline cut, or per-user latest-item "
                        "leave-one-out (the time protocols need a dataset "
                        "with timestamps)")
    p.add_argument("--ranking-k", type=int, default=None,
                   help="also report HR/NDCG/MRR at this K")
    p.add_argument("--ranking-protocol",
                   choices=("sampled", "full", "user"),
                   default="sampled",
                   help="rank against 100 sampled candidates, the full "
                        "catalog, or per-user Recall/Precision/NDCG/MAP "
                        "and coverage/novelty of the served top-K lists")
    _add_device(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("recommend", help="top-K items from a checkpoint")
    _add_checkpoint_source(p)
    p.add_argument("--users", required=True,
                   help="comma-separated dense user ids")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--no-exclude", action="store_true",
                   help="keep already-seen items in the results")
    p.add_argument("--table-dtype", choices=("f32", "bf16", "int8"),
                   default="f32",
                   help="serving-table precision: bf16 halves / int8 "
                        "quarters the tables' memory")
    p.add_argument("--recall-target", type=float, default=None,
                   help="accepted for the reference's interface; served "
                        "exactly")
    p.add_argument("--fused", action="store_true",
                   help="score-block-free serving through the tile_topk "
                        "kernel")
    p.add_argument("--tile", type=int, default=1024,
                   help="fused path: catalog items per kernel tile")
    _add_device(p)
    p.set_defaults(fn=cmd_recommend)

    p = sub.add_parser("similar", help="related items from a checkpoint")
    _add_checkpoint_source(p)
    p.add_argument("--items", required=True,
                   help="comma-separated dense item ids")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--fused", action="store_true",
                   help="score-block-free related-items path")
    _add_device(p)
    p.set_defaults(fn=cmd_similar)

    p = sub.add_parser("serve", help="HTTP serving endpoint over a checkpoint")
    _add_checkpoint_source(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--no-exclude", action="store_true")
    p.add_argument("--table-dtype", choices=("f32", "bf16", "int8"),
                   default="f32")
    p.add_argument("--recall-target", type=float, default=None)
    p.add_argument("--fused", action="store_true",
                   help="score-block-free serving through the tile_topk "
                        "kernel")
    p.add_argument("--fused-exact", action="store_true",
                   help="certified-exact fused serving (suspect-tile "
                        "rescore; falls back to the stock scorer when "
                        "the union overflows --exact-tiles)")
    p.add_argument("--exact-tiles", type=int, default=64)
    p.add_argument("--exact-depth", type=int, default=8,
                   help="per-tile selection depth in exact mode")
    p.add_argument("--tile", type=int, default=1024)
    p.add_argument("--foldin-reg", type=float, default=0.05,
                   help="L2 of the cold-start fold-in solve "
                        "(/recommend_cold)")
    p.add_argument("--mmr", type=float, default=None,
                   help="diversify /recommend lists by greedy MMR with "
                        "this relevance weight in [0,1] (1 = pure "
                        "relevance); over-fetches --mmr-pool x k")
    p.add_argument("--mmr-pool", type=int, default=4)
    _add_device(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export", help="checkpoint -> portable .npz model")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True, help="output .npz path")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "update",
        help="online update: absorb a delta-ratings .npz into a "
             "checkpoint (grow + fold-in + a few SGD epochs)",
    )
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--delta", required=True,
                   help="RatingsCOO .npz of the new ratings "
                        "(ids may exceed the model's tables)")
    p.add_argument("--replay", default=None,
                   help="optional RatingsCOO .npz of old ratings to "
                        "train alongside the delta (rehearsal)")
    p.add_argument("--out", default=None,
                   help="checkpoint dir for the updated step "
                        "(default: append to --checkpoint)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--reg", type=float, default=0.02)
    p.add_argument("--batch-size", type=int, default=8192)
    p.add_argument("--dup-trust", type=float, default=16.0)
    p.add_argument("--foldin-reg", type=float, default=0.05)
    p.add_argument("--no-foldin", action="store_true",
                   help="skip least-squares init of new rows")
    _add_device(p)
    p.set_defaults(fn=cmd_update)

    p = sub.add_parser("datasets", help="list known datasets")
    p.set_defaults(fn=cmd_datasets)

    p = sub.add_parser("presets", help="list named configs")
    p.set_defaults(fn=cmd_presets)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
