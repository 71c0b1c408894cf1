"""Training driver, the counterpart of ``mfx/train/driver.py::train`` for
the ported trainers: single-device SGD (``solver='sgd'``,
``parallel.mode='single'``): minibatch SGD with the ``fixed`` or
``conflict_free`` partitioner (``solvers/sgd.py``), and blocked SGD
(``solvers/blocked.py``; lane biases with the dense phase at rank 64 or
128, or tile biases / none without it, per tile or with
``sgd.step_user_batch``; the ``als`` block, which only other modes read,
is ignored, as the reference's driver ignores it here); and the fused
BPR trainers (``solver='bpr'``): the snapshot-minibatch trainer
(``parallel.mode='single'``, ``solvers/bpr.py``), the data-parallel one on
one data shard (``'dp'``, ``parallel/data_parallel.py``: the single
trainer with host sampling), and the ring of one shard (``'sharded'`` or
``'hybrid'`` with ``model_axis = data_axis = 1``, ``parallel/bpr_sharded.py``)
by ``bpr.kernel``: the fused kernel (``'pallas'``) or the
snapshot-minibatch ring (``'jnp'``); and timeSVD
(``solver='timesvd'``, single device), by ``timesvd.kernel``: 'jnp', the
snapshot-minibatch trainer (``solvers/timesvd.py``), or 'pallas', the
blocked trainer through the time form of the lane sweep
(``solvers/timesvd_blocked.py``). Its time features are fitted once from
the train split; held-out ratings are evaluated at their own timestamps
(``rmse_mae_time``), and checkpoints, ranking, the AUC and the result get
the model's biased-MF view at the end of the train window (``as_mf``).
SVD++ (``solver='svdpp'``, ``solvers/svdpp.py``) trains the minibatch
epoch over ``X = P + S`` and a full-batch step on its implicit factors Y,
and yields the MF view; timeSVD++ (``solver='timesvdpp'``,
``solvers/timesvdpp.py``) adds that step to timeSVD's epoch, by
``timesvdpp.kernel`` 'jnp' or 'pallas' as timeSVD's, and is evaluated as
timeSVD is. Both run on one device (SVD++'s data-parallel trainer is
Q1-13) and cannot resume from the MF-view checkpoint, as the reference's.
The Gram-engine solvers (``solver`` 'als', 'ials' or 'nmf', single
device; ``solvers/als.py``, ``ials.py``, ``nmf.py``) train one sweep an
epoch entry, the train loss NaN, as the reference's driver reports them;
iALS is evaluated as implicit feedback (the sampled AUC). A run of theirs
resumed from a checkpoint goes on at the next sweep, bit for bit the
unbroken run (the reference's driver runs all its sweeps again from the
checkpoint's tables).
Load (through the port's
own ``mfx_torch.data``), split, initialize (``model.bias_init='baseline'``
starts a fresh run from the baseline predictor's biases), train, evaluate
every ``eval_every`` epochs (RMSE/MAE with the reference's clipping, or
for BPR the sampled AUC; with ``ranking_k`` the sampled HR/NDCG/MRR@K),
and stop early at ``target_rmse``.

Each epoch's record goes through ``MetricsLogger`` (JSONL at ``log_path``
when set, echoed to stderr), with the reference's fields; ``profile_dir``
wraps the loop in a ``torch.profiler`` trace. Checkpoints are written as
the reference writes them: every ``checkpoint_every`` epochs and always
at the end, synchronously (``checkpoint_async`` has no effect). A
checkpoint directory that already holds a step is resumed from its
latest step (the run goes on at the next epoch, bit for bit the unbroken
run) unless ``resume=False``.

``ranking_protocol`` takes the reference's three protocols ('sampled',
'full' against the whole catalog minus the train items, 'user' over the
served top-K lists), with its record keys. ``model.dtype='bfloat16'``
trains bf16 tables where the reference does, on the minibatch path
(``sgd.kernel='jnp'``) and the snapshot-minibatch BPR trainers (single,
data-parallel and the ``'jnp'`` ring); the fused blocked kernel
(``sgd.kernel='pallas'``) is refused with the reference's own error, and
the fused BPR ring, timeSVD, SVD++ and timeSVD++ keep float32 tables
here. ``profile_phases`` (``solver='sgd'``,
``parallel.mode='single'``) adds the reference's per-epoch fields:
``plan_ms``, the epoch's planning time; for the blocked trainer
``dense_ms`` and ``sparse_ms``, its dense groups' and sparse sweeps'
device time in the epoch (CUDA events on the card; the reference times
them once, standalone, and leaves them out in ``bias_mode='epoch'``, as
the port does); and ``eval_ms`` on the epochs that evaluate.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mfx_torch.config import TrainConfig
from mfx_torch.data.loaders import load_dataset
from mfx_torch.data.split import (chronological_split, train_test_split,
                                  user_chronological_split)
from mfx_torch.eval.metrics import rmse_mae, sampled_auc
from mfx_torch.models.mf import (TABLE_DTYPES, MFModel, baseline_biases,
                                 init_model)
from mfx_torch.models.timesvd import fit_time_features
from mfx_torch.solvers.timesvd import rmse_mae_time
from mfx_torch.train.checkpoint import (latest_step, load_checkpoint,
                                        save_checkpoint)
from mfx_torch.train.logging import MetricsLogger
from mfx_torch.train.profile import maybe_trace

__all__ = ["train", "TrainResult"]

# the solvers of the Gram engine (solvers/als.py): one entry a sweep
GRAM_SOLVERS = ("als", "ials", "nmf")


@dataclasses.dataclass
class TrainResult:
    model: MFModel
    history: list[dict]
    test_rmse: float | None
    test_mae: float | None
    epochs_run: int
    updates_per_sec: float
    test_auc: float | None = None
    # ranking_k metrics from the last eval ('hr', 'ndcg', 'mrr'); None
    # when ranking eval is disabled
    test_ranking: dict | None = None


def _check_supported(cfg: TrainConfig) -> None:
    mode = cfg.parallel.mode
    if cfg.solver == "bpr":
        if mode == "dp" and cfg.parallel.data_axis != 1:
            raise NotImplementedError(
                f"mfx_torch.train: solver='bpr' parallel.mode='dp' over "
                f"data_axis={cfg.parallel.data_axis} shards; only one data "
                "shard is ported (ROADMAP Queue 1 item 13); set "
                "parallel.data_axis=1"
            )
        if mode in ("sharded", "hybrid") and (
                cfg.parallel.model_axis != 1 or cfg.parallel.data_axis != 1):
            raise NotImplementedError(
                f"mfx_torch.train: a BPR ring of model_axis="
                f"{cfg.parallel.model_axis} x data_axis="
                f"{cfg.parallel.data_axis} shards; only a ring of one shard "
                "is ported (ROADMAP Queue 1 item 13); set "
                "parallel.model_axis=1"
            )
    elif cfg.solver in ("timesvd", "timesvdpp"):
        if mode != "single":
            raise ValueError(
                f"solver={cfg.solver!r} runs single-device; use "
                "solver='sgd' for the data-parallel / row-sharded paths"
            )
    elif cfg.solver == "svdpp":
        if mode in ("dp", "hybrid"):
            raise NotImplementedError(
                f"mfx_torch.train: solver='svdpp' parallel={mode!r}; the "
                "data-parallel SVD++ trainer (svdpp_dp) is ROADMAP Queue 1 "
                "item 13 (Q1-13); set parallel.mode=single to train on one "
                "device"
            )
        if mode != "single":
            # the reference's own refusal (mfx/train/driver.py)
            raise ValueError(
                "solver='svdpp' runs single-device or data-parallel "
                "(parallel.mode in ('single', 'dp', 'hybrid')); use "
                "solver='sgd' for the row-sharded ring paths"
            )
    elif cfg.solver in GRAM_SOLVERS:
        if mode != "single":
            raise NotImplementedError(
                f"mfx_torch.train: solver={cfg.solver!r} parallel={mode!r}; "
                "the Gram-engine solvers (als, ials, nmf) are ported on one "
                "device only: their data-parallel and ring modes are ROADMAP "
                "Queue 1 item 13 (Q1-13); set parallel.mode=single to train "
                "on one device"
            )
    elif cfg.solver != "sgd" or mode != "single":
        raise NotImplementedError(
            f"mfx_torch.train: solver={cfg.solver!r} parallel={mode!r}; "
            "only single-device SGD, ALS, iALS, NMF, SVD++, timeSVD and "
            "timeSVD++ (parallel.mode=single) and the BPR trainers (single, "
            "dp of one data shard, the ring of one shard) are ported: the "
            "SGD ring and data-parallel modes are ROADMAP "
            "Queue 1 item 13 (Q1-13); set parallel.mode=single to train SGD "
            "on one device"
        )
    if cfg.model.dtype != "float32":
        if cfg.model.dtype not in TABLE_DTYPES:
            raise NotImplementedError(
                f"mfx_torch.train: model.dtype={cfg.model.dtype!r}; the "
                f"port's tables are {sorted(TABLE_DTYPES)}"
            )
        if cfg.sgd.kernel == "pallas":
            # the reference's own refusal (mfx/train/driver.py)
            raise ValueError(
                "the fused Pallas kernel keeps factor tables in float32 "
                "(bf16 accumulation loses SGD deltas); use kernel='jnp' or "
                "'blocked_jnp' for low-precision tables"
            )
        fused_ring = cfg.solver == "bpr" and cfg.bpr.kernel == "pallas" and (
            mode in ("sharded", "hybrid"))
        if fused_ring or cfg.solver not in ("sgd", "bpr") or (
                cfg.solver == "sgd" and cfg.sgd.partitioner == "blocked"):
            raise NotImplementedError(
                f"mfx_torch.train: model.dtype={cfg.model.dtype!r} with "
                f"solver={cfg.solver!r}, parallel.mode={mode!r}, "
                f"bpr.kernel={cfg.bpr.kernel!r}, sgd.partitioner="
                f"{cfg.sgd.partitioner!r}; bf16 tables train on the "
                "minibatch path only: minibatch SGD (partitioner 'fixed' or "
                "'conflict_free') and the snapshot-minibatch BPR trainers "
                "(parallel.mode 'single' or 'dp', or the ring with "
                "bpr.kernel='jnp'); the fused BPR ring, timeSVD, SVD++, "
                "timeSVD++ and the Gram-engine solvers keep float32 tables "
                "(ROADMAP Queue 1 item 12)"
            )


def _split(cfg: TrainConfig, coo):
    if cfg.data.split == "time":
        return chronological_split(coo, cfg.data.test_frac)
    if cfg.data.split == "user-time":
        return user_chronological_split(coo, cfg.data.test_frac)
    return train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)


def _sweeps(cfg: TrainConfig, model, train_coo, start_epoch):
    """The Gram-engine solvers' sweeps as the driver's ``(epoch, model,
    train_metric)``: one entry a sweep, the train loss NaN (as the
    reference's driver reports them)."""
    use_bias = cfg.model.use_bias
    if cfg.solver == "als":
        from mfx_torch.solvers.als import train_sweeps_als

        it = train_sweeps_als(model, train_coo, cfg.als, use_bias=use_bias,
                              start_sweep=start_epoch)
    elif cfg.solver == "nmf":
        from mfx_torch.solvers.nmf import train_sweeps_nmf

        it = train_sweeps_nmf(model, train_coo, cfg.nmf, use_bias=use_bias,
                              start_sweep=start_epoch)
    else:
        from mfx_torch.solvers.ials import train_sweeps_ials

        it = train_sweeps_ials(model, train_coo, cfg.ials, use_bias=use_bias,
                               start_sweep=start_epoch)
    for sweep, m in it:
        yield sweep, m, float("nan")


def _epochs(cfg: TrainConfig, model, train_coo, seed, dev, start_epoch,
            feats, timings):
    if cfg.solver in GRAM_SOLVERS:
        return _sweeps(cfg, model, train_coo, start_epoch)
    if cfg.solver == "svdpp":
        from mfx_torch.solvers.svdpp import train_epochs_svdpp

        # start_epoch > 0 raises there: the MF-view checkpoint cannot
        # carry the implicit Y table
        return train_epochs_svdpp(model, train_coo, cfg.svdpp,
                                  cfg.model.use_bias, seed=seed,
                                  start_epoch=start_epoch, device=dev)
    if cfg.solver == "timesvdpp":
        from mfx_torch.solvers.timesvdpp import train_epochs_timesvdpp

        return train_epochs_timesvdpp(model, train_coo, cfg.timesvdpp,
                                      cfg.model.use_bias, seed=seed,
                                      start_epoch=start_epoch, feats=feats,
                                      device=dev)
    if cfg.solver == "timesvd":
        if cfg.timesvd.kernel == "pallas":
            from mfx_torch.solvers.timesvd_blocked import (
                train_epochs_timesvd_blocked)

            trainer = train_epochs_timesvd_blocked
        else:
            from mfx_torch.solvers.timesvd import train_epochs_timesvd

            trainer = train_epochs_timesvd
        return trainer(model, train_coo, cfg.timesvd, cfg.model.use_bias,
                       seed=seed, start_epoch=start_epoch, feats=feats,
                       device=dev)
    if cfg.solver == "bpr":
        mode = cfg.parallel.mode
        if mode == "dp":
            from mfx_torch.parallel.data_parallel import train_epochs_bpr_dp

            return train_epochs_bpr_dp(model, train_coo, cfg.bpr,
                                       data_axis=cfg.parallel.data_axis,
                                       seed=seed, start_epoch=start_epoch,
                                       device=dev)
        if mode in ("sharded", "hybrid"):
            from mfx_torch.parallel.bpr_sharded import train_epochs_bpr_ring

            return train_epochs_bpr_ring(model, train_coo, cfg.bpr, shards=1,
                                         seed=seed, device=dev,
                                         start_epoch=start_epoch)
        from mfx_torch.solvers.bpr import train_epochs_bpr

        return train_epochs_bpr(model, train_coo, cfg.bpr, seed=seed,
                                start_epoch=start_epoch, device=dev)
    from mfx_torch.solvers.sgd import train_epochs

    return train_epochs(model, train_coo, cfg.sgd, cfg.model.use_bias,
                        seed=seed, start_epoch=start_epoch, device=dev,
                        timings=timings)


def train(cfg: TrainConfig, device: torch.device | str = "cuda",
          resume: bool = True) -> TrainResult:
    """Train ``cfg`` on ``device``. The dataset is read from
    ``cfg.data.root`` (and cached there) when it is set; otherwise the
    named dataset's seeded synthetic stand-in is generated in memory.
    With ``resume`` a checkpoint directory that holds a step is resumed
    from its latest one; ``resume=False`` trains from scratch over it
    (its steps are overwritten)."""
    _check_supported(cfg)
    dev = torch.device(device)
    seed = cfg.data.seed
    coo = load_dataset(cfg.data.dataset, root=cfg.data.root,
                       cache=cfg.data.root is not None)
    train_coo, test_coo = _split(cfg, coo)
    start_epoch = 0
    model = None
    if (resume and cfg.checkpoint_dir
            and latest_step(cfg.checkpoint_dir) is not None):
        model, ckpt_epoch, _ = load_checkpoint(cfg.checkpoint_dir,
                                               device=dev)
        start_epoch = ckpt_epoch + 1
        # a model grown past the dataset (the CLI's 'update') trains on
        # the dataset's rows, as the reference slices it back
        U, I = coo.num_users, coo.num_items
        if model.num_users > U or model.num_items > I:
            model = MFModel(model.P[:U], model.Q[:I], model.bu[:U],
                            model.bi[:I], model.mu)
    if model is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.model.seed)
        model = init_model(gen, coo.num_users, coo.num_items,
                           cfg.model.rank, global_mean=train_coo.global_mean,
                           init_scale=cfg.model.init_scale,
                           dtype=cfg.model.dtype)
        if cfg.model.bias_init == "baseline" and cfg.model.use_bias:
            # fresh runs only (a resumed checkpoint carries trained
            # biases): start from the damped-mean baseline predictor
            bu0, bi0 = baseline_biases(train_coo,
                                       damping=cfg.model.bias_damping,
                                       device=dev)
            model = MFModel(model.P, model.Q, bu0.to(model.dtype),
                            bi0.to(model.dtype), model.mu)
    log = MetricsLogger(cfg.log_path)
    clip = (0.5, 5.0) if cfg.clip_predictions else None
    implicit = cfg.solver in ("bpr", "ials")
    feats = None
    if cfg.solver in ("timesvd", "timesvdpp"):
        # the time featurizer, shared by the trainer and the time-aware
        # eval (deterministic from the train split: refitted, not saved)
        tc = cfg.timesvd if cfg.solver == "timesvd" else cfg.timesvdpp
        feats = fit_time_features(train_coo, n_bins=tc.n_bins, beta=tc.beta)

    def _mf(m):
        # a temporal model folds its time terms in at the end of the train
        # window for the MF-only consumers (AUC, ranking, checkpoints, the
        # result)
        return m.as_mf(feats) if hasattr(m, "as_mf") else m

    def _rmse_eval(m):
        if hasattr(m, "predict_t") and test_coo.timestamp is not None:
            return rmse_mae_time(m, feats, test_coo, clip=clip)
        return rmse_mae(_mf(m), test_coo, clip=clip)

    # sampled negatives (AUC and the sampled ranking protocol) reject
    # against all observed positives, train and held-out; built once
    keys = None

    def _keys():
        nonlocal keys
        if keys is None:
            from mfx_torch.data.bpr import build_positive_index

            keys = np.concatenate([build_positive_index(train_coo),
                                   build_positive_index(test_coo)])
            keys.sort()
        return keys

    def _auc(m):
        return sampled_auc(_mf(m), test_coo, seed=seed, pos_keys=_keys())

    def _ranking(m):
        from mfx_torch.eval.ranking import (full_hr_ndcg_at_k, hr_ndcg_at_k,
                                            user_topk_metrics)

        m = _mf(m)
        k = cfg.ranking_k
        if cfg.ranking_protocol == "sampled":
            return hr_ndcg_at_k(m, test_coo, k=k, seed=seed,
                                pos_keys=_keys())
        if cfg.ranking_protocol == "full":
            return full_hr_ndcg_at_k(m, test_coo, train=train_coo, k=k)
        if cfg.ranking_protocol == "user":
            return user_topk_metrics(m, test_coo, train=train_coo, k=k)
        raise ValueError(
            "ranking_protocol must be 'sampled', 'full', or 'user', got "
            f"{cfg.ranking_protocol!r}"
        )

    # profile_phases: the trainer fills plan_s (and, blocked, dense_s /
    # sparse_s) cumulatively; each record gets this epoch's share
    timings = {"plan_s": 0.0} if (cfg.profile_phases and cfg.solver == "sgd"
                                  and cfg.parallel.mode == "single") else None
    seen = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    epochs_run = 0
    last_ups = 0.0
    test_rmse = test_mae = test_auc = test_ranking = None
    sync()
    t_prev = time.perf_counter()
    with maybe_trace(cfg.profile_dir):
        for epoch, model, train_metric in _epochs(cfg, model, train_coo,
                                                  seed, dev, start_epoch,
                                                  feats, timings):
            sync()
            dt = time.perf_counter() - t_prev
            last_ups = train_coo.n_ratings / max(1e-9, dt)
            rec = {"epoch": epoch,
                   "train_metric": round(float(train_metric), 6),
                   "epoch_s": round(dt, 3),
                   "updates_per_sec": round(last_ups, 1),
                   "updates_per_sec_per_chip": round(last_ups, 1)}
            if timings is not None:
                parts = ["plan"]
                if "dense_s" in timings and cfg.sgd.bias_mode != "epoch":
                    parts += ["dense", "sparse"]
                for part in parts:
                    total = timings[f"{part}_s"]
                    rec[f"{part}_ms"] = round(
                        (total - seen.get(part, 0.0)) * 1e3, 2)
                    seen[part] = total
            t_eval = time.perf_counter()
            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                if implicit:
                    test_auc = _auc(model)
                    rec["test_auc"] = round(test_auc, 5)
                else:
                    test_rmse, test_mae = _rmse_eval(model)
                    rec["test_rmse"] = round(test_rmse, 5)
                    rec["test_mae"] = round(test_mae, 5)
                if cfg.ranking_k:
                    test_ranking = _ranking(model)
                    rec.update({f"test_{n}@{cfg.ranking_k}": round(v, 5)
                                for n, v in test_ranking.items()})
                if timings is not None:
                    rec["eval_ms"] = round(
                        (time.perf_counter() - t_eval) * 1e3, 2)
            log.log(**rec)
            if cfg.checkpoint_dir and cfg.checkpoint_every and (
                (epoch + 1) % cfg.checkpoint_every == 0
            ):
                save_checkpoint(cfg.checkpoint_dir, epoch, _mf(model), seed)
            epochs_run = epoch + 1
            if (cfg.target_rmse is not None and test_rmse is not None
                    and test_rmse <= cfg.target_rmse):
                log.log(event="target_rmse_reached", epoch=epoch,
                        test_rmse=round(test_rmse, 5))
                break
            sync()
            t_prev = time.perf_counter()
    if cfg.checkpoint_dir:
        save_checkpoint(cfg.checkpoint_dir, max(0, epochs_run - 1),
                        _mf(model), seed)
    # final eval if none happened yet
    if test_rmse is None and not implicit:
        test_rmse, test_mae = _rmse_eval(model)
    if implicit and test_auc is None:
        test_auc = _auc(model)
    if cfg.ranking_k and test_ranking is None:
        test_ranking = _ranking(model)
    log.close()
    # the result carries the MF view (the full temporal state is the
    # trainers' TimeSVDModel, TimeSVDModel.save_npz)
    return TrainResult(model=_mf(model), history=log.records,
                       test_rmse=test_rmse,
                       test_mae=test_mae, epochs_run=epochs_run,
                       updates_per_sec=last_ups, test_auc=test_auc,
                       test_ranking=test_ranking)
