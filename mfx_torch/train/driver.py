"""Training driver, the counterpart of ``mfx/train/driver.py::train`` for
the ported trainers: single-device blocked SGD (``solver='sgd'``,
``parallel.mode='single'``; lane biases with the dense phase at rank 64 or
128, or tile biases / none without it, per tile or with
``sgd.step_user_batch``; ``sgd.dup_trust`` and the ``als`` block, which
only other modes read, are ignored, as the reference's driver ignores
them here) and
the fused BPR ring of one shard
(``solver='bpr'``, ``parallel.mode`` 'sharded' or 'hybrid' with
``model_axis = data_axis = 1``). Load (through the port's own
``mfx_torch.data``), split, initialize, train, evaluate every
``eval_every`` epochs (RMSE/MAE with the reference's clipping, or for BPR
the sampled AUC and, with ``ranking_k``, the sampled HR/NDCG/MRR@K), and
stop early at ``target_rmse``.

Checkpoints are written as the reference writes them: every
``checkpoint_every`` epochs and always at the end, synchronously
(``checkpoint_async`` has no effect). Resume, JSONL logging and profiling
are not ported yet (ROADMAP Queue 1 item 9): a config that asks for
them is refused, and so is a checkpoint directory that already holds a
step unless ``resume=False``.
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
from mfx_torch.models.mf import MFModel, init_model
from mfx_torch.train.checkpoint import latest_step, save_checkpoint

__all__ = ["train", "TrainResult"]


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
        if mode not in ("sharded", "hybrid"):
            raise NotImplementedError(
                f"mfx_torch.train: solver='bpr' parallel={mode!r}; only the "
                "fused BPR ring is ported, the snapshot-minibatch trainers "
                "are ROADMAP Queue 1 item 12"
            )
        if cfg.parallel.model_axis != 1 or cfg.parallel.data_axis != 1:
            raise NotImplementedError(
                f"mfx_torch.train: a BPR ring of model_axis="
                f"{cfg.parallel.model_axis} x data_axis="
                f"{cfg.parallel.data_axis} shards; only a ring of one shard "
                "is ported (ROADMAP Queue 1 item 13); set "
                "parallel.model_axis=1"
            )
        if cfg.ranking_k and cfg.ranking_protocol != "sampled":
            raise NotImplementedError(
                f"mfx_torch.train: ranking_protocol="
                f"{cfg.ranking_protocol!r}; only 'sampled' is ported "
                "(ROADMAP Queue 1 item 11)"
            )
    elif cfg.solver != "sgd" or mode != "single":
        raise NotImplementedError(
            f"mfx_torch.train: solver={cfg.solver!r} parallel={mode!r}; "
            "only single-device SGD (parallel.mode=single) and the BPR ring "
            "of one shard are ported: the SGD ring and data-parallel modes "
            "are ROADMAP Queue 1 item 13 (Q1-13), the other solvers Queue 1 "
            "items 10 and 12; set parallel.mode=single to train SGD on one "
            "device"
        )
    wanted = {
        "log_path": cfg.log_path,
        "profile_dir": cfg.profile_dir,
        "profile_phases": cfg.profile_phases or None,
        "ranking_k": cfg.ranking_k if cfg.solver != "bpr" else None,
    }
    asked = sorted(k for k, v in wanted.items() if v)
    if asked:
        raise NotImplementedError(
            f"mfx_torch.train: {asked} not ported yet (ROADMAP Queue 1 item 9)"
        )
    if cfg.model.bias_init != "zero" or cfg.model.dtype != "float32":
        raise NotImplementedError(
            f"mfx_torch.train: model.bias_init={cfg.model.bias_init!r} "
            f"model.dtype={cfg.model.dtype!r}; only bias_init='zero' and "
            "float32 tables are ported (ROADMAP Queue 1 item 9)"
        )


def _split(cfg: TrainConfig, coo):
    if cfg.data.split == "time":
        return chronological_split(coo, cfg.data.test_frac)
    if cfg.data.split == "user-time":
        return user_chronological_split(coo, cfg.data.test_frac)
    return train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)


def _epochs(cfg: TrainConfig, model, train_coo, seed, dev):
    if cfg.solver == "bpr":
        from mfx_torch.parallel.bpr_sharded import train_epochs_bpr_ring

        return train_epochs_bpr_ring(model, train_coo, cfg.bpr, shards=1,
                                     seed=seed, device=dev)
    from mfx_torch.solvers.blocked import train_epochs_blocked

    return train_epochs_blocked(model, train_coo, cfg.sgd,
                                cfg.model.use_bias, seed=seed, device=dev)


def train(cfg: TrainConfig, device: torch.device | str = "cuda",
          resume: bool = True) -> TrainResult:
    """Train ``cfg`` on ``device``. The dataset is read from
    ``cfg.data.root`` (and cached there) when it is set; otherwise the
    named dataset's seeded synthetic stand-in is generated in memory.
    ``resume=False`` trains from scratch over an existing checkpoint
    directory (its steps are overwritten)."""
    _check_supported(cfg)
    if (resume and cfg.checkpoint_dir
            and latest_step(cfg.checkpoint_dir) is not None):
        raise NotImplementedError(
            f"mfx_torch.train: {cfg.checkpoint_dir} holds a checkpoint and "
            "resume is not ported yet (ROADMAP Queue 1 item 9); pass "
            "--no-resume (resume=False) to train from scratch over it"
        )
    dev = torch.device(device)
    seed = cfg.data.seed
    coo = load_dataset(cfg.data.dataset, root=cfg.data.root,
                       cache=cfg.data.root is not None)
    train_coo, test_coo = _split(cfg, coo)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.model.seed)
    model = init_model(gen, coo.num_users, coo.num_items, cfg.model.rank,
                       global_mean=train_coo.global_mean,
                       init_scale=cfg.model.init_scale)
    clip = (0.5, 5.0) if cfg.clip_predictions else None
    implicit = cfg.solver == "bpr"

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
        return sampled_auc(m, test_coo, seed=seed, pos_keys=_keys())

    def _ranking(m):
        from mfx_torch.eval.ranking import hr_ndcg_at_k

        return hr_ndcg_at_k(m, test_coo, k=cfg.ranking_k, seed=seed,
                            pos_keys=_keys())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history: list[dict] = []
    epochs_run = 0
    last_ups = 0.0
    test_rmse = test_mae = test_auc = test_ranking = None
    sync()
    t_prev = time.perf_counter()
    for epoch, model, train_metric in _epochs(cfg, model, train_coo, seed,
                                              dev):
        sync()
        dt = time.perf_counter() - t_prev
        last_ups = train_coo.n_ratings / max(1e-9, dt)
        rec = {"epoch": epoch, "train_metric": round(float(train_metric), 6),
               "epoch_s": round(dt, 3), "updates_per_sec": round(last_ups, 1)}
        if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
            if implicit:
                test_auc = _auc(model)
                rec["test_auc"] = round(test_auc, 5)
            else:
                test_rmse, test_mae = rmse_mae(model, test_coo, clip=clip)
                rec["test_rmse"] = round(test_rmse, 5)
                rec["test_mae"] = round(test_mae, 5)
            if cfg.ranking_k:
                test_ranking = _ranking(model)
                rec.update({f"test_{n}@{cfg.ranking_k}": round(v, 5)
                            for n, v in test_ranking.items()})
        history.append(rec)
        if cfg.checkpoint_dir and cfg.checkpoint_every and (
            (epoch + 1) % cfg.checkpoint_every == 0
        ):
            save_checkpoint(cfg.checkpoint_dir, epoch, model, seed)
        epochs_run = epoch + 1
        if (cfg.target_rmse is not None and test_rmse is not None
                and test_rmse <= cfg.target_rmse):
            break
        sync()
        t_prev = time.perf_counter()
    if cfg.checkpoint_dir:
        save_checkpoint(cfg.checkpoint_dir, max(0, epochs_run - 1), model,
                        seed)
    # final eval if none happened yet
    if test_rmse is None and not implicit:
        test_rmse, test_mae = rmse_mae(model, test_coo, clip=clip)
    if implicit and test_auc is None:
        test_auc = _auc(model)
    if cfg.ranking_k and test_ranking is None:
        test_ranking = _ranking(model)
    return TrainResult(model=model, history=history, test_rmse=test_rmse,
                       test_mae=test_mae, epochs_run=epochs_run,
                       updates_per_sec=last_ups, test_auc=test_auc,
                       test_ranking=test_ranking)
