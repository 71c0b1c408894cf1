"""Training driver, the counterpart of the single-device blocked-SGD branch
of ``mfx/train/driver.py::train``: load (through the shared ``mfx.data``),
split, initialize, train, evaluate every ``eval_every`` epochs with the
reference's clipping, and stop early at ``target_rmse``.

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

import torch

from mfx.config import TrainConfig
from mfx.data.loaders import load_dataset
from mfx.data.split import (chronological_split, train_test_split,
                            user_chronological_split)
from mfx_torch.eval.metrics import rmse_mae
from mfx_torch.models.mf import MFModel, init_model
from mfx_torch.solvers.blocked import train_epochs_blocked
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


def _check_supported(cfg: TrainConfig) -> None:
    if cfg.solver != "sgd" or cfg.parallel.mode != "single":
        raise NotImplementedError(
            f"mfx_torch.train: solver={cfg.solver!r} parallel="
            f"{cfg.parallel.mode!r}; only single-device SGD is ported "
            "(ROADMAP Queue 1 items 10-13)"
        )
    wanted = {
        "log_path": cfg.log_path,
        "profile_dir": cfg.profile_dir, "ranking_k": cfg.ranking_k,
        "profile_phases": cfg.profile_phases or None,
    }
    asked = sorted(k for k, v in wanted.items() if v)
    if asked:
        raise NotImplementedError(
            f"mfx_torch.train: {asked} not ported yet (ROADMAP Queue 1 item 9)"
        )
    if cfg.model.bias_init != "zero" or cfg.model.dtype != "float32":
        raise NotImplementedError(
            "mfx_torch.train: bias_init='zero' and float32 tables only"
        )


def _split(cfg: TrainConfig, coo):
    if cfg.data.split == "time":
        return chronological_split(coo, cfg.data.test_frac)
    if cfg.data.split == "user-time":
        return user_chronological_split(coo, cfg.data.test_frac)
    return train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)


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
                       init_scale=cfg.model.init_scale, device=dev)
    clip = (0.5, 5.0) if cfg.clip_predictions else None

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history: list[dict] = []
    epochs_run = 0
    last_ups = 0.0
    test_rmse = test_mae = None
    sync()
    t_prev = time.perf_counter()
    for epoch, model, train_rmse in train_epochs_blocked(
        model, train_coo, cfg.sgd, cfg.model.use_bias, seed=seed, device=dev
    ):
        sync()
        dt = time.perf_counter() - t_prev
        last_ups = train_coo.n_ratings / max(1e-9, dt)
        rec = {"epoch": epoch, "train_metric": round(float(train_rmse), 6),
               "epoch_s": round(dt, 3), "updates_per_sec": round(last_ups, 1)}
        if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
            test_rmse, test_mae = rmse_mae(model, test_coo, clip=clip)
            rec["test_rmse"] = round(test_rmse, 5)
            rec["test_mae"] = round(test_mae, 5)
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
    if test_rmse is None:
        test_rmse, test_mae = rmse_mae(model, test_coo, clip=clip)
    return TrainResult(model=model, history=history, test_rmse=test_rmse,
                       test_mae=test_mae, epochs_run=epochs_run,
                       updates_per_sec=last_ups)
