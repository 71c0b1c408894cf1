"""Public API of the port, the counterpart of ``mfx/api.py``.

>>> import mfx_torch.api as mfx
>>> result = mfx.train(mfx.preset("ml100k_rank16"), device="cuda")
>>> mfx.evaluate(result.model, test_coo)

The names the port has are exported in its own idiom: initializers take
an explicit ``torch.Generator``, and the loaders, trainers and
recommenders a ``device`` (the card unless the caller asks for the CPU).
The reference's names the port lacks stand in :data:`NOT_PORTED` with the
ROADMAP item that ports them; reading one raises ``NotImplementedError``
naming it.
"""

from __future__ import annotations

from mfx_torch.config import (
    TrainConfig, DataConfig, ModelConfig, SGDConfig, SVDPPConfig,
    TimeSVDConfig, TimeSVDPPConfig, ALSConfig, NMFConfig, IALSConfig,
    BPRConfig, ParallelConfig, preset, apply_overrides, PRESETS,
)
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.data.loaders import load_dataset, dataset_names
from mfx_torch.data.split import (
    chronological_split, leave_one_out_split, train_test_split,
    user_chronological_split,
)
from mfx_torch.eval.metrics import rmse, rmse_mae, sampled_auc
from mfx_torch.eval.ranking import (
    full_hr_ndcg_at_k, hr_ndcg_at_k, user_topk_metrics,
)
from mfx_torch.models.mf import MFModel, init_model
from mfx_torch.models.svdpp import SVDppModel, init_svdpp
from mfx_torch.models.timesvd import (TimeSVDModel, fit_time_features,
                                      init_timesvd)
from mfx_torch.serve import (
    FusedTopKRecommender, MMRRecommender, TopKRecommender, fold_in,
    recommend_cold, rerank_mmr, similar_items,
)
from mfx_torch.train.checkpoint import load_checkpoint, save_checkpoint
from mfx_torch.train.driver import TrainResult, train
from mfx_torch.train.online import grow_model, partial_fit
from mfx_torch.version import __version__

# the reference's public names that the port does not have yet, each with
# the ROADMAP item that ports it
NOT_PORTED = {
    "ShardedTopKRecommender": "Queue 1 item 13 (the sharded recommender)",
    "BlendResult": "Queue 1 item 9 (blend)",
    "fit_blend": "Queue 1 item 9 (blend)",
    "blend_as_mf": "Queue 1 item 9 (blend)",
    "CompressResult": "Queue 1 item 9 (compress)",
    "compress_model": "Queue 1 item 9 (compress)",
    "SweepResult": "Queue 1 item 9 (tune)",
    "sweep_sgd": "Queue 1 item 9 (tune)",
}

__all__ = [
    "TrainConfig", "DataConfig", "ModelConfig", "SGDConfig", "SVDPPConfig",
    "TimeSVDConfig", "TimeSVDPPConfig", "ALSConfig", "NMFConfig",
    "IALSConfig", "BPRConfig",
    "ParallelConfig", "preset", "apply_overrides", "PRESETS",
    "RatingsCOO", "load_dataset", "dataset_names", "train_test_split",
    "chronological_split", "user_chronological_split",
    "leave_one_out_split",
    "rmse", "rmse_mae", "sampled_auc", "hr_ndcg_at_k", "full_hr_ndcg_at_k",
    "user_topk_metrics", "evaluate",
    "MFModel", "init_model", "SVDppModel", "init_svdpp",
    "TimeSVDModel", "init_timesvd", "fit_time_features",
    "load_checkpoint", "save_checkpoint",
    "TrainResult", "train", "TopKRecommender",
    "FusedTopKRecommender", "MMRRecommender", "rerank_mmr",
    "similar_items", "fold_in", "recommend_cold",
    "grow_model", "partial_fit",
]


def __getattr__(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"mfx_torch.api.{name} is not ported yet (ROADMAP "
            f"{NOT_PORTED[name]})"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def evaluate(
    model: MFModel,
    coo: RatingsCOO,
    implicit: bool = False,
    clip: tuple[float, float] | None = (0.5, 5.0),
    ranking_k: int | None = None,
    ranking_protocol: str = "sampled",
    train: RatingsCOO | None = None,
) -> dict:
    """Held-out metrics on the model's device: RMSE/MAE (explicit;
    predictions clipped to the rating scale, as the training driver does)
    or sampled AUC (implicit).

    ``ranking_k``: also report ranking metrics at this K, by
    ``ranking_protocol``: 'sampled' (HR/NDCG/MRR against 100 drawn
    candidates a positive), 'full' (HR/NDCG/MRR against the whole
    catalog; ``train``'s interactions are not competitors) or 'user'
    (per-user Recall/Precision/NDCG/MAP and coverage/novelty of the
    served top-K lists)."""
    out = {}
    if implicit:
        out["auc"] = sampled_auc(model, coo)
    else:
        out["rmse"], out["mae"] = rmse_mae(model, coo, clip=clip)
    if ranking_k is not None:
        if ranking_protocol == "full":
            r = full_hr_ndcg_at_k(model, coo, train=train, k=ranking_k)
        elif ranking_protocol == "sampled":
            r = hr_ndcg_at_k(model, coo, k=ranking_k)
        elif ranking_protocol == "user":
            r = user_topk_metrics(model, coo, train=train, k=ranking_k)
        else:
            raise ValueError(
                "ranking_protocol must be 'sampled', 'full', or 'user', "
                f"got {ranking_protocol!r}"
            )
        out.update({f"{name}@{ranking_k}": v for name, v in r.items()})
    return out
