"""Serving layer of the port: batched top-K recommendation from trained
models (stock and fused), related items, MMR diversity re-ranking, and
cold-start fold-in of new user histories. ``server.RecServer`` is the
HTTP endpoint around them."""

from mfx_torch.serve.topk import TopKRecommender, similar_items
from mfx_torch.serve.fused import FusedTopKRecommender, similar_items_fused
from mfx_torch.serve.foldin import fold_in, fold_in_batch, recommend_cold
from mfx_torch.serve.rerank import MMRRecommender, rerank_mmr

__all__ = [
    "TopKRecommender",
    "FusedTopKRecommender",
    "MMRRecommender",
    "similar_items",
    "similar_items_fused",
    "rerank_mmr",
    "fold_in",
    "fold_in_batch",
    "recommend_cold",
]
