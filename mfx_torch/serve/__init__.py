"""Serving layer of the port: batched top-K recommendation from trained
models (stock and fused), related items, and cold-start fold-in of new
user histories. ``server.RecServer`` is the HTTP endpoint around them."""

from mfx_torch.serve.topk import TopKRecommender, similar_items
from mfx_torch.serve.fused import FusedTopKRecommender, similar_items_fused
from mfx_torch.serve.foldin import fold_in, fold_in_batch, recommend_cold

__all__ = [
    "TopKRecommender",
    "FusedTopKRecommender",
    "similar_items",
    "similar_items_fused",
    "fold_in",
    "fold_in_batch",
    "recommend_cold",
]
