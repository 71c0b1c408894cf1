"""Top-K ranking metrics, the counterpart of ``mfx/eval/ranking.py``, in
its three protocols:

- sampled (:func:`hr_ndcg_at_k`): each held-out positive is ranked
  against ``n_neg`` negatives drawn uniformly from the catalog and
  rejection-filtered against the user's observed positives (``pos_keys``:
  train and test). The negatives are the reference's host draws
  (``mfx_torch.data.bpr.sample_negatives``, one seeded stream per
  column), so both packages rank the same candidates;
- full (:func:`full_hr_ndcg_at_k`): each positive against the whole
  catalog minus the user's train items, one (chunk, catalog) f32 score
  block a chunk (TF32 off), capped near 1 GB;
- user (:func:`user_topk_metrics`): the lists the stock recommender
  (:class:`mfx_torch.serve.TopKRecommender`) serves, scored per user.

A positive's rank is 1 + the number of competitors scoring strictly
higher, with half credit for exact ties. Scores are computed on the
model's device; the sums are taken in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from mfx_torch.data.bpr import build_positive_index, sample_negatives
from mfx_torch.data.coo import SeenCSR

__all__ = ["hr_ndcg_at_k", "full_hr_ndcg_at_k", "user_topk_metrics"]



def hr_ndcg_at_k(model, test, k: int = 10, n_neg: int = 100, seed: int = 0,
                 chunk: int = 1 << 16,
                 pos_keys: np.ndarray | None = None) -> dict:
    """{'hr': HR@K, 'ndcg': NDCG@K, 'mrr': MRR@K} of ``model`` on a
    held-out split. A positive's rank is 1 + the number of its negatives
    scoring strictly higher, with half credit for exact ties; the item
    biases count (the user's are constant within a list)."""
    n = test.n_ratings
    if n == 0:
        return {"hr": 0.0, "ndcg": 0.0, "mrr": 0.0}
    if pos_keys is None:
        pos_keys = build_positive_index(test)
    negs = np.stack([
        sample_negatives(n, test.num_items, seed, epoch=0xC0DE00 + j,
                         users=test.user, pos_keys=pos_keys)
        for j in range(n_neg)
    ], axis=1)
    dev = model.device
    sums = torch.zeros(3, dtype=torch.float64, device=dev)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        u = torch.as_tensor(test.user[start:stop]).to(dev, torch.int64)
        p = torch.as_tensor(test.item[start:stop]).to(dev, torch.int64)
        q = torch.as_tensor(negs[start:stop]).to(dev, torch.int64)
        pu = model.P[u]
        s_pos = (pu * model.Q[p]).sum(-1) + model.bi[p]
        s_neg = (torch.einsum("br,bnr->bn", pu, model.Q[q])
                 + model.bi[q])
        better = ((s_neg > s_pos[:, None]).float()
                  + 0.5 * (s_neg == s_pos[:, None]).float()).sum(-1)
        rank = 1.0 + better
        top = rank <= k
        sums += torch.stack([
            top.double().sum(),
            torch.where(top, 1.0 / torch.log2(rank + 1.0), 0.0).double().sum(),
            torch.where(top, 1.0 / rank, 0.0).double().sum(),
        ])
    hr, ndcg, mrr = (float(v) / n for v in sums)
    return {"hr": hr, "ndcg": ndcg, "mrr": mrr}


def full_ranks(model, users, pos, seen: SeenCSR) -> torch.Tensor:
    """Float64 rank of each positive ``pos[b]`` of user ``users[b]``
    (numpy int arrays of one chunk) against the whole catalog minus the
    user's ``seen`` items; the positive is not its own competitor. The
    item biases count (the user's are constant within a row)."""
    from mfx_torch.kernels.serve_topk import matmul_f32
    from mfx_torch.serve.topk import _exclude

    dev = model.device
    m = len(users)
    u = torch.as_tensor(np.asarray(users)).to(dev, torch.int64)
    p = torch.as_tensor(np.asarray(pos)).to(dev, torch.int64)
    scores = matmul_f32(model.P[u], model.Q) + model.bi.float()[None, :]
    rows_b = torch.arange(m, device=dev)
    s_pos = scores[rows_b, p]
    rows, items = seen.batch(np.asarray(users), pad_row=m)
    _exclude(scores, rows, items)
    scores[rows_b, p] = float("-inf")
    better = ((scores > s_pos[:, None]).sum(1).double()
              + 0.5 * (scores == s_pos[:, None]).sum(1).double())
    return 1.0 + better


def full_hr_ndcg_at_k(model, test, train=None, k: int = 10,
                      chunk: int = 1 << 10) -> dict:
    """{'hr', 'ndcg', 'mrr'}@K of ``model`` on a held-out split, ranking
    each positive against the full catalog (the unsampled protocol).
    ``train`` (optional RatingsCOO): interactions excluded from the
    competitor set; other test positives of the same user stay
    competitors. ``chunk`` positives a block, capped so that the (chunk,
    num_items) f32 score block stays under about 1 GB."""
    n = test.n_ratings
    if n == 0:
        return {"hr": 0.0, "ndcg": 0.0, "mrr": 0.0}
    if k < 1 or k > test.num_items:
        raise ValueError(
            f"k must be in [1, num_items={test.num_items}], got {k}"
        )
    seen = (train.seen_csr() if train is not None
            else SeenCSR.empty(test.num_users))
    chunk = max(1, min(chunk, n, (1 << 28) // max(1, test.num_items)))
    sums = torch.zeros(3, dtype=torch.float64, device=model.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        rank = full_ranks(model, test.user[start:stop],
                          test.item[start:stop], seen)
        top = rank <= k
        sums += torch.stack([
            top.double().sum(),
            torch.where(top, 1.0 / torch.log2(rank + 1.0), 0.0).sum(),
            torch.where(top, 1.0 / rank, 0.0).sum(),
        ])
    hr, ndcg, mrr = (float(v) / n for v in sums)
    return {"hr": hr, "ndcg": ndcg, "mrr": mrr}


def user_topk_metrics(model, test, train=None, k: int = 10,
                      batch: int = 256) -> dict:
    """Per-user top-K quality of the lists the stock recommender serves
    (train items excluded): {'recall', 'precision', 'ndcg', 'map',
    'coverage'}@K averaged over users with a held-out item, and, with
    ``train``, 'novelty' (mean -log2 p(i) of the recommended items under
    the train distribution). The reference's definitions: binary gains,
    the ideal DCG at min(K, |T_u|), AP truncated at K."""
    from mfx_torch.serve.topk import TopKRecommender

    if test.n_ratings == 0:
        return {"recall": 0.0, "precision": 0.0, "ndcg": 0.0, "map": 0.0}
    I = test.num_items
    keys = np.unique(test.user.astype(np.int64) * I + test.item)
    users = np.unique((keys // I).astype(np.int32))
    counts = np.searchsorted(
        keys, (users.astype(np.int64) + 1) * I
    ) - np.searchsorted(keys, users.astype(np.int64) * I)

    rec = TopKRecommender(model, train=train, batch=batch)
    items, _ = rec.recommend(users, k=k)  # (n_users, k)

    hit = np.zeros(items.shape, bool)
    qk = users.astype(np.int64)[:, None] * I + items
    pos = np.searchsorted(keys, qk.reshape(-1))
    ok = pos < keys.shape[0]
    hit.reshape(-1)[ok] = keys[pos[ok]] == qk.reshape(-1)[ok]

    ranks = np.arange(1, k + 1, dtype=np.float64)
    disc = 1.0 / np.log2(ranks + 1.0)
    nhit = hit.sum(axis=1).astype(np.float64)
    ideal = np.cumsum(disc)[np.minimum(counts, k) - 1]
    prec_at = np.cumsum(hit, axis=1) / ranks[None, :]
    ap = (prec_at * hit).sum(axis=1) / np.minimum(counts, k)
    out = {
        "recall": float((nhit / counts).mean()),
        "precision": float((nhit / k).mean()),
        "ndcg": float(((hit @ disc) / ideal).mean()),
        "map": float(ap.mean()),
        "coverage": float(np.unique(items).size / I),
    }
    if train is not None and train.n_ratings:
        pop = np.bincount(train.item, minlength=I).astype(np.float64)
        p = np.maximum(pop, 1.0) / train.n_ratings  # floor: unseen items
        out["novelty"] = float(-np.log2(p[items]).mean())
    return out
