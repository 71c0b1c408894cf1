"""Sampled top-K ranking metrics (HR, NDCG, MRR @ K), the counterpart of
``mfx/eval/ranking.py::hr_ndcg_at_k`` under the sampled protocol.

Each held-out positive is ranked against ``n_neg`` negatives drawn
uniformly from the catalog and rejection-filtered against the user's
observed positives (``pos_keys``: train and test). The negatives are the
reference's host draws (``mfx_torch.data.bpr.sample_negatives``, one
seeded stream per column), so both packages rank the same candidates;
the scores are computed in chunks on the model's device. The full-catalog
and per-user protocols are not ported yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import numpy as np
import torch

from mfx_torch.data.bpr import build_positive_index, sample_negatives

__all__ = ["hr_ndcg_at_k"]


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
