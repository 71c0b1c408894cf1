"""Batched top-K recommendation serving, the counterpart of
``mfx/serve/topk.py``: one full-catalog product ``P[users] @ Qᵀ`` per user
batch, plus biases, seen-item exclusion by one scatter of -inf at the
batch's observed (row, item) pairs (from the shared ``SeenCSR``), and an
exact top-K.

The full-catalog product is a plain matrix product outside any kernel, so
it runs as ``torch.matmul`` in true f32 (TF32 off). The int8 tables score
as an f32 product of the int8 values: every product sum over a rank up to
1,040 stays below 2^24, so it is bitwise the int32 result.

Selection is :func:`top_k`, the reference's ``lax.top_k``: descending,
equal values lowest index first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mfx.data.coo import SeenCSR
from mfx_torch.kernels.serve_topk import matmul_f32
from mfx_torch.models.mf import MFModel

__all__ = ["TopKRecommender", "similar_items", "top_k"]

_NEG_INF = float("-inf")
_SORT_COLS = 4096  # top_k: widest row that one stable sort selects from


@dataclasses.dataclass(frozen=True)
class _Int8Tables:
    """Per-row symmetrically quantized serving tables: ``X ≈ X8 * scale``
    with ``scale = max|row| / 127``, 4x less memory than f32."""

    P8: torch.Tensor      # [U, r] int8
    pscale: torch.Tensor  # [U] f32
    Q8: torch.Tensor      # [I, r] int8
    qscale: torch.Tensor  # [I] f32
    bu: torch.Tensor
    bi: torch.Tensor
    mu: float

    @property
    def num_users(self) -> int:
        return self.P8.shape[0]

    @property
    def num_items(self) -> int:
        return self.Q8.shape[0]

    @property
    def rank(self) -> int:
        return self.P8.shape[-1]


def _quantize_rows(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric int8: (X8, scale) with X ≈ X8 * scale[:, None]."""
    X = X.float()
    scale = X.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    X8 = torch.round(X / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return X8, scale


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the rows of ``x``: the ``k`` largest values,
    descending, equal values lowest index first (``torch.topk`` does not
    order ties). Returns (values, int64 indices), each (rows, k). Narrow
    rows (candidate pools) take one stable sort; wide ones (a catalog)
    select by the k-th value, then order the k."""
    if x.shape[1] <= _SORT_COLS:
        vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    kth = torch.topk(x, k, dim=1).values[:, -1:]
    above = x > kth
    tie = x == kth
    room = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
    keep = above | (tie & (tie.cumsum(dim=1, dtype=torch.int32) <= room))
    idx = keep.nonzero()[:, 1].view(x.shape[0], k)  # ascending per row
    vals = x.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def _exclude(scores: torch.Tensor, rows, items) -> None:
    """Scatter -inf at the (row, item) pairs; rows past the block (the pad
    sentinel) are dropped, as the reference's out-of-bounds scatter."""
    r = torch.as_tensor(rows, device=scores.device).long()
    i = torch.as_tensor(items, device=scores.device).long()
    keep = r < scores.shape[0]
    scores[r[keep], i[keep]] = _NEG_INF


def _similar_batch(Qn: torch.Tensor, query: torch.Tensor, k: int):
    scores = matmul_f32(Qn[query], Qn)  # (B, I)
    # exclude the query item itself from its own neighbor list
    scores[torch.arange(query.shape[0], device=Qn.device), query] = _NEG_INF
    return top_k(scores, k)


def _normalized(Q: torch.Tensor) -> torch.Tensor:
    Q = Q.float()
    return Q / torch.linalg.vector_norm(Q, dim=1, keepdim=True).clamp_min(
        1e-12)


def similar_items(model, items, k: int = 10, batch: int = 256, device=None):
    """Top-``k`` most similar items per query item by factor cosine (biases
    excluded; the query item is excluded from its own list). One product
    per batch over the row-normalized item table on ``device`` (default:
    the model's). Each batch holds a (batch, num_items) f32 score block,
    capped at ~1 GB. Returns (items (n, k) int32, cosines (n, k) f32)."""
    items = np.asarray(items, np.int32).reshape(-1)
    num_items = model.num_items
    batch = max(1, min(batch, (1 << 28) // max(1, num_items)))
    if k < 1 or k > num_items - 1:
        raise ValueError(
            f"k must be in [1, num_items-1={num_items - 1}], got {k}"
        )
    if np.any((items < 0) | (items >= num_items)):
        raise ValueError("item id out of range")
    dev = torch.device(device) if device is not None else model.device
    Qn = _normalized(model.Q.to(dev))
    n = items.shape[0]
    out_i = np.empty((n, k), np.int32)
    out_s = np.empty((n, k), np.float32)
    for start in range(0, n, batch):
        stop = min(start + batch, n)
        qb = np.zeros(batch, np.int64)
        qb[: stop - start] = items[start:stop]
        s, i = _similar_batch(Qn, torch.as_tensor(qb, device=dev), k)
        out_i[start:stop] = i[: stop - start].cpu().numpy()
        out_s[start:stop] = s[: stop - start].cpu().numpy()
    return out_i, out_s


def _topk_batch(pu, bu_b, Q, bi, mu, rows, items, k):
    """One padded batch: ``pu @ Qᵀ + bi + bu + mu`` in f32, seen pairs
    excluded, exact top-K. ``pu`` may be bf16 (f32 products and sums)."""
    scores = matmul_f32(pu, Q) + bi[None, :] + bu_b[:, None] + mu
    _exclude(scores, rows, items)
    return top_k(scores, k)


def _topk_batch_int8(pu8, ps, bu_b, Q8, qs, bi, mu, rows, items, k):
    raw = matmul_f32(pu8, Q8)  # exact: |sums| < 2^24
    scores = (raw * ps[:, None] * qs[None, :] + bi[None, :] + bu_b[:, None]
              + mu)
    _exclude(scores, rows, items)
    return top_k(scores, k)


class TopKRecommender:
    """Serve top-K recommendations from a trained :class:`MFModel`.

    >>> rec = TopKRecommender(result.model, train=train_coo, device="cuda")
    >>> items, scores = rec.recommend([3, 17, 940], k=10)

    ``train`` (optional RatingsCOO): interactions to EXCLUDE from results.
    Users absent from ``train`` get unfiltered top-K.

    ``batch``: users per dispatch. Each dispatch scores the full catalog,
    a (batch, num_items) f32 block on the device, capped at ~1 GB.

    ``table_dtype``: 'f32', 'bf16' (factor tables stored bf16, f32 products
    and sums, f32 biases) or 'int8' (per-row symmetric int8 with an f32
    scale per row).

    ``recall_target``: accepted for the reference's interface and served
    EXACTLY. The reference's ``approx_max_k`` is a TPU partial reduce that
    every other backend lowers to the exact op; there is no counterpart
    here, so the result is always the exact top-K.

    ``device``: where the catalog is scored (default: the model's). The
    user table stays where it lives; only a batch's rows travel. On a CPU
    device this runs on the CPU; on CUDA it runs on the card.
    """

    def __init__(
        self, model, train=None, batch: int = 256, table_dtype: str = "f32",
        recall_target: float | None = None, device=None,
    ):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if table_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                "table_dtype must be 'f32', 'bf16' or 'int8', got "
                f"{table_dtype!r}"
            )
        if recall_target is not None and not 0.0 < recall_target <= 1.0:
            raise ValueError(
                f"recall_target must be in (0, 1], got {recall_target}"
            )
        self.recall_target = recall_target
        self.table_dtype = table_dtype
        self.device = torch.device(device) if device is not None else (
            model.device)
        self.batch = batch
        self._seen = (
            train.seen_csr() if train is not None
            else SeenCSR.empty(model.num_users)
        )
        self.model = self._prepare(model)

    def _prepare(self, model):
        """Build the tables this recommender streams: the catalog side on
        the device, the user side where it lives. Returns what
        ``self.model`` reports (the quantized tables for int8)."""
        dev = self.device
        self._bu = model.bu
        self._bi = model.bi.to(dev, torch.float32)
        self._mu = torch.tensor(model.mu, dtype=torch.float32, device=dev)
        if self.table_dtype == "int8":
            P8, ps = _quantize_rows(model.P)
            Q8, qs = _quantize_rows(model.Q.to(dev))
            self._P, self._pscale, self._Q, self._qscale = P8, ps, Q8, qs
            return _Int8Tables(P8=P8, pscale=ps, Q8=Q8, qscale=qs,
                               bu=model.bu, bi=self._bi, mu=model.mu)
        if self.table_dtype == "f32":
            self._P, self._Q = model.P, model.Q.to(dev, torch.float32)
            return model
        # bf16: the recommender keeps only the bf16 copies of the tables
        self._P = model.P.to(torch.bfloat16)
        self._Q = model.Q.to(dev, torch.bfloat16)
        return MFModel(self._P, self._Q, model.bu, self._bi, model.mu)

    def _exclusions(self, users: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(rows, items) of the batch's seen pairs, padded to a pow-2
        bucket; pad slots use the out-of-range row sentinel ``batch``."""
        return self._seen.batch(users, pad_row=self.batch)

    def _validate(self, users: np.ndarray, k: int) -> None:
        if k < 1 or k > self.model.num_items:
            raise ValueError(
                f"k must be in [1, num_items={self.model.num_items}], got {k}"
            )
        if np.any((users < 0) | (users >= self.model.num_users)):
            raise ValueError("user id out of range")

    def _gather(self, table: torch.Tensor, ub: np.ndarray) -> torch.Tensor:
        """Rows ``ub`` of a user-side table, moved to the device."""
        idx = torch.as_tensor(ub, dtype=torch.long, device=table.device)
        return table[idx].to(self.device)

    def _score_batch(self, ub, rows, items, k):
        """Score one padded user batch; returns (items, scores) tensors."""
        bu_b = self._gather(self._bu, ub).float()
        if self.table_dtype == "int8":
            s, i = _topk_batch_int8(
                self._gather(self._P, ub), self._gather(self._pscale, ub),
                bu_b, self._Q, self._qscale, self._bi, self._mu, rows, items,
                k,
            )
        else:
            s, i = _topk_batch(self._gather(self._P, ub), bu_b, self._Q,
                               self._bi, self._mu, rows, items, k)
        return i, s

    def _score_cols(self) -> int:
        """Columns of one dispatch's score block; sizes the batch cap."""
        return self.model.num_items

    @property
    def max_k(self) -> int:
        """Largest ``k`` this recommender can serve."""
        return self.model.num_items

    def recommend(self, users, k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """Top-``k`` unseen items per user: (items (n, k) int32,
        scores (n, k) f32), both sorted by descending score."""
        users = np.asarray(users, np.int32).reshape(-1)
        self._validate(users, k)
        bsz = max(1, min(self.batch, (1 << 28) // max(1, self._score_cols())))
        n = users.shape[0]
        out_i = np.empty((n, k), np.int32)
        out_s = np.empty((n, k), np.float32)
        for start in range(0, n, bsz):
            stop = min(start + bsz, n)
            ub = np.zeros(bsz, np.int32)
            ub[: stop - start] = users[start:stop]
            rows, items = self._exclusions(ub[: stop - start])
            i_, s_ = self._score_batch(ub, rows, items, k)
            out_i[start:stop] = i_[: stop - start].cpu().numpy()
            out_s[start:stop] = s_[: stop - start].cpu().numpy()
        return out_i, out_s
