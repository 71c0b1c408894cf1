"""Fused top-K serving — score-block-free scoring and selection, the
counterpart of the single-device part of ``mfx/serve/fused.py``.

``FusedTopKRecommender`` never materializes the stock path's
``(batch, catalog)`` score block: the per-tile top-``depth`` kernel
(:mod:`mfx_torch.kernels.serve_topk`, ``csrc/tile_topk.cu`` on the card)
leaves only ``depth·catalog/tile`` candidates per user. The finalize then
excludes seen candidates (a tile's runner-up takes over when its winner
was seen), takes the exact top-K over the surviving pool (:func:`top_k`,
ties to the lower index as ``lax.top_k``), and adds the per-user constants
``b_u + mu`` back.

Accuracy contract (the reference's): the result is APPROXIMATE — a true
top-K item is missed only when more than ``depth`` of a user's top
candidates (or fewer plus seen tile winners) share one catalog tile. If
exclusions EXHAUST the pool, serving raises instead of returning seen or
pad items. ``exact=True`` certifies the result: an item outside its
tile's top-``depth`` scores at most the tile's ``depth``-th best, so
rescoring the batch's union of tiles whose ``depth``-th best beats a
user's k-th candidate recovers the true top-K; when that union outgrows
``exact_tiles`` the batch is served by the stock exact scorer
(``exact_fallbacks`` counts those batches).

Seen-item membership looks the candidates up in each user's sorted seen
items with a batched ``torch.searchsorted`` — O(B·n·log E), where the
reference's broadcast compare (which XLA fuses) would materialize a
``(B, E, n)`` block in PyTorch. The seen items live on the device as a
CSR sorted once per user (:class:`_SeenRows`), so a batch's rows are one
gather on the device, padded only to the batch's largest count.
"""

from __future__ import annotations

import numpy as np
import torch

from mfx_torch.kernels.serve_topk import (AUG_LANES, aug_width, matmul_f32,
                                          tile_topk)
from mfx_torch.serve.topk import (TopKRecommender, _normalized,
                                  _quantize_rows, _similar_batch, top_k)

__all__ = ["FusedTopKRecommender", "similar_items_fused"]

_PAD_BIAS = -1e30  # catalog pad rows: can never win a tile
_NEG_INF = float("-inf")


def _validate_fused(
    table_dtype: str, tile: int, rank: int, allow_int8: bool = False,
    exact: bool = False,
) -> None:
    """Shared constructor validation of the fused serving family."""
    allowed = ("f32", "bf16", "int8") if allow_int8 else ("f32", "bf16")
    if table_dtype not in allowed:
        raise ValueError(
            f"fused serving supports table_dtype {allowed}, got "
            f"{table_dtype!r}"
        )
    if table_dtype == "int8" and exact:
        raise ValueError(
            "exact=True certifies the TRUE f32 scores; an int8-quantized "
            "catalog cannot be certified against them — use table_dtype "
            "'f32'/'bf16' for exact mode, or exact=False for the int8 "
            "capacity lever (recall parity with the stock int8 scorer)"
        )
    if tile < 128 or tile % 128:
        raise ValueError(f"tile must be a multiple of 128, got {tile}")
    if rank >= AUG_LANES:
        raise ValueError(
            f"fused serving supports rank < {AUG_LANES}, got {rank}"
        )


def _augment_catalog(Q, bias, ipad: int, dt) -> torch.Tensor:
    """The augmented catalog [q, bias, 0…] padded to ``ipad`` rows; pad
    rows carry bias ``_PAD_BIAS`` so they can never win a tile."""
    I, r = Q.shape
    Q_aug = torch.zeros(ipad, aug_width(r), dtype=dt, device=Q.device)
    Q_aug[:I, :r] = Q.to(dt)
    Q_aug[:, r] = _PAD_BIAS
    Q_aug[:I, r] = bias.to(Q.device, dt)
    return Q_aug


def _augment_catalog_int8(Q, bias, ipad: int, tile: int):
    """int8 augmented catalog and its (n_tiles, 2, tile) f32 scale/bias
    stream. Rows quantize per-row symmetrically like the stock int8
    scorer; the bias lane stays zero (a bias cannot ride an int8 lane) and
    rides ``sb``; pad rows get scale 0 and bias ``_PAD_BIAS``."""
    I, r = Q.shape
    Q8, scale = _quantize_rows(Q)
    Q_aug = torch.zeros(ipad, aug_width(r), dtype=torch.int8, device=Q.device)
    Q_aug[:I, :r] = Q8
    sc = torch.zeros(ipad, dtype=torch.float32, device=Q.device)
    sc[:I] = scale
    bl = torch.full((ipad,), _PAD_BIAS, dtype=torch.float32, device=Q.device)
    bl[:I] = bias.to(Q.device, torch.float32)
    sb = torch.stack([sc.view(-1, tile), bl.view(-1, tile)], dim=1)
    return Q_aug, sb.contiguous()


def _augment_rows(pu, dt, width: int) -> torch.Tensor:
    """The batch's augmented user rows [p, 1, 0…]."""
    B, r = pu.shape
    pu_aug = torch.zeros(B, width, dtype=dt, device=pu.device)
    pu_aug[:, :r] = pu.to(dt)
    pu_aug[:, r] = 1.0
    return pu_aug


def _check_served(items, scores, num_items: int) -> None:
    """Loud failure when exclusions exhausted the fused candidate pool —
    the served slots would otherwise carry seen items (score -inf) or
    catalog pad rows (id >= num_items)."""
    if np.isneginf(scores).any() or (items >= num_items).any():
        raise ValueError(
            "fused serving: the per-tile candidate pool was exhausted by "
            "exclusions for at least one user (k too close to the pool "
            "size) — use a smaller tile (more tiles => more candidates) "
            "or the exact TopKRecommender"
        )


def _member(seen_sorted, cand) -> torch.Tensor:
    """Per-row membership of candidates ``cand`` (B, n) among the row's
    seen items ``seen_sorted`` (B, E), each row ascending (the pad
    sentinel, past every item id, sorts last)."""
    pos = torch.searchsorted(seen_sorted, cand)
    pos = pos.clamp_max_(seen_sorted.shape[1] - 1)
    return seen_sorted.gather(1, pos) == cand


class _SeenRows:
    """A ``SeenCSR`` on the device with each user's items ascending;
    :meth:`rows` gives a user batch's seen items as a (batch, E) matrix,
    E the batch's largest count, rows ascending and padded with an
    out-of-range sentinel (which sorts last)."""

    def __init__(self, csr, device):
        counts = torch.as_tensor(np.diff(csr.offsets), device=device)
        items = torch.as_tensor(csr.items, device=device).long()
        users = torch.repeat_interleave(
            torch.arange(counts.shape[0], device=device), counts)
        span = int(items.max()) + 1 if items.numel() else 1
        self._items = (torch.sort(users * span + items).values % span).int()
        self._offsets = torch.as_tensor(csr.offsets, device=device)

    def rows(self, users: np.ndarray, batch: int, sentinel: int):
        dev = self._offsets.device
        u = torch.as_tensor(users, dtype=torch.long, device=dev)
        start = self._offsets[u]
        count = self._offsets[u + 1] - start
        width = max(int(count.max()) if u.numel() else 0, 1)
        lane = torch.arange(width, device=dev)
        mat = torch.full((batch, width), sentinel, dtype=torch.int32,
                         device=dev)
        if self._items.numel():
            pos = (start[:, None] + lane).clamp_max_(self._items.shape[0] - 1)
            mat[: u.shape[0]] = torch.where(lane < count[:, None],
                                            self._items[pos], sentinel)
        return mat


def _pool(ms, as_, seen_sorted, tile: int):
    """Global ids of the per-tile candidates and their values with seen
    candidates at -inf, each (B, depth·n_tiles), rank-major as the
    reference concatenates them."""
    tn = ms[0].shape[1]
    base = (torch.arange(tn, dtype=torch.int32, device=ms[0].device)
            * tile)[None, :]
    gs = [a + base for a in as_]
    vs = [torch.where(_member(seen_sorted, g), _NEG_INF, m)
          for g, m in zip(gs, ms)]
    return torch.cat(vs, dim=1), torch.cat(gs, dim=1)


def _serve(pu, Q_aug, bu_b, mu, seen_sorted, k, tile, sb=None):
    """The fused dispatch: augment the batch's (B, rank) user rows, run
    the per-tile top-2 kernel, exclude seen candidates (runner-up
    fallback), exact top-K over the pool, add the per-user constants back.
    ``sb`` is the int8 catalog's scale/bias stream (None for f32/bf16)."""
    aug_dt = torch.float32 if Q_aug.dtype == torch.int8 else Q_aug.dtype
    pu_aug = _augment_rows(pu, aug_dt, Q_aug.shape[1])
    m1, a1, m2, a2 = tile_topk(pu_aug, Q_aug, tile=tile, depth=2, sb=sb)
    vals, ids = _pool((m1, m2), (a1, a2), seen_sorted, tile)
    top, sel = top_k(vals, k)
    return ids.gather(1, sel), top + bu_b[:, None] + mu


def _serve_exact(pu, Q_aug, bu_b, mu, seen_sorted, k, tile, s_max, depth):
    """CERTIFIED-EXACT fused serving. The per-tile top-``depth`` kernel
    runs as in :func:`_serve`; an item NOT among its tile's top-``depth``
    scores at most the tile's ``depth``-th best ``m_D[t]``. With ``τ`` the
    user's k-th pool candidate, only tiles with ``m_D[t] > τ`` can hide a
    better item, so the UNION of such tiles across the batch is rescored
    exactly (one gather and f32 product), the pool's copies of union items
    are masked (dedup), and the final exact top-K runs over pool ∪ union.
    Returns (items, scores, overflow, n_suspect): ``overflow`` means the
    union exceeded ``s_max`` and the result is NOT certified."""
    pu_aug = _augment_rows(pu, Q_aug.dtype, Q_aug.shape[1])
    ranks = tile_topk(pu_aug, Q_aug, tile=tile, depth=depth)
    ms, as_ = ranks[0::2], ranks[1::2]
    B = ms[0].shape[0]
    dev = pu_aug.device
    ipad = Q_aug.shape[0]
    vals, ids = _pool(ms, as_, seen_sorted, tile)
    top, sel = top_k(vals, k)
    pool_ids = ids.gather(1, sel)
    tau = top[:, k - 1]
    suspect = ms[-1] > tau[:, None]              # (B, tn)
    sus_any = suspect.any(dim=0)                 # (tn,)
    n_sus = sus_any.sum()
    overflow = n_sus > s_max
    # suspects first (ascending tile id), then the remaining tiles — extra
    # non-suspect slots only ADD exactly-scored candidates
    sel_tiles = torch.argsort((~sus_any).to(torch.int8), stable=True)[:s_max]
    cols = (sel_tiles[:, None] * tile
            + torch.arange(tile, device=dev)[None, :])
    gids = cols.reshape(-1)                      # (s_max*tile,) distinct
    width = gids.shape[0]
    sub = matmul_f32(pu_aug, Q_aug[gids])        # (B, s_max*tile)
    # global -> local position of union items (ipad slot = seen sentinel,
    # local slot ``width`` = not in the union, dropped)
    loc = torch.full((ipad + 1,), width, dtype=torch.long, device=dev)
    loc[gids] = torch.arange(width, device=dev)
    seen_loc = loc[seen_sorted.long().clamp(0, ipad)]
    sub = torch.cat([sub, sub.new_zeros(B, 1)], dim=1)
    sub.scatter_(1, seen_loc, _NEG_INF)
    sub = sub[:, :width]
    # dedup: pool copies of union items yield to their exact rescore
    in_union = loc[pool_ids.long()] < width
    allv = torch.cat([torch.where(in_union, _NEG_INF, top), sub], dim=1)
    alli = torch.cat([pool_ids, gids.to(torch.int32)[None, :].expand(B, -1)],
                     dim=1)
    fv, fsel = top_k(allv, k)
    return alli.gather(1, fsel), fv + bu_b[:, None] + mu, overflow, n_sus


class _FusedServingBase(TopKRecommender):
    """Members of the fused recommenders: batch-row user gather (the user
    table is never copied or widened), the per-row seen matrix, the
    disabled score-block batch cap, and the pool-exhaustion check on every
    served batch."""

    def _score_cols(self) -> int:
        return 1  # no (batch, catalog) score block — no batch cap

    def _exclusions(self, users):
        """The batch's seen rows on the device (the fused finalize tests
        candidate membership against them)."""
        return None, self._seen_rows.rows(users, self.batch, self._ipad)

    def recommend(self, users, k: int = 10):
        items, scores = super().recommend(users, k=k)
        _check_served(items, scores, self.model.num_items)
        return items, scores


class FusedTopKRecommender(_FusedServingBase):
    """Score-block-free top-K serving (see module docstring).

    >>> rec = FusedTopKRecommender(model, train=train_coo, device="cuda")
    >>> items, scores = rec.recommend(users, k=100)

    ``table_dtype``: 'f32', 'bf16' or 'int8'. bf16 halves the augmented
    catalog (the item biases ride the bias lane in bf16 too, and the user
    rows round to bf16). int8 quantizes the catalog per row like the stock
    int8 scorer, with an f32 scale/bias side stream (user rows stay f32);
    ``exact=True`` is f32/bf16 only.

    ``tile``: catalog items per kernel tile (multiple of 128). Larger
    tiles raise the chance that several of a user's top items share a tile
    (only the top-2 per tile survive).

    ``device``: where the catalog lives and the kernel runs (default: the
    model's). The user table stays where it lives — host or device — and
    only a batch's (B, rank) rows travel. On a CUDA device the kernel runs
    or the call raises.

    ``exact=True`` certifies the result (see :func:`_serve_exact`): batches
    whose suspect-tile union outgrows ``exact_tiles`` are served by the
    stock exact scorer, counted by ``exact_fallbacks``.
    """

    def __init__(
        self, model, train=None, batch: int = 256, table_dtype: str = "f32",
        tile: int = 1024, exact: bool = False, exact_tiles: int = 64,
        exact_depth: int = 8, device=None,
    ):
        _validate_fused(table_dtype, tile, model.rank, allow_int8=True,
                        exact=exact)
        if exact_tiles < 1:
            raise ValueError(f"exact_tiles must be >= 1, got {exact_tiles}")
        if not 1 <= exact_depth <= tile:
            raise ValueError(
                f"exact_depth must be in [1, tile], got {exact_depth}"
            )
        self.tile = tile
        self._ipad = -(-model.num_items // tile) * tile
        self._tn = self._ipad // tile
        self.exact = bool(exact)
        self._s_max = min(exact_tiles, self._tn)
        self.exact_depth = exact_depth
        self.exact_fallbacks = 0  # batches that overflowed to the stock path
        self._exact_rec = None
        self._fused_dtype = table_dtype
        # the base wires the seen CSR and batching; _prepare builds the
        # augmented catalog
        super().__init__(model, train=train, batch=batch, table_dtype="f32",
                         device=device)
        self.table_dtype = table_dtype

    def _prepare(self, model):
        dev = self.device
        Q = model.Q.to(dev, torch.float32)
        if self._fused_dtype == "int8":
            self._Q_aug, self._sb = _augment_catalog_int8(
                Q, model.bi, self._ipad, self.tile)
        else:
            dt = (torch.bfloat16 if self._fused_dtype == "bf16"
                  else torch.float32)
            self._Q_aug = _augment_catalog(Q, model.bi, self._ipad, dt)
            self._sb = None
        self._P, self._bu = model.P, model.bu
        self._mu = torch.tensor(model.mu, dtype=torch.float32, device=dev)
        self._seen_rows = _SeenRows(self._seen, dev)
        return model

    @property
    def max_k(self) -> int:
        return min(
            self.model.num_items,
            (self.exact_depth if self.exact else 2) * self._tn,
        )

    def _validate(self, users, k):
        super()._validate(users, k)
        pool = (self.exact_depth if self.exact else 2) * self._tn
        if k > pool:
            raise ValueError(
                f"k={k} exceeds the fused candidate pool depth*n_tiles="
                f"{pool}; lower tile or use TopKRecommender"
            )

    def _score_batch(self, ub, rows, seen, k):
        del rows  # fused exclusion uses the per-row seen rows
        pu = self._gather(self._P, ub).float()
        bu_b = self._gather(self._bu, ub).float()
        if not self.exact:
            return _serve(pu, self._Q_aug, bu_b, self._mu, seen, k,
                          self.tile, sb=self._sb)
        i_, s_, overflow, _n = _serve_exact(
            pu, self._Q_aug, bu_b, self._mu, seen, k, self.tile,
            self._s_max, self.exact_depth,
        )
        if bool(overflow):
            # the suspect-tile union outgrew the rescore budget: this batch
            # is not certified — serve it through the stock exact scorer,
            # so 'exact=True' is unconditional
            self.exact_fallbacks += 1
            if self._exact_rec is None:
                self._exact_rec = TopKRecommender(
                    self.model, batch=self.batch, device=self.device
                )
                self._exact_rec._seen = self._seen  # share the CSR
            return self._exact_rec._score_batch(
                ub, *self._exact_rec._exclusions(ub), k
            )
        return i_, s_


def similar_items_fused(
    model, items, k: int = 10, batch: int = 256, tile: int = 1024,
    table_dtype: str = "f32", exact: bool = False, exact_tiles: int = 64,
    exact_depth: int = 8, device=None,
):
    """Score-block-free related items: top-``k`` item neighbors by factor
    cosine through the same per-tile kernel and finalize as
    :class:`FusedTopKRecommender` — the query rows ride the user side, the
    row-normalized catalog the augmented table with a zero bias lane, and
    each row excludes its own query item. Approximate unless
    ``exact=True`` (the certified suspect-tile rescore; an overflowing
    batch is served by the stock cosine scorer). Returns (items (n, k)
    int32, cosines (n, k) f32)."""
    if table_dtype == "int8":
        raise ValueError(
            "int8 tables are not supported for cosine similar-items: the "
            "catalog rows must be row-normalized in f32 BEFORE augmenting "
            "(per-row int8 quantization of unit vectors destroys the "
            "cosine semantics the stock path certifies against); use "
            "table_dtype 'f32' or 'bf16'"
        )
    _validate_fused(table_dtype, tile, model.rank, exact=exact)
    items = np.asarray(items, np.int32).reshape(-1)
    I = model.num_items
    ipad = -(-I // tile) * tile
    tn = ipad // tile
    pool = (exact_depth if exact else 2) * tn
    if k < 1 or k > min(I - 1, pool):
        raise ValueError(
            f"k must be in [1, min(num_items-1, depth*n_tiles)="
            f"{min(I - 1, pool)}], got {k}"
        )
    if np.any((items < 0) | (items >= I)):
        raise ValueError("item id out of range")
    dev = torch.device(device) if device is not None else model.device
    dt = torch.bfloat16 if table_dtype == "bf16" else torch.float32
    Qn = _normalized(model.Q.to(dev))
    Q_aug = _augment_catalog(Qn, torch.zeros(I, device=dev), ipad, dt)
    zeros_bu = torch.zeros(batch, dtype=torch.float32, device=dev)
    mu = torch.zeros((), dtype=torch.float32, device=dev)

    n = items.shape[0]
    out_i = np.empty((n, k), np.int32)
    out_s = np.empty((n, k), np.float32)
    for start in range(0, n, batch):
        stop = min(start + batch, n)
        qb = np.zeros(batch, np.int32)
        qb[: stop - start] = items[start:stop]
        # exclusion: each row's own query id (padded rows exclude query 0
        # too — their outputs are discarded)
        q_t = torch.as_tensor(qb, dtype=torch.long, device=dev)
        seen_t = q_t.int()[:, None]
        pu = Qn[q_t]
        if exact:
            i_, s_, overflow, _n = _serve_exact(
                pu, Q_aug, zeros_bu, mu, seen_t, k, tile,
                min(exact_tiles, tn), exact_depth,
            )
            if bool(overflow):
                # certificate failed: exact cosine top-K via the stock
                # per-batch path
                s_, i_ = _similar_batch(Qn, q_t, k)
        else:
            i_, s_ = _serve(pu, Q_aug, zeros_bu, mu, seen_t, k, tile)
        m = stop - start
        i_np = i_[:m].cpu().numpy().astype(np.int32)
        s_np = s_[:m].cpu().numpy()
        _check_served(i_np, s_np, I)
        out_i[start:stop] = i_np
        out_s[start:stop] = s_np
    return out_i, out_s
