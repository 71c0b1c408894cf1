"""RatingsCOO — the sparse ratings container (SURVEY.md C1).

The reference project implies a Java
program loading ``user \t item \t rating`` triples into memory; here the
container is a host-side NumPy struct-of-arrays in COO layout, with helpers
to move onto TPU devices. int32 ids + float32 ratings throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RatingsCOO", "SeenCSR"]


@dataclasses.dataclass
class RatingsCOO:
    """Sparse ratings in coordinate format (host memory).

    Attributes:
      user: int32 [n] user ids in ``[0, num_users)``.
      item: int32 [n] item ids in ``[0, num_items)``.
      rating: float32 [n] rating values (explicit feedback) or all-ones
        (implicit feedback).
      num_users: number of user rows in the factor table P.
      num_items: number of item rows in the factor table Q.
      synthetic: True when the ratings came from a seeded generator rather
        than a real dataset file (propagated through caches so benchmark /
        driver output can say so — real data added later is never shadowed
        by a synthetic cache; see mfx.data.loaders).
      item_raw_ids: optional int64 [num_items] map from dense item id back
        to the dataset's raw id. Loaders relabel items by descending
        rating frequency (dense id 0 = most-rated item) so the Zipf head
        clusters into the first item windows — the layout the dense-
        stratum fast path needs (mfx/kernels/dense_pallas.py); this map
        is how predictions translate back to catalog ids.
      user_raw_ids: optional int64 [num_users] map from dense user id
        back to the dataset's raw id. Loaders relabel USERS by
        descending activity too, so rating mass concentrates into
        hot-user × hot-item strata — 2-D occupancy engineering that cuts
        streamed bytes/rating in the dense blocked phase (the r4 lever;
        STATUS.md roofline).
      timestamp: optional int64 [n] per-rating event times in the
        dataset's native unit (seconds for MovieLens, days for Netflix
        dates) — only the ORDERING is contractual. Enables the
        chronological split protocols (mfx.data.split); None when the
        source carried no time column.
    """

    user: np.ndarray
    item: np.ndarray
    rating: np.ndarray
    num_users: int
    num_items: int
    synthetic: bool = False
    item_raw_ids: np.ndarray | None = None
    timestamp: np.ndarray | None = None
    user_raw_ids: np.ndarray | None = None

    def __post_init__(self):
        self.user = np.asarray(self.user, dtype=np.int32)
        self.item = np.asarray(self.item, dtype=np.int32)
        self.rating = np.asarray(self.rating, dtype=np.float32)
        if not (self.user.shape == self.item.shape == self.rating.shape):
            raise ValueError(
                f"COO arrays must share shape; got {self.user.shape}, "
                f"{self.item.shape}, {self.rating.shape}"
            )
        if self.user.ndim != 1:
            raise ValueError("COO arrays must be 1-D")
        if self.timestamp is not None:
            self.timestamp = np.asarray(self.timestamp, dtype=np.int64)
            if self.timestamp.shape != self.user.shape:
                raise ValueError(
                    f"timestamp shape {self.timestamp.shape} != COO shape "
                    f"{self.user.shape}"
                )

    @property
    def n_ratings(self) -> int:
        return int(self.user.shape[0])

    def __len__(self) -> int:
        return self.n_ratings

    @property
    def global_mean(self) -> float:
        return float(self.rating.mean()) if self.n_ratings else 0.0

    @property
    def density(self) -> float:
        denom = float(self.num_users) * float(self.num_items)
        return self.n_ratings / denom if denom else 0.0

    def validate(self) -> None:
        """Bounds-check ids; raises on corruption (debug aid)."""
        if self.n_ratings == 0:
            return
        if self.user.min() < 0 or self.user.max() >= self.num_users:
            raise ValueError(
                f"user ids out of range [0, {self.num_users}): "
                f"[{self.user.min()}, {self.user.max()}]"
            )
        if self.item.min() < 0 or self.item.max() >= self.num_items:
            raise ValueError(
                f"item ids out of range [0, {self.num_items}): "
                f"[{self.item.min()}, {self.item.max()}]"
            )

    def select(self, idx: np.ndarray) -> "RatingsCOO":
        """A new COO with rows gathered at ``idx`` (shares num_users/items)."""
        return RatingsCOO(
            user=self.user[idx],
            item=self.item[idx],
            rating=self.rating[idx],
            num_users=self.num_users,
            num_items=self.num_items,
            synthetic=self.synthetic,
            item_raw_ids=self.item_raw_ids,
            timestamp=None if self.timestamp is None else self.timestamp[idx],
            user_raw_ids=self.user_raw_ids,
        )

    def concat(self, other: "RatingsCOO") -> "RatingsCOO":
        if (other.num_users, other.num_items) != (self.num_users, self.num_items):
            raise ValueError("cannot concat COOs with different table shapes")
        both_ts = self.timestamp is not None and other.timestamp is not None
        return RatingsCOO(
            user=np.concatenate([self.user, other.user]),
            item=np.concatenate([self.item, other.item]),
            rating=np.concatenate([self.rating, other.rating]),
            num_users=self.num_users,
            num_items=self.num_items,
            synthetic=self.synthetic or other.synthetic,
            item_raw_ids=self.item_raw_ids,
            user_raw_ids=self.user_raw_ids,
            # one side without times would poison a chronological cut:
            # the merged COO keeps timestamps only when BOTH sides have them
            timestamp=(
                np.concatenate([self.timestamp, other.timestamp])
                if both_ts else None
            ),
        )

    # ---- derived indexes ----------------------------------------------

    def seen_csr(self) -> "SeenCSR":
        """Per-user seen-item index over these triples (see SeenCSR)."""
        order = np.argsort(self.user, kind="stable")
        items = self.item[order].astype(np.int32)
        offsets = np.searchsorted(
            self.user[order], np.arange(self.num_users + 1)
        ).astype(np.int64)
        return SeenCSR(items=items, offsets=offsets)

    # ---- persistence ------------------------------------------------------

    def save_npz(self, path) -> None:
        # uncompressed: cache files are written once and re-read often; the
        # single-core host pays dearly for deflate on 100M+ rating arrays
        extra = {}
        if self.item_raw_ids is not None:
            extra["item_raw_ids"] = np.asarray(self.item_raw_ids, np.int64)
        if self.user_raw_ids is not None:
            extra["user_raw_ids"] = np.asarray(self.user_raw_ids, np.int64)
        if self.timestamp is not None:
            extra["timestamp"] = self.timestamp
        np.savez(
            path,
            user=self.user,
            item=self.item,
            rating=self.rating,
            num_users=np.int64(self.num_users),
            num_items=np.int64(self.num_items),
            synthetic=np.bool_(self.synthetic),
            **extra,
        )

    @staticmethod
    def load_npz(path) -> "RatingsCOO":
        with np.load(path) as z:
            return RatingsCOO(
                user=z["user"],
                item=z["item"],
                rating=z["rating"],
                num_users=int(z["num_users"]),
                num_items=int(z["num_items"]),
                synthetic=bool(z["synthetic"]) if "synthetic" in z else False,
                item_raw_ids=(
                    z["item_raw_ids"] if "item_raw_ids" in z else None
                ),
                timestamp=z["timestamp"] if "timestamp" in z else None,
                user_raw_ids=(
                    z["user_raw_ids"] if "user_raw_ids" in z else None
                ),
            )


@dataclasses.dataclass
class SeenCSR:
    """Per-user seen-item index (CSR over a RatingsCOO) — the shared
    exclusion machinery of serving ("don't recommend what the user
    already rated", mfx/serve/topk.py) and full-catalog ranking eval
    (seen items are not ranking competitors, mfx/eval/ranking.py).

    Build with :meth:`RatingsCOO.seen_csr` (or :meth:`SeenCSR.empty` for
    the no-exclusions case). ``batch`` emits a user batch's (row, item)
    pairs as flat padded arrays shaped for a single -inf scatter inside a
    jitted scorer: padding goes to pow-2 buckets so the consumer's
    compiled-program count stays logarithmic in batch content.
    """

    items: np.ndarray  # int32 [nnz], user-major
    offsets: np.ndarray  # int64 [num_users + 1]

    @staticmethod
    def empty(num_users: int) -> "SeenCSR":
        return SeenCSR(
            items=np.zeros(0, np.int32),
            offsets=np.zeros(num_users + 1, np.int64),
        )

    def batch(
        self, users: np.ndarray, pad_row: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """(rows, items) of the batch's seen pairs, padded to a pow-2
        bucket; pad slots use the out-of-range row sentinel ``pad_row``
        (dropped by the jitted scatter's out-of-bounds semantics)."""
        starts = self.offsets[users]
        stops = self.offsets[np.asarray(users) + 1]
        counts = (stops - starts).astype(np.int64)
        total = int(counts.sum())
        cap = max(8, 1 << int(np.ceil(np.log2(max(total, 1)))))
        rows = np.full(cap, pad_row, np.int32)
        items = np.zeros(cap, np.int32)
        pos = 0
        for b in np.flatnonzero(counts):
            c = int(counts[b])
            rows[pos:pos + c] = b
            items[pos:pos + c] = self.items[starts[b]:starts[b] + c]
            pos += c
        return rows, items
