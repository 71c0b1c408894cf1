"""Dataset loaders (SURVEY.md C2).

Parsers for the MovieLens file formats (100K ``u.data`` tab-separated,
1M ``ratings.dat`` ``::``-separated, 25M ``ratings.csv``) plus a
Netflix-Prize directory parser, a generic triples parser, an ``.npz`` cache,
and seeded synthetic fallbacks for every BASELINE config shape (the build
environment has no network egress, so real downloads are the user's job;
``load_dataset`` transparently falls back to a synthetic dataset of the
matching shape when the raw files are absent).

Raw ids are remapped to dense ``[0, num_users) × [0, num_items)`` index
space, since factor tables are dense row arrays on TPU.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable

import numpy as np

from mfx_torch.data.coo import RatingsCOO
from mfx_torch.data import synthetic as syn

__all__ = [
    "load_dataset",
    "parse_triples",
    "parse_ml100k",
    "parse_ml1m",
    "parse_ml25m",
    "parse_netflix",
    "dataset_names",
]

DEFAULT_ROOT = Path(os.environ.get("MFX_DATA_ROOT", "~/.cache/mfx")).expanduser()

# bumped whenever synthetic generation OR parsing/relabeling changes, so
# stale caches never leak into new runs (the cache filename carries this
# version). v3: items relabeled by descending frequency on parse.
# v4: benchmark-shape synthetics round ratings to their real star scale
# (ML-25M half-stars, ML-100K/1M + Netflix whole stars) — faithful to the
# real data's label quantization and lossless under the int4 dense
# rating stream.
# v5: parsers keep the source timestamp column (RatingsCOO.timestamp) —
# a v4 real-data cache would silently lack timestamps and block the
# chronological protocols forever. Synthetic v5 content equals v4 (the
# generator is unchanged and emits no time column).
# v6: (a) USERS are relabeled by descending activity at parse (dense
# user 0 = most active), mirroring the item relabel, so rating mass
# concentrates into hot×hot strata — the 2-D occupancy lever of the
# dense blocked phase (VERDICT r3 #1); (b) benchmark-shape synthetics
# add user-activity skew (Zipf s=0.6 — real MovieLens/Netflix users are
# heavy-tailed; the old iid-uniform users made the user axis
# unrealistically flat and the occupancy lever invisible).
GENERATOR_VERSION = 6


def _densify(
    raw_u: np.ndarray,
    raw_i: np.ndarray,
    ratings: np.ndarray,
    timestamps: np.ndarray | None = None,
) -> RatingsCOO:
    """Remap arbitrary raw ids to dense contiguous ids.

    BOTH axes are relabeled by DESCENDING rating frequency (dense id 0 =
    the most-rated item / most-active user, ties broken by raw-id
    order), so the Zipf head of real data clusters into the first
    windows of each axis and rating mass concentrates into hot×hot
    strata — the layout the dense-stratum fast path requires, and the
    2-D occupancy engineering that cuts streamed bytes/rating in the
    full-span dense phase (VERDICT round-1 missing #5, round-3 #1; the
    seeded synthetic generators are popularity-sorted by construction).
    The new-id → raw-id maps ride along as ``coo.item_raw_ids`` /
    ``coo.user_raw_ids``.
    """

    def _relabel(raw):
        uniq, inv = np.unique(raw, return_inverse=True)
        counts = np.bincount(inv, minlength=len(uniq))
        order = np.argsort(-counts, kind="stable")  # new id 0 = most frequent
        rank_of = np.empty_like(order)
        rank_of[order] = np.arange(len(order))
        return rank_of[inv].astype(np.int32), uniq[order].astype(np.int64)

    u, user_raw = _relabel(raw_u)
    i, item_raw = _relabel(raw_i)
    return RatingsCOO(
        u,
        i,
        ratings.astype(np.float32),
        num_users=len(user_raw),
        num_items=len(item_raw),
        item_raw_ids=item_raw,
        user_raw_ids=user_raw,
        timestamp=timestamps,
    )


def parse_triples(path, sep: str | None = None, skip_header: bool = False) -> RatingsCOO:
    """Generic ``user<sep>item<sep>rating[<sep>timestamp]`` parser.

    A 4th column, when present on every row, is kept as the per-rating
    timestamp (``RatingsCOO.timestamp``, int64 dataset-native units) —
    the chronological split protocols need it; rows without it yield a
    timestamp-free COO."""
    rows_u, rows_i, rows_r, rows_t = [], [], [], []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        if skip_header:
            next(f, None)
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(sep) if sep != "::" else line.split("::")
            rows_u.append(int(parts[0]))
            rows_i.append(int(parts[1]))
            rows_r.append(float(parts[2]))
            if rows_t is not None and len(parts) > 3:
                rows_t.append(int(float(parts[3])))
            else:
                rows_t = None
    return _densify(
        np.asarray(rows_u, np.int64),
        np.asarray(rows_i, np.int64),
        np.asarray(rows_r, np.float32),
        None if rows_t is None else np.asarray(rows_t, np.int64),
    )


def parse_ml100k(root) -> RatingsCOO:
    """MovieLens-100K ``u.data``: ``user \t item \t rating \t ts``."""
    return parse_triples(Path(root) / "u.data", sep="\t")


def parse_ml1m(root) -> RatingsCOO:
    """MovieLens-1M ``ratings.dat``: ``user::item::rating::ts``."""
    return parse_triples(Path(root) / "ratings.dat", sep="::")


def parse_ml25m(root) -> RatingsCOO:
    """MovieLens-25M ``ratings.csv``: ``userId,movieId,rating,timestamp``."""
    path = Path(root) / "ratings.csv"
    data = np.loadtxt(path, delimiter=",", skiprows=1, usecols=(0, 1, 2, 3))
    return _densify(
        data[:, 0].astype(np.int64),
        data[:, 1].astype(np.int64),
        data[:, 2],
        # unix seconds ≈ 1.7e9 — exact in float64, exact back to int64
        data[:, 3].astype(np.int64),
    )


def parse_netflix(root) -> RatingsCOO:
    """Netflix Prize ``training_set/mv_*.txt`` directory layout.

    Each file: first line ``movieid:`` then ``user,rating,date`` lines.
    """
    root = Path(root)
    files = sorted((root / "training_set").glob("mv_*.txt"))
    if not files:
        files = sorted(root.glob("mv_*.txt"))
    rows_u, rows_i, rows_r, rows_t = [], [], [], []
    for fp in files:
        with open(fp, "r") as f:
            movie = int(f.readline().strip().rstrip(":"))
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 2:
                    continue
                rows_u.append(int(parts[0]))
                rows_i.append(movie)
                rows_r.append(float(parts[1]))
                if rows_t is not None and len(parts) > 2:
                    # 'YYYY-MM-DD' -> days since unix epoch (ordering is
                    # all the chronological protocols use)
                    rows_t.append(
                        int(np.datetime64(parts[2], "D").astype(np.int64))
                    )
                else:
                    rows_t = None
    return _densify(
        np.asarray(rows_u, np.int64),
        np.asarray(rows_i, np.int64),
        np.asarray(rows_r, np.float32),
        None if rows_t is None else np.asarray(rows_t, np.int64),
    )


# ---- registry ---------------------------------------------------------------

# name -> (raw subdir, parser, synthetic fallback). Benchmark-shape
# fallbacks carry user-activity skew (user_zipf_s=0.6, generator v6) —
# real MovieLens/Netflix users are heavy-tailed, and the flat iid users
# of v4/v5 hid the 2-D occupancy structure the dense phase exploits.
def _synth(shape, rank, seed, star_step=None, user_zipf_s=0.6) -> Callable[[], RatingsCOO]:
    return lambda: syn.make_synthetic(
        *shape, rank=rank, seed=seed, star_step=star_step,
        user_zipf_s=user_zipf_s,
    )


_REGISTRY: dict[str, tuple[str, Callable, Callable[[], RatingsCOO]]] = {
    "ml-100k": ("ml-100k", parse_ml100k,
                _synth(syn.ML100K_SHAPE, 16, 100, star_step=1.0)),
    "ml-1m": ("ml-1m", parse_ml1m,
              _synth(syn.ML1M_SHAPE, 32, 101, star_step=1.0)),
    "ml-25m": ("ml-25m", parse_ml25m,
               _synth(syn.ML25M_SHAPE, 64, 102, star_step=0.5)),
    "netflix": ("netflix", parse_netflix,
                _synth(syn.NETFLIX_SHAPE, 128, 103, star_step=1.0)),
    "billion-implicit": (
        "billion-implicit",
        None,
        lambda: syn.make_implicit_synthetic(*syn.BILLION_SHAPE, rank=64, seed=104),
    ),
    # small synthetic smoke datasets for tests / CI
    "synthetic-small": (
        "synthetic-small",
        None,
        lambda: syn.make_synthetic(256, 512, 20_000, rank=8, seed=7),
    ),
    "synthetic-small-implicit": (
        "synthetic-small-implicit",
        None,
        lambda: syn.make_implicit_synthetic(256, 128, 8_000, rank=8, seed=9),
    ),
}


def dataset_names() -> list[str]:
    return sorted(_REGISTRY)


def load_dataset(
    name: str,
    root: os.PathLike | str | None = None,
    cache: bool = True,
    allow_synthetic: bool = True,
) -> RatingsCOO:
    """Load a named dataset, preferring (in order): real-data npz cache,
    raw files, synthetic npz cache, seeded synthetic fallback of the same
    shape.

    Synthetic fallbacks are cached under a *distinct* filename
    (``{name}.v{V}.synthetic.npz``) and flagged ``coo.synthetic = True``,
    so real MovieLens/Netflix data dropped into ``root`` later is picked up
    immediately instead of being shadowed by a stale synthetic cache, and
    downstream bench/driver output can report the data's provenance.
    """
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; known: {dataset_names()}")
    subdir, parser, fallback = _REGISTRY[name]
    root = Path(root) if root is not None else DEFAULT_ROOT
    real_cache = root / f"{name}.v{GENERATOR_VERSION}.npz"
    syn_cache = root / f"{name}.v{GENERATOR_VERSION}.synthetic.npz"

    if cache and real_cache.exists():
        coo = RatingsCOO.load_npz(real_cache)
        if not coo.synthetic:
            return coo
        # a pre-provenance cache written from a synthetic fallback under
        # the real dataset's name: migrate it so raw data is never shadowed
        try:
            real_cache.rename(syn_cache)
        except OSError:
            pass

    raw_dir = root / subdir
    if parser is not None and raw_dir.exists():
        coo = parser(raw_dir)
        if cache:
            _write_cache(coo, root, real_cache)
        return coo

    if not allow_synthetic:
        raise FileNotFoundError(f"no raw data at {raw_dir} and synthetic disabled")
    if cache and syn_cache.exists():
        coo = RatingsCOO.load_npz(syn_cache)
        coo.synthetic = True  # pre-provenance caches lack the flag
        return coo
    import warnings

    warnings.warn(
        f"dataset {name!r}: no raw files under {raw_dir}; using the seeded "
        "SYNTHETIC fallback of the same shape (results will be flagged "
        "synthetic=true)",
        stacklevel=2,
    )
    coo = fallback()
    if cache:
        _write_cache(coo, root, syn_cache)
    return coo


def _write_cache(coo: RatingsCOO, root: Path, path: Path) -> None:
    try:
        root.mkdir(parents=True, exist_ok=True)
        coo.save_npz(path)
    except OSError:
        pass  # cache is best-effort
