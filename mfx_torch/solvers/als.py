"""ALS solver and the Gram engine that ALS, iALS and NMF share, the
counterpart of ``mfx/solvers/als.py``.

Each half-sweep solves one factor table against the other by batched
rank-d normal equations,

    A_u = Σ_{i∈Ω(u)} q̃_i q̃_iᵀ + λ·max(|Ω(u)|, 1)·I,   b_u = Σ r̃_ui q̃_i,
    p̃_u = A_u⁻¹ b_u

(ALS-WR: the regularizer scales with the row's degree, the stationary
point of the SGD objective; with biases q̃ = [q, 1] and r̃ = r − μ − b_i,
so the row's bias is one more least-squares coordinate). A row with no
ratings keeps its old factors.

The Gram accumulation is the reference's degree-bucketed batched product:
the ratings are sorted by target row once a run, each row's run is cut
into pieces of at most ``BUCKET_CAPS[-1]`` ratings, pieces are bucketed
by the smallest cap that holds them, and each chunk of a bucket computes
``A_piece = Q̃ᵀ_piece Q̃_piece`` with one ``torch.bmm``. The reference
computes the whole engine outside any Pallas kernel (gathers, einsums, a
scatter-add, ``jax.scipy.linalg.cholesky`` / ``cho_solve``), so stock
torch ops are its port:

- gathers and ``torch.bmm`` in true f32: the Grams and solves are f32 in
  the reference, and the card's parity tolerance assumes it, so
  ``torch.backends.cuda.matmul.allow_tf32`` stays off (its default);
- the partial Grams scatter-add into the range's accumulator through
  ``kernels.packing.row_add``: a hot row is cut into pieces and every pad
  piece targets segment ``nseg - 1``, so rows repeat within a chunk, and
  ``index_add_`` on CUDA would sum them with float atomics, in an order
  that changes from run to run; ``row_add`` sorts there
  (``index_put_(accumulate=True)``), so a run repeated from the same
  tables gives the same bits;
- one batched Cholesky a row range: ``torch.linalg.cholesky_ex`` without
  its error check (``torch.linalg.cholesky`` reads ``info`` back to the
  host on every call), then ``torch.cholesky_solve``. λ·I makes every
  system positive definite; a NaN in the tables would come through to
  the caller rather than raise, as the reference's solve lets it.

The plan never changes across sweeps: :func:`device_chunks` packs each
side's padded chunks onto the device once a run, in the reference's chunk
order (which fixes the order in which the partial Grams are summed), so a
half-sweep is launches only, with no host sync.

The bucket plans (:func:`build_bucket_plan`,
:func:`bucket_plan_from_row_starts`) are the port's own NumPy copies and
equal the reference's exactly.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch.profiler import record_function

from mfx_torch.config import ALSConfig
from mfx_torch.data.coo import RatingsCOO
from mfx_torch.kernels.packing import row_add
from mfx_torch.models.mf import MFModel

__all__ = [
    "BUCKET_CAPS", "BUCKET_CELLS", "GRAM_ROWCHUNK_BUDGET",
    "gram_rowchunk", "build_bucket_plan", "bucket_plan_from_row_starts",
    "iter_bucket_chunks", "device_chunks", "sort_side", "sort_sides",
    "gram_accumulate",
    "accumulate_range", "als_half_sweep", "train_sweeps_als", "SPANS",
]

# Degree ladder for piece bucketing. caps[-1] also caps the piece length
# (hot rows split; Gram partial sums add exactly).
BUCKET_CAPS = (32, 128, 512, 2048)

# Gather-chunk budget: nb * cap cells per chunk. At rank 128 (d = 129)
# this is ~135 MB for the (nb, cap, d) gathered-factor block.
BUCKET_CELLS = 1 << 18

# Rows per batched-Cholesky solve, clamped so the (rows, d, d) Gram
# accumulator stays bounded (~70 MB at d = 129).
GRAM_ROWCHUNK_BUDGET = 128 * 1024 * 1024


def _pow2_at_most(n: int, cap: int) -> int:
    n = max(1, min(n, cap))
    return 1 << (n.bit_length() - 1)


def _pow2_at_least(n: int, lo: int = 256) -> int:
    n = int(max(n, lo))  # int(): numpy ints lack bit_length
    return 1 << (n - 1).bit_length()


def gram_rowchunk(d: int, row_chunk: int) -> int:
    return _pow2_at_most(GRAM_ROWCHUNK_BUDGET // (d * d * 4), row_chunk)


def build_bucket_plan(coo_rows_sorted: np.ndarray, num_rows: int):
    """Once a run a side: cut each row's sorted run into pieces and bucket
    them by degree. Returns (plan, row_starts); plan maps cap ->
    (piece_row, piece_start, piece_len), each sorted by row."""
    row_starts = np.searchsorted(
        coo_rows_sorted, np.arange(num_rows + 1, dtype=np.int64)
    )
    return bucket_plan_from_row_starts(row_starts), row_starts


def bucket_plan_from_row_starts(row_starts: np.ndarray):
    """The piece and bucket construction from each row's [start, end) in
    the sorted rating arrays alone."""
    num_rows = len(row_starts) - 1
    degs = np.diff(row_starts)
    capmax = BUCKET_CAPS[-1]
    npieces = -(-degs // capmax)  # 0 pieces for empty rows
    total = int(npieces.sum())
    prow = np.repeat(np.arange(num_rows, dtype=np.int64), npieces)
    first = np.cumsum(npieces) - npieces
    pidx = np.arange(total, dtype=np.int64) - np.repeat(first, npieces)
    pstart = row_starts[prow] + pidx * capmax
    plen = np.minimum(degs[prow] - pidx * capmax, capmax)
    which = np.searchsorted(BUCKET_CAPS, plen)
    plan = {}
    for ci, cap in enumerate(BUCKET_CAPS):
        m = which == ci
        plan[cap] = (
            prow[m].astype(np.int32),
            pstart[m].astype(np.int64),
            plen[m].astype(np.int32),
        )
    return plan


def iter_bucket_chunks(buckets, r0: int, r1: int, nseg: int):
    """Yield ``(cap, rows_rel, starts, lens)`` padded piece chunks (NumPy)
    for target rows [r0, r1), in the reference's order: bucket by bucket,
    ``BUCKET_CELLS // cap`` pieces a chunk, padded to a power of two (at
    least 256). Pad slots target the spare segment ``nseg - 1`` with zero
    length."""
    for cap, (prow, pstart, plen) in buckets.items():
        s, e = np.searchsorted(prow, [r0, r1])
        if e == s:
            continue
        nb_chunk = max(1, BUCKET_CELLS // cap)
        for c0 in range(s, e, nb_chunk):
            c1 = min(c0 + nb_chunk, e)
            nb = _pow2_at_least(c1 - c0)
            rows_rel = np.full(nb, nseg - 1, np.int32)
            starts = np.zeros(nb, pstart.dtype)
            lens = np.zeros(nb, np.int32)
            rows_rel[: c1 - c0] = prow[c0:c1] - r0
            starts[: c1 - c0] = pstart[c0:c1]
            lens[: c1 - c0] = plen[c0:c1]
            yield cap, rows_rel, starts, lens


def _to_device(chunks, device):
    """NumPy chunks as device tensors, through one copy of each field:
    ``[(cap, rows_rel (int64), starts (int64), lens (f32)), ...]``."""
    if not chunks:
        return []
    sizes = [c[1].shape[0] for c in chunks]
    rows = torch.as_tensor(np.concatenate([c[1] for c in chunks]).astype(
        np.int64)).to(device)
    starts = torch.as_tensor(np.concatenate([c[2] for c in chunks]).astype(
        np.int64)).to(device)
    lens = torch.as_tensor(np.concatenate([c[3] for c in chunks]).astype(
        np.float32)).to(device)
    out, o = [], 0
    for (cap, *_), nb in zip(chunks, sizes):
        out.append((cap, rows[o:o + nb], starts[o:o + nb], lens[o:o + nb]))
        o += nb
    return out


def device_chunks(buckets, num_rows: int, row_chunk: int, device):
    """Every row range's padded chunks of one side on ``device``, built
    once a run: ``[(r0, r1, chunks), ...]`` with ``row_chunk`` rows a
    range, each range's chunks as :func:`iter_bucket_chunks` yields them
    (the reference's order). One host-to-device copy a field for the
    whole side."""
    ranges, flat = [], []
    for r0 in range(0, num_rows, row_chunk):
        r1 = min(r0 + row_chunk, num_rows)
        chunks = list(iter_bucket_chunks(buckets, r0, r1, r1 - r0 + 1))
        ranges.append((r0, r1, len(chunks)))
        flat.extend(chunks)
    flat = _to_device(flat, device)
    out, o = [], 0
    for r0, r1, n in ranges:
        out.append((r0, r1, flat[o:o + n]))
        o += n
    return out


def sort_side(rows, cols, vals, num_rows: int, device):
    """The ratings sorted stably by ``rows`` on ``device`` (the reference's
    ``np.argsort(kind='stable')``, which the stable device sort equals)
    and the side's bucket plan: ``(cols, vals, (plan, row_starts))``. The
    row starts come from a device bincount, the only host copy is the
    ``num_rows + 1`` starts."""
    r = torch.as_tensor(np.asarray(rows)).to(device, torch.int64)
    order = torch.sort(r, stable=True).indices
    c = torch.as_tensor(np.asarray(cols)).to(device)[order]
    v = torch.as_tensor(np.asarray(vals, np.float32)).to(device)[order]
    counts = torch.bincount(r, minlength=num_rows)
    del r, order
    starts = np.zeros(num_rows + 1, np.int64)
    starts[1:] = np.cumsum(counts.cpu().numpy())
    return c, v, (bucket_plan_from_row_starts(starts), starts)


def sort_sides(model: MFModel, train: RatingsCOO, row_chunk: int):
    """Both sides of a run on the model's device, once a run (degrees do
    not change across sweeps): by user for the P step and by item for the
    Q step, each ``(cols, vals, plan, chunks)`` (:func:`sort_side`,
    :func:`device_chunks` with ``row_chunk`` rows a range)."""
    dev = model.device
    out = []
    for rows, cols, n in ((train.user, train.item, model.num_users),
                          (train.item, train.user, model.num_items)):
        c, v, plan = sort_side(rows, cols, train.rating, n, dev)
        out.append((c, v, plan, device_chunks(plan[0], n, row_chunk, dev)))
    return out


# The torch.profiler spans of a half-sweep's parts, over its chunks and row
# ranges: gather + Gram, the scatter of the partial Grams, the solve (or
# NMF's update). Inert unless a profiler runs; ``chip_smoke.py`` reads
# the card's time in each from a trace.
SPANS = ("gram.gather_gram", "gram.scatter", "gram.solve")


def _gram_chunk(Fg, resid_all, cols, rows_rel, starts, lens, A, b, cnt, cap):
    """One chunk of the accumulation: ``Fg`` is the gather table (the
    fixed factors, with the ones column when biased), ``resid_all`` the
    per-rating target r̃ (sorted like ``cols``)."""
    with record_function(SPANS[0]):
        nb = rows_rel.shape[0]
        d = Fg.shape[1]
        lane = torch.arange(cap, dtype=starts.dtype, device=starts.device)
        idx = (starts[:, None] + lane[None, :]).clamp_(0, cols.shape[0] - 1)
        mask = (lane[None, :] < lens[:, None]).to(Fg.dtype)
        q = Fg[cols[idx].reshape(-1)].reshape(nb, cap, d)
        q.mul_(mask[:, :, None])
        A_p = torch.bmm(q.transpose(1, 2), q)
        b_p = torch.bmm((resid_all[idx] * mask)[:, None, :], q)[:, 0, :]
    with record_function(SPANS[1]):
        row_add(A, rows_rel, A_p)
        row_add(b, rows_rel, b_p)
        row_add(cnt, rows_rel, lens)


def _gather_table(F_other, use_bias):
    if not use_bias:
        return F_other
    return torch.cat([F_other, torch.ones(F_other.shape[0], 1,
                                          dtype=F_other.dtype,
                                          device=F_other.device)], dim=1)


def _targets(vals, cols, mu, b_other, use_bias):
    """r̃ of every rating: ``v - mu - b_other[c]`` (biased) or ``v - mu``,
    in the reference's f32 order."""
    resid = vals - mu  # a Python scalar: no host-to-device copy
    if use_bias:
        resid = resid - b_other[cols]
    return resid


def gram_accumulate(F_other, b_other, mu, cols, vals, rows_rel, starts,
                    lens, A, b, cnt, *, cap: int, use_bias: bool):
    """One chunk of normal-equation accumulation into ``A`` (nseg, d, d),
    ``b`` (nseg, d) and ``cnt`` (nseg,), in place; returns them. ``cols`` /
    ``vals`` are sorted by target row; pieces are ``rows_rel`` (range-local
    target row, pads ``nseg - 1``), ``starts`` and ``lens`` (pads 0)."""
    dev = A.device
    rows_rel = torch.as_tensor(rows_rel).to(dev, torch.int64)
    starts = torch.as_tensor(starts).to(dev, torch.int64)
    lens = torch.as_tensor(lens).to(dev, A.dtype)
    _gram_chunk(_gather_table(F_other, use_bias),
                _targets(vals, cols, mu, b_other, use_bias), cols, rows_rel,
                starts, lens, A, b, cnt, cap)
    return A, b, cnt


def _solve_gram(A, b, cnt, old, reg):
    """ALS-WR solve of a row range: λ_row = reg · max(degree, 1), the
    stationary point of the per-occurrence SGD objective (the configs[3]
    ALS cross-check of SGD compares the same objective). Rows with no
    ratings keep ``old``. ``A`` is consumed (its diagonal is
    regularized in place)."""
    with record_function(SPANS[2]):
        lam = reg * cnt.clamp_min(1.0)
        A.diagonal(dim1=-2, dim2=-1).add_(lam[:, None])
        # no info check (it would read back to the host): λ·I keeps every
        # system positive definite, and a NaN comes through to the caller
        # rather than raising, as the reference's cho_solve lets it
        L, _ = torch.linalg.cholesky_ex(A)
        sol = torch.cholesky_solve(b[..., None], L)[..., 0]
        return torch.where(cnt[:, None] > 0, sol, old)


def accumulate_range(Fg, resid, cols, chunks, rows, dtype):
    """Normal-equation accumulators (A, b, cnt) of one range of ``rows``
    target rows: the degree-bucketed gather / bmm loop shared by the ALS
    solve and the NMF update, over ``chunks`` (the range's entry of
    :func:`device_chunks`). ``Fg`` is the gather table, ``resid`` every
    rating's r̃ (sorted like ``cols``)."""
    nseg = rows + 1  # +1: pad pieces target the spare last segment
    d = Fg.shape[1]
    A = torch.zeros((nseg, d, d), dtype=dtype, device=Fg.device)
    b = torch.zeros((nseg, d), dtype=dtype, device=Fg.device)
    cnt = torch.zeros((nseg,), dtype=dtype, device=Fg.device)
    for cap, rows_rel, starts, lens in chunks:
        _gram_chunk(Fg, resid, cols, rows_rel, starts, lens, A, b, cnt, cap)
    return A[:rows], b[:rows], cnt[:rows]


def _side_inputs(F_target, coo_rows, coo_cols, coo_vals, row_chunk, plan,
                 chunks):
    """The half-sweep's device inputs: cols, vals and the device chunks
    (built here unless the caller built them once for the run)."""
    num_rows = F_target.shape[0]
    dev = F_target.device
    if plan is None:
        plan = build_bucket_plan(np.asarray(coo_rows), num_rows)
    cols = torch.as_tensor(coo_cols).to(dev)
    vals = torch.as_tensor(coo_vals).to(dev, torch.float32)
    if chunks is None:
        chunks = device_chunks(plan[0], num_rows, row_chunk, dev)
    return cols, vals, chunks


def als_half_sweep(
    F_target,  # (rows, k) table being solved
    b_target,  # (rows,)
    F_other,
    b_other,
    mu,
    coo_rows,  # target-side id per rating (sorted by this)
    coo_cols,  # fixed-side id per rating (tensor or NumPy)
    coo_vals,
    reg: float,
    use_bias: bool,
    row_chunk: int = 8192,
    plan=None,
    chunks=None,
):
    """Solve one table against the other on the tables' device. Ratings
    are sorted by ``coo_rows``; ``plan`` is the matching
    :func:`build_bucket_plan` result and ``chunks`` its
    :func:`device_chunks` (each built here when absent). Returns
    ``(F, b)``: the new factors and biases (``b_target`` when unbiased)."""
    num_rows, k = F_target.shape
    d = k + 1 if use_bias else k
    row_chunk = gram_rowchunk(d, row_chunk)
    cols, vals, chunks = _side_inputs(F_target, coo_rows, coo_cols, coo_vals,
                                      row_chunk, plan, chunks)
    f = F_target.dtype
    Fg = _gather_table(F_other, use_bias)
    resid = _targets(vals, cols, mu, b_other, use_bias)
    old_all = (torch.cat([F_target, b_target[:, None]], dim=1) if use_bias
               else F_target)
    out = torch.empty((num_rows, d), dtype=f, device=F_target.device)
    for r0, r1, ch in chunks:
        A, b, cnt = accumulate_range(Fg, resid, cols, ch, r1 - r0, f)
        out[r0:r1] = _solve_gram(A, b, cnt, old_all[r0:r1], reg)
    if use_bias:
        return out[:, :k].contiguous(), out[:, k].contiguous()
    return out, b_target


def train_sweeps_als(
    model: MFModel,
    train: RatingsCOO,
    cfg: ALSConfig,
    use_bias: bool = True,
    row_chunk: int | None = None,
    start_sweep: int = 0,
) -> Iterator[tuple[int, MFModel]]:
    """Alternate P and Q solves on the model's device; yields ``(sweep,
    model)`` after each full sweep, from ``start_sweep`` (a run resumed
    from the tables an unbroken run had after sweep ``start_sweep - 1``
    repeats it bit for bit: nothing else carries over)."""
    row_chunk = row_chunk or cfg.user_chunk
    d = model.rank + 1 if use_bias else model.rank
    (uc, uv, up, uch), (ic, iv, ip, ich) = sort_sides(
        model, train, gram_rowchunk(d, row_chunk))
    for sweep in range(start_sweep, cfg.sweeps):
        P, bu = als_half_sweep(
            model.P, model.bu, model.Q, model.bi, model.mu, None, uc, uv,
            cfg.reg, use_bias, row_chunk=row_chunk, plan=up, chunks=uch)
        model = MFModel(P, model.Q, bu, model.bi, model.mu)
        Q, bi = als_half_sweep(
            model.Q, model.bi, model.P, model.bu, model.mu, None, ic, iv,
            cfg.reg, use_bias, row_chunk=row_chunk, plan=ip, chunks=ich)
        model = MFModel(model.P, Q, model.bu, bi, model.mu)
        yield sweep, model
