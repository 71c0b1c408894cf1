"""Per-tile top-``depth`` serving candidates: wrapper of
``csrc/tile_topk.cu`` and its plain PyTorch version.

Replaces ``mfx/kernels/serve_pallas.py::_kernel`` (``tile_topk``,
``tile_topk2``). For user rows ``P_aug = [p, 1, 0…]`` and the augmented
catalog ``Q_aug = [q, b_i, 0…]`` (pad rows carry bias -1e30), each catalog
tile of ``tile`` items yields its ``depth`` best ``(score, lane)`` pairs
per user row, value descending and, on equal values, lowest lane first.
Only those candidates leave the kernel: the ``(B, catalog)`` score block
is never written.

The augmented width is ``rank + 1`` padded to a multiple of 8
(:func:`aug_width`), not the TPU's 128 lanes; the reference's
``rank < 128`` limit stays (``AUG_LANES``). Scores are true f32: the
plain version's matmul runs with TF32 off, the kernel with f32 FMA.

On CUDA tensors :func:`tile_topk` launches the kernel (or raises); on CPU
tensors it runs :func:`tile_topk_plain`. Nothing falls back.
"""

from __future__ import annotations

import contextlib

import torch

from mfx_torch.kernels import _build

__all__ = ["tile_topk", "tile_topk2", "tile_topk_plain", "aug_width",
           "matmul_f32", "AUG_LANES"]

AUG_LANES = 128  # widest augmented row: rank + bias lane < 128 + 1
MAX_DEPTH = 32   # the kernel's candidate lists (csrc/tile_topk.cu)
MAX_TILE = 2048  # the kernel's tiles: 128-row chunks, at most 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def aug_width(rank: int) -> int:
    """Width of the augmented rows: ``rank + 1`` padded to a multiple of 8."""
    return -(-(rank + 1) // 8) * 8


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ bᵀ`` in true f32 (TF32 off), the reference's
    ``Precision.HIGHEST``."""
    with _no_tf32():
        return a.float() @ b.float().T


def _validate(P_aug, Q_aug, tile, depth, sb):
    if P_aug.dim() != 2 or Q_aug.dim() != 2:
        raise ValueError("augmented tables must be 2-D")
    ipad, lanes = Q_aug.shape
    if P_aug.shape[1] != lanes or lanes % 8 or lanes > AUG_LANES:
        raise ValueError(
            f"augmented tables must share a width that is a multiple of 8 "
            f"and at most {AUG_LANES} lanes, got {P_aug.shape[1]} and {lanes}"
        )
    if ipad % tile != 0:
        raise ValueError(f"catalog pad {ipad} not a multiple of tile {tile}")
    if not 1 <= depth <= tile:
        raise ValueError(f"depth must be in [1, tile={tile}], got {depth}")
    quant = Q_aug.dtype == torch.int8
    if quant and (sb is None or tuple(sb.shape) != (ipad // tile, 2, tile)):
        raise ValueError(
            "int8 Q_aug needs sb=(n_tiles, 2, tile) f32 scales+biases"
        )
    if not quant and sb is not None:
        raise ValueError("sb is only for int8 catalogs")
    want_p = torch.bfloat16 if Q_aug.dtype == torch.bfloat16 else torch.float32
    if Q_aug.dtype not in _DTYPE_CODE or P_aug.dtype != want_p:
        raise TypeError(
            f"tile_topk: Q_aug {Q_aug.dtype} with P_aug {P_aug.dtype}; takes "
            "f32/f32, bf16/bf16 or int8 with f32 P_aug"
        )
    for name, x in (("Q_aug", Q_aug), ("sb", sb)):
        if x is not None and x.device != P_aug.device:
            raise ValueError(
                f"tile_topk: {name} is on {x.device}, P_aug on {P_aug.device}"
            )
    if sb is not None and sb.dtype != torch.float32:
        raise TypeError(f"tile_topk: sb must be float32, got {sb.dtype}")


def tile_topk_plain(P_aug, Q_aug, tile: int = 1024, depth: int = 2, sb=None):
    """Plain PyTorch version of :func:`tile_topk`: the full score block in
    true f32, then a stable descending sort of each tile (equal values keep
    the lower lane first)."""
    _validate(P_aug, Q_aug, tile, depth, sb)
    scores = matmul_f32(P_aug, Q_aug)  # (B, ipad)
    if sb is not None:
        scores = scores * sb[:, 0, :].reshape(1, -1) + sb[:, 1, :].reshape(1, -1)
    B, ipad = scores.shape
    vals, lanes = torch.sort(scores.view(B, ipad // tile, tile), dim=2,
                             descending=True, stable=True)
    out = []
    for j in range(depth):
        out += [vals[:, :, j].contiguous(),
                lanes[:, :, j].to(torch.int32).contiguous()]
    return tuple(out)


def tile_topk(P_aug, Q_aug, tile: int = 1024, depth: int = 2, sb=None):
    """Per-tile top-``depth`` candidates of ``P_aug @ Q_augᵀ``.

    P_aug: (B, K) user rows ``[p, 1, 0…]``; Q_aug: (I_pad, K) catalog
    ``[q, b_i, 0…]``, I_pad a multiple of ``tile``, pad rows with bias
    -1e30. K is :func:`aug_width` of the rank. Dtypes: f32 tables; bf16
    tables (both bf16, f32 products); or an int8 ``Q_aug`` (bias lane 0)
    with f32 ``P_aug`` and ``sb`` (n_tiles, 2, tile) f32, row 0 the
    per-item dequant scale and row 1 the item bias (pad items: scale 0,
    bias -1e30), scoring ``(P_aug·q8) * scale + bias``.

    Returns ``depth`` pairs ``(m_j, a_j)`` flattened, each (B, n_tiles):
    the tile's j-th best f32 score and its int32 lane (global item =
    t*tile + lane)."""
    _validate(P_aug, Q_aug, tile, depth, sb)
    dev = P_aug.device
    if dev.type == "cpu":
        return tile_topk_plain(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
    if dev.type != "cuda":
        raise ValueError(f"tile_topk: no kernel for device {dev}")
    if depth > MAX_DEPTH or tile % 128 or tile > MAX_TILE:
        raise NotImplementedError(
            f"tile_topk kernel takes depth <= {MAX_DEPTH} and tile a multiple "
            f"of 128 up to {MAX_TILE}, got depth={depth} tile={tile} "
            "(ROADMAP Queue 2 item 8)"
        )
    return _launch(P_aug, Q_aug, tile, depth, sb)


def _launch(P_aug, Q_aug, tile, depth, sb, users_per_block=0):
    """:func:`tile_topk`'s kernel on CUDA tensors already validated.
    ``users_per_block`` 16 or 128 holds the kernel to one of its two block
    forms (``measure_topk forms`` times both); 0, as :func:`tile_topk`
    passes, lets the launch choose."""
    tensors = [P_aug, Q_aug] + ([sb] if sb is not None else [])
    if any(not x.is_contiguous() or x.data_ptr() % 16 for x in tensors):
        raise ValueError("tile_topk: tables must be contiguous and 16-byte "
                         "aligned")
    dev = P_aug.device
    B, K = P_aug.shape
    ipad = Q_aug.shape[0]
    tn = ipad // tile
    m = torch.empty(depth, B, tn, dtype=torch.float32, device=dev)
    a = torch.empty(depth, B, tn, dtype=torch.int32, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.mfx_tile_topk(
        P_aug.data_ptr(), Q_aug.data_ptr(),
        sb.data_ptr() if sb is not None else None, m.data_ptr(),
        a.data_ptr(), B, ipad, K, tile, depth, _DTYPE_CODE[Q_aug.dtype],
        users_per_block, stream,
    ), "tile_topk")
    tile_topk.launches += 1
    return tuple(x for j in range(depth) for x in (m[j], a[j]))


tile_topk.launches = 0


def tile_topk2(P_aug, Q_aug, tile: int = 1024):
    """Per-tile top-2 (the serving default); see :func:`tile_topk`."""
    return tile_topk(P_aug, Q_aug, tile=tile, depth=2)
