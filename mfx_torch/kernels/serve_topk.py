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
tensors it runs :func:`tile_topk_plain`. Nothing falls back. The kernel
has two forms: its lists in registers for ``depth <= 32`` on tiles of at
most 2,048 items, and the deep form for any other depth and tile that is
a multiple of 128 (each user's best so far in a pool in shared or device
memory, ``csrc/tile_topk.cu``). ``tile_topk.launches`` counts the first
form's launches, ``tile_topk.deep_launches`` the deep form's.

The deep form's launch is planned here (:func:`deep_split`,
:func:`deep_pieces`): where the tiles times the user blocks do not fill
the card, each tile's chunks are cut into pieces, each piece keeps its own
top-``depth`` list, and a second launch merges them in piece order
(:func:`merge_pieces_plain` is that merge in plain PyTorch).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from mfx_torch.kernels import _build

__all__ = ["tile_topk", "tile_topk2", "tile_topk_plain", "aug_width",
           "matmul_f32", "AUG_LANES", "deep_split", "deep_pieces",
           "merge_pieces_plain"]

AUG_LANES = 128  # widest augmented row: rank + bias lane < 128 + 1
# the register-list form's limits (csrc/tile_topk.cu); beyond them the
# deep form runs
MAX_DEPTH = 32
MAX_TILE = 2048
CHUNK = 128  # catalog rows a chunk of the kernel
MAX_PIECES = 32  # pieces a tile of the deep form (one warp lane each)
_NOLANE = 2 ** 31 - 1  # an empty slot's lane in a piece's list
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
    if tile % 128:
        raise ValueError(
            f"tile_topk kernel takes tiles that are a multiple of 128, got "
            f"{tile}"
        )
    if depth > MAX_DEPTH or tile > MAX_TILE:
        return _launch_deep(P_aug, Q_aug, tile, depth, sb)
    return _launch(P_aug, Q_aug, tile, depth, sb)


def _outputs(P_aug, Q_aug, tile, depth, sb):
    """The (depth, B, n_tiles) value and lane outputs of a launch, after
    the layout checks the kernel needs."""
    tensors = [P_aug, Q_aug] + ([sb] if sb is not None else [])
    if any(not x.is_contiguous() or x.data_ptr() % 16 for x in tensors):
        raise ValueError("tile_topk: tables must be contiguous and 16-byte "
                         "aligned")
    shape = (depth, P_aug.shape[0], Q_aug.shape[0] // tile)
    return (torch.empty(shape, dtype=torch.float32, device=P_aug.device),
            torch.empty(shape, dtype=torch.int32, device=P_aug.device))


def _pairs(m, a, depth):
    """The (depth, B, n_tiles) outputs as ``depth`` (value, lane) pairs:
    views made by two ``unbind`` calls, not 2 x depth indexing ops (at
    depth 64 those took longer on the host than the kernel on the card)."""
    return tuple(x for pair in zip(m.unbind(0), a.unbind(0)) for x in pair)


def _launch(P_aug, Q_aug, tile, depth, sb, users_per_block=0):
    """:func:`tile_topk`'s register-list form on CUDA tensors already
    validated (``depth <= 32``, ``tile <= 2048``). ``users_per_block`` 16
    or 128 holds the kernel to one of its two block forms
    (``measure_topk forms`` times both); 0, as :func:`tile_topk` passes,
    lets the launch choose."""
    m, a = _outputs(P_aug, Q_aug, tile, depth, sb)
    B, K = P_aug.shape
    lib = _build.load_library()
    stream = torch.cuda.current_stream(P_aug.device).cuda_stream
    _build.check(lib.mfx_tile_topk(
        P_aug.data_ptr(), Q_aug.data_ptr(),
        sb.data_ptr() if sb is not None else None, m.data_ptr(),
        a.data_ptr(), B, Q_aug.shape[0], K, tile, depth,
        _DTYPE_CODE[Q_aug.dtype], users_per_block, stream,
    ), "tile_topk")
    tile_topk.launches += 1
    return _pairs(m, a, depth)


def deep_pieces(cpt: int, pieces: int):
    """The chunks ``[first, end)`` of each piece when a tile's ``cpt``
    chunks are cut into ``pieces`` (``csrc/tile_topk.cu``'s
    ``piece_first``): every chunk in exactly one piece, in order."""
    return [(p * cpt // pieces, (p + 1) * cpt // pieces)
            for p in range(pieces)]


@functools.lru_cache(maxsize=256)
def deep_split(n_ub: int, tn: int, cpt: int, slots: int):
    """``(pieces, S)`` of a deep-form launch: ``n_ub`` user blocks, ``tn``
    tiles of ``cpt`` chunks, ``slots`` blocks the card holds at once. The
    grid is ``n_ub * S`` blocks; user block ``ub``'s blocks take the
    ``tn * pieces`` (tile, piece) items in strides of ``S``. ``pieces``
    (1 to 32, at most ``cpt``) minimises the rounds of items a block walks
    times the chunks of the largest piece, plus one a round for the
    piece's last merges, fewer pieces on a tie: the card is filled where
    the tiles alone would not fill it (15 tiles x 4 user blocks on 132
    SMs: 2 pieces), and a large catalog is not cut (977 tiles: 1)."""
    per_ub = max(1, slots // max(1, n_ub))
    best = None
    for pieces in range(1, min(cpt, MAX_PIECES) + 1):
        items = tn * pieces
        S = min(items, per_ub)
        cost = -(-items // S) * (-(-cpt // pieces) + 1)
        if best is None or cost < best[0]:
            best = (cost, pieces, S)
    return best[1], best[2]


def merge_pieces_plain(vals, lanes, depth):
    """The second launch of the deep form in plain PyTorch: per row, the
    pieces' sorted lists ``vals`` / ``lanes`` (..., pieces, depth), empty
    slots ``(-inf, 2**31 - 1)``, merged into the top ``depth`` by value
    descending, then lane ascending. Returns ``(values, lanes)`` (...,
    depth)."""
    v = vals.flatten(-2)
    ln = lanes.flatten(-2).long()
    order = torch.sort(ln, dim=-1, stable=True).indices
    v, ln = v.gather(-1, order), ln.gather(-1, order)
    order = torch.sort(v, dim=-1, descending=True, stable=True).indices
    return (v.gather(-1, order)[..., :depth],
            ln.gather(-1, order)[..., :depth].to(torch.int32))


_DEEP_INFO = {}


def _deep_info(lib, device, K, depth, code, lists):
    """``mfx_tile_topk_deep_info``'s plan for these shapes on this device,
    asked once (the device's limits do not change; a serving loop asks at
    every batch)."""
    key = (id(lib), device, K, depth, code, lists)
    if key not in _DEEP_INFO:
        info = (ctypes.c_int * 6)()
        _build.check(lib.mfx_tile_topk_deep_info(K, depth, code, lists,
                                                 info), "tile_topk deep info")
        _DEEP_INFO[key] = tuple(info)
    return _DEEP_INFO[key]


def _launch_deep(P_aug, Q_aug, tile, depth, sb, lists=0):
    """:func:`tile_topk`'s deep form on CUDA tensors already validated:
    any depth and any tile that is a multiple of 128. The kernel says its
    block form and where the users' pools fit (``_deep_info``);
    :func:`deep_split` cuts the tiles into pieces where they would not
    fill the card; the pools take a device scratch where they are not in
    shared memory, and the pieces' lists one where there is more than one
    piece. ``lists`` 1 (shared memory) or 2 (the scratch) holds the pools
    to one place (``measure_topk deep`` times both); 0, as
    :func:`tile_topk` passes, lets the launch choose."""
    m, a = _outputs(P_aug, Q_aug, tile, depth, sb)
    B, K = P_aug.shape
    ipad, code = Q_aug.shape[0], _DTYPE_CODE[Q_aug.dtype]
    dev = P_aug.device
    lib = _build.load_library()
    sms, per_sm, shared, ub, slots, form = _deep_info(
        lib, dev.index, K, depth, code, lists)
    n_ub, tn = -(-B // ub), ipad // tile
    pieces, S = deep_split(n_ub, tn, tile // CHUNK, sms * per_sm)
    list_words = 0 if shared else n_ub * S * ub * 2 * slots
    piece_words = B * tn * pieces * 2 * depth if pieces > 1 else 0
    scratch = torch.empty(max(1, list_words + piece_words),
                          dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.mfx_tile_topk_deep(
        P_aug.data_ptr(), Q_aug.data_ptr(),
        sb.data_ptr() if sb is not None else None, m.data_ptr(),
        a.data_ptr(), base if list_words else None, list_words,
        base + 4 * list_words if piece_words else None, piece_words,
        B, ipad, K, tile, depth, code, form, shared, pieces, S, stream,
    ), "tile_topk deep")
    tile_topk.deep_launches += 1
    return _pairs(m, a, depth)


tile_topk.launches = 0
tile_topk.deep_launches = 0


def tile_topk2(P_aug, Q_aug, tile: int = 1024):
    """Per-tile top-2 (the serving default); see :func:`tile_topk`."""
    return tile_topk(P_aug, Q_aug, tile=tile, depth=2)
