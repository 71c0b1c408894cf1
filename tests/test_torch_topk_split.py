"""The deep form of ``tile_topk`` cuts a tile's chunks into pieces where
the tiles do not fill the card, keeps each piece's top-``depth`` list and
merges the lists in piece order (``csrc/tile_topk.cu``). Its planning is
Python (``kernels/serve_topk.py``): these CPU tests hold the planner's
pieces and the plain merge (``merge_pieces_plain``) to the whole tile's
top-``depth``, and the split to the card's slots."""

import numpy as np
import pytest
import torch

from mfx_torch.kernels.serve_topk import (CHUNK, MAX_PIECES, _NOLANE,
                                          deep_pieces, deep_split,
                                          merge_pieces_plain)

PAD = -1e30  # the catalog's pad rows score about this


def _tile_scores(rng, B, tile, pad, ties):
    """(B, tile) f32 scores: random, the last ``pad`` lanes -1e30 plus a
    small random part, and (``ties``) values from a handful so that equal
    scores fall across pieces."""
    x = rng.standard_normal((B, tile)).astype(np.float32)
    if ties:
        x = rng.integers(-3, 4, (B, tile)).astype(np.float32) / 2
    if pad:
        x[:, tile - pad:] = PAD + x[:, tile - pad:]
    return torch.from_numpy(x)


def _top(scores, depth):
    """Top ``depth`` of each row by value descending, lanes ascending on
    ties (the plain version's stable sort)."""
    v, lanes = torch.sort(scores, dim=1, descending=True, stable=True)
    return v[:, :depth], lanes[:, :depth].to(torch.int32)


def _piece_lists(scores, pieces, depth):
    """Each piece's sorted top ``depth`` over its chunks (the kernel's
    lists), empty slots ``(-inf, 2**31 - 1)``: (B, pieces, depth) each."""
    B, tile = scores.shape
    vals = torch.full((B, pieces, depth), -float("inf"))
    lanes = torch.full((B, pieces, depth), _NOLANE, dtype=torch.int32)
    for p, (c0, c1) in enumerate(deep_pieces(tile // CHUNK, pieces)):
        part = scores[:, c0 * CHUNK:c1 * CHUNK]
        v, ln = _top(part, min(depth, part.shape[1]))
        vals[:, p, :v.shape[1]] = v
        lanes[:, p, :v.shape[1]] = ln + c0 * CHUNK
    return vals, lanes


@pytest.mark.parametrize("depth,tile,pieces,pad,ties", [
    (33, 256, 2, 0, False), (64, 4096, 2, 0, False), (64, 4096, 3, 500, True),
    (300, 4096, 7, 0, True), (100, 1024, 8, 1000, False),
    (256, 1024, 5, 0, True), (40, 2304, 18, 37, True), (33, 512, 4, 512, False),
    (300, 3072, 24, 0, False), (256, 256, 2, 100, True),
])
def test_piece_lists_merged_in_piece_order_are_the_tiles_top(depth, tile,
                                                             pieces, pad,
                                                             ties):
    """The pieces' lists, merged in piece order, give exactly the whole
    tile's top ``depth`` (values and lanes), with ties across pieces and
    the catalog's -1e30 pad rows, whether or not a piece holds ``depth``
    items."""
    rng = np.random.default_rng(depth * 7 + tile + pieces)
    scores = _tile_scores(rng, 6, tile, pad, ties)
    vals, lanes = _piece_lists(scores, pieces, depth)
    got_v, got_l = merge_pieces_plain(vals, lanes, depth)
    want_v, want_l = _top(scores, depth)
    assert torch.equal(got_v, want_v) and torch.equal(got_l, want_l)


@pytest.mark.parametrize("cpt", [1, 2, 3, 8, 18, 32, 64, 100])
def test_pieces_cover_each_chunk_exactly_once(cpt):
    """For every piece count the planner may choose, the pieces are
    contiguous, in order, not empty, and cover each chunk exactly once."""
    for pieces in range(1, min(cpt, MAX_PIECES) + 1):
        ranges = deep_pieces(cpt, pieces)
        assert len(ranges) == pieces and ranges[0][0] == 0
        assert ranges[-1][1] == cpt
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0
        assert all(c1 > c0 for c0, c1 in ranges)
        hits = np.zeros(cpt, dtype=int)
        for c0, c1 in ranges:
            hits[c0:c1] += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("n_ub,tn,cpt,slots,want", [
    (4, 15, 32, 132, 2),    # the serving shapes: 60 items fill half the card
    (4, 977, 8, 132, 1),    # 1M items at tile 1024: no cut
    (1, 15, 32, 132, 8),    # one user block, a small catalog
    (5, 2, 2, 132, 2),      # no more pieces than chunks
    (1, 1, 64, 132, 32),    # no more than 32 pieces
    (40, 200, 8, 132, 1),   # more items than slots
])
def test_deep_split_fills_the_card_where_the_tiles_do_not(n_ub, tn, cpt,
                                                          slots, want):
    pieces, S = deep_split(n_ub, tn, cpt, slots)
    assert pieces == want
    assert 1 <= pieces <= min(cpt, MAX_PIECES)
    assert 1 <= S <= tn * pieces and n_ub * S <= max(slots, n_ub)
