"""SHA-256 digests of what each form of the training kernels computes on
seeded inputs, one JSON line a form, so that two checkouts can be held
bit for bit against each other on one card:

    python tools/kernel_digest.py > a.jsonl
    PYTHONPATH=<other checkout> python <other checkout>/tools/kernel_digest.py > b.jsonl
    diff a.jsonl b.jsonl

Forms: ``sgd_sweep`` (lane, ranks 2 to 128; the time form at ranks 8 to
128), ``sgd_sweep_tile`` (tile biases and none, epoch biases at ranks 1
to 128), ``sgd_sweep_step_u`` (tile biases, ranks 1 to 128: its pools in
shared memory at ranks 1 to 32, in device memory at 64 and 128), each SGD
sweep but the time form also in its bf16 form (a ``bf16`` in the name),
``bpr_sweep`` (ranks 1 to 128; ranks 16, 8 and 4 of every sweep are
listed after the other forms, and after them ranks 2 and 1),
``dense_phase`` (lane, frozen and none at ranks 32 and 64 with int4 and
int8 codes, and at rank 128 with int8; lane and none with ``echo2``, two
passes a stratum), ``tile_topk`` (f32, bf16 and int8 catalogs at depths 1,
2, 8 and 32 on tiles of 128-2048, and the deep form: depths 33-300 and
tiles of 2,304-4,096; a checkout without the deep form prints its error
for those). Each training form runs once on the card's count of blocks from random
tables, on random tiles of blocks of 1,024 with long duplicate runs and
pads (the card tests' hot-row case), or on random dense strata of 512 x
512; the digest covers every table, output and the returned scalar.
``tile_topk`` scores 300 seeded random users against a catalog of
5,000 seeded random items (rank 64, item biases) and digests every
(value, lane) output. A
form the checkout does not have prints its error instead. Needs a CUDA
device.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

LR, REG, MU, TPG = 0.012, 0.04, 3.5, 4


def _digest(*xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _tiles(g, dev, rows=3, n_bins=0, bpr=False):
    su = si = 1024
    nt, T = 32, 256
    sa = torch.randint(0, 2, (nt // TPG,), device=dev, generator=g,
                       dtype=torch.int32)
    tc = torch.randint(0, 3, (nt,), device=dev, generator=g,
                       dtype=torch.int32)
    tl = torch.zeros(nt, rows, T, dtype=torch.int32, device=dev)
    for row in (0, 1):
        tl[:, row] = torch.randint(0, 64, (nt, T), device=dev, generator=g,
                                   dtype=torch.int32)
    if bpr:  # the negatives, then pads on every side
        tl[:, 2] = torch.randint(0, 64, (nt, T), device=dev, generator=g,
                                 dtype=torch.int32)
        tl[-1, 0, T // 2:], tl[-1, 1:, T // 2:] = su, si
        return sa, tc, tl, su, si
    tl[:, 2] = (torch.rand(nt, T, device=dev, generator=g) * 4.5
                + 0.5).view(torch.int32)
    if n_bins:
        tl[:, 3] = torch.randint(0, n_bins, (nt, T), device=dev, generator=g,
                                 dtype=torch.int32)
        tl[:, 4] = (torch.randn(nt, T, device=dev, generator=g)
                    * 0.5).view(torch.int32)
    tl[-1, 0, T // 2:], tl[-1, 1, T // 2:] = su, si
    return sa, tc, tl, su, si


def _tables(g, dev, rank, users, items):
    return (torch.randn(users, rank, device=dev, generator=g) * 0.1,
            torch.randn(items, rank, device=dev, generator=g) * 0.1,
            torch.randn(users, device=dev, generator=g) * 0.1,
            torch.randn(items, device=dev, generator=g) * 0.1)


def _group(g, dev, rfmt, nd=12, su=512, si=512):
    """Random dense strata over 3 user blocks and 4 windows."""
    sa = torch.randint(0, 3, (nd,), device=dev, generator=g,
                       dtype=torch.int32)
    sc = torch.randint(0, 4, (nd,), device=dev, generator=g,
                       dtype=torch.int32)
    top = 10 if rfmt == "int4" else 125
    codes = torch.randint(0, top + 1, (nd, su, si), device=dev, generator=g)
    codes[torch.rand(nd, su, si, device=dev, generator=g) < 0.7] = 0
    if rfmt == "int4":
        R = (codes[..., 0::2] | (codes[..., 1::2] << 4)).to(torch.uint8)
    else:
        R = codes.to(torch.int8)
    deg = (codes > 0).float()
    return {"sa": sa, "sc": sc, "R": R.contiguous(),
            "du_s": deg.sum(2).contiguous(), "di_s": deg.sum(1).contiguous()}


# tile_topk: (depth, tile) of the register-list form, then the deep form's
TOPK_FORMS = ((1, 128), (2, 1024), (2, 2048), (8, 256), (8, 2048),
              (32, 128), (32, 1024), (32, 2048))
TOPK_DEEP = ((33, 256), (64, 1024), (300, 512), (2, 2304), (40, 4096))


def _topk_tables(g, dev, dtype, tile, B=300, items=5000, rank=64):
    from mfx_torch.kernels.serve_topk import aug_width
    from mfx_torch.serve.fused import (_augment_catalog,
                                       _augment_catalog_int8, _augment_rows)

    P = torch.randn(B, rank, device=dev, generator=g)
    Q = torch.randn(items, rank, device=dev, generator=g) / rank ** 0.5
    bi = torch.randn(items, device=dev, generator=g) * 0.3
    ipad = -(-items // tile) * tile
    if dtype == "int8":
        Q_aug, sb = _augment_catalog_int8(Q, bi, ipad, tile)
        return _augment_rows(P, torch.float32, aug_width(rank)), Q_aug, sb
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (_augment_rows(P, dt, aug_width(rank)),
            _augment_catalog(Q, bi, ipad, dt), None)


def main() -> int:
    from mfx_torch.kernels import bpr_sweep as bs
    from mfx_torch.kernels import dense_phase as dp
    from mfx_torch.kernels import sgd_sweep as ss

    if not torch.cuda.is_available():
        raise SystemExit("kernel_digest: needs a CUDA device")
    dev = torch.device("cuda", 0)
    forms = []
    for rank in (32, 64, 128):
        forms.append((f"sgd_sweep lane r{rank}", rank, "lane", 0))
    for rank, nb in ((32, 16), (32, 28), (64, 30), (128, 70)):
        forms.append((f"sgd_sweep time r{rank} {nb} bins", rank, "time", nb))
    for rank in (32, 64, 128):
        for mode in ("tile", "none", "epoch"):
            forms.append((f"sgd_sweep_tile {mode} r{rank}", rank, mode, 0))
    for rank in (32, 64, 128):
        forms.append((f"sgd_sweep_step_u tile r{rank}", rank, "step_u", 0))
    for rank in (32, 64, 128):
        forms.append((f"bpr_sweep r{rank}", rank, "bpr", 0))
    for rank in (32, 64, 128):
        forms.append((f"sgd_sweep lane bf16 r{rank}", rank, "lane", 0))
        for mode in ("tile", "none", "epoch"):
            forms.append((f"sgd_sweep_tile {mode} bf16 r{rank}", rank, mode,
                          0))
        forms.append((f"sgd_sweep_step_u tile bf16 r{rank}", rank, "step_u",
                       0))
    for rank, rfmt in ((32, "int4"), (32, "int8"), (64, "int4"),
                       (64, "int8"), (128, "int8")):
        for bias in dp.BIAS_FORMS:
            forms.append((f"dense_phase {bias} {rfmt} r{rank}", rank, bias,
                          rfmt))
        for bias in ("lane", "none"):
            forms.append((f"dense_phase {bias} echo2 {rfmt} r{rank}", rank,
                          bias, rfmt))
    for dtype in ("f32", "bf16", "int8"):
        for depth, tile in TOPK_FORMS + TOPK_DEEP:
            forms.append((f"tile_topk {dtype} depth {depth} tile {tile}", 64,
                          dtype, (depth, tile)))
    # ranks 16, 8 and 4 of the sweeps (the time form at 16 and 8)
    for rank in (16, 8, 4):
        for bf16 in ("", " bf16"):
            forms.append((f"sgd_sweep lane{bf16} r{rank}", rank, "lane", 0))
            for mode in ("tile", "none", "epoch"):
                forms.append((f"sgd_sweep_tile {mode}{bf16} r{rank}", rank,
                              mode, 0))
            forms.append((f"sgd_sweep_step_u tile{bf16} r{rank}", rank,
                          "step_u", 0))
        forms.append((f"bpr_sweep r{rank}", rank, "bpr", 0))
    for rank, nb in ((16, 12), (8, 4)):
        forms.append((f"sgd_sweep time r{rank} {nb} bins", rank, "time", nb))
    # ranks 2 and 1 of the sweeps (the lane form at 2: one lane cannot hold
    # both bias lanes), after every form of a parent checkout
    for rank in (2, 1):
        for bf16 in ("", " bf16"):
            if rank > 1:
                forms.append((f"sgd_sweep lane{bf16} r{rank}", rank, "lane",
                              0))
            for mode in ("tile", "none", "epoch"):
                forms.append((f"sgd_sweep_tile {mode}{bf16} r{rank}", rank,
                              mode, 0))
            forms.append((f"sgd_sweep_step_u tile{bf16} r{rank}", rank,
                          "step_u", 0))
        forms.append((f"bpr_sweep r{rank}", rank, "bpr", 0))
    for name, rank, mode, extra in forms:
        g = torch.Generator(device=dev).manual_seed(len(name) * 7919 + rank)
        # the new forms' options, passed only where they are on
        bf16 = {"bf16": True} if " bf16 " in name else {}
        echo = {"echo": 2} if " echo2 " in name else {}
        try:
            if name.startswith("sgd_sweep "):
                sa, tc, tl, su, si = _tiles(g, dev, 5 if extra else 3, extra)
                P, Q, _, _ = _tables(g, dev, rank, 2 * su, 3 * si)
                kw = dict(su=su, si=si, tpg=TPG, **bf16)
                if extra:
                    s = ss.sgd_sweep_time(P, Q, sa, tc, tl, LR, REG, MU,
                                          n_bins=extra, **kw)
                else:
                    s = ss.sgd_sweep(P, Q, sa, tc, tl, LR, REG, MU, **kw)
                out = (P, Q, s)
            elif name.startswith("tile_topk"):
                from mfx_torch.kernels.serve_topk import tile_topk

                depth, tile = extra
                P_aug, Q_aug, sb = _topk_tables(g, dev, mode, tile)
                out = tile_topk(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
            elif name.startswith("bpr_sweep"):
                sa, tc, tl, su, si = _tiles(g, dev, bpr=True)
                P, Q, _, _ = _tables(g, dev, rank, 2 * su, 3 * si)
                s = bs.bpr_sweep(P, Q, sa, tc, tl, LR, REG, su=su, si=si,
                                 tpg=TPG)
                out = (P, Q, s)
            elif name.startswith("sgd_sweep_"):
                sa, tc, tl, su, si = _tiles(g, dev)
                P, Q, bu, bi = _tables(g, dev, rank, 2 * su, 3 * si)
                kw = dict(su=su, si=si, tpg=TPG, **bf16)
                if mode == "step_u":
                    s = ss.sgd_sweep_step_u(P, Q, bu, bi, sa, tc, tl, LR,
                                            REG, MU, **kw)
                    out = (P, Q, bu, bi, s)
                elif mode == "epoch":
                    e = torch.zeros(tl.shape[0], tl.shape[2], device=dev)
                    s = ss.sgd_sweep_epoch(P, Q, bu, bi, sa, tc, tl, e, LR,
                                           REG, MU, **kw)
                    out = (P, Q, bu, bi, e, s)
                else:
                    s = ss.sgd_sweep_tile(P, Q, bu, bi, sa, tc, tl, LR, REG,
                                          MU, use_bias=mode == "tile", **kw)
                    out = (P, Q, bu, bi, s)
            else:
                grp = _group(g, dev, extra)
                P, Q, bu, bi = _tables(g, dev, rank, 3 * 512, 4 * 512)
                kw = dict(su=512, si=512, bias=mode)
                if mode == "frozen":
                    s, (dbu, dbi) = dp.dense_phase(P, Q, grp, LR, REG, MU,
                                                   bu=bu, bi=bi, **kw)
                    out = (P, Q, dbu, dbi, s)
                else:
                    s = dp.dense_phase(P, Q, grp, LR, REG, MU, **kw, **echo)
                    out = (P, Q, s)
            torch.cuda.synchronize()
            row = {"form": name, "sha256": _digest(*out)}
        except (NotImplementedError, RuntimeError, ValueError) as exc:
            row = {"form": name, "error": type(exc).__name__}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
