"""Timings of ``tile_topk`` beside the stock path, and of its two block
forms across batch sizes, on ``chip_smoke.py``'s serving shapes.

    python -m mfx_torch.measure_topk kernel [--repeats 20]
    python -m mfx_torch.measure_topk forms  [--repeats 20]

The tables are phase 5's: seeded random user rows (``B`` x rank 64) and
catalog (rank 64, item biases), augmented to width 72 as the fused
recommenders augment them (:func:`serving_tables`, which ``chip_smoke.py``
phase 5 builds its tables with); tile 1024.

``kernel``: each of phase 5's variants (1,000,000 items, B = 256; f32 at
depth 2 and 8, bf16 and int8 at depth 2), then the f32 calls of phase 6's
batch (59,047 items, the ML-25M catalog; depth 2 for the fused
recommender, 8 for the exact one): the kernel and the stock path
(:func:`stock_topk`), each timed with CUDA events ``--repeats`` times,
the two interleaved; one JSON line a variant with min, median and max of
each.

``forms``: f32 at depths 2 and 8 on both catalogs, for B in
:data:`BATCHES` (1 and 37 are the HTTP server's small batches, 256 a full
one): the kernel as ``tile_topk`` launches it, and held to each of its
two block forms, 16 and 128 users a block, interleaved; one JSON line
each, the forced forms checked bitwise against the launch's own choice.

It calls only ``tile_topk`` and the fused recommenders' augmentation,
which earlier trees of the port have too, so it also times an earlier
checkout's package: run it by path with that checkout first on the path,
from the checkout's root (``PYTHONPATH=$PWD python
NEW/mfx_torch/measure_topk.py forms``); a package without the forcing
hook gets only the launch's own choice timed. Every line names the
package it timed. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

RANK, SERVE_B, SERVE_TILE, SERVE_ITEMS = 64, 256, 1024, 1_000_000
ML25M_ITEMS = 59_047  # phase 6's catalog
# phase 5's (dtype, depth) at SERVE_ITEMS x SERVE_B
PHASE5_VARIANTS = (("f32", 2), ("f32", 8), ("bf16", 2), ("int8", 2))
BATCHES = (1, 8, 16, 37, 64, 128, 256)


def serving_tables(dev, B, items, dtype):
    """Seeded random ``(P_aug, Q_aug, sb)`` at B user rows and ``items``
    catalog rows (padded to tiles of SERVE_TILE) in ``dtype`` 'f32',
    'bf16' or 'int8' (``sb`` None but for int8)."""
    import torch

    from mfx_torch.kernels.serve_topk import aug_width
    from mfx_torch.serve.fused import (_augment_catalog,
                                       _augment_catalog_int8, _augment_rows)

    g = torch.Generator(device=dev).manual_seed(5)
    P = torch.randn(B, RANK, device=dev, generator=g)
    Q = torch.randn(items, RANK, device=dev, generator=g) / RANK ** 0.5
    bi = torch.randn(items, device=dev, generator=g) * 0.3
    ipad = -(-items // SERVE_TILE) * SERVE_TILE
    if dtype == "int8":
        Q_aug, sb = _augment_catalog_int8(Q, bi, ipad, SERVE_TILE)
        return _augment_rows(P, torch.float32, aug_width(RANK)), Q_aug, sb
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (_augment_rows(P, dt, aug_width(RANK)),
            _augment_catalog(Q, bi, ipad, dt), None)


def stock_topk(P_aug, Q_aug, sb, tile, depth):
    """The yardstick: ``matmul_f32`` (for int8 then the scale and bias),
    then ``torch.topk`` over each tile."""
    import torch

    from mfx_torch.kernels.serve_topk import matmul_f32

    s = matmul_f32(P_aug, Q_aug)
    if sb is not None:
        s = s * sb[:, 0].reshape(1, -1) + sb[:, 1].reshape(1, -1)
    return torch.topk(s.view(P_aug.shape[0], -1, tile), depth, dim=2)


def _stats(xs):
    return {"min": min(xs), "median": statistics.median(xs), "max": max(xs)}


def _event_ms(fn):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _timed(fns, repeats):
    """Each of ``fns`` (name -> callable) warmed up, then timed
    ``repeats`` times in turn: name -> stats."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(repeats):
        for k, fn in fns.items():
            times[k].append(_event_ms(fn))
    return {k: _stats(v) for k, v in times.items()}


def _header():
    import torch

    import mfx_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return {"package": mfx_torch.__file__, "card": card,
            "device": torch.cuda.get_device_name(0)}


def kernel(args, head, dev) -> None:
    import torch

    from mfx_torch.kernels.serve_topk import tile_topk

    cases = ([(SERVE_ITEMS, dt, d) for dt, d in PHASE5_VARIANTS]
             + [(ML25M_ITEMS, "f32", 2), (ML25M_ITEMS, "f32", 8)])
    for items, dtype, depth in cases:
        P_aug, Q_aug, sb = serving_tables(dev, SERVE_B, items, dtype)
        t = _timed({
            "kernel_ms": lambda: tile_topk(P_aug, Q_aug, tile=SERVE_TILE,
                                           depth=depth, sb=sb),
            "stock_ms": lambda: stock_topk(P_aug, Q_aug, sb, SERVE_TILE,
                                           depth)}, args.repeats)
        print(json.dumps({**head, "kernel": "tile_topk", "dtype": dtype,
                          "depth": depth, "items": items, "B": SERVE_B,
                          "tile": SERVE_TILE, "repeats": args.repeats, **t}),
              flush=True)
        del P_aug, Q_aug, sb
        torch.cuda.empty_cache()


def forms(args, head, dev) -> None:
    import torch

    from mfx_torch.kernels import serve_topk

    launch = getattr(serve_topk, "_launch", None)
    for items in (ML25M_ITEMS, SERVE_ITEMS):
        for depth in (2, 8):
            for B in BATCHES:
                P_aug, Q_aug, sb = serving_tables(dev, B, items, "f32")
                fns = {"auto_ms": lambda: serve_topk.tile_topk(
                    P_aug, Q_aug, tile=SERVE_TILE, depth=depth)}
                if launch is not None:
                    want = fns["auto_ms"]()
                    for ub in (16, 128):
                        fns[f"ub{ub}_ms"] = (
                            lambda ub=ub: launch(P_aug, Q_aug, SERVE_TILE,
                                                 depth, None, ub))
                        got = fns[f"ub{ub}_ms"]()
                        if any(not torch.equal(a, b)
                               for a, b in zip(got, want)):
                            raise AssertionError(
                                f"tile_topk: {ub} users a block differ from "
                                f"the launch's choice at B {B}, depth {depth}")
                print(json.dumps({**head, "forms": "tile_topk f32",
                                  "items": items, "depth": depth, "B": B,
                                  "tile": SERVE_TILE,
                                  "repeats": args.repeats,
                                  **_timed(fns, args.repeats)}), flush=True)
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="mfx_torch.measure_topk")
    ap.add_argument("what", choices=("kernel", "forms"))
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure_topk: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    {"kernel": kernel, "forms": forms}[args.what](args, _header(), dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
