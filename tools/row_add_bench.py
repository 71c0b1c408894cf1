"""The card's two scatter-adds of ``mfx_torch/kernels/packing.py`` on the
Y step's shapes: ``row_add`` (``index_put_(accumulate=True)``) against
``segment_row_add`` (rows sorted stably, each row's value and deltas summed
in slot order by ``torch.segment_reduce``, written back once), on one
chunk of the timeSVD++ Y step at ML-25M scale.

    python tools/row_add_bench.py

Rows drawn with Zipf weights over the catalog (items, s = 1.1) and over
the users (s = 0.6), 4,194,304 rank-64 deltas, and 22,500,000 scalar
deltas onto the items (the run constants' degrees). Prints each form's
milliseconds over three calls (host clock around a synchronised call; the
first includes the allocator's warm-up), whether the second form repeats
bit for bit, its largest difference from the first, and whether the card's
result is bit for bit the CPU's. Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mfx_torch.kernels.packing import row_add, segment_row_add  # noqa: E402

CASES = ((4_194_304, 59_047, 64, 1.1), (4_194_304, 162_541, 64, 0.6),
         (22_500_000, 59_047, 1, 1.1))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("row_add_bench needs a CUDA device")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(0)
    for n, rows_n, width, s in CASES:
        p = 1.0 / np.arange(1, rows_n + 1) ** s
        rows = torch.as_tensor(rng.choice(rows_n, n, p=p / p.sum())).to(dev)
        tail = (width,) if width > 1 else ()
        d = torch.randn((n,) + tail, device=dev)
        outs = {}
        for name, fn in (("row_add", row_add),
                         ("segment_row_add", segment_row_add)):
            ms = []
            for _ in range(3):
                t = torch.zeros((rows_n,) + tail, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(t, rows, d)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                outs.setdefault(name, []).append(t)
            print(f"{n} deltas of width {width} onto {rows_n} rows (Zipf "
                  f"{s}, the hottest row {int(torch.bincount(rows).max())} "
                  f"times): {name} ms " + " ".join(f"{x:.2f}" for x in ms))
        a, b = outs["row_add"], outs["segment_row_add"]
        cpu = torch.zeros((rows_n,) + tail)
        segment_row_add(cpu, rows.cpu(), d.cpu())
        print(f"  segment_row_add repeats bitwise "
              f"{torch.equal(b[0], b[1]) and torch.equal(b[0], b[2])}; "
              f"largest difference from row_add "
              f"{float((a[0] - b[0]).abs().max()):.3e}; the CPU's bits "
              f"{torch.equal(cpu, b[0].cpu())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
