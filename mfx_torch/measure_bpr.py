"""Measurements of the BPR ring's cell beyond ``chip_smoke.py``.

    python -m mfx_torch.measure_bpr profile [--cut 10] [--trace out.json]

``profile`` builds the BPR cell of ``chip_smoke.py`` (the
``billion_bpr_sharded`` preset with ``parallel.model_axis=1`` on the
billion-implicit synthetic cut to 1/``cut`` of its users, items and
positives), trains epoch 0 to warm up, runs epoch 1 under
``torch.profiler`` and prints the device time by kernel (device-side
events only), grouped (the sweep kernel, sorts, other kernels, copies),
and one JSON line with the epoch's wall time (host clock, ended by a
synchronize), its negatives and plan times, and the device's idle share
(1 − device-busy / wall). It needs a CUDA device; ``--trace`` also
writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import time


def _group(name: str) -> str:
    low = name.lower()
    if "bpr_sweep" in low:
        return "bpr_sweep kernel"
    if "sort" in low or "radix" in low:
        return "sort"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other kernels"


def _cfg(epochs: int):
    from mfx_torch.config import apply_overrides, preset

    return apply_overrides(preset("billion_bpr_sharded"),
                           ["parallel.model_axis=1", f"bpr.epochs={epochs}"])


def _model(cfg, train, dev):
    import torch

    from mfx_torch.models.mf import init_model

    g = torch.Generator(device=dev).manual_seed(cfg.model.seed)
    return init_model(g, train.num_users, train.num_items, cfg.model.rank,
                      global_mean=train.global_mean)


def profile(args) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import (BILLION_SHAPE,
                                          make_implicit_synthetic)
    from mfx_torch.parallel.bpr_sharded import train_epochs_bpr_ring

    if not torch.cuda.is_available():
        raise SystemExit("measure_bpr profile: needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = _cfg(2)
    shape = tuple(x // args.cut for x in BILLION_SHAPE)
    coo = make_implicit_synthetic(*shape, rank=64, seed=104)
    train, _ = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    del coo
    timings: dict = {}
    it = train_epochs_bpr_ring(_model(cfg, train, dev), train, cfg.bpr,
                               seed=cfg.data.seed, device=dev,
                               timings=timings)
    next(it)  # epoch 0: prep and warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, loss = next(it)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, groups = [], {}
    for ev in prof.key_averages():
        # device-side events only: a host op's row repeats its kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0:
            continue
        rows.append((dev_us, ev.key, ev.count))
        grp = _group(ev.key)
        groups[grp] = groups.get(grp, 0.0) + dev_us
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    for dev_us, key, count in rows[:15]:
        print(f"{dev_us / 1e3:12.3f} ms  {count:6d}x  {key[:90]}")
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "cut": args.cut,
        "epoch": 1, "mean_loss": loss, "wall_ms": wall * 1e3,
        "neg_ms": timings["neg_s"] * 1e3, "plan_ms": timings["plan_s"] * 1e3,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall * 1e3),
        "device_ms_by_group": {k: v / 1e3 for k, v in sorted(groups.items())},
    }))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mfx_torch.measure_bpr")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("profile", help="profile one steady epoch on the card")
    p.add_argument("--cut", type=int, default=10)
    p.add_argument("--trace", default=None)
    p.set_defaults(fn=profile)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
