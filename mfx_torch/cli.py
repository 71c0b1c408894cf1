"""CLI of the port.

    python -m mfx_torch.cli train --preset ml25m_rank64 [--set k=v ...] [--device cuda]

Configs come from the shared ``mfx.config`` presets and ``--set``
overrides; ``train`` prints the same JSON object as ``mfx.cli train``.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_train(args) -> int:
    from mfx.config import apply_overrides, preset
    from mfx_torch.train.driver import train

    cfg = apply_overrides(preset(args.preset), args.overrides)
    result = train(cfg, device=args.device)
    out = {
        "preset": cfg.name,
        "epochs_run": result.epochs_run,
        "updates_per_sec": result.updates_per_sec,
    }
    if result.test_rmse is not None:
        out["test_rmse"] = result.test_rmse
        out["test_mae"] = result.test_mae
    print(json.dumps(out, sort_keys=True))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="mfx_torch", description="matrix factorization on PyTorch/CUDA"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("train", help="train a preset config")
    p.add_argument("--preset", default="ml25m_rank64",
                   help="named config from mfx.config.PRESETS")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dot-path config override")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.set_defaults(fn=cmd_train)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
