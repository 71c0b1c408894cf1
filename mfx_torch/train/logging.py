"""Metrics logging, the port's own copy of ``mfx/train/logging.py``
(verbatim but for this docstring).

Structured per-epoch records with the BASELINE metric fields first-class
(updates/sec/chip, epochs-to-target-RMSE), written as JSONL and echoed to
stderr. No external logging deps.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, path=None, echo: bool = True):
        self.path = Path(path) if path else None
        self.echo = echo
        self.records: list[dict] = []
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", buffering=1)
        else:
            self._fh = None
        self._t0 = time.time()

    def log(self, **fields) -> dict:
        rec = {"t": round(time.time() - self._t0, 3), **fields}
        self.records.append(rec)
        line = json.dumps(rec, sort_keys=True)
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr, flush=True)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
