"""Profiling hook, the counterpart of ``mfx/train/profile.py``: a
``torch.profiler`` trace around the training loop, written as a Chrome
trace (``chrome://tracing`` or Perfetto) into the configured directory;
inert unless a trace directory is set."""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

__all__ = ["maybe_trace"]


@contextlib.contextmanager
def maybe_trace(trace_dir=None):
    """Wrap the body in a ``torch.profiler`` trace (host ops, and the
    card's kernels when one is present) when ``trace_dir`` is set and
    write it to ``<trace_dir>/trace_<time>_<pid>.json``; no-op
    otherwise."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(str(out / name))
