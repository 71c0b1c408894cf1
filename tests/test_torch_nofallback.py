"""The port imports no JAX, and nothing in it carries on without a card:
kernel wrappers, the kernel build and chip_smoke.py fail loudly instead
of falling back to the CPU."""

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mfx_torch.kernels import _build
from mfx_torch.kernels.dense_phase import dense_phase
from mfx_torch.kernels.serve_topk import tile_topk
from mfx_torch.kernels.sgd_sweep import sgd_sweep

ROOT = Path(__file__).resolve().parent.parent
MODULES = [
    "mfx_torch", "mfx_torch.cli", "mfx_torch.convert", "mfx_torch.models.mf",
    "mfx_torch.kernels.packing", "mfx_torch.kernels.plan_device",
    "mfx_torch.kernels.sgd_sweep", "mfx_torch.kernels.dense_phase",
    "mfx_torch.kernels._build", "mfx_torch.eval.metrics",
    "mfx_torch.solvers.dense_prep", "mfx_torch.solvers.blocked",
    "mfx_torch.train.driver", "mfx_torch.train.checkpoint",
    "mfx_torch.kernels.serve_topk", "mfx_torch.serve", "mfx_torch.serve.topk",
    "mfx_torch.serve.fused", "mfx_torch.serve.foldin",
    "mfx_torch.serve.server",
]


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = str(cwd)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_wrappers_on_a_missing_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_gpu.py runs")
    with pytest.raises((RuntimeError, AssertionError)):
        P = torch.zeros(256, 64, device="cuda")
        sgd_sweep(P, P, P, P, P, 0.01, 0.04, 3.5, su=256, si=256, tpg=4)
    with pytest.raises((RuntimeError, AssertionError)):
        P = torch.zeros(256, 64, device="cuda")
        dense_phase(P, P, {}, 0.01, 0.04, 3.5, su=256, si=256)
    with pytest.raises((RuntimeError, AssertionError)):
        P = torch.zeros(16, 72, device="cuda")
        tile_topk(P, torch.zeros(1024, 72, device="cuda"), tile=1024)


def test_recommenders_on_a_missing_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_gpu.py runs")
    from mfx_torch.convert import model_from_numpy
    from mfx_torch.serve import (FusedTopKRecommender, TopKRecommender,
                                 similar_items_fused)

    model = model_from_numpy({"P": np.ones((4, 8)), "Q": np.ones((300, 8)),
                              "bu": np.zeros(4), "bi": np.zeros(300),
                              "mu": 3.0})
    for build in (lambda: FusedTopKRecommender(model, tile=128,
                                               device="cuda"),
                  lambda: TopKRecommender(model, device="cuda"),
                  lambda: similar_items_fused(model, [0], k=1, tile=128,
                                              device="cuda")):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


@pytest.mark.parametrize("wrapper", ["sgd_sweep", "dense_phase",
                                     "tile_topk"])
def test_wrappers_reject_devices_without_a_kernel(wrapper):
    P = torch.zeros(256, 64, device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        if wrapper == "sgd_sweep":
            sgd_sweep(P, P, torch.zeros(1, **i32), torch.zeros(4, **i32),
                      torch.zeros(4, 3, 64, **i32), 0.01, 0.04, 3.5,
                      su=256, si=256, tpg=4)
        elif wrapper == "tile_topk":
            tile_topk(torch.zeros(16, 72, device="meta"),
                      torch.zeros(1024, 72, device="meta"), tile=1024)
        else:
            grp = {"sa": torch.zeros(1, **i32), "sc": torch.zeros(1, **i32),
                   "R": torch.zeros(1, 256, 128, dtype=torch.uint8,
                                    device="meta"),
                   "du_s": torch.zeros(1, 256, device="meta"),
                   "di_s": torch.zeros(1, 256, device="meta")}
            dense_phase(P, P, grp, 0.01, 0.04, 3.5, su=256, si=256)


def test_kernel_build_needs_the_toolkit():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        pytest.skip("a CUDA toolkit is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    t0 = time.monotonic()
    res = _run(["chip_smoke.py"], cwd, timeout=60)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "[data]" not in res.stdout  # failed before generating any data
    assert "FAILED" in res.stderr
    assert time.monotonic() - t0 < 30
