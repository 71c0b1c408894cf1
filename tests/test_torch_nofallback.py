"""The port imports neither JAX nor anything of the JAX package ``mfx``,
and nothing in it carries on without a card: kernel wrappers, loaders
that default to the card, the kernel build and chip_smoke.py fail loudly
instead of falling back to the CPU."""

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
from mfx_torch.kernels.bpr_sweep import bpr_sweep
from mfx_torch.kernels.dense_phase import dense_phase
from mfx_torch.kernels.serve_topk import tile_topk
from mfx_torch.kernels.sgd_sweep import (sgd_sweep, sgd_sweep_step_u,
                                         sgd_sweep_tile, sgd_sweep_time)

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
    "mfx_torch.serve.server", "mfx_torch.config", "mfx_torch.data",
    "mfx_torch.data.coo", "mfx_torch.data.synthetic",
    "mfx_torch.data.loaders", "mfx_torch.data.split", "mfx_torch.data.bpr",
    "mfx_torch.kernels.plan_ring_device", "mfx_torch.kernels.bpr_sweep",
    "mfx_torch.solvers.bpr", "mfx_torch.parallel",
    "mfx_torch.parallel.bpr_sharded", "mfx_torch.parallel.data_parallel",
    "mfx_torch.eval",
    "mfx_torch.eval.ranking", "mfx_torch.measure_bpr",
    "mfx_torch.measure_wavefront", "mfx_torch.data.partition",
    "mfx_torch.oracle", "mfx_torch.oracle.java_oracle",
    "mfx_torch.kernels.minibatch", "mfx_torch.solvers.sgd",
    "mfx_torch.models", "mfx_torch.train.online",
    "mfx_torch.train.logging", "mfx_torch.train.profile",
    "mfx_torch.models.timesvd", "mfx_torch.solvers.timesvd",
    "mfx_torch.solvers.timesvd_blocked", "mfx_torch.api",
    "mfx_torch.serve.rerank", "mfx_torch.version",
    "mfx_torch.solvers.als", "mfx_torch.solvers.ials",
    "mfx_torch.solvers.nmf", "mfx_torch.models.svdpp",
    "mfx_torch.solvers.svdpp", "mfx_torch.solvers.timesvdpp",
]


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = str(cwd)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


_NO_REFERENCE = (
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'mfx'))\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)


def test_port_imports_no_jax():
    """Neither JAX nor any module of the JAX package ``mfx`` (not even a
    NumPy-only one) is loaded after importing every port module."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
    ) + _NO_REFERENCE
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_no_jax():
    """The same check over every module that an import statement anywhere
    in chip_smoke.py names (``from a import b`` also tries module
    ``a.b``)."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods, subs = set(), set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            mods.update(a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom):
            mods.add(n.module)
            subs.update(f"{n.module}.{a.name}" for a in n.names)
    assert "mfx_torch.parallel.bpr_sharded" in subs
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
        f"for m in {sorted(subs)!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "    except ModuleNotFoundError:\n"
        "        pass\n"
    ) + _NO_REFERENCE
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_loaders_default_to_the_card(tmp_path):
    """load_checkpoint, MFModel.load_npz and model_from_numpy put the
    tables on the card unless asked otherwise (so here, with no card, they
    raise), and init_model follows its generator's device."""
    import inspect

    from mfx_torch.convert import model_from_numpy, model_to_numpy
    from mfx_torch.models.mf import MFModel, init_model
    from mfx_torch.train.checkpoint import load_checkpoint, save_checkpoint

    for fn in (load_checkpoint, MFModel.load_npz, model_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    model = init_model(torch.Generator().manual_seed(0), 6, 5, 4)
    assert model.device.type == "cpu"
    save_checkpoint(tmp_path, 0, model)
    model.save_npz(tmp_path / "m.npz")
    assert load_checkpoint(tmp_path, device="cpu")[0].device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the defaults would succeed")
    with pytest.raises((RuntimeError, AssertionError)):
        load_checkpoint(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        MFModel.load_npz(tmp_path / "m.npz")
    arrays = model_to_numpy(model)
    assert model_from_numpy(arrays, device="cpu").device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):
        model_from_numpy(arrays)


def test_svdpp_family_defaults_to_the_card(tmp_path):
    """SVDppModel.load_npz, svdpp_from_numpy and implicit_scale put their
    tensors on the card unless asked otherwise (so here, with no card,
    they raise); the SVD++ and timeSVD++ trainers run on their model's
    device, so a model on a device without a kernel reaches no CPU
    fallback."""
    import inspect

    from mfx_torch.config import SVDPPConfig, TimeSVDPPConfig
    from mfx_torch.convert import model_from_numpy, svdpp_from_numpy
    from mfx_torch.data.coo import RatingsCOO
    from mfx_torch.models.svdpp import SVDppModel, implicit_scale
    from mfx_torch.solvers.svdpp import train_epochs_svdpp
    from mfx_torch.solvers.timesvdpp import train_epochs_timesvdpp

    for fn in (SVDppModel.load_npz, svdpp_from_numpy, implicit_scale):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    a = {"P": np.ones((4, 8)), "Q": np.ones((6, 8)), "Y": np.zeros((6, 8)),
         "bu": np.zeros(4), "bi": np.zeros(6), "mu": 3.0, "nu": np.ones(4)}
    svdpp_from_numpy(a, device="cpu").save_npz(tmp_path / "s.npz")
    assert SVDppModel.load_npz(tmp_path / "s.npz",
                               device="cpu").device.type == "cpu"
    coo = RatingsCOO(np.arange(4, dtype=np.int32), np.arange(4, dtype=np.int32),
                     np.full(4, 3.0, np.float32), 4, 6,
                     timestamp=np.arange(4, dtype=np.int64))
    meta = model_from_numpy(a, device="cpu").to("meta")
    for run in (lambda: train_epochs_svdpp(meta, coo, SVDPPConfig(epochs=1),
                                           True),
                lambda: train_epochs_timesvdpp(
                    meta, coo, TimeSVDPPConfig(epochs=1, n_bins=2,
                                               kernel="pallas",
                                               reg_alpha=0.02))):
        with pytest.raises((NotImplementedError, RuntimeError, ValueError)):
            next(run())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the defaults would succeed")
    for build in (lambda: SVDppModel.load_npz(tmp_path / "s.npz"),
                  lambda: svdpp_from_numpy(a),
                  lambda: implicit_scale(coo.user, 4)):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


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
    with pytest.raises((RuntimeError, AssertionError)):
        P = torch.zeros(256, 64, device="cuda")
        bpr_sweep(P, P, P, P, P, 0.05, 0.002, su=256, si=256, tpg=4)
    with pytest.raises((RuntimeError, AssertionError)):
        P = torch.zeros(512, 64, device="cuda")
        sgd_sweep_time(P, P, P, P, P, 0.01, 0.02, 3.5, su=512, si=512,
                       tpg=4, n_bins=30)
    for tile_bias_sweep in (sgd_sweep_tile, sgd_sweep_step_u):
        with pytest.raises((RuntimeError, AssertionError)):
            P = torch.zeros(256, 32, device="cuda")
            tile_bias_sweep(P, P, P, P, P, P, P, 0.01, 0.04, 3.5, su=256,
                            si=256, tpg=4)


def test_recommenders_on_a_missing_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_gpu.py runs")
    from mfx_torch.convert import model_from_numpy
    from mfx_torch.serve import (FusedTopKRecommender, TopKRecommender,
                                 similar_items_fused)

    model = model_from_numpy({"P": np.ones((4, 8)), "Q": np.ones((300, 8)),
                              "bu": np.zeros(4), "bi": np.zeros(300),
                              "mu": 3.0}, device="cpu")
    for build in (lambda: FusedTopKRecommender(model, tile=128,
                                               device="cuda"),
                  lambda: TopKRecommender(model, device="cuda"),
                  lambda: similar_items_fused(model, [0], k=1, tile=128,
                                              device="cuda")):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


@pytest.mark.parametrize("wrapper", ["sgd_sweep", "dense_phase",
                                     "tile_topk", "bpr_sweep",
                                     "sgd_sweep_tile", "sgd_sweep_step_u",
                                     "sgd_sweep_time"])
def test_wrappers_reject_devices_without_a_kernel(wrapper):
    P = torch.zeros(256, 64, device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        if wrapper == "sgd_sweep":
            sgd_sweep(P, P, torch.zeros(1, **i32), torch.zeros(4, **i32),
                      torch.zeros(4, 3, 64, **i32), 0.01, 0.04, 3.5,
                      su=256, si=256, tpg=4)
        elif wrapper == "sgd_sweep_time":
            sgd_sweep_time(P, P, torch.zeros(1, **i32),
                           torch.zeros(4, **i32),
                           torch.zeros(4, 5, 64, **i32), 0.01, 0.02, 3.5,
                           su=256, si=256, tpg=4, n_bins=30)
        elif wrapper in ("sgd_sweep_tile", "sgd_sweep_step_u"):
            b = torch.zeros(256, device="meta")
            fn = sgd_sweep_tile if wrapper == "sgd_sweep_tile" else sgd_sweep_step_u
            fn(P, P, b, b, torch.zeros(1, **i32), torch.zeros(4, **i32),
               torch.zeros(4, 3, 64, **i32), 0.01, 0.04, 3.5, su=256, si=256,
               tpg=4)
        elif wrapper == "bpr_sweep":
            bpr_sweep(P, P, torch.zeros(1, **i32), torch.zeros(4, **i32),
                      torch.zeros(4, 3, 64, **i32), 0.05, 0.002,
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


@pytest.mark.parametrize("form", ["sgd_sweep_epoch", "dense_frozen",
                                  "dense_none"])
@pytest.mark.parametrize("device", ["cuda", "meta"])
def test_bias_forms_have_no_fallback(form, device):
    """The epoch form of the tile sweep and the frozen and bias-free forms
    of the dense phase launch their kernel or raise: on a missing card
    (RuntimeError / AssertionError) and on a device with no kernel
    (ValueError); neither runs the plain version."""
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_epoch

    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_gpu.py runs")
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    want = (ValueError,) if device == "meta" else (RuntimeError,
                                                   AssertionError)
    with pytest.raises(want):  # without a card, already at the inputs
        P = torch.zeros(256, 64, device=dev)
        b = torch.zeros(256, device=dev)
        if form == "sgd_sweep_epoch":
            sgd_sweep_epoch(P, P, b, b, torch.zeros(1, **i32),
                            torch.zeros(4, **i32),
                            torch.zeros(4, 3, 64, **i32),
                            torch.zeros(4, 64, device=dev), 0.01, 0.04, 3.5,
                            su=256, si=256, tpg=4)
        else:
            grp = {"sa": torch.zeros(1, **i32), "sc": torch.zeros(1, **i32),
                   "R": torch.zeros(1, 256, 128, dtype=torch.uint8,
                                    device=dev),
                   "du_s": torch.zeros(1, 256, device=dev),
                   "di_s": torch.zeros(1, 256, device=dev)}
            extra = (dict(bias="frozen", bu=b, bi=b) if form == "dense_frozen"
                     else dict(bias="none"))
            dense_phase(P, P, grp, 0.01, 0.04, 3.5, su=256, si=256, **extra)


def test_bpr_profile_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mfx_torch.measure_bpr import main

    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main(["profile", "--cut", "100000"])


@pytest.mark.parametrize("what", ["kernel", "forms"])
def test_topk_measure_needs_a_card(what):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mfx_torch.measure_topk import main

    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main([what, "--repeats", "1"])


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


@pytest.mark.parametrize("module,wrappers", [
    ("sgd_sweep", ["sgd_sweep", "sgd_sweep_time", "_lane_sweep",
                   "_tile_bias_sweep", "wavefront_launch"]),
    ("bpr_sweep", ["bpr_sweep"]),
    ("dense_phase", ["dense_phase", "dense_launch"]),
])
def test_sweep_wrappers_cuda_route_reaches_no_plain_version(module, wrappers):
    """In the sweep wrappers' source: no ``try`` at all, and a plain
    version is called only under ``if P.device.type == "cpu"``, so a
    failed build or launch on the card can only raise."""
    import ast

    tree = ast.parse((ROOT / "mfx_torch" / "kernels" / f"{module}.py")
                     .read_text())
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for name in wrappers:
        fn = defs[name]
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], name
        cpu_only = set()
        for branch in (n for n in ast.walk(fn) if isinstance(n, ast.If)):
            if ast.unparse(branch.test) == "P.device.type == 'cpu'":
                cpu_only.update(id(n) for stmt in branch.body
                                for n in ast.walk(stmt))
        plain_calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                       and "plain" in ast.unparse(n.func)]
        assert all(id(n) in cpu_only for n in plain_calls), name
        if name in ("_lane_sweep", "bpr_sweep", "_tile_bias_sweep",
                    "dense_phase"):
            assert plain_calls, name


@pytest.mark.parametrize("form,item", [
    ("sgd_sweep rank 3", "does not divide 128"),
    ("sgd_sweep rank 96", "does not divide 128"),
    ("sgd_sweep_tile rank 6", "does not divide 128"),
    ("bpr_sweep rank 48", "does not divide 128"),
    ("dense_phase rank 128 int4", "reference's dense path has no other"),
    ("dense_phase rank 16 int8", "reference's dense path has no other"),
])
def test_forms_without_a_kernel_raise(form, item):
    """A rank or code format the kernels lack is refused before any launch
    (the checks the wrappers make on a card's tensors), saying that the
    reference has no such form either: the sweeps take every rank that
    divides 128; the kernels' own forms pass."""
    from mfx_torch.kernels.dense_phase import check_kernel_form
    from mfx_torch.kernels.sgd_sweep import SWEEP_RANKS, check_kernel_limits

    who, _, rank, *fmt = form.split()
    rank = int(rank)
    P = torch.zeros(512, rank)
    if who != "dense_phase":
        # every sweep wrapper makes this check
        tl = torch.zeros(4, 3, 256, dtype=torch.int32)
        for ok in SWEEP_RANKS:
            check_kernel_limits(who, torch.zeros(512, ok), tl, 512, 512)
        with pytest.raises(NotImplementedError, match=item):
            check_kernel_limits(who, P, tl, 512, 512)
        return
    codes = {"int4": torch.zeros(1, 512, 256, dtype=torch.uint8),
             "int8": torch.zeros(1, 512, 512, dtype=torch.int8)}
    for ok_rank, ok_fmt in ((32, "int4"), (32, "int8"), (64, "int4"),
                            (64, "int8"), (128, "int8")):
        check_kernel_form(torch.zeros(512, ok_rank), {"R": codes[ok_fmt]},
                          512, 512)
    with pytest.raises(NotImplementedError, match=item):
        check_kernel_form(P, {"R": codes[fmt[0]]}, 512, 512)


def test_chip_smoke_holds_each_run_to_its_kernels():
    """``chip_smoke.kernel_counts`` reads every training kernel's launches
    (``dense_phase`` by bias form) and zeroes them on ``reset``;
    ``expect_kernels`` fails a run that missed a wanted kernel or launched
    any other."""
    import chip_smoke as cs

    saved = (sgd_sweep.launches, sgd_sweep_time.launches,
             dict(dense_phase.form_launches), sgd_sweep.bf16_launches,
             dict(dense_phase.echo_launches))
    forms = ("lane", "frozen", "none")
    try:
        counts = cs.kernel_counts(reset=True)
        assert set(counts) == (
            set(cs.TRAIN_KERNELS) | {f"{k}:bf16" for k in cs.BF16_KERNELS}
            | {f"dense_phase:{f}" for f in forms}
            | {f"dense_phase:{f}:echo" for f in forms})
        assert not any(counts.values())
        sgd_sweep.launches, dense_phase.form_launches["frozen"] = 3, 2
        counts = cs.kernel_counts()
        cs.expect_kernels("run", counts, {"sgd_sweep", "dense_phase:frozen"})
        for want in ({"sgd_sweep"}, {"sgd_sweep", "dense_phase:frozen",
                                     "sgd_sweep_time"}):
            with pytest.raises(AssertionError, match="not the expected"):
                cs.expect_kernels("run", counts, want)
        # the bf16 and echo launches count as kernels of their own
        sgd_sweep.bf16_launches, dense_phase.echo_launches["lane"] = 3, 1
        counts = cs.kernel_counts()
        with pytest.raises(AssertionError, match="not the expected"):
            cs.expect_kernels("run", counts,
                              {"sgd_sweep", "dense_phase:frozen"})
        cs.expect_kernels("run", counts, {
            "sgd_sweep", "sgd_sweep:bf16", "dense_phase:frozen",
            "dense_phase:lane:echo"})
    finally:
        sgd_sweep.launches, sgd_sweep_time.launches = saved[:2]
        dense_phase.form_launches = saved[2]
        sgd_sweep.bf16_launches = saved[3]
        dense_phase.echo_launches = saved[4]


def test_chip_smoke_sums_limit_scales_with_the_largest_sum():
    """``chip_smoke.sums_limit``: sqrt(terms) float32 spacings at a sum
    tensor's largest magnitude (``ulps``), never more than TOL."""
    import chip_smoke as cs

    assert cs.ulps(torch.tensor([300.0, -2.0])) == 2.0 ** -15
    assert cs.ulps(torch.tensor([-0.75, 0.5])) == 2.0 ** -24
    assert cs.sums_limit(torch.tensor([40.0, -3.0]), 256) == 16 * 2.0 ** -18
    assert cs.sums_limit(torch.tensor([-3000.0]), 1024) == cs.TOL


def test_tile_topk_cuda_route_reaches_no_plain_version():
    """``tile_topk`` and both launches (the register-list form and the
    deep form of any depth or tile) hold no ``try``, and the plain version
    is called only under ``if dev.type == "cpu"``: on the card a deep
    depth (64) launches its kernel or raises (``tests/test_torch_gpu.py::
    test_tile_topk_deep_form_raises_when_the_library_fails`` makes the
    library fail there)."""
    import ast

    tree = ast.parse((ROOT / "mfx_torch" / "kernels" / "serve_topk.py")
                     .read_text())
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for name in ("tile_topk", "_launch", "_launch_deep"):
        fn = defs[name]
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], name
        cpu_only = set()
        for branch in (n for n in ast.walk(fn) if isinstance(n, ast.If)):
            if ast.unparse(branch.test) == "dev.type == 'cpu'":
                cpu_only.update(id(n) for stmt in branch.body
                                for n in ast.walk(stmt))
        plain = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and "plain" in ast.unparse(n.func)]
        assert all(id(n) in cpu_only for n in plain), name
        assert bool(plain) == (name == "tile_topk"), name
    calls = {ast.unparse(n.func) for n in ast.walk(defs["tile_topk"])
             if isinstance(n, ast.Call)}
    assert {"_launch", "_launch_deep"} <= calls
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        P = torch.zeros(16, 72, device="cuda")
        tile_topk(P, torch.zeros(4096, 72, device="cuda"), tile=1024,
                  depth=64)


@pytest.mark.parametrize("device", ["cuda", "meta"])
def test_bf16_row_add_has_no_fallback(device):
    """bf16 tables' scatter-add launches csrc/row_add_bf16.cu or raises
    off the CPU: on a missing card (RuntimeError / AssertionError) and on
    a device with no kernel (ValueError)."""
    from mfx_torch.kernels.packing import bf16_row_add, row_add

    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_gpu.py runs")
    want = (ValueError,) if device == "meta" else (RuntimeError,
                                                   AssertionError)
    for fn in (row_add, bf16_row_add):
        with pytest.raises(want):
            t = torch.zeros(8, 4, dtype=torch.bfloat16, device=device)
            fn(t, torch.zeros(3, dtype=torch.long, device=device),
               torch.zeros(3, 4, dtype=torch.bfloat16, device=device))
