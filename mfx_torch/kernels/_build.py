"""Build and load the port's CUDA kernels.

``mfx_torch/csrc/*.cu`` compile with ``nvcc`` (one process per source, all
started together) and link into one shared library with a plain C
interface, at first use, under ``build/mfx_torch/`` beside the package. The library's name carries a hash of the sources' contents, so an
edited source rebuilds and a stale library is never loaded. The library is
loaded with ``ctypes``; pointers and the stream pass as ``c_void_p``.
Every C entry point returns ``cudaGetLastError()`` after its launches, and
``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["load_library", "check", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "mfx_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures (mirrored by the extern "C" definitions in csrc/)
_SIGNATURES = {
    "mfx_sgd_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _I, _F, _F, _F, _P],
    "mfx_sgd_sweep_max_blocks": [_I, _I],
    "mfx_sgd_sweep_time": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P],
    "mfx_sgd_sweep_time_max_blocks": [_I, _I],
    "mfx_dense_phase": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                        _F, _P],
    "mfx_dense_phase_max_blocks": [_I, _I],
    "mfx_tile_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mfx_bpr_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _I, _F, _F, _P],
    "mfx_bpr_sweep_max_blocks": [_I],
    "mfx_sgd_sweep_tile": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                           _P],
    "mfx_sgd_sweep_tile_max_blocks": [_I, _I],
    "mfx_sgd_sweep_step_u": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                             _F, _P],
    "mfx_sgd_sweep_step_u_max_blocks": [_I, _I, _I],
    "mfx_sgd_sweep_step_u_pool_floats": [_I, _I, _I],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _lib_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmfx_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH): "
            "the mfx_torch kernels are built from source with nvcc"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    out = _lib_path()
    if not out.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        # one nvcc per source, all at once, then one link
        procs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
            procs.append((obj, subprocess.Popen(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                 "-v", "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs, failed = [], []
        for obj, proc in procs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(logs[-1])
        objs = [str(obj) for obj, _ in procs]
        if not failed:
            res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                                 capture_output=True, text=True)
            logs.append(res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(logs[-1])
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
        (BUILD_DIR / "nvcc.log").write_text("".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
