"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``<repo>/build/kernels``
and loaded with ``ctypes``.  The library name carries a hash of the sources,
so an edited kernel rebuilds and a stale one is never loaded.  Nothing is
built at import time: :func:`load` builds on a kernel's first launch, and
:func:`build` lets a caller start every kernel's ``nvcc`` at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

KERNELS = ("filtered_agg", "block_agg")

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of csrc/block_reduce.cuh
DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.bool: 2}
ABSENT = -1

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (register and spill counts from -Xptxas=-v) and wall seconds
# of each build this process ran, for chip_smoke.py to print
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "filtered_agg_launch": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _I,
                            _P, _P, _I, _I, _P, _P, _P],
    "block_agg_launch": [_P, _I, _P, _P, _I, _I, _P, _P],
}


def _sources(name: str) -> Sequence[Path]:
    return (_KERNELS_DIR / name / "csrc" / f"{name}.cu",
            _KERNELS_DIR / "csrc" / "block_reduce.cuh")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _sources(name):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def build(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes started together; returns each kernel's library path."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_sources(n)[0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        build_seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            launch = getattr(lib, f"{name}_launch")
            launch.argtypes = _SIGNATURES[f"{name}_launch"]
            launch.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        "(float32, int32 or bool)")
    return code
