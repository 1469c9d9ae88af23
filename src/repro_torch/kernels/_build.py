"""Build and load the port's hand-written CUDA kernels.

Each library is one ``.cu`` file with a plain C interface (``<package>/csrc/
<name>.cu``; a backward lives beside its forward's package), compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``<repo>/build/kernels``
and loaded with ``ctypes``.  The library name carries a hash of the sources,
so an edited kernel rebuilds and a stale one is never loaded.  Nothing is
built at import time: :func:`load` builds on a kernel's first launch, and
:func:`build` lets a caller start every kernel's ``nvcc`` at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

# each library and the shared headers of csrc/ that its .cu includes
HEADERS = {"filtered_agg": ("block_reduce.cuh",), "block_agg": ("block_reduce.cuh",),
           "flash_attn": ("float_io.cuh", "hopper.cuh", "tma_map.cuh"),
           "gla_chunk": ("float_io.cuh", "gla_tiles.cuh"),
           "segment_sum": ("block_reduce.cuh",), "taqa_solve": ("look_back.cuh",),
           "block_draw": ("look_back.cuh",),
           "flash_attn_bwd": ("float_io.cuh", "hopper.cuh", "tma_map.cuh"),
           "gla_chunk_bwd": ("float_io.cuh", "gla_tiles.cuh")}
KERNELS = tuple(HEADERS)
# the package directory of a library whose name is not its package's
PACKAGE = {"flash_attn_bwd": "flash_attn", "gla_chunk_bwd": "gla_chunk"}

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of csrc/block_reduce.cuh (the column kernels)
DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.bool: 2}
ABSENT = -1
# dtype codes of csrc/float_io.cuh (the model kernels: f32 or bf16 in, f32
# arithmetic, the input's dtype out)
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 3}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (register and spill counts from -Xptxas=-v) and wall seconds
# of each build this process ran, for chip_smoke.py to print
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
_U = ctypes.c_uint64
_D = ctypes.c_double
# Every function each library exports, with its ctypes signature.  Each one
# needs its argtypes set: without them ctypes passes a Python int as a 32-bit
# C int, which cuts a device pointer and faults on the card.
_SIGNATURES = {
    "filtered_agg": {
        "filtered_agg_launch": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _I,
                                _P, _P, _I, _I, _I, _I, _P, _P, _P],
        "column_floor_launch": [_I, _I, _P],
    },
    "block_agg": {
        "block_agg_launch": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    },
    "flash_attn": {
        "flash_attn_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _F, _I, _I, _P],
    },
    "flash_attn_bwd": {
        "flash_attn_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _F, _I, _I, _P],
        "flash_attn_bwd_tile_rows": [_I, _I, _P, _P],
    },
    "gla_chunk": {
        "gla_chunk_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _P],
    },
    "gla_chunk_bwd": {
        "gla_chunk_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "segment_sum": {
        "segment_sum_keys_launch": [_P, _L, _L, _P, _P],
        "segment_sum_launch": [_P, _P, _P, _L, _L, _I, _L, _P, _P, _P, _P,
                               _P, _L, _P, _P],
        "segment_sum_slab_launch": [_P, _P, _L, _I, _L, _L, _L, _I, _P, _P],
        "segment_sum_few_launch": [_P, _P, _L, _I, _L, _L, _I, _P, _P, _P],
    },
    "taqa_solve": {
        "taqa_solve_rate_launch": [_P, _L, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P],
        "taqa_draw_compact_launch": [_P, _L, _P, _P, _P, _P, _P],
    },
    "block_draw": {
        "block_draw_launch": [_U, _U, _U, _U, _D, _L, _P, _I, _P, _P, _P],
    },
}

# What ``load`` checks in a library before it hands it out: (module, function
# of the library) that raises where the library and its wrapper's host-side
# copy of its launch shapes differ.
LOAD_CHECKS = {"flash_attn_bwd": ("repro_torch.kernels.flash_attn.ops", "check_tile_rows")}

# Launch counters of the wrappers are bumped under this lock: drain workers
# launch from several threads, and ``fn.launches += 1`` is a read-modify-write
# that would lose updates between them.
_count_lock = threading.Lock()

# the column kernels' grid carries the lane (id row) in blockIdx.y
MAX_BATCH = 65_535


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def count(fn, attr: str) -> None:
    """Add one to the counter attribute ``attr`` of wrapper ``fn``."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def _sources(name: str) -> Sequence[Path]:
    """The kernel's ``.cu`` first, then the shared headers it includes."""
    return (_KERNELS_DIR / PACKAGE.get(name, name) / "csrc" / f"{name}.cu",
            *(_KERNELS_DIR / "csrc" / h for h in HEADERS[name]))


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
        paths[n].with_suffix(".log").write_text(out)
        os.replace(tmp, paths[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output for kernel ``name``'s library, built now or by an
    earlier process (kept beside the library)."""
    if name in build_logs:
        return build_logs[name]
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use and held to
    its ``LOAD_CHECKS`` entry, if any, before it is kept."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            if name in LOAD_CHECKS:
                module, fn_name = LOAD_CHECKS[name]
                getattr(importlib.import_module(module), fn_name)(lib)
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


def float_code(t: torch.Tensor, what: str) -> int:
    code = FLOAT_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    return code
