"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` compiles to one shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``) in ``dgl1_tpu_torch/_build/``, named by a hash of the
source and the flags, so a changed source rebuilds and an unchanged one
is reused. ``build()`` starts one nvcc per missing library, all at once,
and waits for them. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["SOURCES", "build", "load", "nvcc_path", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
SOURCES = {"hub_kernels": _PKG / "csrc" / "hub_kernels.cu",
           "attn_kernels": _PKG / "csrc" / "attn_kernels.cu",
           "tile_kernels": _PKG / "csrc" / "tile_kernels.cu",
           "bdense_kernels": _PKG / "csrc" / "bdense_kernels.cu"}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_int, _ptr, _f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
# C signatures: every pointer and the stream as c_void_p, ints as c_int,
# floats as c_float.
_SIGNATURES = {
    "attn_kernels": {
        "attn_fwd_scratch": [_c_int] * 10,
        "attn_fwd": [_ptr, _ptr, _ptr, _ptr, _ptr, _c_int, _c_int, _ptr,
                     _c_int, _ptr, _ptr, _c_int, _c_int, _c_int, _c_int,
                     _c_int, _c_int, _f, _ptr, _c_int, _f, _c_int, _ptr,
                     _c_int, _ptr, _ptr, _ptr, _ptr, _ptr],
        "attn_bwd_src": [_ptr, _ptr, _ptr, _ptr, _ptr, _c_int, _c_int,
                         _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _c_int, _c_int,
                         _f, _ptr, _c_int, _f, _c_int, _c_int, _ptr, _ptr,
                         _ptr, _ptr],
        "attn_grp_scratch": [_c_int] * 12,
        "attn_bwd_grp": [_ptr, _ptr, _ptr, _ptr, _ptr, _c_int, _c_int,
                         _ptr, _c_int, _ptr, _ptr, _ptr, _ptr, _ptr, _c_int,
                         _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                         _c_int, _c_int, _f, _ptr, _c_int, _f, _c_int,
                         _c_int, _ptr, _ptr, _ptr],
        "attn_ger_scratch": [_c_int] * 3,
        "attn_ger_reduce": [_ptr, _ptr, _c_int, _c_int, _ptr, _c_int, _ptr,
                            _ptr, _ptr],
    },
    "hub_kernels": {
        "hub_dense_fwd": [_ptr, _c_int, _ptr, _ptr, _c_int, _c_int, _c_int,
                          _c_int, _c_int, _ptr],
        "hub_dense_bwd": [_ptr, _c_int, _ptr, _ptr, _c_int, _c_int, _c_int,
                          _ptr, _ptr, _ptr, _c_int, _ptr],
        "hub_chunk_sum": [_ptr, _ptr, _ptr, _ptr, _c_int, _c_int, _ptr,
                          _c_int, _c_int, _ptr, _c_int, _c_int, _c_int, _ptr],
        "hub_expand": [_ptr, _ptr, _ptr, _c_int, _ptr, _c_int, _c_int, _ptr,
                       _c_int, _c_int, _ptr, _c_int, _ptr],
        "hub_chunk_weighted": [_c_int, _ptr, _ptr, _ptr, _ptr, _ptr, _c_int,
                               _c_int, _ptr, _c_int, _c_int, _c_int, _ptr,
                               _c_int, _c_int, _ptr, _c_int, _c_int, _c_int,
                               _ptr],
        "hub_edge_grad": [_c_int, _ptr, _ptr, _ptr, _ptr, _c_int, _c_int,
                          _ptr, _c_int, _c_int, _ptr, _c_int, _c_int, _ptr,
                          _c_int, _c_int, _c_int, _c_int, _ptr],
    },
    "bdense_kernels": {
        "block_mm": [_c_int, _c_int, _ptr, _ptr, _ptr, _ptr, _c_int, _c_int,
                     _ptr, _c_int, _c_int, _c_int, _c_int, _ptr],
    },
    "tile_kernels": {
        "tile_sum": [_ptr, _ptr, _ptr, _c_int, _ptr, _ptr, _c_int, _c_int,
                     _ptr, _c_int, _c_int, _c_int, _c_int, _ptr],
        "tile_minmax": [_c_int, _ptr, _ptr, _ptr, _c_int, _ptr, _ptr, _c_int,
                        _c_int, _ptr, _c_int, _c_int, _c_int, _c_int, _ptr],
        "tile_warps": [],
    },
}

# Entries that return other than an int error code.
_RESTYPES = {"attn_fwd_scratch": ctypes.c_longlong,
             "attn_grp_scratch": ctypes.c_longlong,
             "attn_ger_scratch": ctypes.c_longlong}

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc output) of builds made by this process.
BUILD_LOG: Dict[str, tuple] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[list] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    nvcc process each, started together. Raises with nvcc's output when a
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, so in paths.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, so)
    errors = []
    for n, (p, tmp, so) in procs.items():
        out, _ = p.communicate()
        BUILD_LOG[n] = (time.perf_counter() - t0, out)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]}:\n{out}")
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
        _LIBS[name] = lib
    return lib
