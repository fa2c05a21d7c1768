"""Native (C++) graph builders, compiled with g++ and bound via ctypes.

A copy of ``dgl1_tpu/_native``'s loader for the entry points the port
uses: the layout builders (``build_adj``, ``plan_ell``, ``fill_ell``,
``plan_tiles``, ``build_tiles``) and the fused neighbor sampler
(``sample_block``). The library is compiled on first use into
``dgl1_tpu_torch/_build/`` (keyed by a hash of the source). Every layout
builder keeps a pure numpy fallback for when it is missing; the sampler
has none yet and raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["lib", "BUILD_DIR"]

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_LIB = None
_TRIED = False


def _compile() -> ctypes.CDLL:
    src = Path(__file__).parent / "graph_builder.cpp"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"graph_builder_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".so.tmp{os.getpid()}")
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               str(src), "-o", str(tmp)]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.build_adj.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32,
                              i32p, i32p, i32p, i32p]
    lib.build_adj.restype = None
    lib.plan_ell.argtypes = [i32p, ctypes.c_int32, ctypes.c_int64,
                             ctypes.c_int64, i64p, i64p, i64p]
    lib.plan_ell.restype = ctypes.c_int32
    lib.fill_ell.argtypes = [i32p, i32p, i32p, ctypes.c_int32,
                             ctypes.c_int64, ctypes.c_int64, i32p, i32p,
                             i32p]
    lib.fill_ell.restype = None
    lib.plan_tiles.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_int32, ctypes.c_int32]
    lib.plan_tiles.restype = ctypes.c_int64
    lib.build_tiles.argtypes = [i32p, i32p, i32p, ctypes.c_int64,
                                ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, i32p, i32p, i32p, i32p, i32p]
    lib.build_tiles.restype = None
    lib.sample_block.argtypes = [i32p, i32p, i32p, ctypes.c_int32, i64p,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int32, ctypes.c_uint64,
                                 ctypes.c_int64, ctypes.c_int64, i32p, i32p,
                                 i32p, i64p, i64p]
    lib.sample_block.restype = ctypes.c_int32
    return lib


def lib() -> Optional[ctypes.CDLL]:
    """The native library, or None when it cannot be built."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        _LIB = _compile()
    except (OSError, subprocess.CalledProcessError):
        _LIB = None
    return _LIB
