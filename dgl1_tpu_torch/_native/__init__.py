"""Native (C++) graph builders, compiled with g++ and bound via ctypes.

A copy of ``dgl1_tpu/_native``'s loader for the entry points the port
uses: the layout builders (``build_adj``, ``plan_ell``, ``fill_ell``,
``plan_tiles``, ``build_tiles``), the fused neighbor sampler
(``sample_block``) and the feature store's threaded row gather
(:func:`gather_rows`). The library is compiled on first use into
``dgl1_tpu_torch/_build/`` (keyed by a hash of the source). Every layout
builder and the row gather keep a numpy fallback for when it is missing;
without it ``NeighborSampler`` takes the numpy sampler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["lib", "gather_rows", "BUILD_DIR"]

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
    lib.gather_rows.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_int32]
    lib.gather_rows.restype = None
    return lib


def gather_rows(src: np.ndarray, ids: np.ndarray, num_threads: int = 8,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """``out[i] = src[ids[i]]`` by a threaded row memcpy (numpy's
    ``take`` without the native library or for a non-contiguous ``src``).
    ``src`` is any C-contiguous array of rows, a ``np.memmap`` included;
    ``out``, when given, is a C-contiguous (len(ids), ...) array of its
    type (a pinned staging buffer, say). An id out of range raises
    IndexError."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= len(src)):
        raise IndexError(f"row id out of range [0, {len(src)})")
    if out is None:
        out = np.empty((len(ids),) + src.shape[1:], dtype=src.dtype)
    native = lib()
    if native is None or not src.flags.c_contiguous or len(ids) == 0:
        if len(ids):
            np.take(src, ids, axis=0, out=out)
        return out
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    native.gather_rows(src.ctypes.data, ids, len(ids), row_bytes,
                       out.ctypes.data, num_threads)
    return out


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
