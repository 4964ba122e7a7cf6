"""ctypes loader for the native combinatorics kernel (edcore.cpp).

Compiles lazily with g++ on first import; callers (fock.py) fall back to the
pure-numpy implementations if the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from math import comb

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libedcore.so")
_SRC = os.path.join(_DIR, "edcore.cpp")

_lib = None


def _build() -> None:
    # a temporary name of this process's own: concurrent first builds (one
    # per pytest-xdist worker) must not write or rename each other's file
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or \
            os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        _build()
    lib = ctypes.CDLL(_SO)
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.spin_states.restype = ctypes.c_int64
    lib.spin_states.argtypes = [ctypes.c_int, ctypes.c_int, i64p]
    lib.rank_states.restype = None
    lib.rank_states.argtypes = [i64p, ctypes.c_int64, ctypes.c_int, i64p]
    lib.hop_coo.restype = ctypes.c_int64
    lib.hop_coo.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, i64p, i64p, f64p]
    lib.ladder_coo.restype = ctypes.c_int64
    lib.ladder_coo.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, i64p, i64p, f64p]
    _lib = lib
    return lib


def spin_states(ns: int, n: int) -> np.ndarray:
    lib = _load()
    out = np.empty(comb(ns, n), dtype=np.int64)
    cnt = lib.spin_states(ns, n, out)
    return out[:cnt]


def rank_states(states: np.ndarray, ns: int) -> np.ndarray:
    lib = _load()
    states = np.ascontiguousarray(states, dtype=np.int64)
    out = np.empty(states.size, dtype=np.int64)
    lib.rank_states(states.ravel(), states.size, ns, out)
    return out.reshape(states.shape)


def hop_coo(ns: int, n: int, i: int, j: int):
    lib = _load()
    cap = comb(ns, n)
    rows = np.empty(cap, dtype=np.int64)
    cols = np.empty(cap, dtype=np.int64)
    sgn = np.empty(cap, dtype=np.float64)
    nnz = lib.hop_coo(ns, n, i, j, rows, cols, sgn)
    return rows[:nnz], cols[:nnz], sgn[:nnz].astype(np.int64)


def ladder_coo(ns: int, n: int, i: int, dagger: bool):
    lib = _load()
    cap = comb(ns, n)
    rows = np.empty(cap, dtype=np.int64)
    cols = np.empty(cap, dtype=np.int64)
    sgn = np.empty(cap, dtype=np.float64)
    nnz = lib.ladder_coo(ns, n, i, int(dagger), rows, cols, sgn)
    return rows[:nnz], cols[:nnz], sgn[:nnz].astype(np.int64)
