"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded through ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``kernels/_build/lib<name>-<hash>.so`` (gitignored); the hash of the source,
of every ``csrc/`` header it includes (``#include "..."``, followed
recursively) and of the flags names the file, so an edited source or header
rebuilds and an unchanged one is reused. Builds happen at first use, never
at import. The sources need no link flag: the tensor-map encoder is taken
from the driver at run time (``cudaGetDriverEntryPointByVersion``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# -fmad=false: the TwoSum epilogues must not be contracted into FMAs.
# Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "dmft_ed_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> list:
    """csrc/<name>.cu and every csrc/ file it includes with quotes,
    followed recursively, in the order first reached."""
    todo, seen = [os.path.join(CSRC, name + ".cu")], []
    while todo:
        path = os.path.normpath(todo.pop(0))
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as fh:
            for inc in _INCLUDE.findall(fh.read()):
                cand = os.path.join(os.path.dirname(path), inc.decode())
                if os.path.exists(cand):
                    todo.append(cand)
    return seen


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        with open(path, "rb") as fh:
            h.update(os.path.relpath(path, CSRC).encode() + b"\0"
                     + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; returns the path.
    Returns the ptxas report in ``<path>.log``."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    with open(out + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu (building it on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
