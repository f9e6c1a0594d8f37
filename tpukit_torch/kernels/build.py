# -*- coding: utf-8 -*-
"""Build and load the port's CUDA kernels.

The sources in ``tpukit_torch/csrc/*.cu`` compile with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and link into
one shared library with a plain C interface, loaded with ctypes. The
library is built with ``--fmad=false``: no multiply and add is contracted
into an FMA, which the 9/7 DWT's rounding contract needs (csrc/dwt97.cu).
As the port's host C++ runtime does (tpukit_torch/native/__init__.py), the
library is keyed by a digest of the sources and flags, built at first use
into ``tpukit_torch/csrc/build/`` and older builds are pruned. Nothing here
runs at import: only a machine with the CUDA toolkit builds, and the CPU
tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default
    /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed (set CUDA_HOME)")


def build_library(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into a cached shared library; returns its path.
    Each source compiles in its own ``nvcc`` process, all at once, and the
    objects link in one more. A fresh build echoes nvcc's register and
    shared-memory report (``-Xptxas -v``) to stderr."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libtpukit_torch_{_source_digest()}.so"
    if lib_path.exists() and not force:
        return lib_path
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{p.stem}.o" for p in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(_sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        sys.stderr.write(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = BUILD_DIR / (lib_path.name + ".tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({' '.join(link)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib_path)
    for old in BUILD_DIR.glob("libtpukit_torch_*.so"):
        if old != lib_path:
            old.unlink(missing_ok=True)
    for o in objs:
        o.unlink(missing_ok=True)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built if needed. Thread-safe, cached."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.tpk_fs_table.restype = ctypes.c_int
            lib.tpk_fs_table.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.tpk_dwt97_tile.restype = ctypes.c_int
            lib.tpk_dwt97_tile.argtypes = [
                ptr, i64, i64, i32, i32, i32, ptr, i64, i64, ptr, i64, i64,
                i32, ptr]
            lib.tpk_dwt97_tail.restype = ctypes.c_int
            lib.tpk_dwt97_tail.argtypes = [
                ptr, i64, i64, i32, i32, i32, i32, ptr, i64, i64, i32, ptr]
            lib.tpk_error_string.restype = ctypes.c_char_p
            lib.tpk_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
        return _LIB
