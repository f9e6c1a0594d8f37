# -*- coding: utf-8 -*-
"""The port's host C++ runtime: entropy coders and bit packers, via ctypes.

The port's copy of tpukit/native/__init__.py. The sources in
``tpukit_torch/native/src`` are a verbatim copy of tpukit's; they compile
with g++ at first use into ``tpukit_torch/native/build/`` (gitignored),
keyed by a digest of the sources and flags, and older builds are pruned.
The port uses the CCSDS-121 coder (``native.ccsds121_host``), the JPEG
2000 tier-1 analysis, synthesis and decoder (``io.j2c_enc``, ``io.jp2``),
the CCSDS-123 standard coder, JPEG-LS, the PNG filters, the embedded
bit-plane and run-length coders (``codecs.wavelet_common``) and the
CCSDS-122 BPE (``codecs.bpe122``). Two processes
that build at once (test workers) take turns on a lock file in the build
directory, so the library is compiled once and never read half-written.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC_DIR = Path(__file__).parent / "src"
_BUILD_DIR = Path(__file__).parent / "build"
_LOCK = threading.Lock()
_LIB = None

_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
             "-fno-math-errno", "-ffp-contract=off", "-Wall"]


def _source_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(_SRC_DIR.glob("*.[ch]pp")) + sorted(_SRC_DIR.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_CXXFLAGS).encode())
    return h.hexdigest()[:16]


def build_library(force: bool = False) -> Path:
    """Compile tpukit_torch/native/src/*.cpp into a cached shared library."""
    _BUILD_DIR.mkdir(exist_ok=True)
    digest = _source_digest()
    lib_path = _BUILD_DIR / f"libtpukit_{digest}.so"
    if lib_path.exists() and not force:
        return lib_path
    with open(_BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists() and not force:
            return lib_path     # another process built it meanwhile
        sources = [str(p) for p in sorted(_SRC_DIR.glob("*.cpp"))]
        if not sources:
            raise RuntimeError("No native sources found")
        cmd = ["g++", *_CXXFLAGS, "-o", str(lib_path) + ".tmp", *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed:\n{proc.stderr}")
        os.replace(str(lib_path) + ".tmp", lib_path)
        # prune stale builds
        for old in _BUILD_DIR.glob("libtpukit_*.so"):
            if old != lib_path:
                try:
                    old.unlink()
                except OSError:
                    pass
    return lib_path


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library. Thread-safe, cached."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(str(build_library()))
            _declare(_LIB)
        return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    import ctypes as ct
    u8p = ct.POINTER(ct.c_uint8)
    u16p = ct.POINTER(ct.c_uint16)
    u32p = ct.POINTER(ct.c_uint32)
    i32p = ct.POINTER(ct.c_int32)
    i64p = ct.POINTER(ct.c_int64)
    f64p = ct.POINTER(ct.c_double)
    f32p = ct.POINTER(ct.c_float)
    i64 = ct.c_longlong
    i32 = ct.c_int

    for name, restype, argtypes in [
        ("ck121_encode", i64, [u16p, i64, i32, i32, i32, i32, u8p, i64]),
        ("ck121_encode_seg", i64, [u16p, i64, i32, i32, i32, i32, i32, u8p, i64]),
        ("ck121_quant_encode", i64, [f32p, f32p, ct.c_float, i32p, i64,
                                     i32, i32, i32, i32, u8p, i64, u32p]),
        ("ck121_splice", None, [u8p, i64, u8p, i64]),
        ("ck121_decode", i64, [u8p, i64, i32, i32, i32, i32, u16p, i64]),
        ("ck121_decode_seg", i64, [u8p, i64, i64, i32, i32, i32, i32,
                                   u16p, i64]),
        ("bitpack_concat", i64, [u32p, u8p, i64, i64, u8p, i64]),
        ("jls_encode", i64, [u16p, i32, i32, i32, i32, u8p, i64]),
        ("jls_decode", i64, [u8p, i64, u16p, i32, i32, ct.POINTER(i32), ct.POINTER(i32)]),
        ("bpc_encode", i64, [u32p, i64, u8p, i64, i64]),
        ("bpc_encode_quant", i64, [ct.POINTER(ct.c_float),
                                   ct.POINTER(ct.c_float), ct.c_float,
                                   u32p, i64, u8p, i64, i64, u32p]),
        ("bpc_decode", i64, [u8p, i64, u32p, i64]),
        ("wrle_size_bits", i64, [i32p, i64, ct.POINTER(i64), i32]),
        ("wrle_encode", i64, [i32p, i64, ct.POINTER(i64), i32, u8p, i64]),
        ("wrle_decode", i64, [u8p, i64, ct.POINTER(i64), i32, i32p, i64]),
        ("ck123_code", i64, [u32p, i64, i32, i32, u8p, i64]),
        ("ck123_decode", i64, [u8p, i64, i32, i32, u32p, i64]),
        ("tpukit_bpe122_encode", i64, [i32p, i64, i64, i64, i32, i32,
                                       i32, i32, u8p, i64]),
        ("tpukit_bpe122_decode", i64, [u8p, i64, i64, i32p]),
        ("tpukit_bpe122_decode_trace", i64, [u8p, i64, i64, i32p, i32p,
                                             i64]),
        ("j2k_t1_sig_plan", i64, [i32p, i32, i32, i32p]),
        ("j2k_pkt1_hdr_size", i64, [i32, i32p, i32p, i32p, i64p, i64p]),
        ("j2k_sr2d_97", i64, [f64p, i64, i64, i32, i32]),
        ("j2k_sr2d_53", i64, [i64p, i64, i64, i32, i32]),
        ("j2k_fd2d_97", i64, [f64p, i64, i64, i32, i32]),
        ("j2k_fd2d_53", i64, [i64p, i64, i64, i32, i32]),
        ("j2k_band_recon", i64, [i32p, i32p, ct.POINTER(ct.c_int8),
                                 ct.POINTER(ct.c_int8), i32p, i32p, i64,
                                 ct.c_double, i32, ct.c_void_p]),
        ("j2k_dequant_mid", i64, [i32p, i32p, i64, ct.c_double, f64p]),
        ("ck123std_encode", i64, [u16p, i32, i32, i32, i32, i32, i32,
                                  i32, i32, i32, i32, u8p, i64]),
        ("ck123std_info", i64, [u8p, i64, i32p]),
        ("ck123std_decode", i64, [u8p, i64, u16p, i64]),
    ]:
        try:
            fn = getattr(lib, name)
        except AttributeError:
            continue
        fn.restype = restype
        fn.argtypes = argtypes
