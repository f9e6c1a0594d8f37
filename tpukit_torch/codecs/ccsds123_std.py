# -*- coding: utf-8 -*-
# The port's copy of tpukit/codecs/ccsds123_std.py: only its imports point at the port.
"""CCSDS 123.0-B standard-mode bindings: the Blue Book's sample-adaptive
predictor + sample-adaptive GPO2 coder (native/src/ccsds123std.cpp).

This is the standard-conformant path the reference exercises through the
CNES enc123/dec123 binaries (reference tools/codecs/ccsds123/
ccsds123_wrap.py:8, :111-112); tpukit's TPU-first LS predictor
(ccsds123_codec.encode_model) remains the default. The per-sample weight
update is serial in raster order, so this path runs in-process C++ like
tpukit's other bit-exact sequential coders.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpukit_torch.native import load as load_native


def subframe_for_order(order: str, bands: int) -> int:
    """Map an interleave name to the §4.2 sub-frame depth M: BSQ -> 0
    (band-sequential), BIL -> 1, BIP -> Nz (full band interleaving)."""
    order = (order or "bsq").lower()
    if order == "bsq":
        return 0
    if order == "bil":
        return 1
    if order == "bip":
        return int(bands)
    raise ValueError(f"order must be bsq|bil|bip, got {order!r}")


def encode(cube: np.ndarray, is_signed: bool, D: int = 16, P: int = 3,
           full_mode: bool = True, colsum: bool = False,
           order: str = "bsq", subframe: int = None,
           entropy: str = "sample") -> bytes:
    """(B, H, W) uint16-viewed BSQ-laid-out cube -> CCSDS 123.0-B stream.

    ``order`` selects the ENCODING order (§4.2; the reference wrapper's
    --interleave, ccsds123_wrap.py:116): bsq | bil | bip. ``subframe``
    overrides it with an explicit BI sub-frame depth M in [1, B].
    ``entropy`` selects the coder: 'sample' (sample-adaptive GPO2) or
    'block' (§5.4.2 — the CCSDS-121 block-adaptive coder over the mapped
    residual sequence, no preprocessor; needs D >= 5)."""
    if entropy not in ("sample", "block"):
        raise ValueError(f"entropy must be sample|block, got {entropy!r}")
    lib = load_native()
    cube = np.ascontiguousarray(cube, np.uint16)
    B, H, W = cube.shape
    M = subframe_for_order(order, B) if subframe is None else int(subframe)
    cap = 19 + cube.size * 4 + 4096    # worst case ~2x expansion headroom
    out = np.empty(cap, np.uint8)
    n = lib.ck123std_encode(
        cube.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        B, H, W, int(D), int(bool(is_signed)), int(P),
        int(bool(full_mode)), int(bool(colsum)), M,
        int(entropy == "block"),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError("ccsds123 standard encode failed")
    return out[:n].tobytes()


def stream_info(stream: bytes) -> dict:
    """Parse the §5.3 header: geometry + key parameters."""
    lib = load_native()
    buf = np.frombuffer(stream, np.uint8)
    info = np.zeros(11, np.int32)
    if lib.ck123std_info(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
            info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))) != 0:
        raise ValueError("bad CCSDS-123 header")
    M, B = int(info[9]), int(info[0])
    order = ("bsq" if M == 0 else "bil" if M == 1
             else "bip" if M >= B else f"bi{M}")
    return {"bands": B, "height": int(info[1]),
            "width": int(info[2]), "D": int(info[3]),
            "signed": bool(info[4]), "P": int(info[5]),
            "full_mode": bool(info[6]), "column_sums": bool(info[7]),
            "umax": int(info[8]), "subframe": M, "order": order,
            "entropy": "block" if info[10] else "sample"}


def decode(stream: bytes) -> np.ndarray:
    """CCSDS 123.0-B stream -> (B, H, W) uint16-viewed BSQ cube."""
    lib = load_native()
    info = stream_info(stream)
    B, H, W = info["bands"], info["height"], info["width"]
    buf = np.frombuffer(stream, np.uint8)
    out = np.zeros((B, H, W), np.uint16)
    got = lib.ck123std_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size)
    if got != out.size:
        raise RuntimeError("ccsds123 standard decode failed")
    return out
