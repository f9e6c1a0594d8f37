# -*- coding: utf-8 -*-
# The port's copy of tpukit/io/raw.py: only its imports point at the port.
"""RAW interleave conversion (bip/bil/bsq) with explicit endianness.

Array-level equivalents of the reference's file-based converters
(reference tools/codecs/ccsds121/ccsds121_wrap.py:44-65,
tools/codecs/ccsds123/ccsds123_wrap.py:43-63). In tpukit the cube never
leaves memory — these exist for raw import/export interoperability and
for the optional reference-shell wrappers.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_DTYPES = {"uint16": np.dtype("<u2"), "int16": np.dtype("<i2"), "uint8": np.dtype("u1")}


def np_dtype(dtype_str: str) -> np.dtype:
    try:
        return _DTYPES[dtype_str]
    except KeyError:
        raise ValueError(f"Unsupported dtype: {dtype_str}")


def bsq_to_interleaved(cube_bsq: np.ndarray, interleave: str) -> np.ndarray:
    """(B,H,W) -> flat view in bip/bil/bsq order (C-contiguous copy)."""
    if interleave == "bsq":
        return np.ascontiguousarray(cube_bsq)
    if interleave == "bil":
        return np.ascontiguousarray(np.moveaxis(cube_bsq, 0, 1))  # (H,B,W)
    if interleave == "bip":
        return np.ascontiguousarray(np.moveaxis(cube_bsq, 0, -1))  # (H,W,B)
    raise ValueError("interleave must be one of: bsq, bil, bip")


def interleaved_to_bsq(arr: np.ndarray, interleave: str, B: int, H: int, W: int) -> np.ndarray:
    flat = np.asarray(arr).reshape(-1)
    if flat.size != B * H * W:
        raise RuntimeError("Unexpected RAW size")
    if interleave == "bsq":
        return flat.reshape(B, H, W)
    if interleave == "bil":
        return np.moveaxis(flat.reshape(H, B, W), 1, 0)
    if interleave == "bip":
        return np.moveaxis(flat.reshape(H, W, B), -1, 0)
    raise ValueError("interleave must be one of: bsq, bil, bip")


def write_raw(cube_bsq: np.ndarray, interleave: str, out_path, dtype_str: str) -> Path:
    out_path = Path(out_path)
    dt = np_dtype(dtype_str)
    bsq_to_interleaved(cube_bsq, interleave).astype(dt, copy=False).tofile(out_path)
    return out_path


def read_raw(in_path, interleave: str, dtype_str: str, B: int, H: int, W: int) -> np.ndarray:
    dt = np_dtype(dtype_str)
    arr = np.fromfile(in_path, dtype=dt)
    return interleaved_to_bsq(arr, interleave, B, H, W)
