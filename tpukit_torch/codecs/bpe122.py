# -*- coding: utf-8 -*-
# The port's copy of tpukit/codecs/bpe122.py: only its imports point at the port.
"""CCSDS 122.0-B segment-structured BPE: block organization + host coder
bindings.

The reference's CCSDS-122 path shells out to a user-supplied `bpe.exe`
per band with `-r {bpp}` rate control (reference
tools/codecs/ccsds122/ccsds122_wrap.py:110-133). tpukit's standard
backend codes the same 3-level 9/7M DWT pyramid through an in-framework
BPE (native/src/bpe122.cpp) with the standard's segment structure:
headers, gaggle-coded DC/depths, stages 0-4 bit-plane passes, and
SegByteLimit truncation.

This module owns what sits around the native coder:

* the BLOCK ORGANIZATION: each 8x8 image block maps to 1 DC (LL3) + 63
  AC coefficients — per family (HL, LH, HH): parent (level 3), 4
  children (level 2, 2x2 raster), 16 grandchildren (level 1) in four
  2x2 H-groups, gathered from the packed Mallat layout produced by
  kernels.dwt.dwt2. The gather index table is a permutation of the
  whole plane, so scattering back is its argsort.

* the standard's default subband weights for the integer DWT
  (CCSDS 122.0-B 3.6): power-of-two left-shifts per subband —
  LL3,HL3,LH3: 3; HH3,HL2,LH2: 2; HH2,HL1,LH1: 1; HH1: 0 — applied
  before coding and shifted back out after decode (exactly reversible).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np

from tpukit_torch.kernels import dwt as dwtk
from tpukit_torch.native import load as load_native

LEVELS = 3

# standard default weight EXPONENTS for the integer 9/7M DWT (§3.6)
WEIGHT_EXP = {"LL3": 3, "HL3": 3, "LH3": 3,
              "HH3": 2, "HL2": 2, "LH2": 2,
              "HH2": 1, "HL1": 1, "LH1": 1, "HH1": 0}

_IDX_CACHE: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
_WEXP_CACHE: Dict[Tuple[int, int], np.ndarray] = {}


def weight_exp_map(Hp: int, Wp: int) -> np.ndarray:
    """(Hp, Wp) int32 left-shift per coefficient of the packed layout."""
    key = (Hp, Wp)
    hit = _WEXP_CACHE.get(key)
    if hit is None:
        hit = np.empty((Hp, Wp), np.int32)
        for name, lv, sl in dwtk.subband_slices(Hp, Wp, LEVELS):
            hit[sl] = WEIGHT_EXP[name]
        _WEXP_CACHE[key] = hit
    return hit


def block_indices(Hp: int, Wp: int) -> Tuple[np.ndarray, np.ndarray]:
    """(gather, scatter): gather is (nblocks, 64) int32 flat indices into
    the packed (Hp, Wp) plane in BPE block/family order; scatter is the
    inverse permutation (flat plane index -> position in the block
    stream)."""
    key = (Hp, Wp)
    hit = _IDX_CACHE.get(key)
    if hit is not None:
        return hit
    if Hp % 8 or Wp % 8:
        raise ValueError("plane must be padded to multiples of 8")
    R, C = Hp // 8, Wp // 8
    r = np.arange(R)[:, None]                     # block rows
    c = np.arange(C)[None, :]                     # block cols

    def flat(rr, cc):
        return (rr * Wp + cc).astype(np.int64)

    cols = []
    cols.append(flat(r, c)[..., None])            # DC (LL3)
    # family origins in the packed layout: (row offset, col offset) of the
    # level-3 parent subband and the level-2 / level-1 detail subbands
    fams = [((0, Wp // 8), (0, Wp // 4), (0, Wp // 2)),          # HL
            ((Hp // 8, 0), (Hp // 4, 0), (Hp // 2, 0)),          # LH
            ((Hp // 8, Wp // 8), (Hp // 4, Wp // 4),
             (Hp // 2, Wp // 2))]                                # HH
    dyx = [(0, 0), (0, 1), (1, 0), (1, 1)]
    for (p_off, c_off, g_off) in fams:
        cols.append(flat(p_off[0] + r, p_off[1] + c)[..., None])
        for dy, dx in dyx:                        # children 2x2 raster
            cols.append(flat(c_off[0] + 2 * r + dy,
                             c_off[1] + 2 * c + dx)[..., None])
        for jy, jx in dyx:                        # H-groups follow children
            for ty, tx in dyx:                    # raster within the group
                cols.append(flat(g_off[0] + 4 * r + 2 * jy + ty,
                                 g_off[1] + 4 * c + 2 * jx + tx)[..., None])
    gather = np.concatenate(cols, axis=-1).reshape(R * C, 64)
    gather = gather.astype(np.int32)
    scatter = np.empty(Hp * Wp, np.int32)
    scatter[gather.reshape(-1)] = np.arange(Hp * Wp, dtype=np.int32)
    hit = (gather, scatter)
    _IDX_CACHE[key] = hit
    return hit


def bpe_encode_blocks(blocks: np.ndarray, seg_byte_limit: int = 0,
                      seg_size: int = 0, img_width: int = 0,
                      pad_rows: int = 0, pixel_bitdepth: int = 16,
                      signed_pixels: int = 0) -> bytes:
    """Encode (nblocks, 64) int32 WEIGHTED coefficients into a BPE
    stream. seg_byte_limit 0 = lossless/unbounded; seg_size 0 = one
    segment for the whole image."""
    lib = load_native()
    blocks = np.ascontiguousarray(blocks, np.int32)
    nblocks = blocks.shape[0]
    if seg_size <= 0:
        seg_size = min(nblocks, (1 << 20) - 1)
    # worst case: header + DC + depths + every plane of every coefficient
    # with full word/sign overhead; 8 bytes/coefficient is a safe roof
    cap = 64 * 20 + nblocks * 64 * 8 + 4096
    if seg_byte_limit > 0:
        nseg = (nblocks + seg_size - 1) // seg_size
        cap = min(cap, nseg * max(seg_byte_limit, 32) + 4096)
    out = np.empty(cap, np.uint8)
    n = lib.tpukit_bpe122_encode(
        blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nblocks, seg_size, seg_byte_limit,
        int(img_width), int(pad_rows), int(pixel_bitdepth) & 15,
        int(signed_pixels),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError("bpe122 encode failed")
    return out[:n].tobytes()


def bpe_decode_blocks(stream: bytes, nblocks: int) -> np.ndarray:
    """Decode a BPE stream into (nblocks, 64) int32 reconstructed
    (midpoint-filled) weighted coefficients."""
    lib = load_native()
    buf = np.frombuffer(stream, np.uint8)
    blocks = np.zeros((nblocks, 64), np.int32)
    got = lib.tpukit_bpe122_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        nblocks,
        blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if got < 0:
        raise RuntimeError("bpe122 decode failed (corrupt header)")
    return blocks


def bpe_decode_trace(stream: bytes, nblocks: int):
    """Decode with the stage-1..3 word trace: returns (blocks, trace)
    where trace is an (n_words, 7) int32 array of
    [plane, stage, gaggle, word_len, restricted, option, value] records
    — the field-level inventory of every entropy-coded word in the
    stream (option == the class's n_coded_options means the uncoded
    fallback; -1 means a single-bit word with no option machinery).
    Used by the golden-vector harness so a future Blue-Book table
    transcription has a ready differential surface."""
    lib = load_native()
    buf = np.frombuffer(stream, np.uint8)
    blocks = np.zeros((nblocks, 64), np.int32)
    cap = max(64, len(stream) * 16 * 7)
    trace = np.empty(cap, np.int32)
    got = lib.tpukit_bpe122_decode_trace(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        nblocks,
        blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        trace.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
    if got == -2:
        raise RuntimeError("bpe122 trace buffer overflow")
    if got < 0:
        raise RuntimeError("bpe122 decode failed (corrupt header)")
    return blocks, trace[:got].reshape(-1, 7).copy()


def encode_plane(coefs: np.ndarray, seg_byte_limit: int = 0,
                 img_width: int = 0, pad_rows: int = 0,
                 pixel_bitdepth: int = 16, signed_pixels: int = 0,
                 seg_size: int = 0) -> bytes:
    """One band: packed (Hp, Wp) int32 DWT plane -> weighted, gathered,
    BPE-coded stream."""
    Hp, Wp = coefs.shape
    gather, _ = block_indices(Hp, Wp)
    wexp = weight_exp_map(Hp, Wp)
    weighted = (coefs.astype(np.int32) << wexp).reshape(-1)
    return bpe_encode_blocks(weighted[gather], seg_byte_limit, seg_size,
                             img_width, pad_rows, pixel_bitdepth,
                             signed_pixels)


def decode_plane(stream: bytes, Hp: int, Wp: int) -> np.ndarray:
    """Inverse of encode_plane: stream -> packed (Hp, Wp) int32 DWT plane
    (weights divided back out with rounding — truncated streams midpoint-
    fill, so reconstructions need not stay weight multiples)."""
    gather, scatter = block_indices(Hp, Wp)
    nblocks = (Hp // 8) * (Wp // 8)
    blocks = bpe_decode_blocks(stream, nblocks).reshape(-1)
    plane = blocks[scatter].reshape(Hp, Wp)
    wexp = weight_exp_map(Hp, Wp)
    scale = (1 << wexp).astype(np.float64)
    return np.rint(plane / scale).astype(np.int32)
