# -*- coding: utf-8 -*-
# The port's copy of tpukit/codecs/jpegls_codec.py: only its imports point at the port.
"""JPEG-LS codec object: per-band coding with NEAR rate search and optional
spectral diff1, mirroring the reference wrapper's behavior surface
(reference tools/codecs/jpegls/jpegls_wrap.py):

  * per-band planes, whole image (no tiling) — :7
  * int16 -> uint16 via +32768 before encode, inverse after decode
    (:199, :247-249)
  * NEAR selection: lossless -> 0; explicit nearlossless_eps; target
    cr/bpp -> probe band 1 over the candidate NEAR ladder with bisection
    (derive_near, :30-89) — using tpukit's own T.87 coder as the probe
  * diff1 spectral preproc only in strictly lossless runs; auto-disabled
    when NEAR>0 (:156-158)
  * timing split: codec-only t_comp_s/t_dec_s plus pre/post end-to-end
    breakdown (:263-281)
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import ctypes
import numpy as np

from tpukit_torch import native
from tpukit_torch.codecs.base import (Codec, CodecResult, RateSpec,
                                      codec_domain_to_int16,
                                      int16_to_codec_domain)
from tpukit_torch.kernels.diff1 import diff1_forward_np, diff1_inverse_np
from tpukit_torch.sweep.proc import mem_phase

_NEAR_LADDER = [0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 40, 48, 64,
                80, 96, 128, 160, 192, 224, 255]


def _clamp_near(level: int) -> int:
    return int(max(0, min(255, int(level))))


def jls_encode(img_u16: np.ndarray, near: int, bits: int = 16) -> bytes:
    lib = native.load()
    img = np.ascontiguousarray(img_u16, np.uint16)
    H, W = img.shape
    out = np.zeros(W * H * 4 + 4096, np.uint8)
    n = lib.jls_encode(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                       W, H, int(near), int(bits),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       out.size)
    if n <= 0:
        raise RuntimeError(f"jls_encode failed: {n}")
    return out[:n].tobytes()


def jls_decode(bitstream: bytes, W: int, H: int) -> np.ndarray:
    lib = native.load()
    b = np.frombuffer(bitstream, np.uint8).copy()
    img = np.zeros(H * W, np.uint16)
    ow, oh = ctypes.c_int(0), ctypes.c_int(0)
    r = lib.jls_decode(b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       b.size,
                       img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                       W, H, ctypes.byref(ow), ctypes.byref(oh))
    if r != W * H:
        raise RuntimeError(f"jls_decode failed: {r}")
    return img.reshape(H, W)


def derive_near(rate: RateSpec, band1: np.ndarray, dtype_name: str,
                bits: int = 16) -> int:
    """NEAR selection with the reference's probe-ladder + bisection
    (jpegls_wrap.py:30-89), probing in the codec domain."""
    if rate.lossless or rate.key is None:
        return 0
    if rate.key == "nearlossless_eps":
        return _clamp_near(rate.value)
    if rate.key == "quality":  # compatibility no-op flag (jpegls_wrap.py:133)
        return 0
    if rate.key not in ("cr", "bpp"):
        return 1

    H, W = band1.shape
    if dtype_name == "int16":
        probe = int16_to_codec_domain(band1)
    elif dtype_name == "uint16":
        probe = band1.astype(np.uint16, copy=False)
    else:
        probe = band1.astype(np.uint16, copy=False)
    probe = np.ascontiguousarray(probe)

    if rate.key == "bpp":
        bpp_target = float(rate.value)
    else:
        baseline_bpp = 16.0 if dtype_name in ("uint16", "int16") else 8.0
        bpp_target = baseline_bpp / float(rate.value)

    def size_bpp(n):
        return (8.0 * len(jls_encode(probe, _clamp_near(n), bits))) / (H * W)

    bpp0 = size_bpp(0)   # the most expensive (lossless) probe: run once
    best_n, best_err = 0, abs(bpp0 - bpp_target)
    prev_n, prev_bpp = 0, bpp0
    pick = 0
    for n in _NEAR_LADDER[1:]:
        cur = size_bpp(n)
        err = abs(cur - bpp_target)
        if err < best_err:
            best_n, best_err, pick = n, err, n
        crossed = ((prev_bpp >= bpp_target and cur <= bpp_target) or
                   (prev_bpp <= bpp_target and cur >= bpp_target))
        if crossed:
            lo, hi = prev_n, n
            for _ in range(6):
                mid = (lo + hi) // 2
                curm = size_bpp(mid)
                if abs(curm - bpp_target) < best_err:
                    best_n, best_err, pick = mid, abs(curm - bpp_target), mid
                if curm > bpp_target:
                    lo = mid + 1
                else:
                    hi = mid - 1
            break
        prev_n, prev_bpp = n, cur
    pick = _clamp_near(pick)
    # NEAR=0 deliberately coerces to 1 here — the reference behaves the
    # same way (jpegls_wrap.py:89 `pick or 1`): a cr/bpp rate request is
    # treated as an explicitly lossy ask even when lossless meets it
    return 1 if (pick == 0 and bpp_target < prev_bpp) else (pick or 1)


class JPEGLSCodec(Codec):
    name = "jpegls"
    encoder_desc = "tpukit JPEG-LS (ITU-T T.87, in-process)"
    supports_lossy = True

    def __init__(self, preproc: str = "none"):
        self.preproc = preproc

    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, **opts) -> CodecResult:
        B, H, W = cube.shape
        bits = 16 if dtype_name in ("uint16", "int16") else 8
        near = derive_near(rate, cube[0], dtype_name, bits)
        preproc = self.preproc
        if near > 0 and preproc == "diff1":
            print("[WARN] Disabling spectral diff1 for near-lossless (NEAR>0) "
                  "to prevent inter-band error propagation.", file=sys.stderr)
            preproc = "none"

        recon = np.empty_like(cube)
        streams: Dict[str, bytes] = {}
        sum_bytes = 0
        t_enc = t_dec = 0.0
        t_pre = t_post = 0.0

        src = cube
        if preproc == "diff1":
            t0 = time.perf_counter()
            src = diff1_forward_np(np.ascontiguousarray(cube))
            t_pre += time.perf_counter() - t0

        coded_planes = []
        for i in range(B):
            t0 = time.perf_counter()
            if dtype_name == "int16":
                plane = int16_to_codec_domain(src[i])
            else:
                plane = src[i].astype(np.uint16, copy=False)
            t_pre += time.perf_counter() - t0

            t0 = time.perf_counter()
            with mem_phase("comp"):
                bs = jls_encode(plane, near, bits)
            t_enc += time.perf_counter() - t0
            sum_bytes += len(bs)
            if keep_bitstream:
                streams[f"band_{i+1:02d}.jls"] = bs

            t0 = time.perf_counter()
            with mem_phase("dec"):
                dec = jls_decode(bs, W, H)
            t_dec += time.perf_counter() - t0

            t0 = time.perf_counter()
            if dtype_name == "int16":
                rec = codec_domain_to_int16(dec)
            else:
                rec = dec.astype(cube.dtype, copy=False)
            coded_planes.append(rec)
            t_post += time.perf_counter() - t0

        t0 = time.perf_counter()
        rec_cube = np.stack(coded_planes, axis=0).astype(cube.dtype, copy=False)
        if preproc == "diff1":
            rec_cube = diff1_inverse_np(np.ascontiguousarray(rec_cube))
        recon[:] = rec_cube
        t_post += time.perf_counter() - t0

        return CodecResult(
            codec="jpegls_subproc",
            encoder=self.encoder_desc,
            bitstream_bytes=sum_bytes,
            recon=recon,
            t_comp_s=t_enc,
            t_dec_s=t_dec,
            bitstreams=streams if keep_bitstream else None,
            extras={
                "preproc": preproc,
                "nearlossless_eps": int(near),
                "t_comp_pre_s": float(t_pre),
                "t_comp_end2end_s": float(t_pre + t_enc),
                "t_dec_post_s": float(t_post),
                "t_dec_end2end_s": float(t_dec + t_post),
            },
        )
