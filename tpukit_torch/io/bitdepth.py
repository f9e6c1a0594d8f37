# -*- coding: utf-8 -*-
"""Bit-depth packing ops and the peak estimate of PSNR/SSIM: the port of
tpukit/io/bitdepth.py.

  * ``to_12in16`` (:25-34) — round uint16 DN to multiples of 16, keeping 12
    effective bits in 16-bit storage: ``(x + 8) >> 4 << 4``
    (reference tools/make_baseline_A.py:137-170, the rounding at :167);
  * ``trunc_klsb`` (:37-58) — zero the k least-significant bits through a
    uint16 bit view, so int16 inputs truncate on raw bits
    (reference tools/make_baseline_B.py:281-316, int16 view at :303-312).

Both take a numpy array (tpukit's numpy code, unchanged) or a torch tensor
on any device. torch has few ops on ``torch.uint16``, so on tensors the
16-bit ring values are carried as int32 in [0, 65535], and an int16 result
is mapped back by subtracting 2^16 above 32767, not by the wrap of a
narrowing cast. ``effective_data_range`` (:66-95) and ``RangeScan``
(:98-149, its streaming form over strips) are numpy, copied verbatim.
"""

from __future__ import annotations

import numpy as np
import torch


def _ring(x: torch.Tensor) -> torch.Tensor:
    """The mod-2^16 values of a tensor's samples (an int16 source through
    its uint16 bit view), as int32 in [0, 65535]."""
    return x.to(torch.int32) & 0xFFFF


def _from_ring(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Ring values back to ``dtype``; int16 through its bit view."""
    if dtype == torch.int16:
        u = torch.where(u > 32767, u - 65536, u)
    return u.to(dtype)


def to_12in16(x):
    """Round uint16 samples to multiples of 16 (12 effective bits).

    Accepts a numpy array or a torch tensor; returns uint16. The +8 makes
    it round-to-nearest rather than floor (ties round up), exactly as
    reference make_baseline_A.py:167; like tpukit's uint16 arithmetic, the
    sum wraps mod 2^16, so samples of 65528 and above round to 0.
    """
    if isinstance(x, torch.Tensor):
        u = ((_ring(x) + 8) & 0xFFFF) >> 4 << 4
        return u.to(torch.uint16)
    xp = np
    u = x.astype(xp.uint16)
    return (((u + xp.uint16(8)) >> 4) << 4).astype(xp.uint16)


def trunc_klsb(x, k: int):
    """Zero the k LSBs of 16-bit samples through an unsigned bit-view.

    int16 input is reinterpreted as uint16, truncated, and reinterpreted
    back, preserving the reference's exact semantics for negative DN
    (make_baseline_B.py:303-312). k<=0 is the identity
    (make_baseline_B.py:282-283). A tensor keeps its dtype and device.
    """
    if k <= 0:
        return x
    if isinstance(x, torch.Tensor):
        return _from_ring((_ring(x) >> k) << k, x.dtype)
    x = np.asarray(x)
    if x.dtype == np.int16:
        u = x.view(np.uint16)
        return (((u >> k) << k).astype(np.uint16)).view(np.int16)
    u = x.astype(np.uint16, copy=False)
    return (((u >> k) << k).astype(np.uint16)).astype(x.dtype, copy=False)


def effective_data_range(arr: np.ndarray, dtype_name: str) -> int:
    """Peak estimate for PSNR/SSIM from dtype + bit-packing heuristics.

    Port of reference tools/run_codec.py:86-117:
      uint8 -> 255; uint16 with all samples multiple of 16 and max <= 4095*16
      -> 4095 (12-in-16); other uint16 -> 65535; int16 with 2 zero LSBs in
      [-8192, 8191] -> 8191 (14-in-16); other int16 -> max(|min|, |max|).
    """
    if dtype_name == "uint8":
        return 255
    a = np.asarray(arr)
    if dtype_name == "uint16":
        au = a.astype(np.uint16, copy=False)
        mx = int(au.max()) if au.size else 0
        is_12in16 = not np.any((au & 0xF) != 0)
        if is_12in16 and mx <= 4095 * 16:
            return 4095
        return 65535
    if dtype_name == "int16":
        ai = a.astype(np.int16, copy=False)
        mn = min(0, int(ai.min())) if ai.size else 0
        mx = max(0, int(ai.max())) if ai.size else 0
        is_14in16 = not np.any((ai & 0x3) != 0)
        if is_14in16 and mn >= -8192 and mx <= 8191:
            return 8191
        return int(max(abs(mn), abs(mx)))
    try:
        return int(np.iinfo(np.dtype(dtype_name)).max)
    except Exception:
        return 65535


class RangeScan:
    """Streaming accumulator for effective_data_range over strip windows:
    tracks min, max, and the OR of low bits so scene-scale sweeps never
    hold the whole cube (same heuristics as reference run_codec.py:86-117,
    fed incrementally)."""

    def __init__(self, dtype_name: str):
        self.dtype_name = dtype_name
        self.mn = None
        self.mx = None
        self.lsb_or = 0

    def update(self, arr: np.ndarray) -> "RangeScan":
        a = np.asarray(arr)
        if a.size == 0:
            return self
        mn = int(a.min())
        mx = int(a.max())
        self.mn = mn if self.mn is None else min(self.mn, mn)
        self.mx = mx if self.mx is None else max(self.mx, mx)
        if self.dtype_name == "uint16":
            self.lsb_or |= int(np.bitwise_or.reduce(
                a.astype(np.uint16, copy=False).reshape(-1) & np.uint16(0xF)))
        elif self.dtype_name == "int16":
            self.lsb_or |= int(np.bitwise_or.reduce(
                a.view(np.uint16).reshape(-1) & np.uint16(0x3))
                if a.dtype == np.int16 else
                np.bitwise_or.reduce(
                    a.astype(np.int16).view(np.uint16).reshape(-1)
                    & np.uint16(0x3)))
        return self

    def result(self) -> int:
        """effective_data_range from the accumulated scan."""
        dn = self.dtype_name
        if dn == "uint8":
            return 255
        if dn == "uint16":
            mx = self.mx if self.mx is not None else 0
            if self.lsb_or == 0 and mx <= 4095 * 16:
                return 4095
            return 65535
        if dn == "int16":
            mn = min(0, self.mn if self.mn is not None else 0)
            mx = max(0, self.mx if self.mx is not None else 0)
            if self.lsb_or == 0 and mn >= -8192 and mx <= 8191:
                return 8191
            return int(max(abs(mn), abs(mx)))
        try:
            return int(np.iinfo(np.dtype(dn)).max)
        except Exception:
            return 65535
