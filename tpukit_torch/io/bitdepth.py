# -*- coding: utf-8 -*-
"""The peak estimate of PSNR/SSIM: the part of tpukit/io/bitdepth.py the
port calls (``effective_data_range``, :66-95), numpy only."""

from __future__ import annotations

import numpy as np


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
