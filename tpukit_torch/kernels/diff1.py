# -*- coding: utf-8 -*-
"""Reversible spectral first-difference (diff1) over the band axis.

Counterpart of tpukit/kernels/diff1.py, which imports JAX at top level, so
its numpy pair is re-homed here (``diff1_forward_np``/``diff1_inverse_np``,
tpukit/kernels/diff1.py:60-73).

The tensor pair works on int32 tensors that hold N-bit unsigned samples
(the uint16 bit view of an int16 cube, say): torch's uint16 arithmetic is
thin, so the mod-2^N difference and cumulative sum are taken in int32 and
masked with ``2^N - 1``. That is exactly tpukit's unsigned wraparound.
"""

from __future__ import annotations

import numpy as np
import torch


def diff1_forward(u: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """R[0]=X[0]; R[b]=X[b]-X[b-1] (mod 2^bits) along axis 0 of int32 (B,H,W)."""
    r = u.clone()
    r[1:] = (u[1:] - u[:-1]) & ((1 << bits) - 1)
    return r


def diff1_inverse(r: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """X[b] = Σ_{i<=b} R[i] (mod 2^bits) along axis 0 of int32 (B,H,W)."""
    return torch.cumsum(r, 0, dtype=torch.int64).bitwise_and_(
        (1 << bits) - 1).to(torch.int32)


def diff1_forward_np(cube: np.ndarray) -> np.ndarray:
    u = cube.view(np.uint16) if cube.dtype == np.int16 else cube
    out = u.copy()
    # unsigned subtract wraps == modular difference, no widening needed
    np.subtract(u[1:], u[:-1], out=out[1:])
    return out.view(cube.dtype)


def diff1_inverse_np(res: np.ndarray) -> np.ndarray:
    u = res.view(np.uint16) if res.dtype == np.int16 else res
    # accumulate in the native width: unsigned wraparound IS the mod-2^N
    # cumsum, and runs ~4x faster than widening to 64-bit
    out = np.add.accumulate(u, axis=0, dtype=u.dtype)
    return out.view(res.dtype)
