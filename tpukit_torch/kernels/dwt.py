# -*- coding: utf-8 -*-
"""2-D multilevel DWTs (lifting) on torch tensors: the plain versions.

Port of the irreversible CDF 9/7, the reversible integer 5/3 and the
reversible integer 9/7M paths of tpukit/kernels/dwt.py (``_fwd53_1d``,
``_inv53_1d``, ``_fwd97_1d``, ``_inv97_1d``, ``_fwd97m_1d``,
``_inv97m_1d``, ``_dwt2_once``, ``_idwt2_once``, ``dwt2``, ``idwt2``,
the named transforms ``dwt53`` ... ``idwt97m``, ``subband_slices``;
:72-269): split domain,
whole-point symmetric extension (s[n] := s[n-1], d[-1] := d[0]), the last
axis first and then the rows of each half, and the packed Mallat layout
[LL | HL; LH | HH] per level, in place of the level's window.

Rounding contract. Every lifting step is three separately rounded float32
operations, ``t = s + s_r``, ``t = A * t``, ``d = d + t``, and the scaling
multiplies by ``K`` and by ``IK = float32(1/K)``, rounded once; nothing
divides. torch runs each op as its own IEEE kernel on the CPU and on CUDA,
so this version gives the same bits on both, and kernel K2
(tpukit_torch/csrc/dwt97.cu, wrapper ``kernels.dwt97``) is held bit-equal
to it on the card. tpukit's jnp transform cannot be matched bit for bit:
XLA:CPU contracts ``d + A*(s + s_r)`` into an FMA, rewrites ``x / K`` as
``x * (1/K)`` and fuses the scaling across the two passes of a level. The
two agree to f32 round-off (tests/test_torch_dwt.py).

The 5/3 transform is int32 throughout (arithmetic shifts, as in JAX), so
it equals tpukit's bit for bit and its inverse restores the input exactly.

The 9/7M transform (CCSDS 122.0-B 3.3, kind ``"97m"``) is int32 throughout
too. tpukit rounds its two lifting steps in float32,
``floor((9/16)(s+s_r) - (1/16)(s_l+s_rr) + 0.5)`` and
``floor(-0.25(d_l+d) + 0.5)``; here they are the integer forms
``(9*(s+s_r) - (s_l+s_rr) + 8) >> 4`` and ``(2 - (d_l+d)) >> 2`` with
arithmetic shifts, the same on the CPU and on CUDA with no rounding
contract. The two forms agree wherever float32 holds tpukit's terms
exactly: every term is a multiple of 1/16, and float32 holds such a
multiple exactly below 2^20, so while the low-pass samples of a level stay
below 2^19.8 in magnitude (``9*|s+s_r|/16 < 2^20``) nothing is rounded
before the floor. The low-pass filter's absolute gain is at most 2.125 per
1-D pass, so a 16-bit sample can reach that magnitude only at the third
level and only on a pattern built for it; constant planes at either end of
the uint16 and int16 ranges, checkerboards and uniform noise over the full
ranges stay below 2^18 and the two transforms are bit-equal on them
(tests/test_torch_dwt97m.py). Beyond that magnitude tpukit's float32 loses
bits and this version stays exact and reversible.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# tpukit/kernels/dwt.py:89-93, as the float32 values both packages use
A97 = float(np.float32(-1.586134342059924))
B97 = float(np.float32(-0.052980118572961))
G97 = float(np.float32(0.882911075530934))
D97 = float(np.float32(0.443506852043971))
K97 = float(np.float32(1.230174104914001))
IK97 = float(np.float32(1.0 / 1.230174104914001))


def _next(a: torch.Tensor, axis: int) -> torch.Tensor:
    """a[i+1] along ``axis``, with a[n] := a[n-1] (``_sym_r``)."""
    n = a.shape[axis]
    return torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                     axis)


def _prev(a: torch.Tensor, axis: int) -> torch.Tensor:
    """a[i-1] along ``axis``, with a[-1] := a[0] (``_sym_l``)."""
    n = a.shape[axis]
    return torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)], axis)


def _split(x: torch.Tensor, axis: int):
    """(even, odd) samples along ``axis``."""
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(0, None, 2)
    even = x[tuple(idx)]
    idx[axis] = slice(1, None, 2)
    return even, x[tuple(idx)]


def _fwd53_1d(x: torch.Tensor, axis: int):
    s, d = _split(x, axis)
    d = d - ((s + _next(s, axis)) >> 1)                  # predict
    s = s + ((_prev(d, axis) + d + 2) >> 2)              # update
    return s, d


def _inv53_1d(s: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    s = s - ((_prev(d, axis) + d + 2) >> 2)
    d = d + ((s + _next(s, axis)) >> 1)
    return _interleave(s, d, axis)


def _interleave(s: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    """s0 d0 s1 d1 ... along ``axis``."""
    ax = axis % s.dim()
    return torch.stack([s, d], ax + 1).flatten(ax, ax + 1)


def _fwd97_1d(x: torch.Tensor, axis: int):
    s, d = _split(x, axis)
    d = d + A97 * (s + _next(s, axis))
    s = s + B97 * (_prev(d, axis) + d)
    d = d + G97 * (s + _next(s, axis))
    s = s + D97 * (_prev(d, axis) + d)
    return s * K97, d * IK97


def _inv97_1d(s: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    s = s * IK97
    d = d * K97
    s = s - D97 * (_prev(d, axis) + d)
    d = d - G97 * (s + _next(s, axis))
    s = s - B97 * (_prev(d, axis) + d)
    d = d - A97 * (s + _next(s, axis))
    return _interleave(s, d, axis)


def _prev2(a: torch.Tensor, axis: int) -> torch.Tensor:
    """a[i-1] along ``axis`` with the whole-sample symmetric head
    a[-1] := a[1] (``_sym_l2``: the signal's x[-2] = x[2])."""
    n = a.shape[axis]
    if n == 1:
        return a
    return torch.cat([a.narrow(axis, 1, 1), a.narrow(axis, 0, n - 1)], axis)


def _next2(a: torch.Tensor, axis: int) -> torch.Tensor:
    """a[i+2] along ``axis`` with the whole-sample symmetric tail
    a[n] := a[n-1], a[n+1] := a[n-2] (``_sym_r2``)."""
    n = a.shape[axis]
    if n == 1:
        return a
    return torch.cat([a.narrow(axis, 2, n - 2), a.narrow(axis, n - 1, 1),
                      a.narrow(axis, n - 2, 1)], axis)


def _predict97m(s: torch.Tensor, axis: int) -> torch.Tensor:
    """round_half_up((9/16)(s + s_r) - (1/16)(s_l + s_rr)), in integers."""
    return (9 * (s + _next(s, axis))
            - (_prev2(s, axis) + _next2(s, axis)) + 8) >> 4


def _update97m(d: torch.Tensor, axis: int) -> torch.Tensor:
    """round_half_up(-(d_l + d) / 4), in integers."""
    return (2 - (_prev(d, axis) + d)) >> 2


def _fwd97m_1d(x: torch.Tensor, axis: int):
    s, d = _split(x, axis)
    d = d - _predict97m(s, axis)
    s = s - _update97m(d, axis)
    return s, d


def _inv97m_1d(s: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    s = s + _update97m(d, axis)
    d = d + _predict97m(s, axis)
    return _interleave(s, d, axis)


_FWD = {"53": _fwd53_1d, "97": _fwd97_1d, "97m": _fwd97m_1d}
_INV = {"53": _inv53_1d, "97": _inv97_1d, "97m": _inv97m_1d}
_DTYPE = {"53": torch.int32, "97": torch.float32, "97m": torch.int32}


def _dwt2_once(x: torch.Tensor, kind: str) -> torch.Tensor:
    f = _FWD[kind]
    sL, sH = f(x, -1)
    LL, LH = f(sL, -2)
    HL, HH = f(sH, -2)
    return torch.cat([torch.cat([LL, HL], -1), torch.cat([LH, HH], -1)], -2)


def _idwt2_once(c: torch.Tensor, kind: str) -> torch.Tensor:
    inv = _INV[kind]
    H2, W2 = c.shape[-2] // 2, c.shape[-1] // 2
    sL = inv(c[..., :H2, :W2], c[..., H2:, :W2], -2)
    sH = inv(c[..., :H2, W2:], c[..., H2:, W2:], -2)
    return inv(sL, sH, -1)


def _check(kind: str, H: int, W: int, levels: int):
    if kind not in _FWD:
        raise ValueError(f"dwt kind must be one of {sorted(_FWD)}, got "
                         f"{kind!r}")
    if H % (1 << levels) or W % (1 << levels):
        raise ValueError(f"H and W must be divisible by 2^levels (got "
                         f"{H}x{W} at levels={levels})")


def dwt2(x: torch.Tensor, kind: str = "97", levels: int = 3) -> torch.Tensor:
    """Multilevel forward 2-D DWT of (..., H, W), packed in place (Mallat
    layout), on x's device: float32 for "97", int32 for "53" and "97m"."""
    H, W = x.shape[-2], x.shape[-1]
    _check(kind, H, W, levels)
    out = x.to(_DTYPE[kind], copy=True)
    for lv in range(levels):
        h, w = H >> lv, W >> lv
        out[..., :h, :w] = _dwt2_once(out[..., :h, :w], kind)
    return out


def idwt2(c: torch.Tensor, kind: str = "97", levels: int = 3) -> torch.Tensor:
    """Inverse of :func:`dwt2`."""
    H, W = c.shape[-2], c.shape[-1]
    _check(kind, H, W, levels)
    out = c.to(_DTYPE[kind], copy=True)
    for lv in range(levels - 1, -1, -1):
        h, w = H >> lv, W >> lv
        out[..., :h, :w] = _idwt2_once(out[..., :h, :w], kind)
    return out


# tpukit's named transforms (tpukit/kernels/dwt.py:232-254): dwt2/idwt2 of
# one kind at three levels by default, on the tensor's device


def dwt53(x: torch.Tensor, levels: int = 3) -> torch.Tensor:
    return dwt2(x, "53", levels)


def idwt53(c: torch.Tensor, levels: int = 3) -> torch.Tensor:
    return idwt2(c, "53", levels)


def dwt97(x: torch.Tensor, levels: int = 3) -> torch.Tensor:
    """``dwt2(x, "97", levels)``: tpukit's jnp ``dwt97``, which never
    reaches Pallas. Not kernel K2: its wrapper is
    ``kernels.dwt97.dwt97(x, levels)``, which takes a (B, H, W) float32
    stack and a level count and launches the CUDA kernel on a CUDA
    tensor."""
    return dwt2(x, "97", levels)


def idwt97(c: torch.Tensor, levels: int = 3) -> torch.Tensor:
    return idwt2(c, "97", levels)


def dwt97m(x: torch.Tensor, levels: int = 3) -> torch.Tensor:
    return dwt2(x, "97m", levels)


def idwt97m(c: torch.Tensor, levels: int = 3) -> torch.Tensor:
    return idwt2(c, "97m", levels)


def subband_slices(H: int, W: int, levels: int) -> List[Tuple[str, int, tuple]]:
    """(name, level, (rowslice, colslice)) for the packed layout; level 0 is
    the finest. LL only at the coarsest level."""
    out = []
    for lv in range(levels):
        h = H >> lv
        w = W >> lv
        h2, w2 = h // 2, w // 2
        out.append((f"HL{lv+1}", lv, (slice(0, h2), slice(w2, w))))
        out.append((f"LH{lv+1}", lv, (slice(h2, h), slice(0, w2))))
        out.append((f"HH{lv+1}", lv, (slice(h2, h), slice(w2, w))))
    out.append((f"LL{levels}", levels - 1,
                (slice(0, H >> levels), slice(0, W >> levels))))
    return out
