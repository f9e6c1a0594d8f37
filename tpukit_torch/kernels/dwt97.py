# -*- coding: utf-8 -*-
"""Multilevel forward CDF 9/7 DWT: kernel K2, its schedule and its plain
version.

``dwt97(x, levels)`` replaces tpukit's fused Pallas transform
``dwt2_pallas`` and its per-level kernels ``_level97``
(tpukit/kernels/dwt_pallas.py:85-155). For a (B, H, W) float32 stack it
returns the packed Mallat layout of ``kernels.dwt.dwt2(x, "97", levels)``.

  * A CUDA tensor launches the hand-written Hopper kernels
    (tpukit_torch/csrc/dwt97.cu) on its device's current stream, as
    :func:`plan` schedules them, or raises; the caller's current device is
    left as it was. The result is bit-equal to the plain version
    on the card: both follow the rounding contract of ``kernels.dwt``. The
    input is only read.
  * A CPU tensor takes the plain version ``dwt97_ref``.

``dwt97.launches`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from tpukit_torch.kernels.dwt import dwt2

TAIL_MAX = 128 * 128    # samples of the largest window the tail kernel holds


class Step(NamedTuple):
    """One launch: ``kind`` "tile" runs level ``level`` of the h x w
    window, "tail" runs ``levels`` levels from it in one block per plane.
    ``src`` is the buffer holding the window ("x", the input, or a scratch
    buffer "s0"/"s1" holding the last LL); ``ll`` is where its LL goes
    ("s0", "s1" or "out")."""
    kind: str
    level: int
    h: int
    w: int
    levels: int
    src: str
    ll: str


def plan(H: int, W: int, levels: int, tail_max: int = TAIL_MAX) -> List[Step]:
    """The launches of a ``levels``-level transform of H x W planes.

    Each level whose window exceeds ``tail_max`` samples is one tile
    launch; it reads the input (level 1) or the scratch buffer the level
    before wrote its LL into, and writes its own LL into the other scratch
    buffer (into the output at the last level). The first window of at
    most ``tail_max`` samples, and every level after it, is one tail
    launch that writes everything into the output. "s0" holds a
    (H/2, W/2) window per plane and "s1" a (H/4, W/4) one."""
    steps: List[Step] = []
    src = "x"
    for lv in range(levels):
        h, w = H >> lv, W >> lv
        if h * w <= tail_max:
            steps.append(Step("tail", lv, h, w, levels - lv, src, "out"))
            break
        ll = "out" if lv == levels - 1 else ("s1" if src == "s0" else "s0")
        steps.append(Step("tile", lv, h, w, 1, src, ll))
        src = ll
    return steps


def dwt97_ref(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Plain torch version: ``kernels.dwt.dwt2(x, "97", levels)``."""
    return dwt2(x, "97", levels)


def _check(lib, err: int, step: Step):
    if err != 0:
        raise RuntimeError(f"dwt97 {step.kind} kernel launch failed at window "
                           f"{step.h}x{step.w}: CUDA error {err} "
                           f"({lib.tpk_error_string(err).decode()})")
    dwt97.launches += 1


def dwt97(x: torch.Tensor, levels: int,
          tail_max: int = TAIL_MAX) -> torch.Tensor:
    """(B, H, W) float32 -> (B, H, W) float32 packed multilevel 9/7 DWT:
    kernel K2's wrapper. ``tail_max`` (0 .. TAIL_MAX) moves the switch to
    the tail kernel; a check can lower it to run every level through the
    tile kernel. Not tpukit's ``dwt97``: that one is the plain
    ``kernels.dwt.dwt97(x, levels=3)``, of any shape and on any device."""
    if x.device.type == "cpu":
        return dwt97_ref(x, levels)
    if x.device.type != "cuda":
        raise ValueError(f"dwt97: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"dwt97: need a 3-D float32 tensor, got {x.dtype} "
                         f"of shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("dwt97: the input must be contiguous")
    B, H, W = x.shape
    if not 1 <= B <= 65535:
        raise ValueError(f"dwt97: band count {B} outside 1..65535")
    if levels < 0 or min(H, W) < 2 or H % (1 << levels) or W % (1 << levels):
        raise ValueError(f"dwt97: H and W must be divisible by 2^levels "
                         f"(got {H}x{W} at levels={levels})")
    if not 0 <= tail_max <= TAIL_MAX:
        raise ValueError(f"dwt97: tail_max {tail_max} outside 0..{TAIL_MAX}")
    if levels == 0:
        return x.clone()
    from tpukit_torch.kernels import build

    lib = build.load()
    steps = plan(H, W, levels, tail_max)
    out = torch.empty_like(x)
    bufs = {"x": x, "out": out}
    for name, div in (("s0", 2), ("s1", 4)):
        if any(name in (s.src, s.ll) for s in steps):
            bufs[name] = torch.empty(B * (H // div) * (W // div),
                                     dtype=x.dtype, device=x.device)
    dev = x.device.index
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def strides(name: str, h: int, w: int):
        """(band, row) strides of an h x w window held in buffer ``name``:
        x and out are (B, H, W), a scratch buffer holds (B, h, w)."""
        return (H * W, W) if name in ("x", "out") else (h * w, w)

    with torch.cuda.device(x.device):
        for s in steps:
            src = bufs[s.src]
            if s.kind == "tile":
                ll = bufs[s.ll]
                err = lib.tpk_dwt97_tile(
                    src.data_ptr(), *strides(s.src, s.h, s.w), B, s.h, s.w,
                    out.data_ptr(), H * W, W, ll.data_ptr(),
                    *strides(s.ll, s.h // 2, s.w // 2), dev, stream)
            else:
                err = lib.tpk_dwt97_tail(
                    src.data_ptr(), *strides(s.src, s.h, s.w), B, s.h, s.w,
                    s.levels, out.data_ptr(), H * W, W, dev, stream)
            _check(lib, err, s)
    return out


dwt97.launches = 0
