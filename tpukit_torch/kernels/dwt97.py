# -*- coding: utf-8 -*-
"""Multilevel forward CDF 9/7 DWT: kernel K2 and its plain version.

``dwt97(x, levels)`` replaces tpukit's fused Pallas transform
``dwt2_pallas`` and its per-level kernels ``_level97``
(tpukit/kernels/dwt_pallas.py:85-155). For a (B, H, W) float32 stack it
returns the packed Mallat layout of ``kernels.dwt.dwt2(x, "97", levels)``.

  * A CUDA tensor launches the hand-written Hopper kernel
    (tpukit_torch/csrc/dwt97.cu) on the current stream, two launches per
    level (row pass, column pass), or raises. The result is bit-equal to
    the plain version on the card: both follow the rounding contract of
    ``kernels.dwt``.
  * A CPU tensor takes the plain version ``dwt97_ref``.

``dwt97.launches`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import torch

from tpukit_torch.kernels.dwt import dwt2

MAX_SIDE = 58112         # one line of float32 in a block's shared memory


def dwt97_ref(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Plain torch version: ``kernels.dwt.dwt2(x, "97", levels)``."""
    return dwt2(x, "97", levels)


def _launch(fn, lib, src, dst, B, h, w, H, W, dev):
    err = fn(src.data_ptr(), dst.data_ptr(), B, h, w, H * W, W,
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dwt97 kernel launch failed at window {h}x{w}: "
                           f"CUDA error {err} "
                           f"({lib.tpk_error_string(err).decode()})")
    dwt97.launches += 1


def dwt97(x: torch.Tensor, levels: int) -> torch.Tensor:
    """(B, H, W) float32 -> (B, H, W) float32 packed multilevel 9/7 DWT."""
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
    if max(H, W) > MAX_SIDE:
        raise ValueError(f"dwt97: {H}x{W} exceeds {MAX_SIDE} samples a side")
    out = x.clone()
    if levels == 0:
        return out
    from tpukit_torch.kernels import build

    lib = build.load()
    scratch = torch.empty_like(out)
    for lv in range(levels):
        h, w = H >> lv, W >> lv
        _launch(lib.tpk_dwt97_rows, lib, out, scratch, B, h, w, H, W,
                x.device)
        _launch(lib.tpk_dwt97_cols, lib, scratch, out, B, h, w, H, W,
                x.device)
    return out


dwt97.launches = 0
