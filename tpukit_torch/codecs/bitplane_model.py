# -*- coding: utf-8 -*-
"""Exact size model of the embedded bit-plane coder, on torch tensors.

Port of tpukit/codecs/bitplane_model.py:42-90 (``_msb_index``,
``bpc_size_bits``, ``bpc_size_bytes``). ``native/src/bitplane.cpp``
streams, per plane (MSB to LSB), one gate bit per not-yet-active group of
16, one significance bit per still-insignificant member of active groups
plus a sign bit for members that become significant, and one refinement
bit per previously significant coefficient. Every bit's plane is a closed
form of the coefficient's MSB index and its group's top plane, so the
stream length is an O(n) reduction:

  gates   = sum_g (nplanes - max(topg_g, 0))
  members = sum_i (topg_{g(i)} - max(msb_i, 0) + 1)   for groups with topg >= 0
  signs   = #{i : mag_i > 0}
  refine  = sum_i max(msb_i, 0)
  bytes   = 1 + ceil((gates + members + signs + refine) / 8)

Integers throughout, so the counts equal tpukit's exactly; they are kept
in int64 here (tpukit sums in int32, which a band of fewer than 2^26
coefficients cannot overflow).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

GROUP = 16  # must match bitplane.cpp


def _msb_index(mag: torch.Tensor) -> torch.Tensor:
    """floor(log2(mag)) for mag > 0, -1 for 0 (bitplane.cpp msb_index).
    Exact: frexp of a float64 holding an integer below 2^53 gives
    mag = m * 2^e with m in [0.5, 1), so the MSB is e - 1; frexp(0) has
    e = 0."""
    return torch.frexp(mag.to(torch.float64)).exponent.to(torch.int64) - 1


def bpc_size_bits(coefs: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact bit count (excluding the 1-byte header) of bpc_encode over the
    last axis of ``coefs`` (integers, already in scan order). Leading axes
    are batch. ``valid`` masks padded tail entries (True = real
    coefficient); pad with zeros AND mark them invalid."""
    mag = coefs.to(torch.int64).abs()
    if valid is None:
        w = torch.ones(coefs.shape[-1], dtype=torch.bool, device=coefs.device)
    else:
        w = valid.to(torch.bool)
    w = torch.broadcast_to(w, coefs.shape)

    pad = (-coefs.shape[-1]) % GROUP
    if pad:
        mag = F.pad(mag, (0, pad))
        w = F.pad(w, (0, pad))
    g = mag.shape[-1] // GROUP
    magg = mag.reshape(mag.shape[:-1] + (g, GROUP))
    wg = w.reshape(w.shape[:-1] + (g, GROUP))

    msb = _msb_index(magg)                                   # -1 for 0
    topg = torch.where(wg, msb, -1).amax(-1)                 # (..., g)
    nplanes = (topg.amax(-1) + 1).clamp(min=0)               # (...,)

    gates = (nplanes[..., None] - topg.clamp(min=0)).sum(-1)
    act = (topg >= 0)[..., None]
    members = torch.where(act & wg, topg[..., None] - msb.clamp(min=0) + 1,
                          0).sum((-2, -1))
    signs = ((magg > 0) & wg).sum((-2, -1))
    refine = torch.where(wg, msb.clamp(min=0), 0).sum((-2, -1))
    return gates + members + signs + refine


def bpc_size_bytes(coefs: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact byte length of bpc_encode (header byte included), int64."""
    return 1 + (bpc_size_bits(coefs, valid) + 7) // 8
