# -*- coding: utf-8 -*-
"""Exact size and truncated-decode models of the embedded bit-plane coder,
on torch tensors.

Port of tpukit/codecs/bitplane_model.py (``_msb_index``, ``bpc_size_bits``,
``bpc_size_bytes``, ``bpc_size_bytes_host``, :42-95;
``bpc_stream_layout``, ``bpc_decode_at``, ``bpc_truncated_decode``,
:131-266). ``native/src/bitplane.cpp``
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

The truncated-decode model (second half of the file) reproduces what
``bpc_decode(bpc_encode(coefs, max_bytes))`` gives, and the stream's exact
byte count, without building the stream: the stream is cut at
``8*(max_bytes-1)`` payload bits, significance units are atomic,
refinement bits arrive one by one in acquisition order, and the decoder
fills each coefficient at the middle of its lowest known plane. Every one
of those bit positions is a closed form of the MSB indices:

  * per plane p and group g the significance unit is 1 gate bit while the
    group is inactive (topg < p), 1 + nb + nh bits when it activates
    (topg == p) and nb + nh (none when nb = 0) after, with nb = #{members:
    msb <= p} and nh = #{members: msb == p};
  * the refinement pass of plane p holds one bit per coefficient with
    msb > p, in acquisition order: MSB descending, scan position ascending
    (a STABLE sort; an unstable one reorders equal planes and moves the
    cut);
  * a coefficient is reconstructed iff its unit ends at or before the cut.

tpukit maps these functions over bands with ``jax.vmap``; here every
function takes leading batch axes. Magnitudes are int64 in [0, 2^32)
(torch has no uint32 arithmetic); tpukit's int32 sentinels keep their
values; no shift amount reaches the width of its type.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpukit_torch.device import resolve_device

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


def bpc_size_bytes_host(coefs: np.ndarray, device="cuda") -> np.ndarray:
    """Host convenience wrapper: :func:`bpc_size_bytes` of a numpy array
    on ``device`` (the card unless the caller asks for the CPU; no card
    raises), back as an int32 numpy array, as tpukit's (which jits on its
    default backend)."""
    x = torch.from_numpy(np.ascontiguousarray(coefs, dtype=np.int32))
    return bpc_size_bytes(x.to(resolve_device(device))).to(
        torch.int32).cpu().numpy()


_INF = 2**31 - 1       # tpukit's int32 cut sentinel, kept in int64


def bpc_stream_layout(coefs: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> dict:
    """Budget-independent stream geometry over the last axis of ``coefs``
    (integers in scan order; leading axes are bands): everything
    :func:`bpc_decode_at` needs to evaluate any byte budget. A rate ladder
    computes this once and prices and reconstructs every budget from it.
    Entries are padded to ``npad = ceil(n/GROUP)*GROUP``."""
    n = coefs.shape[-1]
    lead = tuple(coefs.shape[:-1])
    dev = coefs.device
    mag = coefs.to(torch.int64).abs()
    if valid is None:
        w = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        w = valid.to(torch.bool)
    w = torch.broadcast_to(w, coefs.shape)
    neg = coefs < 0
    pad = (-n) % GROUP
    if pad:
        mag = F.pad(mag, (0, pad))
        w = F.pad(w, (0, pad))
        neg = F.pad(neg, (0, pad))
    npad = mag.shape[-1]
    g = npad // GROUP
    wg = w.reshape(lead + (g, GROUP))

    msb = torch.where(wg, _msb_index(mag.reshape(lead + (g, GROUP))), -1)
    topg = msb.amax(-1)                                      # (..., g)
    nplanes = (topg.amax(-1) + 1).clamp(min=0)               # (...,)

    # members per (group, plane): bin 0 counts the valid zeros, bin 1 + p
    # the members with msb == p, bin 33 the padding
    hist = torch.zeros(lead + (g, 34), dtype=torch.int64, device=dev)
    hist.scatter_add_(-1, torch.where(wg, msb + 1, 33),
                      torch.ones_like(msb))
    nh = hist[..., 1:33].transpose(-1, -2)                   # (..., 32, g)
    nb = hist[..., :33].cumsum(-1)[..., 1:].transpose(-1, -2)

    p = torch.arange(32, dtype=torch.int64, device=dev)
    topg_ = topg[..., None, :]
    sig_bits = torch.where(
        topg_ < p[:, None], 1,
        torch.where(topg_ == p[:, None], 1 + nb + nh,
                    torch.where(nb > 0, nb + nh, 0)))
    live = p < nplanes[..., None]                            # (..., 32)
    sig_bits = torch.where(live[..., None], sig_bits, 0)     # (..., 32, g)

    sig_total = sig_bits.sum(-1)                             # (..., 32)
    # refinement bits at plane p: one per coefficient with msb > p
    nh_tot = nh.sum(-1)
    ref_total = torch.where(
        live, nh_tot.sum(-1, keepdim=True) - nh_tot.cumsum(-1), 0)

    # the stream runs planes nplanes-1 .. 0, each plane sig then ref; a
    # plane starts where all higher planes end
    seg_len = sig_total + ref_total
    above = seg_len.flip(-1).cumsum(-1).flip(-1) - seg_len
    start_ref = above + sig_total
    unit_end = above[..., None] + sig_bits.cumsum(-1)        # (..., 32, g)

    total_bits = seg_len.sum(-1)
    full_bytes = 1 + (total_bits + 7) // 8

    # acquisition rank: msb descending, scan position ascending (stable)
    msb_flat = msb.reshape(lead + (npad,))
    order = torch.argsort(-msb_flat, dim=-1, stable=True)
    idx = torch.arange(npad, dtype=torch.int64, device=dev)
    rank = torch.empty_like(order).scatter_(-1, order, idx.expand_as(order))

    msb_c = msb_flat.clamp(0, 31)
    unit_end_i = torch.gather(unit_end.reshape(lead + (32 * g,)), -1,
                              msb_c * g + idx // GROUP)
    return {
        "mag": mag,                       # (..., npad) int64 in [0, 2^32)
        "msb": msb_flat,                  # -1 for zero and for padding
        "msb_c": msb_c,
        "neg": neg,
        "rank": rank,                     # acquisition order index
        "unit_end_i": unit_end_i,         # per-coefficient unit end bit
        "start_ref": start_ref,           # (..., 32)
        "full_bytes": full_bytes,         # (...,)
    }


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """An int64 value mod 2^32, as a signed 32-bit value (in int64): what
    tpukit's int32 and uint32 arithmetic wraps to."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v)


def bpc_decode_at(layout: dict, budget_bytes):
    """Evaluate one byte budget (an int or a scalar tensor; <= 0 means
    untruncated) against a precomputed layout. Returns (recon (..., npad)
    int32, group-padded: slice [:n] yourself; the exact encoded byte count
    (...,) int64)."""
    dev = layout["mag"].device
    budget = torch.as_tensor(budget_bytes, device=dev).to(torch.int64)
    full = layout["full_bytes"]
    nbytes = torch.where(budget > 0, torch.minimum(full, budget), full)
    # a budget beyond 2^27 bytes (1 Gbit) is past any stream, so the clamp
    # keeps 8*(budget-1) inside tpukit's int32
    bclamp = budget.clamp(max=1 << 27)
    cut = torch.where(budget > 0, 8 * (bclamp - 1).clamp(min=0), _INF)

    mag, msb = layout["mag"], layout["msb"]
    msb_c, rank = layout["msb_c"], layout["rank"]
    start_ref = layout["start_ref"]
    acq = (msb >= 0) & (layout["unit_end_i"] <= cut)

    # the refinement bit of plane q arrives iff its position
    # start_ref[q] + rank is below the cut (and q < msb); all of a
    # coefficient's refinement positions lie after its unit end
    rec = torch.where(acq, 1 << msb_c, 0)
    known = msb_c
    for q in range(32):
        inc = (q < msb) & (start_ref[..., q, None] + rank < cut)
        rec = rec + torch.where(inc, mag & (1 << q), 0)
        known = torch.where(inc, known.clamp(max=q), known)
    m = rec + torch.where(acq & (known > 0), 1 << (known - 1).clamp(min=0), 0)
    out = torch.where(acq, torch.where(layout["neg"], -m, m), 0)
    return _wrap_i32(out).to(torch.int32), nbytes


def bpc_truncated_decode(coefs: torch.Tensor, budget_bytes,
                         valid: Optional[torch.Tensor] = None):
    """Model ``bpc_decode(bpc_encode(coefs, budget_bytes))`` over the last
    axis: (recon (..., n) int32, exact encoded bytes (...,) int64, header
    included, truncation applied)."""
    out, nbytes = bpc_decode_at(bpc_stream_layout(coefs, valid), budget_bytes)
    return out[..., :coefs.shape[-1]], nbytes
