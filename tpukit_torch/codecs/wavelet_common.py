# -*- coding: utf-8 -*-
"""Shared machinery of the wavelet codecs: the embedded scan order, the
subband segment layout and the run-length backend's size model.

Re-homed from tpukit/codecs/wavelet_common.py, which imports JAX at :13:
``scan_order``, ``inverse_scan_order`` and ``pad_to_multiple`` (:20-43,
:64-71), the Rice backend constants (:178-193),
``RLE_CAP_BITS``/``_rle_cap_bits`` (:226-232), ``subband_seg_bounds``
(:235-253) and ``_rle_model_consts`` (:320-331), verbatim in numpy; and
``rle_size_bytes_model`` (:334-419) ported to torch; and
``device_scan_orders`` (:46-61), cached per device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tpukit_torch.kernels.dwt import subband_slices


@lru_cache(maxsize=32)
def scan_order(H: int, W: int, levels: int) -> np.ndarray:
    """Flat index permutation: coarsest LL first, then HL/LH/HH per level
    from coarse to fine — the embedded-progressive scan."""
    idx = np.arange(H * W).reshape(H, W)
    parts = []
    subs = subband_slices(H, W, levels)
    ll = subs[-1]
    parts.append(idx[ll[2]].ravel())
    for lv in range(levels - 1, -1, -1):
        for name, l, sl in subs[:-1]:
            if l == lv:
                parts.append(idx[sl].ravel())
    order = np.concatenate(parts)
    assert order.size == H * W
    return order


@lru_cache(maxsize=32)
def inverse_scan_order(H: int, W: int, levels: int) -> np.ndarray:
    order = scan_order(H, W, levels)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return inv


@lru_cache(maxsize=32)
def device_scan_orders(H: int, W: int, levels: int, device: torch.device):
    """(order, inverse) scan permutations as int64 tensors on ``device``,
    uploaded once per padded shape and device."""
    return (torch.from_numpy(scan_order(H, W, levels)).to(device),
            torch.from_numpy(inverse_scan_order(H, W, levels)).to(device))


def pad_to_multiple(img: np.ndarray, m: int):
    """Edge-pad the last two axes up to multiples of ``m``; returns
    (padded, H, W) with the original H and W."""
    H, W = img.shape[-2:]
    ph = (-H) % m
    pw = (-W) % m
    if ph == 0 and pw == 0:
        return img, H, W
    pads = [(0, 0)] * (img.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(img, pads, mode="edge"), H, W


RICE_MARK = 0x80
RICE_BITS = 16
RICE_J = 64
RICE_RSI = 2
RICE_J_SPARSE = 32
RICE_RSI_SPARSE = 8

# saturation ceiling of the run-length model's magnitude-cost sums: any
# candidate whose true cost reaches CAP bits is clamped to CAP, which
# exceeds every competitor the backend selection compares it with
RLE_CAP_BITS = 1 << 29


def _rle_cap_bits(n: int) -> int:
    """Saturation ceiling > 34*n (any competitor's size), <= 2^30 - 1 so
    the pairwise saturating adds stay inside int32."""
    return RLE_CAP_BITS if 34 * n <= RLE_CAP_BITS else (1 << 30) - 1


@lru_cache(maxsize=32)
def subband_seg_bounds(H: int, W: int, levels: int):
    """Static (start, stop) pairs of each subband's span in scan order —
    the wrle backend's segment layout (same traversal as scan_order)."""
    subs = subband_slices(H, W, levels)
    lens = []
    ll = subs[-1][2]
    lens.append((ll[0].stop - ll[0].start) * (ll[1].stop - ll[1].start))
    for lv in range(levels - 1, -1, -1):
        for name, l, sl in subs[:-1]:
            if l == lv:
                lens.append((sl[0].stop - sl[0].start)
                            * (sl[1].stop - sl[1].start))
    out, off = [], 0
    for n in lens:
        out.append((off, off + n))
        off += n
    assert off == H * W
    return tuple(out)


@lru_cache(maxsize=64)
def _rle_model_consts(segbounds):
    """Static helper arrays for rle_size_bytes_model: per-position segment
    floor index (seg_start - 1, resets the prev-nonzero chain at segment
    boundaries) and the per-segment nnz field widths."""
    n = segbounds[-1][1]
    floor = np.empty(n, np.int32)
    widths = []
    for a, b in segbounds:
        floor[a:b] = a - 1
        widths.append(int(b - a).bit_length())
    return floor, np.asarray(widths, np.int32)


class RleModelConsts:
    """The model's static arrays on one device, built once per (segment
    layout, device) so that a ladder of points uploads nothing: uploads
    from pageable host memory wait for the stream, which would stall the
    ladder that pricing enqueues ahead of the host's tier-1 analysis."""

    def __init__(self, segbounds, device: torch.device):
        floor, widths = _rle_model_consts(tuple(segbounds))
        self.n = int(segbounds[-1][1])
        self.nsegs = len(segbounds)
        self.cap = _rle_cap_bits(self.n)
        self.floor = torch.from_numpy(floor.astype(np.int64)).to(device)
        self.widths = torch.from_numpy(widths.astype(np.int64)).to(device)
        self.starts = torch.tensor([a for a, _ in segbounds],
                                   dtype=torch.int64, device=device)
        self.stops = torch.tensor([b for _, b in segbounds],
                                  dtype=torch.int64, device=device)
        self.idx = torch.arange(self.n, dtype=torch.int64, device=device)
        # (k, j) weights 2^(j-k) of bit plane j in sum(m >> k), 0 for j < k
        self.weights = torch.tensor(
            [[1 << (j - k) if j >= k else 0 for j in range(15)]
             for k in range(16)], dtype=torch.int64, device=device)
        self.ks = torch.arange(1, 17, dtype=torch.int64,
                               device=device)[:, None]        # k + 1


def _seg_sums(x: torch.Tensor, c: RleModelConsts) -> torch.Tensor:
    """(..., n) -> (..., S) exact int64 sums over each segment, from one
    cumulative sum per row gathered at the segment bounds. CUDA takes
    :func:`_seg_sums_flat`: torch scans a few long rows with one thread
    block per row, ~40x slower than one device-wide scan for (4, 2^20).
    On the CPU the rows are scanned in parallel, which a 1-D scan is not.
    The integers are the same either way."""
    if x.device.type == "cuda":
        return _seg_sums_flat(x, c)
    cs = torch.cumsum(x, -1, dtype=torch.int64)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], -1)
    return cs[..., c.stops] - cs[..., c.starts]


def _seg_sums_flat(x: torch.Tensor, c: RleModelConsts) -> torch.Tensor:
    """:func:`_seg_sums` from one cumulative sum over the flattened tensor
    (segments never cross a row, so row offsets locate them)."""
    cs = torch.cumsum(x.reshape(-1), 0, dtype=torch.int64)
    cs = torch.cat([cs.new_zeros(1), cs])
    rows = torch.arange(0, cs.numel() - 1, c.n, device=cs.device)[:, None]
    sums = cs[rows + c.stops] - cs[rows + c.starts]
    return sums.reshape(x.shape[:-1] + (c.nsegs,))


def rle_size_bytes_model(qc: torch.Tensor, segbounds=None,
                         consts: RleModelConsts | None = None) -> torch.Tensor:
    """EXACT model of rle_size_host over the last axis for int16-range
    inputs (callers clip first), equal to tpukit's jnp model integer for
    integer.

    tpukit sums the magnitude costs in saturating int32 trees: each term
    ``S_j * 2^(j-k)`` and each partial sum is clamped at CAP, which yields
    ``min(true sum, CAP)``. Here the sums are exact int64 and clamped once,
    which is the same integer. The segment total follows tpukit's tree too:
    clamped at CAP when there are two segments or more, as it is."""
    n = qc.shape[-1]
    if consts is None:
        if segbounds is None:
            segbounds = ((0, n),)
        consts = RleModelConsts(segbounds, qc.device)
    c = consts
    if c.n != n:
        raise ValueError(f"segment layout covers {c.n} samples, got {n}")
    cap = c.cap

    nz = qc != 0
    masked = torch.where(nz, c.idx, -1)
    incl = torch.cummax(masked, -1).values
    prev = torch.cat([torch.full_like(incl[..., :1], -1), incl[..., :-1]], -1)
    prev = torch.maximum(prev, c.floor)
    gap = torch.where(nz, c.idx - prev - 1, 0)

    nnz = _seg_sums(nz, c)                                    # (..., S)
    # gap candidates: min over k of sum(gap >> k) + nnz * (k + 1)
    cost_g = torch.stack([_seg_sums(gap >> k, c) + nnz * (k + 1)
                          for k in range(16)], -2).amin(-2)
    # magnitude bit-plane sums: m = |v| - 1 <= 32766 -> 15 planes
    mag = torch.where(nz, qc.to(torch.int64).abs() - 1, 0)
    S = torch.stack([_seg_sums((mag >> j) & 1, c) for j in range(15)],
                    -2)                                       # (..., 15, S)
    # sum_{j>=k} S_j 2^(j-k) == sum(m >> k), then + nnz * (k + 1), at CAP
    msum = (c.weights[:, :, None] * S[..., None, :, :]).sum(-2)
    cost_m = (msum + nnz[..., None, :] * c.ks).clamp(max=cap).amin(-2)

    bits = c.widths + torch.where(nnz > 0, 8 + cost_g + cost_m + nnz, 0)
    total = bits.sum(-1)
    if c.nsegs > 1:
        total = total.clamp(max=cap)
    return 1 + (total + 7) // 8
