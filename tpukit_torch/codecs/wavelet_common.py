# -*- coding: utf-8 -*-
"""Shared machinery of the wavelet codecs: the embedded scan order, the
subband segment layout and the run-length backend's size model.

Re-homed from tpukit/codecs/wavelet_common.py, which imports JAX at :13:
``scan_order``, ``inverse_scan_order`` and ``pad_to_multiple`` (:20-43,
:64-71), the Rice backend constants (:178-193),
``RLE_CAP_BITS``/``_rle_cap_bits`` (:226-232), ``subband_seg_bounds``
(:235-253) and ``_rle_model_consts`` (:320-331), verbatim in numpy; and
``rle_size_bytes_model`` (:334-419) ported to torch;
``device_scan_orders`` (:46-61), cached per device; and the host Rice /
bit-plane / run-length coder (:74-175, :196-317, :422-633: ``bpc_*``,
``rle_*``, ``split_*``, ``wenc_encode``, ``wenc_decode``,
``wenc_quant_encode_ck``), the same text over the port's native library.
"""

from __future__ import annotations

import ctypes as ct
from functools import lru_cache

import numpy as np
import torch

from tpukit_torch import native
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


# ---------------------------------------------------------------------------
# The host coder: tpukit's functions, copied by hand (the same text, the
# package name in the imports apart; tests/test_torch_host_copies.py holds
# each to its original). numpy over ctypes into the port's own native
# library (bitplane.cpp, rle.cpp, ccsds121.cpp).
#
# Backend selection is per band and a function of the quantized
# coefficients alone (the smallest of EXACT sizes; Rice and run-length need
# the values to fit int16), so the device size model
# (``j2k_codec.wenc_size_bytes``) and this coder always agree:
#
#   header bit 7 set       -> zigzag + CCSDS-121 backend (nbit=16, no
#                             preprocessing; log2 J in bits 0-2,
#                             log2(rsi)-1 in bits 3-4; bit 5 = Rice-split
#                             variant for values beyond int16)
#   header 0x40|nplanes    -> embedded bit-plane backend (bitplane.cpp; the
#                             only truncatable one)
#   header 0x20            -> sparse run-length backend (rle.cpp; subband
#                             segment layout passed out-of-band)
# ---------------------------------------------------------------------------

_TLS = __import__("threading").local()


def _tls_buf(name: str, need: int, dtype) -> np.ndarray:
    """Reusable thread-local scratch buffer (the J2K/122 codecs fan coder
    calls across bands; the C calls release the GIL)."""
    buf = getattr(_TLS, name, None)
    if buf is None or buf.size < need:
        buf = np.empty(need, dtype)
        setattr(_TLS, name, buf)
    return buf


def bpc_encode(coef: np.ndarray, max_bytes: int = 0) -> bytes:
    """Native embedded bit-plane encode from int32 coefficients."""
    lib = native.load()
    c = np.ascontiguousarray(coef.ravel(), np.int32)
    buf = _tls_buf("buf", c.size * 8 + 1024, np.uint8)
    n = lib.bpc_encode(c.ctypes.data_as(ct.POINTER(ct.c_uint32)), c.size,
                       buf.ctypes.data_as(ct.POINTER(ct.c_uint8)), buf.size,
                       int(max_bytes))
    if n <= 0:
        raise RuntimeError(f"bpc_encode failed: {n}")
    return buf[:n].tobytes()


def bpc_encode_quant_ck(coefs: np.ndarray, inv_steps: np.ndarray,
                        inv_base: float, max_bytes: int = 0):
    """Fused deadzone quantize + embedded encode (one native pass).

    qc = trunc(coefs * (inv_steps * inv_base)) with the same f32
    association order as the numpy path and the device requantizer, so all
    three agree bit-for-bit. Returns (bitstream bytes, qc int32 array,
    s1, s2) where s1/s2 are sum(qc) and sum(qc*qc) mod 2^32 (signed int32
    wraparound) accumulated inside the quantize pass — the coefficient
    checksums against the device requantizer cost no extra host pass."""
    lib = native.load()
    c = np.ascontiguousarray(coefs.ravel(), np.float32)
    s = np.ascontiguousarray(inv_steps.ravel(), np.float32)
    if s.size != c.size:
        raise ValueError("inv_steps size mismatch")
    qc = np.empty(c.size, np.int32)
    buf = _tls_buf("buf", c.size * 8 + 1024, np.uint8)
    sums = np.zeros(2, np.uint32)
    fp = ct.POINTER(ct.c_float)
    u32p = ct.POINTER(ct.c_uint32)
    n = lib.bpc_encode_quant(c.ctypes.data_as(fp), s.ctypes.data_as(fp),
                             ct.c_float(inv_base),
                             qc.ctypes.data_as(u32p),
                             c.size,
                             buf.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                             buf.size, int(max_bytes),
                             sums.ctypes.data_as(u32p))
    if n <= 0:
        raise RuntimeError(f"bpc_encode_quant failed: {n}")
    return buf[:n].tobytes(), qc, int(sums[0]), int(sums[1])


def bpc_encode_quant(coefs: np.ndarray, inv_steps: np.ndarray,
                     inv_base: float, max_bytes: int = 0):
    """bpc_encode_quant_ck without the checksums: (bitstream, qc)."""
    bs, qc, _, _ = bpc_encode_quant_ck(coefs, inv_steps, inv_base, max_bytes)
    return bs, qc


def bpc_decode(bitstream: bytes, n: int) -> np.ndarray:
    lib = native.load()
    b = np.frombuffer(bitstream, np.uint8)   # decoder reads only
    c = np.empty(n, np.int32)                # decoder fully overwrites
    r = lib.bpc_decode(b.ctypes.data_as(ct.POINTER(ct.c_uint8)), b.size,
                       c.ctypes.data_as(ct.POINTER(ct.c_uint32)), n)
    if r != n:
        raise RuntimeError(f"bpc_decode failed: {r}")
    return c


def _fits_rice(qc: np.ndarray) -> bool:
    """Rice backend applies iff zigzag(qc) fits RICE_BITS (qc in int16
    range). Mirrored on device by wenc_size_bytes. The RLE backend shares
    this eligibility gate (its device size model's magnitude sums are then
    int32-exact, see rle_size_bytes_model)."""
    return bool(qc.min() >= -32768 and qc.max() <= 32767)


RLE_MARK = 0x20


def _seg_lens(segbounds, n: int) -> np.ndarray:
    if segbounds is None:
        return np.array([n], np.int64)
    segs = np.array([b - a for a, b in segbounds], np.int64)
    if int(segs.sum()) != n:
        raise ValueError("segbounds do not cover the stream")
    return segs


def rle_size_host(qc: np.ndarray, segbounds=None) -> int:
    """Exact total stream bytes (incl. the marker byte) of the wrle
    backend for scan-ordered int32 coefficients."""
    lib = native.load()
    qc = np.ascontiguousarray(qc.ravel(), np.int32)
    segs = _seg_lens(segbounds, qc.size)
    bits = lib.wrle_size_bits(
        qc.ctypes.data_as(ct.POINTER(ct.c_int32)), qc.size,
        segs.ctypes.data_as(ct.POINTER(ct.c_longlong)), len(segs))
    if bits < 0:
        raise RuntimeError(f"wrle_size_bits failed: {bits}")
    return 1 + (int(bits) + 7) // 8


def rle_encode(qc: np.ndarray, segbounds=None,
               size_bytes: int | None = None) -> bytes:
    """``size_bytes``: the already-known rle_size_host result (callers do
    the min-selection sizing pass anyway) — skips a second native sizing
    pass. Without it the buffer is exact-sized here: adversarial
    magnitudes (beyond the int16 eligibility gate this backend is
    selected under) can cost far more than 8 bytes/sample in unary."""
    lib = native.load()
    qc = np.ascontiguousarray(qc.ravel(), np.int32)
    segs = _seg_lens(segbounds, qc.size)
    if size_bytes is None:
        bits = lib.wrle_size_bits(
            qc.ctypes.data_as(ct.POINTER(ct.c_int32)), qc.size,
            segs.ctypes.data_as(ct.POINTER(ct.c_longlong)), len(segs))
        if bits < 0:
            raise RuntimeError(f"wrle_size_bits failed: {bits}")
        size_bytes = 1 + (int(bits) + 7) // 8
    buf = _tls_buf("rle", int(size_bytes) + 64, np.uint8)
    n = lib.wrle_encode(
        qc.ctypes.data_as(ct.POINTER(ct.c_int32)), qc.size,
        segs.ctypes.data_as(ct.POINTER(ct.c_longlong)), len(segs),
        buf.ctypes.data_as(ct.POINTER(ct.c_uint8)), buf.size)
    if n < 0:
        raise RuntimeError(f"wrle_encode failed: {n}")
    return bytes([RLE_MARK]) + buf[:n].tobytes()


def rle_decode(bitstream: bytes, n: int, segbounds=None) -> np.ndarray:
    lib = native.load()
    b = np.frombuffer(bitstream, np.uint8)
    segs = _seg_lens(segbounds, n)
    out = np.empty(n, np.int32)
    r = lib.wrle_decode(
        b.ctypes.data_as(ct.POINTER(ct.c_uint8)), b.size,
        segs.ctypes.data_as(ct.POINTER(ct.c_longlong)), len(segs),
        out.ctypes.data_as(ct.POINTER(ct.c_int32)), n)
    if r != n:
        raise RuntimeError(f"wrle_decode failed: {r}")
    return out


def _rice_cfg(qc: np.ndarray):
    """(J, rsi) by the shared sparsity rule (see RICE_J_SPARSE)."""
    if int(np.count_nonzero(qc)) * 32 < qc.size:
        return RICE_J_SPARSE, RICE_RSI_SPARSE
    return RICE_J, RICE_RSI


def _rice_header(J: int, rsi: int) -> int:
    """0x80 | log2(J) in bits 0-2 | (log2(rsi) - 1) in bits 3-4. J=1 is
    never a valid block size, so a zero J field (a bare 0x80 header from
    the earliest wenc streams, which carried an implicit J=8/rsi=2) is
    decoded as that legacy config. Bit 5 (SPLIT_FLAG) marks the split
    variant: a second header byte carries s, the count of raw LSBs per
    zigzag value packed ahead of the Rice stream of the high parts."""
    return RICE_MARK | (J.bit_length() - 1) | ((rsi.bit_length() - 2) << 3)


# Rice-split variant: when the zigzag overflows 16 bits, s = bitlen(max
# zigzag) - 16 raw LSBs per sample go ahead of the Rice stream of the
# 16-bit high parts
SPLIT_FLAG = 0x20


def _zigzag32(qc: np.ndarray) -> np.ndarray:
    """Zigzag of full-range int32 as uint32 (matches the device's
    wraparound (qc << 1) ^ (qc >> 31) trick bit-for-bit)."""
    q = qc.astype(np.int64)
    return (((q << 1) ^ (q >> 63)) & 0xFFFFFFFF).astype(np.uint32)


def _split_s(maxz: int) -> int:
    return max(0, int(maxz).bit_length() - 16)


def split_encode(qc: np.ndarray, J: int = RICE_J,
                 rsi: int = RICE_RSI) -> bytes:
    """[hdr | s | packed LSB planes (ceil(n*s/8) bytes) | Rice(z >> s)]."""
    from tpukit_torch.native import ccsds121_host as ck

    qc = np.ascontiguousarray(qc.ravel(), np.int32)
    z = _zigzag32(qc)
    s = _split_s(int(z.max()) if z.size else 0)
    zhi = (z >> s).astype(np.uint16)
    if s:
        lsb = (z & ((1 << s) - 1)).astype(">u2")
        bits = np.unpackbits(lsb.view(np.uint8)).reshape(-1, 16)[:, 16 - s:]
        block = np.packbits(bits.ravel()).tobytes()
    else:
        block = b""
    return (bytes([_rice_header(J, rsi) | SPLIT_FLAG, s]) + block
            + ck.encode(zhi, RICE_BITS, J, rsi, flags=0))


def split_decode(bitstream: bytes, n: int) -> np.ndarray:
    from tpukit_torch.native import ccsds121_host as ck

    if len(bitstream) < 2:
        raise RuntimeError("split stream truncated (no header)")
    hdr = bitstream[0]
    jf = hdr & 0x07
    J = 8 if jf == 0 else 1 << jf
    rsi = 1 << (((hdr >> 3) & 0x03) + 1)
    s = bitstream[1]
    if s > 16:
        raise RuntimeError(f"split stream corrupt: s={s} > 16")
    nlsb = (n * s + 7) // 8
    if len(bitstream) < 2 + nlsb:
        raise RuntimeError("split stream truncated (LSB block)")
    zhi = ck.decode(bitstream[2 + nlsb:], n, RICE_BITS, J, rsi, flags=0)
    z = zhi.astype(np.uint64) << s
    if s:
        bits = np.unpackbits(
            np.frombuffer(bitstream[2:2 + nlsb], np.uint8))[:n * s]
        w = (np.uint64(1) << np.arange(s - 1, -1, -1, dtype=np.uint64))
        z |= (bits.reshape(n, s).astype(np.uint64) * w).sum(
            axis=1, dtype=np.uint64)
    zi = z.astype(np.int64)
    return (((zi >> 1) ^ -(zi & 1)) & 0xFFFFFFFF).astype(np.uint32) \
        .astype(np.int32)


def split_size_host(qc: np.ndarray, J: int = RICE_J,
                    rsi: int = RICE_RSI) -> int:
    """Exact stream bytes of split_encode without materializing it."""
    from tpukit_torch.native import ccsds121_host as ck

    qc = np.ascontiguousarray(qc.ravel(), np.int32)
    z = _zigzag32(qc)
    s = _split_s(int(z.max()) if z.size else 0)
    zhi = (z >> s).astype(np.uint16)
    return 2 + (qc.size * s + 7) // 8 + len(
        ck.encode(zhi, RICE_BITS, J, rsi, flags=0))


def zigzag_np(qc: np.ndarray) -> np.ndarray:
    q = qc.astype(np.int32)
    return np.where(q >= 0, 2 * q, -2 * q - 1).astype(np.uint16)


def unzigzag_np(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.int32)
    return (z >> 1) ^ -(z & 1)


def wenc_encode(qc: np.ndarray, max_bytes: int = 0,
                segbounds=None) -> bytes:
    """Entropy-encode scan-ordered int32 coefficients with the
    auto-selected backend (strictly-smaller exact size wins; ties keep the
    Rice/bit-plane candidate — the device size model computes the same
    min, j2k_codec.wenc_size_bytes). ``max_bytes`` (byte budget) forces
    the embedded backend — only it has truncation semantics."""
    qc = np.ascontiguousarray(qc.ravel(), np.int32)
    if max_bytes:
        return bpc_encode(qc, max_bytes)
    fits = _fits_rice(qc)
    if qc.size % RICE_J == 0 and fits:
        from tpukit_torch.native import ccsds121_host as ck
        J, rsi = _rice_cfg(qc)
        base = bytes([_rice_header(J, rsi)]) + ck.encode(
            zigzag_np(qc), RICE_BITS, J, rsi, flags=0)
        rle_bytes = rle_size_host(qc, segbounds)
        if rle_bytes < len(base):
            return rle_encode(qc, segbounds, size_bytes=rle_bytes)
        return base
    base = bpc_encode(qc)
    if fits:
        rle_bytes = rle_size_host(qc, segbounds)
        if rle_bytes < len(base):
            return rle_encode(qc, segbounds, size_bytes=rle_bytes)
    elif qc.size % RICE_J == 0 and split_size_host(qc) < len(base):
        return split_encode(qc)
    return base


def wenc_decode(bitstream: bytes, n: int, segbounds=None) -> np.ndarray:
    if bitstream and (bitstream[0] & RICE_MARK):
        from tpukit_torch.native import ccsds121_host as ck
        if bitstream[0] & SPLIT_FLAG:
            return split_decode(bitstream, n)
        jf = bitstream[0] & 0x07
        J = 8 if jf == 0 else 1 << jf       # 0 == legacy implicit J=8
        rsi = 1 << (((bitstream[0] >> 3) & 0x03) + 1)
        z = ck.decode(bitstream[1:], n, RICE_BITS, J, rsi, flags=0)
        return unzigzag_np(z)
    if bitstream and (bitstream[0] & 0x40):   # 0x40|nplanes: bit-plane
        return bpc_decode(bitstream, n)
    if bitstream and bitstream[0] == RLE_MARK:
        return rle_decode(bitstream[1:], n, segbounds)
    raise RuntimeError(
        f"wenc stream has unknown backend marker "
        f"0x{bitstream[0]:02x}" if bitstream else "empty wenc stream")


def wenc_quant_encode_ck(coefs: np.ndarray, inv_steps: np.ndarray,
                         inv_base: float, segbounds=None):
    """Deadzone-quantize + auto-backend encode; returns
    (bitstream, qc, s1, s2) with the same wraparound-int32 checksums (and
    the same f32 multiply association order) as the device requantizer.

    The Rice case runs ONE fused native pass (ck121_quant_encode:
    quantize + checksums + zigzag + encode, no numpy temporaries), then
    compares the exact wrle candidate size (one native sizing pass over
    qc) and re-encodes only when wrle is strictly smaller — the same min
    the device size model computes. When the quantized values overflow
    int16 it reuses the already-quantized qc through the embedded backend
    (wrle shares the int16 eligibility gate)."""
    c = np.ascontiguousarray(coefs.ravel(), np.float32)
    s = np.ascontiguousarray(inv_steps.ravel(), np.float32)
    if s.size != c.size:
        raise ValueError("inv_steps size mismatch")
    n = c.size
    to_i32 = lambda v: v - (1 << 32) if v >= (1 << 31) else v
    if n % RICE_J == 0:
        lib = native.load()
        qc = np.empty(n, np.int32)
        out = _tls_buf("wq", n * 4 + 4096, np.uint8)
        sums = np.zeros(3, np.uint32)
        fp = ct.POINTER(ct.c_float)
        r = lib.ck121_quant_encode(
            c.ctypes.data_as(fp), s.ctypes.data_as(fp),
            ct.c_float(inv_base),
            qc.ctypes.data_as(ct.POINTER(ct.c_int32)), n, RICE_J, RICE_RSI,
            RICE_J_SPARSE, RICE_RSI_SPARSE,
            out.ctypes.data_as(ct.POINTER(ct.c_uint8)), out.size,
            sums.ctypes.data_as(ct.POINTER(ct.c_uint32)))
        if r > 0:
            rle_bytes = rle_size_host(qc, segbounds)
            if rle_bytes < 1 + r:
                return (rle_encode(qc, segbounds, size_bytes=rle_bytes),
                        qc, to_i32(int(sums[0])), to_i32(int(sums[1])))
            if sums[2]:
                hdr = _rice_header(RICE_J_SPARSE, RICE_RSI_SPARSE)
            else:
                hdr = _rice_header(RICE_J, RICE_RSI)
            return (bytes([hdr]) + out[:r].tobytes(), qc,
                    to_i32(int(sums[0])), to_i32(int(sums[1])))
        if r != -3:
            raise RuntimeError(f"ck121_quant_encode failed: {r}")
        # int16 overflow (very fine quantization): qc and checksums are
        # already computed — min of the embedded and Rice-split backends
        bpc = bpc_encode(qc)
        stream = (split_encode(qc) if split_size_host(qc) < len(bpc)
                  else bpc)
        return (stream, qc, to_i32(int(sums[0])), to_i32(int(sums[1])))
    # odd tail (never hit by padded tiles): plain numpy route
    qc = np.trunc(c * (s * np.float32(inv_base))).astype(np.int32)
    u = qc.astype(np.uint32)
    s1 = int(u.sum(dtype=np.uint64) & 0xFFFFFFFF)
    s2 = int((u * u).sum(dtype=np.uint64) & 0xFFFFFFFF)
    return wenc_encode(qc, segbounds=segbounds), qc, to_i32(s1), to_i32(s2)
