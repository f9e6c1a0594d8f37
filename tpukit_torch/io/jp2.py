# -*- coding: utf-8 -*-
# The port's copy of tpukit/io/jp2.py: only its imports point at the port.
"""JP2 / JPEG 2000 Part 1 reader (clean-room, ITU-T T.800 subset).

Sentinel-2 distributes its band rasters as JP2 files; the reference ingests
them through rasterio/GDAL/OpenJPEG (reference tools/make_baseline_A.py:13-19).
tpukit decodes the codestream in-framework: this module parses the JP2 boxes
and codestream markers (SIZ/COD/QCD/SOT), walks packets in any of the five
progression orders with tag-tree coded headers, hands code-block segments to
the native EBCOT tier-1 decoder (native/src/j2k_t1.cpp), and synthesizes the
reversible 5/3 wavelet at arbitrary (odd-sized, offset) geometries per
T.800 Annex F.

Scope: the profile Sentinel-2 / OpenJPEG-default lossless products use —
reversible 5/3, no subsampling, no POC/PPM/PPT, MQ-coded passes (no bypass /
termall). Sample-exact vs OpenJPEG (tests/test_jp2.py round-trips fixtures
written by Pillow's OpenJPEG encoder).
"""

from __future__ import annotations

import ctypes as ct
import math
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpukit_torch import native

# ---------------------------------------------------------------------------
# markers
SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, QCD, QCC, RGN, POC_M = 0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F
TLM, PLM, PLT, PPM, PPT, CRG, COM = 0xFF55, 0xFF57, 0xFF58, 0xFF60, 0xFF61, 0xFF63, 0xFF64
SOP, EPH = 0xFF91, 0xFF92


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# packet-header bit reader (B.10.1: bit-stuffing after 0xFF bytes)
class HdrBits:
    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.byte = 0
        self.ct = 0

    def bit(self) -> int:
        if self.ct == 0:
            prev = self.byte
            self.byte = self.data[self.pos]
            self.pos += 1
            self.ct = 7 if prev == 0xFF else 8
        self.ct -= 1
        return (self.byte >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def flush(self) -> int:
        """Align to byte boundary; skip the stuffed byte after a trailing
        0xFF (B.10.1). Returns the next byte offset."""
        self.ct = 0
        if self.byte == 0xFF:
            self.pos += 1  # stuffed zero-bit byte
        self.byte = 0
        return self.pos


# ---------------------------------------------------------------------------
# tag trees (B.10.2)
class TagTree:
    def __init__(self, w: int, h: int):
        self.dims: List[Tuple[int, int]] = []
        ww, hh = w, h
        while True:
            self.dims.append((ww, hh))
            if ww == 1 and hh == 1:
                break
            ww, hh = ceil_div(ww, 2), ceil_div(hh, 2)
        total = sum(a * b for a, b in self.dims)
        self.vmin = [0] * total
        self.known = [False] * total
        self.off = []
        o = 0
        for a, b in self.dims:
            self.off.append(o)
            o += a * b

    def _path(self, i: int, j: int) -> List[int]:
        p = []
        for lv, (a, b) in enumerate(self.dims):
            p.append(self.off[lv] + j * a + i)
            i //= 2
            j //= 2
        return p[::-1]  # root first

    def decode(self, br: HdrBits, i: int, j: int, threshold: int) -> bool:
        """True iff leaf value < threshold (reads just enough bits)."""
        low = 0
        for n in self._path(i, j):
            if self.vmin[n] < low:
                self.vmin[n] = low
            while not self.known[n] and self.vmin[n] < threshold:
                if br.bit():
                    self.known[n] = True
                else:
                    self.vmin[n] += 1
            low = self.vmin[n]
            if low >= threshold:
                return False
        return True

    def value(self, i: int, j: int) -> int:
        return self.vmin[self._path(i, j)[-1]]


# ---------------------------------------------------------------------------
# codestream structures
@dataclass
class CodingStyle:
    prog: int = 0          # 0 LRCP 1 RLCP 2 RPCL 3 PCRL 4 CPRL
    layers: int = 1
    mct: int = 0
    levels: int = 5        # decomposition levels NL
    xcb: int = 6           # code-block exp (log2 width), stored -2
    ycb: int = 6
    cblksty: int = 0
    transform: int = 1     # 1 = 5/3 reversible
    precw: List[int] = field(default_factory=list)   # PPx per resolution
    prech: List[int] = field(default_factory=list)
    use_sop: bool = False
    use_eph: bool = False


@dataclass
class Quant:
    style: int = 0         # 0 none(rev) 1 derived 2 expounded
    guard: int = 2
    exps: List[int] = field(default_factory=list)    # per band
    mants: List[int] = field(default_factory=list)


@dataclass
class Band:
    orient: int            # 0 LL 1 HL 2 LH 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    numbps: int            # Mb for this band
    incl: Optional[TagTree] = None
    imsb: Optional[TagTree] = None
    # per code-block state
    cb_included: Optional[np.ndarray] = None
    cb_lblock: Optional[np.ndarray] = None
    cb_zbp: Optional[np.ndarray] = None
    cb_passes: Optional[np.ndarray] = None
    cb_chunks: Optional[list] = None
    cw: int = 0            # code-block grid
    ch: int = 0
    cbx0: int = 0          # first code-block index
    cby0: int = 0


def _load_t1():
    lib = native.load()
    fn = lib.j2k_t1_decode_full
    fn.restype = ct.c_int64
    fn.argtypes = [ct.c_char_p, ct.c_int64, ct.POINTER(ct.c_int64),
                   ct.POINTER(ct.c_uint8), ct.c_int, ct.c_int, ct.c_int,
                   ct.c_int, ct.c_int, ct.c_int, ct.c_int,
                   ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32)]
    return fn


def _pass_is_raw(style: int, k: int) -> bool:
    """Selective AC bypass (D.6): significance and refinement passes are
    raw-coded from the 5th significant bit-plane on — absolute pass index
    k >= 10 with pass kind SPP/MRP; cleanup stays MQ."""
    return bool(style & 1) and k >= 10 and (k - 1) % 3 != 2


def _seg_boundary(style: int, k: int) -> bool:
    """True when a codeword-segment boundary falls between passes k-1 and
    k (D.4.1): termall terminates every pass; bypass terminates at each
    MQ<->raw transition."""
    if k <= 0:
        return False
    if style & 4:
        return True
    if style & 1:
        return _pass_is_raw(style, k) != _pass_is_raw(style, k - 1)
    return False


def t1_segments(style: int, npasses: int):
    """Codeword segments of a block coded with npasses total passes:
    list of (first_pass, npasses, is_raw)."""
    segs = []
    start = 0
    for k in range(1, npasses + 1):
        if k == npasses or _seg_boundary(style, k):
            segs.append((start, k - start, _pass_is_raw(style, start)))
            start = k
    return segs


def block_segs(style: int, piece_passes, chunks, total_passes: int):
    """Group a block's packet pieces into codeword segments: returns the
    [(nbytes, is_raw), ...] that t1_decode_block expects, or None for the
    single-MQ-segment default style.  Pieces never span segment
    boundaries (the packet reader splits lengths there), but one segment
    may arrive as several pieces across layers."""
    if not (style & 5):
        return None
    segs = t1_segments(style, total_passes)
    lens = [0] * len(segs)
    si, k = 0, 0
    for np_piece, chunk in zip(piece_passes, chunks):
        while k >= segs[si][0] + segs[si][1]:
            si += 1
        lens[si] += len(chunk)
        k += np_piece
    return [(lens[i], segs[i][2]) for i in range(len(segs))]


def t1_decode_block(data: bytes, passes: int, numbps: int, orient: int,
                    style: int, w: int, h: int, want_lastp: bool = False,
                    segs=None):
    """Decode one code-block.  Returns the sign-magnitude (h, w) array, or
    with want_lastp a (coefs, lastp) pair where lastp[i] is the bit-plane
    of coefficient i's last magnitude update (-1 if never significant) —
    the per-coefficient dequant-midpoint position.

    segs: optional [(nbytes, is_raw), ...] codeword segments for
    bypass/termall blocks (must cover `data` and match
    t1_segments(style, passes)); default is one MQ segment."""
    fn = _load_t1()
    out = np.zeros(w * h, np.int32)
    lastp = np.zeros(w * h, np.int32)
    if not segs:
        segs = [(len(data), False)]
    seg = (ct.c_int64 * len(segs))(*(s[0] for s in segs))
    raw = (ct.c_uint8 * len(segs))(*(1 if s[1] else 0 for s in segs))
    r = fn(data, len(data), seg, raw, len(segs), passes, numbps, orient,
           style, w, h, out.ctypes.data_as(ct.POINTER(ct.c_int32)),
           lastp.ctypes.data_as(ct.POINTER(ct.c_int32)))
    if r < 0:
        raise ValueError(f"tier-1 decode failed: {r}")
    if want_lastp:
        return out.reshape(h, w), lastp.reshape(h, w)
    return out.reshape(h, w)


# ---------------------------------------------------------------------------
# inverse reversible 5/3 at arbitrary geometry (T.800 F.3.8)
def _sr1d_53(x: np.ndarray, i0: int) -> np.ndarray:
    """1D synthesis along the last axis; the signal covers absolute
    coordinates [i0, i0+n) (parity decides the even/odd interleave)."""
    n = x.shape[-1]
    if n == 0:
        return x
    x = x.astype(np.int64)
    if n == 1:
        if i0 % 2:  # single high-pass sample: X = Y/2 (trunc toward 0)
            return (x - np.sign(x) * (np.abs(x) % 2)) // 2
        return x
    # symmetric extension by 1 on both sides (whole-point reflection)
    ext = np.concatenate([x[..., 1:2], x, x[..., -2:-1]], axis=-1)
    # ext[j] holds absolute coordinate i0 - 1 + j
    # step 1: even coordinates  X(2m) = Y(2m) - floor((Y(2m-1)+Y(2m+1)+2)/4)
    e0 = (i0 + 1) % 2   # smallest ext index with even absolute coordinate
    out = ext.copy()
    je = np.arange(e0, n + 2, 2)
    je = je[(je >= 1) & (je <= n)]
    out[..., je] = ext[..., je] - ((ext[..., je - 1] + ext[..., je + 1] + 2) >> 2)
    # re-extend the updated evens so odd-boundary steps see reflected values
    out[..., 0] = out[..., 2] if n >= 2 else out[..., 0]
    out[..., n + 1] = out[..., n - 1]
    # step 2: odd coordinates   X(2m+1) = Y(2m+1) + floor((X(2m)+X(2m+2))/2)
    jo = np.arange(e0 + 1, n + 2, 2)
    jo = jo[(jo >= 1) & (jo <= n)]
    out[..., jo] = ext[..., jo] + ((out[..., jo - 1] + out[..., jo + 1]) >> 1)
    return out[..., 1:n + 1]


def sr2d_53(ll: np.ndarray, hl: np.ndarray, lh: np.ndarray, hh: np.ndarray,
            u0: int, v0: int, u1: int, v1: int) -> np.ndarray:
    """One 2D synthesis level: interleave subbands over the resolution
    region [u0,u1)x[v0,v1) (absolute coords), then horizontal + vertical
    1D synthesis."""
    h, w = v1 - v0, u1 - u0
    a = np.zeros((h, w), np.int64)
    # 2D_INTERLEAVE (F.3.3): LL at (even,even) ... in absolute coords
    ev_u = ((-u0) % 2)   # first even column index
    od_u = 1 - ev_u
    ev_v = ((-v0) % 2)
    od_v = 1 - ev_v
    a[ev_v::2, ev_u::2] = ll
    a[ev_v::2, od_u::2] = hl
    a[od_v::2, ev_u::2] = lh
    a[od_v::2, od_u::2] = hh
    a = _sr1d_53(a, u0)                        # horizontal (rows)
    a = _sr1d_53(np.swapaxes(a, -1, -2), v0)   # vertical (columns)
    return np.swapaxes(a, -1, -2)


# ---------------------------------------------------------------------------
# inverse irreversible 9/7 at arbitrary geometry (T.800 F.4.8.2)
_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001


def _sr1d_97(x: np.ndarray, i0: int) -> np.ndarray:
    """1D 9/7 synthesis along the last axis; the signal covers absolute
    coordinates [i0, i0+n).  Float lifting per T.800 F.4.8.2: scale, then
    the four inverse lifting steps (-delta, -gamma, -beta, -alpha), each
    reaching only nearest neighbours, with whole-point symmetric extension
    re-applied between steps (same geometry machinery as _sr1d_53)."""
    n = x.shape[-1]
    if n == 0:
        return x
    x = x.astype(np.float64)
    # scaling (F-28/F-29): even abs coords (low-pass) * K, odd * 1/K
    ev = ((np.arange(n) + i0) % 2) == 0
    if n == 1:
        return x * (_K97 if i0 % 2 == 0 else 1.0 / _K97)
    x = np.where(ev, x * _K97, x / _K97)
    ext = np.concatenate([x[..., 1:2], x, x[..., -2:-1]], axis=-1)
    out = ext.copy()
    e0 = (i0 + 1) % 2   # smallest ext index with even absolute coordinate
    je = np.arange(e0, n + 2, 2)
    je = je[(je >= 1) & (je <= n)]
    jo = np.arange(e0 + 1, n + 2, 2)
    jo = jo[(jo >= 1) & (jo <= n)]

    def _reext(a):
        a[..., 0] = a[..., 2]
        a[..., n + 1] = a[..., n - 1]

    out[..., je] = ext[..., je] - _D97 * (ext[..., je - 1] + ext[..., je + 1])
    _reext(out)
    out[..., jo] = out[..., jo] - _G97 * (out[..., jo - 1] + out[..., jo + 1])
    _reext(out)
    out[..., je] = out[..., je] - _B97 * (out[..., je - 1] + out[..., je + 1])
    _reext(out)
    out[..., jo] = out[..., jo] - _A97 * (out[..., jo - 1] + out[..., jo + 1])
    return out[..., 1:n + 1]


def sr2d_97(ll, hl, lh, hh, u0: int, v0: int, u1: int, v1: int) -> np.ndarray:
    """One 2D 9/7 synthesis level over [u0,u1)x[v1,v1) (absolute coords);
    float in, float out; same interleave conventions as sr2d_53."""
    h, w = v1 - v0, u1 - u0
    a = np.zeros((h, w), np.float64)
    ev_u = ((-u0) % 2)
    od_u = 1 - ev_u
    ev_v = ((-v0) % 2)
    od_v = 1 - ev_v
    a[ev_v::2, ev_u::2] = ll
    a[ev_v::2, od_u::2] = hl
    a[od_v::2, ev_u::2] = lh
    a[od_v::2, od_u::2] = hh
    a = _sr1d_97(a, u0)
    a = _sr1d_97(np.swapaxes(a, -1, -2), v0)
    return np.swapaxes(a, -1, -2)


def _dequant_mid(blk: np.ndarray, lastp: np.ndarray,
                 step: float) -> np.ndarray:
    """Irreversible dequantization with the per-coefficient midpoint
    (E.1.1 + block-truncation half): fused native pass when available
    (j2k_dequant_mid — identical per-element arithmetic), numpy oracle
    otherwise."""
    try:
        from tpukit_torch import native
        lib = native.load()
        fn = lib.j2k_dequant_mid
    except Exception:
        fn = None
    if fn is not None:
        import ctypes as ct
        b = np.ascontiguousarray(blk, np.int32)
        lp = np.ascontiguousarray(lastp, np.int32)
        out = np.empty(b.shape, np.float64)
        if fn(b.ctypes.data_as(ct.POINTER(ct.c_int32)),
              lp.ctypes.data_as(ct.POINTER(ct.c_int32)),
              b.size, float(step),
              out.ctypes.data_as(ct.POINTER(ct.c_double))) == 0:
            return out
    mag = np.abs(blk).astype(np.float64)
    half = 0.5 * np.exp2(np.maximum(lastp, 0))
    return np.where(mag > 0, np.sign(blk) * (mag + half) * step, 0.0)


def _sr2d_fast(rev: bool, ll, hl, lh, hh, u0: int, v0: int,
               u1: int, v1: int) -> np.ndarray:
    """One 2D synthesis level through the native lifting when available
    (j2k_sr2d_53/97 — bit-exact to sr2d_53/sr2d_97, fuzz-pinned in
    tests/test_j2c_enc.py), numpy reference otherwise. Same contract as
    sr2d_53/sr2d_97."""
    try:
        from tpukit_torch import native
        lib = native.load()
        fn = lib.j2k_sr2d_53 if rev else lib.j2k_sr2d_97
    except Exception:
        return (sr2d_53 if rev else sr2d_97)(ll, hl, lh, hh,
                                             u0, v0, u1, v1)
    import ctypes as ct
    h, w = v1 - v0, u1 - u0
    a = np.zeros((h, w), np.int64 if rev else np.float64)
    ev_u = ((-u0) % 2)
    od_u = 1 - ev_u
    ev_v = ((-v0) % 2)
    od_v = 1 - ev_v
    a[ev_v::2, ev_u::2] = ll
    a[ev_v::2, od_u::2] = hl
    a[od_v::2, ev_u::2] = lh
    a[od_v::2, od_u::2] = hh
    ptr = ct.POINTER(ct.c_int64 if rev else ct.c_double)
    if fn(a.ctypes.data_as(ptr), h, w, u0, v0) < 0:
        raise ValueError("native synthesis failed")
    return a


def band_rect(tcx0, tcy0, tcx1, tcy1, nb, xob, yob):
    """Subband rectangle (B-15). nb==0 is the NL=0 LL band (the whole
    tile-component): xob==yob==0 there, so the half-step term vanishes."""
    d = 1 << nb
    h = (1 << (nb - 1)) if nb > 0 else 0
    return (ceil_div(tcx0 - h * xob, d), ceil_div(tcy0 - h * yob, d),
            ceil_div(tcx1 - h * xob, d), ceil_div(tcy1 - h * yob, d))


# ---------------------------------------------------------------------------
class JP2Decoder:
    def __init__(self, data: bytes):
        self.data = data
        cs = self._find_codestream(data)
        self.cs = cs
        self._tiles = {}   # (tx, ty) -> [component arrays]
        self._parse_main_header()

    # -- container ----------------------------------------------------------
    @staticmethod
    def _find_codestream(data: bytes) -> bytes:
        if data[:4] == b"\xffO\xffQ" or data[:2] == b"\xff\x4f":
            return data  # raw codestream (.j2k/.j2c)
        pos = 0
        n = len(data)
        while pos + 8 <= n:
            (lbox,) = struct.unpack_from(">I", data, pos)
            tbox = data[pos + 4:pos + 8]
            hdr = 8
            if lbox == 1:
                (lbox,) = struct.unpack_from(">Q", data, pos + 8)
                hdr = 16
            elif lbox == 0:
                lbox = n - pos
            if tbox == b"jp2c":
                return data[pos + hdr:pos + lbox]
            pos += lbox
        raise ValueError("No jp2c codestream box found")

    # -- main header ---------------------------------------------------------
    def _parse_main_header(self):
        cs = self.cs
        if struct.unpack_from(">H", cs, 0)[0] != SOC:
            raise ValueError("missing SOC")
        pos = 2
        self.cod = CodingStyle()
        self.qcd = Quant()
        self.coc: Dict[int, CodingStyle] = {}
        self.qcc: Dict[int, Quant] = {}
        self.tileparts: Dict[int, List[Tuple[int, int]]] = {}
        while pos < len(cs):
            (mk,) = struct.unpack_from(">H", cs, pos)
            if mk == SOT:
                break
            (ln,) = struct.unpack_from(">H", cs, pos + 2)
            body = cs[pos + 4:pos + 2 + ln]
            if mk == SIZ:
                self._parse_siz(body)
            elif mk == COD:
                self.cod = self._parse_cod(body)
            elif mk == COC:
                c, st = self._parse_coc(body)
                self.coc[c] = st
            elif mk == QCD:
                self.qcd = self._parse_qcd(body)
            elif mk == QCC:
                c, q = self._parse_qcc(body)
                self.qcc[c] = q
            elif mk in (POC_M, PPM):
                raise NotImplementedError(f"marker 0x{mk:04X} unsupported")
            # TLM/PLM/CRG/COM: informational, skip
            pos += 2 + ln
        self._scan_tileparts(pos)

    def _parse_siz(self, b: bytes):
        (_, xs, ys, xo, yo, xt, yt, xto, yto, nc) = struct.unpack_from(
            ">HIIIIIIIIH", b, 0)
        self.xsiz, self.ysiz, self.xosiz, self.yosiz = xs, ys, xo, yo
        self.xtsiz, self.ytsiz, self.xtosiz, self.ytosiz = xt, yt, xto, yto
        self.ncomp = nc
        self.ssiz = []
        self.subs = []
        off = 36
        for _ in range(nc):
            s, xr, yr = struct.unpack_from(">BBB", b, off)
            off += 3
            if (xr, yr) != (1, 1):
                raise NotImplementedError("component subsampling unsupported")
            self.ssiz.append(s)
            self.subs.append((xr, yr))
        self.ntx = ceil_div(xs - xto, xt)
        self.nty = ceil_div(ys - yto, yt)

    @staticmethod
    def _parse_cod(b: bytes) -> CodingStyle:
        st = CodingStyle()
        scod = b[0]
        st.use_sop = bool(scod & 2)
        st.use_eph = bool(scod & 4)
        st.prog = b[1]
        st.layers = struct.unpack_from(">H", b, 2)[0]
        st.mct = b[4]
        st.levels = b[5]
        st.xcb = (b[6] & 0x0F) + 2
        st.ycb = (b[7] & 0x0F) + 2
        st.cblksty = b[8]
        st.transform = 1 if b[9] == 1 else 0  # SPcod: 1 = reversible 5/3
        if scod & 1:
            st.precw = []
            st.prech = []
            for r in range(st.levels + 1):
                v = b[10 + r]
                st.precw.append(v & 0x0F)
                st.prech.append(v >> 4)
        else:
            st.precw = [15] * (st.levels + 1)
            st.prech = [15] * (st.levels + 1)
        return st

    def _parse_coc(self, b: bytes):
        i = 0
        if self.ncomp < 257:
            c = b[0]
            i = 1
        else:
            c = struct.unpack_from(">H", b, 0)[0]
            i = 2
        st = CodingStyle()
        scoc = b[i]
        base = self.cod
        st.use_sop, st.use_eph = base.use_sop, base.use_eph
        st.prog, st.layers, st.mct = base.prog, base.layers, base.mct
        st.levels = b[i + 1]
        st.xcb = (b[i + 2] & 0x0F) + 2
        st.ycb = (b[i + 3] & 0x0F) + 2
        st.cblksty = b[i + 4]
        st.transform = 1 if b[i + 5] == 1 else 0
        if scoc & 1:
            st.precw, st.prech = [], []
            for r in range(st.levels + 1):
                v = b[i + 6 + r]
                st.precw.append(v & 0x0F)
                st.prech.append(v >> 4)
        else:
            st.precw = [15] * (st.levels + 1)
            st.prech = [15] * (st.levels + 1)
        return c, st

    @staticmethod
    def _parse_qcd(b: bytes) -> Quant:
        q = Quant()
        sq = b[0]
        q.guard = sq >> 5
        q.style = sq & 0x1F
        if q.style == 0:
            q.exps = [v >> 3 for v in b[1:]]
        elif q.style == 1:
            v = struct.unpack_from(">H", b, 1)[0]
            q.exps = [v >> 11]
            q.mants = [v & 0x7FF]
        else:
            q.exps, q.mants = [], []
            for off in range(1, len(b), 2):
                v = struct.unpack_from(">H", b, off)[0]
                q.exps.append(v >> 11)
                q.mants.append(v & 0x7FF)
        return q

    def _parse_qcc(self, b: bytes):
        if self.ncomp < 257:
            c = b[0]
            rest = b[1:]
        else:
            c = struct.unpack_from(">H", b, 0)[0]
            rest = b[2:]
        return c, self._parse_qcd(rest)

    def _scan_tileparts(self, pos: int):
        cs = self.cs
        while pos + 4 <= len(cs):
            (mk,) = struct.unpack_from(">H", cs, pos)
            if mk == EOC:
                break
            if mk != SOT:
                raise ValueError(f"expected SOT at {pos}, got 0x{mk:04X}")
            (ln, isot, psot, _tpsot, _tnsot) = struct.unpack_from(
                ">HHIBB", cs, pos + 2)
            if psot == 0 or pos + psot > len(cs):
                # open-ended (Psot=0) or truncated final tile-part:
                # take what is actually present (progressive streams are
                # cut mid-body by design)
                psot = len(cs) - pos
            body0 = pos + 2 + ln
            # walk to SOD; tile-part header overrides (COD/COC/QCD/QCC/
            # POC/PPT) would silently change the decode parameters, so
            # reject them loudly like the main-header POC/PPM paths
            (mk2,) = struct.unpack_from(">H", cs, body0)
            p2 = body0
            while mk2 != SOD:
                if mk2 in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5F, 0xFF61):
                    raise NotImplementedError(
                        f"tile-part marker 0x{mk2:04X} overrides "
                        f"unsupported")
                (l2,) = struct.unpack_from(">H", cs, p2 + 2)
                p2 += 2 + l2
                (mk2,) = struct.unpack_from(">H", cs, p2)
            data0 = p2 + 2
            self.tileparts.setdefault(isot, []).append((data0, pos + psot))
            pos += psot

    # -- tile decode ----------------------------------------------------------
    def _style_for(self, c: int) -> CodingStyle:
        return self.coc.get(c, self.cod)

    def _quant_for(self, c: int) -> Quant:
        return self.qcc.get(c, self.qcd)

    def _band_step(self, c: int, r: int, orient: int) -> float:
        """Irreversible quantization step Delta_b (E-3): 2^(Rb - eps) *
        (1 + mant / 2^11) with Rb = component depth + band gain."""
        q = self._quant_for(c)
        st = self._style_for(c)
        nl = st.levels
        depth = (self.ssiz[c] & 0x7F) + 1
        gain = (0, 1, 1, 2)[orient]
        bi = 0 if r == 0 else 3 * (r - 1) + orient
        if q.style == 1:   # derived (E-5)
            nb = nl - r + 1 if r > 0 else nl
            eps = q.exps[0] - nl + nb
            mant = q.mants[0]
        else:
            eps = q.exps[min(bi, len(q.exps) - 1)]
            mant = q.mants[min(bi, len(q.mants) - 1)] if q.mants else 0
        return float(2.0 ** (depth + gain - eps) * (1.0 + mant / 2048.0))

    def _band_numbps(self, c: int, r: int, orient: int) -> int:
        q = self._quant_for(c)
        st = self._style_for(c)
        nl = st.levels
        # band index in QCD order: LL, then (HL,LH,HH) per level r=1..NL
        if r == 0:
            bi = 0
        else:
            bi = 3 * (r - 1) + orient
        if q.style == 1:  # derived: eps_b = eps_0 - NL + nb (E-5)
            nb = nl - r + 1 if r > 0 else nl
            eps = q.exps[0] - nl + nb
        else:
            eps = q.exps[min(bi, len(q.exps) - 1)]
        return eps + q.guard - 1

    def decode_component(self, tx: int, ty: int, c: int) -> np.ndarray:
        """Decode one tile-component; returns the signed int array over the
        tile-component region (inverse MCT applied when signalled)."""
        return self.decode_tile(tx, ty)[c]

    def decode_tile(self, tx: int, ty: int):
        """Decode every component of one tile: one packet walk feeds all
        components (packets interleave them), then per-component
        synthesis, inverse multi-component transform (RCT/ICT, G.1) and
        DC level shift.  Results are cached per tile."""
        key = (tx, ty)
        if key in self._tiles:
            return self._tiles[key]
        tidx = ty * self.ntx + tx
        tx0 = max(self.xtosiz + tx * self.xtsiz, self.xosiz)
        ty0 = max(self.ytosiz + ty * self.ytsiz, self.yosiz)
        tx1 = min(self.xtosiz + (tx + 1) * self.xtsiz, self.xsiz)
        ty1 = min(self.ytosiz + (ty + 1) * self.ytsiz, self.ysiz)

        res_all = [self._build_comp_structs(c, tx0, ty0, tx1, ty1)
                   for c in range(self.ncomp)]
        parts = self.tileparts.get(tidx, [])
        if not parts:
            raise ValueError(f"no tile-parts for tile {tidx}")
        buf = b"".join(self.cs[a:b] for a, b in parts)
        self._read_packets(buf, res_all)

        raws = [self._synthesize(res_all[c], self._style_for(c),
                                 tx0, ty0, tx1, ty1, c)
                for c in range(self.ncomp)]
        if self.cod.mct and self.ncomp >= 3:
            y, u, v = raws[0], raws[1], raws[2]
            if self._style_for(0).transform == 1:    # inverse RCT (G-6..8)
                g = y - ((u + v) >> 2)
                raws[0], raws[1], raws[2] = v + g, g, u + g
            else:                                    # inverse ICT
                raws[0] = y + 1.402 * v
                raws[1] = y - 0.344136 * u - 0.714136 * v
                raws[2] = y + 1.772 * u
        out = []
        for c in range(self.ncomp):
            a = raws[c]
            signed = bool(self.ssiz[c] & 0x80)
            depth = (self.ssiz[c] & 0x7F) + 1
            shift = 0 if signed else (1 << (depth - 1))
            if a.dtype.kind == "f":                  # irreversible path
                lo = -(1 << (depth - 1)) if signed else 0
                a = np.clip(np.rint(a) + shift, lo,
                            lo + (1 << depth) - 1).astype(np.int64)
            else:
                a = a + shift
            out.append(a)
        self._tiles[key] = out
        return out

    def _build_comp_structs(self, c: int, tx0, ty0, tx1, ty1):
        st = self._style_for(c)
        if st.transform not in (0, 1):
            raise NotImplementedError(f"unknown transform {st.transform}")
        nl = st.levels

        # resolutions and bands
        res = []
        for r in range(nl + 1):
            d = 1 << (nl - r)
            trx0, try0 = ceil_div(tx0, d), ceil_div(ty0, d)
            trx1, try1 = ceil_div(tx1, d), ceil_div(ty1, d)
            bands = []
            if r == 0:
                bx0, by0, bx1, by1 = band_rect(tx0, ty0, tx1, ty1, nl, 0, 0)
                bands.append(Band(0, bx0, by0, bx1, by1,
                                  self._band_numbps(c, 0, 0)))
            else:
                nb = nl - r + 1
                for orient, (xob, yob) in ((1, (1, 0)), (2, (0, 1)),
                                           (3, (1, 1))):
                    bx0, by0, bx1, by1 = band_rect(tx0, ty0, tx1, ty1, nb,
                                                   xob, yob)
                    bands.append(Band(orient, bx0, by0, bx1, by1,
                                      self._band_numbps(c, r, orient)))
            res.append(dict(trx0=trx0, try0=try0, trx1=trx1, try1=try1,
                            bands=bands, r=r))

        # precinct + code-block bookkeeping per band
        for rinfo in res:
            r = rinfo["r"]
            ppx, ppy = st.precw[r], st.prech[r]
            trx0, try0 = rinfo["trx0"], rinfo["try0"]
            trx1, try1 = rinfo["trx1"], rinfo["try1"]
            if trx1 > trx0 and try1 > try0:
                npw = ceil_div(trx1, 1 << ppx) - (trx0 >> ppx)
                nph = ceil_div(try1, 1 << ppy) - (try0 >> ppy)
            else:
                npw = nph = 0
            rinfo["npw"], rinfo["nph"] = npw, nph
            # effective code-block size
            xcb = min(st.xcb, ppx - 1 if r > 0 else ppx)
            ycb = min(st.ycb, ppy - 1 if r > 0 else ppy)
            rinfo["xcb"], rinfo["ycb"] = xcb, ycb
            for band in rinfo["bands"]:
                if band.x1 > band.x0 and band.y1 > band.y0:
                    band.cbx0 = band.x0 >> xcb
                    band.cby0 = band.y0 >> ycb
                    band.cw = ceil_div(band.x1, 1 << xcb) - band.cbx0
                    band.ch = ceil_div(band.y1, 1 << ycb) - band.cby0
                else:
                    band.cw = band.ch = 0
                n = max(band.cw * band.ch, 1)
                band.cb_included = np.zeros(n, bool)
                band.cb_lblock = np.full(n, 3, np.int32)
                band.cb_zbp = np.zeros(n, np.int32)
                band.cb_passes = np.zeros(n, np.int32)
                band.cb_chunks = [[] for _ in range(n)]
                band.cb_piece_passes = [[] for _ in range(n)]
                # tag trees are PER PRECINCT: build lazily
                band.incl = {}
                band.imsb = {}
        return res

    # -- packet walking -------------------------------------------------------
    def _precinct_cb_range(self, rinfo, band, ppx, ppy, pi, pj):
        """Code-block index rectangle of precinct (pi, pj) within band."""
        r = rinfo["r"]
        shift = 1 if r > 0 else 0
        # precinct rect on the resolution grid
        px0 = max(((rinfo["trx0"] >> ppx) + pi) << ppx, rinfo["trx0"])
        py0 = max(((rinfo["try0"] >> ppy) + pj) << ppy, rinfo["try0"])
        px1 = min((((rinfo["trx0"] >> ppx) + pi + 1) << ppx), rinfo["trx1"])
        py1 = min((((rinfo["try0"] >> ppy) + pj + 1) << ppy), rinfo["try1"])
        if px1 <= px0 or py1 <= py0:
            return 0, 0, 0, 0, (0, 0, 0, 0)
        # map the precinct rect to band coordinates (B-17)
        if r == 0:
            qx0, qy0, qx1, qy1 = px0, py0, px1, py1
        else:
            xob = 1 if band.orient in (1, 3) else 0
            yob = 1 if band.orient in (2, 3) else 0
            qx0 = ceil_div(px0 - xob, 2)
            qy0 = ceil_div(py0 - yob, 2)
            qx1 = ceil_div(px1 - xob, 2)
            qy1 = ceil_div(py1 - yob, 2)
        qx0, qy0 = max(qx0, band.x0), max(qy0, band.y0)
        qx1, qy1 = min(qx1, band.x1), min(qy1, band.y1)
        if qx1 <= qx0 or qy1 <= qy0:
            return 0, 0, 0, 0, (0, 0, 0, 0)
        xcb, ycb = rinfo["xcb"], rinfo["ycb"]
        ci0 = (qx0 >> xcb) - band.cbx0
        cj0 = (qy0 >> ycb) - band.cby0
        ci1 = ceil_div(qx1, 1 << xcb) - band.cbx0
        cj1 = ceil_div(qy1, 1 << ycb) - band.cby0
        return ci0, cj0, ci1, cj1, (qx0, qy0, qx1, qy1)

    def _read_packets(self, buf: bytes, res_all):
        pos = 0
        cod = self.cod
        ncomp = len(res_all)
        sts = [self._style_for(c) for c in range(ncomp)]
        nl_max = max(s.levels for s in sts)

        def by_position(entries):
            """(c, r, pi, pj) in position-major order (B.12.1.3-5): each
            resolution's precinct packet is emitted at the tile coordinate
            where that precinct starts (tile-origin special case for
            unaligned grids).  `entries` fixes the inner (c, r) order."""
            st0 = sts[entries[0][0]]
            tr = res_all[entries[0][0]][st0.levels]
            tX0, tY0 = tr["trx0"], tr["try0"]
            tX1, tY1 = tr["trx1"], tr["try1"]
            xs, ys = {tX0}, {tY0}
            for c, r in entries:
                st = sts[c]
                d = st.levels - r
                sx = 1 << (st.precw[r] + d)
                sy = 1 << (st.prech[r] + d)
                xs.update(range((tX0 // sx + 1) * sx, tX1, sx))
                ys.update(range((tY0 // sy + 1) * sy, tY1, sy))
            for y in sorted(ys):
                for x in sorted(xs):
                    for c, r in entries:
                        st = sts[c]
                        rinfo = res_all[c][r]
                        if rinfo["npw"] == 0 or rinfo["nph"] == 0:
                            continue
                        d = st.levels - r
                        sx = 1 << (st.precw[r] + d)
                        sy = 1 << (st.prech[r] + d)
                        ok_x = (x % sx == 0) or (
                            x == tX0 and (rinfo["trx0"] << d) % sx)
                        ok_y = (y % sy == 0) or (
                            y == tY0 and (rinfo["try0"] << d) % sy)
                        if not (ok_x and ok_y):
                            continue
                        pi = ((ceil_div(x, 1 << d) >> st.precw[r])
                              - (rinfo["trx0"] >> st.precw[r]))
                        pj = ((ceil_div(y, 1 << d) >> st.prech[r])
                              - (rinfo["try0"] >> st.prech[r]))
                        if (0 <= pi < rinfo["npw"]
                                and 0 <= pj < rinfo["nph"]):
                            yield c, r, pi, pj

        def packets_in_order():
            layers = cod.layers
            if cod.prog in (0, 1):  # LRCP / RLCP
                outer = ([(l, r) for l in range(layers)
                          for r in range(nl_max + 1)] if cod.prog == 0 else
                         [(l, r) for r in range(nl_max + 1)
                          for l in range(layers)])
                for l, r in outer:
                    for c in range(ncomp):
                        if r > sts[c].levels:
                            continue
                        rinfo = res_all[c][r]
                        for pj in range(rinfo["nph"]):
                            for pi in range(rinfo["npw"]):
                                yield l, c, r, pi, pj
            elif cod.prog == 2:  # RPCL: resolution, position, component
                for r in range(nl_max + 1):
                    ents = [(c, r) for c in range(ncomp)
                            if r <= sts[c].levels]
                    for c, r2, pi, pj in by_position(ents):
                        for l in range(layers):
                            yield l, c, r2, pi, pj
            elif cod.prog == 3:  # PCRL: position, component, resolution
                ents = [(c, r) for c in range(ncomp)
                        for r in range(sts[c].levels + 1)]
                for c, r, pi, pj in by_position(ents):
                    for l in range(layers):
                        yield l, c, r, pi, pj
            elif cod.prog == 4:  # CPRL: component, position, resolution
                for c in range(ncomp):
                    ents = [(c, r) for r in range(sts[c].levels + 1)]
                    for c2, r, pi, pj in by_position(ents):
                        for l in range(layers):
                            yield l, c2, r, pi, pj
            else:
                raise NotImplementedError(
                    f"progression order {cod.prog} unsupported")

        for (l, c, r, pi, pj) in packets_in_order():
            if pos >= len(buf):
                break          # truncated stream: keep what arrived
            res = res_all[c]
            st = sts[c]
            rinfo = res[r]
            ppx, ppy = st.precw[r], st.prech[r]
            if cod.use_sop and buf[pos:pos + 2] == b"\xff\x91":
                pos += 6
            br = HdrBits(buf, pos)
            if pos >= len(buf):
                break
            body_specs = []
            try:
                nonempty = br.bit()
                bands_iter = rinfo["bands"] if nonempty else []
                for band in bands_iter:
                    if band.cw == 0:
                        continue
                    ci0, cj0, ci1, cj1, _ = self._precinct_cb_range(
                        rinfo, band, ppx, ppy, pi, pj)
                    if ci1 <= ci0 or cj1 <= cj0:
                        continue
                    pw, ph = ci1 - ci0, cj1 - cj0
                    key = (pi, pj)
                    if key not in band.incl:
                        band.incl[key] = TagTree(pw, ph)
                        band.imsb[key] = TagTree(pw, ph)
                    itree, ztree = band.incl[key], band.imsb[key]
                    for cj in range(cj0, cj1):
                        for ci in range(ci0, ci1):
                            n = cj * band.cw + ci
                            li, lj = ci - ci0, cj - cj0
                            if not band.cb_included[n]:
                                inc = itree.decode(br, li, lj, l + 1)
                            else:
                                inc = br.bit() == 1
                            if not inc:
                                continue
                            if not band.cb_included[n]:
                                # zero bit-planes: raise threshold to known
                                zb = 1
                                while not ztree.decode(br, li, lj, zb):
                                    zb += 1
                                band.cb_zbp[n] = zb - 1
                                band.cb_included[n] = True
                            # pass count
                            if br.bit() == 0:
                                np_new = 1
                            elif br.bit() == 0:
                                np_new = 2
                            else:
                                v = br.bits(2)
                                if v < 3:
                                    np_new = 3 + v
                                else:
                                    v = br.bits(5)
                                    if v < 31:
                                        np_new = 6 + v
                                    else:
                                        np_new = 37 + br.bits(7)
                            # Lblock update (one comma code, then one
                            # length per codeword-segment piece, B.10.7)
                            while br.bit():
                                band.cb_lblock[n] += 1
                            k0 = int(band.cb_passes[n])
                            rem, k = np_new, k0
                            while rem:
                                take = 1
                                while (take < rem
                                       and not _seg_boundary(st.cblksty,
                                                             k + take)):
                                    take += 1
                                nbits = (band.cb_lblock[n]
                                         + int(math.floor(math.log2(take))))
                                seglen = br.bits(int(nbits))
                                body_specs.append((band, n, take, seglen))
                                rem -= take
                                k += take
            except IndexError:
                break          # header cut off: keep completed packets
            pos = br.flush()
            if cod.use_eph:
                if pos + 2 > len(buf):
                    break
                if buf[pos:pos + 2] != b"\xff\x92":
                    raise ValueError("missing EPH")
                pos += 2
            truncated = False
            for band, n, np_new, seglen in body_specs:
                if pos + seglen > len(buf):
                    # chunk cut off: drop this and later contributions
                    # (cb_passes counts only fully-present chunks)
                    truncated = True
                    break
                band.cb_chunks[n].append(buf[pos:pos + seglen])
                band.cb_piece_passes[n].append(np_new)
                band.cb_passes[n] += np_new
                pos += seglen
            if truncated:
                break
        return pos

    # -- synthesis ------------------------------------------------------------
    def _synthesize(self, res, st: CodingStyle, tx0, ty0, tx1, ty1,
                    c: int) -> np.ndarray:
        # decode code-blocks into band coefficient arrays
        def band_array(rinfo, band) -> np.ndarray:
            bw, bh = band.x1 - band.x0, band.y1 - band.y0
            arr = np.zeros((bh, bw), np.int64)
            if band.cw == 0:
                return arr
            xcb, ycb = rinfo["xcb"], rinfo["ycb"]
            for cj in range(band.ch):
                for ci in range(band.cw):
                    n = cj * band.cw + ci
                    if not band.cb_included[n] or band.cb_passes[n] == 0:
                        continue
                    gx0 = max((band.cbx0 + ci) << xcb, band.x0)
                    gy0 = max((band.cby0 + cj) << ycb, band.y0)
                    gx1 = min((band.cbx0 + ci + 1) << xcb, band.x1)
                    gy1 = min((band.cby0 + cj + 1) << ycb, band.y1)
                    w, h = gx1 - gx0, gy1 - gy0
                    data = b"".join(band.cb_chunks[n])
                    numbps = band.numbps - int(band.cb_zbp[n])
                    segs = block_segs(st.cblksty, band.cb_piece_passes[n],
                                      band.cb_chunks[n],
                                      int(band.cb_passes[n]))
                    blk, lastp = t1_decode_block(
                        data, int(band.cb_passes[n]), numbps, band.orient,
                        st.cblksty, w, h, want_lastp=True, segs=segs)
                    blk = blk.astype(np.int64)
                    # per-coefficient midpoint for truncated coefficients:
                    # uncertainty interval [mag, mag + 2^lastp); for fully
                    # refined coefficients lastp == 0 and the int midpoint
                    # term 2^(lastp-1) truncates to 0, keeping complete
                    # (lossless) decodes exact
                    part = lastp >= 1
                    if part.any():
                        half = (1 << np.maximum(lastp, 1)) >> 1
                        blk = np.where(part, blk + np.sign(blk) * half, blk)
                    arr[gy0 - band.y0:gy1 - band.y0,
                        gx0 - band.x0:gx1 - band.x0] = blk
            return arr

        def band_array_f(rinfo, band) -> np.ndarray:
            """Dequantized float coefficients (E.1.1) with block-level
            midpoint reconstruction: nonzero indices reconstruct at
            (|q| + 0.5 * 2^P) * Delta_b where P counts the block's
            undecoded bit-planes (P=0 for fully decoded blocks gives the
            standard r=0.5 dead-zone midpoint)."""
            bw, bh = band.x1 - band.x0, band.y1 - band.y0
            arr = np.zeros((bh, bw), np.float64)
            if band.cw == 0:
                return arr
            step = self._band_step(c, rinfo["r"], band.orient)
            xcb, ycb = rinfo["xcb"], rinfo["ycb"]
            for cj in range(band.ch):
                for ci in range(band.cw):
                    n = cj * band.cw + ci
                    if not band.cb_included[n] or band.cb_passes[n] == 0:
                        continue
                    gx0 = max((band.cbx0 + ci) << xcb, band.x0)
                    gy0 = max((band.cby0 + cj) << ycb, band.y0)
                    gx1 = min((band.cbx0 + ci + 1) << xcb, band.x1)
                    gy1 = min((band.cby0 + cj + 1) << ycb, band.y1)
                    w, h = gx1 - gx0, gy1 - gy0
                    data = b"".join(band.cb_chunks[n])
                    numbps = band.numbps - int(band.cb_zbp[n])
                    npass = int(band.cb_passes[n])
                    segs = block_segs(st.cblksty, band.cb_piece_passes[n],
                                      band.cb_chunks[n], npass)
                    blk, lastp = t1_decode_block(data, npass, numbps,
                                                 band.orient, st.cblksty,
                                                 w, h, want_lastp=True,
                                                 segs=segs)
                    val = _dequant_mid(blk, lastp, step)
                    arr[gy0 - band.y0:gy1 - band.y0,
                        gx0 - band.x0:gx1 - band.x0] = val
            return arr

        nl = st.levels
        rev = st.transform == 1
        get = band_array if rev else band_array_f
        ll = get(res[0], res[0]["bands"][0])
        for r in range(1, nl + 1):
            rinfo = res[r]
            hl = get(rinfo, rinfo["bands"][0])
            lh = get(rinfo, rinfo["bands"][1])
            hh = get(rinfo, rinfo["bands"][2])
            d = 1 << (nl - r)
            u0, v0 = ceil_div(tx0, d), ceil_div(ty0, d)
            u1, v1 = ceil_div(tx1, d), ceil_div(ty1, d)
            ll = _sr2d_fast(rev, ll, hl, lh, hh, u0, v0, u1, v1)

        # raw transform-domain output: int64 (reversible) or float64
        # (irreversible); inverse MCT + DC level shift + rounding/clipping
        # happen in decode_tile, across components
        return ll


JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


def is_jp2(path) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return False
    return head.startswith(JP2_SIGNATURE[:8]) or head[:2] == b"\xff\x4f"


class JP2Dataset:
    """Dataset adapter over JP2Decoder with the tiff.Dataset surface the
    pipelines use (width/height/count/read/close), so `make-baseline-a` can
    consume Sentinel-2 .jp2 band files directly (the reference goes through
    rasterio/GDAL, make_baseline_A.py:13-19)."""

    def __init__(self, path):
        self.path = Path(path)
        self._dec = JP2Decoder(self.path.read_bytes())
        self.width = self._dec.xsiz - self._dec.xosiz
        self.height = self._dec.ysiz - self._dec.yosiz
        self.count = self._dec.ncomp
        self.nodata = None
        self.transform = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)  # identity default
        self.geo = None
        self.descriptions = tuple([None] * self.count)
        depth = (self._dec.ssiz[0] & 0x7F) + 1
        signed = bool(self._dec.ssiz[0] & 0x80)
        self.dtypes = ((("int16" if depth <= 16 else "int32") if signed else
                        ("uint8" if depth <= 8 else
                         "uint16" if depth <= 16 else "uint32")),) * self.count
        self._cache: Dict[int, np.ndarray] = {}

    def _plane(self, i: int) -> np.ndarray:
        if i not in self._cache:
            # reuse the parsed decoder: no second file read/header scan
            self._cache[i] = read_jp2(self.path, band=i, dec=self._dec)
        return self._cache[i]

    def read(self, indexes=None, window=None) -> np.ndarray:
        if indexes is None:
            out = np.stack([self._plane(i) for i in range(self.count)])
        elif isinstance(indexes, int):
            out = self._plane(indexes - 1)
        else:
            out = np.stack([self._plane(i - 1) for i in indexes])
        if window is not None:
            w = window
            sl = (slice(int(w.row_off), int(w.row_off + w.height)),
                  slice(int(w.col_off), int(w.col_off + w.width)))
            out = out[..., sl[0], sl[1]]
        return out

    def dataset_mask(self, window=None) -> np.ndarray:
        m = np.full((self.height, self.width), 255, np.uint8)
        if window is not None:
            w = window
            m = m[int(w.row_off):int(w.row_off + w.height),
                  int(w.col_off):int(w.col_off + w.width)]
        return m

    def close(self):
        self._cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_raster(path):
    """Open a raster by content type: JP2/J2K codestreams decode through
    the in-framework JPEG 2000 reader, everything else through the TIFF
    stack."""
    from tpukit_torch.io import tiff as _tiff
    if is_jp2(path):
        return JP2Dataset(path)
    return _tiff.open(path)


# ---------------------------------------------------------------------------
def read_jp2(path, band: Optional[int] = None,
             dec: "JP2Decoder | None" = None) -> np.ndarray:
    """Decode a JP2/J2K file to a (H, W) (single component) or (C, H, W)
    array, full image (all tiles stitched). A caller that already holds
    the parsed ``JP2Decoder`` (JP2Dataset) passes it to avoid re-reading
    and re-parsing the file."""
    if dec is None:
        data = Path(path).read_bytes()
        dec = JP2Decoder(data)
    H = dec.ysiz - dec.yosiz
    W = dec.xsiz - dec.xosiz
    comps = range(dec.ncomp) if band is None else [band]
    planes = []
    for c in comps:
        signed = bool(dec.ssiz[c] & 0x80)
        depth = (dec.ssiz[c] & 0x7F) + 1
        if signed:
            dt = np.int16 if depth <= 16 else np.int32
        else:
            dt = np.uint8 if depth <= 8 else (np.uint16 if depth <= 16
                                              else np.uint32)
        out = np.zeros((H, W), dt)
        for ty in range(dec.nty):
            for tx in range(dec.ntx):
                tile = dec.decode_component(tx, ty, c)
                tx0 = max(dec.xtosiz + tx * dec.xtsiz, dec.xosiz)
                ty0 = max(dec.ytosiz + ty * dec.ytsiz, dec.yosiz)
                lo = 0 if not signed else -(1 << (depth - 1))
                hi = (1 << depth) - 1 if not signed else (1 << (depth - 1)) - 1
                tile = np.clip(tile, lo, hi)
                out[ty0 - dec.yosiz:ty0 - dec.yosiz + tile.shape[0],
                    tx0 - dec.xosiz:tx0 - dec.xosiz + tile.shape[1]] = \
                    tile.astype(dt)
        planes.append(out)
    if band is not None:
        return planes[0]
    return planes[0] if len(planes) == 1 else np.stack(planes)
