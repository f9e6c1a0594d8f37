# -*- coding: utf-8 -*-
# The port's copy of tpukit/codecs/png_codec.py: only its imports point at the port.
"""PNG lossless per-band codec.

The reference's PNG baseline writes one 16-bit grayscale PNG per band via
imageio/Pillow/pypng with a deflate level knob and ignores rate flags
(reference tools/codecs/png/png_wrap.py:76-146, :155-159). tpukit carries
its own minimal PNG writer/reader (stdlib zlib only): 8/16-bit grayscale,
all five scanline filters on read, minimum-sum-of-absolutes adaptive
filtering on write.
"""

from __future__ import annotations

import struct
import time
import zlib
from typing import Dict

import numpy as np

from tpukit_torch.codecs.base import Codec, CodecResult, RateSpec
from tpukit_torch.sweep.proc import mem_phase

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload +
            struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _filter_scanlines(byte_rows: np.ndarray, bpp: int) -> bytes:
    """Adaptive per-row filter via the minimum-sum-of-absolute-differences
    heuristic (the standard encoder heuristic). byte_rows: (H, stride) u8.

    PNG filters always reference the RAW previous scanline, never the
    filtered one, so selection is fully row-parallel: each candidate
    filter and its MSD score are whole-array ops (the per-row Python loop
    this replaced was 3x the cost of the deflate stage). Candidates are
    built one at a time in uint8 wraparound arithmetic and the running
    best rows overwritten in place, bounding peak memory at a few copies
    of the frame instead of 5 candidate stacks."""
    H, stride = byte_rows.shape
    rb = byte_rows
    pb = np.zeros_like(rb)
    pb[1:] = rb[:-1]
    left = np.zeros_like(rb)
    left[:, bpp:] = rb[:, :-bpp]
    upleft = np.zeros_like(pb)
    upleft[:, bpp:] = pb[:, :-bpp]

    def cand(f: int) -> np.ndarray:
        # uint8 wraparound subtraction == the (int16 diff) & 0xFF of the
        # PNG spec; predictors are all in [0, 255]
        if f == 0:
            return rb
        if f == 1:
            return rb - left
        if f == 2:
            return rb - pb
        if f == 3:
            avg = ((left.astype(np.uint16) + pb) >> 1).astype(np.uint8)
            return rb - avg
        lp = left.astype(np.int16)
        pp = pb.astype(np.int16)
        ul = upleft.astype(np.int16)
        p = lp + pp - ul
        pa = np.abs(p - lp)
        pb_ = np.abs(p - pp)
        pc_ = np.abs(p - ul)
        paeth = np.where((pa <= pb_) & (pa <= pc_), lp,
                         np.where(pb_ <= pc_, pp, ul)).astype(np.uint8)
        return rb - paeth

    out = np.empty((H, stride + 1), np.uint8)
    best_s = None
    for f in range(5):
        c = cand(f)
        # MSD score: |signed(v)| == min(v, 256 - v) in uint8 arithmetic
        s = np.minimum(c, -c).sum(axis=1, dtype=np.int64)
        if best_s is None:
            out[:, 0] = 0
            out[:, 1:] = c
            best_s = s
        else:
            better = s < best_s          # strict: first minimum wins ties
            if better.any():
                out[better, 0] = f
                out[better, 1:] = c[better]
                np.minimum(best_s, s, out=best_s)
    return out.tobytes()


def png_encode(band: np.ndarray, zlevel: int = 6) -> bytes:
    """Single-channel 8/16-bit grayscale PNG."""
    arr = np.ascontiguousarray(band)
    if arr.dtype not in (np.dtype(np.uint8), np.dtype(np.uint16)):
        arr = arr.astype(np.uint16)
    H, W = arr.shape
    depth = 16 if arr.dtype == np.uint16 else 8
    bpp = depth // 8
    if depth == 16:
        arr = arr.astype(">u2")
    filtered = _filter_scanlines(np.frombuffer(arr.tobytes(), np.uint8)
                                 .reshape(H, W * bpp),
                                 bpp)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, 0, 0, 0, 0)
    data = zlib.compress(filtered, int(zlevel))
    return (_PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data) +
            _chunk(b"IEND", b""))


def png_encode_compat(band: np.ndarray, zlevel: int = 6) -> bytes:
    """Reference-chain PNG writer: imageio.v3 first, Pillow fallback, with
    the exact arguments of reference png_wrap.py:76-116 — produces the SAME
    bytes as the reference baseline, so CR/bpp columns reproduce exactly.
    (pypng, the reference's third fallback, is not in this image; the first
    two cover the chain because imageio wins whenever it is installed.)"""
    import io
    arr = np.ascontiguousarray(band)
    if arr.dtype not in (np.dtype(np.uint16), np.dtype(np.uint8)):
        arr = arr.astype(np.uint16, copy=False)
    try:
        import imageio.v3 as iio
        buf = io.BytesIO()
        iio.imwrite(buf, arr, extension=".png", compress_level=int(zlevel))
        return buf.getvalue()
    except Exception:
        pass
    from PIL import Image
    im = Image.fromarray(arr)
    if arr.dtype == np.uint16 and im.mode != "I;16":
        im = im.convert("I;16")
    buf = io.BytesIO()
    im.save(buf, format="PNG", compress_level=int(zlevel))
    return buf.getvalue()


def png_decode(data: bytes) -> np.ndarray:
    """Decode grayscale PNG. Uses Pillow's C decoder when present (the
    reference PNG path is imageio/Pillow-backed anyway — png_wrap.py:118-146);
    falls back to the pure-python filter inverse."""
    try:
        import io
        from PIL import Image
        im = Image.open(io.BytesIO(data))
        arr = np.array(im)
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr.astype(np.uint16 if arr.dtype.itemsize == 2 or im.mode.startswith("I")
                          else np.uint8)
    except Exception:
        return _png_decode_py(data)


def _png_decode_py(data: bytes) -> np.ndarray:
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    W = H = depth = color = None
    idat = bytearray()
    while pos + 8 <= len(data):
        ln = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            W, H, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB", payload)
            if color != 0 or comp != 0 or filt != 0 or inter != 0:
                raise ValueError("only grayscale non-interlaced supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    bpp = depth // 8
    stride = W * bpp
    raw = zlib.decompress(bytes(idat))
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.int16)
    posr = 0
    for r in range(H):
        f = raw[posr]
        row = np.frombuffer(raw[posr + 1:posr + 1 + stride], np.uint8).astype(np.int16)
        posr += 1 + stride
        if f == 0:
            rec = row
        elif f == 1:
            rec = row.copy()
            for i in range(bpp, stride):
                rec[i] = (rec[i] + rec[i - bpp]) & 0xFF
        elif f == 2:
            rec = (row + prev) & 0xFF
        elif f == 3:
            rec = row.copy()
            for i in range(stride):
                left = rec[i - bpp] if i >= bpp else 0
                rec[i] = (rec[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif f == 4:
            rec = row.copy()
            for i in range(stride):
                left = int(rec[i - bpp]) if i >= bpp else 0
                up = int(prev[i])
                ul = int(prev[i - bpp]) if i >= bpp else 0
                p = left + up - ul
                pa, pb_, pc_ = abs(p - left), abs(p - up), abs(p - ul)
                pred = left if (pa <= pb_ and pa <= pc_) else (up if pb_ <= pc_ else ul)
                rec[i] = (rec[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {f}")
        out[r] = rec.astype(np.uint8)
        prev = rec
    if depth == 16:
        return np.frombuffer(out.tobytes(), ">u2").reshape(H, W).astype(np.uint16)
    return out.reshape(H, W)


class PNGCodec(Codec):
    name = "png"
    encoder_desc = "tpukit PNG (stdlib zlib, per-band 16-bit grayscale)"
    supports_lossy = False

    def __init__(self, zlevel: int = 6, writer: str = "tpukit"):
        if writer not in ("tpukit", "compat"):
            raise ValueError(f"png writer must be tpukit|compat, got {writer!r}")
        self.zlevel = zlevel
        self.writer = writer

    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, **opts) -> CodecResult:
        # rate flags are accepted but ignored (reference png_wrap.py:8, :157)
        B, H, W = cube.shape
        streams: Dict[str, bytes] = {}
        sum_bytes = 0
        recon = np.empty_like(cube)

        enc = png_encode if self.writer == "tpukit" else png_encode_compat
        t0 = time.perf_counter()
        encoded = []
        with mem_phase("comp"):
            for i in range(B):
                band = cube[i]
                if band.dtype == np.int16:
                    band = band.view(np.uint16)  # lossless bit-view container
                bs = enc(band, self.zlevel)
                encoded.append(bs)
                sum_bytes += len(bs)
                if keep_bitstream:
                    streams[f"b{i+1:02d}.png"] = bs
        t_comp = time.perf_counter() - t0

        t0 = time.perf_counter()
        with mem_phase("dec"):
            for i in range(B):
                dec = png_decode(encoded[i])
                if cube.dtype == np.int16:
                    dec = dec.astype(np.uint16).view(np.int16)
                recon[i] = dec.astype(cube.dtype, copy=False)
        t_dec = time.perf_counter() - t0

        return CodecResult(
            codec="png_lossless",
            encoder=self.encoder_desc,
            bitstream_bytes=sum_bytes,
            recon=recon,
            t_comp_s=t_comp,
            t_dec_s=t_dec,
            bitstreams=streams if keep_bitstream else None,
            extras={"zlevel": int(self.zlevel), "writer": self.writer},
        )
