# -*- coding: utf-8 -*-
# The port's copy of tpukit/io/tiff.py: only its imports point at the port.
"""Self-contained GeoTIFF reader/writer (no GDAL/rasterio dependency).

The reference pipeline leans on rasterio/GDAL for every raster touch
(reference tools/run_codec.py:242-304, tools/make_baseline_A.py:38-170).
This module provides the subset of that surface the framework needs,
implemented directly against the TIFF 6.0 / BigTIFF specs:

  * classic TIFF and BigTIFF, little- and big-endian
  * striped and tiled layouts, chunky (PlanarConfig=1) and planar (=2)
  * uint8/uint16/int16/int32/uint32/float32/float64 samples
  * Compression: none (1), zlib/deflate (8 and legacy 32946) with
    horizontal-differencing Predictor (2)
  * GDAL sidecar tags: GDAL_NODATA (42113), GDAL_METADATA (42112,
    band descriptions), internal mask IFDs (NewSubfileType & 4)
  * geo-referencing passthrough: ModelPixelScale / ModelTiepoint /
    ModelTransformation / GeoKey directories are preserved as opaque
    values on copy and written back verbatim

API intentionally mirrors the slice of rasterio the reference uses:
``open(path)`` -> ``Dataset`` with ``read``, ``dataset_mask``, ``meta``;
``write_geotiff(path, data, **profile)`` for output.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# TIFF constants
# ---------------------------------------------------------------------------

TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d",
            13: "I", 16: "Q", 17: "q", 18: "Q"}

TAG_NEW_SUBFILE_TYPE = 254
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_IMAGE_DESCRIPTION = 270
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_SOFTWARE = 305
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_EXTRA_SAMPLES = 338
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORMATION = 34264
TAG_GEO_KEY_DIRECTORY = 34735
TAG_GEO_DOUBLE_PARAMS = 34736
TAG_GEO_ASCII_PARAMS = 34737
TAG_GDAL_METADATA = 42112
TAG_GDAL_NODATA = 42113

GEO_TAGS = (TAG_MODEL_PIXEL_SCALE, TAG_MODEL_TIEPOINT, TAG_MODEL_TRANSFORMATION,
            TAG_GEO_KEY_DIRECTORY, TAG_GEO_DOUBLE_PARAMS, TAG_GEO_ASCII_PARAMS)

COMPRESSION_NONE = 1
COMPRESSION_DEFLATE = 8
COMPRESSION_DEFLATE_OLD = 32946

_SF_UINT, _SF_INT, _SF_FLOAT = 1, 2, 3

_DTYPES = {
    ("uint", 8): np.uint8, ("uint", 16): np.uint16, ("uint", 32): np.uint32,
    ("int", 8): np.int8, ("int", 16): np.int16, ("int", 32): np.int32,
    ("float", 32): np.float32, ("float", 64): np.float64,
}


def _np_dtype(sample_format: int, bits: int):
    kind = {_SF_UINT: "uint", _SF_INT: "int", _SF_FLOAT: "float"}.get(sample_format, "uint")
    try:
        return _DTYPES[(kind, bits)]
    except KeyError:
        raise ValueError(f"Unsupported TIFF sample: format={sample_format} bits={bits}")


# ---------------------------------------------------------------------------
# Window
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Window:
    """Pixel window (mirrors rasterio.windows.Window col/row/width/height)."""
    col_off: int
    row_off: int
    width: int
    height: int

    @staticmethod
    def coerce(w) -> "Window":
        if w is None:
            raise ValueError("window is None")
        if isinstance(w, Window):
            return w
        c, r, ww, hh = w
        return Window(int(c), int(r), int(ww), int(hh))


# ---------------------------------------------------------------------------
# IFD parsing
# ---------------------------------------------------------------------------

@dataclass
class IFDEntry:
    tag: int
    type: int
    count: int
    value: object  # decoded tuple / bytes


@dataclass
class IFD:
    entries: Dict[int, IFDEntry] = field(default_factory=dict)

    def get(self, tag, default=None):
        e = self.entries.get(tag)
        return e.value if e is not None else default

    def scalar(self, tag, default=None):
        v = self.get(tag)
        if v is None:
            return default
        if isinstance(v, (tuple, list)):
            return v[0] if v else default
        return v


class _Parser:
    def __init__(self, data: memoryview):
        self.data = data
        magic = bytes(data[:2])
        if magic == b"II":
            self.bo = "<"
        elif magic == b"MM":
            self.bo = ">"
        else:
            raise ValueError("Not a TIFF file")
        version = struct.unpack(self.bo + "H", bytes(data[2:4]))[0]
        if version == 42:
            self.big = False
            self.first_ifd = struct.unpack(self.bo + "I", bytes(data[4:8]))[0]
        elif version == 43:
            self.big = True
            off_size, _ = struct.unpack(self.bo + "HH", bytes(data[4:8]))
            if off_size != 8:
                raise ValueError("Unsupported BigTIFF offset size")
            self.first_ifd = struct.unpack(self.bo + "Q", bytes(data[8:16]))[0]
        else:
            raise ValueError(f"Bad TIFF version {version}")

    def _read_value(self, typ: int, count: int, raw: bytes, inline_size: int):
        size = TYPE_SIZES.get(typ, 1) * count
        if size <= inline_size:
            payload = raw[:size]
        else:
            off = struct.unpack(self.bo + ("Q" if self.big else "I"), raw[: 8 if self.big else 4])[0]
            payload = bytes(self.data[off:off + size])
        if typ == 2:  # ASCII
            return payload.rstrip(b"\x00").decode("utf-8", errors="replace")
        if typ in (5, 10):  # RATIONAL
            fmt = self.bo + ("II" if typ == 5 else "ii") * count
            vals = struct.unpack(fmt, payload)
            return tuple(vals[i] / max(vals[i + 1], 1) for i in range(0, len(vals), 2))
        if typ in (7, 1) and typ == 7:
            return payload
        fmt_ch = TYPE_FMT.get(typ)
        if fmt_ch is None:
            return payload
        return tuple(struct.unpack(self.bo + fmt_ch * count, payload))

    def parse_ifd(self, offset: int) -> Tuple[IFD, int]:
        bo, big = self.bo, self.big
        if big:
            n = struct.unpack(bo + "Q", bytes(self.data[offset:offset + 8]))[0]
            pos = offset + 8
            entry_size, inline = 20, 8
        else:
            n = struct.unpack(bo + "H", bytes(self.data[offset:offset + 2]))[0]
            pos = offset + 2
            entry_size, inline = 12, 4
        ifd = IFD()
        for i in range(n):
            e = bytes(self.data[pos:pos + entry_size])
            pos += entry_size
            if big:
                tag, typ = struct.unpack(bo + "HH", e[:4])
                count = struct.unpack(bo + "Q", e[4:12])[0]
                raw = e[12:20]
            else:
                tag, typ = struct.unpack(bo + "HH", e[:4])
                count = struct.unpack(bo + "I", e[4:8])[0]
                raw = e[8:12]
            try:
                value = self._read_value(typ, count, raw, inline)
            except Exception:
                continue
            ifd.entries[tag] = IFDEntry(tag, typ, count, value)
        nxt = struct.unpack(bo + ("Q" if big else "I"),
                            bytes(self.data[pos:pos + (8 if big else 4)]))[0]
        return ifd, nxt


# ---------------------------------------------------------------------------
# Decoding helpers
# ---------------------------------------------------------------------------

def _undo_predictor2(arr: np.ndarray) -> np.ndarray:
    # arr: (rows, cols, samples) — horizontal differencing per sample
    np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
    return arr


def _apply_predictor2(arr: np.ndarray) -> np.ndarray:
    out = arr.copy()
    out[:, 1:, ...] = arr[:, 1:, ...] - arr[:, :-1, ...]
    return out


def _decompress(buf: bytes, compression: int) -> bytes:
    if compression == COMPRESSION_NONE:
        return buf
    if compression in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_OLD):
        return zlib.decompress(buf)
    raise ValueError(f"Unsupported compression {compression}")


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

def _parse_gdal_metadata(xml: Optional[str]) -> Dict[int, Dict[str, str]]:
    """Parse GDAL_METADATA XML into {band(1-based or 0 for dataset): {key: value}}."""
    out: Dict[int, Dict[str, str]] = {}
    if not xml:
        return out
    for m in re.finditer(r'<Item\s+([^>]*)>(.*?)</Item>', xml, re.S):
        attrs = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
        name = attrs.get("name", "")
        band = int(attrs.get("sample", -1)) + 1  # GDAL uses 0-based "sample"
        from xml.sax.saxutils import unescape
        out.setdefault(band, {})[name] = unescape(m.group(2).strip())
    return out


class Dataset:
    """Read-only raster dataset. Mirrors the rasterio reader surface used by
    the reference (width/height/count/dtypes/nodata/descriptions, read(),
    dataset_mask()) — see reference tools/run_codec.py:451-467."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        # memory-map the file: windowed reads touch only the pages of the
        # chunks they decode, keeping RSS bounded for scene-scale inputs
        # (the pages are clean/file-backed, so the OS can evict them)
        self._buf = np.memmap(self.path, dtype=np.uint8, mode="r")
        self._mv = memoryview(self._buf)  # zero-copy view of the file buffer
        p = _Parser(self._mv)
        self._parser = p
        ifds: List[IFD] = []
        off = p.first_ifd
        seen = set()
        while off and off not in seen:
            seen.add(off)
            ifd, off = p.parse_ifd(off)
            ifds.append(ifd)
        if not ifds:
            raise ValueError(f"No IFD in {self.path}")
        self._main = None
        self._mask_ifd = None
        self._overviews: List[IFD] = []
        for ifd in ifds:
            sub = ifd.scalar(TAG_NEW_SUBFILE_TYPE, 0) or 0
            if sub & 4:
                if self._mask_ifd is None:
                    self._mask_ifd = ifd
            elif sub & 1:
                self._overviews.append(ifd)
            elif self._main is None:
                self._main = ifd
        if self._main is None:
            self._main = ifds[0]

        m = self._main
        self.width = int(m.scalar(TAG_IMAGE_WIDTH))
        self.height = int(m.scalar(TAG_IMAGE_LENGTH))
        self.count = int(m.scalar(TAG_SAMPLES_PER_PIXEL, 1))
        bits = m.get(TAG_BITS_PER_SAMPLE, (8,))
        if isinstance(bits, (int, float)):
            bits = (int(bits),)
        sf = m.get(TAG_SAMPLE_FORMAT, (1,) * self.count)
        if isinstance(sf, (int, float)):
            sf = (int(sf),)
        self._dtype = _np_dtype(int(sf[0]), int(bits[0]))
        self.dtypes = tuple(np.dtype(self._dtype).name for _ in range(self.count))
        self.nodata = None
        nd = m.get(TAG_GDAL_NODATA)
        if nd is not None:
            try:
                ndf = float(str(nd).strip().split()[0])
                self.nodata = ndf
            except Exception:
                pass
        md = _parse_gdal_metadata(m.get(TAG_GDAL_METADATA))
        self.descriptions = tuple(
            md.get(i, {}).get("DESCRIPTION") for i in range(1, self.count + 1))
        self.band_metadata = md
        # geo passthrough
        self.geo = {t: m.entries[t] for t in GEO_TAGS if t in m.entries}
        self.transform = self._derive_transform()
        self._cache: Dict[int, np.ndarray] = {}

    # -- geometry ----------------------------------------------------------
    def _derive_transform(self):
        scale = self._main.get(TAG_MODEL_PIXEL_SCALE)
        tie = self._main.get(TAG_MODEL_TIEPOINT)
        if scale and tie and len(tie) >= 6:
            sx, sy = float(scale[0]), float(scale[1])
            i, j, _, x, y, _ = [float(v) for v in tie[:6]]
            # affine (a,b,c,d,e,f): X = a*col + b*row + c ; Y = d*col + e*row + f
            return (sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
        mt = self._main.get(TAG_MODEL_TRANSFORMATION)
        if mt and len(mt) >= 8:
            v = [float(x) for x in mt]
            return (v[0], v[1], v[3], v[4], v[5], v[7])
        return (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    @property
    def meta(self) -> dict:
        return {
            "width": self.width, "height": self.height, "count": self.count,
            "dtype": self.dtypes[0], "nodata": self.nodata,
            "transform": self.transform, "geo": self.geo,
            "descriptions": self.descriptions,
        }

    @property
    def profile(self) -> dict:
        return dict(self.meta)

    # -- pixel access ------------------------------------------------------
    def _chunk_grid(self, ifd: IFD):
        tw = ifd.scalar(TAG_TILE_WIDTH)
        if tw is not None:
            th = int(ifd.scalar(TAG_TILE_LENGTH))
            tw = int(tw)
            offs = ifd.get(TAG_TILE_OFFSETS)
            cnts = ifd.get(TAG_TILE_BYTE_COUNTS)
            tiled = True
        else:
            tw = int(ifd.scalar(TAG_IMAGE_WIDTH))
            th = int(ifd.scalar(TAG_ROWS_PER_STRIP, ifd.scalar(TAG_IMAGE_LENGTH)))
            offs = ifd.get(TAG_STRIP_OFFSETS)
            cnts = ifd.get(TAG_STRIP_BYTE_COUNTS)
            tiled = False
        if isinstance(offs, (int, float)):
            offs = (int(offs),)
        if isinstance(cnts, (int, float)):
            cnts = (int(cnts),)
        return tiled, tw, th, list(offs or ()), list(cnts or ())

    def _decode_plane_ifd(self, ifd: IFD, band_idx0: int, dtype, nbands: int) -> np.ndarray:
        """Decode one full band plane (H, W) from an IFD."""
        W = int(ifd.scalar(TAG_IMAGE_WIDTH))
        H = int(ifd.scalar(TAG_IMAGE_LENGTH))
        comp = int(ifd.scalar(TAG_COMPRESSION, 1))
        planar = int(ifd.scalar(TAG_PLANAR_CONFIG, 1))
        pred = int(ifd.scalar(TAG_PREDICTOR, 1))
        tiled, tw, th, offs, cnts = self._chunk_grid(ifd)
        bo = self._parser.bo
        dt = np.dtype(dtype).newbyteorder(bo)
        spp = nbands if planar == 1 else 1
        # TIFF 6.0: BitsPerSample defaults to 1 (bilevel) when absent —
        # PIL omits the tag for 1-bit images; GDAL/rasterio always write it
        bits_ps = int(ifd.scalar(TAG_BITS_PER_SAMPLE, 1) or 1)

        tiles_x = (W + tw - 1) // tw
        tiles_y = (H + th - 1) // th
        per_plane = tiles_x * tiles_y
        # sparse (SPARSE_OK) chunks read back as nodata, matching GDAL
        fill = 0
        nd = self.nodata
        if nd is not None and np.isfinite(nd) and ifd is self._main:
            try:
                fill = np.dtype(dtype).type(nd)
            except (OverflowError, ValueError):
                fill = 0
        out = np.full((H, W), fill, dtype=dtype)
        plane_base = 0 if planar == 1 else band_idx0 * per_plane

        for ty in range(tiles_y):
            for tx in range(tiles_x):
                ci = plane_base + ty * tiles_x + tx
                if ci >= len(offs):
                    continue
                off, cnt = int(offs[ci]), int(cnts[ci])
                if off == 0 or cnt == 0:
                    continue  # sparse chunk
                raw = _decompress(bytes(self._mv[off:off + cnt]), comp)
                if tiled:
                    rows, cols = th, tw
                else:
                    rows = min(th, H - ty * th)
                    cols = W
                if bits_ps == 1:
                    # 1-bit packed plane (GDAL/rasterio internal masks): rows
                    # are MSB-first bit rows padded to whole bytes
                    rowbytes = (cols * spp + 7) // 8
                    need = rows * rowbytes
                    rawb = np.frombuffer(raw, np.uint8,
                                         count=min(need, len(raw)))
                    if rawb.size < need:
                        rawb = np.concatenate(
                            [rawb, np.zeros(need - rawb.size, np.uint8)])
                    arr = np.unpackbits(rawb.reshape(rows, rowbytes),
                                        axis=1)[:, :cols * spp]
                    arr = arr.reshape(rows, cols, spp).astype(dtype)
                else:
                    n_expected = rows * cols * spp
                    arr = np.frombuffer(raw, dtype=dt,
                                        count=min(n_expected, len(raw) // dt.itemsize))
                    if arr.size < n_expected:
                        arr = np.concatenate([arr, np.zeros(n_expected - arr.size, dtype=dt)])
                    arr = arr.reshape(rows, cols, spp).astype(dtype)
                if pred == 2:
                    arr = _undo_predictor2(arr)
                elif pred not in (0, 1):
                    raise ValueError(f"Unsupported TIFF predictor {pred}")
                plane = arr[..., band_idx0] if planar == 1 else arr[..., 0]
                y0, x0 = ty * th, tx * tw
                hh = min(rows, H - y0)
                ww = min(cols, W - x0)
                out[y0:y0 + hh, x0:x0 + ww] = plane[:hh, :ww]
        return out

    def _decode_window_ifd(self, ifd: IFD, band_idx0: int, dtype, nbands: int,
                           win: Window) -> np.ndarray:
        """Decode only the chunks intersecting ``win`` from an IFD — the
        bounded-RSS path for scene-scale streaming (only the strips/tiles a
        window touches are decompressed; the memmapped file pages the rest
        stays on disk)."""
        W = int(ifd.scalar(TAG_IMAGE_WIDTH))
        H = int(ifd.scalar(TAG_IMAGE_LENGTH))
        comp = int(ifd.scalar(TAG_COMPRESSION, 1))
        planar = int(ifd.scalar(TAG_PLANAR_CONFIG, 1))
        pred = int(ifd.scalar(TAG_PREDICTOR, 1))
        tiled, tw, th, offs, cnts = self._chunk_grid(ifd)
        bo = self._parser.bo
        dt = np.dtype(dtype).newbyteorder(bo)
        spp = nbands if planar == 1 else 1
        bits_ps = int(ifd.scalar(TAG_BITS_PER_SAMPLE, 1) or 1)

        tiles_x = (W + tw - 1) // tw
        tiles_y = (H + th - 1) // th
        per_plane = tiles_x * tiles_y
        fill = 0
        nd = self.nodata
        if nd is not None and np.isfinite(nd) and ifd is self._main:
            try:
                fill = np.dtype(dtype).type(nd)
            except (OverflowError, ValueError):
                fill = 0
        out = np.full((win.height, win.width), fill, dtype=dtype)
        plane_base = 0 if planar == 1 else band_idx0 * per_plane

        ty0 = win.row_off // th
        ty1 = (win.row_off + win.height - 1) // th
        tx0 = win.col_off // tw
        tx1 = (win.col_off + win.width - 1) // tw
        for ty in range(ty0, min(ty1, tiles_y - 1) + 1):
            for tx in range(tx0, min(tx1, tiles_x - 1) + 1):
                ci = plane_base + ty * tiles_x + tx
                if ci >= len(offs):
                    continue
                off, cnt = int(offs[ci]), int(cnts[ci])
                y0, x0 = ty * th, tx * tw
                if tiled:
                    rows, cols = th, tw
                else:
                    rows = min(th, H - y0)
                    cols = W
                sy0 = max(win.row_off, y0)
                sy1 = min(win.row_off + win.height, y0 + min(rows, H - y0))
                sx0 = max(win.col_off, x0)
                sx1 = min(win.col_off + win.width, x0 + min(cols, W - x0))
                if sy1 <= sy0 or sx1 <= sx0:
                    continue
                if off == 0 or cnt == 0:   # sparse chunk reads back as fill
                    continue
                raw = _decompress(bytes(self._mv[off:off + cnt]), comp)
                if bits_ps == 1:
                    rowbytes = (cols * spp + 7) // 8
                    need = rows * rowbytes
                    rawb = np.frombuffer(raw, np.uint8,
                                         count=min(need, len(raw)))
                    if rawb.size < need:
                        rawb = np.concatenate(
                            [rawb, np.zeros(need - rawb.size, np.uint8)])
                    arr = np.unpackbits(rawb.reshape(rows, rowbytes),
                                        axis=1)[:, :cols * spp]
                    arr = arr.reshape(rows, cols, spp).astype(dtype)
                else:
                    n_expected = rows * cols * spp
                    arr = np.frombuffer(raw, dtype=dt,
                                        count=min(n_expected, len(raw) // dt.itemsize))
                    if arr.size < n_expected:
                        arr = np.concatenate(
                            [arr, np.zeros(n_expected - arr.size, dtype=dt)])
                    arr = arr.reshape(rows, cols, spp).astype(dtype)
                if pred == 2:
                    arr = _undo_predictor2(arr)
                elif pred not in (0, 1):
                    raise ValueError(f"Unsupported TIFF predictor {pred}")
                plane = arr[..., band_idx0] if planar == 1 else arr[..., 0]
                out[sy0 - win.row_off:sy1 - win.row_off,
                    sx0 - win.col_off:sx1 - win.col_off] = \
                    plane[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0]
        return out

    def _band(self, i: int) -> np.ndarray:
        """1-based band read, cached full plane."""
        if i not in self._cache:
            self._cache[i] = self._decode_plane_ifd(self._main, i - 1, self._dtype, self.count)
        return self._cache[i]

    def read(self, indexes=None, window=None, out_dtype=None) -> np.ndarray:
        """rasterio-style read: indexes int -> (H,W); list/None -> (B,H,W).

        Windowed reads decode only the intersecting chunks (unless the full
        plane is already cached), so strip-streaming a scene never
        materializes whole planes."""
        single = isinstance(indexes, (int, np.integer))
        if indexes is None:
            idx = list(range(1, self.count + 1))
        elif single:
            idx = [int(indexes)]
        else:
            idx = [int(i) for i in indexes]
        if window is not None:
            w = Window.coerce(window)
            # .copy(): never hand out views of the plane cache (mutation
            # through the returned array must not corrupt later reads —
            # rasterio returns fresh arrays too)
            planes = [
                (self._cache[i][w.row_off:w.row_off + w.height,
                                w.col_off:w.col_off + w.width].copy()
                 if i in self._cache else
                 self._decode_window_ifd(self._main, i - 1, self._dtype,
                                         self.count, w))
                for i in idx]
        else:
            planes = [self._band(i) for i in idx]
        if len(planes) == 1:
            arr = (planes[0].copy() if planes[0].base is not None
                   or planes[0] is self._cache.get(idx[0]) else planes[0])
            arr = arr[None]
        else:
            arr = np.stack(planes, axis=0)   # stack copies
        if out_dtype is not None:
            arr = arr.astype(out_dtype)
        return arr[0] if single else arr

    def dataset_mask(self, window=None) -> np.ndarray:
        """0/255 validity mask: internal mask IFD if present, else nodata on
        any band, else all-valid (mirrors rasterio.DatasetReader.dataset_mask
        as consumed at reference tools/quicklooks.py:35-45)."""
        if window is not None:
            w = Window.coerce(window)
            if self._mask_ifd is not None:
                m = self._decode_window_ifd(self._mask_ifd, 0, np.uint8, 1, w)
                return np.where(m > 0, 255, 0).astype(np.uint8)
            if self.nodata is not None and np.isfinite(self.nodata):
                valid = np.ones((w.height, w.width), dtype=bool)
                for i in range(1, self.count + 1):
                    valid &= (self.read(i, window=w) != self.nodata)
                return np.where(valid, 255, 0).astype(np.uint8)
            return np.full((w.height, w.width), 255, dtype=np.uint8)
        if self._mask_ifd is not None:
            m = self._decode_plane_ifd(self._mask_ifd, 0, np.uint8, 1)
            m = np.where(m > 0, 255, 0).astype(np.uint8)
        elif self.nodata is not None and np.isfinite(self.nodata):
            valid = np.ones((self.height, self.width), dtype=bool)
            for i in range(1, self.count + 1):
                valid &= (self._band(i) != self.nodata)
            m = np.where(valid, 255, 0).astype(np.uint8)
        else:
            m = np.full((self.height, self.width), 255, dtype=np.uint8)
        return m

    def set_band_description(self, i: int, desc: str):
        raise IOError("Dataset is read-only; use update_band_descriptions()")

    def close(self):
        self._cache.clear()
        self._mv = memoryview(b"")
        self._parser = None  # drops the last reference to the file buffer
        self._buf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open(path) -> Dataset:  # noqa: A001 — mirrors rasterio.open
    return Dataset(path)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _gdal_metadata_xml(descriptions, band_metadata=None) -> Optional[str]:
    from xml.sax.saxutils import escape, quoteattr

    def _txt(v):        # XML-escape item payloads ('&', '<', '>')
        return escape(str(v))

    items = []
    if descriptions:
        for i, d in enumerate(descriptions):
            if d:
                items.append(f'<Item name="DESCRIPTION" sample="{i}" '
                             f'role="description">{_txt(d)}</Item>')
    if band_metadata:
        for band, kv in band_metadata.items():
            for k, v in kv.items():
                if k == "DESCRIPTION":
                    continue
                nm = quoteattr(str(k))
                if band == 0:
                    items.append(f'<Item name={nm}>{_txt(v)}</Item>')
                else:
                    items.append(f'<Item name={nm} sample="{band-1}">'
                                 f'{_txt(v)}</Item>')
    if not items:
        return None
    return "<GDALMetadata>\n  " + "\n  ".join(items) + "\n</GDALMetadata>\n"


class _TagWriter:
    """Accumulates IFD entries and out-of-line payloads for one IFD."""

    def __init__(self, bo: str, big: bool):
        self.bo, self.big = bo, big
        self.tags: List[Tuple[int, int, int, bytes]] = []  # tag, type, count, payload

    def add(self, tag: int, typ: int, values) -> None:
        if typ == 2:  # ascii
            payload = values.encode("utf-8") + b"\x00"
            count = len(payload)
        elif typ == 7:
            payload = bytes(values)
            count = len(payload)
        else:
            if isinstance(values, (int, float)):
                values = (values,)
            fmt = TYPE_FMT[typ]
            payload = struct.pack(self.bo + fmt * len(values), *values)
            count = len(values)
        self.tags.append((tag, typ, count, payload))

    def serialize(self, ifd_offset: int, next_ifd: int) -> Tuple[bytes, bytes, int]:
        """Return (ifd_bytes, overflow_bytes, total_len). Overflow payloads are
        placed immediately after the IFD."""
        self.tags.sort(key=lambda t: t[0])
        bo, big = self.bo, self.big
        n = len(self.tags)
        entry_size = 20 if big else 12
        inline = 8 if big else 4
        header = struct.pack(bo + ("Q" if big else "H"), n)
        ifd_len = len(header) + n * entry_size + (8 if big else 4)
        overflow_off = ifd_offset + ifd_len
        entries = b""
        overflow = b""
        for tag, typ, count, payload in self.tags:
            if len(payload) <= inline:
                val = payload + b"\x00" * (inline - len(payload))
            else:
                pos = overflow_off + len(overflow)
                if pos % 2:
                    overflow += b"\x00"
                    pos += 1
                val = struct.pack(bo + ("Q" if big else "I"), pos)
                overflow += payload
            if big:
                entries += struct.pack(bo + "HHQ", tag, typ, count) + val
            else:
                entries += struct.pack(bo + "HHI", tag, typ, count) + val
        ifd = header + entries + struct.pack(bo + ("Q" if big else "I"), next_ifd)
        return ifd, overflow, ifd_len + len(overflow)


def write_geotiff(path, data: np.ndarray, *,
                  nodata=None, descriptions=None, band_metadata=None,
                  transform=None, geo: Optional[dict] = None,
                  tiled: bool = True, blockxsize: int = 512, blockysize: int = 512,
                  compress: Optional[str] = None, zlevel: int = 6,
                  predictor: int = 1, photometric: Optional[str] = None,
                  mask: Optional[np.ndarray] = None,
                  bigtiff: Union[bool, str] = "IF_SAFER",
                  tags: Optional[Dict[str, str]] = None,
                  sparse_ok: bool = False) -> Path:
    """Write a (bands, H, W) or (H, W) array as a (Big)GeoTIFF.

    Matches the creation pattern the reference uses everywhere:
    tiled planar GTiff, optional DEFLATE, nodata + band descriptions +
    optional internal validity mask (reference tools/make_baseline_B.py:251-316,
    tools/quicklooks.py:88-109). ``sparse_ok`` mirrors GDAL's SPARSE_OK
    creation option (reference ccsds123_wrap.py:177): blocks whose data is
    entirely nodata (or 0 when no nodata is set) are not materialized —
    their offset/bytecount entries are 0 and readers fill them on demand.
    """
    path = Path(path)
    arr = np.asarray(data)
    if arr.ndim == 2:
        arr = arr[None]
    B, H, W = arr.shape
    dt = arr.dtype
    if dt == np.bool_:
        arr = arr.astype(np.uint8)
        dt = arr.dtype
    bits = dt.itemsize * 8
    if dt.kind == "u":
        sf = _SF_UINT
    elif dt.kind == "i":
        sf = _SF_INT
    elif dt.kind == "f":
        sf = _SF_FLOAT
    else:
        raise ValueError(f"Unsupported dtype {dt}")

    comp = COMPRESSION_NONE
    if compress and str(compress).upper() in ("DEFLATE", "ZLIB"):
        comp = COMPRESSION_DEFLATE

    if tiled:
        tw = max(16, (int(blockxsize) // 16) * 16)
        th = max(16, (int(blockysize) // 16) * 16)
    else:
        tw, th = W, min(H, max(1, (1 << 20) // max(1, W * dt.itemsize)))

    tiles_x = (W + tw - 1) // tw if tiled else 1
    tiles_y = (H + th - 1) // th
    chunks_per_plane = tiles_x * tiles_y

    sparse_fill = None
    if sparse_ok:
        try:
            sparse_fill = dt.type(nodata) if nodata is not None else dt.type(0)
        except (OverflowError, ValueError):
            sparse_fill = None

    def encode_plane(plane: np.ndarray) -> List[Optional[bytes]]:
        out = []
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                y0, x0 = ty * th, tx * tw
                if tiled:
                    sub = plane[y0:y0 + th, x0:x0 + tw]
                    if sparse_fill is not None and (sub == sparse_fill).all():
                        out.append(None)   # sparse block: offset/count 0
                        continue
                    block = np.zeros((th, tw), dtype=dt)
                    block[:sub.shape[0], :sub.shape[1]] = sub
                else:
                    block = plane[y0:y0 + th, :]
                    if sparse_fill is not None and (block == sparse_fill).all():
                        out.append(None)
                        continue
                chunk = block[..., None]
                if predictor == 2:
                    chunk = _apply_predictor2(chunk)
                raw = np.ascontiguousarray(chunk.astype(dt.newbyteorder("<"))).tobytes()
                if comp == COMPRESSION_DEFLATE:
                    raw = zlib.compress(raw, int(zlevel))
                out.append(raw)
        return out

    plane_chunks = [encode_plane(arr[b]) for b in range(B)]
    all_chunks = [c for chunks in plane_chunks for c in chunks]
    mask_chunks = None
    if mask is not None:
        mk = np.where(np.asarray(mask) > 0, 255, 0).astype(np.uint8)
        mko = []
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                y0, x0 = ty * th, tx * tw
                if tiled:
                    block = np.zeros((th, tw), dtype=np.uint8)
                    sub = mk[y0:y0 + th, x0:x0 + tw]
                    block[:sub.shape[0], :sub.shape[1]] = sub
                else:
                    block = mk[y0:y0 + th, :]
                mko.append(zlib.compress(block.tobytes(), 6))
        mask_chunks = mko

    total_data = sum(len(c) for c in all_chunks if c is not None) + (
        sum(len(c) for c in mask_chunks) if mask_chunks else 0)
    if bigtiff is True or str(bigtiff).upper() == "YES":
        big = True
    elif bigtiff is False or str(bigtiff).upper() == "NO":
        big = False
    else:  # IF_SAFER
        big = total_data > (1 << 32) - (1 << 26)

    bo = "<"
    header_len = 16 if big else 8

    # layout: header | chunk data | main IFD (+overflow) | mask IFD (+overflow)
    data_off = header_len
    offsets = []
    pos = data_off
    for c in all_chunks:
        if c is None:
            offsets.append(0)
            continue
        if pos % 2:
            pos += 1
        offsets.append(pos)
        pos += len(c)
    mask_offsets = []
    if mask_chunks:
        for c in mask_chunks:
            if pos % 2:
                pos += 1
            mask_offsets.append(pos)
            pos += len(c)
    if pos % 2:
        pos += 1
    main_ifd_off = pos

    def build_main_ifd(off: int, next_off: int):
        w = _TagWriter(bo, big)
        w.add(TAG_IMAGE_WIDTH, 4, W)
        w.add(TAG_IMAGE_LENGTH, 4, H)
        w.add(TAG_BITS_PER_SAMPLE, 3, (bits,) * B)
        w.add(TAG_COMPRESSION, 3, comp)
        phot = 2 if (photometric == "RGB" and B >= 3) else 1
        w.add(TAG_PHOTOMETRIC, 3, phot)
        w.add(TAG_SAMPLES_PER_PIXEL, 3, B)
        w.add(TAG_PLANAR_CONFIG, 3, 2)  # planar (BSQ) — natural for band stacks
        if B > 1 and phot != 2:
            w.add(TAG_EXTRA_SAMPLES, 3, (0,) * (B - 1))
        elif B > 3 and phot == 2:
            w.add(TAG_EXTRA_SAMPLES, 3, (0,) * (B - 3))
        w.add(TAG_SAMPLE_FORMAT, 3, (sf,) * B)
        if predictor == 2:
            w.add(TAG_PREDICTOR, 3, 2)
        otyp = 16 if big else 4
        if tiled:
            w.add(TAG_TILE_WIDTH, 3, tw)
            w.add(TAG_TILE_LENGTH, 3, th)
            w.add(TAG_TILE_OFFSETS, otyp, tuple(offsets))
            w.add(TAG_TILE_BYTE_COUNTS, 4,
                  tuple(0 if c is None else len(c) for c in all_chunks))
        else:
            w.add(TAG_ROWS_PER_STRIP, 4, th)
            w.add(TAG_STRIP_OFFSETS, otyp, tuple(offsets))
            w.add(TAG_STRIP_BYTE_COUNTS, 4,
                  tuple(0 if c is None else len(c) for c in all_chunks))
        w.add(TAG_SOFTWARE, 2, "tpukit")
        if nodata is not None:
            ndv = float(nodata)
            txt = str(int(ndv)) if float(ndv).is_integer() else repr(ndv)
            w.add(TAG_GDAL_NODATA, 2, txt)
        md = dict(band_metadata or {})
        if tags:
            md.setdefault(0, {}).update(tags)
        xml = _gdal_metadata_xml(descriptions, md)
        if xml:
            w.add(TAG_GDAL_METADATA, 2, xml)
        if geo:
            for t, entry in geo.items():
                if isinstance(entry, IFDEntry):
                    if entry.type == 2:
                        w.add(t, 2, entry.value)
                    elif entry.type == 7:
                        w.add(t, 7, entry.value)
                    else:
                        w.add(t, entry.type, entry.value)
        elif transform is not None:
            a, b_, c, d, e, f = transform
            if b_ == 0 and d == 0 and a > 0:
                w.add(TAG_MODEL_PIXEL_SCALE, 12, (a, abs(e), 0.0))
                w.add(TAG_MODEL_TIEPOINT, 12, (0.0, 0.0, 0.0, c, f, 0.0))
            else:
                w.add(TAG_MODEL_TRANSFORMATION, 12,
                      (a, b_, 0.0, c, d, e, 0.0, f, 0, 0, 0, 0, 0, 0, 0, 1))
        return w.serialize(off, next_off)

    def build_mask_ifd(off: int):
        w = _TagWriter(bo, big)
        w.add(TAG_NEW_SUBFILE_TYPE, 4, 4)
        w.add(TAG_IMAGE_WIDTH, 4, W)
        w.add(TAG_IMAGE_LENGTH, 4, H)
        w.add(TAG_BITS_PER_SAMPLE, 3, 8)
        w.add(TAG_COMPRESSION, 3, COMPRESSION_DEFLATE)
        w.add(TAG_PHOTOMETRIC, 3, 4)  # transparency mask
        w.add(TAG_SAMPLES_PER_PIXEL, 3, 1)
        w.add(TAG_PLANAR_CONFIG, 3, 1)
        otyp = 16 if big else 4
        if tiled:
            w.add(TAG_TILE_WIDTH, 3, tw)
            w.add(TAG_TILE_LENGTH, 3, th)
            w.add(TAG_TILE_OFFSETS, otyp, tuple(mask_offsets))
            w.add(TAG_TILE_BYTE_COUNTS, 4, tuple(len(c) for c in mask_chunks))
        else:
            w.add(TAG_ROWS_PER_STRIP, 4, th)
            w.add(TAG_STRIP_OFFSETS, otyp, tuple(mask_offsets))
            w.add(TAG_STRIP_BYTE_COUNTS, 4, tuple(len(c) for c in mask_chunks))
        return w.serialize(off, 0)

    # two-pass: sizes of IFDs depend on layout, but chunk offsets are fixed,
    # so we can compute the main IFD, then the mask IFD position.
    if mask_chunks:
        # need main IFD length before we know mask ifd offset; serialize twice
        _, _, main_len = build_main_ifd(main_ifd_off, 0)
        mask_ifd_off = main_ifd_off + main_len
        if mask_ifd_off % 2:
            mask_ifd_off += 1
        main_ifd, main_over, main_len2 = build_main_ifd(main_ifd_off, mask_ifd_off)
        assert main_len2 == main_len
        mask_ifd, mask_over, _ = build_mask_ifd(mask_ifd_off)
    else:
        main_ifd, main_over, _ = build_main_ifd(main_ifd_off, 0)
        mask_ifd = mask_over = b""
        mask_ifd_off = None

    path.parent.mkdir(parents=True, exist_ok=True)
    with open_file(path, "wb") as f:
        if big:
            f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, main_ifd_off))
        else:
            f.write(b"II" + struct.pack("<HI", 42, main_ifd_off))
        pos = header_len
        for off, c in zip(offsets, all_chunks):
            if c is None:
                continue
            if pos < off:
                f.write(b"\x00" * (off - pos))
                pos = off
            f.write(c)
            pos += len(c)
        if mask_chunks:
            for off, c in zip(mask_offsets, mask_chunks):
                if pos < off:
                    f.write(b"\x00" * (off - pos))
                    pos = off
                f.write(c)
                pos += len(c)
        if pos < main_ifd_off:
            f.write(b"\x00" * (main_ifd_off - pos))
            pos = main_ifd_off
        f.write(main_ifd + main_over)
        pos += len(main_ifd) + len(main_over)
        if mask_chunks:
            if pos < mask_ifd_off:
                f.write(b"\x00" * (mask_ifd_off - pos))
            f.write(mask_ifd + mask_over)
    return path


class StripWriter:
    """Sequential strip-streaming GeoTIFF writer for scene-scale outputs.

    ``write_geotiff`` materializes every chunk in memory before writing;
    this writer accepts row blocks in ascending order and appends their
    strips to the file immediately, emitting the IFD only at ``close()`` —
    host RSS stays O(strip) no matter how large the scene (the bounded-RSS
    counterpart of the reference's rasterio windowed writes, reference
    tools/make_baseline_B.py:296-316).

    Layout: header | strip data in arrival order | main IFD | mask IFD.
    Strips are uncompressed, planar (BSQ), fixed RowsPerStrip; the result
    reads back identically through ``Dataset`` (windowed or whole) and GDAL.
    """

    def __init__(self, path, *, count: int, height: int, width: int, dtype,
                 rows_per_strip: int = 512, nodata=None, descriptions=None,
                 band_metadata=None, geo: Optional[dict] = None,
                 transform=None, tags: Optional[Dict[str, str]] = None,
                 with_mask: bool = False,
                 bigtiff: Union[bool, str] = "IF_SAFER"):
        self.path = Path(path)
        self.B, self.H, self.W = int(count), int(height), int(width)
        self.dt = np.dtype(dtype)
        if self.dt.kind == "u":
            self._sf = _SF_UINT
        elif self.dt.kind == "i":
            self._sf = _SF_INT
        elif self.dt.kind == "f":
            self._sf = _SF_FLOAT
        else:
            raise ValueError(f"Unsupported dtype {self.dt}")
        self.rps = int(rows_per_strip)
        self.strips_y = (self.H + self.rps - 1) // self.rps
        n_chunks = self.B * self.strips_y
        self._offsets = [0] * n_chunks
        self._counts = [0] * n_chunks
        self._nodata = nodata
        self._descriptions = descriptions
        self._band_metadata = band_metadata
        self._geo = geo
        self._transform = transform
        self._tags = tags
        self._with_mask = bool(with_mask)
        self._mask_chunks: Dict[int, bytes] = {}
        total = self.B * self.H * self.W * self.dt.itemsize
        if bigtiff is True or str(bigtiff).upper() == "YES":
            self._big = True
        elif bigtiff is False or str(bigtiff).upper() == "NO":
            self._big = False
        else:
            self._big = total > (1 << 32) - (1 << 26)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # crash-safe: strips stream into a .part file; only close() (which
        # emits the IFD) renames it to the final name. An interrupted
        # writer therefore never leaves a final-named, IFD-less TIFF for
        # a later resume to trust (sweep resume checks path existence).
        self._tmp = self.path.with_name(self.path.name + ".part")
        self._f = open_file(self._tmp, "wb")
        if self._big:
            self._f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, 0))
            self._pos = 16
        else:
            self._f.write(b"II" + struct.pack("<HI", 42, 0))
            self._pos = 8
        self._closed = False

    def _append(self, data: bytes) -> int:
        if self._pos % 2:
            self._f.write(b"\x00")
            self._pos += 1
        off = self._pos
        self._f.write(data)
        self._pos += len(data)
        return off

    def write(self, y0: int, block: np.ndarray) -> None:
        """Write rows [y0, y0+rows) for all bands. ``block`` is (B, rows, W)
        (or (rows, W) for single-band files); ``y0`` must be a multiple of
        rows_per_strip and rows a multiple of it too (except the last)."""
        if self._closed:
            raise IOError("StripWriter is closed")
        blk = np.asarray(block)
        if blk.ndim == 2:
            blk = blk[None]
        if blk.dtype != self.dt:
            blk = blk.astype(self.dt)
        B, rows, W = blk.shape
        if B != self.B or W != self.W:
            raise ValueError(f"block {blk.shape} != ({self.B}, rows, {self.W})")
        if y0 % self.rps != 0:
            raise ValueError(f"y0={y0} not aligned to rows_per_strip={self.rps}")
        if y0 + rows > self.H:
            raise ValueError(f"rows beyond image: {y0}+{rows} > {self.H}")
        if rows % self.rps != 0 and y0 + rows != self.H:
            raise ValueError(f"rows={rows} not a strip multiple")
        le = self.dt.newbyteorder("<")
        for s0 in range(0, rows, self.rps):
            sy = (y0 + s0) // self.rps
            srows = min(self.rps, rows - s0)
            for b in range(B):
                raw = np.ascontiguousarray(
                    blk[b, s0:s0 + srows].astype(le)).tobytes()
                ci = b * self.strips_y + sy
                self._offsets[ci] = self._append(raw)
                self._counts[ci] = len(raw)

    def write_mask(self, y0: int, mask_rows: np.ndarray) -> None:
        """Buffer validity-mask rows (deflate-compressed, tiny) for the
        internal mask IFD written at close()."""
        if not self._with_mask:
            raise ValueError("writer created without with_mask=True")
        mk = np.where(np.asarray(mask_rows) > 0, 255, 0).astype(np.uint8)
        rows = mk.shape[0]
        if y0 % self.rps != 0 or (rows % self.rps != 0 and y0 + rows != self.H):
            raise ValueError("mask rows must align to rows_per_strip")
        for s0 in range(0, rows, self.rps):
            sy = (y0 + s0) // self.rps
            srows = min(self.rps, rows - s0)
            self._mask_chunks[sy] = zlib.compress(
                mk[s0:s0 + srows].tobytes(), 6)

    def abort(self) -> None:
        """Drop an unfinished write: close the handle and remove the .part
        file. The final path is never created. Safe to call twice."""
        if self._closed:
            return
        self._closed = True
        try:
            self._f.close()
        finally:
            try:
                self._tmp.unlink(missing_ok=True)
            except OSError:
                pass

    def close(self) -> Path:
        if self._closed:
            return self.path
        bo = "<"
        big = self._big
        mask_offsets = []
        mask_counts = []
        if self._with_mask:
            for sy in range(self.strips_y):
                c = self._mask_chunks.get(sy)
                if c is None:   # unwritten mask rows read back as invalid
                    c = zlib.compress(
                        b"\x00" * (min(self.rps, self.H - sy * self.rps)
                                   * self.W), 6)
                mask_offsets.append(self._append(c))
                mask_counts.append(len(c))
        if self._pos % 2:
            self._f.write(b"\x00")
            self._pos += 1
        main_ifd_off = self._pos

        def build_main(off: int, next_off: int):
            w = _TagWriter(bo, big)
            w.add(TAG_IMAGE_WIDTH, 4, self.W)
            w.add(TAG_IMAGE_LENGTH, 4, self.H)
            w.add(TAG_BITS_PER_SAMPLE, 3, (self.dt.itemsize * 8,) * self.B)
            w.add(TAG_COMPRESSION, 3, COMPRESSION_NONE)
            w.add(TAG_PHOTOMETRIC, 3, 1)
            w.add(TAG_SAMPLES_PER_PIXEL, 3, self.B)
            w.add(TAG_PLANAR_CONFIG, 3, 2)
            if self.B > 1:
                w.add(TAG_EXTRA_SAMPLES, 3, (0,) * (self.B - 1))
            w.add(TAG_SAMPLE_FORMAT, 3, (self._sf,) * self.B)
            w.add(TAG_ROWS_PER_STRIP, 4, self.rps)
            w.add(TAG_STRIP_OFFSETS, 16 if big else 4, tuple(self._offsets))
            w.add(TAG_STRIP_BYTE_COUNTS, 4, tuple(self._counts))
            w.add(TAG_SOFTWARE, 2, "tpukit")
            if self._nodata is not None:
                ndv = float(self._nodata)
                txt = str(int(ndv)) if ndv.is_integer() else repr(ndv)
                w.add(TAG_GDAL_NODATA, 2, txt)
            md = dict(self._band_metadata or {})
            if self._tags:
                md.setdefault(0, {}).update(self._tags)
            xml = _gdal_metadata_xml(self._descriptions, md)
            if xml:
                w.add(TAG_GDAL_METADATA, 2, xml)
            if self._geo:
                for t, entry in self._geo.items():
                    if isinstance(entry, IFDEntry):
                        w.add(t, entry.type, entry.value)
            elif self._transform is not None:
                a, b_, c, d, e, f = self._transform
                if b_ == 0 and d == 0 and a > 0:
                    w.add(TAG_MODEL_PIXEL_SCALE, 12, (a, abs(e), 0.0))
                    w.add(TAG_MODEL_TIEPOINT, 12, (0.0, 0.0, 0.0, c, f, 0.0))
                else:
                    w.add(TAG_MODEL_TRANSFORMATION, 12,
                          (a, b_, 0.0, c, d, e, 0.0, f, 0, 0, 0, 0, 0, 0, 0, 1))
            return w.serialize(off, next_off)

        def build_mask(off: int):
            w = _TagWriter(bo, big)
            w.add(TAG_NEW_SUBFILE_TYPE, 4, 4)
            w.add(TAG_IMAGE_WIDTH, 4, self.W)
            w.add(TAG_IMAGE_LENGTH, 4, self.H)
            w.add(TAG_BITS_PER_SAMPLE, 3, 8)
            w.add(TAG_COMPRESSION, 3, COMPRESSION_DEFLATE)
            w.add(TAG_PHOTOMETRIC, 3, 4)
            w.add(TAG_SAMPLES_PER_PIXEL, 3, 1)
            w.add(TAG_PLANAR_CONFIG, 3, 1)
            w.add(TAG_ROWS_PER_STRIP, 4, self.rps)
            w.add(TAG_STRIP_OFFSETS, 16 if big else 4, tuple(mask_offsets))
            w.add(TAG_STRIP_BYTE_COUNTS, 4, tuple(mask_counts))
            return w.serialize(off, 0)

        if self._with_mask:
            _, _, main_len = build_main(main_ifd_off, 0)
            mask_ifd_off = main_ifd_off + main_len
            if mask_ifd_off % 2:
                mask_ifd_off += 1
            main_ifd, main_over, main_len2 = build_main(main_ifd_off,
                                                        mask_ifd_off)
            assert main_len2 == main_len
            self._f.write(main_ifd + main_over)
            self._pos += len(main_ifd) + len(main_over)
            if self._pos < mask_ifd_off:
                self._f.write(b"\x00" * (mask_ifd_off - self._pos))
            mask_ifd, mask_over, _ = build_mask(mask_ifd_off)
            self._f.write(mask_ifd + mask_over)
        else:
            main_ifd, main_over, _ = build_main(main_ifd_off, 0)
            self._f.write(main_ifd + main_over)
        # patch the header's first-IFD offset
        self._f.seek(8 if big else 4)
        self._f.write(struct.pack(bo + ("Q" if big else "I"), main_ifd_off))
        self._f.close()
        import os as _os
        _os.replace(self._tmp, self.path)
        self._closed = True
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_file(path, mode):
    import builtins
    return builtins.open(path, mode)


def update_band_descriptions(path, descriptions, band_metadata=None):
    """Rewrite a GeoTIFF with new band descriptions (read-modify-write; the
    reference mutates descriptions in place via rasterio r+ —
    tools/make_baseline_B.py:556-561)."""
    ds = Dataset(path)
    data = ds.read()
    meta = ds.meta
    mask = None
    if ds._mask_ifd is not None:
        mask = ds.dataset_mask()
    # carry existing per-band/dataset metadata through the rewrite (the
    # reference's rasterio r+ edit keeps everything else untouched);
    # caller-provided entries win
    merged_md = {b: dict(kv) for b, kv in (ds.band_metadata or {}).items()}
    for b, kv in (band_metadata or {}).items():
        merged_md.setdefault(b, {}).update(kv)
    ds.close()
    write_geotiff(path, data, nodata=meta["nodata"], descriptions=descriptions,
                  band_metadata=merged_md or None, geo=meta["geo"], mask=mask)


def window_transform(win: Window, transform) -> tuple:
    """Affine transform of a window (rasterio.windows.transform equivalent)."""
    a, b, c, d, e, f = transform
    return (a, b, c + a * win.col_off + b * win.row_off,
            d, e, f + d * win.col_off + e * win.row_off)
