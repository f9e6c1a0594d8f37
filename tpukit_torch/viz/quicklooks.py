# -*- coding: utf-8 -*-
# The port's copy of tpukit/viz/quicklooks.py: only its imports point at the port.
"""RGB quicklooks and 8-bit error maps.

Functional equivalent of reference tools/quicklooks.py: percentile stretch
parameters from the baseline (:51-70), 8-bit RGB GeoTIFF writer that drops
nodata and carries the validity mask (:76-109), and 8-bit per-pixel
max|Δ|-across-bands error maps at fixed caps with GIS statistics tags
(:115-207). Array-first API with thin path-based wrappers; output files are
tiled DEFLATE GeoTIFFs like the reference's.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tpukit_torch.io import tiff

RGB_ORDER = [3, 2, 1]  # 1-based band order (reference quicklooks.py:29)


def valid_mask_from_ds(ds: tiff.Dataset) -> np.ndarray:
    """dataset_mask ∧ (first band != nodata), as reference :35-45."""
    m = ds.dataset_mask() > 0
    nd = ds.nodata
    if nd is not None and np.isfinite(nd):
        m &= ds.read(1) != nd
    return m


def stretch_params_from_arrays(bands: np.ndarray, valid: Optional[np.ndarray],
                               pct=(2, 98)) -> List[Tuple[float, float]]:
    """(lo, hi) per channel over valid, finite pixels (reference :51-70)."""
    params = []
    for i in range(bands.shape[0]):
        vals = bands[i].astype(np.float32)
        sel = np.isfinite(vals)
        if valid is not None:
            sel &= valid
        v = vals[sel]
        if v.size == 0:
            lo, hi = 0.0, 1.0
        else:
            lo, hi = np.percentile(v, pct)
            if not np.isfinite(lo):
                lo = 0.0
            if (not np.isfinite(hi)) or hi <= lo:
                hi = lo + 1.0
        params.append((float(lo), float(hi)))
    return params


def stretch_params_from_baseline(path, rgb_order: Sequence[int] = RGB_ORDER,
                                 pct=(2, 98)) -> List[Tuple[float, float]]:
    with tiff.open(path) as ds:
        bands = ds.read(list(rgb_order)).astype(np.float32)
        return stretch_params_from_arrays(bands, valid_mask_from_ds(ds), pct)


def rgb8_from_arrays(bands: np.ndarray, params) -> np.ndarray:
    """Stretch (3,H,W) to uint8 per channel (reference stretch8 :79-81)."""
    out = np.empty(bands.shape, np.uint8)
    for i in range(bands.shape[0]):
        lo, hi = params[i]
        y = np.clip((bands[i].astype(np.float32) - lo) / (hi - lo + 1e-9), 0, 1)
        out[i] = (y * 255.0).astype(np.uint8)
    return out


def write_rgb_8bit(src_path, out_path, params,
                   rgb_order: Sequence[int] = RGB_ORDER) -> Path:
    """8-bit RGB GeoTIFF without nodata propagation, mask carried
    (reference :76-109)."""
    with tiff.open(src_path) as ds:
        if ds.count < 3:
            raise ValueError(f"Need >=3 bands for RGB in {src_path}")
        rgb = rgb8_from_arrays(ds.read(list(rgb_order)), params)
        return tiff.write_geotiff(
            Path(out_path), rgb, photometric="RGB", compress="DEFLATE",
            blockxsize=512, blockysize=512, geo=ds.geo,
            mask=ds.dataset_mask())


def error_max8_from_arrays(a: np.ndarray, b: np.ndarray,
                           valid: Optional[np.ndarray],
                           cap: Optional[int], pct=(2, 98)):
    """Per-pixel max|Δ| across bands scaled to uint8; returns (err8, cap_used)
    (reference to_err8 :136-150)."""
    err = np.max(np.abs(a.astype(np.int32) - b.astype(np.int32)), axis=0).astype(np.float32)
    if valid is not None:
        err[~valid] = 0.0
    if cap is None:
        nz = err[err > 0]
        if nz.size:
            lo, hi = np.percentile(nz, pct)
            if not np.isfinite(lo):
                lo = 0.0
            if (not np.isfinite(hi)) or hi <= lo:
                hi = lo + 1.0
        else:
            lo, hi = 0.0, 1.0
    else:
        lo, hi = 0.0, float(cap)
    e8 = (np.clip((err - lo) / (hi - lo + 1e-9), 0, 1) * 255.0).astype(np.uint8)
    return e8, int(round(hi))


def err8_lut(cap: int, nvals: int = 65536) -> np.ndarray:
    """uint8 transfer table for integer max|Δ| errors: ``err8_lut(cap)[err]``
    reproduces the fixed-cap scaling of :func:`error_max8_from_arrays`
    bit-exactly (same f32 ops, evaluated once per possible error value).
    The sweep runner uses it to render error maps ON DEVICE as a masked
    int reduction + table lookup, fetching only (H, W) uint8 maps."""
    x = np.arange(nvals, dtype=np.float32)
    lo, hi = 0.0, float(cap)
    return (np.clip((x - lo) / (hi - lo + 1e-9), 0, 1) * 255.0).astype(np.uint8)


def _write_err_tif(path, err8: np.ndarray, valid: Optional[np.ndarray], geo):
    tags = {
        "STATISTICS_MINIMUM": "0",
        "STATISTICS_MAXIMUM": "255",
        "STATISTICS_MEAN": str(float(err8.mean())),
        "STATISTICS_STDDEV": str(float(err8.std())),
        "PIXEL_MINIMUM": "0",
        "PIXEL_MAXIMUM": "255",
    }
    return tiff.write_geotiff(
        Path(path), err8, compress="DEFLATE", blockxsize=512, blockysize=512,
        geo=geo, mask=(valid.astype(np.uint8) * 255) if valid is not None else None,
        tags=tags)


def write_rgb_8bit_arrays(bands_rgb: np.ndarray, out_path, params,
                          geo=None, mask: Optional[np.ndarray] = None) -> Path:
    """Array-first variant of write_rgb_8bit: same output file contract,
    but from an in-memory (3,H,W) stack (the sweep runner already holds the
    cubes in RAM/HBM — re-reading the TIFFs per rate point like the
    reference does, quicklooks.py:76-109, would be pure IO overhead)."""
    rgb = rgb8_from_arrays(bands_rgb, params)
    return tiff.write_geotiff(
        Path(out_path), rgb, photometric="RGB", compress="DEFLATE",
        blockxsize=512, blockysize=512, geo=geo, mask=mask)


def write_error_max8_arrays(a: np.ndarray, b: np.ndarray,
                            valid: Optional[np.ndarray], out_path_base,
                            err_max_global: int = 255,
                            err_max_zoom: Optional[int] = None,
                            geo=None, pct=(2, 98)):
    """Array-first variant of write_error_max8 (same filenames/tags)."""
    out_base = Path(out_path_base)
    out_base.parent.mkdir(parents=True, exist_ok=True)
    err8_g, cap_g = error_max8_from_arrays(a, b, valid, err_max_global, pct)
    out_g = out_base.with_name(out_base.stem + f"_ERR8_0_{cap_g}.tif")
    _write_err_tif(out_g, err8_g, valid, geo)
    out_z = None
    if err_max_zoom is not None:
        err8_z, cap_z = error_max8_from_arrays(a, b, valid, err_max_zoom, pct)
        out_z = out_base.with_name(out_base.stem + f"_ERR8_0_{cap_z}.tif")
        _write_err_tif(out_z, err8_z, valid, geo)
    return out_g, out_z


def write_error_max8(a_path, b_path, out_path_base, err_max_global: int = 255,
                     err_max_zoom: Optional[int] = None, pct=(2, 98)):
    """<base>_ERR8_0_<cap>.tif (+ optional zoom variant), reference :115-207."""
    with tiff.open(a_path) as da, tiff.open(b_path) as db:
        A = da.read()
        B = db.read()
        if A.shape != B.shape:
            raise ValueError("Dims/band count must match")
        valid = (valid_mask_from_ds(da)) & (valid_mask_from_ds(db))
        out_base = Path(out_path_base)
        out_base.parent.mkdir(parents=True, exist_ok=True)
        err8_g, cap_g = error_max8_from_arrays(A, B, valid, err_max_global, pct)
        out_g = out_base.with_name(out_base.stem + f"_ERR8_0_{cap_g}.tif")
        _write_err_tif(out_g, err8_g, valid, da.geo)
        out_z = None
        if err_max_zoom is not None:
            err8_z, cap_z = error_max8_from_arrays(A, B, valid, err_max_zoom, pct)
            out_z = out_base.with_name(out_base.stem + f"_ERR8_0_{cap_z}.tif")
            _write_err_tif(out_z, err8_z, valid, da.geo)
        return out_g, out_z
