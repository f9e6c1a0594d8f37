# -*- coding: utf-8 -*-
# The port's copy of tpukit/sweep/csvio.py: only its imports point at the port.
"""CSV contract: per-run metrics.csv and aggregated metrics_mean.csv.

Field names, column order, separator (';'), decimal-comma number
formatting, 6-decimal trimming, per-band column expansion, and the
means+IQR aggregation (with the lossless_all → PSNR=inf/SSIM=1 override)
all follow the reference harness so downstream figure tools and existing
spreadsheets keep working:
  * row formatting      — reference tools/run_codec.py:143-173
  * base/band columns   — :568-585
  * aggregation         — :598-670
A ``decimal="."`` mode is provided as an option for plainer consumers.
"""

from __future__ import annotations

import csv
import math
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BASE_COLS = [
    "case", "asset", "codec", "encoder", "nearlossless_eps",
    "rate_key", "rate_value", "tile_id",
    "width", "height", "bands", "in_bytes", "bitstream_bytes",
    "cr", "bpp",
    "psnr_band_avg", "ssim_band_avg", "psnr_global", "ssim_global",
    "max_abs_err", "lossless",
    "sam_deg", "sid", "lmse",
    "t_comp_s", "t_dec_s", "t_wrap_s", "mem_comp_peak_mb", "mem_dec_peak_mb",
    "link_mbps", "link_eff", "t_link_tile_s", "t_e2e_tile_s",
    "mem_comp_peak_bytes", "mem_dec_peak_bytes",
    # device-memory observability (TPU-native analog of the reference's
    # peak-RAM axis, proc_metrics.py:93-106): accelerator HBM peak at
    # the end of the tile's device pass, from device.memory_stats().
    # Empty on backends that expose no stats (e.g. CPU).
    "hbm_peak_mb", "hbm_peak_bytes",
]

MAX_BAND_COLS = 64  # per-band columns emitted up to 63 bands (ref :581)


def _is_number(x) -> bool:
    return isinstance(x, (int, float, np.number)) and not isinstance(x, bool)


def fmt_number(x, decimal: str = ",") -> str:
    """Format one numeric cell: 6 decimals, trailing zeros trimmed,
    'inf' literal, NaN → empty, decimal comma by default."""
    if x is None:
        return ""
    if isinstance(x, (np.floating,)):
        x = float(x)
    if isinstance(x, (np.integer,)):
        x = int(x)
    if isinstance(x, float):
        if math.isinf(x):
            return "inf" if x > 0 else "-inf"
        if math.isnan(x):
            return ""
        s = f"{x:.6f}".rstrip("0").rstrip(".")
        return s.replace(".", decimal) if decimal != "." else s
    if isinstance(x, int):
        return str(x)
    return str(x)


def format_row(row: Dict[str, object], decimal: str = ",") -> Dict[str, str]:
    out = {}
    for k, v in row.items():
        if _is_number(v):
            out[k] = fmt_number(v, decimal)
        elif isinstance(v, np.generic):
            out[k] = fmt_number(v.item(), decimal)
        else:
            out[k] = "" if v is None else str(v)
    return out


def band_columns(rows: List[dict]) -> List[str]:
    cols = []
    for i in range(1, MAX_BAND_COLS):
        for k in (f"psnr_b{i}", f"ssim_b{i}", f"maxerr_b{i}"):
            if any(k in r for r in rows):
                cols.append(k)
    return cols


def write_metrics_csv(path, rows: List[dict], decimal: str = ",") -> Path:
    path = Path(path)
    header = BASE_COLS + band_columns(rows)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=header, extrasaction="ignore", delimiter=";")
        w.writeheader()
        for row in rows:
            w.writerow(format_row(row, decimal))
    return path


# ---------------------------------------------------------------------------
# Aggregation (means; IQR for times/RAM)
# ---------------------------------------------------------------------------

def _flt(x) -> Optional[float]:
    try:
        v = float(x)
        return v if math.isfinite(v) else None
    except (TypeError, ValueError):
        return None


def _vec(grp, col):
    return [v for v in (_flt(r.get(col)) for r in grp) if v is not None]


def _mean(vs):
    return (sum(vs) / len(vs)) if vs else None


def _iqr(vs):
    if not vs:
        return None
    a = np.asarray(vs, dtype=float)
    return float(np.percentile(a, 75) - np.percentile(a, 25))


def group_key(r: dict):
    """The RD-point identity for aggregation (reference run_codec.py:615)."""
    return (r.get("case"), r.get("asset"), r.get("codec"), r.get("encoder"),
            r.get("nearlossless_eps"), r.get("rate_key"), r.get("rate_value"),
            r.get("tile_id"), r.get("width"), r.get("height"), r.get("bands"),
            r.get("link_mbps"), r.get("link_eff"))


def aggregate_rows(rows: List[dict]) -> List[dict]:
    band_keys = sorted({k for r in rows for k in r
                        if k.startswith(("psnr_b", "ssim_b", "maxerr_b"))})
    groups = defaultdict(list)
    for r in rows:
        groups[group_key(r)].append(r)
    out = []
    for _, grp in groups.items():
        r0 = grp[0]
        rowm = {
            "case": r0.get("case"), "asset": r0.get("asset"),
            "codec": r0.get("codec"), "encoder": r0.get("encoder"),
            "nearlossless_eps": r0.get("nearlossless_eps"),
            "rate_key": r0.get("rate_key"), "rate_value": r0.get("rate_value"),
            "tile_id": r0.get("tile_id"),
            "width": int(r0["width"]), "height": int(r0["height"]),
            "bands": int(r0["bands"]), "in_bytes": int(r0.get("in_bytes")),
            "bitstream_bytes_mean": _mean(_vec(grp, "bitstream_bytes")),
            "bpp_mean": _mean(_vec(grp, "bpp")),
            "cr_mean": _mean(_vec(grp, "cr")),
            "psnr_band_avg_rep": _mean(_vec(grp, "psnr_band_avg")),
            "ssim_band_avg_rep": _mean(_vec(grp, "ssim_band_avg")),
            "max_abs_err_mean": _mean(_vec(grp, "max_abs_err")),
            "psnr_global_rep": _mean(_vec(grp, "psnr_global")),
            "ssim_global_rep": _mean(_vec(grp, "ssim_global")),
            "sam_deg_rep": _mean(_vec(grp, "sam_deg")),
            "sid_rep": _mean(_vec(grp, "sid")),
            "lmse_rep": _mean(_vec(grp, "lmse")),
            "lossless_all": 1 if all(int(r.get("lossless", 0)) == 1 for r in grp) else 0,
            "t_comp_s_mean": _mean(_vec(grp, "t_comp_s")),
            "t_comp_s_iqr": _iqr(_vec(grp, "t_comp_s")),
            "t_dec_s_mean": _mean(_vec(grp, "t_dec_s")),
            "t_dec_s_iqr": _iqr(_vec(grp, "t_dec_s")),
            "t_e2e_tile_s_mean": _mean(_vec(grp, "t_e2e_tile_s")),
            "t_e2e_tile_s_iqr": _iqr(_vec(grp, "t_e2e_tile_s")),
            "t_link_tile_s_mean": _mean(_vec(grp, "t_link_tile_s")),
            "mem_comp_peak_mb_mean": _mean(_vec(grp, "mem_comp_peak_mb")),
            "mem_comp_peak_mb_iqr": _iqr(_vec(grp, "mem_comp_peak_mb")),
            "mem_dec_peak_mb_mean": _mean(_vec(grp, "mem_dec_peak_mb")),
            "mem_dec_peak_mb_iqr": _iqr(_vec(grp, "mem_dec_peak_mb")),
            "link_mbps": r0.get("link_mbps"), "link_eff": r0.get("link_eff"),
            "n_reps": len(grp),
        }
        # perfect-lossless groups override quality metrics (reference :665-666)
        if rowm["lossless_all"] == 1:
            rowm.update({"psnr_band_avg_rep": float("inf"),
                         "ssim_band_avg_rep": 1.0,
                         "max_abs_err_mean": 0,
                         "psnr_global_rep": float("inf"),
                         "ssim_global_rep": 1.0})
        for bk in band_keys:
            rowm[bk + "_rep"] = _mean(_vec(grp, bk))
        out.append(rowm)
    return out


MEAN_COLS_HEAD = [
    "case", "asset", "codec", "encoder", "nearlossless_eps",
    "rate_key", "rate_value", "tile_id",
    "width", "height", "bands", "in_bytes",
    "bitstream_bytes_mean", "bpp_mean", "cr_mean",
    "psnr_band_avg_rep", "ssim_band_avg_rep", "max_abs_err_mean",
    "psnr_global_rep", "ssim_global_rep",
    "sam_deg_rep", "sid_rep", "lmse_rep",
    "lossless_all",
    "t_comp_s_mean", "t_comp_s_iqr",
    "t_dec_s_mean", "t_dec_s_iqr",
    "t_e2e_tile_s_mean", "t_e2e_tile_s_iqr",
    "t_link_tile_s_mean",
    "mem_comp_peak_mb_mean", "mem_comp_peak_mb_iqr",
    "mem_dec_peak_mb_mean", "mem_dec_peak_mb_iqr",
    "link_mbps", "link_eff", "n_reps",
]


def write_mean_csv(path, rows: List[dict], decimal: str = ",") -> Path:
    """Aggregate per-rep rows and write metrics_mean.csv."""
    path = Path(path)
    mean_rows = aggregate_rows(rows)
    # NOTE lexicographic sort and no 63-band cap, UNLIKE the per-run file:
    # this asymmetry is the reference's own contract (run_codec.py:613
    # sorted() vs :581 range(1,64)) and downstream tools depend on it
    band_keys = sorted({k for r in rows for k in r
                       if k.startswith(("psnr_b", "ssim_b", "maxerr_b"))})
    header = MEAN_COLS_HEAD + [k + "_rep" for k in band_keys]
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=header, extrasaction="ignore", delimiter=";")
        w.writeheader()
        for row in mean_rows:
            w.writerow(format_row(row, decimal))
    return path


def read_csv_smart(path):
    """Decimal-comma tolerant reader (reference rd_curve.py:25-30)."""
    import pandas as pd
    try:
        return pd.read_csv(path, sep=None, engine="python", decimal=",")
    except Exception:
        return pd.read_csv(path, sep=None, engine="python", decimal=".")
