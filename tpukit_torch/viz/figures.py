# -*- coding: utf-8 -*-
# The port's copy of tpukit/viz/figures.py: only its imports point at the port.
"""Rate-distortion and summary figures from metrics CSVs.

Covers the reference's three plotting tools on tpukit/reference CSVs alike
(decimal-comma tolerant):

  * RD curves per tile and HC-vs-LC combined, with control-parameter
    ordering (near > quality > bpp), anchors and point annotations, and
    optional piecewise-linear interpolation
    (reference tools/rd_curve.py:80-251)
  * multi-codec RD overlays, Pareto plots (quality vs peak RAM / encode
    time / decode time), iso-rate PSNR bars at fixed CRs via inverse
    interpolation (reference tools/overlay_means.py:192-437)
  * LC-vs-HC grouped bars for CR / encode time / peak memory
    (reference tools/fig_caseB.py:50-133)
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import pandas as pd  # noqa: E402

CODEC_LABELS = {
    "ccsds122_ext": "CCSDS-122",
    "ccsds121_ext": "CCSDS-121",
    "ccsds123_ext": "CCSDS-123",
    "j2k": "JPEG 2000",
    "j2k_gdal": "JPEG 2000",
    "jpegls": "JPEG-LS",
    "jpegls_subproc": "JPEG-LS",
    "png_lossless": "PNG",
}


def pretty_codec(name: str) -> str:
    return CODEC_LABELS.get(str(name), str(name))


def read_csv_smart(path) -> pd.DataFrame:
    from tpukit_torch.sweep.csvio import read_csv_smart as _read
    df = _read(path)
    df.columns = [re.sub(r"\s+", "_", str(c).strip()) for c in df.columns]
    return df


def load_and_merge(paths: Sequence, dedup: bool = False) -> pd.DataFrame:
    dfs = []
    for p in paths:
        df = read_csv_smart(p)
        df["__source"] = str(p)
        dfs.append(df)
    if not dfs:
        raise ValueError("no input CSVs")
    big = pd.concat(dfs, axis=0, ignore_index=True, sort=False)
    if dedup:
        key = [k for k in ("case", "asset", "codec", "encoder", "rate_key",
                           "rate_value", "tile_id", "width", "height", "bands")
               if k in big.columns]
        if key:
            big = big.sort_values("__source").drop_duplicates(subset=key, keep="last")
    return big


def norm_tile(s) -> str:
    t = str(s).strip().upper()
    if t in ("HC", "HIGH", "H"):
        return "HC"
    if t in ("LC", "LOW", "L"):
        return "LC"
    return t


def normalize_df(df: pd.DataFrame) -> pd.DataFrame:
    """Derive plotting helper columns (reference overlay_means.py:91-128).

    Inputs are AGGREGATED metrics_mean.csv frames; like the reference
    tools (rd_curve.py:43-46 raises SystemExit), a per-run metrics.csv
    is rejected with a clear message instead of a downstream KeyError."""
    need = ["bpp_mean", "psnr_global_rep"]
    missing = [c for c in need if c not in df.columns]
    if missing:
        raise ValueError(
            "Missing required column(s): " + ", ".join(missing) +
            " — pass metrics_mean.csv (aggregated), not a per-run "
            "metrics.csv")
    d = df.copy()
    if "bpp" not in d.columns and "bpp_mean" in d.columns:
        d["bpp"] = pd.to_numeric(d["bpp_mean"], errors="coerce")
    for src, dst in (("psnr_global_rep", "_psnr"), ("ssim_global_rep", "_ssim"),
                     ("t_comp_s_mean", "_tenc"), ("t_dec_s_mean", "_tdec"),
                     ("mem_comp_peak_mb_mean", "_mem")):
        if src in d.columns:
            d[dst] = pd.to_numeric(d[src], errors="coerce")
    if "nearlossless_eps" in d.columns:
        d["near"] = pd.to_numeric(d["nearlossless_eps"], errors="coerce")
    if "rate_key" in d.columns and "rate_value" in d.columns:
        rk = d["rate_key"].astype(str).str.lower()
        rv = pd.to_numeric(d["rate_value"], errors="coerce")
        d.loc[rk == "quality", "quality"] = rv
        d.loc[rk.isin(["nearlossless_eps", "near", "error", "eps"]), "near"] = rv
        d.loc[rk == "bpp", "bpp_ctrl"] = rv
    if "tile_id" in d.columns:
        d["tile_id"] = d["tile_id"].apply(norm_tile)
    for c in ("bpp", "_psnr", "_ssim", "quality", "near", "bpp_ctrl"):
        if c in d.columns:
            d[c] = pd.to_numeric(d[c], errors="coerce")
    return d


def sort_for_plot(dd: pd.DataFrame) -> pd.DataFrame:
    """near > quality > bpp ordering (reference rd_curve.py:122-125)."""
    if "near" in dd.columns and dd["near"].notna().any():
        return dd.sort_values("near")
    if "quality" in dd.columns and dd["quality"].notna().any():
        return dd.sort_values("quality")
    if "bpp" in dd.columns:
        return dd.sort_values("bpp")
    return dd


def _monotone_samples(key, val):
    """(key, val) prepared for np.interp: NaN pairs dropped, ordered by
    key, duplicate keys collapsed to their first-seen sample. One shared
    primitive behind all three curve-interp helpers (the reference
    repeats this dance inline per function, overlay_means.py:142-185)."""
    key = np.asarray(key, float)
    val = np.asarray(val, float)
    ok = ~(np.isnan(key) | np.isnan(val))
    key, val = key[ok], val[ok]
    order = np.argsort(key, kind="stable")
    ukey, first = np.unique(key[order], return_index=True)
    return ukey, val[order][first]


def interp_curve_xy(x, y, n=200):
    """Densify an RD curve to ``n`` uniform x samples."""
    xs, ys = _monotone_samples(x, y)
    if xs.size < 2:
        return xs, ys
    xi = np.linspace(xs[0], xs[-1], int(n))
    return xi, np.interp(xi, xs, ys)


def interp_y_at_x(x, y, x_targets):
    """y at each x target; NaN outside the curve's x support."""
    xs, ys = _monotone_samples(x, y)
    xt = np.asarray(x_targets, float)
    if xs.size < 2:
        return np.full(xt.shape, np.nan)
    return np.where((xt >= xs[0]) & (xt <= xs[-1]),
                    np.interp(xt, xs, ys), np.nan)


def interp_x_at_y(x, y, y_target):
    """Inverse read-off: x where the curve crosses ``y_target``, NaN
    outside the y support."""
    ys, xs = _monotone_samples(y, x)
    if ys.size < 2 or not (ys[0] <= y_target <= ys[-1]):
        return np.nan
    return float(np.interp(y_target, ys, xs))


def _plot_curve(ax, x, y, label, interp=False, num_points=200):
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    m = ~(np.isnan(x) | np.isnan(y))
    x, y = x[m], y[m]
    if len(x) == 0:
        return
    i = np.argsort(x)
    x, y = x[i], y[i]
    ux, fi = np.unique(x, return_index=True)
    x, y = ux, y[fi]
    if interp and len(x) >= 2:
        xi, yi = interp_curve_xy(x, y, num_points)
        ax.plot(xi, yi, "-", linewidth=1.5, label=label)
        ax.plot(x, y, "o", markersize=4, linestyle="None", label="_nolegend_")
    else:
        ax.plot(x, y, "-o", markersize=4, linewidth=1.5, label=label)
    ax.grid(True, linewidth=0.3)


def _mark_anchor(ax, dd, x, y, spec: Optional[str]):
    if not spec:
        return
    try:
        key, val = spec.split("=")
        key = key.strip().lower()
        val = float(val)
        m = None
        if key in ("near", "error") and "near" in dd.columns:
            m = dd["near"].astype(float).to_numpy() == val
        elif key in ("q", "quality") and "quality" in dd.columns:
            m = dd["quality"].astype(float).to_numpy() == val
        elif key == "bpp":
            src = (dd["bpp_ctrl"] if "bpp_ctrl" in dd.columns else dd["bpp"])
            m = np.isclose(src.astype(float).to_numpy(), val, rtol=0, atol=1e-12)
        if m is not None and m.any():
            ax.plot([np.asarray(x, float)[m][0]], [np.asarray(y, float)[m][0]],
                    marker="*", markersize=14, linestyle="None",
                    label="_nolegend_")
    except Exception:
        pass


def _ycol(dd, ymetric):
    if ymetric == "psnr":
        return "_psnr", "PSNR [dB]"
    if ymetric == "ssim":
        return "_ssim", "SSIM"
    raise ValueError("ymetric must be psnr or ssim")


def plot_rd(df: pd.DataFrame, out_prefix, tiles=None, ymetric="psnr",
            codec: Optional[str] = None, anchors: Optional[Dict[str, str]] = None,
            interp=False, interp_points=200, annotate=True) -> List[Path]:
    """Per-tile RD curves + combined HC-vs-LC (reference rd_curve.py
    plot_rd_single/plot_rd_both)."""
    d = normalize_df(df)
    if codec is not None and "codec" in d.columns:
        d = d[d["codec"] == codec]
    out_prefix = Path(out_prefix)
    out_prefix.parent.mkdir(parents=True, exist_ok=True)
    ycol, ylabel = _ycol(d, ymetric)
    suf = "PSNR" if ymetric == "psnr" else "SSIM"
    if tiles is None:
        tiles = sorted(d["tile_id"].dropna().unique()) if "tile_id" in d.columns else ["ALL"]
    written = []

    def draw(ax, dd, label):
        dd = sort_for_plot(dd)
        x = dd["bpp"].to_numpy(float)
        y = dd[ycol].to_numpy(float)
        _plot_curve(ax, x, y, label, interp, interp_points)
        if annotate:
            for ctrl in ("quality", "near"):
                if ctrl in dd.columns and dd[ctrl].notna().any():
                    for xi, yi, qi in zip(x, y, dd[ctrl].to_numpy(float)):
                        if not np.isnan(qi) and not np.isnan(xi) and not np.isnan(yi):
                            ax.annotate(str(int(qi)), (xi, yi), xytext=(3, 3),
                                        textcoords="offset points", fontsize=8)
        for spec in (anchors or {}).values():
            _mark_anchor(ax, dd, x, y, spec)
        return x, y

    # combined
    fig, ax = plt.subplots(figsize=(6, 4))
    for t in tiles:
        dd = d[d["tile_id"] == t] if "tile_id" in d.columns else d
        if dd.empty:
            continue
        draw(ax, dd, str(t))
    ax.set_xlabel("bpp per band")
    ax.set_ylabel(ylabel)
    ax.set_title("RD – HC vs LC")
    ax.legend(title="Tile")
    p = Path(f"{out_prefix}_RD_HC_vs_LC_{suf}.png")
    fig.tight_layout()
    fig.savefig(p, dpi=200)
    plt.close(fig)
    written.append(p)

    for t in tiles:
        dd = d[d["tile_id"] == t] if "tile_id" in d.columns else d
        if dd.empty:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        draw(ax, dd, str(t))
        ax.set_xlabel("bpp per band")
        ax.set_ylabel(ylabel)
        ax.set_title(f"RD – {t}")
        ax.legend()
        p = Path(f"{out_prefix}_RD_{t}_{suf}.png")
        fig.tight_layout()
        fig.savefig(p, dpi=200)
        plt.close(fig)
        written.append(p)
    return written


def overlay_rd(df: pd.DataFrame, out_prefix, tiles=("HC", "LC"),
               ymetric="psnr", anchors=None, interp=False,
               interp_points=200) -> List[Path]:
    """Multi-codec RD overlay per tile (reference overlay_means.py:192-244)."""
    d = normalize_df(df)
    out_prefix = Path(out_prefix)
    out_prefix.parent.mkdir(parents=True, exist_ok=True)
    ycol, ylab = _ycol(d, ymetric)
    written = []
    for tile in tiles:
        dd = d[d["tile_id"] == tile] if "tile_id" in d.columns else d
        if dd.empty:
            continue
        fig, ax = plt.subplots(figsize=(7.2, 4.2))
        for codec, g in dd.groupby("codec"):
            gg = sort_for_plot(g.copy())
            x = gg["bpp"].to_numpy(float)
            y = gg[ycol].to_numpy(float)
            _plot_curve(ax, x, y, pretty_codec(codec), interp, interp_points)
            _mark_anchor(ax, gg, x, y, (anchors or {}).get(str(codec)))
        ax.set_xlabel("bpp per band")
        ax.set_ylabel(ylab)
        ax.set_title(f"RD overlay – {tile} ({ylab})")
        ax.grid(True, linewidth=0.3)
        ax.legend(title="Codec")
        p = out_prefix.parent / f"{out_prefix.name}_RD_{tile}_{ylab.replace(' ', '_')}.png"
        fig.tight_layout()
        fig.savefig(p, dpi=200)
        plt.close(fig)
        written.append(p)
    return written


def pareto_plots(df: pd.DataFrame, out_prefix, tile="HC", ymetric="psnr",
                 anchors=None) -> List[Path]:
    """Quality vs peak RAM / encode time / decode time
    (reference overlay_means.py:270-360)."""
    d = normalize_df(df)
    dd = d[d["tile_id"] == tile] if "tile_id" in d.columns else d
    out_prefix = Path(out_prefix)
    out_prefix.parent.mkdir(parents=True, exist_ok=True)
    ycol, ylab = _ycol(d, ymetric)
    written = []
    for xcol, xlab, tag in (("_mem", "Peak RAM [MB]", "RAM"),
                            ("_tenc", "Encode time [s]", "EncodeTime"),
                            ("_tdec", "Decode time [s]", "DecodeTime")):
        if xcol not in dd.columns or dd.empty:
            continue
        fig, ax = plt.subplots(figsize=(6.6, 4.2))
        for codec, g in dd.groupby("codec"):
            ax.plot(g[xcol], g[ycol], "o", markersize=5, label=pretty_codec(codec))
            _mark_anchor(ax, g, g[xcol].to_numpy(float), g[ycol].to_numpy(float),
                         (anchors or {}).get(str(codec)))
        ax.set_xlabel(xlab)
        ax.set_ylabel(ylab)
        ax.set_title(f"Pareto – {tile}: {ylab} vs {xlab}")
        ax.grid(True, linewidth=0.3)
        ax.legend(title="Codec")
        p = out_prefix.parent / f"{out_prefix.name}_Pareto_{tile}_{ylab.replace(' ', '_')}_vs_{tag}.png"
        fig.tight_layout()
        fig.savefig(p, dpi=200)
        plt.close(fig)
        written.append(p)
    return written


def ensure_cr_column(d: pd.DataFrame) -> pd.DataFrame:
    d = d.copy()
    if "cr_mean" not in d.columns:
        if {"in_bytes", "bitstream_bytes_mean"}.issubset(d.columns):
            d["cr_mean"] = (pd.to_numeric(d["in_bytes"], errors="coerce") /
                            pd.to_numeric(d["bitstream_bytes_mean"], errors="coerce"))
        else:
            raise ValueError("Need cr_mean or (in_bytes & bitstream_bytes_mean)")
    d["cr_mean"] = pd.to_numeric(d["cr_mean"], errors="coerce")
    return d


def iso_rate_psnr_bars(df: pd.DataFrame, out_prefix, tile="HC",
                       cr_list=(2, 5, 7)) -> Optional[Path]:
    """PSNR at fixed CRs per codec (reference overlay_means.py:380-437)."""
    d = ensure_cr_column(normalize_df(df))
    if "tile_id" in d.columns:
        d = d[d["tile_id"] == tile]
    if d.empty:
        return None
    codecs = sorted(map(str, d["codec"].dropna().unique()))
    cr_list = list(cr_list)
    mat = np.full((len(codecs), len(cr_list)), np.nan)
    for i, codec in enumerate(codecs):
        g = d[d["codec"] == codec]
        cr = pd.to_numeric(g["cr_mean"], errors="coerce").to_numpy(float)
        ps = pd.to_numeric(g["psnr_global_rep"], errors="coerce").to_numpy(float)
        if np.isfinite(cr).sum() >= 2 and np.isfinite(ps).sum() >= 2:
            mat[i, :] = interp_y_at_x(cr, ps, np.asarray(cr_list, float))
    fig, ax = plt.subplots(figsize=(8.0, 4.0))
    x = np.arange(len(codecs))
    width = 0.8 / max(1, len(cr_list))
    for j, crv in enumerate(cr_list):
        offs = x - 0.4 + width / 2 + j * width
        vals = mat[:, j]
        bars = ax.bar(offs, np.nan_to_num(vals), width, label=f"CR={crv}")
        for bx, v in zip(bars, vals):
            if np.isnan(v):
                bx.set_alpha(0.3)
                ax.text(bx.get_x() + bx.get_width() / 2, 1.0, "N/A",
                        ha="center", va="bottom", fontsize=8, rotation=90)
            else:
                ax.text(bx.get_x() + bx.get_width() / 2, v, f"{v:.1f}",
                        ha="center", va="bottom", fontsize=8)
    ax.set_xticks(x)
    ax.set_xticklabels([pretty_codec(c) for c in codecs], fontsize=11)
    ax.set_ylabel("PSNR [dB]")
    ax.set_title(f"Iso-rate: PSNR at fixed CR ({', '.join(map(str, cr_list))}) – {tile}")
    ax.legend(title="Fixed CR")
    ax.grid(axis="y", linewidth=0.3)
    # clamp the axis to the finite values (reference overlay_means.py:
    # 425-433) — lossless rows carry PSNR=inf, which must not blow up the
    # scale
    finite_vals = mat[np.isfinite(mat)]
    if finite_vals.size:
        ymin = max(0.0, np.floor(finite_vals.min() - 1))
        ymax = min(100.0, np.ceil(finite_vals.max() + 1))
        if ymin < ymax:
            ax.set_ylim(ymin, ymax)
    else:
        ax.set_ylim(0, 100)
    out_prefix = Path(out_prefix)
    out_prefix.parent.mkdir(parents=True, exist_ok=True)
    p = out_prefix.parent / f"{out_prefix.name}_IsoRate_{tile}.png"
    fig.tight_layout()
    fig.savefig(p, dpi=200)
    plt.close(fig)
    return p


def caseb_bars(df: pd.DataFrame, outdir, max_codecs=3, mem="enc") -> List[Path]:
    """LC-vs-HC grouped bars: CR, encode time, peak memory
    (reference fig_caseB.py:50-133)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    d = df.copy()
    d.columns = [re.sub(r"\s+", "_", str(c).strip()) for c in d.columns]

    def find_col(cands):
        low = {c.lower(): c for c in d.columns}
        for c in cands:
            if c.lower() in low:
                return low[c.lower()]
        raise KeyError(f"None of {cands} in columns")

    col_tile = find_col(["tile_id", "tile", "tier", "profile"])
    col_codec = find_col(["codec", "coder", "codec_name"])
    col_cr = find_col(["cr_mean", "cr", "compression_ratio", "ratio"])
    col_tenc = find_col(["t_comp_s_mean", "enc_time_mean", "encode_time_mean", "t_comp_s"])
    col_mem = find_col(["mem_comp_peak_mb_mean", "mem_comp_peak_mb"] if mem == "enc"
                       else ["mem_dec_peak_mb_mean", "mem_dec_peak_mb"])
    d["tier"] = d[col_tile].apply(norm_tile)
    d = d[d["tier"].isin(["LC", "HC"])].copy()
    for col in (col_cr, col_tenc, col_mem):
        d[col] = pd.to_numeric(d[col], errors="coerce")
    codecs = pd.Index(d[col_codec].dropna().astype(str).unique())[:max_codecs]
    d[col_codec] = pd.Categorical(d[col_codec].astype(str),
                                  categories=list(codecs), ordered=True)

    written = []
    for metric, title, ylab, fname in (
            (col_cr, "CR achieved (LC vs HC)", "CR (ratio)", "fig_cr.png"),
            (col_tenc, "Encoding time (LC vs HC)", "Time [s]", "fig_time.png"),
            (col_mem, f"Peak memory (LC vs HC) [{mem.upper()}]", "Memory [MiB]",
             "fig_mem.png")):
        pvt = (d.groupby([col_codec, "tier"], as_index=False, observed=False)[metric]
                .mean()
                .pivot(index=col_codec, columns="tier", values=metric)
                .reindex(codecs))
        for t in ("LC", "HC"):
            if t not in pvt.columns:
                pvt[t] = np.nan
        pvt = pvt[["LC", "HC"]]
        ax = pvt.plot(kind="bar", rot=0, figsize=(8, 4.2))
        ax.set_title(title)
        ax.set_xlabel("Codec")
        ax.set_ylabel(ylab)
        ax.legend(title="Tier")
        for cont in ax.containers:
            try:
                ax.bar_label(cont, fmt="%.2f")
            except Exception:
                pass
        plt.tight_layout()
        p = outdir / fname
        plt.savefig(p, dpi=160)
        plt.close()
        written.append(p)
    return written
