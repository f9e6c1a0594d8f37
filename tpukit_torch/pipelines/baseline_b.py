# -*- coding: utf-8 -*-
"""Case B baseline preparation: EnMAP raw tiles -> 14-in-16 scene + tiles.

The port of tpukit/pipelines/baseline_b.py: host code over the port's own
``io`` copies, with two device steps on ``CaseBConfig.device`` (CUDA unless
the caller names the CPU): the k-LSB truncation and the scene error map's
band reductions. The matplotlib quicklooks are written where matplotlib is
installed and skipped with a warning elsewhere, as the PIL error maps are.

Pipeline equivalent of reference tools/make_baseline_B.py:
  1. parse product XML metadata: per-band wavelengths, bad-band flags and
     the QUALITY_TESTFLAGS bit map (:73-118)
  2. λ-uniform selection of 180 bands skipping bad bands (:122-160)
  3. mosaic the spectral subsets into an int16 scene; mosaic the
     quality-flag and pixel-mask products the same way (the reference
     shells out to gdalbuildvrt/gdal_translate — :485-508; tpukit mosaics
     natively from the tiles' geotransforms)
  4. final validity mask = ¬(cloud|shadow|cirrus|defect bits ∨
     pixelmask≠0 ∨ NoData) (:510-553)
  5. annotate lambda_nm band descriptions (:556-561)
  6. scene quicklooks: RGB / false-color via λ-nearest bands with joint
     percentile stretch, white balance and gamma (:198-247, :563-579)
  7. k-LSB truncation -> 14-in-16 (:281-316), on the device
  8. scene error map of 14-in-16 vs 16 in modes max|mean|rms|p95|count3
     (:324-419), computed as device band reductions
  9. crop LC/HC tiles + tile masks + tile RGB + per-tile ERRmax maps
     (:594-628) and write the index manifest
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpukit_torch.device import resolve_device
from tpukit_torch.io import tiff
from tpukit_torch.io.bitdepth import trunc_klsb
from tpukit_torch.io.manifest import write_manifest


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------

def parse_metadata(xml_path) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Dict[int, str]]:
    """Wavelengths, bad-band flags and quality-flag bit map from the product
    XML (reference :73-118 tolerant tag matching)."""
    try:
        root = ET.parse(str(xml_path)).getroot()
    except Exception:
        return None, None, {}
    lambdas, badband = [], []
    for band in root.iter():
        tag = band.tag.split("}")[-1].lower()
        if "band" in tag and list(band):
            lam = None
            bad = False
            for ch in band:
                k = ch.tag.split("}")[-1].lower()
                v = (ch.text or "").strip()
                if not v:
                    continue
                if "center" in k and "wavelength" in k:
                    try:
                        lam = float(v)
                    except ValueError:
                        pass
                if any(s in k for s in ("bad", "invalid", "artifact", "masked", "excluded")):
                    if v.lower() in ("1", "true", "yes"):
                        bad = True
            if lam is not None:
                lambdas.append(lam)
                badband.append(bad)
    bit_map: Dict[int, str] = {}
    for el in root.iter():
        tag = el.tag.split("}")[-1].lower()
        if ("flag" in tag or "bit" in tag) and (el.attrib or el.text):
            idx = (el.attrib.get("index") or el.attrib.get("bit")
                   or el.attrib.get("bit_index"))
            meaning = (el.attrib.get("meaning") or el.attrib.get("name")
                       or (el.text or "")).strip()
            if idx is not None and meaning:
                try:
                    bit_map[int(idx)] = meaning.lower()
                except ValueError:
                    pass
    return (np.array(lambdas, float) if lambdas else None,
            np.array(badband, bool) if badband else None,
            bit_map)


def pick_bands(count_common: int, lambdas: Optional[np.ndarray],
               badband: Optional[np.ndarray], target: int) -> List[int]:
    """λ-uniform band subset that skips flagged bands; 1-based indices.

    Parity contract with the reference's selector (make_baseline_B.py
    pick_180 :122-160): exactly ``target`` kept bands spread uniformly
    across the λ range, falling back to index-uniform spacing when no λ
    table is available. The selection itself is tpukit's own: a
    monotone nearest-λ assignment over the λ-sorted band axis with
    vectorized collision repair (the reference walks a greedy
    per-target scan with ad-hoc neighbor shifts that can come up short
    and backfill arbitrarily; the monotone assignment always yields
    ``target`` distinct bands and is order-optimal along λ)."""
    idx = np.arange(1, count_common + 1)
    keep = np.ones(count_common, bool)
    if badband is not None and badband.size >= count_common:
        keep &= ~badband[:count_common]
    idx = idx[keep]
    if lambdas is None or lambdas.size < count_common:
        if idx.size <= target:
            return idx.tolist()
        pos = np.round(np.linspace(0, idx.size - 1, target)).astype(int)
        return idx[pos].tolist()
    lam = np.asarray(lambdas, float)[:count_common][keep]
    if lam.size <= target:
        return idx.tolist()
    order = np.argsort(lam, kind="stable")
    lam_s, idx_s = lam[order], idx[order]
    # nearest λ-sorted slot per uniform grid point (ties to the lower λ)
    grid = np.linspace(lam_s[0], lam_s[-1], target)
    hi = np.clip(np.searchsorted(lam_s, grid), 0, lam_s.size - 1)
    lo = np.maximum(hi - 1, 0)
    near = np.where(np.abs(lam_s[lo] - grid) <= np.abs(lam_s[hi] - grid),
                    lo, hi)
    # collision repair: force strict increase from the left
    # (i_k = k + max_{j<=k}(near_j - j)), then clamp against the right
    # edge — both steps preserve monotonicity, so the result is always
    # `target` distinct slots
    k = np.arange(target)
    sel = k + np.maximum.accumulate(near - k)
    sel = np.minimum(sel, lam_s.size - target + k)
    return np.sort(idx_s[sel]).tolist()


def lambdas_from_descriptions(descs) -> Optional[np.ndarray]:
    if not descs:
        return None
    vals = []
    for d in descs:
        m = re.search(r"lambda_nm\s*=\s*([0-9.]+)", d or "")
        vals.append(float(m.group(1)) if m else np.nan)
    arr = np.array(vals, float)
    return arr if np.isfinite(arr).any() else None


def nearest_band(lams: np.ndarray, target_nm: float) -> int:
    return int(np.nanargmin(np.abs(lams - target_nm))) + 1


# ---------------------------------------------------------------------------
# Mosaic (replaces gdalbuildvrt + gdal_translate)
# ---------------------------------------------------------------------------

def mosaic(paths: Sequence[Path], band_indices: Optional[List[int]] = None,
           nodata=None):
    """Place georeferenced tiles on a common grid (north-up, uniform
    resolution) and return (cube, transform, nodata)."""
    infos = []
    for p in paths:
        with tiff.open(p) as ds:
            infos.append((Path(p), ds.transform, ds.width, ds.height,
                          ds.count, ds.dtypes[0], ds.nodata))
    px = infos[0][1][0]
    py = infos[0][1][4]
    x0 = min(i[1][2] for i in infos)
    y0 = max(i[1][5] for i in infos)
    x1 = max(i[1][2] + i[2] * px for i in infos)
    y1 = min(i[1][5] + i[3] * py for i in infos)
    W = int(round((x1 - x0) / px))
    H = int(round((y1 - y0) / py))
    nbands = len(band_indices) if band_indices else infos[0][4]
    dtype = np.dtype(infos[0][5])
    nd = nodata if nodata is not None else (infos[0][6] if infos[0][6] is not None else 0)
    out = np.full((nbands, H, W), nd, dtype=dtype)
    for p, tr, w, h, cnt, dt, ndv in infos:
        with tiff.open(p) as ds:
            data = ds.read(band_indices) if band_indices else ds.read()
        c0 = int(round((tr[2] - x0) / px))
        r0 = int(round((tr[5] - y0) / py))
        src_nd = ndv if ndv is not None else nodata
        if src_nd is None:
            out[:, r0:r0 + h, c0:c0 + w] = data
        else:
            # nodata-aware compositing, like the gdalbuildvrt path this
            # replaces: a later tile's fill pixels must not overwrite an
            # earlier tile's valid data in the overlap
            dst = out[:, r0:r0 + h, c0:c0 + w]
            valid = data != np.asarray(src_nd, data.dtype)
            np.copyto(dst, data, where=valid)
    transform = (px, 0.0, x0, 0.0, py, y0)
    return out, transform, nd


# ---------------------------------------------------------------------------
# Quicklooks (joint stretch + white balance + gamma)
# ---------------------------------------------------------------------------

def _wb_gains(channels, valid, estimator) -> np.ndarray:
    """Per-channel illuminant estimates under a NaN-aware estimator over
    the valid region (bands may hold NaN at their own nodata even where
    ``valid`` — built from another band — is True). Non-finite estimates
    (empty selection, all-NaN) fall back to 1.0 so the quicklook never
    goes black."""
    est = []
    for x in channels:
        sel = x[valid] if (valid is not None and valid.any()) else x
        v = estimator(sel) if sel.size else np.nan
        est.append(float(v) if np.isfinite(v) else 1.0)
    return np.asarray(est, np.float64)


def _wb_apply(channels, est: np.ndarray):
    """Scale every channel toward the common gray target (the mean of
    the per-channel estimates), clipped back into [0, 1]."""
    gains = est.mean() / (est + 1e-6)
    return tuple(np.clip(c * g, 0, 1) for c, g in zip(channels, gains))


def _wb_whitepatch(R, G, B, valid=None, q=98):
    """White-patch balance: equalize the channels' bright quantiles
    (same estimator family as the reference quicklook chain)."""
    est = _wb_gains((R, G, B), valid,
                    lambda s: np.nanpercentile(s, q))
    return _wb_apply((R, G, B), est)


def _wb_grayworld(R, G, B, valid=None):
    """Gray-world balance: equalize the channels' medians."""
    est = _wb_gains((R, G, B), valid, np.nanmedian)
    return _wb_apply((R, G, B), est)


def rgb_joint(cube: np.ndarray, bands_1based, nodata=None, valid=None,
              p=(1, 99), gamma=0.9, wb="whitepatch", sample=6) -> np.ndarray:
    """Joint-stretched RGB float image in [0,1] (reference rgb_joint
    :198-234: subsampled joint percentiles, WB, gamma)."""
    def f(b):
        x = cube[b - 1].astype(np.float32)
        if nodata is not None and np.isfinite(nodata):
            x = np.where(x == nodata, np.nan, x)
        return x
    R, G, B = (f(b) for b in bands_1based)
    Rs, Gs, Bs = (x[::sample, ::sample] for x in (R, G, B))
    if valid is not None:
        vs = valid[::sample, ::sample]
        sel = vs & np.isfinite(Rs) & np.isfinite(Gs) & np.isfinite(Bs)
    else:
        sel = np.isfinite(Rs) & np.isfinite(Gs) & np.isfinite(Bs)
    flat = np.concatenate([Rs[sel], Gs[sel], Bs[sel]]) if np.any(sel) else np.array([])
    lo, hi = (np.percentile(flat, p) if flat.size else (0.0, 1.0))
    rng = max(1e-6, hi - lo)
    R, G, B = ((np.clip((x - lo) / rng, 0, 1)) for x in (R, G, B))
    if wb == "whitepatch":
        R, G, B = _wb_whitepatch(R, G, B, valid)
    elif wb == "gray":
        R, G, B = _wb_grayworld(R, G, B, valid)
    if gamma != 1.0:
        R, G, B = (np.power(x, gamma) for x in (R, G, B))
    return np.dstack([np.nan_to_num(R), np.nan_to_num(G), np.nan_to_num(B)])


def save_png(img: np.ndarray, path, valid=None, overlay=False, title=""):
    """Matplotlib PNG with optional red invalid-overlay (reference :236-247).
    Without matplotlib the quicklook is skipped with a warning."""
    try:
        import matplotlib
    except ImportError:
        print(f"[WARN] quicklook {path} skipped: matplotlib is not "
              f"installed")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.figure(figsize=(10, 10))
    plt.imshow(img)
    if overlay and valid is not None:
        inv = ~valid
        ov = np.zeros((*inv.shape, 4), float)
        ov[inv, 0] = 1.0
        ov[inv, 3] = 0.25
        plt.imshow(ov)
    plt.axis("off")
    plt.title(title)
    plt.tight_layout()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(path, dpi=200)
    plt.close()


# ---------------------------------------------------------------------------
# Scene error maps (device reductions)
# ---------------------------------------------------------------------------

def scene_error_map(ref16: np.ndarray, cmp14: np.ndarray,
                    valid: Optional[np.ndarray], mode: str, k_bits: int,
                    err_scale: str = "fixed",
                    device="cuda") -> Tuple[np.ndarray, int]:
    """Per-pixel band-aggregated |Δ| map scaled to uint8
    (reference make_scene_error_map :324-419, modes max|mean|rms|p95|count3).
    The band reductions run on ``device``, in tpukit's float32 arithmetic:
    integer sums are exact, and the float32 division, square root and
    0.95 product round the same way on every device."""
    dev = resolve_device(device)
    a = torch.from_numpy(np.ascontiguousarray(ref16)).to(dev).to(torch.int32)
    c = torch.from_numpy(np.ascontiguousarray(cmp14)).to(dev).to(torch.int32)
    d = (a - c).abs()
    if valid is not None:
        d = torch.where(torch.from_numpy(np.asarray(valid, bool))
                        .to(dev)[None], d, 0)
    kmax = (1 << k_bits) - 1
    B = d.shape[0]
    # a divisor on the device: CUDA divides by a host scalar through its
    # reciprocal, which is not the correctly rounded quotient
    nb = torch.tensor(float(B), dtype=torch.float32, device=dev)
    if mode == "mean":
        out = d.sum(0).to(torch.float32) / nb
    elif mode == "rms":
        out = torch.sqrt((d * d).to(torch.float32).sum(0) / nb)
    elif mode == "count3":
        out = (d == kmax).sum(0).to(torch.float32)
    elif mode == "max":
        out = d.amax(0).to(torch.float32)
    elif mode == "p95":
        dc = d.clamp(0, kmax)
        cnt = torch.stack([(dc == k).sum(0) for k in range(kmax + 1)])
        cdf = cnt.cumsum(0)
        f95 = torch.tensor(0.95, dtype=torch.float32, device=dev)
        thr = (cdf[-1].to(torch.float32) * f95).to(torch.int64)
        hit = cdf >= thr[None]
        # the first k that hits (tpukit takes the argmax of the hits, which
        # returns the first): the cdf is non-decreasing in k, so the hits
        # are a suffix and the misses before it count the index
        out = (~hit).sum(0).to(torch.float32)
    else:
        raise ValueError(f"bad err mode {mode}")
    out = out.cpu().numpy()
    if mode == "count3":
        emax = max(1, B) if err_scale == "fixed" else max(1, int(out.max()))
    else:
        emax = kmax if err_scale == "fixed" else max(1, int(np.ceil(out.max())))
    u8 = (np.clip(out, 0, emax) * (255.0 / emax) + 0.5).astype(np.uint8)
    return u8, emax


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

@dataclass
class CaseBConfig:
    input_raw: Path                       # folder of raw tiles
    output: Path
    dt: str                               # datatake id filter
    target_bands: int = 180
    tile_size: int = 512
    lc: tuple = (580, 5620)               # col, row (reference :430)
    hc: tuple = (2000, 1536)              # reference :431
    stretch: tuple = (1.0, 99.0)
    gamma: float = 0.9
    wb: str = "whitepatch"
    rgb_nm: tuple = (665.0, 560.0, 490.0)
    false_nm: tuple = (842.0, 665.0, 560.0)
    k: int = 2                            # LSBs to zero (14-in-16)
    err_mode: str = "mean"
    err_scale: str = "fixed"
    quicklooks: bool = True
    device: str = "cuda"                  # truncation and error maps
    spectral_glob: str = "*{dt}*SPECTRAL_IMAGE*.TIF"
    flags_sub: tuple = ("SPECTRAL_IMAGE", "QL_QUALITY_TESTFLAGS")
    pixm_sub: tuple = ("SPECTRAL_IMAGE", "QL_PIXELMASK")
    metadata_glob: str = "*{dt}*METADATA*"


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", str(s))]


def _find(input_dir: Path, pattern: str):
    return sorted(input_dir.glob(pattern), key=lambda p: _natural_key(p.name))


def find_bit(substrs, bit_map: Dict[int, str]) -> Optional[int]:
    """First bit whose meaning contains all substrings — deliberately the
    reference's exact heuristic incl. its quirks (e.g. 'cloud' can bind a
    'cloud shadow' bit when that one enumerates first; both bits are
    queried separately so the union mask is unaffected in practice).
    Reference make_baseline_B.py:518-523."""
    for b, name in bit_map.items():
        if all(ss in name for ss in substrs):
            return b
    return None


def run(cfg: CaseBConfig) -> dict:
    dev = resolve_device(cfg.device)      # an absent card raises first
    input_dir = Path(cfg.input_raw)
    out_dir = Path(cfg.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    dt = cfg.dt

    spectral = _find(input_dir, cfg.spectral_glob.format(dt=dt))
    if not spectral:
        raise FileNotFoundError(f"No spectral tiles for {dt} in {input_dir}")

    counts = []
    for p in spectral:
        with tiff.open(p) as ds:
            counts.append(ds.count)
    min_count = min(counts)

    metas = _find(input_dir, cfg.metadata_glob.format(dt=dt))
    lambdas = badband = None
    bit_map: Dict[int, str] = {}
    if metas:
        lambdas, badband, bit_map = parse_metadata(metas[0])
    idx_list = pick_bands(min_count, lambdas, badband, cfg.target_bands)

    # spectral scene mosaic (subset to the selected bands on the fly)
    cube, transform, nodata = mosaic(spectral, idx_list)
    B, H, W = cube.shape
    scene16 = out_dir / f"{dt}_scene_180b_int16.tif"

    # companion mosaics
    def companions(subs):
        out = []
        missing = []
        for p in spectral:
            cand = p.with_name(p.name.replace(subs[0], subs[1]))
            (out if cand.exists() else missing).append(cand)
        if out and missing:
            # a partial companion set would leave silent holes in the
            # validity mask (flag value 0 == "all clear"); the reference
            # opens these paths unconditionally and would raise too
            raise FileNotFoundError(
                f"missing {len(missing)} companion file(s), e.g. "
                f"{missing[0]}")
        return out

    invalid = np.zeros((H, W), bool)
    if nodata is not None:
        invalid |= (cube[0] == nodata)
    used_bits = {}
    flags_tiles = companions(cfg.flags_sub)
    if flags_tiles and bit_map:
        fl, _, _ = mosaic(flags_tiles)
        fl = fl[0].astype(np.uint32)
        for name, subs in (("cloud", ["cloud"]), ("shadow", ["shadow"]),
                           ("cirrus", ["cirrus"]), ("defect", ["defect"])):
            b = find_bit(subs, bit_map)
            if b is not None:
                invalid |= (fl & (1 << b)) != 0
                used_bits[name] = b
    pixm_tiles = companions(cfg.pixm_sub)
    if pixm_tiles:
        pm, _, _ = mosaic(pixm_tiles)
        invalid |= (pm[0] != 0)
    valid = ~invalid

    mask_final = out_dir / f"{dt}_scene_mask_uint8.tif"
    tiff.write_geotiff(mask_final, valid.astype(np.uint8), nodata=0,
                       transform=transform, blockxsize=512, blockysize=512)

    # λ annotations
    descriptions = None
    if lambdas is not None:
        descriptions = [f"lambda_nm={lambdas[i-1]:.2f}"
                        if i - 1 < len(lambdas) else None for i in idx_list]
    tiff.write_geotiff(scene16, cube, nodata=nodata, transform=transform,
                       descriptions=descriptions, blockxsize=512,
                       blockysize=512, bigtiff="IF_SAFER")

    lams = (lambdas_from_descriptions(descriptions)
            if descriptions else None)
    if lams is None and lambdas is not None and len(lambdas) >= max(idx_list):
        lams = lambdas[np.array(idx_list) - 1]

    artifacts = {"scene16": scene16, "mask": mask_final, "used_bits": used_bits}

    if cfg.quicklooks and lams is not None and np.isfinite(lams).any():
        bands_rgb = tuple(nearest_band(lams, nm) for nm in cfg.rgb_nm)
        bands_false = tuple(nearest_band(lams, nm) for nm in cfg.false_nm)
        RGB = rgb_joint(cube, bands_rgb, nodata, valid, cfg.stretch,
                        cfg.gamma, cfg.wb)
        FALSE = rgb_joint(cube, bands_false, nodata, valid, cfg.stretch,
                          cfg.gamma, cfg.wb)
        save_png(RGB, out_dir / f"{dt}_quicklook_rgb.png", valid, False, "RGB (λ)")
        save_png(RGB, out_dir / f"{dt}_quicklook_rgb_overlay.png", valid, True, "RGB (λ)")
        save_png(FALSE, out_dir / f"{dt}_quicklook_false.png", valid, False,
                 "False Color (λ)")

    # 14-in-16 truncation on the device (k <= 0 is the identity)
    scene14_path = out_dir / f"{dt}_scene_180b_14in16.tif"
    cube14 = trunc_klsb(torch.from_numpy(cube).to(dev), cfg.k)
    cube14 = cube14.cpu().numpy() if cfg.k > 0 else cube
    if nodata is not None:
        cube14 = np.where(cube == nodata, cube, cube14)
    tiff.write_geotiff(scene14_path, cube14, nodata=nodata, transform=transform,
                       descriptions=descriptions, blockxsize=512,
                       blockysize=512, bigtiff="IF_SAFER")

    # scene error map
    err_png = scene14_path.with_suffix(f".scene_ERR_{cfg.err_mode}.png")
    u8, emax = scene_error_map(cube, cube14, valid, cfg.err_mode, cfg.k,
                               cfg.err_scale, dev)
    try:
        from PIL import Image
        Image.fromarray(u8).save(err_png)
        artifacts["scene_err"] = err_png
    except Exception as e:
        # warn-and-continue policy (§5.3): quicklook artifacts are
        # non-fatal, but a silent miss hides disk/permission errors
        print(f"[WARN] scene error-map PNG failed: {e}")

    # tiles
    items = []
    sz = cfg.tile_size
    for tid, (cx, ry) in (("LC", cfg.lc), ("HC", cfg.hc)):
        tpath = out_dir / f"{dt}_tile_{tid}_{sz}_14in16bit.tif"
        mpath = out_dir / f"{dt}_tile_{tid}_{sz}_mask.tif"
        if not (0 <= cx <= W - sz and 0 <= ry <= H - sz):
            raise ValueError(f"tile {tid} offset out of bounds")
        win_tr = tiff.window_transform(tiff.Window(cx, ry, sz, sz), transform)
        tiff.write_geotiff(tpath, cube14[:, ry:ry + sz, cx:cx + sz],
                           nodata=nodata, transform=win_tr,
                           descriptions=descriptions,
                           blockxsize=512, blockysize=512)
        tiff.write_geotiff(mpath, valid[ry:ry + sz, cx:cx + sz].astype(np.uint8),
                           nodata=0, transform=win_tr,
                           blockxsize=512, blockysize=512)
        if cfg.quicklooks and lams is not None and np.isfinite(lams).any():
            vt = valid[ry:ry + sz, cx:cx + sz]
            imgT = rgb_joint(cube14[:, ry:ry + sz, cx:cx + sz],
                             tuple(nearest_band(lams, nm) for nm in cfg.rgb_nm),
                             nodata, vt, cfg.stretch, cfg.gamma, cfg.wb)
            save_png(imgT, tpath.with_suffix(".RGB8.png"), vt, False, "Tile RGB (λ)")
            u8t, emt = scene_error_map(cube[:, ry:ry + sz, cx:cx + sz],
                                       cube14[:, ry:ry + sz, cx:cx + sz],
                                       vt, "max", cfg.k, cfg.err_scale, dev)
            try:
                from PIL import Image
                Image.fromarray(u8t).save(
                    tpath.with_suffix(".ERRmax_vs16.png"))
            except Exception as e:
                print(f"[WARN] tile error-map PNG failed: {e}")
        items.append({"tile_id": tid, "path": tpath, "mask": mpath})

    index = out_dir / "index_caseB.json"
    write_manifest(index, "caseB", f"tile_{sz}", items)
    artifacts.update({"scene14": scene14_path, "index": index, "items": items})
    return artifacts
