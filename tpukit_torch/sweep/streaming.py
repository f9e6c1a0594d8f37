# -*- coding: utf-8 -*-
"""Scene-scale strip streaming for the sweep runner: the port of
tpukit/sweep/streaming.py.

The batched runner (``runner.run_sweep``) uploads each tile cube to the
device once — right for 1024²/512² tiles, impossible in host memory for
full scenes (an EnMAP scene is ~180×2000×10000 int16 ≈ 7 GB; the reference
streams scenes in two-pass 512-row windows, reference
tools/make_baseline_B.py:324-419, and its codec wrappers window scenes into
512² tiles, ccsds121_wrap.py:170-219).

This module runs one sweep item in bounded host memory:

  * the source is read in row strips (windowed chunk decode — only the
    touched TIFF chunks are ever decompressed, tiff.Dataset.read);
  * each strip is uploaded ONCE to the sweep's device; that tensor serves
    the metric lanes and is handed to the codec as ``device_cube``, so
    CCSDS-123 strips run on the device and CCSDS-121 strips take the device
    encode plan (kernel K1 on CUDA), with a FRESH ``device_plan_cache`` per
    strip (the CCSDS-121 cache keys are tile geometry only, valid within
    one cube, wrong across strips);
  * the codec runs per strip; strip heights align to the codec's internal
    tile grid, so for the tiled lossless codecs (CCSDS-121/123 —
    ``strip_exact``) the concatenated bitstream is byte-identical to the
    whole-image run;
  * reconstructions stream to disk through ``tiff.StripWriter`` (O(strip)
    host memory) and bitstreams flush per strip; a recon the codec left on
    the device goes to the metric lane as it is, and to the host only for
    the writer and the quicklooks;
  * metrics accumulate as per-strip device stats merged exactly on the host
    (metrics.quality.merge_quality_stats — CGL moment combination;
    metrics.spectral.merge_spectral_stats with 1-row halos so the Sobel in
    LMSE sees whole-image neighbourhoods).

Quicklooks stream too (same artifact contract as the batched path,
reference run_codec.py:511-520): the 8-bit maps are tiny next to the cube,
so ERR8 planes and recon validity accumulate per strip (bit-exact to the
batched renderer — integer compares + the fixed-cap LUT), the percentile
stretch comes from exact per-channel histograms built during the pass
(float64 interpolation of integer order statistics — the one deliberate
deviation from np.percentile's float32 path), and RGB8 renders in a second
windowed pass over just the 3 RGB bands.

With a device mesh (``--mesh``; tpukit streaming.py:374-385, :432-437)
the metric lanes go round-robin to the mesh's positions, each lane to one
position for all its strips, and every position that holds a lane gets its
own copy of each strip; a lane's programs are the same as without a mesh,
so the rows and artifacts are too. The codec's strip work stays as it is
without a mesh (one upload, a fresh plan cache per strip): like tpukit
(:531-538), the mesh is not handed to the codec.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from tpukit_torch.codecs.base import RateSpec
from tpukit_torch.device import resolve_device
from tpukit_torch.io import tiff
from tpukit_torch.io.bitdepth import RangeScan
from tpukit_torch.io.manifest import guess_mask_path
from tpukit_torch.metrics.quality import (assemble_quality,
                                          merge_quality_stats,
                                          quality_stats_dual)
from tpukit_torch.metrics.spectral import (merge_spectral_stats,
                                           spectral_stats_strip)
from tpukit_torch.sweep.proc import MemorySampler
from tpukit_torch.viz import quicklooks as ql


def log(s: str):
    print(s, flush=True, file=sys.stderr)


def stream_plan(codec, H: int, W: int, B: int, itemsize: int,
                stream_rows: Optional[int],
                auto_bytes: int) -> Optional[int]:
    """Rows per strip, or None when the item should run whole-cube.

    Explicit ``stream_rows`` forces streaming (aligned up to the codec's
    tile grid); otherwise streaming turns on automatically when the cube
    exceeds ``auto_bytes`` and the codec is strip-exact."""
    cube_bytes = H * W * B * itemsize
    if stream_rows is None and cube_bytes <= auto_bytes:
        return None
    if not getattr(codec, "strip_exact", False):
        if stream_rows is not None:
            log(f"[WARN] --stream-rows ignored: codec "
                f"{getattr(codec, 'name', '?')} is not strip-exact "
                f"(whole-image transform); running whole-cube")
        return None
    tile = int(getattr(codec, "tile", 512) or 512)
    rows = int(stream_rows) if stream_rows else 1024
    rows = max(tile, (rows + tile - 1) // tile * tile)
    if rows >= H:
        return None
    return rows


class _LaneAcc:
    """Per-metric-lane accumulator across strips. The stats stay device
    tensors until the lane is merged; the pending strip and the halo rows
    are device tensors too."""

    def __init__(self):
        self.q_masked: List[dict] = []
        self.q_ones: List[dict] = []
        self.s_parts: List[dict] = []
        # deferred spectral pipeline (needs the next strip's first recon row)
        self.pend: Optional[dict] = None
        self.tail_ref: Optional[torch.Tensor] = None   # (B,1,W) prev last row
        self.tail_rec: Optional[torch.Tensor] = None


# target sample count per spectral launch: bounds the f32 working set to
# ~8M samples x a few temporaries regardless of band count or scene width
_SPECTRAL_CHUNK_SAMPLES = 8 << 20


def _host(parts: List[dict]) -> List[dict]:
    """Per-strip device stats to host arrays for the float64 merge."""
    return [{k: v.cpu().numpy() for k, v in p.items()} for p in parts]


def _spectral_flush(acc: _LaneAcc, bot_ref: Optional[torch.Tensor],
                    bot_rec: Optional[torch.Tensor]):
    """Run the deferred strip's spectral stats once its bottom halo row is
    known (None at the last strip: true image edge, Sobel edge-pads).
    Wide/many-band strips split into column chunks with 1-px halos so each
    launch stays small (same merged sums — SAM/SID are per-pixel and the
    Sobel halo makes LMSE chunk-exact)."""
    p = acc.pend
    if p is None:
        return
    top = 0 if p["top_ref"] is None else 1
    bot = 0 if bot_ref is None else 1
    ref_parts = ([p["top_ref"]] if top else []) + [p["ref"]] + \
        ([bot_ref] if bot else [])
    rec_parts = ([p["top_rec"]] if top else []) + [p["rec"]] + \
        ([bot_rec] if bot else [])
    ref_h = torch.cat(ref_parts, 1)
    rec_h = torch.cat(rec_parts, 1)
    B, Hh, W = ref_h.shape
    wc = max(64, _SPECTRAL_CHUNK_SAMPLES // max(B * Hh, 1))
    for x0 in range(0, W, wc):
        cols = min(wc, W - x0)
        left = 1 if x0 > 0 else 0
        right = 1 if x0 + cols < W else 0
        sl = slice(x0 - left, x0 + cols + right)
        acc.s_parts.append(spectral_stats_strip(
            ref_h[:, :, sl], rec_h[:, :, sl], p["vm"][:, x0:x0 + cols],
            top, bot, left, right))
    acc.tail_ref = p["ref"][:, -1:].clone()
    acc.tail_rec = p["rec"][:, -1:].clone()
    acc.pend = None


def _u8_mean_std(a: np.ndarray, chunk: int = 1 << 20):
    """``a.mean()`` and ``a.std()`` of a C-contiguous uint8 map, bit for
    bit, without numpy's full-size float64 temporaries (two of 8 bytes a
    pixel). The mean is the exact integer sum over the count. numpy sums
    the float64 squared deviations in blocks of its buffer size, each
    block pairwise, adding the block sums in order: the same blocks,
    taken a chunk at a time, give the same sum."""
    flat = a.reshape(-1)
    n = flat.size
    mean = int(flat.sum(dtype=np.int64)) / n
    blk = np.getbufsize()
    step = max(blk, chunk - chunk % blk)
    total = 0.0
    for s in range(0, n, step):
        x = flat[s:s + step].astype(np.float64)
        x -= mean
        x *= x
        for b in range(0, x.size, blk):
            total += np.add.reduce(x[b:b + blk])
    return mean, math.sqrt(total / n)


def _write_err_tif(path, err8: np.ndarray, valid: np.ndarray, geo):
    """viz.quicklooks._write_err_tif, with the map's statistics taken by
    ``_u8_mean_std``: the same file."""
    mean, std = _u8_mean_std(err8)
    tags = {"STATISTICS_MINIMUM": "0", "STATISTICS_MAXIMUM": "255",
            "STATISTICS_MEAN": str(float(mean)),
            "STATISTICS_STDDEV": str(float(std)),
            "PIXEL_MINIMUM": "0", "PIXEL_MAXIMUM": "255"}
    return tiff.write_geotiff(
        Path(path), err8, compress="DEFLATE", blockxsize=512, blockysize=512,
        geo=geo, mask=valid, tags=tags)


class _StreamQuicklooks:
    """Streamed-scene quicklooks (reference run_codec.py:511-520 artifact
    contract).

    The batched runner renders quicklooks from whole in-RAM cubes; a
    streamed scene only ever holds strips. The 8-BIT artifacts are tiny
    next to the cube (uint8 planes vs a 180-band int16 scene), so this
    helper accumulates them instead:

      * per-lane ERR8 maps at the fixed caps — ``lut[max|Δ|]`` per strip
        (max|Δ| and the recon validity reduced over the bands on the
        device), bit-identical to the batched renderer (integer compares +
        the same viz.quicklooks LUT and writer);
      * per-lane validity of the ERR8 maps (source and recon valid); for
        RGB8 also the recon validity (rec_ok) and the dataset mask;
      * exact per-channel HISTOGRAMS of the baseline RGB bands over
        valid pixels (65536 bins) for the percentile stretch. Percentiles
        interpolate the exact integer order statistics in float64 — the
        one place streamed output may differ from the batched
        np.percentile(float32) path in the last bit ("identical modulo
        stretch pass").

    ``finalize`` then renders RGB8 in a second windowed pass over just
    the 3 RGB bands (baseline from the source, recon from the
    already-written recon.tif) and writes every file through the same
    viz.quicklooks writers the batched artifact phase uses, hardlinking
    replicas into the lane's other rep dirs."""

    # uint8-plane budget; above this the helper disables itself (a sweep
    # with hundreds of rate lanes should not hold hundreds of scene maps)
    MAX_BYTES = 2 << 30

    def __init__(self, H: int, W: int, caps: List[int], want_rgb: bool,
                 rgb_order: List[int], signed: bool, n_lanes: int):
        self.H, self.W = H, W
        self.caps = list(caps)
        self.want_rgb = want_rgb
        self.rgb_order = list(rgb_order)
        self.off = 32768 if signed else 0
        need = (len(caps) + 1) * H * W * max(n_lanes, 1) + 2 * H * W
        self.enabled = need <= self.MAX_BYTES
        if not self.enabled:
            log(f"[NOTE] streamed quicklooks disabled: {n_lanes} lanes x "
                f"{len(caps)} caps would buffer {need >> 20} MiB of maps")
            return
        self.lut = torch.from_numpy(np.stack([ql.err8_lut(c) for c in caps]))
        self.src_mask = np.zeros((H, W), np.uint8) if want_rgb else None
        self.hist = (np.zeros((3, 65536), np.int64) if want_rgb else None)
        self.lanes: Dict[object, dict] = {}

    def src_strip(self, y0: int, block: np.ndarray,
                  src_mask_w: np.ndarray, nodata, has_nodata: bool):
        if not self.want_rgb or not self.enabled:
            return
        rows = block.shape[1]
        sv = src_mask_w > 0
        if has_nodata:
            sv = sv & (block[0] != nodata)
        self.src_mask[y0:y0 + rows] = src_mask_w
        for c, b in enumerate(self.rgb_order):
            vals = block[b - 1][sv].astype(np.int64) + self.off
            if vals.size:
                self.hist[c] += np.bincount(vals, minlength=65536)

    def lane_strip(self, key, y0: int, block: np.ndarray,
                   block_dev: torch.Tensor, rec_dev: torch.Tensor,
                   src_mask_w: np.ndarray, nodata, has_nodata: bool):
        """One (lane, strip) contribution. Source validity is computed
        strip-locally: a lane may accumulate in an earlier rep than the one
        that fills the source planes. The band
        reductions (recon validity, max|Δ|) run on the strip's device
        tensors, and so does the LUT, so the host holds (rows, W) uint8
        planes, not a (B, rows, W) int32 difference; they are integer, so
        the maps are tpukit's."""
        if not self.enabled:
            return
        lane = self.lanes.get(key)
        if lane is None:
            lane = self.lanes[key] = {
                "e8": np.zeros((len(self.caps), self.H, self.W), np.uint8),
                "valid": np.zeros((self.H, self.W), bool),
                "rec_ok": (np.zeros((self.H, self.W), bool)
                           if self.want_rgb else None)}
        rows = block.shape[1]
        dev = block_dev.device
        sv = src_mask_w > 0
        if has_nodata:
            sv = sv & (block[0] != nodata)
        v = torch.from_numpy(sv).to(dev)
        rec_ok = (rec_dev != nodata).all(0) if has_nodata else None
        if rec_ok is not None:
            v = v & rec_ok
        lane["valid"][y0:y0 + rows] = v.cpu().numpy()
        if lane["rec_ok"] is not None:
            lane["rec_ok"][y0:y0 + rows] = (
                True if rec_ok is None else rec_ok.cpu().numpy())
        err = (rec_dev.to(torch.int32) - block_dev.to(torch.int32)).abs() \
            .amax(0)
        err = torch.where(v, err, 0).clamp(0, self.lut.shape[1] - 1).long()
        lane["e8"][:, y0:y0 + rows] = self.lut.to(dev)[:, err].cpu().numpy()

    def _stretch_params(self) -> List:
        """(lo, hi) per channel from the exact histograms — same pct=(2,98)
        and degenerate-range rules as quicklooks.stretch_params_from_arrays."""
        params = []
        for c in range(3):
            h = self.hist[c]
            n = int(h.sum())
            if n == 0:
                params.append((0.0, 1.0))
                continue
            cum = np.cumsum(h)

            def order_stat(k):
                return int(np.searchsorted(cum, k + 1)) - self.off

            vals = []
            for p in (2.0, 98.0):
                r = (n - 1) * (p / 100.0)
                k = int(np.floor(r))
                a = order_stat(k)
                b = order_stat(min(k + 1, n - 1))
                vals.append(a + (b - a) * (r - k))
            lo, hi = vals
            if hi <= lo:
                hi = lo + 1.0
            params.append((float(lo), float(hi)))
        return params

    def finalize(self, ds: tiff.Dataset, lane_dirs: Dict[object, List],
                 lane_src: Dict[object, Optional[Path]], geo,
                 rows_blk: int):
        """Write ERR8 + RGB8 for every lane and hardlink replicas.

        ``lane_dirs``: lane key -> ordered run_dirs sharing the lane;
        ``lane_src``: lane key -> recon.tif to re-read RGB bands from."""
        if not self.enabled or not self.lanes:
            return
        H, W = self.H, self.W
        params = self._stretch_params() if self.hist is not None else None
        base_rgb8 = None
        if params is not None:
            base_rgb8 = np.empty((3, H, W), np.uint8)
            for y0 in range(0, H, rows_blk):
                win = tiff.Window(col_off=0, row_off=y0, width=W,
                                  height=min(rows_blk, H - y0))
                bands = ds.read(self.rgb_order, window=win)
                base_rgb8[:, y0:y0 + win.height] = \
                    ql.rgb8_from_arrays(bands, params)

        for key, lane in self.lanes.items():
            dirs = lane_dirs.get(key) or []
            if not dirs:
                continue
            v = lane["valid"]

            def lane_emit(name, render, _dirs=dirs):
                """Render into the lane's first run_dir, hardlink the
                replicas (deterministic content across reps — same policy
                as the batched artifact phase)."""
                src = None
                for d in _dirs:
                    d.mkdir(parents=True, exist_ok=True)
                    dst = d / name
                    if src is None:
                        src = render(dst)
                        continue
                    dst.unlink(missing_ok=True)
                    try:
                        os.link(src, dst)
                    except OSError:
                        shutil.copyfile(src, dst)

            for cap, e8 in zip(self.caps, lane["e8"]):
                lane_emit(f"recon_ERR8_0_{int(cap)}.tif",
                          lambda p, _e8=e8: _write_err_tif(p, _e8, v, geo))
            if params is not None:
                lane_emit("baseline_RGB8.tif",
                          lambda p: tiff.write_geotiff(
                              p, base_rgb8, photometric="RGB",
                              compress="DEFLATE", blockxsize=512,
                              blockysize=512, geo=geo,
                              mask=self.src_mask))
                src_tif = lane_src.get(key)
                if src_tif is not None and Path(src_tif).exists():
                    rec_rgb8 = np.empty((3, H, W), np.uint8)
                    with tiff.open(src_tif) as rds:
                        for y0 in range(0, H, rows_blk):
                            win = tiff.Window(
                                col_off=0, row_off=y0, width=W,
                                height=min(rows_blk, H - y0))
                            bands = rds.read(self.rgb_order, window=win)
                            rec_rgb8[:, y0:y0 + win.height] = \
                                ql.rgb8_from_arrays(bands, params)
                    rec_mask = lane["rec_ok"].astype(np.uint8) * 255
                    lane_emit("recon_RGB8.tif",
                              lambda p: tiff.write_geotiff(
                                  p, rec_rgb8, photometric="RGB",
                                  compress="DEFLATE", blockxsize=512,
                                  blockysize=512, geo=geo,
                                  mask=rec_mask))


def sweep_item_streaming(cfg, ds: tiff.Dataset, item: dict, rates: List,
                         rk: Optional[str], is_caseb: bool, link,
                         rows_blk: int, case_name=None, asset_name=None,
                         device=None, mesh=None) -> List[dict]:
    """Run one index item through the strip-streaming path on ``device``
    (``cfg.device`` when None), its metric lanes on ``mesh``'s positions
    when one is given (built from ``cfg.mesh`` when None); returns the CSV
    rows (same schema as the batched path, reference
    run_codec.py:568-585)."""
    from tpukit_torch.sweep.runner import (_build_mesh, _pick_rgb_order,
                                           build_csv_row, hbm_peak_bytes,
                                           rate_slug, resume_recon)

    device = resolve_device(cfg.device if device is None else device)
    if mesh is None and cfg.mesh:
        mesh = _build_mesh(cfg.mesh, device)

    outdir = Path(cfg.outdir).resolve()
    tile_id = item["tile_id"]
    W, H, B = ds.width, ds.height, ds.count
    dtype_name = ds.dtypes[0]
    nodata = ds.nodata
    geo = ds.geo
    has_nodata = nodata is not None and math.isfinite(nodata)
    bytes_per_sample = 2 if dtype_name in ("uint16", "int16") else 1
    container_bytes = int(W * H * B * bytes_per_sample)
    raw16_bytes = int(W * H * B * 16 // 8)

    mask_path = item.get("mask") or guess_mask_path(item["path"])
    mask_ds = None
    if mask_path and Path(mask_path).exists():
        try:
            mask_ds = tiff.open(mask_path)
            if (mask_ds.height, mask_ds.width) != (H, W):
                log(f"[WARN] Mask {mask_path} shape mismatch; ignored.")
                mask_ds.close()
                mask_ds = None
        except Exception:
            log(f"[WARN] Failed to read mask {mask_path}; ignored.")
            mask_ds = None

    strips = []
    y0 = 0
    while y0 < H:
        strips.append((y0, min(rows_blk, H - y0)))
        y0 += rows_blk

    # lane plan. Honest reps (default): each fresh (rate, rep) gets its
    # own metric lane, accumulated during its own rep's pass (reference
    # run_codec.py:522-529 computes metrics per rep). --dedupe-reps:
    # fresh lanes shared across reps (deterministic codecs). Resumed
    # (ri, rep) recons always get their own lanes, read windowed from
    # disk. Quicklook artifacts stay grouped by CONTENT (per rate) in
    # both modes — identical bytes, replica writes.
    dedupe = bool(cfg.dedupe_reps)
    jobs: Dict[tuple, dict] = {}
    lanes: Dict[object, dict] = {}
    for rep in range(cfg.reps):
        for ri, r in enumerate(rates):
            run_dir = outdir / tile_id / rate_slug(rk, r) / f"rep_{rep+1:02d}"
            recon_path = run_dir / "recon.tif"
            # shared validated probe (runner.resume_recon): an interrupted
            # writer's leftover must re-encode, not wedge every retry
            reused, _, bs = resume_recon(run_dir, cfg.write_artifacts, log)
            ckey = ("reused", ri, rep) if reused else ("fresh", ri)
            key = (ckey if (reused or dedupe)
                   else ("fresh", ri, rep))
            job = {"ri": ri, "rep": rep, "run_dir": run_dir,
                   "reused": reused, "meta": {}, "t_wrap": 0.0,
                   "bs_bytes": bs, "lane": key, "ckey": ckey}
            if key not in lanes:
                lanes[key] = {"acc": _LaneAcc(),
                              "src": (recon_path if reused else None)}
            jobs[(ri, rep)] = job
    # the stable lane -> position map (mesh mode): every strip of a lane
    # runs on one position
    lane_pos: Dict[object, object] = {}
    if mesh is not None:
        positions = mesh.positions()
        for i, key in enumerate(sorted(lanes)):
            lane_pos[key] = positions[i % len(positions)]

    # streamed quicklooks (same artifact contract as the batched phase)
    sql = None
    if cfg.write_artifacts and cfg.quicklooks:
        caps = [int(cfg.ql_err_global)]
        if cfg.ql_err_zoom is not None:
            caps.append(int(cfg.ql_err_zoom))
        want_rgb = bool(cfg.ql_rgb) and B >= 3
        if caps or want_rgb:
            sql = _StreamQuicklooks(
                H, W, caps, want_rgb,
                _pick_rgb_order(ds, str(case_name).lower()),
                signed=(dtype_name == "int16"),
                n_lanes=len({j["ckey"] for j in jobs.values()}))

    fresh_ri = sorted({job["ri"] for job in jobs.values()
                       if not job["reused"]})
    # last rep in which each rate runs fresh: that run feeds the rate's
    # shared metric lane (recons are rep-invariant for these codecs)
    metric_rep_ri = {ri: max(rep for rep in range(cfg.reps)
                             if not jobs[(ri, rep)]["reused"])
                     for ri in fresh_ri}
    rscan = RangeScan(dtype_name)

    # TIFF strips must tile the codec's write blocks
    strip_rps = min(512, rows_blk)
    if rows_blk % strip_rps:
        t = int(getattr(cfg.codec, "tile", 0) or 0)
        strip_rps = t if t and rows_blk % t == 0 else rows_blk

    # per-rep codec execution (timing fidelity: the codec re-runs per rep,
    # reference run_codec.py:472-495); metrics accumulate on one pass — the
    # last rep that runs the codec (or the last rep if everything resumed)
    per_ri_meta: Dict[int, dict] = {}
    descriptions = ds.descriptions
    mask_passthrough = getattr(cfg.codec, "mask_passthrough", False)
    fresh_reps = [rep for rep in range(cfg.reps)
                  if any(not jobs[(ri, rep)]["reused"] for ri in fresh_ri)]
    metric_rep = fresh_reps[-1] if fresh_reps else cfg.reps - 1

    for rep in range(cfg.reps):
        # only the rates whose job is fresh in THIS rep run the codec (a
        # rate resumed for this rep must not be re-encoded into its reused
        # run_dir)
        rep_ri = [ri for ri in fresh_ri if not jobs[(ri, rep)]["reused"]]
        rep_specs = [RateSpec.of(rk, rates[ri]) for ri in rep_ri]
        rep_jobs = [jobs[(ri, rep)] for ri in rep_ri]
        if not rep_jobs and rep != metric_rep:
            continue
        is_metric_rep = rep == metric_rep
        # masks go to the device when the resumed lanes accumulate
        # (metric_rep), any fresh rate's shared metric lane fills in this
        # rep (--dedupe-reps), or — honest reps — any fresh job runs
        needs_metrics = is_metric_rep or any(
            metric_rep_ri[ri] == rep for ri in rep_ri) or \
            (not dedupe and bool(rep_ri))
        writers: Dict[int, tiff.StripWriter] = {}
        # a fresh (re-)encode owns its bit/ dir: clear strip files left
        # by an interrupted earlier run (possibly on a different strip
        # grid) so the dir stays a valid stream concatenation and
        # resume's recursive byte sum stays exact — also when THIS run
        # keeps no bitstreams (stale bit/ next to a fresh recon would
        # corrupt a later resume's byte sum)
        for job in rep_jobs:
            shutil.rmtree(job["run_dir"] / "bit", ignore_errors=True)
        if cfg.write_artifacts:
            for job in rep_jobs:
                job["run_dir"].mkdir(parents=True, exist_ok=True)
                writers[job["ri"]] = tiff.StripWriter(
                    job["run_dir"] / "recon.tif", count=B, height=H,
                    width=W, dtype=np.dtype(dtype_name),
                    rows_per_strip=strip_rps, nodata=nodata,
                    descriptions=descriptions, geo=geo,
                    with_mask=mask_passthrough)
        sum_b: Dict[int, int] = {ri: 0 for ri in rep_ri}
        sum_t: Dict[int, List[float]] = {ri: [0.0, 0.0] for ri in rep_ri}
        sum_skip: Dict[int, int] = {ri: 0 for ri in rep_ri}
        with MemorySampler() as ms:
            for y0, rows in strips:
                win = tiff.Window(col_off=0, row_off=y0, width=W,
                                  height=rows)
                block, src_mask_w = _read_strip(ds.path, win, B, dtype_name)
                if is_metric_rep:
                    for band in block:      # band by band: small temporaries
                        rscan.update(band)
                    if sql is not None:
                        sql.src_strip(y0, block, src_mask_w, nodata,
                                      has_nodata)
                # the strip's one upload: the codec's device work and the
                # metric lanes read it
                block_dev = torch.from_numpy(block).to(device)
                if rep_jobs:
                    ctx = dict(cfg.codec_opts)
                    ctx.setdefault("nodata", nodata)
                    ctx.setdefault("dataset_mask", src_mask_w)
                    ctx["device_cube"] = block_dev
                    ctx["device_plan_cache"] = {}
                    results = cfg.codec.sweep_rates(
                        block, dtype_name, rep_specs,
                        keep_bitstream=cfg.keep_bitstream, **ctx)
                    ctx = None      # the plan cache dies with the strip's codec
                else:
                    results = []
                # strip-local masks (reference run_codec.py:249-263)
                if needs_metrics:
                    vm_base = src_mask_w > 0
                    if has_nodata:
                        vm_base = vm_base & np.all(block != nodata, axis=0)
                    user_w = None
                    if mask_ds is not None:
                        user_w = mask_ds.read(1, window=win) > 0
                        vm_base = vm_base & user_w
                    sam_vm = np.ascontiguousarray(
                        user_w if user_w is not None else (src_mask_w > 0))
                    if mesh is None:
                        vm_dev = torch.from_numpy(vm_base).to(device)
                        sam_vm_dev = torch.from_numpy(sam_vm).to(device)
                # one copy of the strip and its masks per position that
                # holds a lane (mesh mode)
                strip_on: Dict[object, tuple] = {}

                def accumulate(key, rec, _block=block, _on_pos=strip_on):
                    """One (lane, strip) contribution, on the lane's position
                    when there is a mesh; returns the recon tensor used
                    without one (None with one)."""
                    pos = lane_pos.get(key)
                    if pos is None:
                        rec_dev = _on(rec, device)
                        _acc_lane_strip(lanes[key]["acc"], block_dev, rec_dev,
                                        vm_dev, sam_vm_dev, nodata,
                                        has_nodata, is_caseb)
                        return rec_dev
                    if pos not in _on_pos:
                        _on_pos[pos] = (pos.put(_block), pos.put(vm_base),
                                        pos.put(sam_vm))
                    blk_p, vm_p, sam_p = _on_pos[pos]
                    rec_p = pos.put(rec)
                    with pos.run():
                        _acc_lane_strip(lanes[key]["acc"], blk_p, rec_p, vm_p,
                                        sam_p, nodata, has_nodata, is_caseb)
                    return None

                for ri, res in zip(rep_ri, results):
                    sum_b[ri] += res.bitstream_bytes
                    sum_t[ri][0] += res.t_comp_s
                    sum_t[ri][1] += res.t_dec_s
                    sum_skip[ri] += int(
                        res.extras.get("tiles_skipped_nodata", 0) or 0)
                    if ri not in per_ri_meta:
                        per_ri_meta[ri] = res.to_meta()
                    recon = res.recon
                    rec_dev = None
                    if cfg.write_artifacts and ri in writers:
                        writers[ri].write(y0, (
                            recon.cpu().numpy()
                            if isinstance(recon, torch.Tensor)
                            else np.asarray(recon)))
                        if mask_passthrough:
                            writers[ri].write_mask(y0, src_mask_w)
                    if cfg.keep_bitstream and res.bitstreams:
                        bit_dir = jobs[(ri, rep)]["run_dir"] / "bit"
                        bit_dir.mkdir(parents=True, exist_ok=True)
                        for name, data in res.bitstreams.items():
                            (bit_dir / f"s{y0:06d}_{name}").write_bytes(data)
                    lane_key = jobs[(ri, rep)]["lane"]
                    if (not dedupe) or metric_rep_ri[ri] == rep:
                        # honest reps: THIS rep's own lane accumulates;
                        # dedupe: only the rate's designated rep feeds
                        # the shared lane
                        rec_dev = accumulate(lane_key, recon)
                    if sql is not None and metric_rep_ri[ri] == rep:
                        # quicklook CONTENT is per rate in both modes
                        sql.lane_strip(
                            ("fresh", ri), y0, block, block_dev,
                            _on(recon, device) if rec_dev is None
                            else rec_dev, src_mask_w, nodata, has_nodata)
                # resumed lanes: metric-only windowed read of their recons
                if is_metric_rep:
                    for key, lane in lanes.items():
                        if lane["src"] is None:
                            continue
                        with tiff.open(lane["src"]) as rds:
                            rec_host = rds.read(window=win)
                        rec_dev = accumulate(key, rec_host)
                        if sql is not None:
                            sql.lane_strip(key, y0, block, block_dev,
                                           _on(rec_host, device)
                                           if rec_dev is None else rec_dev,
                                           src_mask_w, nodata, has_nodata)
                # drop the strip's buffers (source, upload, recons, the
                # codec's plan cache) before the next strip is read, which
                # would otherwise hold two strips at once
                block = block_dev = results = res = recon = rec_dev = None
                strip_on = accumulate = None
            if is_caseb:
                # settle any lane whose accumulation ended this rep (a
                # lane with nothing pending is a no-op)
                for key, lane in lanes.items():
                    pos = lane_pos.get(key)
                    with (pos.run() if pos is not None
                          else contextlib.nullcontext()):
                        _spectral_flush(lane["acc"], None, None)
        for ri in rep_ri:   # every rep_ri job is fresh in this rep
            job = jobs[(ri, rep)]
            meta = dict(per_ri_meta[ri])
            meta["bitstream_bytes"] = sum_b[ri]
            meta["t_comp_s"] = sum_t[ri][0]
            meta["t_dec_s"] = sum_t[ri][1]
            meta["mem_comp_peak_bytes"] = ms.phase_peak_bytes("comp")
            meta["mem_dec_peak_bytes"] = ms.phase_peak_bytes("dec")
            mib = lambda x: None if not x else round(x / (1 << 20), 2)
            meta["mem_comp_peak_mb"] = mib(meta["mem_comp_peak_bytes"])
            meta["mem_dec_peak_mb"] = mib(meta["mem_dec_peak_bytes"])
            # keep the wrapper-JSON parity fields (reference
            # ccsds121_wrap.py:221-237) consistent with the whole-item
            # sums; the CSV schema deliberately excludes them
            if "bpp_effective_total" in meta:
                bpp = sum_b[ri] * 8.0 / max(W * H, 1)
                meta["bpp_effective_total"] = float(bpp)
                meta["bpp_effective_per_band"] = float(bpp / max(B, 1))
            if "tiles_skipped_nodata" in meta:
                meta["tiles_skipped_nodata"] = sum_skip[ri]
            job["meta"] = meta
            job["t_wrap"] = sum_t[ri][0] + sum_t[ri][1]
            job["bs_bytes"] = sum_b[ri]
        for w in writers.values():
            w.close()

    if sql is not None:
        # quicklook artifact write-out (warn-and-continue, §5.3 policy —
        # reference run_codec.py:519-520)
        # quicklook files group by CONTENT key — per rate for fresh jobs
        # (replicas hardlinked across reps), per (ri, rep) for resumed
        lane_dirs: Dict[object, List[Path]] = {}
        for (ri, rep) in sorted(jobs):
            job = jobs[(ri, rep)]
            lane_dirs.setdefault(job["ckey"], []).append(job["run_dir"])
        lane_src = {}
        for key, dirs in lane_dirs.items():
            src = lanes[key]["src"] if key in lanes else None
            if src is None:
                src = (dirs[0] / "recon.tif" if cfg.write_artifacts
                       else None)
            lane_src[key] = src
        try:
            sql.finalize(ds, lane_dirs, lane_src, geo, rows_blk)
        except Exception as e:
            log(f"[WARN] Streamed quicklooks failed: {e}")

    if mask_ds is not None:
        mask_ds.close()
    data_range = rscan.result()
    if mesh is not None:
        # the lanes' statistics come to the host below
        for pos in mesh.positions():
            pos.synchronize()

    # assemble merged metrics per lane
    lane_met: Dict[object, dict] = {}
    for key, lane in lanes.items():
        acc: _LaneAcc = lane["acc"]
        mq = merge_quality_stats(_host(acc.q_masked)) if acc.q_masked \
            else None
        if mq is None or float(mq["n"]) == 0.0:
            mq = merge_quality_stats(_host(acc.q_ones))
        met = assemble_quality(mq, float(data_range))
        if is_caseb:
            met.update(merge_spectral_stats(_host(acc.s_parts)))
        else:
            met.update({"sam_deg": float("nan"), "sid": float("nan"),
                        "lmse": float("nan")})
        lane_met[key] = met

    hbm = hbm_peak_bytes(device)
    rows_out: List[dict] = []
    for ri, r in enumerate(rates):
        for rep in range(cfg.reps):
            job = jobs[(ri, rep)]
            row = build_csv_row(
                case_name=case_name, asset_name=asset_name,
                codec_label=cfg.codec_label, rk=rk, r=r, tile_id=tile_id,
                W=W, H=H, B=B, container_bytes=container_bytes,
                raw16_bytes=raw16_bytes, link=link, t_wrap=job["t_wrap"],
                meta=job["meta"], bs_bytes=job["bs_bytes"],
                met=lane_met[job["lane"]])
            if hbm:
                row["hbm_peak_bytes"] = hbm
                row["hbm_peak_mb"] = round(hbm / (1 << 20), 2)
            rows_out.append(row)
    return rows_out


def _read_strip(path, win: tiff.Window, B: int, dtype_name: str):
    """One strip of the source and its dataset mask, through a reader of its
    own that is closed on return (the reader maps the file, and the pages a
    strip touches count in the process's RSS until the map is dropped),
    read band by band into the strip (a whole-strip read stacks a copy of
    its bands)."""
    block = np.empty((B, win.height, win.width), np.dtype(dtype_name))
    with tiff.open(path) as sds:
        for b in range(B):
            block[b] = sds.read(b + 1, window=win)
        return block, sds.dataset_mask(window=win)


def _on(recon, device: torch.device) -> torch.Tensor:
    """A codec's recon (host array or tensor) as a tensor on ``device``."""
    if isinstance(recon, torch.Tensor):
        return recon.to(device)
    return torch.from_numpy(np.ascontiguousarray(recon)).to(device)


def _acc_lane_strip(acc: _LaneAcc, block_dev: torch.Tensor,
                    rec_dev: torch.Tensor, vm_base: torch.Tensor,
                    sam_vm: torch.Tensor, nodata, has_nodata: bool,
                    is_caseb: bool):
    """Accumulate one (lane, strip) contribution on the device: quality
    now, spectral deferred until the next strip's halo row exists."""
    vm = vm_base
    if has_nodata:
        vm = vm & (rec_dev != nodata).all(0)
    qm, qu = quality_stats_dual(block_dev, rec_dev, vm)
    acc.q_masked.append(qm)
    acc.q_ones.append(qu)
    if is_caseb:
        _spectral_flush(acc, block_dev[:, :1], rec_dev[:, :1])
        acc.pend = {"ref": block_dev, "rec": rec_dev, "vm": sam_vm,
                    "top_ref": acc.tail_ref, "top_rec": acc.tail_rec}
