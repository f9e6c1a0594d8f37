# -*- coding: utf-8 -*-
"""Case A baseline preparation: Sentinel-2 bands -> scene + HC/LC tiles.

The port of tpukit/pipelines/baseline_a.py: host code over the port's own
``io`` copies; the one device step, the 12-in-16 conversion, runs on
``CaseAConfig.device`` (CUDA unless the caller names the CPU).

Pipeline equivalent of reference tools/make_baseline_A.py:
  1. stack the four 10 m bands (B02/B03/B04/B08) windowed into a
     2000×10000 uint16 scene GeoTIFF (:38-93; geometry constants :20-25)
  2. convert to 12-in-16 (round DN to multiples of 16, :137-170)
  3. scene quicklooks: RGB of the 12-in-16 baseline and the ERR8 map of
     12-in-16 vs raw 16-bit at cap 15 (:173-198, :219-220)
  4. crop 1024² HC/LC tiles inside the scene at the measured offsets
     (HC 300,688; LC 488,7012 — :24-25), 12-in-16 them, drop the 16-bit
     intermediates, RGB quicklooks (:222-248)
  5. write the runs/tile index manifest (runs/tile/index_caseA.json:1-8)

Inputs are GeoTIFFs (or any raster tpukit_torch.io.tiff can read). The
bit-depth conversion runs on the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpukit_torch.device import resolve_device
from tpukit_torch.io import tiff
from tpukit_torch.io.bitdepth import to_12in16
from tpukit_torch.io.manifest import write_manifest
from tpukit_torch.viz import quicklooks as ql


@dataclass
class CaseAConfig:
    band_paths: Sequence[Path]              # B02, B03, B04, B08
    outdir: Path
    scene_w: int = 2000                     # reference :20
    scene_h: int = 10000
    tile_w: int = 1024                      # reference :21
    tile_h: int = 1024
    hc_off: tuple = (300, 688)              # col, row — reference :24
    lc_off: tuple = (488, 7012)             # reference :25
    col_off: Optional[int] = None           # scene window (None = centered)
    row_off: Optional[int] = None
    quicklooks: bool = True
    keep_16bit_tiles: bool = False
    device: str = "cuda"                    # the 12-in-16 conversion's


def write_window_stack(cfg: CaseAConfig, out_path: Path) -> Path:
    """Cut a window from the band sources and stack into one multiband
    GeoTIFF (reference :38-93)."""
    from tpukit_torch.io.jp2 import open_raster
    # band sources may be GeoTIFFs or Sentinel-2 .jp2 files (the reference
    # reads the JP2s via rasterio/GDAL, make_baseline_A.py:13-19)
    from contextlib import ExitStack, closing
    with ExitStack() as stack:
        # datasets mmap whole files — release them on EVERY exit path,
        # not only after a successful stack
        dss = [stack.enter_context(closing(open_raster(p)))
               for p in cfg.band_paths]
        ref = dss[0]
        W, H = ref.width, ref.height
        for ds, p in zip(dss, cfg.band_paths):
            if (ds.width, ds.height) != (W, H):
                raise ValueError(f"Different size in {p}")
        col = cfg.col_off if cfg.col_off is not None \
            else max(0, (W - cfg.scene_w) // 2)
        row = cfg.row_off if cfg.row_off is not None \
            else max(0, (H - cfg.scene_h) // 2)
        col = min(col, max(0, W - cfg.scene_w))
        row = min(row, max(0, H - cfg.scene_h))
        win = tiff.Window(col, row, min(cfg.scene_w, W),
                          min(cfg.scene_h, H))
        data = np.stack([ds.read(1, window=win).astype(np.uint16)
                         for ds in dss])
        tr = tiff.window_transform(win, ref.transform)
        tiff.write_geotiff(out_path, data, transform=tr, nodata=ref.nodata,
                           blockxsize=512, blockysize=512,
                           bigtiff="IF_SAFER")
    return out_path


def convert_12in16(in_path: Path, out_path: Path, device="cuda") -> Path:
    """12-in-16 conversion on ``device`` (reference to_12in16 :137-170)."""
    dev = resolve_device(device)
    with tiff.open(in_path) as src:
        data = src.read()
        out = to_12in16(torch.from_numpy(data).to(dev)).cpu().numpy()
        tiff.write_geotiff(out_path, out, nodata=src.nodata, geo=src.geo,
                           blockxsize=512, blockysize=512)
    return out_path


def cut_tile(parent: Path, out_path: Path, col_off: int, row_off: int,
             w: int, h: int) -> Path:
    """Window from the scene so tiles stay inside its footprint (:96-134)."""
    with tiff.open(parent) as src:
        if not (0 <= col_off <= src.width - w):
            raise ValueError("col_off outside the scene")
        if not (0 <= row_off <= src.height - h):
            raise ValueError("row_off outside the scene")
        win = tiff.Window(col_off, row_off, w, h)
        data = src.read(window=win)
        tr = tiff.window_transform(win, src.transform)
        tiff.write_geotiff(out_path, data, transform=tr, nodata=src.nodata,
                           blockxsize=512, blockysize=512)
    return out_path


def run(cfg: CaseAConfig) -> dict:
    dev = resolve_device(cfg.device)        # an absent card raises first
    outdir = Path(cfg.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    scene16 = outdir / "caseA_scene_2k10k_16bit.tif"
    scene12 = outdir / "caseA_scene_2k10k_12in16.tif"

    write_window_stack(cfg, scene16)
    convert_12in16(scene16, scene12, dev)

    if cfg.quicklooks:
        params = ql.stretch_params_from_baseline(scene12)
        ql.write_rgb_8bit(scene12, scene12.with_name(scene12.stem + "_RGB8.tif"),
                          params)
        ql.write_error_max8(scene12, scene16,
                            scene12.with_name(scene12.stem),
                            err_max_global=15)

    items = []
    for tid, (coff, roff) in (("HC", cfg.hc_off), ("LC", cfg.lc_off)):
        t16 = outdir / f"caseA_tile_{tid}_1024_16bit.tif"
        t12 = outdir / f"caseA_tile_{tid}_1024_12in16.tif"
        cut_tile(scene16, t16, coff, roff, cfg.tile_w, cfg.tile_h)
        convert_12in16(t16, t12, dev)
        if not cfg.keep_16bit_tiles:
            try:
                os.remove(t16)
            except FileNotFoundError:
                pass
        if cfg.quicklooks:
            params = ql.stretch_params_from_baseline(t12)
            ql.write_rgb_8bit(t12, t12.with_name(t12.stem + "_RGB8.tif"), params)
        items.append({"tile_id": tid, "path": t12})

    index = outdir / "index_caseA.json"
    write_manifest(index, "caseA", f"tile_{cfg.tile_w}", items)
    return {"scene16": scene16, "scene12": scene12, "index": index,
            "items": items}
