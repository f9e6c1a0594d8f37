#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Time the host steps of the J2K scene row on bench.py's scene.

    python3 scripts/scene_host_costs.py [--seed 2026] [--reps 7]

Draws ``bench_torch.py``'s 4x2000x10000 uint16 scene from ``--seed``,
writes it as the benchmark does (a GeoTIFF in 512² blocks, untimed), and
times in turns, each rep once, the host steps that
``sceneA_j2k_device_tiled1024`` takes before and around the codec:

  tiff_read            ``tiff.open(path).read()``, the runner's read
  data_range           ``bitdepth.effective_data_range`` (the runner's)
  float64_scan         tpukit's quantizer peak,
                       ``float(np.abs(cube.astype(np.float64)).max()) or 1.0``
  cube_peak            the port's ``j2k_codec._cube_peak`` (same float)

and, where there is a card, the runner's pageable upload, the same upload
from pinned memory (its buffer filled untimed), and the peak taken on the
card (``torch.aminmax`` of the upload widened to int32, which CUDA's
``aminmax`` needs for uint16; two numbers back). Every peak must equal
tpukit's float. Prints the card's ``nvidia-smi`` name and power limit,
then one JSON line with every time in seconds (each rep's, and their
median).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_torch  # noqa: E402
from tpukit_torch.codecs.j2k_codec import _cube_peak  # noqa: E402
from tpukit_torch.io import tiff  # noqa: E402
from tpukit_torch.io.bitdepth import effective_data_range  # noqa: E402


PEAKS = ("float64_scan", "cube_peak", "device_peak_int32")


def tpukit_peak(cube: np.ndarray) -> float:
    return float(np.abs(cube.astype(np.float64)).max()) or 1.0


def read(path: Path) -> np.ndarray:
    with tiff.open(path) as ds:
        return ds.read()


def card_steps(scene: np.ndarray, dev: torch.device):
    """The card's steps as (name, function) pairs; each function ends in a
    synchronize and returns a peak or None."""
    pinned = torch.empty(scene.shape, dtype=torch.uint16, pin_memory=True)
    pinned.copy_(torch.from_numpy(scene))
    dc = torch.from_numpy(scene).to(dev)

    def pageable():
        torch.from_numpy(scene).to(dev)
        torch.cuda.synchronize(dev)

    def from_pinned():
        pinned.to(dev, non_blocking=True)
        torch.cuda.synchronize(dev)

    def device_peak():
        lo, hi = torch.aminmax(dc.to(torch.int32))
        lo, hi = torch.stack([lo, hi]).tolist()
        return float(max(abs(lo), abs(hi))) or 1.0

    return [("upload_pageable", pageable), ("upload_pinned", from_pinned),
            ("device_peak_int32", device_peak)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=bench_torch.SEED)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    scene = bench_torch.draw_inputs(args.seed, bench_torch.FULL,
                                    scene=True)["scene"]
    want = tpukit_peak(scene)
    with tempfile.TemporaryDirectory(prefix="scene_host_costs_") as tmp:
        path = Path(tmp) / "scene.tif"
        tiff.write_geotiff(path, scene, blockxsize=512, blockysize=512)
        steps = [("tiff_read", lambda: read(path)),
                 ("data_range", lambda: effective_data_range(scene,
                                                             "uint16")),
                 ("float64_scan", lambda: tpukit_peak(scene)),
                 ("cube_peak", lambda: _cube_peak(scene))]
        if torch.cuda.is_available():
            steps += card_steps(scene, torch.device("cuda", 0))
        times = {name: [] for name, _ in steps}
        for _ in range(args.reps):
            for name, fn in steps:
                t0 = time.perf_counter()
                out = fn()
                times[name].append(time.perf_counter() - t0)
                if name in PEAKS and out != want:
                    print(f"{name}: peak {out!r} != tpukit's {want!r}",
                          file=sys.stderr)
                    return 1
                if name == "tiff_read" and not np.array_equal(out, scene):
                    print("tiff_read: not the scene", file=sys.stderr)
                    return 1
    print(bench_torch.card_line())
    print(json.dumps({
        "scene": list(scene.shape), "dtype": scene.dtype.name,
        "seed": args.seed, "peak": want,
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else "cpu"),
        "median_s": {k: statistics.median(v) for k, v in times.items()},
        "reps_s": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
