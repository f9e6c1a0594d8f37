#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""tpukit_torch benchmark: bench.py's canonical commands on one NVIDIA card.

    python3 bench_torch.py                   # all four cells, then one line
    python3 bench_torch.py --cell NAME       # one cell
    python3 bench_torch.py --device cpu      # a rehearsal on the CPU (slow)
    python3 bench_torch.py --control k2-bf16 --warm 0   # the control

The port of ``bench.py`` for ``tpukit_torch``. Its four rows are the
benchmark's cells (``BENCHMARK.json``), each a ``run-codec`` command line
driven in-process through ``cli.main.run_codec_config`` and
``sweep.runner.run_sweep``, as the CLI runs it:

  caseB_anchor_ccsds121        ``--codec ccsds121 --rate-key none --reps 3
                               --preproc none --nbit 16 --interleave bip
                               --tile 512`` on bench.py's 180x512x512 int16
                               14-in-16 tile, then the anchor flow (the
                               device encode plan beside the metric
                               reductions, the parallel host coder, the
                               parallel decode and its verification)
  caseA_j2k_quality14          ``--codec j2k --rate-key quality --rates 1 2
                               4 6 8 10 15 20 25 30 35 40 60 100 --reps 3
                               --keep-bitstream`` on bench.py's two
                               1024x1024x4 uint16 12-in-16 tiles
  sceneA_j2k_device_tiled1024  ``--codec j2k --entropy device --rate-key
                               quality --rates 40 --reps 1 --tilex 1024
                               --tiley 1024 --no-artifacts`` on bench.py's
                               2000x10000x4 12-in-16 scene
  sceneA_ccsds121_stream512    ``--codec ccsds121 --rate-key none --reps 1
                               --preproc none --nbit 16 --interleave bip
                               --tile 512 --stream-rows 512`` on the scene

The inputs are drawn from ``--seed`` by bench.py's recipes in bench.py's
order from one generator (Case B tile, Case A tiles, scene), so a cell run
alone sees the inputs of a full run, and written as GeoTIFFs (untimed).

Each cell runs one cold sweep (iteration 0: the kernels' nvcc build, the
native library's g++ build, CUDA's start-up and the allocator's growth),
then its warm sweeps, each into a fresh outdir and ended by
``torch.cuda.synchronize()``, then one traced sweep under
``torch.profiler`` that is not timed, in the scene J2K cell one more
untimed sweep under the host RSS sampler, then its reference pass
(below). It prints one JSON line with the median, quartiles and sample
count of each end-to-end metric (``sweep_wall_s``; ``anchor_flow_s`` in
Case B), the cold sweep apart, the per-layer metrics (the runner's
phases, K1/K2 launches, device memory peak, the host RSS delta of the two
scene cells: every warm sweep's in the streamed one, gated, and the RSS
sweep's in the scene J2K one, not gated, as bench.py does), the traced
device-busy share and the rows attempted (the timed and traced sweeps')
and failed. Every sweep's rows are checked; a failed check makes the cell
exit non-zero after its line is printed. Without a ``--cell``, a last
line has bench.py's keys but the five it drops by name (``north_star_s``,
``north_star_met``, ``warm_sum_s``, ``program_warmup_s``,
``transfer_warmup_s``: a TPU north star and the TPU's warm-ups).

Correct means equal to tpukit, the JAX system the port reproduces.
``bench_reference.json`` (written from the JAX package by
``tests/test_torch_bench.py``) holds tpukit's rows of each cell's command
on the recipes drawn for seed 2026, at full size and at the small
geometry ``REF``, and for Case B its anchor plan's bits and stream length
(at full size bench.py's TPU-recorded, libaec-equal ones). At seed 2026
every sweep's rows and Case B's anchor are held to the full-size ones;
each cell's reference pass runs its command once more, untimed, at
``REF`` and is held to those. Bytes, bits and lossless flags must be
equal; the J2K rows' bytes and PSNR within ``REF_TOL``. ``--control
k2-bf16`` rounds K2's input and output to bfloat16: a lower-precision
control that the J2K cells must fail.

Without a card, and without ``--device cpu``, it exits non-zero naming
the missing card: it never falls back to the CPU. It imports nothing of
JAX and nothing of tpukit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from tpukit_torch.cli.main import run_codec_config
from tpukit_torch.codecs import ccsds121, j2k_codec
from tpukit_torch.io import manifest, tiff
from tpukit_torch.io.bitdepth import effective_data_range
from tpukit_torch.io.jp2 import JP2Decoder
from tpukit_torch.kernels.dwt97 import dwt97
from tpukit_torch.kernels.fs_table import fs_table
from tpukit_torch.metrics.quality import assemble_quality, quality_stats
from tpukit_torch.metrics.spectral import spectral_stats
from tpukit_torch.native import ccsds121_host
from tpukit_torch.sweep import runner
from tpukit_torch.sweep.proc import MemorySampler, psutil

SEED = 2026                     # bench.py's
RATES_A = ["1", "2", "4", "6", "8", "10", "15", "20", "25", "30", "35", "40",
           "60", "100"]
RSS_GATE_MB = 500.0             # bench.py's bounded-memory gate (:492-500)
PSNR_REL = 1e-6                 # Case A's psnr_band_avg across iterations
PHASE_KEYS = ("codec_s", "device_s", "artifacts_s", "streamed_s")
REFERENCE = Path(__file__).with_name("bench_reference.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---- inputs: bench.py's recipes ------------------------------------------

@dataclass(frozen=True)
class Geometry:
    """The inputs' sizes and the sizes the command lines take from them.
    ``FULL`` is bench.py's; the tests run smaller ones on the CPU."""
    caseb_bands: int = 180
    caseb_size: int = 512
    casea_size: int = 1024
    scene: tuple = (4, 2000, 10000)
    scene_tile: int = 1024      # --tilex/--tiley of the J2K scene row
    codec_tile: int = 512       # --tile of the CCSDS-121 rows
    strip_rows: int = 512       # --stream-rows of the streamed row
    anchor_chunk: int = 1 << 22     # the anchor flow's plan chunk


FULL = Geometry()
# the reference passes' geometry: every path of the full one (K1 in the
# anchor plan, K2 on full and edge tiles, strips), small enough for tpukit
# to run on a CPU
REF = Geometry(caseb_bands=16, caseb_size=128, casea_size=128,
               scene=(4, 300, 700), scene_tile=128, codec_tile=128,
               strip_rows=128, anchor_chunk=1 << 14)


def caseb_texture(rng, rows: int, cols: int) -> np.ndarray:
    """The Case B recipe's shared spatial texture (bench.py:60-65): N(0, 1)
    smoothed by a 9-tap box along rows and columns, scaled to
    [500, 6500]."""
    base = rng.normal(0, 1, (rows, cols))
    k = np.ones(9) / 9.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    return 500 + 6000 * base


def caseb_gains(bands: int) -> np.ndarray:
    """The Case B recipe's smooth spectral gains (bench.py:66)."""
    return 0.6 + 0.8 * np.abs(np.sin(np.linspace(0.3, 5.8, bands)))


def make_caseb_cube(rng, bands=180, size=512):
    """bench.py's canonical Case B tile (bench.py:57-69): shared spatial
    texture x smooth spectral gains + N(0, 12) noise, 14-in-16 int16."""
    spatial = caseb_texture(rng, size, size)
    cube = (spatial[None] * caseb_gains(bands)[:, None, None]
            + rng.normal(0, 12, (bands, size, size)))
    cube = np.clip(cube, -8192, 8191).astype(np.int16)
    return ((cube.view(np.uint16) >> 2) << 2).view(np.int16)


def make_casea_tiles(rng, size=1024):
    """bench.py's two canonical Case A tiles, HC and LC (bench.py:72-81):
    size x size x 4 uint16, 12-in-16."""
    gy, gx = np.mgrid[0:size, 0:size]
    base = ((800 + 2.5 * gy + 1.5 * gx).astype(np.int32)) % 4096
    tiles = {}
    for tid, amp in (("HC", 400), ("LC", 40)):
        t = np.clip(base[None] + rng.integers(-amp, amp, (4, size, size)),
                    0, 4095).astype(np.uint16) << 4
        tiles[tid] = t.astype(np.uint16)
    return tiles


def make_scene(rng, bands=4, height=2000, width=10000):
    """bench.py's 2000x10000x4 uint16 12-in-16 Case A scene
    (bench.py:415-420)."""
    gy, gx = np.mgrid[0:height, 0:width]
    sbase = ((700 + 1.1 * gy + 0.7 * gx).astype(np.int32)) % 4096
    return (np.clip(sbase[None] + rng.integers(-300, 300,
                                               (bands, height, width)),
                    0, 4095).astype(np.uint16) << 4).astype(np.uint16)


def draw_inputs(seed: int, geo: Geometry, scene: bool) -> dict:
    """The inputs in bench.py's draw order from one generator: the Case B
    tile, the Case A tiles, then (when ``scene``) the scene."""
    rng = np.random.default_rng(seed)
    out = {"caseB": make_caseb_cube(rng, geo.caseb_bands, geo.caseb_size),
           "caseA": make_casea_tiles(rng, geo.casea_size)}
    if scene:
        out["scene"] = make_scene(rng, *geo.scene)
    return out


def write_inputs(work: Path, inputs: dict, kinds) -> dict:
    """GeoTIFFs (512² blocks) and manifests of the inputs named in
    ``kinds``, as bench.py writes them; {kind: index path}."""
    idx = {}
    if "caseB" in kinds:
        p = work / "caseB_tile.tif"
        tiff.write_geotiff(p, inputs["caseB"], blockxsize=512, blockysize=512)
        idx["caseB"] = work / "index_caseB.json"
        manifest.write_manifest(idx["caseB"], "caseB", "tile_512",
                                [{"tile_id": "T01", "path": p}])
    if "caseA" in kinds:
        items = []
        for tid, t in inputs["caseA"].items():
            p = work / f"caseA_tile_{tid}_12in16.tif"
            tiff.write_geotiff(p, t, blockxsize=512, blockysize=512)
            items.append({"tile_id": tid, "path": p})
        idx["caseA"] = work / "index_caseA.json"
        manifest.write_manifest(idx["caseA"], "caseA", "tile_1024", items)
    if "scene" in kinds:
        p = work / "caseA_scene_12in16.tif"
        tiff.write_geotiff(p, inputs["scene"], blockxsize=512, blockysize=512)
        idx["scene"] = work / "index_scene.json"
        manifest.write_manifest(idx["scene"], "caseA", "scene",
                                [{"tile_id": "sceneA", "path": p}])
    return idx


# ---- the cells -----------------------------------------------------------

def caseb_argv(idx, geo):
    return ["--indices", str(idx), "--codec", "ccsds121", "--rate-key", "none",
            "--reps", "3", "--preproc", "none", "--nbit", "16",
            "--interleave", "bip", "--tile", str(geo.codec_tile)]


def casea_argv(idx, geo):
    return ["--indices", str(idx), "--codec", "j2k", "--rate-key", "quality",
            "--rates", *RATES_A, "--reps", "3", "--keep-bitstream"]


def scene_j2k_argv(idx, geo):
    return ["--indices", str(idx), "--codec", "j2k", "--entropy", "device",
            "--rate-key", "quality", "--rates", "40", "--reps", "1",
            "--tilex", str(geo.scene_tile), "--tiley", str(geo.scene_tile),
            "--no-artifacts"]


def stream_argv(idx, geo):
    return ["--indices", str(idx), "--codec", "ccsds121", "--rate-key", "none",
            "--reps", "1", "--preproc", "none", "--nbit", "16",
            "--interleave", "bip", "--tile", str(geo.codec_tile),
            "--stream-rows", str(geo.strip_rows)]


def check_caseb(state, rows, outdir):
    """Lossless rows whose bytes are equal across reps and iterations."""
    bad = []
    for r in rows:
        want = state.setdefault("bytes", r["bitstream_bytes"])
        if (r["lossless"], r["max_abs_err"]) != (1, 0):
            bad.append(f"not lossless: max_abs_err {r['max_abs_err']}")
        elif r["bitstream_bytes"] != want:
            bad.append(f"bitstream_bytes {r['bitstream_bytes']} != {want}")
    return bad


def check_casea(state, rows, outdir):
    """Each (tile, quality) point's bytes equal across reps and
    iterations, psnr_band_avg equal across iterations within rel 1e-6,
    and each rep's kept codestreams on disk, as long as the row says,
    decoded by the sweep (t_dec_s > 0)."""
    bad = []
    reps = 3
    for i, r in enumerate(rows):
        tid, q, rep = r["tile_id"], r["rate_value"], i % reps
        want = state.setdefault(("bytes", tid, q), r["bitstream_bytes"])
        psnr = state.setdefault(("psnr", tid, q, rep), r["psnr_band_avg"])
        bit = (outdir / tid / runner.rate_slug("quality", q)
               / f"rep_{rep + 1:02d}" / "bit")
        kept = sorted(bit.glob("*.j2c")) if bit.is_dir() else []
        if r["bitstream_bytes"] != want:
            bad.append(f"{tid} q={q}: bitstream_bytes {r['bitstream_bytes']}"
                       f" != {want}")
        elif not (r["psnr_band_avg"] == psnr       # inf at quality 100
                  or abs(r["psnr_band_avg"] - psnr) <= PSNR_REL * abs(psnr)):
            bad.append(f"{tid} q={q} rep {rep + 1}: psnr_band_avg "
                       f"{r['psnr_band_avg']} != {psnr}")
        elif (len(kept) != r["bands"]
              or sum(p.stat().st_size for p in kept) != want):
            bad.append(f"{tid} q={q} rep {rep + 1}: kept streams {kept} do "
                       f"not hold the row's {want} B")
        elif not r["t_dec_s"] > 0:
            bad.append(f"{tid} q={q} rep {rep + 1}: not decoded")
    return bad


def check_scene_j2k(state, rows, outdir):
    """One lossy row whose bytes and psnr_global are equal across
    iterations."""
    bad = []
    for r in rows:
        want = state.setdefault("row", (r["bitstream_bytes"],
                                        r["psnr_global"]))
        if r["lossless"] != 0 or not math.isfinite(r["psnr_global"]):
            bad.append(f"lossless {r['lossless']}, psnr {r['psnr_global']}")
        elif (r["bitstream_bytes"], r["psnr_global"]) != want:
            bad.append(f"(bytes, psnr_global) ({r['bitstream_bytes']}, "
                       f"{r['psnr_global']}) != {want}")
    return bad


def check_stream(state, rows, outdir):
    """Lossless rows."""
    return [f"not lossless: max_abs_err {r['max_abs_err']}" for r in rows
            if (r["lossless"], r["max_abs_err"]) != (1, 0)]


@dataclass(frozen=True)
class Cell:
    config: str                 # the configuration's name in BENCHMARK.json
    index: str                  # the input it sweeps: caseB, caseA or scene
    argv: object                # (index path, Geometry) -> run-codec argv
    warm: int                   # warm iterations
    rows: int                   # rows a sweep must give
    check: object               # (state, rows, outdir) -> failures
    rss: bool = False           # sample the host RSS of every sweep, gated
    rss_sweep: bool = False     # one more sweep, untimed, for the host RSS


CELLS = {
    "caseB_anchor_ccsds121": Cell("caseB_tile_180x512x512_int16", "caseB",
                                  caseb_argv, 20, 3, check_caseb),
    "caseA_j2k_quality14": Cell("caseA_tiles_2x4x1024x1024_u16_12in16",
                                "caseA", casea_argv, 5, 2 * 14 * 3,
                                check_casea),
    "sceneA_j2k_device_tiled1024": Cell("caseA_scene_4x2000x10000_u16_12in16",
                                        "scene", scene_j2k_argv, 20, 1,
                                        check_scene_j2k, rss_sweep=True),
    "sceneA_ccsds121_stream512": Cell("caseA_scene_4x2000x10000_u16_12in16",
                                      "scene", stream_argv, 20, 1,
                                      check_stream, rss=True),
}

# the PSNR each J2K cell holds, and the largest relative distance to
# tpukit's rows that each cell accepts, at REF and at full size: above
# the sound readings on the card (bytes <= 5.1e-8, PSNR <= 1.3e-6) and
# the float-order differences tpukit's own tests allow across platforms,
# below what K2 in bfloat16 gives (Case A bytes >= 3.3e-2, PSNR >= 5.3e-3;
# scene J2K PSNR >= 6.9e-2); PERF.md §2. The lossless cells are exact.
PSNR_KEY = {"caseA_j2k_quality14": "psnr_band_avg",
            "sceneA_j2k_device_tiled1024": "psnr_global"}
REF_TOL = {"caseB_anchor_ccsds121": {"bytes": 0.0, "psnr": 0.0},
           "caseA_j2k_quality14": {"bytes": 1e-3, "psnr": 1e-4},
           "sceneA_j2k_device_tiled1024": {"bytes": 1e-3, "psnr": 1e-4},
           "sceneA_ccsds121_stream512": {"bytes": 0.0, "psnr": 0.0}}


def decode_check(outdir: Path, tiles) -> list:
    """Rep 1's recon.tif == the JPEG 2000 decoder's output of its kept
    streams, at the lowest and the highest quality of each tile."""
    bad = []
    for tid in tiles:
        for q in (RATES_A[0], RATES_A[-1]):
            (r,) = runner._normalize_rates("quality", [q])
            rep = outdir / tid / runner.rate_slug("quality", r) / "rep_01"
            with tiff.open(rep / "recon.tif") as ds:
                recon = ds.read()
            for b in range(recon.shape[0]):
                dec = JP2Decoder((rep / "bit" / f"b{b + 1:02d}.j2c")
                                 .read_bytes()).decode_component(0, 0, 0)
                if not np.array_equal(np.clip(dec, 0, 65535), recon[b]):
                    bad.append(f"{tid} q={q} band {b + 1}: recon.tif != "
                               f"its decoded stream")
    return bad


# ---- the reference: tpukit's rows (bench_reference.json) -----------------

def load_reference() -> dict:
    return json.loads(REFERENCE.read_text())


def reference_row(name: str, row: dict) -> dict:
    """The fields of a row that are held to tpukit's."""
    out = {"tile_id": row["tile_id"],
           "bitstream_bytes": int(row["bitstream_bytes"]),
           "lossless": int(row["lossless"])}
    if name in PSNR_KEY:
        out[PSNR_KEY[name]] = float(row[PSNR_KEY[name]])
    return out


def rel_dist(got: float, want: float) -> float:
    if got == want:                 # inf == inf at quality 100
        return 0.0
    if not (math.isfinite(got) and math.isfinite(want)) or want == 0:
        return math.inf
    return abs(got - want) / abs(want)


def hold_to_reference(name: str, rows, want) -> tuple:
    """A sweep's rows against tpukit's, in order: tile and lossless flag
    exactly, bytes and PSNR within ``REF_TOL[name]``. Returns (readings:
    the rows and the largest relative distances seen, failures)."""
    tol, key = REF_TOL[name], PSNR_KEY.get(name)
    bad = [] if len(rows) == len(want) else [
        f"{len(rows)} rows, tpukit's {len(want)}"]
    far = {"bytes": 0.0, "psnr": 0.0}
    for i, (r, w) in enumerate(zip(rows, want)):
        got = reference_row(name, r)
        d = {"bytes": rel_dist(got["bitstream_bytes"], w["bitstream_bytes"]),
             "psnr": rel_dist(got[key], w[key]) if key else 0.0}
        far = {k: max(far[k], d[k]) for k in far}
        if (got["tile_id"], got["lossless"]) != (w["tile_id"], w["lossless"]):
            bad.append(f"row {i}: (tile, lossless) {got['tile_id']}, "
                       f"{got['lossless']} != tpukit's {w['tile_id']}, "
                       f"{w['lossless']}")
        elif any(d[k] > tol[k] for k in d):
            bad.append(f"row {i} ({w['tile_id']}): {got} against tpukit's "
                       f"{w}: rel {d} over {tol}")
    return {"rows": len(rows), "max_rel_bytes": far["bytes"],
            "max_rel_psnr": far["psnr"] if key else None,
            "tolerance": tol}, bad


def worst(a, b: dict) -> dict:
    """Two sweeps' reference readings as one: the rows counted, the
    largest distances kept."""
    if a is None:
        return b
    return {**b, "rows": a["rows"] + b["rows"],
            **{k: max(a[k], b[k]) for k in ("max_rel_bytes", "max_rel_psnr")
               if b[k] is not None}}


def reference_pass(name: str, device: torch.device, work: Path) -> tuple:
    """The cell's command once more, untimed, on seed 2026's inputs at
    ``REF``, held to tpukit's rows; Case B's anchor flow too, its plan's
    bits and its stream's length exactly tpukit's. Returns (readings,
    failures)."""
    ref = load_reference()["ref"]["cells"][name]
    cell = CELLS[name]
    inputs = draw_inputs(SEED, REF, scene=cell.index == "scene")
    d = work / f"{name}_reference"
    d.mkdir()
    try:
        idx = write_inputs(d, inputs, {cell.index})
        s = sweep(cell.argv(idx[cell.index], REF), device, d / "out")
        readings, bad = hold_to_reference(name, s["res"]["rows"], ref["rows"])
        readings.update(k1_launches=s["k1"], k2_launches=s["k2"])
        if name == "caseB_anchor_ccsds121":
            a = anchor_flow(inputs["caseB"], device, REF.anchor_chunk, 0)
            got = (a["plan"]["total_bits"], len(a["stream"]))
            want = (ref["anchor_total_bits"], ref["anchor_bytes"])
            readings.update(anchor_total_bits=got[0],
                            anchor_k1_launches=a["k1"][0])
            bad += a["bad"] + ([] if got == want else [
                f"anchor (total_bits, bytes) {got} != tpukit's {want}"])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return readings, bad


@contextlib.contextmanager
def k2_in_bf16():
    """The lower-precision control: every K2 call of the J2K codec gets
    its input and gives its output rounded to bfloat16."""
    dwt = j2k_codec.dwt97

    def lowered(x, *args, **kw):
        y = dwt(x.to(torch.bfloat16).to(x.dtype), *args, **kw)
        return y.to(torch.bfloat16).to(y.dtype)
    j2k_codec.dwt97 = lowered
    try:
        yield
    finally:
        j2k_codec.dwt97 = dwt


# ---- measurement ---------------------------------------------------------

def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stats(xs) -> dict:
    """Median, quartiles and count of a metric's warm samples."""
    a = np.asarray(xs, dtype=np.float64)
    if a.size == 0:
        return {"median": None, "q1": None, "q3": None, "n": 0, "samples": []}
    return {"median": float(np.median(a)),
            "q1": float(np.percentile(a, 25)),
            "q3": float(np.percentile(a, 75)), "n": int(a.size),
            "samples": [float(x) for x in a]}


def rss_bytes() -> int:
    return psutil.Process().memory_info().rss if psutil else 0


def sweep(argv, device: torch.device, outdir: Path, rss: bool = False):
    """One run-codec sweep: its result, host-clock wall (ended by a
    synchronize), K1/K2 launches, device memory peak and (when ``rss``)
    host RSS delta."""
    cfg = run_codec_config([*argv, "--device", str(device),
                            "--outdir", str(outdir)])
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    k1, k2 = fs_table.launches, dwt97.launches
    rss0 = rss_bytes()
    with (MemorySampler() if rss else contextlib.nullcontext()) as ms:
        t0 = time.perf_counter()
        res = runner.run_sweep(cfg)
        sync(device)
        wall = time.perf_counter() - t0
    out = {"res": res, "wall": wall, "k1": fs_table.launches - k1,
           "k2": dwt97.launches - k2,
           "hbm_mb": (torch.cuda.max_memory_allocated(device) / (1 << 20)
                      if device.type == "cuda" else None),
           "phases": {k: sum(p[k] for p in res["phases"] if k in p)
                      for k in PHASE_KEYS
                      if any(k in p for p in res["phases"])}}
    if ms is not None:
        out["rss_mb"] = (max(ms.peak_bytes or 0, rss0) - rss0) / (1 << 20)
    return out


def busy_ms(prof) -> float:
    """Device-busy time of a torch.profiler trace: the union of the
    device events' intervals, in ms."""
    ivs = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if str(e.device_type).endswith("CUDA"))
    busy, end = 0, None
    for a, b in ivs:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1000.0


def top_device_ops(prof, n: int = 8) -> list:
    """The ``n`` operations with the most self device time: name, ms,
    calls."""
    ops = []
    for a in prof.key_averages():
        us = getattr(a, "self_device_time_total",
                     getattr(a, "self_cuda_time_total", 0))
        # kernels and copies only: the host op that launched one carries
        # the same device time
        if us > 0 and str(a.device_type).endswith("CUDA"):
            ops.append({"name": a.key[:80], "ms": us / 1000.0,
                        "calls": int(a.count)})
    return sorted(ops, key=lambda o: -o["ms"])[:n]


def traced_sweep(argv, device: torch.device, outdir: Path):
    """One more sweep under torch.profiler (CPU + CUDA), not timed: its
    wall, the device-busy share and the device operations that took the
    most time. Without device events the share is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        s = sweep(argv, device, outdir)
    busy = busy_ms(prof) if device.type == "cuda" else 0.0
    return s, {"traced_wall_s": s["wall"],
               "device_busy_ms": busy or None,
               "device_busy_share": (busy / (1000.0 * s["wall"])
                                     if busy else None),
               "top_device_ops": top_device_ops(prof) if busy else []}


# ---- the anchor flow (bench.py:335-389) ----------------------------------

def anchor_flow(cube: np.ndarray, device: torch.device, chunk: int,
                runs: int):
    """bench.py's Case B anchor flow, ``1 + runs`` times (the first cold):
    the device encode plan of the uploaded flat stream in a worker thread
    while the metric reductions run on the int32 cube, then the parallel
    host coder from the plan, the parallel decode, its verification, and
    a synchronize before the clock stops. Returns (cold s, warm s list,
    K1 launches of each run, failures, the last run's plan and stream,
    its metrics)."""
    flat = np.ascontiguousarray(
        np.moveaxis(cube.view(np.uint16), 0, -1)).ravel()
    x = torch.from_numpy(flat).to(device).to(torch.int32)
    c = torch.from_numpy(cube.view(np.uint16)).to(device)
    v = torch.ones(cube.shape[1:], dtype=torch.bool, device=device)
    serial = ccsds121_host.encode(flat, 16)     # the check, untimed
    sync(device)
    times, k1s, bad = [], [], []
    plan = stream = qs = None
    for i in range(1 + runs):
        k1 = fs_table.launches
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as tp:
            fplan = tp.submit(ccsds121.encode_plan, x, chunk=chunk)
            ci = c.to(torch.int32)
            qs = quality_stats(ci, ci, v)
            ss = spectral_stats(ci, ci, v)
            plan = fplan.result()       # host ints: the table came back
            if plan is None:
                raise RuntimeError(f"no encode plan for {flat.size} "
                                   f"samples in chunks of {chunk}")
            stream = ccsds121_host.encode_parallel(flat, plan)
        dec = ccsds121_host.decode_parallel(stream, plan)
        ok = np.array_equal(dec, flat)
        sync(device)
        times.append(time.perf_counter() - t0)
        k1s.append(fs_table.launches - k1)
        if not ok:
            bad.append(f"anchor run {i}: decode != input")
        if (plan["total_bits"] + 7) // 8 != len(stream):
            bad.append(f"anchor run {i}: size model {plan['total_bits']} "
                       f"bits != {len(stream)} B")
        if stream != serial:
            bad.append(f"anchor run {i}: stream != the serial coder's")
    del ss
    met = assemble_quality({k: t.cpu().numpy() for k, t in qs.items()},
                           effective_data_range(cube, "int16"))
    if met["lossless"] != 1:
        bad.append(f"anchor metrics not lossless: {met['max_abs_err']}")
    return {"cold": times[0], "warm": times[1:], "k1": k1s, "bad": bad,
            "plan": plan, "stream": stream, "n": int(flat.size),
            "lossless": met["lossless"]}


# ---- a cell --------------------------------------------------------------

def run_cell(name: str, idx: Path, inputs: dict, work: Path,
             device: torch.device, geo: Geometry = FULL, warm=None,
             keep_last: bool = True, seed: int = SEED,
             reference: bool = True) -> dict:
    """One cell: its cold sweep, warm sweeps and traced sweep, every
    sweep's rows checked, the RSS sweep of a ``rss_sweep`` cell, Case B's
    anchor flow, and (when ``reference``) its reference pass. ``inputs``
    were drawn from ``seed`` at ``geo``.
    Returns the cell's record (printed as its JSON line) with, for the
    caller, ``_rows`` (the last warm sweep's rows), ``_outdir`` (its
    outdir, kept when ``keep_last``) and Case B's ``_anchor``. A failure
    of any kind is recorded in ``failures``, never raised."""
    cell = CELLS[name]
    warm = cell.warm if warm is None else warm
    argv = cell.argv(idx, geo)
    state, failures = {}, []
    # bench.py's own inputs: every sweep's rows are held to tpukit's
    full = (load_reference()["full"]["cells"][name]
            if geo == FULL and seed == SEED else None)
    attempted = failed = 0
    walls, k1s, k2s, hbm, rss = [], [], [], [], []
    phases = {k: [] for k in PHASE_KEYS}
    rec = {"cell": name, "config": cell.config, "metric": "sweep_wall_s",
           "unit": "s", "warm_iterations": warm}
    last = None

    def check(rows, outdir) -> list:
        """A sweep's failures: the cell's check, tpukit's full-size rows
        (their distances kept in ``reference_full``) and the row count."""
        bad = cell.check(state, rows, outdir)
        if full:
            r, more = hold_to_reference(name, rows, full["rows"])
            rec["reference_full"] = worst(rec.get("reference_full"), r)
            bad += [f"reference: full size: {b}" for b in more]
        if len(rows) != cell.rows:
            bad.append(f"{len(rows)} rows, expected {cell.rows}")
        return bad

    try:
        for it in range(warm + 2):      # cold, warm..., traced
            traced = it == warm + 1
            outdir = work / f"{name}_{it}"
            attempted += cell.rows
            if traced:
                s, rec["trace"] = traced_sweep(argv, device, outdir)
            else:
                s = sweep(argv, device, outdir, rss=cell.rss)
            rows = s["res"]["rows"]
            bad = check(rows, outdir)
            # the cold sweep is the streamed cell's warm-up (bench.py takes
            # its row after the canonical sweeps); the traced one samples
            # nothing
            if "rss_mb" in s and it > 0 and not s["rss_mb"] < RSS_GATE_MB:
                bad.append(f"RSS delta {s['rss_mb']:.1f} MB >= "
                           f"{RSS_GATE_MB} MB")
            failed += min(cell.rows, len(bad))
            failures += [f"iteration {it}: {b}" for b in bad]
            log(f"[{name}] iteration {it}{' (cold)' if it == 0 else ''}"
                f"{' (traced)' if traced else ''}: {s['wall']:.3f} s, "
                f"phases {s['phases']}, K1 {s['k1']}, K2 {s['k2']}"
                + (f", RSS delta {s['rss_mb']:.1f} MB" if "rss_mb" in s
                   else ""))
            if it == 0:
                rec["cold_sweep_s"] = s["wall"]
                rec["cold_k1_launches"] = s["k1"]
                rec["cold_k2_launches"] = s["k2"]
            elif not traced:
                walls.append(s["wall"])
                k1s.append(s["k1"])
                k2s.append(s["k2"])
                hbm.append(s["hbm_mb"])
                rss.append(s.get("rss_mb"))
                for k, v in s["phases"].items():
                    phases[k].append(v)
            if it == warm:
                last = (rows, outdir)
            else:
                shutil.rmtree(outdir, ignore_errors=True)
        if cell.rss_sweep:
            # bench.py samples this row's host RSS (:466-481) and gates only
            # the streamed row: one more sweep under the sampler, after the
            # timed ones so its thread costs no median, its rows checked,
            # its delta a layer metric with no gate
            outdir = work / f"{name}_rss"
            s = sweep(argv, device, outdir, rss=True)
            bad = check(s["res"]["rows"], outdir)
            shutil.rmtree(outdir, ignore_errors=True)
            failures += [f"RSS sweep: {b}" for b in bad]
            rss = [s["rss_mb"]]
            log(f"[{name}] RSS sweep (untimed): {s['wall']:.3f} s, RSS "
                f"delta {s['rss_mb']:.1f} MB")
        if cell.index == "caseA":
            failures += [f"decode: {b}" for b in
                         decode_check(last[1], inputs["caseA"])]
        if name == "caseB_anchor_ccsds121":
            a = anchor_flow(inputs["caseB"], device, geo.anchor_chunk, warm)
            failures += a["bad"]
            rec["anchor_flow_s"] = stats(a["warm"])
            rec["cold_anchor_flow_s"] = a["cold"]
            rec["anchor_k1_launches"] = a["k1"][1:]
            # all samples over all warm time: a stalled run moves it
            rec["anchor_Msamples_per_s"] = (
                a["n"] * len(a["warm"]) / sum(a["warm"]) / 1e6
                if a["warm"] else None)
            rec["bitstream_bytes"] = len(a["stream"])
            rec["anchor_total_bits"] = a["plan"]["total_bits"]
            rec["_anchor"] = a
            got = (a["plan"]["total_bits"], len(a["stream"]))
            if full and got != (full["anchor_total_bits"],
                                full["anchor_bytes"]):
                failures.append(
                    f"reference: full size: anchor (total_bits, bytes) {got}"
                    f" != tpukit's {full['anchor_total_bits']}, "
                    f"{full['anchor_bytes']}")
        if reference:
            rec["reference"], bad = reference_pass(name, device, work)
            failures += [f"reference: {b}" for b in bad]
    except Exception as e:          # the cell's boundary: record, go on
        log(traceback.format_exc())
        failures.append(f"{type(e).__name__}: {e}")
        failed = attempted
    if last and not keep_last:
        shutil.rmtree(last[1], ignore_errors=True)
    rec["sweep_wall_s"] = stats(walls)
    rec["value"] = rec["sweep_wall_s"]["median"]
    rec["layers"] = {
        **{k: stats(v) for k, v in phases.items() if v},
        "k1_launches": k1s, "k2_launches": k2s,
        "hbm_peak_mb": stats([h for h in hbm if h is not None]),
    }
    if cell.rss or cell.rss_sweep:
        rec["layers"]["rss_delta_mb"] = stats([r for r in rss
                                               if r is not None])
    rec["rows_attempted"] = attempted
    rec["rows_failed"] = failed
    rec["failures"] = failures[:20]
    rec["correct"] = not failures
    if last and keep_last:
        rec["_rows"], rec["_outdir"] = last
    return rec


# ---- the card ------------------------------------------------------------

def card_line():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def device_record(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    line = card_line()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "card": line,
            "power_limit": line.split(",")[-1].strip() if line else None}


def public(rec: dict) -> dict:
    """A cell's record without the fields kept for callers."""
    return {k: v for k, v in rec.items() if not k.startswith("_")}


def dedupe_wall(idx: dict, device, work: Path, geo: Geometry) -> float:
    """bench.py's opt-in ``--dedupe-reps`` wall of Case A and Case B,
    measured once (bench.py:307-328); not a cell."""
    total = 0.0
    for kind, fn in (("caseA", casea_argv), ("caseB", caseb_argv)):
        s = sweep(fn(idx[kind], geo) + ["--dedupe-reps"], device,
                  work / f"dedupe_{kind}")
        shutil.rmtree(work / f"dedupe_{kind}", ignore_errors=True)
        total += s["wall"]
    return total


def headline(recs: dict, t_dedupe, n_scene: int, dev: dict) -> dict:
    """bench.py's one JSON line (bench.py:504-546), from the cells'
    medians; ``t_dedupe`` is None when that sweep failed."""
    a, b = recs["caseA_j2k_quality14"], recs["caseB_anchor_ccsds121"]
    scene = {}
    for key, name in (("ccsds121_stream512", "sceneA_ccsds121_stream512"),
                      ("j2k_device_tiled1024", "sceneA_j2k_device_tiled1024")):
        r = recs[name]
        w = r["sweep_wall_s"]
        scene[key] = {"wall_s": w["median"], "Msamples_per_s": (
            n_scene * w["n"] / sum(w["samples"]) / 1e6 if w["n"] else None),
            "scene_mb": n_scene * 2 / (1 << 20)}
        if "rss_delta_mb" in r["layers"]:
            scene[key]["rss_delta_mb"] = r["layers"]["rss_delta_mb"]["median"]
    ta, tb = a["sweep_wall_s"]["median"], b["sweep_wall_s"]["median"]
    total = (ta + tb) if ta is not None and tb is not None else None
    ca, cb = a.get("cold_sweep_s"), b.get("cold_sweep_s")
    anchor = b.get("_anchor")
    return {
        "metric": "canonical_sweeps_wall_s",
        "value": total,
        "unit": "s (median of the warm sweeps: caseA j2k 14pt x2 tiles x3 "
                "HONEST reps + caseB ccsds121 anchor x3 HONEST reps, "
                "canonical run-codec CLI, artifacts on; bench.py sums mins)",
        "vs_baseline": None,
        "correct": t_dedupe is not None and all(r["correct"]
                                                for r in recs.values()),
        "detail": {
            "backend": "torch " + torch.__version__,
            "rep_semantics": "honest (every rep re-executes codec points "
                             "+ its own metric lanes)",
            "summary": "median of warm iterations; iteration 0 apart",
            "t_caseA_canonical_s": ta, "t_caseB_canonical_s": tb,
            "t_total_median_s": total,
            "iters_caseA_s": a["sweep_wall_s"]["samples"],
            "iters_caseB_s": b["sweep_wall_s"]["samples"],
            "cold_caseA_s": ca, "cold_caseB_s": cb,
            "iter0_sum_s": (ca + cb) if ca is not None and cb is not None
            else None,
            "phase_breakdown_warm": {
                k: {p: v["median"] for p, v in r["layers"].items()
                    if p in PHASE_KEYS}
                for k, r in (("caseA", a), ("caseB", b))},
            "t_dedupe_reps_wall_s": t_dedupe,
            "t_anchor_flow_s": b.get("anchor_flow_s", {}).get("median"),
            "t_reference_anchor_flow_s": None,
            "anchor_Msamples_per_s": b.get("anchor_Msamples_per_s"),
            "bitstream_bytes": b.get("bitstream_bytes"),
            "cr_vs_raw16": (anchor["n"] * 2 / len(anchor["stream"])
                            if anchor else None),
            "lossless": anchor["lossless"] if anchor else None,
            "bitstream_equals_serial_coder": bool(anchor) and not any(
                "serial" in f for f in b["failures"]),
            "bitstream_equals_libaec": None,
            "scene": scene,
        },
        "device": dev,
    }


def main(argv=None, geo: Geometry = FULL, reference: bool = True) -> int:
    """The command line; ``geo`` and ``reference`` (run the reference
    passes) let the tests run it small."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", choices=sorted(CELLS), default=None,
                    help="run one cell (default: all four, then bench.py's "
                         "line)")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for a rehearsal")
    ap.add_argument("--warm", type=int, default=None,
                    help="warm iterations of every cell (default: each "
                         "cell's own, as BENCHMARK.json states them)")
    ap.add_argument("--control", choices=["k2-bf16"], default=None,
                    help="a lower-precision control: K2 in bfloat16, which "
                         "the J2K cells' reference checks must fail (exit "
                         "1); with --warm 0 it is short")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("bench_torch.py: no CUDA card (torch.cuda.is_available() is "
            "false); it measures the card and does not fall back to the CPU "
            "(pass --device cpu for a rehearsal)")
        return 2
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dev = device_record(device)
    log(f"[bench_torch] device {dev}; torch {torch.__version__}")
    names = [args.cell] if args.cell else list(CELLS)
    kinds = {CELLS[n].index for n in names}
    if args.cell is None:
        kinds |= {"caseA", "caseB"}     # the --dedupe-reps wall
    t0 = time.perf_counter()
    inputs = draw_inputs(args.seed, geo, scene="scene" in kinds)
    recs, ok = {}, True
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_bench_",
                                     ignore_cleanup_errors=True) as tmp, \
            (k2_in_bf16() if args.control else contextlib.nullcontext()):
        work = Path(tmp)
        idx = write_inputs(work, inputs, kinds)
        log(f"[bench_torch] inputs in {time.perf_counter() - t0:.1f} s "
            f"(untimed) under {work}")
        for n in names:
            rec = run_cell(n, idx[CELLS[n].index], inputs, work, device,
                           geo, args.warm, keep_last=False, seed=args.seed,
                           reference=reference)
            rec["control"], rec["device"] = args.control, dev
            recs[n] = rec
            print(json.dumps(public(rec)), flush=True)
            if not rec["correct"]:
                ok = False
                log(f"FAILED: {n}: {rec['failures']}")
        if args.cell is None:
            t_dedupe = None
            try:
                t_dedupe = dedupe_wall(idx, device, work, geo)
            except Exception:       # printed as null, then exits 1
                log(traceback.format_exc())
                ok = False
            print(json.dumps(headline(recs, t_dedupe, inputs["scene"].size,
                                      dev)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
