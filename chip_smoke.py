#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of tpukit_torch on one NVIDIA card (Hopper).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and drives
the port's main path, bench.py's canonical pair, through its own CLI:

  0. the card: CUDA must be present; prints its name and power limit;
  1. build: compiles kernels K1 (tpukit_torch/csrc/fs_table.cu) and K2
     (tpukit_torch/csrc/dwt97.cu) with nvcc, one process per source, and
     the port's host C++ runtime (the CCSDS-121 coder, the J2K tier-1
     analysis and decoder) with g++ from its sources in
     tpukit_torch/native/src, so that no build lands in a timed rep;
  2. K1 against its plain torch version on the card, exact, at the main
     paths' shapes (Case B's plan chunk and remainder, the device mode's
     (65536, 64) and (131072, 32), the packer's chunks (524288, 16),
     (327680, 16), (1048576, 8) and (655360, 8)), an odd block count, J = 1, 2, 4, 5
     and 16, values up to 2^31 - 1, a misaligned input and saturating
     input; K2 against its plain version, bit-equal and with its input
     untouched, at Case A's (4, 1024, 1024), the scene row's four batch
     shapes, one level, (2, 256, 256) with 3 levels, a non-square
     (3, 96, 160), the tile kernel alone down to windows of 3 x 5 and on
     windows smaller than one tile, and one (1, 4096, 4096) plane; then
     both timed at every main-path shape beside their bounds (CUDA
     graphs, the L2 flushed before each launch, in turns: plain, kernel,
     kernel, plain; also the kernel's time with a warm L2 and its eager
     time, the method of earlier runs);
  3. the Case B slice: ``run-codec --codec ccsds121 --rate-key none --reps 3
     --preproc none --nbit 16 --interleave bip --tile 512`` (bench.py's
     Case B command, plus --keep-bitstream to compare the stream) on
     bench.py's canonical 180×512×512 int16 tile; checks that the sweep
     launched K1 at least once per plan chunk, that its plan equals the
     plain CPU plan, that its stream equals the serial C++ coder's (pinned
     byte-exact to libaec by tests/test_ccsds121.py), and that every rep
     is lossless;
  4. the metric pass on a lossy recon of the same tile, on the card and on
     the CPU (exact integers and ERR8 maps; PSNR/SSIM within rel 1e-4,
     SAM/SID/LMSE within rel 1e-3: float32 sums in another order);
  5. the Case A slice: ``run-codec --codec j2k --rate-key quality --rates 1
     2 4 6 8 10 15 20 25 30 35 40 60 100 --reps 3 --keep-bitstream``
     (bench.py's Case A command) on bench.py's two 1024²×4 uint16 12-in-16
     tiles; checks that the sweep launched K2 for both tiles' pricing, that
     the byte targets it priced on the card equal the plain version's on
     the CPU exactly, that every point's streams fit its target, and that
     rep 1's recon.tif equals the JPEG 2000 decoder's output of its kept
     .j2c streams;
  6. the J2K device fast mode (``--entropy device``): (a) bench.py's ``j2k_device_tiled1024`` scene row, ``run-codec --codec
     j2k --entropy device --rate-key quality --rates 40 --reps 1 --tilex
     1024 --tiley 1024 --no-artifacts``, on bench.py's 2000×10000×4
     12-in-16 scene: K2 launched as kernels.dwt97.plan schedules every tile
     batch and K1 for every
     tile and point, one CSV row with a finite PSNR, and on the scene's
     right-hand 2000×1808 crop (all four tile shapes) the codec's bytes
     and recons on the card equal to the plain CPU run's; the row is run a
     second time under ``torch.profiler`` for its device-busy share;
     (b) the untiled device ladder (bench.py's Case A command with
     ``--entropy device`` and without ``--keep-bitstream``) on the two
     1024²×4 tiles: on the HC tile, the CSV's bytes and rep 1's recon.tif
     at three qualities equal the plain CPU run's; (c) the reversible
     point ``--rate-key none --entropy device`` on the HC tile: lossless,
     and bytes equal to the plain CPU run's; (d) a ``--rate-fit`` bpp
     point on the HC tile's 512² corner: within its byte budget, bytes and
     recon equal to the plain CPU run's;
  7. the other lossless codecs of Case B, on phase 3's tile: (a) the
     on-device CCSDS-121 packer alone, ``ccsds121.encode_device`` on the
     card for the anchor's flat stream (J = 8, rsi = 2, preprocessor on)
     and for CCSDS-123's mapped residuals (J = 16, rsi = 64, preprocessor
     off): bytes equal to the serial C++ coder's and to ``encode_device``
     on the CPU, ``decode_to_device`` back to the samples, K1 launched once
     per packed chunk; (b) ``run-codec --codec ccsds123 --rate-key none
     --reps 3 --keep-bitstream``: every rep lossless, the kept stream equal
     to the CPU run's byte for byte and decoded by the host path back to
     the tile, fewer bytes than phase 3's CCSDS-121 stream, K1 launched
     once per packed chunk; a small uint16 tile, whole and tiled, lossless
     through the same CLI; the codec's stages timed one by one, and one
     more rep under ``torch.profiler`` for the device-busy share; (c) the
     host codecs through the same CLI, one rep each: ``--codec ccsds123
     --predictor standard``, ``--codec jpegls`` (lossless, and
     ``--rate-key nearlossless_eps --rates 2`` with max|Δ| <= 2) and
     ``--codec png``. Phases 3 and 6 must have run no per-block clamp scan
     (only the packer needs it).

Every phase raises on failure. Logs each phase's checks and timings to
stderr; prints a kernels JSON line, the card line from nvidia-smi and,
last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX and
nothing of tpukit: the input recipes are copies of bench.py's.
"""

import csv
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpukit_torch.cli.main import run_codec_main
from tpukit_torch.codecs import ccsds121 as model
from tpukit_torch.codecs.ccsds121_codec import flat_stream
from tpukit_torch import native
from tpukit_torch.codecs import ccsds123_codec, j2k_codec
from tpukit_torch.codecs.base import RateSpec
from tpukit_torch.codecs.ccsds123_codec import CCSDS123Codec
from tpukit_torch.codecs.j2k_codec import J2KCodec
from tpukit_torch.device import resolve_device
from tpukit_torch.io import manifest, tiff
from tpukit_torch.io.jp2 import JP2Decoder
from tpukit_torch.kernels import build
from tpukit_torch.native import ccsds121_host
from tpukit_torch.kernels.dwt97 import TAIL_MAX, dwt97, dwt97_ref, plan
from tpukit_torch.kernels.fs_table import fs_table, fs_table_ref
from tpukit_torch.sweep import runner

BANDS, SIZE = 180, 512
PLAN_CHUNK = 1 << 22
RATES_A = [1, 2, 4, 6, 8, 10, 15, 20, 25, 30, 35, 40, 60, 100]
SCENE_TILE = 1024
QUALITIES_HELD = (1, 40, 100)    # points of phase 6b held against the CPU
PACK_CHUNK = 1 << 23             # encode_device's default chunk, in samples


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores


_FLUSH = {}


def l2_flush():
    """Writes 64 MiB, more than the card's 50 MB L2, so that the next
    launch finds its input in device memory."""
    buf = _FLUSH.get("buf")
    if buf is None:
        buf = _FLUSH["buf"] = torch.empty(16 << 20, dtype=torch.float32,
                                          device="cuda")
    buf.zero_()


def graph_ms(fn, iters: int, cold: bool = False) -> float:
    """Device time of one fn() in ms: ``iters`` calls captured in a CUDA
    graph, two replays timed with CUDA events. The graph takes the host's
    launch cost out, which for a launch of a few microseconds exceeds the
    kernel's own time. ``cold``: an L2 flush before every call, its own
    time (a graph of flushes alone) subtracted."""
    def replay_ms(body):
        body()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                body()
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (2 * iters)

    if not cold:
        return replay_ms(fn)

    def flushed():
        l2_flush()
        fn()
    return replay_ms(flushed) - replay_ms(l2_flush)


def eager_ms(fn, iters: int = 50) -> float:
    """Mean time of fn() over ``iters`` eager calls between two CUDA
    events, warm: the method of the earlier runs, where the host's launch
    cost sets the pace of a launch of a few microseconds."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(fn_kernel, fn_plain, iters, plain_iters):
    """(kernel ms, plain ms), each the mean of two timings with a cold L2
    taken in turns: plain, kernel, kernel, plain."""
    p1 = graph_ms(fn_plain, plain_iters, cold=True)
    k1 = graph_ms(fn_kernel, iters, cold=True)
    k2 = graph_ms(fn_kernel, iters, cold=True)
    p2 = graph_ms(fn_plain, plain_iters, cold=True)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, ops: float):
    """(bound ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_row(shape, fn_kernel, fn_plain, iters, plain_iters, bounded, card,
              note=""):
    """Times the kernel and its plain version at one shape, beside the
    bound; also the kernel's eager time, comparable with earlier runs."""
    ms, plain_ms = time_pair(fn_kernel, fn_plain, iters, plain_iters)
    warm = graph_ms(fn_kernel, iters)
    eager = eager_ms(fn_kernel)
    bound_ms, bound_by = bounded
    log(f"  {shape}: kernel {ms:.5f} ms (L2 warm {warm:.5f} ms{note}, eager "
        f"{eager:.5f} ms), plain torch {plain_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({100 * bound_ms / ms:.1f}% of it) on {card}")
    return {"shape": list(shape), "ms": ms, "warm_ms": warm,
            "eager_ms": eager, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms}


def check_fs_table(dev, card):
    """Phase 2, K1: fs_table == plain version on the card, exactly, then
    timed at the main paths' shapes: Case B's plan chunk (524288, 8), the
    device mode's dense (65536, 64) and sparse (131072, 32) Rice tables,
    and the packer's chunks and remainders for J = 16 and J = 8. Returns
    (max_abs_err, [timed rows])."""
    g = torch.Generator(device=dev).manual_seed(2026)

    def rand(nb, J, hi=65536):
        return torch.randint(0, hi, (nb, J), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def mapped(nb, J):
        # zigzag-mapped coefficients: magnitudes spread over 16 bits
        return rand(nb, J) >> rand(nb, J, 16)

    misaligned = torch.empty(100003 * 8 + 1, dtype=torch.int32, device=dev)
    misaligned[1:] = rand(100003, 8).reshape(-1)
    cases = {
        "path chunk (524288, 8)": rand(524288, 8),
        "path remainder (131072, 8)": rand(131072, 8),
        "device dense (65536, 64)": mapped(65536, 64),
        "device sparse (131072, 32)": mapped(131072, 32),
        "pack chunk J=16 (524288, 16)": mapped(524288, 16),
        "pack remainder J=16 (327680, 16)": mapped(327680, 16),
        "pack chunk J=8 (1048576, 8)": rand(1048576, 8),
        "pack remainder J=8 (655360, 8)": rand(655360, 8),
        "odd block count (100003, 8)": rand(100003, 8),
        "J=16 (262144, 16)": rand(262144, 16),
        "J=5 (4099, 5)": rand(4099, 5),
        "J=4 (4099, 4)": rand(4099, 4),
        "J=2 (4099, 2)": rand(4099, 2),
        "J=1 (4099, 1)": rand(4099, 1),
        "values to 2^31-1 (65536, 64)": rand(65536, 64, 1 << 31),
        "values to 2^25 (131072, 8)": rand(131072, 8, 1 << 25),
        "misaligned rows (100003, 8)": misaligned[1:].view(100003, 8),
        "saturating 65535 (524288, 8)": torch.full((524288, 8), 65535,
                                                   dtype=torch.int32,
                                                   device=dev),
    }
    worst = 0
    for name, x in cases.items():
        got, want = fs_table(x), fs_table_ref(x)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 != plain at {name}: max|err| {err}")
        log(f"[K1] {name}: equal")
    log("[K1] times (CUDA graphs, L2 flushed before each launch; warm: the "
        "16.8 MB inputs stay in the 50 MB L2):")
    rows = []
    for name in ("device dense (65536, 64)", "device sparse (131072, 32)",
                 "path chunk (524288, 8)", "pack chunk J=16 (524288, 16)",
                 "pack remainder J=16 (327680, 16)",
                 "pack chunk J=8 (1048576, 8)",
                 "pack remainder J=8 (655360, 8)"):
        x = cases[name]
        nb, J = x.shape
        rows.append(timed_row((nb, J), lambda: fs_table(x),
                              lambda: fs_table_ref(x), 50, 10,
                              bound(4 * nb * (J + 14), 0), card,
                              ", input in L2"))
    return worst, rows


def check_dwt97(dev, card):
    """Phase 2, K2: dwt97 == plain version on the card, bit for bit, and
    its input untouched, then timed at the main paths' shapes: Case A's
    (4, 1024, 1024) and the scene row's batches. Returns (max_abs_err,
    [timed rows])."""
    g = torch.Generator(device=dev).manual_seed(2026)

    def rand(shape):
        # 12-in-16 samples, as the Case A tiles hold
        return (torch.randint(0, 4096, shape, generator=g, device=dev,
                              dtype=torch.int32) << 4).to(torch.float32)

    cases = {"path (4, 1024, 1024) L5": ((4, 1024, 1024), 5, TAIL_MAX),
             "scene batch (32, 1024, 1024) L5": ((32, 1024, 1024), 5,
                                                 TAIL_MAX),
             "scene batch (32, 992, 1024) L5": ((32, 992, 1024), 5,
                                                TAIL_MAX),
             "scene edge (4, 1024, 800) L5": ((4, 1024, 800), 5, TAIL_MAX),
             "scene corner (4, 992, 800) L5": ((4, 992, 800), 5, TAIL_MAX),
             "one level (4, 1024, 1024) L1": ((4, 1024, 1024), 1, TAIL_MAX),
             "(2, 256, 256) L3": ((2, 256, 256), 3, TAIL_MAX),
             "non-square (3, 96, 160) L5": ((3, 96, 160), 5, TAIL_MAX),
             "tile kernel down to 3x5 windows (3, 96, 160) L5":
                 ((3, 96, 160), 5, 0),
             "windows smaller than a tile (2, 40, 48) L2": ((2, 40, 48), 2,
                                                            0),
             "large plane (1, 4096, 4096) L5": ((1, 4096, 4096), 5,
                                                TAIL_MAX)}
    worst = 0.0
    for name, (shape, levels, tail_max) in cases.items():
        x = rand(shape)
        x0 = x.clone()
        got, want = dwt97(x, levels, tail_max), dwt97_ref(x, levels)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"K2 != plain at {name}: max|err| {err}")
        if not torch.equal(x, x0):
            raise AssertionError(f"K2 wrote into its input at {name}")
        log(f"[K2] {name}: equal, input untouched")
    log("[K2] times (CUDA graphs, L2 flushed before each launch; warm: "
        "inputs under 50 MB stay in L2):")
    rows = []
    for shape in ((4, 1024, 1024), (32, 1024, 1024), (32, 992, 1024),
                  (4, 1024, 800), (4, 992, 800)):
        x = rand(shape)
        n = x.numel()
        # 14 rounded float32 operations a sample and level (a pass: four
        # lifting steps of 3 a pair, one scaling), over the 4/3 of the
        # samples that the levels together transform
        note = ", input in L2" if 4 * n < 50e6 else ""
        rows.append(timed_row(shape, lambda: dwt97(x, 5),
                              lambda: dwt97_ref(x, 5), 10, 3,
                              bound(8 * n, 14 * n * 4 / 3), card, note))
    # where the time goes at (32, 1024, 1024): each launch's device span,
    # beside a device copy of the same tensor (what moving its bytes once
    # each way costs on this card)
    from torch.profiler import ProfilerActivity, profile
    x = rand((32, 1024, 1024))
    dwt97(x, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dwt97(x, 5)
        x.clone()
        torch.cuda.synchronize()
    spans = [(e.name.replace("(anonymous namespace)::", "").split("(")[0],
              e.time_range.elapsed_us()) for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    log(f"[K2] (32, 1024, 1024) L5 launches, device µs (profiler): "
        f"{', '.join(f'{n} {us:.2f}' for n, us in spans)} on {card}")
    return worst, rows


def make_caseb_cube(rng, bands=180, size=512):
    """bench.py's canonical Case B tile, by its recipe (bench.py:57-69):
    shared spatial texture x smooth spectral gains + noise, 14-in-16
    int16."""
    base = rng.normal(0, 1, (size, size))
    k = np.ones(9) / 9.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    spatial = (500 + 6000 * base)
    gains = 0.6 + 0.8 * np.abs(np.sin(np.linspace(0.3, 5.8, bands)))[:, None, None]
    cube = spatial[None] * gains + rng.normal(0, 12, (bands, size, size))
    cube = np.clip(cube, -8192, 8191).astype(np.int16)
    return ((cube.view(np.uint16) >> 2) << 2).view(np.int16)


def make_casea_tiles(rng):
    """bench.py's two canonical Case A tiles (HC, LC), by its recipe
    (bench.py:72-81): 1024²×4 uint16, 12-in-16."""
    gy, gx = np.mgrid[0:1024, 0:1024]
    base = ((800 + 2.5 * gy + 1.5 * gx).astype(np.int32)) % 4096
    tiles = {}
    for tid, amp in (("HC", 400), ("LC", 40)):
        t = np.clip(base[None] + rng.integers(-amp, amp, (4, 1024, 1024)),
                    0, 4095).astype(np.uint16) << 4
        tiles[tid] = t.astype(np.uint16)
    return tiles


def write_caseb_index(work: Path, cube: np.ndarray, name="caseB") -> Path:
    src = work / f"{name}_tile.tif"
    tiff.write_geotiff(src, cube, blockxsize=512, blockysize=512)
    idx = work / f"index_{name}.json"
    manifest.write_manifest(idx, "caseB", "tile_512",
                            [{"tile_id": "T01", "path": src}])
    return idx


def run_slice(work: Path, cube: np.ndarray, card: str):
    """Phase 3: the Case B anchor sweep through the port's CLI on CUDA;
    returns K1's launch count in the sweep and the stream's bytes."""
    idx = write_caseb_index(work, cube)

    plans = []
    encode_plan = model.encode_plan

    def recording_plan(*a, **kw):
        plans.append(encode_plan(*a, **kw))
        return plans[-1]

    model.encode_plan = recording_plan
    try:
        fs_table.launches = 0
        t0 = time.perf_counter()
        res = run_codec_main([
            "--indices", str(idx), "--codec", "ccsds121",
            "--rate-key", "none", "--reps", "3", "--outdir", str(work / "runs"),
            "--preproc", "none", "--nbit", "16", "--interleave", "bip",
            "--tile", "512", "--keep-bitstream", "--device", "cuda"])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = fs_table.launches
    finally:
        model.encode_plan = encode_plan

    nchunks = -(-BANDS * SIZE * SIZE // PLAN_CHUNK)
    if launches != nchunks:
        raise AssertionError(f"K1 launched {launches} times, expected "
                             f"{nchunks} (one per plan chunk, planned once)")
    if len(plans) != 1 or plans[0] is None:
        raise AssertionError(f"expected one chunked plan, got {plans}")

    # the sweep's CUDA plan == the plain plan from the same stream on the CPU
    flat_cpu = flat_stream(torch.from_numpy(cube), 0, 0, SIZE, SIZE, "none",
                           "bip")
    t0 = time.perf_counter()
    plan_cpu = model.encode_plan(flat_cpu, chunk=PLAN_CHUNK)
    log(f"[slice] plain CPU plan in {time.perf_counter() - t0:.1f} s")
    if plans[0] != plan_cpu:
        raise AssertionError("CUDA plan != plain CPU plan")

    # the stream == the monolithic serial coder's
    flat = np.moveaxis(cube.view(np.uint16), 0, -1).ravel()
    serial = ccsds121_host.encode(flat, 16, 8, 2)
    rows = list(csv.DictReader(open(work / "runs" / "metrics.csv",
                                    newline=""), delimiter=";"))
    if len(rows) != 3:
        raise AssertionError(f"expected 3 rows, got {len(rows)}")
    for rep, row in enumerate(rows, 1):
        rep_dir = work / "runs" / "T01" / "norate" / f"rep_{rep:02d}"
        stream = (rep_dir / "bit" / "t_x00000_y00000.aec").read_bytes()
        if stream != serial:
            raise AssertionError(f"rep {rep}: stream != serial coder")
        if (row["lossless"], row["max_abs_err"]) != ("1", "0"):
            raise AssertionError(f"rep {rep}: not lossless: {row}")
        if int(row["bitstream_bytes"]) != len(serial):
            raise AssertionError(f"rep {rep}: bitstream_bytes mismatch")
    with tiff.open(work / "runs" / "T01" / "norate" / "rep_01"
                   / "recon.tif") as ds:
        if not np.array_equal(ds.read(), cube):
            raise AssertionError("recon.tif != input tile")

    reps = [{k: float(r[k].replace(",", ".")) for k in
             ("t_comp_s", "t_dec_s", "t_wrap_s")} for r in rows]
    for i, r in enumerate(reps, 1):
        log(f"[slice] rep {i}: t_comp {r['t_comp_s']:.3f} s, t_dec "
            f"{r['t_dec_s']:.3f} s, t_wrap {r['t_wrap_s']:.3f} s on {card}")
    log(f"[slice] sweep wall {sweep_s:.2f} s, phases {res['phases']}, "
        f"{launches} K1 launches, {len(serial)} B stream, hbm peak "
        f"{rows[0].get('hbm_peak_mb')} MiB on {card}")
    return launches, len(serial)


def metric_pass(device, cube, lanes, valid):
    """The runner's device pass (dispatch + finalize) on one device."""
    ref = torch.from_numpy(cube).to(device)
    vm = torch.from_numpy(valid).to(device)
    chunks = runner._device_pass_dispatch(
        device, ref, vm, vm, lanes, runner._metric_chunk(*cube.shape), 0.0,
        False, True, src_valid=valid, ql_caps=(255, 40), ref_host=cube)
    met, e8, _ = runner._device_pass_finalize(chunks, 8191, True)
    return met, e8


def check_metrics(cube, dev, card):
    """Phase 4: lossy metric pass, CUDA against the port's CPU path."""
    rng = np.random.default_rng(7)
    lanes = [np.clip(cube.astype(np.int32) + rng.integers(-a, a + 1, cube.shape),
                     -8192, 8191).astype(np.int16) for a in (6, 300)]
    valid = np.ones(cube.shape[1:], bool)
    valid[:16] = False
    t0 = time.perf_counter()
    met_cuda, e8_cuda = metric_pass(dev, cube, lanes, valid)
    cuda_s = time.perf_counter() - t0
    met_cpu, e8_cpu = metric_pass(torch.device("cpu"), cube, lanes, valid)
    worst = {"quality": 0.0, "spectral": 0.0}
    for mc, mp in zip(met_cuda, met_cpu):
        for k, want in mp.items():
            got = mc[k]
            if k in ("max_abs_err", "lossless") or k.startswith("maxerr_b"):
                if got != want:
                    raise AssertionError(f"{k}: {got} != {want}")
                continue
            kind, tol = (("spectral", 1e-3) if k in ("sam_deg", "sid", "lmse")
                         else ("quality", 1e-4))
            rel = abs(got - want) / max(abs(want), 1e-12)
            if not (math.isfinite(got) and rel <= tol):
                raise AssertionError(f"{k}: {got} vs {want} (rel {rel:.2e})")
            worst[kind] = max(worst[kind], rel)
    for a, b in zip(e8_cuda, e8_cpu):
        if not np.array_equal(a, b):
            raise AssertionError("ERR8 maps differ between CUDA and CPU")
    log(f"[metrics] CUDA == CPU: max rel err PSNR/SSIM {worst['quality']:.2e}, "
        f"SAM/SID/LMSE {worst['spectral']:.2e}; CUDA pass {cuda_s:.2f} s "
        f"(host clock, 2 lanes) on {card}")


def run_casea(work: Path, tiles, card: str):
    """Phase 5: the Case A quality ladder through the port's CLI on CUDA;
    returns K2's launch count in the sweep."""
    items = []
    for tid, t in tiles.items():
        p = work / f"caseA_tile_{tid}_12in16.tif"
        tiff.write_geotiff(p, t, blockxsize=512, blockysize=512)
        items.append({"tile_id": tid, "path": p})
    idx = work / "index_caseA.json"
    manifest.write_manifest(idx, "caseA", "tile_1024", items)

    priced = []
    price = J2KCodec._price_targets

    def recording(self, cube, qual_specs, device_cube=None):
        wait = price(self, cube, qual_specs, device_cube)

        def recorded_wait():
            targets = wait()
            priced.append((cube, dict(qual_specs), device_cube.device,
                           targets))
            return targets
        return recorded_wait

    J2KCodec._price_targets = recording
    try:
        dwt97.launches = 0
        t0 = time.perf_counter()
        res = run_codec_main([
            "--indices", str(idx), "--codec", "j2k",
            "--rate-key", "quality", "--rates", *map(str, RATES_A),
            "--reps", "3", "--outdir", str(work / "runsA"),
            "--keep-bitstream", "--device", "cuda"])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = dwt97.launches
    finally:
        J2KCodec._price_targets = price

    per_tile = len(plan(1024, 1024, 5))
    if launches < per_tile * len(tiles):
        raise AssertionError(f"K2 launched {launches} times, expected >= "
                             f"{per_tile * len(tiles)} ({per_tile} a tile)")
    if len(priced) != len(tiles):
        raise AssertionError(f"expected one pricing per tile, got "
                             f"{len(priced)}")
    # the card's targets == the plain version's on the CPU, exactly
    t0 = time.perf_counter()
    for cube, qual_specs, where, targets in priced:
        if where.type != "cuda":
            raise AssertionError(f"pricing ran on {where}, not on the card")
        cpu = J2KCodec()._price_targets(cube, qual_specs)()
        if cpu != targets:
            raise AssertionError(f"CUDA-priced targets {targets} != "
                                 f"CPU-priced {cpu}")
    log(f"[caseA] CUDA targets == plain CPU targets for {len(priced)} tiles "
        f"(CPU pricing {time.perf_counter() - t0:.1f} s)")
    # one tile's pricing on the card, warm: CUDA events around the enqueue
    # of the DWT and the 14-point ladder and the copy of the sizes
    cube, qual_specs, _, _ = priced[0]
    dc = torch.from_numpy(cube).to("cuda")
    codec = J2KCodec()
    codec._price_targets(cube, qual_specs, dc)()
    spans = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wait = codec._price_targets(cube, qual_specs, dc)
        end.record()
        wait()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    log(f"[caseA] pricing one tile on the card: "
        f"{', '.join(f'{ms:.1f}' for ms in spans)} ms (CUDA events, "
        f"{len(qual_specs)} points) on {card}")

    rows = list(csv.DictReader(open(work / "runsA" / "metrics.csv",
                                    newline=""), delimiter=";"))
    per_tile = {tid: [r for r in rows if r["tile_id"] == tid]
                for tid in tiles}
    target_of = {}
    for cube, qual_specs, _, targets in priced:
        tid = next(t for t, c in tiles.items() if np.array_equal(c, cube))
        for i, spec in qual_specs.items():
            target_of[tid, int(spec.value)] = targets[i]
    for tid, trows in per_tile.items():
        if len(trows) != 3 * len(RATES_A):
            raise AssertionError(f"{tid}: {len(trows)} rows, expected "
                                 f"{3 * len(RATES_A)}")
        for r in trows:
            bs, q = int(r["bitstream_bytes"]), int(r["rate_value"])
            if bs > target_of[tid, q]:
                raise AssertionError(f"{tid} q={q}: {bs} B over the target "
                                     f"{target_of[tid, q]}")
    # rep 1's recon == the decoder's output of its kept streams
    for tid in tiles:
        for q in RATES_A:
            rep = work / "runsA" / tid / f"quality_{q}" / "rep_01"
            with tiff.open(rep / "recon.tif") as ds:
                recon = ds.read()
            for b in range(recon.shape[0]):
                dec = JP2Decoder((rep / "bit" / f"b{b + 1:02d}.j2c")
                                 .read_bytes()).decode_component(0, 0, 0)
                dec = np.clip(dec, 0, 65535).astype(np.uint16)
                if not np.array_equal(dec, recon[b]):
                    raise AssertionError(f"{tid} q={q} band {b + 1}: "
                                         f"recon.tif != decoded stream")
    log(f"[caseA] {len(rows)} rows; every point within its target; rep 1 "
        f"recons == decoded .j2c streams")

    for tid, trows in per_tile.items():
        for k in range(0, len(trows), 3):       # rate outer, rep inner
            reps = trows[k:k + 3]
            log(f"[caseA] {tid} q={reps[0]['rate_value']}: "
                f"{reps[0]['bitstream_bytes']} B, psnr "
                f"{reps[0].get('psnr_global')}; t_comp_s "
                f"{[r['t_comp_s'] for r in reps]}, t_dec_s "
                f"{[r['t_dec_s'] for r in reps]}")
    log(f"[caseA] sweep wall {sweep_s:.2f} s, phases {res['phases']}, "
        f"{launches} K2 launches, hbm peak {rows[0].get('hbm_peak_mb')} MiB "
        f"on {card}")
    return launches


def read_rows(path: Path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter=";"))


def num(s: str) -> float:
    return float(s.replace(",", "."))


def make_scene(rng):
    """bench.py's 2000×10000×4 uint16 12-in-16 Case A scene, by its recipe
    (bench.py:415-420)."""
    gy, gx = np.mgrid[0:2000, 0:10000]
    sbase = ((700 + 1.1 * gy + 0.7 * gx).astype(np.int32)) % 4096
    return (np.clip(sbase[None] + rng.integers(-300, 300, (4, 2000, 10000)),
                    0, 4095).astype(np.uint16) << 4).astype(np.uint16)


def tile_counts(H: int, W: int, t: int):
    """{(th, tw): number of tiles} of a t×t tiling."""
    counts = {}
    for y0 in range(0, H, t):
        for x0 in range(0, W, t):
            s = (min(t, H - y0), min(t, W - x0))
            counts[s] = counts.get(s, 0) + 1
    return counts


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


def run_scene(work: Path, scene: np.ndarray, dev, card):
    """Phase 6a: bench.py's j2k_device_tiled1024 scene row through the
    port's CLI on CUDA; returns (K1, K2) launch counts of the row."""
    src = work / "caseA_scene_12in16.tif"
    t0 = time.perf_counter()
    tiff.write_geotiff(src, scene, blockxsize=512, blockysize=512)
    idx = work / "index_scene.json"
    manifest.write_manifest(idx, "caseA", "scene",
                            [{"tile_id": "sceneA", "path": src}])
    log(f"[scene] wrote the {scene.shape} scene in "
        f"{time.perf_counter() - t0:.1f} s")
    argv = ["--indices", str(idx), "--codec", "j2k", "--entropy", "device",
            "--rate-key", "quality", "--rates", "40", "--reps", "1",
            "--tilex", str(SCENE_TILE), "--tiley", str(SCENE_TILE),
            "--no-artifacts", "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs_table.launches = 0
    dwt97.launches = 0
    t0 = time.perf_counter()
    res = run_codec_main(argv + ["--outdir", str(work / "runsS")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fs_table.launches, dwt97.launches

    counts = tile_counts(*scene.shape[1:], SCENE_TILE)
    n_tiles = sum(counts.values())
    n_batches = sum(-(-n // j2k_codec._TILE_BATCH) for n in counts.values())
    # one transform per batch of tiles of one shape, padded to the 32 grid
    want_k2 = sum(-(-n // j2k_codec._TILE_BATCH)
                  * len(plan(th + (-th) % 32, tw + (-tw) % 32, 5))
                  for (th, tw), n in counts.items())
    if k2 != want_k2:
        raise AssertionError(f"K2 launched {k2} times, expected {want_k2} "
                             f"({n_batches} tile batches)")
    if k1 != 3 * n_tiles:
        raise AssertionError(f"K1 launched {k1} times, expected "
                             f"{3 * n_tiles} (3 Rice sizes per tile)")
    rows = read_rows(work / "runsS" / "metrics.csv")
    if len(rows) != 1:
        raise AssertionError(f"expected one scene row, got {len(rows)}")
    row = rows[0]
    psnr = num(row["psnr_global"])
    if row["lossless"] != "0" or not math.isfinite(psnr):
        raise AssertionError(f"scene row: lossless {row['lossless']}, "
                             f"psnr {row['psnr_global']}")
    log(f"[scene] row: {row['bitstream_bytes']} B, psnr {psnr}, t_comp_s "
        f"{row['t_comp_s']}, t_dec_s {row['t_dec_s']}, hbm peak "
        f"{row.get('hbm_peak_mb')} MiB; {n_tiles} tiles in {n_batches} "
        f"batches {counts}; {k1} K1 and {k2} K2 launches")
    log(f"[scene] row wall {wall:.2f} s, phases {res['phases']} on {card}")

    # the row again, traced, for its device-busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_codec_main(argv + ["--outdir", str(work / "runsS2")])
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    busy = busy_ms(prof)
    log(f"[scene] traced row wall {traced:.2f} s, device busy {busy:.1f} ms "
        f"({100.0 * busy / (1000.0 * traced):.2f}% busy"
        + (", no device events traced: not measured" if busy == 0 else "")
        + f") on {card}")
    avgs = prof.key_averages()
    sort = ("self_device_time_total" if avgs and hasattr(
        avgs[0], "self_device_time_total") else "self_cuda_time_total")
    log(avgs.table(sort_by=sort, row_limit=12, max_name_column_width=48))

    # the right-hand 2000×1808 crop, every tile shape: card == plain CPU
    crop = np.ascontiguousarray(scene[:, :, 8 * SCENE_TILE:])
    if len(tile_counts(*crop.shape[1:], SCENE_TILE)) != 4:
        raise AssertionError("the crop does not hold all four tile shapes")
    spec = [RateSpec.of("quality", 40)]
    t0 = time.perf_counter()
    got = J2KCodec(SCENE_TILE, SCENE_TILE, entropy="device").sweep_rates(
        crop, "uint16", spec, device_cube=torch.from_numpy(crop).to(dev))[0]
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = J2KCodec(SCENE_TILE, SCENE_TILE, entropy="device").sweep_rates(
        crop, "uint16", spec)[0]
    cpu_s = time.perf_counter() - t0
    if got.recon.device.type != "cuda":
        raise AssertionError(f"the crop's recon is on {got.recon.device}")
    if got.bitstream_bytes != want.bitstream_bytes:
        raise AssertionError(f"crop bytes: CUDA {got.bitstream_bytes} != "
                             f"CPU {want.bitstream_bytes}")
    if not torch.equal(got.recon.cpu(), want.recon):
        raise AssertionError("crop recon: CUDA != CPU")
    log(f"[scene] crop {crop.shape}: CUDA == plain CPU ({got.bitstream_bytes}"
        f" B, recon equal); CUDA {cuda_s:.2f} s, CPU {cpu_s:.2f} s")

    # the codec alone on the scene, for the row's breakdown: its wall and
    # device-memory peak above the upload, and the host scan of the peak
    # sample that each device-mode entry makes first
    t0 = time.perf_counter()
    np.abs(scene.astype(np.float64)).max()
    scan_s = time.perf_counter() - t0
    dc = torch.from_numpy(scene).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    J2KCodec(SCENE_TILE, SCENE_TILE, entropy="device").sweep_rates(
        scene, "uint16", spec, device_cube=dc)
    torch.cuda.synchronize()
    codec_s = time.perf_counter() - t0
    codec_mb = (torch.cuda.max_memory_allocated() - held) / (1 << 20)
    log(f"[scene] codec alone: {codec_s:.3f} s, device memory peak "
        f"{codec_mb:.1f} MiB above the {held / (1 << 20):.1f} MiB upload; "
        f"host peak-sample scan {scan_s:.3f} s on {card}")
    return k1, k2


def write_index(work: Path, tiles, name: str) -> Path:
    items = []
    for tid, t in tiles.items():
        p = work / f"caseA_tile_{tid}_12in16.tif"
        if not p.exists():
            tiff.write_geotiff(p, t, blockxsize=512, blockysize=512)
        items.append({"tile_id": tid, "path": p})
    idx = work / f"index_{name}.json"
    manifest.write_manifest(idx, "caseA", "tile_1024", items)
    return idx


def run_device_ladder(work: Path, tiles, card):
    """Phase 6b: the untiled device-mode quality ladder through the port's
    CLI on CUDA; returns (K1, K2) launch counts of the sweep."""
    idx = write_index(work, tiles, "ladder")
    fs_table.launches = 0
    dwt97.launches = 0
    t0 = time.perf_counter()
    res = run_codec_main([
        "--indices", str(idx), "--codec", "j2k", "--entropy", "device",
        "--rate-key", "quality", "--rates", *map(str, RATES_A),
        "--reps", "3", "--outdir", str(work / "runsD"), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fs_table.launches, dwt97.launches
    # one DWT per tile (kept across reps), three Rice sizes per point
    if k2 != len(plan(1024, 1024, 5)) * len(tiles):
        raise AssertionError(f"K2 launched {k2} times, expected "
                             f"{len(plan(1024, 1024, 5)) * len(tiles)}")
    if k1 != 3 * len(RATES_A) * 3 * len(tiles):
        raise AssertionError(f"K1 launched {k1} times, expected "
                             f"{3 * len(RATES_A) * 3 * len(tiles)}")
    rows = read_rows(work / "runsD" / "metrics.csv")
    if len(rows) != 3 * len(RATES_A) * len(tiles):
        raise AssertionError(f"{len(rows)} rows")
    for r in rows:
        if r["lossless"] != "0" or not math.isfinite(num(r["psnr_global"])):
            raise AssertionError(f"bad row {r}")

    t0 = time.perf_counter()
    cpu = J2KCodec(entropy="device").sweep_qualities(tiles["HC"],
                                                     QUALITIES_HELD)
    cpu_s = time.perf_counter() - t0
    for q, want in zip(QUALITIES_HELD, cpu):
        got = [int(r["bitstream_bytes"]) for r in rows
               if r["tile_id"] == "HC" and int(r["rate_value"]) == q]
        if got != [want.bitstream_bytes] * 3:
            raise AssertionError(f"HC q={q}: CUDA bytes {got} != CPU "
                                 f"{want.bitstream_bytes}")
        with tiff.open(work / "runsD" / "HC" / f"quality_{q}" / "rep_01"
                       / "recon.tif") as ds:
            if not np.array_equal(ds.read(), want.recon.numpy()):
                raise AssertionError(f"HC q={q}: CUDA recon != CPU recon")
    log(f"[ladder] HC at q={QUALITIES_HELD}: CUDA bytes and recon.tif == "
        f"plain CPU (CPU {cpu_s:.1f} s)")
    for tid in tiles:
        trows = [r for r in rows if r["tile_id"] == tid]
        for k in range(0, len(trows), 3):
            reps = trows[k:k + 3]
            log(f"[ladder] {tid} q={reps[0]['rate_value']}: "
                f"{reps[0]['bitstream_bytes']} B, psnr "
                f"{reps[0]['psnr_global']}; t_comp_s "
                f"{[r['t_comp_s'] for r in reps]}, t_dec_s "
                f"{[r['t_dec_s'] for r in reps]}")
    log(f"[ladder] sweep wall {wall:.2f} s, phases {res['phases']}, {k1} K1 "
        f"and {k2} K2 launches, hbm peak {rows[0].get('hbm_peak_mb')} MiB "
        f"on {card}")
    return k1, k2


def run_device_lossless(work: Path, tile: np.ndarray, card):
    """Phase 6c: the reversible device point on the HC tile through the
    port's CLI on CUDA; returns K1's launch count."""
    idx = write_index(work, {"HC": tile}, "lossless")
    fs_table.launches = 0
    t0 = time.perf_counter()
    run_codec_main([
        "--indices", str(idx), "--codec", "j2k", "--entropy", "device",
        "--rate-key", "none", "--reps", "1", "--no-artifacts",
        "--outdir", str(work / "runsL"), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = fs_table.launches
    if k1 != 3:
        raise AssertionError(f"K1 launched {k1} times, expected 3")
    (row,) = read_rows(work / "runsL" / "metrics.csv")
    want = J2KCodec(entropy="device").run(tile, "uint16", RateSpec.none())
    if (row["lossless"], row["max_abs_err"]) != ("1", "0"):
        raise AssertionError(f"not lossless: {row}")
    if int(row["bitstream_bytes"]) != want.bitstream_bytes:
        raise AssertionError(f"lossless bytes: CUDA {row['bitstream_bytes']}"
                             f" != CPU {want.bitstream_bytes}")
    log(f"[lossless] HC: {row['bitstream_bytes']} B == plain CPU, t_comp_s "
        f"{row['t_comp_s']}, t_dec_s {row['t_dec_s']}; wall {wall:.2f} s, "
        f"{k1} K1 launches on {card}")
    return k1


def run_device_rate_fit(work: Path, tile: np.ndarray, card):
    """Phase 6d: a ``--rate-fit`` bpp point (the base step bisected on the
    card against the byte budget) on the HC tile's 512² corner through
    the port's CLI on CUDA; returns K1's launch count."""
    corner = np.ascontiguousarray(tile[:, :512, :512])
    idx = write_index(work, {"HC512": corner}, "ratefit")
    bpp = 2.0
    fs_table.launches = 0
    t0 = time.perf_counter()
    run_codec_main([
        "--indices", str(idx), "--codec", "j2k", "--entropy", "device",
        "--rate-key", "bpp", "--rates", str(bpp), "--rate-fit",
        "--reps", "1", "--outdir", str(work / "runsF"), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = fs_table.launches
    # 24 bisection probes and the fitted point, three Rice sizes each
    if k1 != 3 * 25:
        raise AssertionError(f"K1 launched {k1} times, expected {3 * 25}")
    (row,) = read_rows(work / "runsF" / "metrics.csv")
    target = bpp * corner.size / 8.0
    t0 = time.perf_counter()
    want = J2KCodec(entropy="device", rate_fit=True).run(
        corner, "uint16", RateSpec.of("bpp", bpp))
    cpu_s = time.perf_counter() - t0
    got = int(row["bitstream_bytes"])
    if got != want.bitstream_bytes or got > target:
        raise AssertionError(f"rate fit: CUDA {got} B, CPU "
                             f"{want.bitstream_bytes} B, target {target}")
    (recon_tif,) = (work / "runsF" / "HC512").glob("*/rep_01/recon.tif")
    with tiff.open(recon_tif) as ds:
        if not np.array_equal(ds.read(), want.recon.numpy()):
            raise AssertionError("rate fit: CUDA recon != CPU recon")
    log(f"[rate fit] HC 512²: {got} B of a {target:.0f} B budget == plain "
        f"CPU (base step {want.extras['base_step']}, CPU {cpu_s:.1f} s), "
        f"t_comp_s {row['t_comp_s']}, t_dec_s {row['t_dec_s']}; wall "
        f"{wall:.2f} s, {k1} K1 launches on {card}")
    return k1


def pack_sizes(n: int, step: int):
    """encode_device's chunk sizes for n samples (chunks of PACK_CHUNK
    samples, which is a multiple of every ``step`` = J * rsi used here)."""
    assert PACK_CHUNK % step == 0
    return [PACK_CHUNK] * (n // PACK_CHUNK) + ([n % PACK_CHUNK]
                                               if n % PACK_CHUNK else [])


def check_packer(cube: np.ndarray, dev, card):
    """Phase 7a: the on-device CCSDS-121 packer alone, for the anchor's
    flat stream and for CCSDS-123's mapped residuals; returns K1's launch
    counts of the two packs."""
    shift = ccsds123_codec.trailing_zero_shift(cube)
    xu = (torch.from_numpy(cube).to(dev).to(torch.int32) & 0xFFFF) >> shift
    mapped, _ = ccsds123_codec.encode_model(xu)
    del xu
    streams = [
        ("anchor flat stream", flat_stream(torch.from_numpy(cube), 0, 0,
                                           SIZE, SIZE, "none", "bip"),
         dict(bits=16, J=8, rsi=2, preprocess=True)),
        ("mapped residuals", mapped.reshape(-1).cpu(),
         dict(bits=16, J=16, rsi=64, preprocess=False))]
    del mapped
    counts = []
    for name, x_cpu, kw in streams:
        x_dev = x_cpu.to(dev)
        model.encode_device(x_dev, **kw)                # warm
        torch.cuda.synchronize()
        fs_table.launches = 0
        t0 = time.perf_counter()
        bs, plan_ = model.encode_device(x_dev, return_plan=True, **kw)
        cuda_s = time.perf_counter() - t0
        k1 = fs_table.launches
        sizes = pack_sizes(x_cpu.numel(), kw["J"] * kw["rsi"])
        if plan_["sizes"] != sizes or k1 != len(sizes):
            raise AssertionError(f"{name}: K1 launched {k1} times for chunks "
                                 f"{plan_['sizes']}, expected one for each "
                                 f"of {sizes}")
        t0 = time.perf_counter()
        serial = ccsds121_host.encode(
            x_cpu.numpy().astype(np.uint16), kw["bits"], kw["J"], kw["rsi"],
            flags=ccsds121_host.FLAG_PREPROCESS if kw["preprocess"] else 0)
        serial_s = time.perf_counter() - t0
        if bs != serial:
            raise AssertionError(f"{name}: encode_device on the card != the "
                                 f"serial C++ coder")
        t0 = time.perf_counter()
        if model.encode_device(x_cpu, **kw) != bs:
            raise AssertionError(f"{name}: encode_device on the card != "
                                 f"encode_device on the CPU")
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ccsds121_host.decode_to_device(bs, plan_, dev)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        if back.device.type != "cuda" or not torch.equal(back, x_dev):
            raise AssertionError(f"{name}: decode_to_device != the samples")
        # one full chunk's pack_words, device time from CUDA events
        words = model.pack_cap_words(PACK_CHUNK, kw["bits"], kw["J"])
        k0 = torch.zeros((), dtype=torch.int32, device=dev)
        spans = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.pack_words(x_dev[:PACK_CHUNK], k0, out_words=words, **kw)
            end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end))
        # the packer's row-wise prefix sums: torch's scan of the innermost
        # axis against the same scan through the transposed view
        rows = x_dev[:PACK_CHUNK].reshape(-1, kw["J"])
        scan_ms = []
        for fn in (lambda: torch.cumsum(rows, 1),
                   lambda: model._excl_cumsum(rows, 1)):
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            torch.cuda.synchronize()
            scan_ms.append(start.elapsed_time(end) / 10)
        log(f"[packer] {name}: prefix sum along the rows of "
            f"{tuple(rows.shape)}: torch.cumsum(x, 1) {scan_ms[0]:.3f} ms, "
            f"the packer's _excl_cumsum {scan_ms[1]:.3f} ms (CUDA events, "
            f"10 calls) on {card}")
        log(f"[packer] {name}: {x_cpu.numel()} samples in {len(sizes)} chunks,"
            f" {len(bs)} B == serial C++ coder == CPU encode_device; "
            f"decode_to_device == samples; {k1} K1 launches; encode_device "
            f"on the card {cuda_s:.3f} s, on the CPU {cpu_s:.2f} s, serial "
            f"C++ {serial_s:.2f} s, decode_to_device {dec_s:.3f} s (host "
            f"clock); pack_words of one {PACK_CHUNK}-sample chunk "
            f"{', '.join(f'{ms:.2f}' for ms in spans)} ms (CUDA events) "
            f"on {card}")
        counts.append(k1)
        del x_dev, back
    return counts


def ccsds123_stages(cube: np.ndarray, dev, card):
    """The stages of one CCSDS-123 ``ls`` encode and decode of the tile on
    the card, one after the other with a synchronize between them (host
    clock): the split of t_comp_s and t_dec_s."""
    def lap(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cc = ccsds123_codec
    ent = dict(bits=16, J=16, rsi=64, preprocess=False)
    B, H, W = cube.shape
    dc = torch.from_numpy(cube).to(dev)
    for warm in (True, False):
        t = {}
        xu, t["ring view"] = lap(lambda: (dc.to(torch.int32) & 0xFFFF)
                                 >> cc.trailing_zero_shift(cube))
        (c, feats), t["row diff + features"] = lap(
            lambda: (lambda c: (c, cc._features(c)))(
                cc._signed_view(cc._row_diff_ring(xu))))
        wq, t["fit"] = lap(lambda: cc.fit_weights(feats, c))
        wq_dev = torch.from_numpy(wq.astype(np.int32)).to(dev)
        mapped, t["predict + map"] = lap(lambda: cc._zigzag(cc._signed_view(
            (c - cc._predict(feats, wq_dev)) & 0xFFFF)).reshape(-1))
        del feats, c, xu

        def pack_all():
            parts, start = [], 0
            k = torch.zeros((), dtype=torch.int32, device=dev)
            for sz in pack_sizes(mapped.numel(), 16 * 64):
                w, tb, lo, hi = model.pack_words(
                    mapped[start:start + sz], k,
                    out_words=model.pack_cap_words(sz, 16, 16), **ent)
                parts.append((w, tb))
                k = model._clip(k, lo, hi)
                start += sz
            return parts
        parts, t["pack"] = lap(pack_all)

        def fetch():
            seg_bits = torch.stack([tb for _, tb in parts]).cpu().tolist()
            return seg_bits, model._words_to_host(
                [w[:(tb + 31) // 32 + 2]
                 for (w, _), tb in zip(parts, seg_bits)])
        (seg_bits, host_words), t["fetch"] = lap(fetch)
        del parts
        (stream, plan_), t["encode_device whole"] = lap(
            lambda: model.encode_device(mapped, return_plan=True, **ent))
        t["splice (whole - pack - fetch)"] = (
            t["encode_device whole"] - t["pack"] - t["fetch"])
        back, t["host decode + upload"] = lap(
            lambda: ccsds121_host.decode_to_device(stream, plan_, dev))
        _, t["band loop + cumsum"] = lap(
            lambda: cc.decode_model(back.reshape(B, H, W), wq_dev))
        _, t["cumsum"] = lap(
            lambda: cc._row_cumsum_ring(back.reshape(B, H, W)))
        del back, mapped
    log("[ccsds123] stages, second pass (host clock, synchronized): "
        + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in t.items())
        + f" on {card}")


def run_ccsds123(work: Path, cube: np.ndarray, dev, card, anchor_bytes: int):
    """Phase 7b: the CCSDS-123 ``ls`` sweep through the port's CLI on CUDA;
    returns K1's launch count in the sweep."""
    idx = write_caseb_index(work, cube)
    argv = ["--indices", str(idx), "--codec", "ccsds123", "--rate-key",
            "none", "--keep-bitstream", "--device", "cuda"]
    B, H, W = cube.shape
    n_chunks = len(pack_sizes(cube.size, 16 * 64))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs_table.launches = 0
    t0 = time.perf_counter()
    res = run_codec_main(argv + ["--reps", "3", "--outdir",
                                 str(work / "runs123")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = fs_table.launches
    if k1 != 3 * n_chunks:
        raise AssertionError(f"K1 launched {k1} times, expected "
                             f"{3 * n_chunks} ({n_chunks} packed chunks a "
                             f"rep)")
    rows = read_rows(work / "runs123" / "metrics.csv")
    if len(rows) != 3:
        raise AssertionError(f"expected 3 rows, got {len(rows)}")

    # the same encode on the CPU (what --device cpu runs): its stream
    t0 = time.perf_counter()
    want = CCSDS123Codec().run(cube, "int16", RateSpec.none(),
                               keep_bitstream=True)
    cpu_s = time.perf_counter() - t0
    (cpu_stream,) = want.bitstreams.values()
    if not np.array_equal(want.recon.numpy(), cube):
        raise AssertionError("the CPU run is not lossless")
    for rep, row in enumerate(rows, 1):
        rep_dir = work / "runs123" / "T01" / "norate" / f"rep_{rep:02d}"
        stream = (rep_dir / "bit" / "t_x00000_y00000.bit").read_bytes()
        if stream != cpu_stream:
            raise AssertionError(f"rep {rep}: stream on the card != the "
                                 f"CPU run's")
        if (row["lossless"], row["max_abs_err"]) != ("1", "0"):
            raise AssertionError(f"rep {rep}: not lossless: {row}")
        if int(row["bitstream_bytes"]) != len(stream):
            raise AssertionError(f"rep {rep}: bitstream_bytes mismatch")
    if len(stream) >= anchor_bytes:
        raise AssertionError(f"CCSDS-123 {len(stream)} B is not below the "
                             f"anchor's CCSDS-121 {anchor_bytes} B")
    with tiff.open(work / "runs123" / "T01" / "norate" / "rep_01"
                   / "recon.tif") as ds:
        if not np.array_equal(ds.read(), cube):
            raise AssertionError("recon.tif != input tile")
    # the kept stream through the host decode path (no plan), on the CPU
    t0 = time.perf_counter()
    ring = CCSDS123Codec._decode_device(stream, B, H, W)
    host_dec_s = time.perf_counter() - t0
    if not np.array_equal(ring.numpy().astype(np.uint16).view(np.int16), cube):
        raise AssertionError("host decode of the kept stream != input tile")
    log(f"[ccsds123] 3 reps lossless; stream {len(stream)} B == the CPU "
        f"run's (CPU codec run {cpu_s:.1f} s), "
        f"{100.0 * len(stream) / anchor_bytes:.1f}% of the anchor's "
        f"{anchor_bytes} B; host decode of the kept stream == tile "
        f"({host_dec_s:.1f} s on the CPU)")
    for rep, r in enumerate(rows, 1):
        log(f"[ccsds123] rep {rep}: t_comp_s {r['t_comp_s']}, t_dec_s "
            f"{r['t_dec_s']}, t_wrap_s {r['t_wrap_s']} on {card}")
    log(f"[ccsds123] sweep wall {wall:.2f} s, phases {res['phases']}, {k1} "
        f"K1 launches, hbm peak {rows[0].get('hbm_peak_mb')} MiB (process "
        f"peak, reset before the sweep) on {card}")

    # a uint16 source (Case A's type): the recon handed to the runner is a
    # torch.uint16 tensor on the card, whole, and a host array when tiled
    u16 = make_casea_tiles(np.random.default_rng(2026))["HC"][:, :160, :128]
    idx16 = write_caseb_index(work, np.ascontiguousarray(u16), "caseB_u16")
    for tag, extra in (("whole", []), ("tiled", ["--tile", "64"])):
        out = work / f"runs123u16{tag}"
        r16 = run_codec_main(["--indices", str(idx16), "--codec", "ccsds123",
                              "--rate-key", "none", "--reps", "1", "--outdir",
                              str(out), "--device", "cuda", *extra])
        (row,) = r16["rows"]
        if (row["lossless"], row["max_abs_err"]) != (1, 0):
            raise AssertionError(f"uint16 {tag}: not lossless: {row}")
        with tiff.open(out / "T01" / "norate" / "rep_01" / "recon.tif") as ds:
            if not np.array_equal(ds.read(), u16):
                raise AssertionError(f"uint16 {tag}: recon.tif != input")
    log(f"[ccsds123] uint16 {u16.shape} tile lossless on the card, whole and "
        f"in 64² tiles")

    ccsds123_stages(cube, dev, card)

    # one more rep, traced, for its device-busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_codec_main(argv + ["--reps", "1", "--outdir",
                               str(work / "runs123t")])
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    busy = busy_ms(prof)
    log(f"[ccsds123] traced one-rep sweep wall {traced:.2f} s, device busy "
        f"{busy:.1f} ms ({100.0 * busy / (1000.0 * traced):.2f}% busy"
        + (", no device events traced: not measured" if busy == 0 else "")
        + f") on {card}")
    avgs = prof.key_averages()
    sort = ("self_device_time_total" if avgs and hasattr(
        avgs[0], "self_device_time_total") else "self_cuda_time_total")
    log(avgs.table(sort_by=sort, row_limit=12, max_name_column_width=48))
    return k1


def run_host_codecs(work: Path, cube: np.ndarray, card):
    """Phase 7c: CCSDS-123 ``standard``, JPEG-LS and PNG (host codecs; the
    metric pass runs on the card) through the port's CLI, one rep each."""
    idx = write_caseb_index(work, cube, "caseB_host")
    runs = [("ccsds123 standard", ["--codec", "ccsds123", "--predictor",
                                   "standard"], 0),
            ("jpegls", ["--codec", "jpegls"], 0),
            ("jpegls near 2", ["--codec", "jpegls", "--rate-key",
                               "nearlossless_eps", "--rates", "2"], 2),
            ("png", ["--codec", "png"], 0)]
    for i, (name, argv, max_err) in enumerate(runs):
        t0 = time.perf_counter()
        run_codec_main(["--indices", str(idx), "--reps", "1",
                        "--no-artifacts", "--outdir", str(work / f"runsH{i}"),
                        "--device", "cuda", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (row,) = read_rows(work / f"runsH{i}" / "metrics.csv")
        err = int(row["max_abs_err"])
        if max_err == 0 and (row["lossless"], err) != ("1", 0):
            raise AssertionError(f"{name}: not lossless: {row}")
        if err > max_err or (max_err and row["lossless"] != "0"):
            raise AssertionError(f"{name}: max|err| {err} > {max_err}, or "
                                 f"marked lossless: {row}")
        log(f"[host codecs] {name}: {row['bitstream_bytes']} B, max|err| "
            f"{err}, t_comp_s {row['t_comp_s']}, t_dec_s {row['t_dec_s']}; "
            f"wall {wall:.2f} s on {card}")


def main():
    # phase 0: the card
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    dev = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 1: build K1 and K2 from this checkout's sources, and the port's
    # host C++ runtime from its copy of the sources (tpukit_torch/native/src)
    t0 = time.perf_counter()
    lib = build.build_library(force=True)
    build.load()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    host_lib = native.build_library(force=True)
    native.load()
    log(f"[build] host C++ runtime {host_lib.name} (CCSDS-121 coder, J2K "
        f"tier-1 and decoder) in {time.perf_counter() - t0:.1f} s")

    # the packer's per-block clamp scan, counted: the size-only paths of
    # phases 3-6 must not run it
    scans = {"n": 0}
    scan_clamps = model._scan_clamps

    def counting_scan(lo, hi):
        scans["n"] += 1
        return scan_clamps(lo, hi)

    model._scan_clamps = counting_scan

    # phase 2: K1 and K2 against their plain versions, and their times
    k1_err, k1_rows = check_fs_table(dev, card)
    k2_err, k2_rows = check_dwt97(dev, card)

    # phase 3: the slice
    cube = make_caseb_cube(np.random.default_rng(2026), BANDS, SIZE)
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        launches, anchor_bytes = run_slice(Path(tmp), cube, card)

    # phase 4: lossy metric pass
    check_metrics(cube, dev, card)

    # phase 5: the Case A slice
    tiles = make_casea_tiles(np.random.default_rng(2026))
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        k2_launches = run_casea(Path(tmp), tiles, card)

    # phase 6: the J2K device fast mode
    t6 = time.perf_counter()
    scene = make_scene(np.random.default_rng(2026))
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        scene_k1, scene_k2 = run_scene(Path(tmp), scene, dev, card)
        del scene
        ladder_k1, ladder_k2 = run_device_ladder(Path(tmp), tiles, card)
        lossless_k1 = run_device_lossless(Path(tmp), tiles["HC"], card)
        fit_k1 = run_device_rate_fit(Path(tmp), tiles["HC"], card)
    log(f"[fast mode] phase 6 in {time.perf_counter() - t6:.1f} s")
    if scans["n"]:
        raise AssertionError(f"phases 3-6 ran the per-block clamp scan "
                             f"{scans['n']} times; only the packer needs it")

    # phase 7: the other lossless codecs of Case B
    t7 = time.perf_counter()
    pack_anchor_k1, pack_mapped_k1 = check_packer(cube, dev, card)
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        c123_k1 = run_ccsds123(Path(tmp), cube, dev, card, anchor_bytes)
        run_host_codecs(Path(tmp), cube, card)
    log(f"[caseB codecs] phase 7 in {time.perf_counter() - t7:.1f} s, "
        f"{scans['n']} clamp scans (one per packed chunk)")

    jax_loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax."))
    if jax_loaded:
        raise AssertionError(f"JAX was imported: {jax_loaded}")

    loaded = sorted(m for m in sys.modules
                    if m == "tpukit" or m.startswith("tpukit."))
    if loaded:
        raise AssertionError(f"tpukit was imported: {loaded}")

    # launches and the headline time are the device fast mode's (the scene
    # row, and the largest shape it gives each kernel); every path's count
    # and every main-path shape's time is listed too
    def entry(name, source, replaces, launches, err, rows, headline, paths):
        row = next(r for r in rows if tuple(r["shape"]) == headline)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None,
                "bound_us": 1e3 * row["bound_ms"],
                "share_of_bound": row["share_of_bound"],
                "shape": list(headline), "launches_by_path": paths,
                "times": rows}

    kernels = {"kernels": [
        entry("fs_table", "tpukit_torch/csrc/fs_table.cu",
              "tpukit/codecs/ccsds121.py:63", scene_k1, k1_err, k1_rows,
              (65536, 64),
              {"caseB_anchor": launches, "scene_row": scene_k1,
               "device_ladder": ladder_k1, "device_lossless": lossless_k1,
               "device_rate_fit": fit_k1,
               "packer_anchor_stream": pack_anchor_k1,
               "packer_mapped_residuals": pack_mapped_k1,
               "ccsds123_sweep": c123_k1}),
        entry("dwt97", "tpukit_torch/csrc/dwt97.cu",
              "tpukit/kernels/dwt_pallas.py:85", scene_k2, k2_err, k2_rows,
              (32, 1024, 1024),
              {"caseA_ebcot": k2_launches, "scene_row": scene_k2,
               "device_ladder": ladder_k2})]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
