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
     is lossless; that the band interleave and its inverse ran on the
     card: every rep's recon lane a CUDA tensor equal to the tile, the one
     host stream fetched from the card equal to the host transpose of the
     tile (computed once, untimed), and no host transpose
     (``rawio.bsq_to_interleaved``/``interleaved_to_bsq``) in the sweep;
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
     (only the packer needs it);
  8. CCSDS-122, the sixth codec, and the kept streams of the J2K device
     mode, on phase 5's two 1024²×4 tiles: (a) the BPE rate ladder,
     ``run-codec --codec ccsds122 --rate-key bpp --rates 0.5 1 2 4 16
     --reps 1 --keep-bitstream``: every kept ``.bpe`` stream as long as the
     device model says, the 16 bpp point lossless, bytes and PSNR rising
     with the rate, ``bpe122.decode_plane`` of the kept streams, inverse
     transformed on the host, equal to recon.tif, and the HC tile at 1 and
     16 bpp equal to the plain CPU run (bytes, streams, recons); its stages
     timed one by one, and the sweep once more under ``torch.profiler``;
     (b) the same with ``--entropy embedded``: ``.wbit`` lengths equal to
     the model's, the lossless ``.bit`` streams decoded back to the tiles,
     K1 launched three times a tile for the lossless point, HC equal to the
     CPU run; (c) ``run-codec --codec j2k --entropy device --rate-key
     quality --rates 10 40 100 --keep-bitstream`` on the HC tile and phase
     6's scene-row command with ``--keep-bitstream`` on the scene's
     2000×1808 crop: no checksum warning, the kept streams equal to the CPU
     run's byte for byte, ``wenc_decode`` of them, dequantized and inverse
     transformed, equal to recon.tif, K1 and K2 launches as counted; (d)
     one 2 bpp CCSDS-122 point on phase 3's 180-band tile, for the band
     grouping of the BPE model and its device-memory peak;
  9. scene streaming: (a) bench.py's ``ccsds121_stream512`` row, ``run-codec
     --codec ccsds121 --rate-key none --reps 1 --preproc none --nbit 16
     --interleave bip --tile 512 --stream-rows 512`` (plus
     ``--keep-bitstream``) on its 2000×10000×4 scene: the host's RSS delta
     under bench.py's 500 MB, and the rows, recon.tif (== the scene) and
     every tile's stream equal to the same scene run whole-cube, its
     bytes equal to the codec's host-interleave path (the upload withheld:
     the host transposes and the serial coder) and lossless, K1
     launched 0 times (a 4×512² tile is below one plan chunk); (b) a
     180×4096×1024 Case B scene (1.5 GB, the Case B tile recipe, its
     noise drawn on the card) that streams by itself in 1024-row strips, through the anchor's CCSDS-121
     flags and through ``--codec ccsds123``, streams kept: lossless,
     recon.tif == the scene, every stream equal to a whole-cube run of the
     same scene, the RSS delta below the whole-cube run's, K1 12 (CCSDS-121)
     and 6 (CCSDS-123) times a tile in both; one more CCSDS-123 sweep under
     ``torch.profiler``; (c) a 32×1280×512 crop of it with a NoData stripe
     and a user mask, its noisy recon pre-seeded, streamed in 512-row
     strips on the card and on the CPU: integers and the ERR8/RGB8
     quicklooks equal, PSNR/SSIM within rel 1e-5, SAM/SID/LMSE within rel
     1e-4; (d) ``make-baseline-a`` on four synthetic 10,980² bands and
     ``make-baseline-b`` on two synthetic 224-band 1000² EnMAP products, on
     the card and with ``--device cpu``: every output file byte-equal; in
     each other ``--err-mode`` on the card, its error map equal to the
     CPU's map of the same scenes;
 10. the rest of the command line: (a) ``tile-complexity --device cuda``
     on phase 5's two tiles and phase 3's tile, twice on the card (the same
     bits) and with ``--device cpu`` (counts exact, grad_* within rel 1e-5,
     the spectral metrics and delentropy within rel 1e-4), the ms per tile
     on each; (b) ``codec-ccsds121`` with the anchor flags on the card: a
     JSON last line, recon == the tile, the kept stream == phase 3's, K1 once
     per plan chunk; (c) ``codec-j2k --quality 40 --entropy device
     --keep-bitstream`` on the HC tile: K2 as ``plan`` schedules one 1024²
     transform, the kept streams == phase 8c's q 40 streams; (d) ``run-codec
     --compressor-cmd`` over ``codec-ccsds121 --device cuda`` in a child
     process, the anchor flags after ``--``: lossless, the row == phase 3's
     but the time and memory columns, the stream == phase 3's, and the
     child's start-up cost step by step; (e) ``J2KCodec.sweep_rd`` on the HC
     tile at the 14 qualities: bytes, max|Δ| and the lossless flag == phase
     6b's rep 1 rows, PSNR/SSIM within rel 1e-5, K2 as for one transform;
     (f) one anchor rep with and without ``--profile``: the Chrome trace
     names K1's kernel, both walls; (g) ``doctor --smoke --device cuda``:
     rc 0, every row ok; (h) ``rd-curve`` from phase 5's metrics_mean.csv
     where pandas and matplotlib import, else the refusal naming the one
     that is missing;
 11. the device mesh (``--mesh DP[,SP]``, tpukit_torch/parallel/mesh.py;
     eight positions on one card, wrapped round-robin): (a) phase 6b's
     device ladder on the two 1024²×4 tiles at ``--mesh 4,2`` and
     ``--mesh 1``: rows but the time and memory columns and every artifact
     equal, bytes equal to phase 6b's no-mesh run with PSNR/SSIM within
     rel 1e-4 (whether exactly equal is logged), K2 4 launches on each
     position that takes a point, K1 3 a point; one more ``--mesh 4,2``
     rep under ``torch.profiler``; (b) phase 3's Case B command at
     ``--mesh 4,2``: one plan of 16 chunks equal to one position's plan of
     the same chunks and as long as phase 3's, K1 once a chunk, every
     rep's stream == phase 3's, lossless, rows == phase 3's; (c) phase 8a's
     BPE ladder at ``--mesh 4,2``: rows and every file (kept streams,
     recons, quicklooks) == phase 8a's; (d) a 180×1024×512 Case B scene
     streamed in 512-row strips, 2 reps, streams kept, at ``--mesh 2`` and
     without: rows and files equal, K1 the same; (e) ``run_sharded_batch``
     and ``sharded_metric_ladder`` at dp=4, sp=2 on eight lanes of a
     (4, 512, 512) cube: eight positions on the card against one (floats
     within rel 1e-5) and against eight on the CPU (SAM/SID/LMSE within
     rel 1e-3), integers exact; (f) the current device unchanged after
     phase 2 and every case, and with two cards or more K1 and K2 on
     cuda:1 and ``--mesh 2`` across two cards == ``--mesh 1``;
 12. the benchmark (bench_torch.py): its ``caseB_anchor_ccsds121`` and
     ``sceneA_ccsds121_stream512`` cells through its own cell function,
     with three warm iterations each, on its inputs (seed 2026): every
     check of both cells (lossless rows, bytes equal across reps and
     iterations, every sweep's rows and the anchor's bits and bytes equal
     to tpukit's full-size ones, the anchor flow's decode, size model and
     stream == the serial coder, the streamed sweeps' RSS delta under 500
     MB, the reference passes against tpukit's rows), K1 once per plan
     chunk in every Case B sweep and anchor run, none in the streamed
     scene;
 13. the host floors and tpukit's last entry points: (a) the timed body of
     scripts/nativebench_torch.py once at full size (the CCSDS-121 coder
     on a 180x512x512 Case B stream, the bit-plane coder on the q35 and
     lossless 5/3 coefficients of a 4x1024² tile) with the tile's DWTs on
     the card: its round trips hold, and its q35 and 5/3 streams equal
     those of the same coefficients taken on the CPU; (b)
     ``bpc_size_bytes_host`` on the card == on the CPU == the native
     coder's stream lengths, on both coefficient sets; (c) the named
     transforms ``kernels.dwt.dwt53`` ... ``idwt97m`` on the tile, the card
     against the CPU, forward and inverse bit-equal, the integer ones
     reversible.

Every phase raises on failure. Logs each phase's checks and timings to
stderr; prints a kernels JSON line, the card line from nvidia-smi and,
last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX and
nothing of tpukit: the input recipes are bench_torch.py's ports of
bench.py's.
"""

import contextlib
import csv
import hashlib
import importlib.util
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import bench_torch
from bench_torch import (busy_ms, card_line, caseb_gains, caseb_texture,
                         make_casea_tiles, make_caseb_cube, make_scene,
                         rss_bytes)
from tpukit_torch.cli.main import run_codec_config, run_codec_main
from tpukit_torch.codecs import bpe122, bpe122_model, ccsds122_codec
from tpukit_torch.codecs.bitplane_model import bpc_size_bytes_host
from tpukit_torch.codecs import ccsds121 as model
from tpukit_torch.codecs import wavelet_common as wc
from tpukit_torch.codecs import ccsds121_codec
from tpukit_torch.codecs.ccsds121_codec import CCSDS121Codec, flat_stream
from tpukit_torch import native
from tpukit_torch.codecs import ccsds123_codec, j2k_codec
from tpukit_torch.codecs.base import RateSpec, device_work
from tpukit_torch.codecs.ccsds122_codec import CCSDS122Codec
from tpukit_torch.codecs.ccsds123_codec import CCSDS123Codec
from tpukit_torch.codecs.j2k_codec import J2KCodec
from tpukit_torch.device import resolve_device
from tpukit_torch.io import manifest, tiff
from tpukit_torch.io import raw as rawio
from tpukit_torch.io.jp2 import JP2Decoder
from tpukit_torch.kernels import build
from tpukit_torch.kernels import dwt as dwtk
from tpukit_torch.kernels.dwt import dwt2, idwt2
from tpukit_torch.native import ccsds121_host
from tpukit_torch.kernels.dwt97 import TAIL_MAX, dwt97, dwt97_ref, plan
from tpukit_torch.kernels.fs_table import fs_table, fs_table_ref
from tpukit_torch.parallel import mesh as pmesh
from tpukit_torch.sweep import runner

BANDS, SIZE = 180, 512
PLAN_CHUNK = 1 << 22
RATES_A = [1, 2, 4, 6, 8, 10, 15, 20, 25, 30, 35, 40, 60, 100]
SCENE_TILE = 1024
QUALITIES_HELD = (1, 40, 100)    # points of phase 6b held against the CPU
PACK_CHUNK = 1 << 23             # encode_device's default chunk, in samples
RATES_122 = ["0.5", "1", "2", "4", "16"]     # bpp a band; 16 is lossless
RATES_122_HELD = ["1", "16"]     # points of phase 8 held against the CPU
QUALITIES_KEPT = (10, 40, 100)   # phase 8c's kept-stream ladder


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_codec(argv):
    """A ``run-codec`` command line through the sweep runner, as
    ``run_codec_main`` runs it; returns the runner's result dict (rows,
    phases), which the CLI entry point does not hand on."""
    return runner.run_sweep(run_codec_config(argv))


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


def make_caseb_scene(rng, bands, rows, cols, dev):
    """The Case B tile recipe (make_caseb_cube) at a scene's size: the same
    smoothed spatial texture and spectral gains, drawn from ``rng``, with
    the N(0, 12) noise drawn on the card from a generator seeded by
    ``rng`` (a billion normals take minutes on the host); 14-in-16 int16,
    returned on the host."""
    spatial = torch.from_numpy(caseb_texture(rng, rows, cols)).to(dev)
    gains = caseb_gains(bands)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    out = torch.empty((bands, rows, cols), dtype=torch.int16, device=dev)
    for b in range(bands):
        band = spatial * float(gains[b]) + 12.0 * torch.randn(
            (rows, cols), generator=g, device=dev, dtype=torch.float64)
        # clip, truncate toward zero, zero the 2 LSBs (x & -4 is the
        # recipe's >> 2 << 2 on the uint16 bit view)
        out[b] = band.clamp(-8192, 8191).to(torch.int16) & -4
    return out.cpu().numpy()


def write_caseb_index(work: Path, cube: np.ndarray, name="caseB") -> Path:
    src = work / f"{name}_tile.tif"
    tiff.write_geotiff(src, cube, blockxsize=512, blockysize=512)
    idx = work / f"index_{name}.json"
    manifest.write_manifest(idx, "caseB", "tile_512",
                            [{"tile_id": "T01", "path": src}])
    return idx


def run_slice(work: Path, cube: np.ndarray, card: str):
    """Phase 3: the Case B anchor sweep through the port's CLI on CUDA;
    returns K1's launch count in the sweep, the stream's bytes, and the
    stream, rep 1's CSV row (phase 10 holds the wrappers to them), every
    row and the plan (phase 11b holds the mesh run to them)."""
    idx = write_caseb_index(work, cube)

    plans, recons, fetched = [], [], []
    transposes = {"bsq_to_interleaved": 0, "interleaved_to_bsq": 0}

    def recording(out, fn, keep=lambda r: r):
        def call(*a, **kw):
            r = fn(*a, **kw)
            out.append(keep(r))
            return r
        return call

    def counted(name):
        fn = getattr(rawio, name)

        def call(*a, **kw):
            transposes[name] += 1
            return fn(*a, **kw)
        return call

    with contextlib.ExitStack() as patches:
        for obj, name, fn in [
                (model, "encode_plan", recording(plans, model.encode_plan)),
                (CCSDS121Codec, "run", recording(recons, CCSDS121Codec.run,
                                                 lambda r: r.recon)),
                (ccsds121_codec, "host_flat",
                 recording(fetched, ccsds121_codec.host_flat)),
                *((rawio, n, counted(n)) for n in transposes)]:
            patches.enter_context(mock.patch.object(obj, name, fn))
        fs_table.launches = 0
        t0 = time.perf_counter()
        res = run_codec([
            "--indices", str(idx), "--codec", "ccsds121",
            "--rate-key", "none", "--reps", "3", "--outdir", str(work / "runs"),
            "--preproc", "none", "--nbit", "16", "--interleave", "bip",
            "--tile", "512", "--keep-bitstream", "--device", "cuda"])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = fs_table.launches

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

    # the interleave and its inverse on the card: one fetched host stream
    # (reps 2-3 take it from the plan cache) == the host transpose, every
    # rep's recon lane a CUDA tensor == the tile, no host transpose
    if any(transposes.values()):
        raise AssertionError(f"host transposes in the sweep: {transposes}")
    if len(fetched) != 1 or fetched[0].dtype != np.uint16 \
            or not np.array_equal(fetched[0], flat):
        raise AssertionError(f"the {len(fetched)} host stream(s) fetched "
                             f"from the card != the host transpose")
    tile_dev = torch.from_numpy(cube).cuda()
    if len(recons) != 3 or not all(
            isinstance(r, torch.Tensor) and r.is_cuda
            and torch.equal(r, tile_dev) for r in recons):
        raise AssertionError("a recon lane is not a CUDA tensor equal to "
                             "the tile: " + ", ".join(
                                 f"{type(r).__name__} on "
                                 f"{getattr(r, 'device', 'host')}"
                                 for r in recons))
    del tile_dev, recons
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
        f"{rows[0].get('hbm_peak_mb')} MiB; interleave and inverse on the "
        f"card (3 CUDA recon lanes == the tile, the fetched stream == the "
        f"host transpose, no host transpose) on {card}")
    return launches, len(serial), {"stream": serial, "row": rows[0],
                                   "rows": rows, "plan": plans[0]}


def metric_pass(device, cube, lanes, valid):
    """The runner's device pass (dispatch + finalize) on one device."""
    ref = torch.from_numpy(cube).to(device)
    vm = torch.from_numpy(valid).to(device)
    ql_dev = tuple(torch.from_numpy(a).to(device)
                   for a in runner._ql_inputs((255, 40), valid, lanes))
    chunks = runner._device_pass_dispatch(
        device, ref, vm, vm, lanes, runner._metric_chunk(*cube.shape), 0.0,
        False, True, ql_dev=ql_dev, ref_host=cube)
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
    returns K2's launch count in the sweep and the text of its
    metrics_mean.csv (phase 10 draws it)."""
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
        res = run_codec([
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
    return launches, (work / "runsA" / "metrics_mean.csv").read_text()


def read_rows(path: Path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter=";"))


def num(s: str) -> float:
    return float(s.replace(",", "."))


def tile_counts(H: int, W: int, t: int):
    """{(th, tw): number of tiles} of a t×t tiling."""
    counts = {}
    for y0 in range(0, H, t):
        for x0 in range(0, W, t):
            s = (min(t, H - y0), min(t, W - x0))
            counts[s] = counts.get(s, 0) + 1
    return counts


def traced_sweep(tag: str, argv, card):
    """One more sweep of the CLI's ``argv`` (which names its ``--outdir``)
    under bench_torch's tracer: its device-busy share and the device
    operations that take the most time."""
    i = argv.index("--outdir")
    _, tr = bench_torch.traced_sweep(
        argv[:i] + argv[i + 2:],
        torch.device("cuda", torch.cuda.current_device()), Path(argv[i + 1]))
    share = tr["device_busy_share"]
    log(f"[{tag}] traced sweep wall {tr['traced_wall_s']:.2f} s, device busy "
        + (f"{tr['device_busy_ms']:.1f} ms ({100.0 * share:.2f}% busy)"
           if share else "not measured (no device events traced)")
        + f" on {card}")
    for op in tr["top_device_ops"]:
        log(f"[{tag}]   {op['ms']:9.3f} ms {op['calls']:6d} x {op['name']}")


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
    res = run_codec(argv + ["--outdir", str(work / "runsS")])
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
    traced_sweep("scene", argv + ["--outdir", str(work / "runsS2")], card)

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
        crop, "uint16", spec, device="cpu")[0]
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
    j2k_codec._cube_peak(scene)
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
    CLI on CUDA; returns (K1, K2) launch counts of the sweep and the HC
    tile's rep 1 rows by quality (phase 10 holds ``sweep_rd`` to them) and
    every row (phase 11a holds the mesh ladder to them)."""
    idx = write_index(work, tiles, "ladder")
    fs_table.launches = 0
    dwt97.launches = 0
    t0 = time.perf_counter()
    res = run_codec([
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
    cpu = J2KCodec(entropy="device").sweep_qualities(tiles["HC"], "uint16",
                                                     QUALITIES_HELD,
                                                     device="cpu")
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
    hc_rep1 = {}                     # rate outer, rep inner: rep 1 first
    for r in rows:
        if r["tile_id"] == "HC":
            hc_rep1.setdefault(int(num(r["rate_value"])), r)
    return k1, k2, hc_rep1, rows


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
    want = J2KCodec(entropy="device").run(tile, "uint16", RateSpec.none(),
                                          device="cpu")
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
        corner, "uint16", RateSpec.of("bpp", bpp), device="cpu")
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
    res = run_codec(argv + ["--reps", "3", "--outdir",
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
                               keep_bitstream=True, device="cpu")
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
        r16 = run_codec(["--indices", str(idx16), "--codec", "ccsds123",
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
    traced_sweep("ccsds123", argv + ["--reps", "1", "--outdir",
                                     str(work / "runs123t")], card)
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


def rate_dir(out: Path, tid: str, key: str, rate) -> Path:
    """The runner's rep 1 directory of one (tile, rate) point."""
    (r,) = runner._normalize_rates(key, [rate])
    return out / tid / runner.rate_slug(key, r) / "rep_01"


def kept_streams(run_dir: Path) -> dict:
    """{name: bytes} of a run directory's kept streams."""
    return {f.name: f.read_bytes()
            for f in sorted((run_dir / "bit").iterdir())}


def ccsds122_budgets(tile: np.ndarray):
    codec = CCSDS122Codec()
    return [codec.budget_for(RateSpec.of("bpp", float(r)), *tile.shape,
                             "uint16")[1] for r in RATES_122]


def ccsds122_model_bytes(tile: np.ndarray, dev, entropy: str) -> np.ndarray:
    """(rates, bands) stream bytes of RATES_122 from the device models
    alone, as the codec calls them."""
    B, H, W = tile.shape
    c = ccsds122_codec._consts(H, W, dev)
    work = torch.from_numpy(tile.astype(np.int32)).to(dev)
    budgets = ccsds122_budgets(tile)
    if entropy == "bpe":
        _, nbytes, _ = ccsds122_codec._bpe_ladder_device(
            work, c.gather, c.wexp, budgets)
        return nbytes.cpu().numpy()
    _, nbytes, _ = ccsds122_codec._analyze_ladder_device(
        work, c.order, budgets[:-1], c.wmap, True)
    shift = ccsds122_codec.trailing_zero_shift(tile)
    _, sizes = ccsds122_codec._lossless_analyze_device(
        work, c.order, c.segb, shift, c.rle)
    return np.concatenate([nbytes.cpu().numpy(),
                           sizes.cpu().numpy()[None] + 1])


def decode_ccsds122(streams: dict, tile: np.ndarray, entropy: str,
                    lossless: bool) -> np.ndarray:
    """The host decode of one point's kept streams: the native coders'
    decoders, the weights divided out, the inverse 9/7M on the CPU."""
    B, H, W = tile.shape
    names = sorted(streams)
    if entropy == "bpe":
        planes = np.stack([bpe122.decode_plane(streams[n], H, W)
                           for n in names])
        shift = 0
    else:
        order = wc.scan_order(H, W, 3)
        segb = wc.subband_seg_bounds(H, W, 3)
        planes = np.empty((B, H * W), np.int32)
        shift = 0
        for b, n in enumerate(names):
            s = streams[n]
            if lossless:
                shift = s[0]
                planes[b, order] = wc.wenc_decode(s[1:], H * W, segb)
            else:
                planes[b, order] = wc.bpc_decode(s, H * W)
        planes = planes.reshape(B, H, W)
        if not lossless:
            wmap = ccsds122_codec.subband_weight_map(H, W)
            planes = np.rint(planes.astype(np.float32) / wmap) \
                .astype(np.int32)
    rec = idwt2(torch.from_numpy(planes), "97m", 3) << shift
    return rec.clamp(0, 65535).numpy().astype(np.uint16)


def run_ccsds122(work: Path, tiles, dev, card, entropy: str):
    """Phases 8a and 8b: the CCSDS-122 rate ladder of one entropy backend
    through the port's CLI on CUDA; returns K1's launch count and the rows
    and files of the sweep (phase 11c holds the mesh run to them)."""
    idx = write_index(work, tiles, f"c122{entropy}")
    out = work / f"runs122{entropy}"
    argv = ["--indices", str(idx), "--codec", "ccsds122", "--entropy",
            entropy, "--rate-key", "bpp", "--rates", *RATES_122, "--reps",
            "1", "--keep-bitstream", "--device", "cuda"]
    tag = f"ccsds122 {entropy}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs_table.launches = 0
    t0 = time.perf_counter()
    res = run_codec(argv + ["--outdir", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = fs_table.launches
    # the Rice candidates of the embedded backend's lossless point: dense,
    # sparse and split, once a tile
    want_k1 = 3 * len(tiles) if entropy == "embedded" else 0
    if k1 != want_k1:
        raise AssertionError(f"{tag}: K1 launched {k1} times, expected "
                             f"{want_k1}")
    rows = read_rows(out / "metrics.csv")
    if len(rows) != len(RATES_122) * len(tiles):
        raise AssertionError(f"{tag}: {len(rows)} rows")

    for tid, tile in tiles.items():
        model_bytes = ccsds122_model_bytes(tile, dev, entropy)
        budgets = ccsds122_budgets(tile)
        trows = [r for r in rows if r["tile_id"] == tid]
        last_bytes, last_psnr = 0, -math.inf
        for qi, (rate, row) in enumerate(zip(RATES_122, trows)):
            if num(row["rate_value"]) != float(rate):
                raise AssertionError(f"{tag} {tid}: row order {row}")
            lossless = budgets[qi] == 0
            streams = kept_streams(rate_dir(out, tid, "bpp", rate))
            suffix = (".bpe" if entropy == "bpe"
                      else ".bit" if lossless else ".wbit")
            if sorted(streams) != [f"b{b + 1:02d}{suffix}"
                                   for b in range(tile.shape[0])]:
                raise AssertionError(f"{tag} {tid} {rate}: streams "
                                     f"{sorted(streams)}")
            lens = [len(streams[n]) for n in sorted(streams)]
            if lens != model_bytes[qi].tolist():
                raise AssertionError(
                    f"{tag} {tid} {rate} bpp: kept streams {lens} B, the "
                    f"device model {model_bytes[qi].tolist()} B")
            nbytes = int(row["bitstream_bytes"])
            if nbytes != sum(lens):
                raise AssertionError(f"{tag} {tid} {rate}: CSV bytes")
            if not lossless and max(lens) > budgets[qi]:
                raise AssertionError(f"{tag} {tid} {rate}: a stream of "
                                     f"{max(lens)} B over {budgets[qi]} B")
            is_lossless = (row["lossless"], row["max_abs_err"]) == ("1", "0")
            if is_lossless != lossless:
                raise AssertionError(f"{tag} {tid} {rate}: lossless {row}")
            psnr = num(row["psnr_global"])
            if not (nbytes > last_bytes and psnr > last_psnr):
                raise AssertionError(
                    f"{tag} {tid}: bytes or PSNR do not rise at {rate} bpp: "
                    f"{nbytes} B after {last_bytes}, {psnr} after {last_psnr}")
            last_bytes, last_psnr = nbytes, psnr
            with tiff.open(rate_dir(out, tid, "bpp", rate)
                           / "recon.tif") as ds:
                recon = ds.read()
            if lossless and not np.array_equal(recon, tile):
                raise AssertionError(f"{tag} {tid}: recon.tif != tile")
            if tid == "HC" or lossless:
                if not np.array_equal(decode_ccsds122(streams, tile, entropy,
                                                      lossless), recon):
                    raise AssertionError(f"{tag} {tid} {rate} bpp: host "
                                         f"decode of the kept streams != "
                                         f"recon.tif")
            log(f"[{tag}] {tid} {rate} bpp: {nbytes} B {lens}, psnr "
                f"{row['psnr_global']}, t_comp_s {row['t_comp_s']}, t_dec_s "
                f"{row['t_dec_s']}")

    # the HC tile on the CPU: bytes, streams and recons
    t0 = time.perf_counter()
    want = CCSDS122Codec(entropy).sweep_rates(
        tiles["HC"], "uint16",
        [RateSpec.of("bpp", float(r)) for r in RATES_122_HELD],
        keep_bitstream=True, device="cpu")
    cpu_s = time.perf_counter() - t0
    for rate, w in zip(RATES_122_HELD, want):
        d = rate_dir(out, "HC", "bpp", rate)
        if kept_streams(d) != w.bitstreams:
            raise AssertionError(f"{tag} HC {rate} bpp: streams on the card "
                                 f"!= the CPU run's")
        with tiff.open(d / "recon.tif") as ds:
            if not np.array_equal(ds.read(), w.recon.numpy()):
                raise AssertionError(f"{tag} HC {rate} bpp: CUDA recon != "
                                     f"CPU recon")
    log(f"[{tag}] every kept stream as long as the device model says; host "
        f"decode of the kept streams == recon.tif; HC at {RATES_122_HELD} "
        f"bpp: CUDA streams and recons == plain CPU (CPU {cpu_s:.1f} s)")
    log(f"[{tag}] sweep wall {wall:.2f} s, phases {res['phases']}, {k1} K1 "
        f"launches, hbm peak {rows[-1].get('hbm_peak_mb')} MiB (process "
        f"peak, reset before the sweep) on {card}")
    return k1, {"rows": rows, "digest": tree_digest(out)}


def ccsds122_stages(tile: np.ndarray, dev, card):
    """The stages of phase 8a's codec work on one tile, each synchronized
    on the host clock; the second pass is reported."""
    B, H, W = tile.shape
    c = ccsds122_codec._consts(H, W, dev)
    budgets = ccsds122_budgets(tile)

    def lap(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for _ in range(2):
        t = {}
        dc, t["upload"] = lap(lambda: torch.from_numpy(tile).to(dev))
        work, t["work"] = lap(lambda: device_work(
            tile, {"device_cube": dc}, 8, torch.int32))
        coefs, t["9/7M dwt"] = lap(lambda: dwt2(work, "97m", 3))
        blocks, t["weights + gather"] = lap(
            lambda: (coefs << c.wexp[None]).reshape(B, -1)[:, c.gather])
        layout, t["bpe layout"] = lap(
            lambda: bpe122_model.bpe_stream_layout(blocks))
        recs, t_dec, t_syn, t_host = [], [], [], []
        for budget in budgets:
            (rec, _), s = lap(lambda: bpe122_model.bpe_decode_at(layout,
                                                                 budget))
            t_dec.append(s)
            recs.append(rec)
        del layout
        for rec in recs:
            _, s = lap(lambda: ccsds122_codec._bpe_synthesize_device(
                rec, c.scatter, c.wexp, H, W, H, W, torch.uint16, 0, 65535))
            t_syn.append(s)
        del recs
        host, t["blocks to host"] = lap(lambda: blocks.cpu().numpy())
        for budget in budgets:
            _, s = lap(lambda: [bpe122.bpe_encode_blocks(
                host[b], seg_byte_limit=budget, img_width=W,
                pixel_bitdepth=16) for b in range(B)])
            t_host.append(s)
        perm, t["embedded: scan order"] = lap(
            lambda: (coefs * c.wmap[None]).reshape(B, -1)[:, c.order])
        elayout, t["embedded: layout"] = lap(
            lambda: ccsds122_codec.bm.bpc_stream_layout(perm))
        _, t["embedded: decode, one budget"] = lap(
            lambda: ccsds122_codec.bm.bpc_decode_at(elayout, budgets[1]))
        del elayout, perm, blocks, coefs, work, dc
    ms = lambda v: "/".join(f"{1e3 * x:.1f}" for x in v)
    log("[ccsds122] stages of the HC tile, second pass (host clock, "
        "synchronized): "
        + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in t.items())
        + f"; per budget {RATES_122} bpp: bpe decode {ms(t_dec)} ms, "
          f"synthesis {ms(t_syn)} ms, host BPE coder (4 bands) "
          f"{ms(t_host)} ms on {card}")


def run_j2k_kept(work: Path, tile: np.ndarray, crop: np.ndarray, dev, card):
    """Phase 8c: the J2K device mode with kept streams through the port's
    CLI on CUDA, whole tile and tiled; returns the (K1, K2) launch counts
    of the two sweeps and the whole tile's kept q 40 streams (phase 10
    holds the ``codec-j2k`` wrapper to them)."""
    B, H, W = tile.shape
    counts = []
    kept_q40 = None
    runs = [("HC", tile, [str(q) for q in QUALITIES_KEPT], []),
            ("crop", crop, ["40"], ["--tilex", str(SCENE_TILE), "--tiley",
                                    str(SCENE_TILE)])]
    for tid, cube, rates, extra in runs:
        idx = write_index(work, {tid: cube}, f"kept{tid}")
        out = work / f"runsK{tid}"
        fs_table.launches = 0
        dwt97.launches = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = run_codec([
                "--indices", str(idx), "--codec", "j2k", "--entropy",
                "device", "--rate-key", "quality", "--rates", *rates,
                "--reps", "1", "--keep-bitstream", "--outdir", str(out),
                "--device", "cuda", *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k1, k2 = fs_table.launches, dwt97.launches
        bad = [str(w.message) for w in caught
               if "checksum" in str(w.message)]
        if bad:
            raise AssertionError(f"[j2k kept] {tid}: {bad}")
        shapes = tile_counts(*cube.shape[1:], SCENE_TILE if extra else 1 << 20)
        n_tiles = sum(shapes.values())
        # a DWT for the whole tile's ladder, or one a tile and point; three
        # Rice sizes a tile and point
        want_k2 = sum(n * len(plan(th + (-th) % 32, tw + (-tw) % 32, 5))
                      for (th, tw), n in shapes.items()) * \
            (len(rates) if extra else 1)
        want_k1 = 3 * n_tiles * len(rates)
        if (k1, k2) != (want_k1, want_k2):
            raise AssertionError(f"[j2k kept] {tid}: K1 {k1}, K2 {k2} "
                                 f"launches, expected {want_k1}, {want_k2}")
        rows = read_rows(out / "metrics.csv")

        t0 = time.perf_counter()
        want = J2KCodec(entropy="device", **(
            {"tilex": SCENE_TILE, "tiley": SCENE_TILE} if extra else {})
        ).sweep_rates(cube, "uint16",
                      [RateSpec.of("quality", int(q)) for q in rates],
                      keep_bitstream=True, device="cpu")
        cpu_s = time.perf_counter() - t0
        for q, row, w in zip(rates, rows, want):
            d = rate_dir(out, tid, "quality", q)
            streams = kept_streams(d)
            if len(streams) != n_tiles * B or streams != w.bitstreams:
                raise AssertionError(f"[j2k kept] {tid} q={q}: streams on "
                                     f"the card != the CPU run's")
            if int(row["bitstream_bytes"]) != sum(map(len, streams.values())):
                raise AssertionError(f"[j2k kept] {tid} q={q}: CSV bytes")
            if not extra and q == "40":
                kept_q40 = streams
            with tiff.open(d / "recon.tif") as ds:
                recon = ds.read()
            if not np.array_equal(recon, w.recon.numpy()):
                raise AssertionError(f"[j2k kept] {tid} q={q}: CUDA recon "
                                     f"!= CPU recon")
            if not extra:
                # decode(stream), dequantized and inverse transformed
                c = j2k_codec._PricingConsts(H, W, torch.device("cpu"))
                qc = np.empty((B, H * W), np.int32)
                for b, name in enumerate(sorted(streams)):
                    qc[b, c.order_host] = wc.wenc_decode(streams[name],
                                                         H * W, c.segbounds)
                peak = j2k_codec._cube_peak(cube)
                base = np.float32(j2k_codec.base_step_for_quality(int(q),
                                                                  peak))
                back = j2k_codec._device_recon(
                    torch.from_numpy(qc.reshape(B, H, W)), c.scale, base, 5,
                    H, W, 0, 65535, torch.uint16)
                if not np.array_equal(back.numpy(), recon):
                    raise AssertionError(f"[j2k kept] {tid} q={q}: "
                                         f"decode(stream) != recon.tif")
            log(f"[j2k kept] {tid} q={q}: {row['bitstream_bytes']} B in "
                f"{len(streams)} streams, psnr {row['psnr_global']}, "
                f"t_comp_s {row['t_comp_s']}, t_dec_s {row['t_dec_s']}")
        log(f"[j2k kept] {tid} {cube.shape}: no checksum warning; kept "
            f"streams and recons == plain CPU (CPU {cpu_s:.1f} s); sweep "
            f"wall {wall:.2f} s, phases {res['phases']}, {k1} K1 and {k2} "
            f"K2 launches on {card}")
        counts.append((k1, k2))
    return counts, kept_q40


def run_ccsds122_caseb(work: Path, cube: np.ndarray, card):
    """Phase 8d: one CCSDS-122 BPE point on the 180-band Case B tile."""
    idx = write_caseb_index(work, cube, "caseB_122")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_codec(["--indices", str(idx), "--codec", "ccsds122",
                     "--rate-key", "bpp", "--rates", "2", "--reps", "1",
                     "--no-artifacts", "--outdir", str(work / "runs122B"),
                     "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (row,) = read_rows(work / "runs122B" / "metrics.csv")
    B, H, W = cube.shape
    budget = int(2.0 * H * W / 8.0)
    nbytes = int(row["bitstream_bytes"])
    if not (0 < nbytes <= B * budget) or row["lossless"] != "0" \
            or not math.isfinite(num(row["psnr_global"])):
        raise AssertionError(f"[ccsds122 caseB] {row}")
    group = ccsds122_codec.band_group(
        B, (H // 8) * (W // 8) * bpe122_model.LAYOUT_BYTES_PER_BLOCK,
        torch.device("cuda"))
    log(f"[ccsds122 caseB] {cube.shape} at 2 bpp: {nbytes} B of a "
        f"{B * budget} B budget, psnr {row['psnr_global']}, t_comp_s "
        f"{row['t_comp_s']}, t_dec_s {row['t_dec_s']}; wall {wall:.2f} s, "
        f"phases {res['phases']}, hbm_peak_mb {row.get('hbm_peak_mb')} "
        f"(process peak, reset before the sweep; bands in groups of up to "
        f"{group} now) on {card}")


def run_phase8(tiles, cube, dev, card):
    """Phase 8; returns its launch counts by path."""
    t8 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        work = Path(tmp)
        bpe_k1, bpe_ref = run_ccsds122(work, tiles, dev, card, "bpe")
        ccsds122_stages(tiles["HC"], dev, card)
        idx = write_index(work, tiles, "c122bpe")
        traced_sweep("ccsds122 bpe", [
            "--indices", str(idx), "--codec", "ccsds122", "--rate-key",
            "bpp", "--rates", *RATES_122, "--reps", "1", "--keep-bitstream",
            "--outdir", str(work / "runs122t"), "--device", "cuda"], card)
        emb_k1, _ = run_ccsds122(work, tiles, dev, card, "embedded")
        crop = np.ascontiguousarray(make_scene(
            np.random.default_rng(2026))[:, :, 8 * SCENE_TILE:])
        ((kept_k1, kept_k2), (tiled_k1, tiled_k2)), kept_q40 = run_j2k_kept(
            work, tiles["HC"], crop, dev, card)
        run_ccsds122_caseb(work, cube, card)
    log(f"[ccsds122] phase 8 in {time.perf_counter() - t8:.1f} s")
    return {"kept_q40": kept_q40, "bpe_ref": bpe_ref,
            "k1": {"ccsds122_bpe": bpe_k1,
                   "ccsds122_embedded_lossless": emb_k1,
                   "j2k_device_kept": kept_k1,
                   "j2k_device_kept_tiled": tiled_k1},
            "k2": {"j2k_device_kept": kept_k2,
                   "j2k_device_kept_tiled": tiled_k2}}


# phase 9: scene streaming. 9b's EnMAP-like data take: over 1 GiB (1.5 GB)
# so that it streams by itself; 6144 rows, which would hold the reference's
# Case B LC tile offset (row 5620, tpukit/cli/main.py:224), took phase 9
# past its 300 s
SCENE_B_ROWS, SCENE_B_COLS = 4096, 1024
STRIP_ROWS_AUTO = 1024          # stream_plan's strip height without --stream-rows
ERR_MODES = ("max", "mean", "rms", "p95", "count3")
# 9d's inputs: a Sentinel-2 10 m band's size; EnMAP products of 224 bands
# x 1000², whose 1000 x 2000 mosaic holds neither of the reference's tile
# offsets, so the tiles are placed inside it
S2_SIZE = 10980
CASEA_FLAGS = ()
ENMAP_BANDS, ENMAP_SIZE = 224, 1000
CASEB_FLAGS = ("--lc", "580,400", "--hc", "1400,64")


def rss_parts() -> str:
    """The process's resident memory, anonymous and file-backed."""
    with open("/proc/self/status") as f:
        return ", ".join(" ".join(line.split()) for line in f
                         if line.startswith(("VmRSS", "RssAnon", "RssFile")))


def device_busy(argv, card, tag):
    """One sweep under torch.profiler with the device's activity only (no
    host-op table: the trace of a scene's host ops takes minutes to
    summarize): its wall and device-busy share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_codec(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_ms(prof)
    log(f"[{tag}] traced sweep wall {wall:.2f} s, device busy {busy:.1f} ms "
        f"({100.0 * busy / (1000.0 * wall):.2f}% busy"
        + (", no device events traced: not measured" if busy == 0 else "")
        + f") on {card}")


def measured_sweep(argv, cfg_edit=None):
    """One sweep through the CLI's config, with K1 counted from 0 and the
    host's RSS sampled: (result, wall s, K1 launches, RSS delta MB)."""
    from tpukit_torch.sweep.proc import MemorySampler
    cfg = run_codec_config(argv)
    if cfg_edit:
        cfg_edit(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs_table.launches = 0
    rss0 = rss_bytes()
    with MemorySampler() as ms:
        t0 = time.perf_counter()
        res = runner.run_sweep(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    delta = (max(ms.peak_bytes or 0, rss0) - rss0) / (1 << 20)
    return res, wall, fs_table.launches, delta


def warm_up(work: Path, cube: np.ndarray, case: str, flags):
    """One streamed sweep of a slice of the scene (two strips, full width),
    so that what the first such sweep of a process loads or keeps (CUDA
    modules loaded on first use, cached pinned and staging buffers of the
    strips' sizes) is not counted in the measured sweep's RSS delta:
    bench.py takes its row after its canonical sweeps."""
    src = work / "warm.tif"
    tiff.write_geotiff(src, cube, blockxsize=512, blockysize=512)
    idx = work / "index_warm.json"
    manifest.write_manifest(idx, case, "scene",
                            [{"tile_id": "warm", "path": src}])
    cfg = run_codec_config(["--indices", str(idx), *flags, "--outdir",
                            str(work / "warm")])
    cfg.stream_auto_bytes = 1   # streams without --stream-rows too
    runner.run_sweep(cfg)
    shutil.rmtree(work / "warm")
    src.unlink()


def strip_streams(bit_dir: Path) -> dict:
    """A streamed run's kept streams under the names the whole-cube run
    gives them: s{y0}_t_x{x}_y{y}.ext is tile (x, y0 + y) of the scene."""
    out = {}
    for f in sorted(bit_dir.iterdir()):
        strip, name = f.name.split("_", 1)
        head, ext = name.rsplit(".", 1)
        tx, ty = head.split("_")[1:3]
        y = int(strip[1:]) + int(ty[1:])
        out[f"t_{tx}_y{y:05d}.{ext}"] = f.read_bytes()
    return out


def same_rows(got, want, tag, skip=("hbm_",)):
    """Two CSVs' rows: equal in every column but the wall-clock, memory
    and device-peak ones."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} rows != {len(want)}")
    for g, w in zip(got, want):
        for col in w:
            if col.startswith(("t_", "mem_") + tuple(skip)) and \
                    not col.startswith("t_link_tile_s"):
                continue
            if g.get(col) != w[col]:
                raise AssertionError(f"{tag}: {col} {g.get(col)} != {w[col]}")


def equal_to_source(recon_tif: Path, src: np.ndarray, rows=1024) -> bool:
    """recon.tif == the source, read back strip by strip."""
    with tiff.open(recon_tif) as ds:
        for y0 in range(0, ds.height, rows):
            win = tiff.Window(col_off=0, row_off=y0, width=ds.width,
                              height=min(rows, ds.height - y0))
            if not np.array_equal(ds.read(window=win),
                                  src[:, y0:y0 + win.height]):
                return False
    return True


def run_stream512(work: Path, card):
    """Phase 9a: bench.py's ccsds121_stream512 scene row on the card, its
    host RSS delta under bench.py's 500 MB, held to the same scene run
    whole-cube: rows, recon == source; then the row again with
    --keep-bitstream, every tile's stream equal to the whole-cube run's;
    its bytes those of the codec's host-interleave path (no upload), run
    once untimed. Returns K1's launches (0: a 4x512² tile is below one
    plan chunk, so it stays on the serial coder)."""
    scene = make_scene(np.random.default_rng(2026))
    src = work / "caseA_scene_12in16.tif"
    tiff.write_geotiff(src, scene, blockxsize=512, blockysize=512)
    idx = work / "index_scene.json"
    manifest.write_manifest(idx, "caseA", "scene",
                            [{"tile_id": "sceneA", "path": src}])
    argv = ["--indices", str(idx), "--codec", "ccsds121", "--rate-key",
            "none", "--reps", "1", "--preproc", "none", "--nbit", "16",
            "--interleave", "bip", "--tile", "512", "--device", "cuda",
            "--stream-rows", "512"]
    warm_up(work, scene[:, :1024], "caseA", argv[2:])
    res, wall, k1, rss = measured_sweep(
        argv + ["--outdir", str(work / "s512")])
    (phase,) = res["phases"]
    if phase.get("rows") != 512:
        raise AssertionError(f"9a did not stream in 512-row strips: {phase}")
    wres, wwall, wk1, wrss = measured_sweep(
        argv[:-2] + ["--keep-bitstream", "--outdir", str(work / "whole")])
    _, _, kk1, _ = measured_sweep(
        argv + ["--keep-bitstream", "--outdir", str(work / "kept")])
    if k1 or wk1 or kk1:
        raise AssertionError(f"9a: K1 launched {k1} / {wk1} / {kk1} times, "
                             f"expected 0 (tiles below one plan chunk)")
    if rss >= 500:
        raise AssertionError(f"9a: RSS delta {rss:.0f} MB, not bounded "
                             f"(now {rss_parts()})")
    got = read_rows(work / "s512" / "metrics.csv")
    same_rows(got, read_rows(work / "whole" / "metrics.csv"), "9a")
    if (got[0]["lossless"], got[0]["max_abs_err"]) != ("1", "0"):
        raise AssertionError(f"9a: not lossless: {got[0]}")
    host = CCSDS121Codec(tile=512, interleave="bip", preproc="none",
                         nbit=16).run(scene, "uint16", RateSpec.none())
    if (int(got[0]["bitstream_bytes"]) != host.bitstream_bytes
            or not np.array_equal(host.recon, scene)):
        raise AssertionError(f"9a: {got[0]['bitstream_bytes']} B, the host "
                             f"interleave's {host.bitstream_bytes} B")
    del host
    run = Path("sceneA") / "norate" / "rep_01"
    if not equal_to_source(work / "s512" / run / "recon.tif", scene):
        raise AssertionError("9a: streamed recon.tif != the scene")
    streamed = strip_streams(work / "kept" / run / "bit")
    whole = kept_streams(work / "whole" / run)
    if streamed != whole:
        raise AssertionError(f"9a: strip streams != whole-cube streams "
                             f"({len(streamed)} / {len(whole)} files)")
    n = scene.size
    log(f"[stream] 9a ccsds121_stream512: wall {wall:.2f} s, "
        f"{n / wall / 1e6:.1f} Msamples/s, RSS delta {rss:.1f} MB, "
        f"{-(-scene.shape[1] // 512)} strips, {len(streamed)} tile streams "
        f"({sum(map(len, streamed.values()))} B) == whole-cube == the host "
        f"interleave's bytes; whole-cube "
        f"run (streams kept) {wwall:.2f} s, RSS delta {wrss:.1f} MB; t_comp_s "
        f"{got[0]['t_comp_s']}, t_dec_s {got[0]['t_dec_s']} on {card}")
    return k1


def run_caseb_stream(work: Path, card):
    """Phase 9b: a 180 x 4096 x 1024 Case B scene (1.5 GB) that streams by
    itself, through the anchor's CCSDS-121 flags and through CCSDS-123
    (`ls`), streams kept: lossless, recon.tif == the source, every stream
    equal to a whole-cube run of the same scene (``stream_auto_bytes``
    raised, --no-artifacts), the RSS delta below the whole-cube run's, K1
    counted. Returns ({path: K1 launches}, the scene)."""
    t0 = time.perf_counter()
    cube = make_caseb_scene(np.random.default_rng(2026), BANDS, SCENE_B_ROWS,
                            SCENE_B_COLS, "cuda")
    src = work / "caseB_scene.tif"
    tiff.write_geotiff(src, cube, blockxsize=512, blockysize=512)
    idx = work / "index_caseB_scene.json"
    manifest.write_manifest(idx, "caseB", "scene",
                            [{"tile_id": "sceneB", "path": src}])
    log(f"[stream] 9b scene {cube.shape} ({cube.nbytes / 1e9:.2f} GB) made "
        f"and written in {time.perf_counter() - t0:.1f} s")
    tiles = -(-SCENE_B_ROWS // SIZE) * -(-SCENE_B_COLS // SIZE)
    per_tile = {"ccsds121": -(-BANDS * SIZE * SIZE // PLAN_CHUNK),
                "ccsds123": -(-BANDS * SIZE * SIZE // PACK_CHUNK)}
    codecs = {"ccsds121": ["--codec", "ccsds121", "--preproc", "none",
                           "--nbit", "16", "--interleave", "bip", "--tile",
                           "512"],
              "ccsds123": ["--codec", "ccsds123"]}
    run = Path("sceneB") / "norate" / "rep_01"
    counts = {}
    for name, flags in codecs.items():
        argv = ["--indices", str(idx), "--rate-key", "none", "--reps", "1",
                "--keep-bitstream", "--device", "cuda", *flags]
        warm_up(work, cube[:, :2 * STRIP_ROWS_AUTO], "caseB", argv[2:])
        res, wall, k1, rss = measured_sweep(
            argv + ["--outdir", str(work / f"s_{name}")])
        (phase,) = res["phases"]
        if phase.get("rows") != STRIP_ROWS_AUTO:
            raise AssertionError(f"9b {name}: did not stream by itself: "
                                 f"{phase}")
        (row,) = read_rows(work / f"s_{name}" / "metrics.csv")
        if (row["lossless"], row["max_abs_err"]) != ("1", "0"):
            raise AssertionError(f"9b {name}: not lossless: {row}")
        t1 = time.perf_counter()
        if not equal_to_source(work / f"s_{name}" / run / "recon.tif", cube):
            raise AssertionError(f"9b {name}: streamed recon.tif != scene")
        log(f"[stream] 9b {name}: recon.tif == scene, read back in "
            f"{time.perf_counter() - t1:.1f} s")

        whole = {}

        def whole_cube(cfg):
            # no artifacts, so the kept streams are taken from the codec's
            # results as the runner receives them
            cfg.stream_auto_bytes = 1 << 40
            sweep = cfg.codec.sweep_rates

            def keeping(*a, **kw):
                out = sweep(*a, **kw)
                whole.update(out[0].bitstreams)
                return out
            cfg.codec.sweep_rates = keeping
        wres, wwall, wk1, wrss = measured_sweep(
            argv + ["--no-artifacts", "--outdir", str(work / f"w_{name}")],
            whole_cube)
        if "codec_s" not in wres["phases"][0]:
            raise AssertionError(f"9b {name}: the whole-cube run streamed")
        streamed = strip_streams(work / f"s_{name}" / run / "bit")
        if streamed != whole or len(whole) != tiles:
            raise AssertionError(f"9b {name}: strip streams != whole-cube "
                                 f"streams ({len(streamed)}/{len(whole)})")
        want = per_tile[name] * tiles
        if not k1 == wk1 == want:
            raise AssertionError(f"9b {name}: K1 launched {k1} (streamed), "
                                 f"{wk1} (whole), expected {want}")
        if rss >= wrss:
            raise AssertionError(f"9b {name}: RSS delta {rss:.0f} MB not "
                                 f"below the whole-cube run's {wrss:.0f}")
        (wrow,) = read_rows(work / f"w_{name}" / "metrics.csv")
        log(f"[stream] 9b {name}: streamed wall {wall:.2f} s "
            f"({cube.size / wall / 1e6:.1f} Msamples/s), "
            f"{-(-SCENE_B_ROWS // STRIP_ROWS_AUTO)} strips, t_comp_s "
            f"{row['t_comp_s']}, t_dec_s {row['t_dec_s']}, hbm_peak_mb "
            f"{row.get('hbm_peak_mb')}, RSS delta {rss:.1f} MB, "
            f"{row['bitstream_bytes']} B in {tiles} tile streams == "
            f"whole-cube; whole-cube run {wwall:.2f} s, t_comp_s "
            f"{wrow['t_comp_s']}, t_dec_s {wrow['t_dec_s']}, hbm_peak_mb "
            f"{wrow.get('hbm_peak_mb')}, RSS delta {wrss:.1f} MB; {k1} K1 "
            f"launches each on {card}")
        counts[f"caseB_scene_stream_{name}"] = k1
        counts[f"caseB_scene_whole_{name}"] = wk1
        for d in (f"s_{name}", f"w_{name}"):
            shutil.rmtree(work / d)
    device_busy([
        "--indices", str(idx), "--codec", "ccsds123", "--rate-key", "none",
        "--reps", "1", "--no-artifacts", "--outdir", str(work / "traced"),
        "--device", "cuda"], card, "stream 9b ccsds123")
    shutil.rmtree(work / "traced")
    return counts, cube


def run_stream_metrics(work: Path, scene: np.ndarray, card):
    """Phase 9c: a 32 x 1280 x 512 crop of 9b's scene with a NoData stripe
    and a user mask, its noisy recon pre-seeded (the resume path), streamed
    in 512-row strips on the card and on the CPU: integers and the ERR8 and
    RGB8 quicklooks exact, PSNR/SSIM within rel 1e-5, SAM/SID/LMSE within
    rel 1e-4."""
    crop = np.ascontiguousarray(scene[:32, :1280, :512])
    nodata = -32768
    crop[:, :64] = nodata
    crop[:, 400:432, :100] = nodata
    src = work / "crop.tif"
    tiff.write_geotiff(src, crop, nodata=nodata)
    mask = np.ones(crop.shape[1:], np.uint8)
    mask[:80] = 0
    mask[:, :16] = 0
    tiff.write_geotiff(work / "crop_mask.tif", mask, nodata=0)
    idx = work / "index_crop.json"
    manifest.write_manifest(idx, "caseB", "scene", [
        {"tile_id": "CR", "path": src, "mask": work / "crop_mask.tif"}])
    rng = np.random.default_rng(7)
    noisy = (crop.astype(np.int32)
             + rng.integers(-12, 12, crop.shape)).astype(np.int16)
    rows, walls = {}, {}
    for dev in ("cuda", "cpu"):
        d = work / dev / "CR" / "norate" / "rep_01"
        d.mkdir(parents=True)
        tiff.write_geotiff(d / "recon.tif", noisy)
        t0 = time.perf_counter()
        run_codec(["--indices", str(idx), "--codec", "ccsds121",
                   "--rate-key", "none", "--reps", "1", "--stream-rows",
                   "512", "--ql-rgb", "--ql-err-zoom", "15", "--outdir",
                   str(work / dev), "--device", dev])
        walls[dev] = time.perf_counter() - t0
        (rows[dev],) = read_rows(work / dev / "metrics.csv")
    got, want = rows["cuda"], rows["cpu"]
    if not (math.isfinite(num(got["sam_deg"])) and num(got["lmse"]) > 0
            and got["lossless"] == "0"):
        raise AssertionError(f"9c: trivial metrics: {got}")
    worst = {}
    for col, w in want.items():
        if col.startswith(("t_", "mem_", "hbm_")) and \
                not col.startswith("t_link_tile_s"):
            continue
        tol = (1e-5 if col.startswith(("psnr", "ssim")) else
               1e-4 if col.startswith(("sam_deg", "sid", "lmse")) else None)
        if tol is None:
            if got[col] != w:
                raise AssertionError(f"9c: {col} CUDA {got[col]} != CPU {w}")
            continue
        a, b = num(w), num(got[col])
        rel = abs(a - b) / abs(a) if a else abs(b)
        worst[col.split("_b")[0]] = max(worst.get(col.split("_b")[0], 0), rel)
        if rel > tol:
            raise AssertionError(f"9c: {col} CUDA {b} vs CPU {a}: rel {rel}")
    run = Path("CR") / "norate" / "rep_01"
    for name in ("recon_ERR8_0_255.tif", "recon_ERR8_0_15.tif",
                 "baseline_RGB8.tif", "recon_RGB8.tif"):
        if (work / "cuda" / run / name).read_bytes() != \
                (work / "cpu" / run / name).read_bytes():
            raise AssertionError(f"9c: {name} CUDA != CPU")
    log(f"[stream] 9c CUDA == CPU on the crop (32 x 1280 x 512, 3 strips): "
        f"SAM {got['sam_deg']} deg, PSNR {got['psnr_global']} dB; worst "
        f"rel {worst}; quicklooks byte-equal; wall CUDA {walls['cuda']:.2f} "
        f"s, CPU {walls['cpu']:.2f} s on {card}")


def same_outputs(a: Path, b: Path, tag: str, differ=None) -> int:
    """Every file of two pipeline runs byte for byte (a manifest up to its
    output directory; the error map ``differ`` of another mode by name
    only); returns the file count."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    if differ:
        fb = sorted(Path(differ) if "scene_ERR_" in p.name else p
                    for p in fb)
    if fa != fb or not fa:
        raise AssertionError(f"{tag}: files differ: {fa} / {fb}")
    for rel in fa:
        if rel.name == differ:
            continue
        x, y = (a / rel).read_bytes(), (b / rel).read_bytes()
        if rel.suffix == ".json":
            x, y = (x.replace(str(a).encode(), b"OUT"),
                    y.replace(str(b).encode(), b"OUT"))
        if x != y:
            raise AssertionError(f"{tag}: {rel} CUDA != CPU")
    return len(fa)


def enmap_products(raw: Path, rng):
    """Two adjacent synthetic EnMAP products of 224 bands x 1000 x 1000
    int16 (NoData -32768 in a corner), with metadata XML (wavelengths, two
    bad bands, the quality-flag bits), QUALITY_TESTFLAGS (cloud rows) and
    PIXELMASK (defect columns): tests/test_pipelines.py's layout at full
    size."""
    raw.mkdir()
    nb, n = ENMAP_BANDS, ENMAP_SIZE
    gains = 0.6 + 0.8 * np.abs(np.sin(np.linspace(0.3, 5.8, nb)))
    for k, x0 in (("001", 600000.0), ("002", 600000.0 + 30.0 * n)):
        tr = (30.0, 0.0, x0, 0.0, -30.0, 4700000.0)
        spatial = rng.integers(500, 6500, (n, n)).astype(np.float64)
        cube = np.empty((nb, n, n), np.int16)
        for b in range(nb):
            cube[b] = np.clip(spatial * gains[b]
                              + rng.integers(-40, 40, (n, n)), -8192, 8191)
        cube[:, :50, :50] = -32768
        tiff.write_geotiff(raw / f"ENMAP-DT01-{k}-SPECTRAL_IMAGE.TIF", cube,
                           transform=tr, nodata=-32768)
        flags = np.zeros((1, n, n), np.uint16)
        flags[0, 100:160] = 0b10
        tiff.write_geotiff(raw / f"ENMAP-DT01-{k}-QL_QUALITY_TESTFLAGS.TIF",
                           flags, transform=tr)
        pixm = np.zeros((1, n, n), np.uint8)
        pixm[0, :, 700:705] = 1
        tiff.write_geotiff(raw / f"ENMAP-DT01-{k}-QL_PIXELMASK.TIF", pixm,
                           transform=tr)
    bands = "\n".join(
        f"<bandID number='{i + 1}'><wavelengthCenterOfBand>"
        f"{420 + 9.5 * i:.1f}</wavelengthCenterOfBand><badBand>"
        f"{1 if i in (60, 61) else 0}</badBand></bandID>" for i in range(nb))
    (raw / "ENMAP-DT01-METADATA.XML").write_text(
        f"<root><bands>{bands}</bands>"
        "<flagBit index='1' meaning='quality cloud'/>"
        "<flagBit index='2' meaning='quality cloud shadow'/></root>")


def run_pipelines(work: Path, card):
    """Phase 9d: make-baseline-a and make-baseline-b through the CLI on the
    card and with --device cpu, every output file byte for byte. Case A:
    four synthetic 10,980² uint16 bands (a Sentinel-2 10 m band's size),
    the defaults (2000 x 10000 scene, HC 300,688, LC 488,7012). Case B: two
    synthetic 224-band 1000² products -> 180 bands, --k 2; the default
    --err-mode on both devices, the other four on the card, each one's
    error map held to the CPU's (a CPU run of every mode took 14-21 s); the
    mosaic is 1000 x 2000, so the tiles sit at LC 580,400 and HC 1400,64
    (the reference's 580,5620 and 2000,1536 lie outside it)."""
    from contextlib import redirect_stdout
    from tpukit_torch.cli.main import main as cli_main

    def cli(argv):
        # the commands print their outputs as JSON: to the log, so that
        # this script's stdout keeps its three result lines
        with redirect_stdout(sys.stderr):
            return cli_main(argv)
    rng = np.random.default_rng(2026)
    t0 = time.perf_counter()
    bands = []
    tr = (10.0, 0.0, 600000.0, 0.0, -10.0, 5000040.0)
    for name in ("B02", "B03", "B04", "B08"):
        p = work / f"T33UUP_{name}_10m.tif"
        tiff.write_geotiff(p, rng.integers(0, 20000, (1, S2_SIZE, S2_SIZE),
                                           dtype=np.uint16), transform=tr)
        bands.append(str(p))
    made = time.perf_counter() - t0
    walls = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        if cli(["make-baseline-a", "--bands", *bands, *CASEA_FLAGS,
                "--outdir", str(work / f"A_{dev}"), "--device", dev]) != 0:
            raise AssertionError(f"make-baseline-a --device {dev} failed")
        walls[f"A {dev}"] = time.perf_counter() - t0
    n_a = same_outputs(work / "A_cuda", work / "A_cpu", "9d Case A")
    for p in bands:
        Path(p).unlink()
    t0 = time.perf_counter()
    enmap_products(work / "raw", rng)
    made_b = time.perf_counter() - t0

    def baseline_b(mode, dev):
        t0 = time.perf_counter()
        out = work / f"B_{mode}_{dev}"
        if cli(["make-baseline-b", "--input-raw", str(work / "raw"),
                "--output", str(out), "--dt", "DT01", "--k", "2",
                "--err-mode", mode, *CASEB_FLAGS, "--device", dev]) != 0:
            raise AssertionError(f"make-baseline-b {mode} {dev} failed")
        walls[f"B {mode} {dev}"] = time.perf_counter() - t0
        return out

    # the default mode on both devices, every file; the other modes on the
    # card, their error map (the one file the mode changes) against the
    # CPU's map of the same scenes and mask, written by the same PNG writer
    from PIL import Image
    from tpukit_torch.pipelines.baseline_b import scene_error_map
    ref = baseline_b("mean", "cpu")
    n_b = same_outputs(baseline_b("mean", "cuda"), ref, "9d Case B mean")
    with tiff.open(ref / "DT01_scene_180b_int16.tif") as ds:
        cube16 = ds.read()
    with tiff.open(ref / "DT01_scene_180b_14in16.tif") as ds:
        cube14 = ds.read()
    with tiff.open(ref / "DT01_scene_mask_uint8.tif") as ds:
        valid = ds.read(1) > 0
    for mode in ERR_MODES:
        if mode == "mean":
            continue
        got = baseline_b(mode, "cuda")
        name = f"DT01_scene_180b_14in16.scene_ERR_{mode}.png"
        u8, _ = scene_error_map(cube16, cube14, valid, mode, 2,
                                device="cpu")
        Image.fromarray(u8).save(work / name)
        if (work / name).read_bytes() != (got / name).read_bytes():
            raise AssertionError(f"9d Case B {mode}: {name} CUDA != CPU")
        same_outputs(got, work / "B_mean_cuda", f"9d Case B {mode}",
                     differ=name)
        shutil.rmtree(got)
    log(f"[pipelines] 9d CUDA == CPU, byte for byte: Case A {n_a} files, "
        f"Case B {n_b} files (mean); the {len(ERR_MODES) - 1} other error "
        f"modes' maps == the CPU's, their other files == mean's; inputs "
        f"made in {made:.1f} s (A) and {made_b:.1f} s (B); walls "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f" on {card}")


def run_phase9(card):
    """Phase 9; returns K1's launch counts by path."""
    t9 = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        k1_512 = run_stream512(work, card)
        times["9a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        counts, scene = run_caseb_stream(work, card)
        times["9b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_stream_metrics(work / "crop", scene, card)
        del scene
        times["9c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_pipelines(work / "pipelines", card)
        times["9d"] = time.perf_counter() - t0
    log(f"[stream] phase 9 in {time.perf_counter() - t9:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()) + ")")
    return {"scene_stream512": k1_512, **counts}


# phase 10: the rest of tpukit's command line on the card
ANCHOR_FLAGS = ["--tile", "512", "--preproc", "none", "--nbit", "16",
                "--interleave", "bip"]
COMPLEXITY_INTS = ("path", "bands", "width", "height")
REPO = Path(__file__).resolve().parent


def cli_lines(fn, argv):
    """A command's entry point in this process: (its code, its stdout
    lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue().strip().splitlines()


def complexity_close(got: dict, want: dict, tag: str):
    """tile-complexity's tolerances (tests/test_torch_complexity.py): the
    integers exact; grad_* within rel 1e-5 (grad_std on grad_mean's scale),
    the spectral metrics and delentropy_bits within rel 1e-4 (cuFFT against
    pocketfft, float32 sums in another order)."""
    if list(got) != list(want):
        raise AssertionError(f"[10a] {tag}: keys {list(got)} != {list(want)}")
    worst = {}
    for k, w in want.items():
        g = got[k]
        if k in COMPLEXITY_INTS:
            if g != w:
                raise AssertionError(f"[10a] {tag} {k}: {g} != {w}")
            continue
        rel = 1e-5 if k.startswith("grad_") else 1e-4
        scale = max(abs(w), abs(want["grad_mean"])) if k == "grad_std" \
            else abs(w)
        worst[k] = abs(g - w) / max(scale, 1e-30)
        if worst[k] > rel:
            raise AssertionError(f"[10a] {tag} {k}: CUDA {g} != CPU {w} "
                                 f"(rel {worst[k]:.2e} > {rel})")
    return worst


def run_tile_complexity(work: Path, tiles, cube, card):
    """10a: ``tile-complexity --device cuda`` on the two Case A tiles and
    the Case B tile, twice on the card (the same bits) and once with
    ``--device cpu`` (within the tolerances); the ms per tile of each."""
    from tpukit_torch.cli.main import tile_complexity_main
    paths = {}
    for tid, t in {**tiles, "caseB": cube}.items():
        paths[tid] = work / f"cx_{tid}.tif"
        tiff.write_geotiff(paths[tid], t, blockxsize=512, blockysize=512)
    for tid, p in paths.items():
        got, ms = {}, {}
        for run, device in (("cuda", "cuda"), ("cuda again", "cuda"),
                            ("cpu", "cpu")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc, lines = cli_lines(tile_complexity_main,
                                  [str(p), "--json", "--device", device])
            ms[run] = 1e3 * (time.perf_counter() - t0)
            if rc != 0:
                raise AssertionError(f"[10a] {tid} {device}: rc {rc}")
            got[run] = json.loads(lines[-1])
        if got["cuda"] != got["cuda again"]:
            raise AssertionError(f"[10a] {tid}: two card runs differ: "
                                 f"{got['cuda']} != {got['cuda again']}")
        worst = complexity_close(got["cuda"], got["cpu"], tid)
        shape = tuple((cube if tid == "caseB" else tiles[tid]).shape)
        log(f"[10a] tile-complexity {tid} {shape}: CUDA {ms['cuda']:.1f} ms "
            f"(first call), {ms['cuda again']:.1f} ms (second), CPU "
            f"{ms['cpu']:.1f} ms, each with the TIFF read, "
            f"on {card}; two card runs bit-equal; CUDA vs CPU worst rel "
            + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
        log(f"[10a] {tid} on the card: {got['cuda']}")
    return paths


def run_wrapper_anchor(work: Path, src: Path, cube: np.ndarray, anchor,
                       card) -> int:
    """10b: ``codec-ccsds121`` with the anchor flags on the card, in this
    process: a JSON last line, recon == the tile, the kept stream == phase
    3's; returns K1's launches (one per plan chunk)."""
    from tpukit_torch.cli import wrappers
    out = work / "wrap121"
    fs_table.launches = 0
    t0 = time.perf_counter()
    rc, lines = cli_lines(wrappers.ccsds121_main, [
        "--in", str(src), "--out", str(out / "recon.tif"),
        "--keep-bitstream", str(out / "bit"), *ANCHOR_FLAGS,
        "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = fs_table.launches
    meta = json.loads(lines[-1])
    nchunks = -(-cube.size // PLAN_CHUNK)
    if rc != 0 or k1 != nchunks:
        raise AssertionError(f"[10b] rc {rc}, K1 {k1} (expected {nchunks})")
    stream = (out / "bit" / "t_x00000_y00000.aec").read_bytes()
    if stream != anchor["stream"]:
        raise AssertionError("[10b] kept stream != phase 3's anchor stream")
    if meta["codec"] != "ccsds121_ext" or \
            meta["bitstream_bytes"] != len(stream):
        raise AssertionError(f"[10b] JSON {meta}")
    with tiff.open(out / "recon.tif") as ds:
        if not np.array_equal(ds.read(), cube):
            raise AssertionError("[10b] recon.tif != the tile")
    log(f"[10b] codec-ccsds121 (anchor flags) wall {wall:.2f} s, "
        f"t_comp_s {meta['t_comp_s']:.3f}, t_dec_s {meta['t_dec_s']:.3f}, "
        f"{k1} K1 launches, stream == phase 3's ({len(stream)} B), recon == "
        f"tile, on {card}")
    return k1


def run_wrapper_j2k(work: Path, src: Path, kept_q40, card):
    """10c: ``codec-j2k --quality 40 --entropy device`` on the HC tile on
    the card: K2 launched as ``plan`` schedules one 1024² transform, the
    kept streams == phase 8c's q 40 streams. (The ``ebcot`` wrapper emits a
    quality point whole, without pricing, in tpukit as in the port: no K2
    there and no phase 5 stream to equal.) Returns (K1, K2) launches."""
    from tpukit_torch.cli import wrappers
    out = work / "wrapj2k"
    fs_table.launches = 0
    dwt97.launches = 0
    t0 = time.perf_counter()
    rc, lines = cli_lines(wrappers.j2k_main, [
        "--in", str(src), "--out", str(out / "recon.tif"),
        "--keep-bitstream", str(out / "bit"), "--quality", "40",
        "--entropy", "device", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fs_table.launches, dwt97.launches
    meta = json.loads(lines[-1])
    if rc != 0 or k2 != len(plan(1024, 1024, 5)):
        raise AssertionError(f"[10c] rc {rc}, K2 {k2}")
    streams = kept_streams(out)
    if streams != kept_q40:
        raise AssertionError("[10c] kept streams != phase 8c's q 40 streams")
    if meta["bitstream_bytes"] != sum(map(len, streams.values())):
        raise AssertionError(f"[10c] JSON {meta}")
    log(f"[10c] codec-j2k --quality 40 --entropy device wall {wall:.2f} s, "
        f"{meta['bitstream_bytes']} B in {len(streams)} streams == phase 8c's, "
        f"{k1} K1 and {k2} K2 launches, on {card}")
    return k1, k2


def child_startup(card):
    """What a wrapper child pays before it codes, in one fresh process that
    stamps each step on its own clock: torch's import, CUDA's
    initialisation, the kernels' and the host library's load, the port's
    CLI; the interpreter's start is the rest of the process's wall."""
    code = (
        "import json, time; t = [time.perf_counter()]\n"
        "import torch; t.append(time.perf_counter())\n"
        "torch.zeros(1, device='cuda'); torch.cuda.synchronize()\n"
        "t.append(time.perf_counter())\n"
        "from tpukit_torch.kernels import build; build.load()\n"
        "from tpukit_torch import native; native.load()\n"
        "t.append(time.perf_counter())\n"
        "from tpukit_torch.cli import main, wrappers\n"
        "t.append(time.perf_counter())\n"
        "print(json.dumps([b - a for a, b in zip(t, t[1:])]))\n")
    env = dict(__import__("os").environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         check=True, capture_output=True, text=True).stdout
    wall = time.perf_counter() - t0
    steps = json.loads(out.strip().splitlines()[-1])
    names = ("import torch", "CUDA init", "kernel and host library load",
             "the port's CLI import")
    log(f"[10d] a child's start-up, {wall:.2f} s in all (host clock): "
        + ", ".join(f"{n} {v:.2f} s" for n, v in zip(names, steps))
        + f", the interpreter's start and exit {wall - sum(steps):.2f} s; "
        f"on {card}")


def run_compressor_cmd(work: Path, cube: np.ndarray, anchor, card):
    """10d: ``run-codec --compressor-cmd`` over ``python3 -m tpukit_torch
    codec-ccsds121 --device cuda`` (a two-line script: argparse's
    ``nargs="+"`` stops at ``-m``), the anchor flags after ``--``, 1 rep:
    lossless, phase 3's bytes and stream, its row but for the time and
    memory columns. K1 runs in the child, where this process cannot count
    it."""
    script = work / "codec_ccsds121_cuda.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from tpukit_torch.cli.main import main\n"
        "sys.exit(main(['codec-ccsds121', '--device', 'cuda', "
        "*sys.argv[1:]]))\n")
    idx = write_caseb_index(work, cube, "cmd")
    out = work / "runsCmd"
    t0 = time.perf_counter()
    res = run_codec([
        "--indices", str(idx), "--codec", "ccsds121", "--rate-key", "none",
        "--reps", "1", "--keep-bitstream", "--outdir", str(out),
        "--device", "cuda", "--compressor-cmd", sys.executable, str(script),
        "--", *ANCHOR_FLAGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (row,) = read_rows(out / "metrics.csv")
    stream = (out / "T01" / "norate" / "rep_01" / "bit"
              / "t_x00000_y00000.aec").read_bytes()
    if row["lossless"] != "1" or stream != anchor["stream"]:
        raise AssertionError(f"[10d] lossless {row['lossless']}, stream == "
                             f"phase 3's: {stream == anchor['stream']}")
    same_rows([row], [anchor["row"]], "[10d] row vs phase 3's")
    t_codec = num(row["t_comp_s"]) + num(row["t_dec_s"])
    (phase,) = res["phases"]
    log(f"[10d] --compressor-cmd sweep wall {wall:.2f} s, phases "
        f"{res['phases']}; the child's t_comp_s {row['t_comp_s']}, t_dec_s "
        f"{row['t_dec_s']}: its codec phase {phase['codec_s']:.2f} s is "
        f"{phase['codec_s'] - t_codec:.2f} s beyond the codec's timed work "
        f"(the child's start-up, the tile's TIFF write and the recon's "
        f"read); row == phase 3's but time and memory; on {card}")
    child_startup(card)


def run_sweep_rd(tile: np.ndarray, ladder_hc, card) -> int:
    """10e: ``J2KCodec.sweep_rd`` on the HC tile at bench.py's 14 qualities
    on the card: the device mode's ladder with its metrics, held to phase
    6b's rep 1 rows of the same tile (its CSV through the runner: bytes,
    max|Δ| and the lossless flag exact, PSNR/SSIM within rel 1e-5). Returns
    K2's launches."""
    dwt97.launches = 0
    t0 = time.perf_counter()
    rows = J2KCodec(entropy="device").sweep_rd(tile, "uint16", RATES_A,
                                                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = dwt97.launches
    if k2 != len(plan(1024, 1024, 5)):
        raise AssertionError(f"[10e] K2 {k2}")
    worst = 0.0
    for q, (res, met) in zip(RATES_A, rows):
        ref = ladder_hc[q]
        if res.bitstream_bytes != int(ref["bitstream_bytes"]):
            raise AssertionError(f"[10e] q={q}: {res.bitstream_bytes} B != "
                                 f"phase 6b's {ref['bitstream_bytes']}")
        if (met["max_abs_err"], met["lossless"]) != \
                (int(num(ref["max_abs_err"])), int(ref["lossless"])):
            raise AssertionError(f"[10e] q={q}: max|Δ| / lossless")
        for k, v in met.items():
            if k.startswith(("psnr", "ssim")) and ref.get(k):
                rel = abs(v - num(ref[k])) / max(abs(num(ref[k])), 1e-30)
                worst = max(worst, rel)
                if rel > 1e-5:
                    raise AssertionError(f"[10e] q={q} {k}: {v} != "
                                         f"{ref[k]}")
    log(f"[10e] sweep_rd HC at {len(RATES_A)} qualities: wall {wall:.2f} s, "
        f"{k2} K2 launches, bytes == phase 6b's, PSNR/SSIM worst rel "
        f"{worst:.1e} (the CSV's 6 decimals), on {card}")
    return k2


def run_profiled_anchor(work: Path, cube: np.ndarray, card) -> int:
    """10f: one anchor rep with and without ``--profile``: a Chrome trace
    naming K1's kernel; both walls. Returns K1's launches in the profiled
    run."""
    idx = write_caseb_index(work, cube, "prof")
    argv = ["--indices", str(idx), "--codec", "ccsds121", "--rate-key",
            "none", "--reps", "1", *ANCHOR_FLAGS, "--device", "cuda"]
    walls = {}
    for tag, extra in (("plain", []), ("profiled",
                                       ["--profile", str(work / "prof")])):
        fs_table.launches = 0
        t0 = time.perf_counter()
        if run_codec_main(argv + ["--outdir", str(work / f"runs_{tag}"),
                                  *extra]) != 0:
            raise AssertionError(f"[10f] {tag}: rc != 0")
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
    k1 = fs_table.launches
    trace = work / "prof" / "trace.json"
    text = trace.read_text()
    if "fs_table_kernel" not in text:
        raise AssertionError("[10f] the trace does not name K1's kernel")
    log(f"[10f] anchor rep {walls['plain']:.2f} s, with --profile "
        f"{walls['profiled']:.2f} s (trace {trace.stat().st_size / 1e6:.1f} "
        f"MB, names fs_table_kernel, {text.count('fs_table_kernel')} "
        f"mentions, {k1} K1 launches), on {card}")
    return k1


def run_doctor(card):
    """10g: ``doctor --smoke --device cuda``: rc 0 and every row ok.
    Returns its (K1, K2) launches."""
    from tpukit_torch.cli.main import doctor_main
    fs_table.launches = 0
    dwt97.launches = 0
    t0 = time.perf_counter()
    rc, lines = cli_lines(doctor_main, ["--smoke", "--device", "cuda"])
    wall = time.perf_counter() - t0
    rows = [ln for ln in lines if ln.startswith("[")]
    bad = [ln for ln in rows if not ln.startswith("[ok ]")]
    if rc != 0 or bad or len(rows) != 10:
        raise AssertionError(f"[10g] rc {rc}, rows {rows}")
    log(f"[10g] doctor --smoke --device cuda in {wall:.1f} s, all "
        f"{len(rows)} rows ok:\n" + "\n".join(rows))
    return fs_table.launches, dwt97.launches


def run_figures(work: Path, mean_csv: str, card):
    """10h: ``rd-curve`` from phase 5's metrics_mean.csv where pandas and
    matplotlib import; where they do not, the named refusal."""
    from tpukit_torch.cli.main import rd_curve_main
    src = work / "metrics_mean.csv"
    src.write_text(mean_csv)
    missing = []
    for name in ("pandas", "matplotlib"):
        try:
            __import__(name)
        except ImportError:
            missing.append(name)
    argv = ["--csv", str(src), "--out-prefix", str(work / "fig" / "rd")]
    if not missing:
        if rd_curve_main(argv) != 0:
            raise AssertionError("[10h] rd-curve rc != 0")
        figs = sorted(p.name for p in (work / "fig").glob("*.png"))
        if not figs:
            raise AssertionError("[10h] rd-curve drew nothing")
        log(f"[10h] rd-curve drew {figs} from phase 5's CSV")
        return
    try:
        rd_curve_main(argv)
    except SystemExit as e:
        if not (isinstance(e.code, str) and missing[0] in e.code):
            raise AssertionError(f"[10h] refusal {e.code!r} does not name "
                                 f"{missing[0]}")
        log(f"[10h] {', '.join(missing)} not installed on this machine: "
            f"rd-curve refused, naming it: {e.code}")
        return
    raise AssertionError(f"[10h] rd-curve ran without {missing}")


def run_phase10(card, tiles, cube, refs):
    """Phase 10; returns the launch counts by path. ``refs``: phase 3's
    anchor stream and row, phase 5's metrics_mean.csv, phase 6b's HC rows
    and phase 8c's kept HC q 40 streams."""
    t10 = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        work = Path(tmp)
        for tag, fn in (
                ("10a", lambda: run_tile_complexity(work, tiles, cube, card)),
                ("10b", lambda: run_wrapper_anchor(
                    work, work / "cx_caseB.tif", cube, refs["anchor"], card)),
                ("10c", lambda: run_wrapper_j2k(
                    work, work / "cx_HC.tif", refs["kept_q40"], card)),
                ("10d", lambda: run_compressor_cmd(work, cube, refs["anchor"],
                                                   card)),
                ("10e", lambda: run_sweep_rd(tiles["HC"], refs["ladder_hc"],
                                             card)),
                ("10f", lambda: run_profiled_anchor(work, cube, card)),
                ("10g", lambda: run_doctor(card)),
                ("10h", lambda: run_figures(work, refs["mean_csv"], card))):
            t0 = time.perf_counter()
            times[tag] = (fn(), time.perf_counter() - t0)
    log(f"[cli] phase 10 in {time.perf_counter() - t10:.1f} s ("
        + ", ".join(f"{k} {v[1]:.1f} s" for k, v in times.items()) + ")")
    (wrap_k1, (j2k_k1, j2k_k2), rd_k2, prof_k1, (doc_k1, doc_k2)) = (
        times["10b"][0], times["10c"][0], times["10e"][0], times["10f"][0],
        times["10g"][0])
    # the smoke's codecs run no 9/7 (J2K lossless is 5/3, CCSDS-122 the
    # integer 9/7M): a path is listed under the kernels it launches
    k1 = {"codec_ccsds121_wrapper": wrap_k1, "codec_j2k_wrapper_q40": j2k_k1,
          "profiled_anchor_rep": prof_k1, "doctor_smoke": doc_k1}
    k2 = {"codec_j2k_wrapper_q40": j2k_k2, "sweep_rd": rd_k2,
          "doctor_smoke": doc_k2}
    return {"k1": {k: v for k, v in k1.items() if v},
            "k2": {k: v for k, v in k2.items() if v}}


# ---------------------------------------------------------------------------
# phase 11: the device mesh on the card (--mesh DP[,SP], parallel/mesh.py)

MESH = "4,2"                     # eight positions, on one card or wrapped
MESH_STREAM_SCENE = (BANDS, 1024, 512)     # 11d: two 512-row strips
MESH_STREAM_ROWS = 512


def tree_digest(out: Path) -> dict:
    """{path: sha256} of every file of a run directory but its CSVs."""
    return {str(p.relative_to(out)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(out.rglob("*"))
            if p.is_file() and p.suffix != ".csv"}


def same_device(dev0: int, tag: str):
    """The caller's current device after a phase's launches."""
    if torch.cuda.current_device() != dev0:
        raise AssertionError(f"{tag}: the current device moved from "
                             f"cuda:{dev0} to cuda:"
                             f"{torch.cuda.current_device()}")


def mesh_sweep(tag: str, argv, mesh, out: Path, card):
    """One ``run-codec`` sweep on the card with ``--mesh mesh`` (none when
    None), K1 and K2 counted from 0, the device-memory peak reset before;
    returns (rows, K1, K2, wall s)."""
    dev0 = torch.cuda.current_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs_table.launches = 0
    dwt97.launches = 0
    t0 = time.perf_counter()
    res = run_codec(argv + ["--outdir", str(out), "--device", "cuda"]
                    + (["--mesh", mesh] if mesh else []))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fs_table.launches, dwt97.launches
    same_device(dev0, tag)
    log(f"[{tag}] {f'--mesh {mesh}' if mesh else 'no mesh'}: sweep wall {wall:.2f} s, phases "
        f"{res['phases']}, {k1} K1 and {k2} K2 launches, hbm_peak_mb "
        f"{torch.cuda.max_memory_allocated() / (1 << 20):.1f} (reset before "
        f"the sweep) on {card}")
    return read_rows(out / "metrics.csv"), k1, k2, wall


def run_mesh_ladder(work: Path, tiles, ref_rows, card):
    """11a: the Case A device ladder with ``--mesh 4,2`` and ``--mesh 1``:
    CSVs equal but the time and memory columns, every artifact byte-equal
    (rep 1's recon.tif included), bytes equal to phase 6b's no-mesh CSV
    and PSNR/SSIM within rel 1e-4 of it; K2 four launches a transform on
    every position that takes a point, K1 three a point. With two cards or
    more, ``--mesh 2`` across two of them == ``--mesh 1``. Returns the
    launch counts by path."""
    idx = write_index(work, tiles, "mesh_ladder")
    argv = ["--indices", str(idx), "--codec", "j2k", "--entropy", "device",
            "--rate-key", "quality", "--rates", *map(str, RATES_A)]
    k2_dwt = len(plan(1024, 1024, 5))
    got = {}
    for mesh, npos in ((MESH, 8), ("1", 1)):
        rows, k1, k2, _ = mesh_sweep("11a", argv + ["--reps", "3"], mesh,
                                     work / f"ladder_{npos}", card)
        want_k2 = min(npos, len(RATES_A)) * k2_dwt * 3 * len(tiles)
        want_k1 = 3 * len(RATES_A) * 3 * len(tiles)
        if (k1, k2) != (want_k1, want_k2):
            raise AssertionError(f"11a --mesh {mesh}: K1 {k1}, K2 {k2}; "
                                 f"expected {want_k1}, {want_k2}")
        got[mesh] = (rows, k1, k2)
    same_rows(got[MESH][0], got["1"][0], "11a --mesh 4,2 vs --mesh 1")
    d8, d1 = tree_digest(work / "ladder_8"), tree_digest(work / "ladder_1")
    if d8 != d1 or not any(k.endswith("rep_01/recon.tif") for k in d8):
        raise AssertionError("11a: the artifacts of --mesh 4,2 != --mesh 1")
    exact, worst = True, 0.0
    for g, w in zip(got[MESH][0], ref_rows):
        if (g["tile_id"], g["rate_value"], g["bitstream_bytes"]) != \
                (w["tile_id"], w["rate_value"], w["bitstream_bytes"]):
            raise AssertionError(f"11a: bytes != phase 6b's: {g} / {w}")
        for col in ("psnr_global", "ssim_global"):
            a, b = num(g[col]), num(w[col])
            rel = abs(a - b) / max(abs(b), 1e-12)
            worst = max(worst, rel)
            if rel > 1e-4:
                raise AssertionError(f"11a {col}: {a} vs phase 6b's {b}")
    try:
        same_rows(got[MESH][0], ref_rows, "11a vs 6b")
    except AssertionError:
        exact = False
    log(f"[11a] --mesh 4,2 == --mesh 1 (rows but time and memory, {len(d8)} "
        f"files byte-equal); bytes == phase 6b's no-mesh run, PSNR/SSIM "
        f"worst rel {worst:.2e}; rows exactly equal to 6b's: {exact}")
    traced_sweep("11a mesh", argv + [
        "--reps", "1", "--no-artifacts", "--mesh", MESH, "--outdir",
        str(work / "ladder_traced"), "--device", "cuda"], card)
    paths = {"k1": {"mesh_ladder_4x2": got[MESH][1],
                    "mesh_ladder_1": got["1"][1]},
             "k2": {"mesh_ladder_4x2": got[MESH][2],
                    "mesh_ladder_1": got["1"][2]}}
    if torch.cuda.device_count() >= 2:
        rows2, k1, k2, _ = mesh_sweep("11f", argv + ["--reps", "1"], "2",
                                      work / "ladder_2cards", card)
        same_rows(rows2, got["1"][0][::3], "11f --mesh 2 on two cards")
        log("[11f] --mesh 2 across two cards == --mesh 1 (rep 1 rows)")
        paths["k1"]["mesh_ladder_2cards"] = k1
        paths["k2"]["mesh_ladder_2cards"] = k2
    return paths


def run_mesh_anchor(work: Path, cube: np.ndarray, anchor, card) -> int:
    """11b: bench.py's Case B command with ``--mesh 4,2``: one mesh plan,
    equal to the plan of the same stream at the same chunk on one
    position and as long as phase 3's plan; K1 once per chunk; every
    rep's stream == phase 3's (the serial coder's) and lossless; the rows
    == phase 3's but the time and memory columns. Returns K1."""
    idx = write_caseb_index(work, cube, "caseB_mesh")
    plans = []
    encode_plan = model.encode_plan

    def recording_plan(*a, **kw):
        plans.append(encode_plan(*a, **kw))
        return plans[-1]

    model.encode_plan = recording_plan
    try:
        rows, k1, k2, _ = mesh_sweep("11b", [
            "--indices", str(idx), "--codec", "ccsds121", "--rate-key",
            "none", "--reps", "3", "--preproc", "none", "--nbit", "16",
            "--interleave", "bip", "--tile", str(SIZE), "--keep-bitstream"],
            MESH, work / "anchor_mesh", card)
    finally:
        model.encode_plan = encode_plan
    n = BANDS * SIZE * SIZE
    chunk = min(PLAN_CHUNK, max(16, n // 16))      # 8 positions
    chunk -= chunk % 16
    if len(plans) != 1 or plans[0] is None:
        raise AssertionError(f"11b: expected one mesh plan, got {plans}")
    (pm,) = plans
    if k1 != len(pm["sizes"]) or pm["sizes"][0] != chunk:
        raise AssertionError(f"11b: K1 {k1} for {len(pm['sizes'])} chunks "
                             f"of {pm['sizes'][0]} samples (want {chunk})")
    flat = flat_stream(torch.from_numpy(cube).cuda(), 0, 0, SIZE, SIZE,
                       "none", "bip")
    if pm != model.encode_plan(flat, chunk=chunk):
        raise AssertionError("11b: mesh plan != one position's plan")
    if pm["total_bits"] != anchor["plan"]["total_bits"]:
        raise AssertionError("11b: mesh plan's length != phase 3's plan's")
    for rep in range(1, 4):
        d = work / "anchor_mesh" / "T01" / "norate" / f"rep_{rep:02d}"
        if (d / "bit" / "t_x00000_y00000.aec").read_bytes() != \
                anchor["stream"]:
            raise AssertionError(f"11b rep {rep}: stream != serial coder")
    same_rows(rows, anchor["rows"], "11b vs phase 3")
    log(f"[11b] mesh plan of {len(pm['sizes'])} chunks == one position's, "
        f"{pm['total_bits']} bits as phase 3's; 3 reps lossless, streams == "
        f"the serial coder's, rows == phase 3's; {k1} K1 launches")
    return k1


def run_mesh_ccsds122(work: Path, tiles, ref, card):
    """11c: phase 8a's CCSDS-122 BPE ladder with ``--mesh 4,2``: rows,
    kept streams and recons (every file) == phase 8a's."""
    idx = write_index(work, tiles, "mesh122")
    rows, k1, k2, _ = mesh_sweep("11c", [
        "--indices", str(idx), "--codec", "ccsds122", "--entropy", "bpe",
        "--rate-key", "bpp", "--rates", *RATES_122, "--reps", "1",
        "--keep-bitstream"], MESH, work / "c122_mesh", card)
    same_rows(rows, ref["rows"], "11c vs phase 8a")
    dig = tree_digest(work / "c122_mesh")
    if dig != ref["digest"]:
        raise AssertionError("11c: files != phase 8a's: " + str(sorted(
            k for k in set(dig) | set(ref["digest"])
            if dig.get(k) != ref["digest"].get(k))[:5]))
    log(f"[11c] --mesh 4,2 BPE ladder: rows and {len(dig)} files (kept .bpe "
        f"streams, recons, quicklooks) == phase 8a's; K1 {k1}, K2 {k2}")
    return k1


def run_mesh_stream(work: Path, card):
    """11d: a 180 x 1024 x 512 Case B scene streamed in 512-row strips
    through the anchor's CCSDS-121 flags, 2 reps, streams kept, with
    ``--mesh 2`` and without: rows and every file equal, K1 the same."""
    cube = make_caseb_scene(np.random.default_rng(11), *MESH_STREAM_SCENE,
                            "cuda")
    src = work / "mesh_scene.tif"
    tiff.write_geotiff(src, cube, blockxsize=512, blockysize=512)
    idx = work / "index_mesh_scene.json"
    manifest.write_manifest(idx, "caseB", "scene",
                            [{"tile_id": "meshB", "path": src}])
    argv = ["--indices", str(idx), "--codec", "ccsds121", "--rate-key",
            "none", "--reps", "2", "--preproc", "none", "--nbit", "16",
            "--interleave", "bip", "--tile", str(SIZE), "--keep-bitstream",
            "--stream-rows", str(MESH_STREAM_ROWS)]
    r0, k1_0, _, _ = mesh_sweep("11d", argv, None, work / "stream_single",
                                card)
    r2, k1_2, _, _ = mesh_sweep("11d", argv, "2", work / "stream_mesh", card)
    same_rows(r2, r0, "11d --mesh 2 vs no mesh")
    d0, d2 = tree_digest(work / "stream_single"), tree_digest(
        work / "stream_mesh")
    if d0 != d2:
        raise AssertionError("11d: streamed files differ with --mesh 2")
    tiles = (MESH_STREAM_SCENE[1] // SIZE) * (MESH_STREAM_SCENE[2] // SIZE)
    n = BANDS * SIZE * SIZE           # a tile's stream; planned once a strip
    want = (-(-n // PLAN_CHUNK) if n > PLAN_CHUNK else 0) * tiles * 2
    if not k1_0 == k1_2 == want:
        raise AssertionError(f"11d: K1 {k1_0} / {k1_2}, expected {want}")
    if [r["lossless"] for r in r2] != ["1", "1"]:
        raise AssertionError(f"11d: not lossless: {r2}")
    log(f"[11d] streamed with --mesh 2 == without: rows, {len(d0)} files "
        f"(recon.tif, strip streams, quicklooks); {k1_2} K1 launches each")
    return k1_2


def close(got, want, rel, tag):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    if not np.all(np.isfinite(got)) or err.max() > rel:
        raise AssertionError(f"{tag}: worst rel {err.max():.2e} > {rel}")
    return float(err.max())


# per-band first centred moments are zero in exact arithmetic: held through
# the PSNR/SSIM they feed, not alone
_CENTRED = ("sum_ac", "sum_rc")


def hold_steps(a: dict, b: dict, tag: str, spectral_rel: float) -> float:
    """Two runs of the library steps: integers exact, float32 sums within
    rel 1e-5 (spectral ones within ``spectral_rel``)."""
    worst = 0.0
    for key in sorted(a):
        x, y = a[key], b[key]
        if isinstance(x, dict):
            worst = max(worst, hold_steps(x, y, f"{tag}.{key}",
                                          spectral_rel))
            continue
        if key in _CENTRED:
            continue
        if x.dtype.kind in "iub" or key == "n":
            if not np.array_equal(x, y):
                raise AssertionError(f"{tag}.{key}: integers differ")
            continue
        rel = spectral_rel if key in ("sam_sum", "sid_sum", "lmse") else 1e-5
        worst = max(worst, close(x, y, rel, f"{tag}.{key}"))
    return worst


def run_mesh_steps(card) -> int:
    """11e: ``run_sharded_batch`` and ``sharded_metric_ladder`` at dp=4,
    sp=2 on 8 lanes of a (4, 512, 512) uint16 12-in-16 cube: eight
    positions on the card against one position on the card (float32 within
    rel 1e-5: the band axis cut into slices) and against eight on the CPU
    (quality within rel 1e-5; SAM/SID/LMSE within rel 1e-3, as in phase 4:
    float32 sums in another order); integers exact, and the derived
    PSNR/SSIM within rel 1e-5 on the card. Returns K1's launches in the
    card's mesh step (one a tile)."""
    from tpukit_torch.metrics.quality import assemble_quality_many

    rng = np.random.default_rng(5)
    cube = (rng.integers(0, 4096, (4, 512, 512)).astype(np.uint16) << 4)
    lanes = [np.clip(cube.astype(np.int32) + rng.integers(-a, a + 1,
                                                          cube.shape),
                     0, 65535).astype(np.uint16)
             for a in (0, 16, 48, 160, 400, 1600, 4000, 16000)]
    valid = rng.random((512, 512)) > 0.05
    tiles = np.stack([cube] * 8)
    meshes = {"card": pmesh.make_mesh(["cuda"] * 8, dp=4, sp=2),
              "card1": pmesh.make_mesh(["cuda"], dp=1, sp=1),
              "cpu": pmesh.make_mesh(["cpu"] * 8, dp=4, sp=2)}
    batch, ladder = {}, {}
    dev0 = torch.cuda.current_device()
    for name, m in meshes.items():
        fs_table.launches = 0
        t0 = time.perf_counter()
        batch[name] = pmesh.run_sharded_batch(
            tiles, np.stack(lanes), np.stack([valid] * 8), m)
        t_batch = time.perf_counter() - t0
        if name == "card":
            k1 = fs_table.launches
        ref, stack, vm, sam, nod, n_real = pmesh.place_ladder_inputs(
            m, cube, lanes, valid, valid, 0.0)
        t0 = time.perf_counter()
        qs, ss = pmesh.sharded_metric_ladder(m, False, True)(
            ref, stack, vm, sam, nod)
        ladder[name] = {"quality": {k: v.cpu().numpy()[:n_real]
                                    for k, v in qs.items()},
                        "spectral": {k: v.cpu().numpy()[:n_real]
                                     for k, v in ss.items()}}
        log(f"[11e] {name}: run_sharded_batch {t_batch:.2f} s, "
            f"sharded_metric_ladder {time.perf_counter() - t0:.2f} s "
            f"(host clock) on {card if name != 'cpu' else 'the CPU'}")
    same_device(dev0, "11e")
    if k1 != len(tiles):
        raise AssertionError(f"11e: K1 launched {k1} times, expected "
                             f"{len(tiles)}")
    w1 = hold_steps(batch["card"], batch["card1"], "11e batch 8 vs 1", 1e-5)
    w2 = hold_steps(ladder["card"], ladder["card1"], "11e ladder 8 vs 1",
                    1e-5)
    w3 = hold_steps(batch["card"], batch["cpu"], "11e batch card vs CPU",
                    1e-3)
    w4 = hold_steps(ladder["card"], ladder["cpu"], "11e ladder card vs CPU",
                    1e-3)
    for res in (batch, ladder):
        mets = {k: assemble_quality_many(res[k]["quality"], 65535.0)
                for k in res}
        for a, b in zip(mets["card"], mets["card1"]):
            for key in ("psnr_global", "ssim_global"):
                if math.isfinite(b[key]):
                    close(a[key], b[key], 1e-5, f"11e {key}")
    log(f"[11e] eight positions on the card == one (integers exact, floats "
        f"worst rel {max(w1, w2):.2e}), == eight on the CPU (integers exact, "
        f"floats worst rel {max(w3, w4):.2e}); {k1} K1 launches")
    return k1


def check_other_card(card):
    """11f on two cards or more: K1 and K2 on cuda:1 leave the current
    device where it was and equal their plain versions, through their
    wrappers and through the C entry points called directly (the wrappers
    also launch under ``torch.cuda.device``)."""
    dev0 = torch.cuda.current_device()
    x = torch.randint(0, 1 << 16, (4096, 64), dtype=torch.int32,
                      device="cuda:1")
    if not torch.equal(fs_table(x).cpu(), fs_table_ref(x.cpu())):
        raise AssertionError("11f: K1 on cuda:1 != its plain version")
    same_device(dev0, "11f K1 on cuda:1")
    y = torch.rand((2, 256, 256), device="cuda:1")
    if not torch.equal(dwt97(y, 3).cpu(), dwt97_ref(y.cpu(), 3)):
        raise AssertionError("11f: K2 on cuda:1 != its plain version")
    same_device(dev0, "11f K2 on cuda:1")
    lib = build.load()
    stream = torch.cuda.current_stream(1).cuda_stream
    out = torch.empty((4096, 14), dtype=torch.int32, device="cuda:1")
    err = lib.tpk_fs_table(x.data_ptr(), out.data_ptr(), 4096, 64, 1,
                           stream)
    same_device(dev0, "11f tpk_fs_table called on cuda:1")
    z = torch.rand((2, 64, 64), device="cuda:1")
    res = torch.empty_like(z)
    err2 = lib.tpk_dwt97_tail(z.data_ptr(), 64 * 64, 64, 2, 64, 64, 3,
                              res.data_ptr(), 64 * 64, 64, 1, stream)
    same_device(dev0, "11f tpk_dwt97_tail called on cuda:1")
    torch.cuda.synchronize(1)
    if (err, err2) != (0, 0) or not torch.equal(out.cpu(),
                                                 fs_table_ref(x.cpu())) \
            or not torch.equal(res.cpu(), dwt97_ref(z.cpu(), 3)):
        raise AssertionError(f"11f: direct C calls on cuda:1: {err}, {err2}")
    log(f"[11f] K1 and K2 on cuda:1 == plain, current device cuda:{dev0} "
        f"kept; {torch.cuda.device_count()} cards: {card}")


def run_phase11(card, tiles, cube, refs):
    """Phase 11; returns the launch counts by path. ``refs``: phase 3's
    anchor (stream, rows, plan), phase 6b's rows and phase 8a's BPE rows
    and files."""
    t11 = time.perf_counter()
    times = {}
    dev0 = torch.cuda.current_device()
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        paths = run_mesh_ladder(work, tiles, refs["ladder_rows"], card)
        times["11a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths["k1"]["mesh_caseb_anchor"] = run_mesh_anchor(
            work, cube, refs["anchor"], card)
        times["11b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths["k1"]["mesh_ccsds122_bpe"] = run_mesh_ccsds122(
            work, tiles, refs["bpe_ref"], card)
        times["11c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths["k1"]["mesh_caseb_scene_stream"] = run_mesh_stream(work, card)
        times["11d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths["k1"]["mesh_analysis_step"] = run_mesh_steps(card)
        times["11e"] = time.perf_counter() - t0
    if torch.cuda.device_count() >= 2:
        check_other_card(card)
    same_device(dev0, "phase 11")
    log(f"[mesh] phase 11 in {time.perf_counter() - t11:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
        + f"); current device cuda:{dev0} after every case on {card}")
    return paths


PHASE12_CELLS = ("caseB_anchor_ccsds121", "sceneA_ccsds121_stream512")
PHASE12_WARM = 3                # the phase stays under a minute


def run_phase12(dev, card):
    """Phase 12: two of the benchmark's cells through bench_torch's own
    cell function, with PHASE12_WARM warm iterations each (the benchmark
    runs more, for its spread); their checks, reference passes included,
    must hold, and K1 must run once per plan chunk in every Case B sweep
    and anchor run and never in the streamed scene (its tiles are below
    one plan chunk)."""
    t12 = time.perf_counter()
    inputs = bench_torch.draw_inputs(bench_torch.SEED, bench_torch.FULL,
                                     scene=True)
    want_k1 = {PHASE12_CELLS[0]: -(-inputs["caseB"].size // PLAN_CHUNK),
               PHASE12_CELLS[1]: 0}
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        idx = bench_torch.write_inputs(Path(tmp), inputs, {"caseB", "scene"})
        for name in PHASE12_CELLS:
            rec = bench_torch.run_cell(
                name, idx[bench_torch.CELLS[name].index], inputs, Path(tmp),
                dev, warm=PHASE12_WARM, keep_last=False)
            if not rec["correct"]:
                raise AssertionError(f"[12] {name}: {rec['failures']}")
            k1 = rec["layers"]["k1_launches"] + rec.get("anchor_k1_launches",
                                                        [])
            if set(k1) != {want_k1[name]}:
                raise AssertionError(f"[12] {name}: K1 launched {k1} times, "
                                     f"expected {want_k1[name]} each")
            w, tr = rec["sweep_wall_s"], rec["trace"]
            log(f"[12] {name}: sweep_wall_s median {w['median']:.3f} s "
                f"(q1 {w['q1']:.3f}, q3 {w['q3']:.3f}, n {w['n']}), cold "
                f"{rec['cold_sweep_s']:.3f} s, anchor_flow_s "
                f"{rec.get('anchor_flow_s', {}).get('median')}, RSS delta "
                f"{rec['layers'].get('rss_delta_mb', {}).get('median')} MB, "
                f"{tr['device_busy_share']} busy traced, K1 {k1}; "
                f"{rec['rows_attempted']} rows checked on {card}")
    log(f"[12] phase 12 in {time.perf_counter() - t12:.1f} s")


def load_nativebench():
    """scripts/nativebench_torch.py as a module (scripts/ is no package)."""
    path = Path(__file__).resolve().parent / "scripts" / "nativebench_torch.py"
    spec = importlib.util.spec_from_file_location("nativebench_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NAMED_DWTS = (("dwt53", "idwt53", torch.int32), ("dwt97", "idwt97", None),
              ("dwt97m", "idwt97m", torch.int32))


def run_phase13(dev, card):
    """Phase 13: scripts/nativebench_torch.py's body at full size with its
    DWTs on the card, its streams held to the CPU's coefficients;
    ``bpc_size_bytes_host`` and tpukit's named DWTs, card against CPU."""
    t13 = time.perf_counter()
    nb = load_nativebench()
    cpu = torch.device("cpu")
    _, flat, tile = nb.draw_inputs(np.random.default_rng(nb.SEED))
    res = nb.bench(flat, tile, dev)         # raises if a round trip fails
    perms = {"bpc_q35": nb.q35_perm(nb.dwt_coefs(tile, "97", cpu)),
             "bpc_lossless53": nb.lossless_perm(nb.dwt_coefs(tile, "53",
                                                             cpu))}
    for key, perm in perms.items():
        want = [wc.bpc_encode(p) for p in perm]
        if res[key]["streams"] != want:
            raise AssertionError(f"[13] {key}: the streams of the card's "
                                 f"coefficients != the CPU's")
        sizes = bpc_size_bytes_host(perm)
        if not (sizes.tolist() == bpc_size_bytes_host(perm, "cpu").tolist()
                == [len(e) for e in want]):
            raise AssertionError(f"[13] {key}: bpc_size_bytes_host on the "
                                 f"card {sizes.tolist()} != the CPU's or the "
                                 f"coder's {[len(e) for e in want]}")
    c = res["ccsds121"]
    log(f"[13] nativebench floors (min of N, DWT on {dev}): ccsds121 encode "
        f"{c['encode_s']:.4f} s ({c['encode_Msamples_per_s']:.0f} Ms/s), "
        f"decode {c['decode_s']:.4f} s ({c['decode_Msamples_per_s']:.0f} "
        f"Ms/s), stream {c['stream_bytes']} B; bpc q35 encode "
        f"{res['bpc_q35']['encode_s']:.4f} s, decode "
        f"{res['bpc_q35']['decode_s']:.4f} s, "
        f"{res['bpc_q35']['stream_bytes']} B; lossless 5/3 encode "
        f"{res['bpc_lossless53']['encode_s']:.4f} s, decode "
        f"{res['bpc_lossless53']['decode_s']:.4f} s, "
        f"{res['bpc_lossless53']['stream_bytes']} B; streams == the CPU "
        f"coefficients', bpc_size_bytes_host card == CPU == coder; {card}")
    x = torch.from_numpy(tile)
    for fwd, inv, dtype in NAMED_DWTS:
        xi = x if dtype is None else x.to(dtype)
        f, b = getattr(dwtk, fwd), getattr(dwtk, inv)
        got, want = f(xi.to(dev)), f(xi)
        back, back_cpu = b(got), b(want)
        if not (torch.equal(got.cpu(), want)
                and torch.equal(back.cpu(), back_cpu)):
            raise AssertionError(f"[13] {fwd}/{inv}: the card != the CPU")
        if dtype is not None and not torch.equal(back_cpu, xi):
            raise AssertionError(f"[13] {inv}({fwd}(x)) != x")
    log(f"[13] {', '.join(f for f, _, _ in NAMED_DWTS)} and their inverses "
        f"on a {tuple(tile.shape)} tile: the card == the CPU, bit for bit; "
        f"phase 13 in {time.perf_counter() - t13:.1f} s")


def main():
    # phase 0: the card
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    dev = resolve_device("cuda")
    card = card_line()
    if card is None:
        raise RuntimeError("nvidia-smi gave no card line")
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

    # phase 2: K1 and K2 against their plain versions, and their times;
    # neither may move the current device
    dev0 = torch.cuda.current_device()
    k1_err, k1_rows = check_fs_table(dev, card)
    same_device(dev0, "phase 2 K1")
    k2_err, k2_rows = check_dwt97(dev, card)
    same_device(dev0, "phase 2 K2")

    # phase 3: the slice
    cube = make_caseb_cube(np.random.default_rng(2026), BANDS, SIZE)
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        launches, anchor_bytes, anchor = run_slice(Path(tmp), cube, card)

    # phase 4: lossy metric pass
    check_metrics(cube, dev, card)

    # phase 5: the Case A slice
    tiles = make_casea_tiles(np.random.default_rng(2026))
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        k2_launches, casea_mean_csv = run_casea(Path(tmp), tiles, card)

    # phase 6: the J2K device fast mode
    t6 = time.perf_counter()
    scene = make_scene(np.random.default_rng(2026))
    with tempfile.TemporaryDirectory(prefix="tpukit_torch_smoke_") as tmp:
        scene_k1, scene_k2 = run_scene(Path(tmp), scene, dev, card)
        del scene
        ladder_k1, ladder_k2, ladder_hc, ladder_rows = run_device_ladder(
            Path(tmp), tiles, card)
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

    # phase 8: CCSDS-122 and the kept streams of the J2K device mode
    p8 = run_phase8(tiles, cube, dev, card)

    # phase 9: scene streaming, the strip metrics and the baseline pipelines
    p9 = run_phase9(card)

    # phase 10: the rest of the command line, held to phases 3, 5, 6b and 8c
    p10 = run_phase10(card, tiles, cube, {
        "anchor": anchor, "mean_csv": casea_mean_csv,
        "ladder_hc": ladder_hc, "kept_q40": p8["kept_q40"]})

    # phase 11: the device mesh, held to phases 3, 6b and 8a
    p11 = run_phase11(card, tiles, cube, {
        "anchor": anchor, "ladder_rows": ladder_rows,
        "bpe_ref": p8["bpe_ref"]})

    # phase 12: two of the benchmark's cells, with their checks
    run_phase12(dev, card)

    # phase 13: the host floors (nativebench) and tpukit's last entry points
    run_phase13(dev, card)

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
               "ccsds123_sweep": c123_k1, **p8["k1"], **p9,
               **p10["k1"], **p11["k1"]}),
        entry("dwt97", "tpukit_torch/csrc/dwt97.cu",
              "tpukit/kernels/dwt_pallas.py:85", scene_k2, k2_err, k2_rows,
              (32, 1024, 1024),
              {"caseA_ebcot": k2_launches, "scene_row": scene_k2,
               "device_ladder": ladder_k2, **p8["k2"], **p10["k2"],
               **p11["k2"]})]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
