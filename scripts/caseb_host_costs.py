#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Split the CCSDS-121 codec phase of the Case B anchor sweep into its steps.

    python3 scripts/caseb_host_costs.py [--seed 2026] [--sweeps 5]
                                        [--device cuda]

Draws ``bench_torch.py``'s 180x512x512 int16 Case B tile from ``--seed``,
uploads it once as the sweep runner does, and runs the codec phase of one
``caseB_anchor_ccsds121`` sweep (``--codec ccsds121 --reps 3 --preproc none
--nbit 16 --interleave bip --tile 512``) step by step, each step timed on
its own wall clock and ended by a synchronize. Two paths take turns, one
sweep each, ``--sweeps`` times:

  host     the interleave on the host: ``rawio.bsq_to_interleaved`` of the
           tile (flat), the device stream built again for the plan (plan),
           and every rep ``rawio.interleaved_to_bsq`` copied into a host
           recon (deinterleave)
  device   the interleave on the card: ``ccsds121_codec.flat_stream`` once
           and ``host_flat``'s one copy back (flat), the plan from that
           stream (plan), and every rep ``device_tile`` written into a
           recon on the card (deinterleave)

Both share ``encode_parallel`` and ``decode_parallel`` (each rep). A sweep
builds the flat stream and the plan once and codes 3 reps, as the codec
does with the runner's plan cache. Then, untimed, both paths' host streams
must equal each other, the decoded recons the tile. ``codec_run_s`` times
three ``CCSDS121Codec.run`` calls with the upload and a shared plan cache,
the codec phase itself. Prints the card's ``nvidia-smi`` name and power
limit, then one JSON line: every sweep's seconds per step and path, and
their medians.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_torch  # noqa: E402
from tpukit_torch.codecs import ccsds121 as model  # noqa: E402
from tpukit_torch.codecs.base import RateSpec  # noqa: E402
from tpukit_torch.codecs.ccsds121_codec import (CCSDS121Codec,  # noqa: E402
                                                device_tile, flat_stream,
                                                host_flat)
from tpukit_torch.device import resolve_device  # noqa: E402
from tpukit_torch.io import raw as rawio  # noqa: E402
from tpukit_torch.native import ccsds121_host  # noqa: E402

REPS = 3
STEPS = ("flat", "plan", "encode", "decode", "deinterleave")
PLAN_CHUNK = 1 << 22


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sweep(path: str, cube: np.ndarray, dc: torch.device, dev) -> tuple:
    """One sweep's codec phase on ``path``; returns ({step: s}, host flat,
    the last rep's recon)."""
    B, H, W = cube.shape
    t = dict.fromkeys(STEPS, 0.0)

    def timed(step, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        t[step] += time.perf_counter() - t0
        return out

    if path == "host":
        flat = timed("flat", lambda: rawio.bsq_to_interleaved(
            cube.view(np.uint16), "bip").ravel())
        plan = timed("plan", lambda: model.encode_plan(
            flat_stream(dc, 0, 0, H, W, "none", "bip"), chunk=PLAN_CHUNK))
    else:
        fd = timed("flat", lambda: flat_stream(dc, 0, 0, H, W, "none",
                                               "bip"))
        flat = timed("flat", lambda: host_flat(fd, cube.dtype))
        plan = timed("plan", lambda: model.encode_plan(fd, chunk=PLAN_CHUNK))
        del fd
    for _ in range(REPS):
        bs = timed("encode", lambda: ccsds121_host.encode_parallel(flat,
                                                                   plan))
        dec = timed("decode", lambda: ccsds121_host.decode_parallel(bs,
                                                                    plan))
        if path == "host":
            def write():
                recon = np.empty_like(cube)
                recon[:] = rawio.interleaved_to_bsq(dec, "bip", B, H,
                                                    W).view(np.int16)
                return recon
        else:
            def write():
                recon = torch.empty(cube.shape, dtype=torch.int16,
                                    device=dev)
                recon[:] = device_tile(dec, cube.dtype, B, H, W, "none",
                                       "bip", dev)
                return recon
        recon = timed("deinterleave", write)
    return t, flat, recon


def codec_run(cube: np.ndarray, dc: torch.Tensor, dev) -> float:
    """Three reps of ``CCSDS121Codec.run`` with the upload, as the runner
    calls it (one plan cache a sweep), ended by a synchronize."""
    codec = CCSDS121Codec(tile=512, interleave="bip", preproc="none",
                          nbit=16)
    cache = {}
    t0 = time.perf_counter()
    for _ in range(REPS):
        codec.run(cube, "int16", RateSpec.none(), device_cube=dc,
                  device_plan_cache=cache)
    sync(dev)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=bench_torch.SEED)
    ap.add_argument("--sweeps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cube = bench_torch.draw_inputs(args.seed, bench_torch.FULL,
                                   scene=False)["caseB"]
    dc = torch.from_numpy(cube).to(dev)
    times = {p: {s: [] for s in STEPS} for p in ("host", "device")}
    runs = []
    for i in range(args.sweeps):
        order = ("host", "device") if i % 2 == 0 else ("device", "host")
        flats, recons = {}, {}
        for path in order:
            t, flats[path], recons[path] = sweep(path, cube, dc, dev)
            for s, v in t.items():
                times[path][s].append(v)
        runs.append(codec_run(cube, dc, dev))
        if not np.array_equal(flats["host"], flats["device"]):
            print("the device's host stream != the host transpose",
                  file=sys.stderr)
            return 1
        if not (np.array_equal(recons["host"], cube)
                and np.array_equal(recons["device"].cpu().numpy(), cube)):
            print("a recon != the tile", file=sys.stderr)
            return 1
    med = {p: {s: statistics.median(v) for s, v in d.items()}
           for p, d in times.items()}
    for p in med:
        med[p]["total"] = statistics.median(
            sum(times[p][s][i] for s in STEPS) for i in range(args.sweeps))
    print(bench_torch.card_line())
    print(json.dumps({
        "cube": list(cube.shape), "dtype": cube.dtype.name,
        "seed": args.seed, "reps": REPS, "sweeps": args.sweeps,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "median_s": med, "codec_run_s": statistics.median(runs),
        "sweeps_s": times, "codec_runs_s": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
