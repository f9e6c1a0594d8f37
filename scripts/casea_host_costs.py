#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Split the codec phase of the Case A quality sweep into its steps.

    python3 scripts/casea_host_costs.py [--seed 2026] [--sweeps 3]
                                        [--device cuda]

Draws ``bench_torch.py``'s two 4x1024x1024 uint16 12-in-16 Case A tiles
(HC, LC) from ``--seed``, uploads each once as the sweep runner does, and
runs the codec phase of one ``caseA_j2k_quality14`` sweep (``--codec j2k
--rate-key quality --rates 1 ... 100 --reps 3 --keep-bitstream``): for each
tile, three ``J2KCodec.sweep_rates`` calls with the upload and one plan
cache, as the runner makes them. The codec's own steps are timed in place,
each on its own wall clock, by wrappers that this script puts around the
module's functions:

  enqueue       ``_price_targets``: the pricing DWT (kernel K2) and ladder
                enqueued on the card, once a tile
  plans         ``_band_plans``: one ``J2CPlan`` (9/7 analysis and tier-1)
                a band, once a tile
  pricing_wait  the residual wait for the priced sizes after the plans
  truncate      ``at_size_multi``: 14 points x 3 reps = 42 a tile
  decode        ``_decode_bands_into``: rep 1's real decode, 14 a tile
  model         ``_model_bands_into``: the truncated-decode model recons of
                reps 2-3, 28 a tile
  other         the rest of the three calls' wall

Two paths take turns, one sweep (both tiles) each, ``--sweeps`` times:
``pooled``, the codec as it is (the plans and the model recons on the band
pool), and ``serial``, with ``j2k_codec._band_pool`` patched to return
``None`` in this process, as on a one-core host. The comp phase's peak RSS
(``MemorySampler``, as the runner tags it) is kept for each path, beside
the RSS before the call. Then, untimed, every point's streams and recon
must be equal on both paths and across reps. Last, untimed, each tile's
four plans are built once more on each path under ``tracemalloc``, whose
peak (numpy's buffers and Python's objects) is what building the bands at
once costs in host memory beside building them one after another; the
process's RSS also carries what the allocator kept from earlier steps.
Prints the card's ``nvidia-smi`` name and power limit, then one JSON line:
every sweep's seconds per step, tile and path, their medians, and the
plans' traced peaks.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
import tracemalloc
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_torch  # noqa: E402
from tpukit_torch.codecs import j2k_codec  # noqa: E402
from tpukit_torch.codecs.base import RateSpec  # noqa: E402
from tpukit_torch.device import resolve_device  # noqa: E402
from tpukit_torch.sweep import runner  # noqa: E402
from tpukit_torch.sweep.proc import MemorySampler  # noqa: E402

REPS = 3
STEPS = ("enqueue", "plans", "pricing_wait", "truncate", "decode", "model",
         "other")
CALLS = {"enqueue": 1, "plans": 1, "pricing_wait": 1,
         "truncate": REPS * len(bench_torch.RATES_A),
         "decode": len(bench_torch.RATES_A),
         "model": (REPS - 1) * len(bench_torch.RATES_A)}
_T: dict = {}
_N: dict = {}


def _timed(step, fn):
    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            _T[step] += time.perf_counter() - t0
            _N[step] += 1
    return wrapped


def instrument():
    """Wrap the codec's steps with timers (this process only)."""
    for step, name in (("plans", "_band_plans"),
                       ("truncate", "at_size_multi"),
                       ("decode", "_decode_bands_into"),
                       ("model", "_model_bands_into")):
        setattr(j2k_codec, name, _timed(step, getattr(j2k_codec, name)))
    price = j2k_codec.J2KCodec._price_targets

    def price_targets(self, *a, **kw):
        return _timed("pricing_wait",
                      _timed("enqueue", price)(self, *a, **kw))

    j2k_codec.J2KCodec._price_targets = price_targets


def digest(res) -> str:
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(res.bitstreams):
        h.update(name.encode())
        h.update(res.bitstreams[name])
    h.update(res.recon.tobytes())
    return h.hexdigest()


def sweep(path: str, tiles: dict, uploads: dict, specs) -> tuple:
    """One sweep's codec phase on ``path``; returns ({tile: {step: s}},
    {tile: rss}, {tile: [[digest of each point] of each rep]})."""
    pool = j2k_codec._band_pool
    if path == "serial":
        j2k_codec._band_pool = lambda B: None
    times, rss, digests = {}, {}, {}
    try:
        for tid, cube in tiles.items():
            _T.update(dict.fromkeys(STEPS, 0.0))
            _N.update(dict.fromkeys(STEPS, 0))
            codec = j2k_codec.J2KCodec()
            cache = {}
            wall = 0.0
            digests[tid] = []
            for rep in range(REPS):
                with MemorySampler() as ms:
                    before = ms.peak_bytes or 0
                    t0 = time.perf_counter()
                    res = codec.sweep_rates(
                        cube, "uint16", specs, keep_bitstream=True,
                        device_cube=uploads[tid], device_plan_cache=cache,
                        dedupe_reps=False)
                    wall += time.perf_counter() - t0
                if rep == 0:
                    comp = ms.phase_peak_bytes("comp") or 0
                    rss[tid] = {"before_mb": before / 2 ** 20,
                                "comp_peak_mb": comp / 2 ** 20,
                                "comp_delta_mb": (comp - before) / 2 ** 20}
                digests[tid].append([digest(r) for r in res])
            bad = {s: _N[s] for s, n in CALLS.items() if _N[s] != n}
            if bad:
                raise RuntimeError(f"{path} {tid}: step counts {bad}, "
                                   f"want {CALLS}")
            _T["other"] = wall - sum(_T[s] for s in STEPS if s != "other")
            times[tid] = {**_T, "codec": wall}
    finally:
        j2k_codec._band_pool = pool
    return times, rss, digests


def plans_peak_mb(cube, specs, pooled: bool) -> dict:
    """The traced peak and the held size, in MB, of building ``cube``'s
    plans at the sweep's base step, with the band pool or without it."""
    codec = j2k_codec.J2KCodec()
    base = min(1.0, float(codec._quality_bases(cube, specs).min()))
    info = np.iinfo(cube.dtype)
    pool = j2k_codec._band_pool(cube.shape[0]) if pooled else None
    tracemalloc.start()
    try:
        plans = j2k_codec._band_plans(
            cube, info.bits, info.min < 0, "97", base,
            pool.map if pool is not None else map)
        held, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
        if pool is not None:
            pool.shutdown()
    del plans
    return {"peak_mb": peak / 2 ** 20, "held_mb": held / 2 ** 20}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=bench_torch.SEED)
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tiles = bench_torch.draw_inputs(args.seed, bench_torch.FULL,
                                    scene=False)["caseA"]
    uploads = {tid: torch.from_numpy(t).to(dev) for tid, t in tiles.items()}
    specs = [RateSpec.of("quality", q) for q in
             runner._normalize_rates("quality", bench_torch.RATES_A)]
    instrument()
    paths = ("pooled", "serial")
    times = {p: [] for p in paths}
    rss = {p: [] for p in paths}
    for i in range(args.sweeps):
        order = paths if i % 2 == 0 else paths[::-1]
        got = {}
        for path in order:
            t, r, got[path] = sweep(path, tiles, uploads, specs)
            times[path].append(t)
            rss[path].append(r)
        if got["pooled"] != got["serial"]:
            print("the pooled sweep's streams or recons != the serial "
                  "sweep's", file=sys.stderr)
            return 1
        if any(reps[k] != reps[0] for reps in got["pooled"].values()
               for k in range(REPS)):
            print("a rep's streams or recon != rep 1's", file=sys.stderr)
            return 1
    med = {p: {tid: {s: statistics.median(t[tid][s] for t in times[p])
                     for s in STEPS + ("codec",)} for tid in tiles}
           for p in paths}
    for p in paths:
        med[p]["both"] = {s: statistics.median(
            sum(t[tid][s] for tid in tiles) for t in times[p])
            for s in STEPS + ("codec",)}
    plan_mem = {p: {tid: plans_peak_mb(t, specs, p == "pooled")
                    for tid, t in tiles.items()} for p in paths}
    pool = j2k_codec._band_pool(len(next(iter(tiles.values()))))
    workers = pool._max_workers if pool is not None else 1
    if pool is not None:
        pool.shutdown()
    print(bench_torch.card_line())
    print(json.dumps({
        "tiles": {tid: list(t.shape) for tid, t in tiles.items()},
        "seed": args.seed, "reps": REPS, "points": len(specs),
        "sweeps": args.sweeps, "calls": CALLS,
        "workers": workers,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "median_s": med, "sweeps_s": times, "rss_mb": rss,
        "plans_traced_mb": plan_mem}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
