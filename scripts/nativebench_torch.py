#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Microbenchmark of tpukit_torch's native entropy stages (host C++), min-of-N.

    python3 scripts/nativebench_torch.py [--device cuda]

The port of ``scripts/nativebench.py``: the same figures, inputs and
min-of-N counts, through the port's copies of the host coders. These
floors bound the host phases of the benchmark's cells: the CCSDS-121
encode and decode of a Case B stream (min of 3 and of 5), and the
bit-plane coder's encode and decode of 4 quality-35 1024² bands and of the
lossless 5/3 case (min of 3 each). Run with the machine otherwise idle.

The inputs come from ``np.random.default_rng(7)`` in the original's draw
order: the smoothed 180x512x512 Case B cube (14-in-16) and its BIP flat
stream, then the 4x1024² ramp-plus-noise Case A tile. The tile's 9/7 and
5/3 DWTs run on ``--device`` (the card by default; with no card it
raises), and the coefficients come back to the host before any timed
region. Prints the original's lines, then one JSON line with each floor,
the stream sizes, the DWT's device and the card's name and power limit
(``nvidia-smi``). Imports nothing of JAX and nothing of tpukit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch import card_line  # noqa: E402
from tpukit_torch.codecs import wavelet_common as wc  # noqa: E402
from tpukit_torch.codecs.j2k_codec import (  # noqa: E402
    _subband_steps, base_step_for_quality)
from tpukit_torch.device import resolve_device  # noqa: E402
from tpukit_torch.kernels import dwt as dwtk  # noqa: E402
from tpukit_torch.native import ccsds121_host as ck  # noqa: E402

SEED = 7
CASEB = (180, 512)          # bands, size
CASEA = (4, 1024)
LEVELS = 5
QUALITY = 35
PEAK = 4095.0               # 12-bit data


def mintime(fn, n=5):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def draw_inputs(rng, caseb=CASEB, casea=CASEA):
    """(Case B cube, its flat BIP uint16 stream, Case A float32 tile), in
    the original's draw order (scripts/nativebench.py:35-59)."""
    bands, size = caseb
    # Case B-like stream (smooth spatial x spectral gains, 14-in-16)
    base = rng.normal(0, 1, (size, size))
    k = np.ones(9) / 9.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    gains = 0.6 + 0.8 * np.abs(np.sin(np.linspace(0.3, 5.8, bands)))[:, None,
                                                                     None]
    cube = np.clip((500 + 6000 * base)[None] * gains
                   + rng.normal(0, 12, (bands, size, size)), -8192,
                   8191).astype(np.int16)
    cube = ((cube.view(np.uint16) >> 2) << 2).view(np.int16)
    flat = np.ascontiguousarray(np.moveaxis(cube.view(np.uint16), 0,
                                            -1)).ravel()
    # Case A-like tile: a ramp plus noise, 12 bits
    bands, size = casea
    gy, gx = np.mgrid[0:size, 0:size]
    tile = (np.clip(((800 + 2.5 * gy + 1.5 * gx) % 4096)[None]
                    + rng.integers(-400, 400, (bands, size, size)), 0, 4095)
            .astype(np.float32))
    return cube, flat, tile


def dwt_coefs(tile: np.ndarray, kind: str, device: torch.device,
              levels: int = LEVELS) -> np.ndarray:
    """The tile's ``kind`` DWT on ``device``, back on the host: float32 for
    "97" (the tile as it is), int32 for "53" (the tile cast to int32)."""
    x = tile if kind == "97" else tile.astype(np.int32)
    return dwtk.dwt2(torch.from_numpy(x).to(device), kind,
                     levels).cpu().numpy()


def q35_perm(coefs: np.ndarray, levels: int = LEVELS) -> np.ndarray:
    """9/7 coefficients quantized at quality 35 by the per-subband steps,
    as int32 rows in the embedded scan order."""
    B, H, W = coefs.shape
    steps = _subband_steps(H, W, base_step_for_quality(QUALITY, PEAK))
    qc = np.trunc(coefs / steps[None]).astype(np.int32)
    return qc.reshape(B, -1)[:, wc.scan_order(H, W, levels)]


def lossless_perm(coefs53: np.ndarray, levels: int = LEVELS) -> np.ndarray:
    """5/3 coefficients as int32 rows in the embedded scan order."""
    B, H, W = coefs53.shape
    return coefs53.reshape(B, -1)[:, wc.scan_order(H, W, levels)]


def time_ccsds121(flat: np.ndarray) -> dict:
    """CCSDS-121 encode (min of 3) and decode (min of 5) of the flat
    stream, 16 bits, libaec's defaults; the round trip checked."""
    bs = ck.encode(flat, 16)
    t_enc = mintime(lambda: ck.encode(flat, 16), 3)
    t_dec = mintime(lambda: ck.decode(bs, flat.size, 16), 5)
    check(np.array_equal(ck.decode(bs, flat.size, 16), flat),
          "ccsds121: decode(encode(flat)) != flat")
    return {"encode_s": t_enc, "decode_s": t_dec, "samples": int(flat.size),
            "encode_Msamples_per_s": flat.size / t_enc / 1e6,
            "decode_Msamples_per_s": flat.size / t_dec / 1e6,
            "stream_bytes": len(bs), "stream": bs}


def time_bpc(perm: np.ndarray, tag: str) -> dict:
    """The embedded bit-plane coder's encode and decode of every band (min
    of 3 each); the round trips checked."""
    n = perm.shape[1]
    enc = [wc.bpc_encode(p) for p in perm]
    t_be = mintime(lambda: [wc.bpc_encode(p) for p in perm], 3)
    t_bd = mintime(lambda: [wc.bpc_decode(e, n) for e in enc], 3)
    for b, e in enumerate(enc):
        check(np.array_equal(wc.bpc_decode(e, n), perm[b]),
              f"bpc {tag}: band {b} decode(encode(coefs)) != coefs")
    return {"encode_s": t_be, "decode_s": t_bd,
            "stream_bytes": sum(len(e) for e in enc), "streams": enc}


def bench(flat: np.ndarray, tile: np.ndarray, device: torch.device,
          levels: int = LEVELS) -> dict:
    """The timed body: the CCSDS-121 floors, then the tile's DWTs on
    ``device`` and the bit-plane floors of its q35 and 5/3 coefficients."""
    out = {"ccsds121": time_ccsds121(flat)}
    perm = q35_perm(dwt_coefs(tile, "97", device, levels), levels)
    out["bpc_q35"] = time_bpc(perm, "q35")
    perm53 = lossless_perm(dwt_coefs(tile, "53", device, levels), levels)
    out["bpc_lossless53"] = time_bpc(perm53, "lossless 5/3")
    return out


def report(res: dict, tile_shape, device: torch.device) -> dict:
    """Prints the original's lines; returns the JSON record (no streams)."""
    c, q, l = res["ccsds121"], res["bpc_q35"], res["bpc_lossless53"]
    bands, size = tile_shape[0], tile_shape[-1]
    print(f"ccsds121 encode: {c['encode_s']:.3f}s "
          f"({c['encode_Msamples_per_s']:.0f} Ms/s)  "
          f"stream {c['stream_bytes']/1e6:.1f} MB")
    print(f"ccsds121 decode: {c['decode_s']:.3f}s "
          f"({c['decode_Msamples_per_s']:.0f} Ms/s)")
    print(f"bpc encode ({bands} bands q35 {size}^2): {q['encode_s']:.3f}s  "
          f"stream {q['stream_bytes']/1e6:.1f} MB")
    print(f"bpc decode ({bands} bands q35 {size}^2): {q['decode_s']:.3f}s")
    print(f"bpc encode lossless 5/3: {l['encode_s']:.3f}s  "
          f"stream {l['stream_bytes']/1e6:.1f} MB")
    print(f"bpc decode lossless 5/3: {l['decode_s']:.3f}s")
    return {
        "ccsds121": {k: v for k, v in c.items() if k != "stream"},
        **{k: {f: v for f, v in res[k].items() if f != "streams"}
           for k in ("bpc_q35", "bpc_lossless53")},
        "tile": list(tile_shape), "dwt_device": str(device),
        "card": card_line() if device.type == "cuda" else None,
        "torch": torch.__version__}


def main(argv=None, caseb=CASEB, casea=CASEA) -> int:
    """The command line; ``caseb`` and ``casea`` (bands, size) let the tests
    run it small."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the DWT's device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)    # no card: raises
    _, flat, tile = draw_inputs(np.random.default_rng(SEED), caseb, casea)
    rec = report(bench(flat, tile, device), tile.shape, device)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
