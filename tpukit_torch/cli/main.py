# -*- coding: utf-8 -*-
"""tpukit_torch command-line interface.

``python -m tpukit_torch run-codec ...`` is tpukit's sweep runner CLI
(tpukit/cli/main.py:26-189, reference tools/run_codec.py:374-399) on a
torch device, plus ``--device`` (default ``cuda``; an absent card is an
error, not a fall back to the CPU). Codecs: ccsds121, ccsds123 (both
predictors), jpegls, png and j2k; ccsds122 is refused with its ROADMAP
item. Flags the port cannot honour yet
(``--compressor-cmd``, ``--profile``, ``--mesh``, ``--stream-rows``, and
``--keep-bitstream`` with ``--entropy device``) raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def run_codec_main(argv=None):
    """Sweep runner CLI mirroring reference tools/run_codec.py:374-399."""
    ap = argparse.ArgumentParser(
        description="tpukit_torch codec runner: sweep codecs and collect "
                    "metrics per tile")
    ap.add_argument("--indices", required=True)
    ap.add_argument("--codec", required=True,
                    help="codec name (ccsds121, ccsds123, jpegls, png or "
                         "j2k) or its reference label (ccsds121_ext, "
                         "ccsds123_ext, jpegls_subproc, png_lossless, "
                         "j2k_gdal)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--compressor-cmd", nargs="+", default=None)
    ap.add_argument("--rate-key", default="none",
                    choices=["none", "cr", "bpp", "nearlossless_eps", "quality"])
    ap.add_argument("--rates", nargs="+", default=None)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--keep-bitstream", action="store_true")
    ap.add_argument("--case", default=None)
    ap.add_argument("--asset", default=None)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--caseA-link-mbps", type=float, default=1.0)
    ap.add_argument("--caseA-eff", type=float, default=0.80)
    ap.add_argument("--caseB-link-mbps", type=float, default=None)
    ap.add_argument("--caseB-eff", type=float, default=None)
    ap.add_argument("--ql-err-global", type=int, default=255)
    ap.add_argument("--ql-err-zoom", type=int, default=None)
    ap.add_argument("--ql-rgb", action="store_true")
    ap.add_argument("--no-artifacts", action="store_true",
                    help="skip recon.tif/quicklooks on disk")
    ap.add_argument("--single-csv", default=None,
                    help="path to the per-run CSV (default "
                         "<outdir>/metrics.csv; metrics_mean.csv is "
                         "written next to it)")
    ap.add_argument("--csv-decimal", choices=[",", "."], default=",")
    # codec options pass through
    ap.add_argument("--tile", type=int, default=None)
    ap.add_argument("--interleave", default=None)
    ap.add_argument("--preproc", default=None)
    ap.add_argument("--nbit", type=int, default=None)
    # handed to the codec as tpukit does, which refuses the ones it does
    # not take
    ap.add_argument("--zlevel", type=int, default=None)
    ap.add_argument("--png-writer", dest="png_writer",
                    choices=("tpukit", "compat"), default=None)
    ap.add_argument("--crop-nodata", dest="crop_nodata", action="store_true")
    ap.add_argument("--predictor", choices=("ls", "standard"), default=None)
    ap.add_argument("--pred-bands", dest="pred_bands", type=int, default=None)
    ap.add_argument("--pred-mode", dest="pred_mode",
                    choices=("full", "reduced"), default=None)
    ap.add_argument("--local-sums", dest="local_sums",
                    choices=("neighbor", "column"), default=None)
    ap.add_argument("--tilex", type=int, default=None)
    ap.add_argument("--tiley", type=int, default=None)
    ap.add_argument("--rate-fit", dest="rate_fit", action="store_true")
    ap.add_argument("--entropy",
                    choices=("ebcot", "device", "bpe", "embedded",
                             "sample", "block"), default=None)
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--mesh", metavar="DP[,SP]", default=None)
    ap.add_argument("--stream-rows", type=int, default=None)
    ap.add_argument("--dedupe-reps", action="store_true",
                    help="reps of an identical (tile, rate) point share one "
                         "metric lane (default: honest reps)")
    args = ap.parse_args(argv)

    for flag, value, item in (
            ("--compressor-cmd", args.compressor_cmd,
             "item 20 (the external-wrapper codec)"),
            ("--profile", args.profile, "item 20 (torch.profiler)"),
            ("--mesh", args.mesh, "item 21 (multi-GPU)"),
            ("--stream-rows", args.stream_rows, "item 18 (scene streaming)"),
            ("--keep-bitstream with --entropy device",
             (args.keep_bitstream and args.entropy == "device") or None,
             "item 22 (the host Rice/bit-plane/run-length coder)")):
        if value is not None:
            raise NotImplementedError(
                f"{flag} is not ported to tpukit_torch yet "
                f"(ROADMAP.md 'Modules to port': {item})")

    from tpukit_torch.codecs.registry import create
    from tpukit_torch.io import manifest
    from tpukit_torch.sweep.runner import SweepConfig, run_sweep

    copts = {k: getattr(args, k)
             for k in ("tile", "interleave", "preproc", "nbit", "zlevel",
                       "tilex", "tiley", "entropy", "predictor", "pred_bands",
                       "pred_mode", "local_sums")
             if getattr(args, k) is not None}
    if args.crop_nodata:
        copts["crop_nodata"] = True
    if args.png_writer is not None:
        copts["writer"] = args.png_writer
    if args.rate_fit:
        copts["rate_fit"] = True
    codec = create(args.codec, **copts)

    case_name, _, _ = manifest.load_indices(Path(args.indices))
    if args.case:
        case_name = args.case
    if str(case_name).lower() in ("caseb", "b"):
        link_mbps, link_eff = args.caseB_link_mbps, args.caseB_eff
    else:
        link_mbps, link_eff = args.caseA_link_mbps, args.caseA_eff

    cfg = SweepConfig(
        indices=Path(args.indices), codec=codec, codec_label=args.codec,
        outdir=Path(args.outdir), device=args.device,
        rate_key=args.rate_key, rates=args.rates,
        reps=args.reps, keep_bitstream=args.keep_bitstream,
        write_artifacts=not args.no_artifacts,
        quicklooks=not args.no_artifacts,
        ql_rgb=args.ql_rgb, ql_err_global=args.ql_err_global,
        ql_err_zoom=args.ql_err_zoom, case=args.case, asset=args.asset,
        link_mbps=link_mbps, link_eff=link_eff, csv_decimal=args.csv_decimal,
        single_csv=(Path(args.single_csv) if args.single_csv else None),
        dedupe_reps=args.dedupe_reps)
    return run_sweep(cfg)


COMMANDS = {"run-codec": run_codec_main}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("tpukit_torch commands:")
        for name in sorted(COMMANDS):
            print(f"  {name}")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}", file=sys.stderr)
        return 2
    COMMANDS[cmd](argv[1:])
    return 0
