# -*- coding: utf-8 -*-
"""tpukit_torch command-line interface.

``python -m tpukit_torch <command> ...`` has tpukit's 15 commands
(tpukit/cli/main.py:504-566); those with device work run on the torch
device named by ``--device`` (default ``cuda``; an absent card is an error,
not a fall back to the CPU):

  run-codec        tpukit's sweep runner CLI (tpukit/cli/main.py:26-189,
                   reference tools/run_codec.py:374-399)
  make-baseline-a  Case A preparation (tpukit/cli/main.py:192-215,
                   reference tools/make_baseline_A.py)
  make-baseline-b  Case B preparation (tpukit/cli/main.py:218-251,
                   reference tools/make_baseline_B.py)
  quicklooks       RGB + ERR8 maps (tools/quicklooks.py; host code)
  rd-curve         RD figures (tools/rd_curve.py)
  overlay-means    overlays/Pareto/iso bars (tools/overlay_means.py)
  fig-caseb        LC-vs-HC bars (tools/fig_caseB.py)
  tile-complexity  complexity analytics (tools/utils/tile_complexity.py)
  doctor           install and device health check
  codec-*          the six wrapper CLIs (tools/codecs/*_wrap.py contract,
                   ``cli/wrappers.py``)

``quicklooks`` and the three figure commands are host code and take no
``--device``; the figure commands need pandas and matplotlib and exit
non-zero naming the one that is missing.

``run-codec`` codecs: tpukit's six, ccsds121, ccsds122 (``--entropy
bpe|embedded``), ccsds123 (both predictors), jpegls, png and j2k
(``--entropy ebcot|device``), each with and without ``--keep-bitstream``;
``--stream-rows`` streams items in row strips (items over 1 GiB stream by
themselves with a strip-exact codec); ``--compressor-cmd`` drives an
external wrapper through the reference's L2 contract (``codecs.shell``),
the arguments after ``--`` passed through to it; ``--profile DIR`` writes
a ``torch.profiler`` Chrome trace of the sweep to ``DIR/trace.json``;
``--mesh DP[,SP]`` runs the codecs' mesh ladders and the metric pass on a
mesh of DP·SP positions, wrapped round-robin onto the cards of
``--device`` (``sweep.runner._build_mesh``).

``run_codec_main`` returns 0 as tpukit's does; ``run_codec_config`` gives
the ``SweepConfig`` of a command line for callers that want ``run_sweep``'s
result dict.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _run_codec_args(argv=None):
    """The parsed ``run-codec`` command line and its ``SweepConfig``
    (reference tools/run_codec.py:374-399)."""
    ap = argparse.ArgumentParser(
        description="tpukit_torch codec runner: sweep codecs and collect "
                    "metrics per tile")
    ap.add_argument("--indices", required=True)
    ap.add_argument("--codec", required=True,
                    help="codec name (ccsds121, ccsds122, ccsds123, jpegls, "
                         "png or j2k) or its reference label (ccsds121_ext, "
                         "ccsds122_ext, ccsds123_ext, jpegls_subproc, "
                         "png_lossless, j2k_gdal)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--compressor-cmd", nargs="+", default=None,
                    help="external wrapper command (reference L2 contract); "
                         "when set, --codec is only the CSV label and unknown "
                         "args after -- pass through to the wrapper")
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
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the sweep "
                         "to DIR/trace.json (Perfetto reads it)")
    ap.add_argument("--mesh", metavar="DP[,SP]", default=None,
                    help="run on a mesh of DP*SP positions: DP-way over "
                         "lanes and budgets, SP-way over bands; positions "
                         "wrap round-robin onto the cards of --device")
    ap.add_argument("--stream-rows", type=int, default=None)
    ap.add_argument("--dedupe-reps", action="store_true",
                    help="reps of an identical (tile, rate) point share one "
                         "metric lane (default: honest reps)")
    args, _extra = ap.parse_known_args(argv)

    from tpukit_torch.codecs.registry import create
    from tpukit_torch.io import manifest
    from tpukit_torch.sweep.runner import SweepConfig

    if args.compressor_cmd:
        # the runner still uploads each tile for its metric pass; the
        # wrapper process reads the host cube
        from tpukit_torch.codecs.shell import ShellCodec
        codec = ShellCodec(args.compressor_cmd,
                           [x for x in _extra if x != "--"])
    else:
        copts = {k: getattr(args, k)
                 for k in ("tile", "interleave", "preproc", "nbit", "zlevel",
                           "tilex", "tiley", "entropy", "predictor",
                           "pred_bands", "pred_mode", "local_sums")
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

    return args, SweepConfig(
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
        stream_rows=args.stream_rows, dedupe_reps=args.dedupe_reps,
        mesh=args.mesh)


def run_codec_config(argv=None):
    """The ``SweepConfig`` of a ``run-codec`` command line (reference
    tools/run_codec.py:374-399)."""
    return _run_codec_args(argv)[1]


def run_codec_main(argv=None):
    """Sweep runner CLI: run the sweep of :func:`run_codec_config` and
    return 0, as tpukit's ``run_codec_main`` does. With ``--profile DIR``
    the sweep runs under ``torch.profiler`` (the CPU, and CUDA when the
    sweep's device is a card) and its Chrome trace is written to
    ``DIR/trace.json``, in place of tpukit's ``jax.profiler.trace``."""
    from tpukit_torch.sweep.runner import run_sweep

    args, cfg = _run_codec_args(argv)
    if not args.profile:
        run_sweep(cfg)
        return 0
    from torch.profiler import ProfilerActivity, profile

    from tpukit_torch.device import resolve_device
    acts = [ProfilerActivity.CPU]
    if resolve_device(args.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run_sweep(cfg)
    out = Path(args.profile)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    return 0


def make_baseline_a_main(argv=None):
    ap = argparse.ArgumentParser(description="Case A baseline preparation")
    ap.add_argument("--bands", nargs=4, required=True,
                    metavar=("B02", "B03", "B04", "B08"))
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--scene", default="2000x10000")
    ap.add_argument("--tile", default="1024x1024")
    ap.add_argument("--hc", default="300,688")
    ap.add_argument("--lc", default="488,7012")
    ap.add_argument("--no-quicklooks", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the 12-in-16 conversion: cuda "
                         "(default), cuda:N or cpu")
    args = ap.parse_args(argv)
    from tpukit_torch.pipelines.baseline_a import CaseAConfig, run
    sw, sh = (int(v) for v in args.scene.split("x"))
    tw, th = (int(v) for v in args.tile.split("x"))
    cfg = CaseAConfig(
        band_paths=[Path(p) for p in args.bands], outdir=Path(args.outdir),
        scene_w=sw, scene_h=sh, tile_w=tw, tile_h=th,
        hc_off=tuple(int(v) for v in args.hc.split(",")),
        lc_off=tuple(int(v) for v in args.lc.split(",")),
        quicklooks=not args.no_quicklooks, device=args.device)
    out = run(cfg)
    print(json.dumps({k: str(v) for k, v in out.items() if k != "items"}))
    return 0


def make_baseline_b_main(argv=None):
    ap = argparse.ArgumentParser(description="Case B baseline preparation")
    ap.add_argument("--input-raw", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--dt", required=True)
    ap.add_argument("--target-bands", type=int, default=180)
    ap.add_argument("--tile-size", type=int, default=512)
    ap.add_argument("--lc", default="580,5620")
    ap.add_argument("--hc", default="2000,1536")
    ap.add_argument("--stretch", default="1,99")
    ap.add_argument("--gamma", type=float, default=0.9)
    ap.add_argument("--wb", default="whitepatch", choices=["none", "whitepatch", "gray"])
    ap.add_argument("--rgb-nm", default="665.0,560.0,490.0")
    ap.add_argument("--false-nm", default="842.0,665.0,560.0")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--err-mode", default="mean",
                    choices=["max", "mean", "rms", "p95", "count3"])
    ap.add_argument("--err-scale", default="fixed", choices=["fixed", "auto"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the truncation and the error "
                         "maps: cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    from tpukit_torch.pipelines.baseline_b import CaseBConfig, run
    cfg = CaseBConfig(
        input_raw=Path(args.input_raw), output=Path(args.output), dt=args.dt,
        target_bands=args.target_bands, tile_size=args.tile_size,
        lc=tuple(int(v) for v in args.lc.split(",")),
        hc=tuple(int(v) for v in args.hc.split(",")),
        stretch=tuple(float(v) for v in args.stretch.split(",")),
        gamma=args.gamma, wb=args.wb,
        rgb_nm=tuple(float(v) for v in args.rgb_nm.split(",")),
        false_nm=tuple(float(v) for v in args.false_nm.split(",")),
        k=args.k, err_mode=args.err_mode, err_scale=args.err_scale,
        device=args.device)
    out = run(cfg)
    print(json.dumps({k: str(v) for k, v in out.items()
                      if k not in ("items", "used_bits")}))
    return 0


def quicklooks_main(argv=None):
    ap = argparse.ArgumentParser(description="RGB quicklook and 8-bit error maps")
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--out")
    ap.add_argument("--error-against")
    ap.add_argument("--err-out-base")
    ap.add_argument("--err-max-global", type=int, default=255)
    ap.add_argument("--err-max-zoom", type=int, default=None)
    ap.add_argument("--rgb-order", nargs=3, type=int, default=[3, 2, 1])
    ap.add_argument("--rgb-pct", nargs=2, type=float, default=(2, 98))
    args = ap.parse_args(argv)
    from tpukit_torch.viz import quicklooks as ql
    p = Path(args.baseline)
    if args.out:
        params = ql.stretch_params_from_baseline(p, rgb_order=args.rgb_order,
                                                 pct=tuple(args.rgb_pct))
        ql.write_rgb_8bit(p, Path(args.out), params, rgb_order=args.rgb_order)
    if args.error_against:
        out_base = Path(args.err_out_base) if args.err_out_base else p.with_suffix("")
        ql.write_error_max8(p, args.error_against, out_base,
                            err_max_global=args.err_max_global,
                            err_max_zoom=args.err_max_zoom,
                            pct=tuple(args.rgb_pct))
    return 0


def _figures(command: str):
    """``viz.figures``, imported when a figure command runs. It needs
    pandas and matplotlib; without them the command exits non-zero naming
    the missing package (there is no other renderer to fall back to)."""
    try:
        from tpukit_torch.viz import figures
    except ImportError as e:
        missing = getattr(e, "name", None) or str(e)
        raise SystemExit(f"{command}: the figure commands need pandas and "
                         f"matplotlib; {missing} is not available ({e})")
    return figures


def rd_curve_main(argv=None):
    ap = argparse.ArgumentParser(description="RD curves from metrics_mean.csv")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--case", default=None)
    ap.add_argument("--asset", default=None)
    ap.add_argument("--tile", default=None)
    ap.add_argument("--codec", default=None)
    ap.add_argument("--anchor-q", type=float, default=None)
    ap.add_argument("--anchor-bpp", type=float, default=None)
    ap.add_argument("--anchor-error", type=float, default=None)
    ap.add_argument("--out-prefix", default="fig/rd")
    ap.add_argument("--ymetric", choices=["psnr", "ssim"], default="psnr")
    ap.add_argument("--interp", action="store_true")
    ap.add_argument("--interp-points", type=int, default=200)
    args = ap.parse_args(argv)
    figures = _figures("rd-curve")
    df = figures.read_csv_smart(args.csv)
    for col, val in (("case", args.case), ("asset", args.asset),
                     ("codec", args.codec)):
        if val is not None and col in df.columns:
            df = df[df[col] == val]
    if df.empty:
        raise SystemExit("No rows match the provided filters.")
    anchors = {}
    if args.anchor_q is not None:
        anchors["q"] = f"quality={args.anchor_q}"
    if args.anchor_bpp is not None:
        anchors["bpp"] = f"bpp={args.anchor_bpp}"
    if args.anchor_error is not None:
        anchors["near"] = f"near={args.anchor_error}"
    tiles = [args.tile] if args.tile else None
    figures.plot_rd(df, args.out_prefix, tiles=tiles, ymetric=args.ymetric,
                    codec=args.codec, anchors=anchors, interp=args.interp,
                    interp_points=args.interp_points)
    return 0


def overlay_means_main(argv=None):
    ap = argparse.ArgumentParser(description="Overlay RD + Pareto + ISO bars")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--inputs", nargs="*", default=None)
    ap.add_argument("--glob", default=None)
    ap.add_argument("--dedup", action="store_true")
    ap.add_argument("--save-merged", default=None)
    ap.add_argument("--case", default=None)
    ap.add_argument("--asset", default=None)
    ap.add_argument("--tiles", default="HC,LC")
    ap.add_argument("--ymetric", choices=["psnr", "ssim"], default="psnr")
    ap.add_argument("--out-prefix", default="fig/overlay")
    ap.add_argument("--codecs", nargs="*", default=None)
    ap.add_argument("--anchors", default=None)
    ap.add_argument("--interp", action="store_true")
    ap.add_argument("--interp-points", type=int, default=200)
    ap.add_argument("--iso-quality-psnr", type=float, default=65.0)
    ap.add_argument("--iso-rate-cr", default="2,5,7")
    args = ap.parse_args(argv)
    figures = _figures("overlay-means")
    paths = []
    if args.csv:
        paths.append(Path(args.csv))
    if args.inputs:
        paths += [Path(x) for x in args.inputs]
    if args.glob:
        paths += sorted(Path(".").glob(args.glob))
    df = figures.load_and_merge(paths, dedup=args.dedup)
    if args.save_merged:
        Path(args.save_merged).parent.mkdir(parents=True, exist_ok=True)
        df.to_csv(args.save_merged, sep=";", index=False, decimal=",")
    for col, val in (("case", args.case), ("asset", args.asset)):
        if val is not None and col in df.columns:
            df = df[df[col] == val]
    if args.codecs:
        df = df[df["codec"].isin(args.codecs)]
    if df.empty:
        raise SystemExit("No rows after filters.")
    anchors = json.loads(args.anchors) if args.anchors else {}
    tiles = [t.strip() for t in args.tiles.split(",") if t.strip()]
    figures.overlay_rd(df, args.out_prefix, tiles=tiles, ymetric=args.ymetric,
                       anchors=anchors, interp=args.interp,
                       interp_points=args.interp_points)
    for t in tiles:
        figures.pareto_plots(df, args.out_prefix, tile=t, ymetric=args.ymetric,
                             anchors=anchors)
    try:
        cr_list = [float(x) for x in str(args.iso_rate_cr).replace(";", ",").split(",") if x.strip()]
    except ValueError:
        cr_list = [2, 5, 7]
    for t in tiles:
        figures.iso_rate_psnr_bars(df, args.out_prefix, tile=t, cr_list=cr_list)
    return 0


def fig_caseb_main(argv=None):
    ap = argparse.ArgumentParser(description="LC vs HC bar charts from CSVs")
    ap.add_argument("csv_paths", nargs="+")
    ap.add_argument("--max-codecs", type=int, default=3)
    ap.add_argument("--mem", choices=["enc", "dec"], default="enc")
    ap.add_argument("--outdir", default=".")
    args = ap.parse_args(argv)
    figures = _figures("fig-caseb")
    df = figures.load_and_merge([Path(p) for p in args.csv_paths])
    figures.caseb_bars(df, args.outdir, max_codecs=args.max_codecs, mem=args.mem)
    return 0


def tile_complexity_main(argv=None):
    ap = argparse.ArgumentParser(description="Tile complexity metrics")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--hf-cut", type=float, default=0.30)
    ap.add_argument("--radial-bins", type=int, default=256)
    ap.add_argument("--alpha-min", type=float, default=0.02)
    ap.add_argument("--alpha-max", type=float, default=0.45)
    ap.add_argument("--delent-bins", type=int, default=256)
    ap.add_argument("--delent-clip", type=float, default=99.0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the metrics: cuda (default), "
                         "cuda:N or cpu")
    args = ap.parse_args(argv)
    from tpukit_torch.analysis.complexity import compute_all
    for p in args.paths:
        m = compute_all(p, hf_cut=args.hf_cut, nbins_radial=args.radial_bins,
                        alpha_fit_min=args.alpha_min, alpha_fit_max=args.alpha_max,
                        delent_bins=args.delent_bins,
                        delent_clip_pct=args.delent_clip, device=args.device)
        if args.json:
            print(json.dumps(m))
        else:
            print(f'{Path(m["path"]).name}: '
                  f'grad_mean={m["grad_mean"]:.3f}, '
                  f'hf_ratio={m["hf_ratio"]:.4f}, '
                  f'MDF={m["mdf"]:.4f}, MNF={m["mnf"]:.4f}, '
                  f'alpha={m["alpha"]:.3f}, '
                  f'ps_med={m["ps_median"]:.3e}, ps_mean={m["ps_mean"]:.3e}, '
                  f'delentropy_bits={m["delentropy_bits"]:.3f}')
    return 0


def doctor_main(argv=None):
    """Install and device health check (tpukit/cli/main.py:414-501): the
    python, torch and CUDA versions and the card, the CUDA kernels' build
    (nvcc, K1 and K2), the port's host C++ runtime, and with ``--smoke`` a
    lossless round trip through each of the six codecs on ``--device``.
    Exits nonzero if any REQUIRED check fails. The card is required when
    ``--device`` names one, and so is the kernels' build; tpukit's compile
    cache and ``vm.max_map_count`` rows guard XLA and have no counterpart."""
    ap = argparse.ArgumentParser(
        description="tpukit_torch environment and install health check")
    ap.add_argument("--smoke", action="store_true",
                    help="also run tiny encode/decode round-trips through "
                         "all six codecs (seconds)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to check and to smoke-test on: cuda "
                         "(default), cuda:N or cpu")
    args = ap.parse_args(argv)
    import platform

    import torch

    failures = []

    def row(name, ok, detail, required=True):
        mark = "ok " if ok else ("FAIL" if required else "warn")
        print(f"[{mark}] {name}: {detail}")
        if required and not ok:
            failures.append(name)

    print(f"tpukit_torch doctor — python {platform.python_version()} "
          f"on {platform.machine()}")
    row("torch", True, f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s)")
    from tpukit_torch.device import resolve_device
    want_cuda = torch.device(args.device).type == "cuda"
    device = None
    try:
        device = resolve_device(args.device)
        detail = (f"{device}: {torch.cuda.get_device_name(device)}"
                  if device.type == "cuda" else "cpu (asked for)")
        row("device", True, detail)
    except (RuntimeError, ValueError) as e:
        row("device", False, f"{args.device}: {e}")

    try:
        from tpukit_torch.kernels import build
        nvcc = build.nvcc_path()
        path = build.build_library()
        build.load()
        row("cuda kernels", True, f"{path.name} (K1 fs_table, K2 dwt97; "
            f"{nvcc})", required=want_cuda)
    except (RuntimeError, OSError) as e:
        row("cuda kernels", False, f"build/load failed: {e}",
            required=want_cuda)

    try:
        from tpukit_torch import native
        path = native.build_library()
        lib = native.load()
        row("native library", True, f"{path.name} "
            f"({len([s for s in dir(lib) if not s.startswith('_')])} syms)")
    except (RuntimeError, OSError) as e:
        row("native library", False, f"build/load failed: {e}")

    if args.smoke:
        import numpy as np

        from tpukit_torch.codecs.base import RateSpec
        from tpukit_torch.codecs.registry import create
        rng = np.random.default_rng(0)
        cube = ((rng.integers(0, 4096, (2, 64, 64)).astype(np.uint16))
                << 4)
        for name in ("ccsds121", "jpegls", "png", "j2k", "ccsds122",
                     "ccsds123"):
            try:
                if device is None:
                    raise RuntimeError(f"no device {args.device!r}")
                res = create(name).run(cube, "uint16", RateSpec.none(),
                                       keep_bitstream=True, device=device)
                recon = res.recon
                if isinstance(recon, torch.Tensor):
                    recon = recon.cpu().numpy()
                exact = bool(np.array_equal(recon, cube))
                row(f"codec {name}", exact,
                    f"lossless round-trip on {device}, "
                    f"{res.bitstream_bytes} B")
            except Exception as e:      # a health check reports and goes on
                row(f"codec {name}", False, f"{type(e).__name__}: {e}")

    if failures:
        print(f"doctor: {len(failures)} required check(s) failed: "
              f"{failures}", file=sys.stderr)
        return 1
    print("doctor: all required checks passed")
    return 0


COMMANDS = {
    "run-codec": run_codec_main,
    "make-baseline-a": make_baseline_a_main,
    "make-baseline-b": make_baseline_b_main,
    "quicklooks": quicklooks_main,
    "rd-curve": rd_curve_main,
    "overlay-means": overlay_means_main,
    "fig-caseb": fig_caseb_main,
    "tile-complexity": tile_complexity_main,
    "doctor": doctor_main,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from tpukit_torch.cli import wrappers
    codec_cmds = {
        "codec-ccsds121": wrappers.ccsds121_main,
        "codec-jpegls": wrappers.jpegls_main,
        "codec-png": wrappers.png_main,
        "codec-j2k": wrappers.j2k_main,
        "codec-ccsds122": wrappers.ccsds122_main,
        "codec-ccsds123": wrappers.ccsds123_main,
    }
    all_cmds = {**COMMANDS, **codec_cmds}
    if not argv or argv[0] in ("-h", "--help"):
        print("tpukit_torch commands:")
        for name in sorted(all_cmds):
            print(f"  {name}")
        return 0
    cmd = argv[0]
    if cmd not in all_cmds:
        print(f"unknown command: {cmd}", file=sys.stderr)
        return 2
    return all_cmds[cmd](argv[1:])
