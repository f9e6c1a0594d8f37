# -*- coding: utf-8 -*-
"""The whole slice on the CPU: tpukit's run_sweep and tpukit_torch's on the
same small Case B tiles (CCSDS-121 lossless, honest reps, bitstreams and
artifacts kept, chunked device plan), compared file by file.

metrics.csv and metrics_mean.csv must be equal column by column, leaving
out the wall-clock columns (t_*, except the modelled t_link_tile_s), the
process-memory columns (mem_*) and the IQRs of times; every other file
(.aec streams, recon.tif, ERR8 and RGB quicklooks) must be byte-equal."""

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpukit.codecs.ccsds121_codec import CCSDS121Codec as JaxCodec
from tpukit.io import tiff, write_manifest
from tpukit.sweep.runner import SweepConfig as JaxSweepConfig
from tpukit.sweep.runner import run_sweep as jax_run_sweep
from tpukit_torch.convert import from_tpukit_codec
from tpukit_torch.kernels.fs_table import fs_table
from tpukit_torch.sweep.runner import SweepConfig, run_sweep

torch.set_num_threads(2)        # xdist workers share the host

_REPO = Path(__file__).resolve().parent.parent


def _volatile(col: str) -> bool:
    """Wall-clock and process-memory columns (and their means and IQRs)."""
    return ((col.startswith("t_") and not col.startswith("t_link_tile_s"))
            or col.startswith("mem_"))


def _read_csv(path):
    with open(path, newline="") as f:
        r = csv.reader(f, delimiter=";")
        header = next(r)
        return header, [dict(zip(header, row)) for row in r]


@pytest.fixture
def caseb_tiles(tmp_path, rng):
    """Two 16-band int16 14-in-16 tiles of 48×48 px with nodata pixels and
    a user mask; a 32-px codec tile grid gives full and edge tiles."""
    items = []
    for tid, amp in (("LC", 6), ("HC", 60)):
        base = rng.integers(200, 1800, (48, 48)).astype(np.int32)
        cube = (base[None] + rng.integers(-amp, amp, (16, 48, 48))).astype(np.int16)
        cube = ((cube.view(np.uint16) >> 2) << 2).view(np.int16)
        cube[:, 40:, :3] = -4                         # nodata pixels
        p = tmp_path / f"caseB_tile_{tid}.tif"
        tiff.write_geotiff(p, cube, nodata=-4)
        mask = np.ones((48, 48), np.uint8)
        mask[:5, :] = 0
        mp = tmp_path / f"caseB_tile_{tid}_mask.tif"
        tiff.write_geotiff(mp, mask, nodata=0)
        items.append({"tile_id": tid, "path": p, "mask": mp})
    idx = tmp_path / "index_caseB.json"
    write_manifest(idx, "caseB", "tile_512", items)
    return idx


def test_port_sweep_equals_tpukit(tmp_path, caseb_tiles, monkeypatch):
    from tpukit_torch.codecs import ccsds121 as model

    plans = []
    encode_plan = model.encode_plan

    def spy(*a, **kw):
        plans.append(encode_plan(*a, **kw))
        return plans[-1]

    monkeypatch.setattr(model, "encode_plan", spy)
    jax_codec = JaxCodec(tile=32, interleave="bip", preproc="none",
                         plan_chunk=2048)
    common = dict(indices=caseb_tiles, codec_label="ccsds121_ext",
                  rate_key="none", reps=2, keep_bitstream=True, ql_rgb=True,
                  ql_err_zoom=40)
    jax_run_sweep(JaxSweepConfig(codec=jax_codec, outdir=tmp_path / "jax",
                                 **common))
    res = run_sweep(SweepConfig(codec=from_tpukit_codec(jax_codec),
                                outdir=tmp_path / "port", device="cpu",
                                **common))
    assert [p["tile"] for p in res["phases"]] == ["LC", "HC"]
    # one chunked device plan per codec tile (4 per item), reused by rep 2
    assert len(plans) == 8 and all(len(p["sizes"]) > 1 for p in plans)
    assert fs_table.launches == 0                 # CPU tensors: plain table

    for name in ("metrics.csv", "metrics_mean.csv"):
        hj, rows_j = _read_csv(tmp_path / "jax" / name)
        hp, rows_p = _read_csv(tmp_path / "port" / name)
        assert hp == hj, name
        assert len(rows_p) == len(rows_j) == (4 if name == "metrics.csv" else 2)
        for rp, rj in zip(rows_p, rows_j):
            for col in hj:
                if not _volatile(col):
                    assert rp[col] == rj[col], (name, col)
    rows = res["rows"]
    assert all(r["lossless"] == 1 and r["max_abs_err"] == 0 for r in rows)
    assert "hbm_peak_bytes" not in rows[0]        # omitted on the CPU

    files_j = sorted(p.relative_to(tmp_path / "jax")
                     for p in (tmp_path / "jax").rglob("*") if p.is_file())
    files_p = sorted(p.relative_to(tmp_path / "port")
                     for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert files_p == files_j
    kinds = {p.suffix for p in files_j}
    assert {".aec", ".tif", ".csv"} <= kinds
    assert any(p.name == "recon_ERR8_0_40.tif" for p in files_j)
    for rel in files_j:
        if rel.suffix != ".csv":
            assert (tmp_path / "port" / rel).read_bytes() == \
                (tmp_path / "jax" / rel).read_bytes(), rel


@pytest.mark.parametrize("extra", [["--mesh", "2", "--codec", "ccsds121",
                                    "--tile", "32"],
                                   ["--stream-rows", "32", "--codec",
                                    "ccsds121", "--tile", "32"],
                                   ["--profile", "{tmp}/prof", "--codec",
                                    "ccsds121", "--tile", "32"],
                                   ["--compressor-cmd", "{python}", "{wrap}",
                                    "--codec", "ccsds121_ext"],
                                   ["--compressor-cmd", "{python}", "{wrap}",
                                    "--codec", "ccsds121_ext", "--", "--tile",
                                    "32"],
                                   ["--codec", "j2k", "--entropy", "device",
                                    "--keep-bitstream"],
                                   ["--codec", "ccsds122"]])
def test_cli_refuses_what_is_not_ported(tmp_path, caseb_tiles, extra):
    """What the port once refused runs the sweep and returns 0, as
    tpukit's ``run_codec_main`` does, with tpukit's bytes: ``--mesh 2``
    (two positions, tpukit's two virtual devices), scene streaming in row
    strips, ``--profile``, ``--compressor-cmd`` with the arguments after
    ``--`` passed through to the wrapper, the device mode's kept streams,
    CCSDS-122. The ``--compressor-cmd`` runs drive the port's
    ``codec-ccsds121`` wrapper in a child process, held against tpukit's
    codec run in this process with the wrapper's options."""
    from tpukit.cli.main import run_codec_main as jax_run_codec
    from tpukit_torch.cli.main import main, run_codec_main

    wrap = tmp_path / "wrap.py"
    wrap.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(_REPO)!r})\n"
        "from tpukit_torch.cli.main import main\n"
        "sys.exit(main(['codec-ccsds121', '--device', 'cpu', "
        "*sys.argv[1:]]))\n")
    fill = {"{tmp}/prof": str(tmp_path / "prof"), "{python}": sys.executable,
            "{wrap}": str(wrap)}
    extra = [fill.get(x, x) for x in extra]
    argv = ["--indices", str(caseb_tiles), "--rate-key", "none", "--reps",
            "1", "--no-artifacts"]
    port_extra = extra
    if "--compressor-cmd" in extra:
        # tpukit's in-process codec with the wrapper's options
        extra = ["--codec", "ccsds121", "--tile",
                 "32" if "--" in extra else "512"]
    # the arguments after "--" go last: they all pass through
    got = run_codec_main(argv + ["--outdir", str(tmp_path / "port"),
                                 "--device", "cpu"] + port_extra)
    want = jax_run_codec(argv + extra + ["--outdir", str(tmp_path / "jax")])
    assert got == want == 0
    _, rows = _read_csv(tmp_path / "port" / "metrics.csv")
    _, jrows = _read_csv(tmp_path / "jax" / "metrics.csv")
    assert [(r["tile_id"], r["bitstream_bytes"], r["lossless"])
            for r in rows] == \
        [(r["tile_id"], r["bitstream_bytes"], r["lossless"]) for r in jrows]
    assert [r["lossless"] for r in rows] == ["1", "1"]
    if "--profile" in port_extra:
        assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    # the entry point hands the command's code on
    assert main(["run-codec"] + argv + ["--outdir", str(tmp_path / "again"),
                                        "--device", "cpu"] + port_extra) == 0
    assert main(["no-such-command"]) == 2
