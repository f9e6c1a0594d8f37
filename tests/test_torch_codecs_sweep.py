# -*- coding: utf-8 -*-
"""The lossless codecs of Case B as whole sweeps on the CPU: tpukit's
run_sweep and tpukit_torch's on the same small Case B tile for CCSDS-123
(``standard``; ``ls`` with tpukit's fitted weights injected into the port),
JPEG-LS (lossless, diff1, a near-lossless point, a cr point) and PNG.

metrics.csv and metrics_mean.csv must be equal column by column, leaving
out the wall-clock columns (t_*, except the modelled t_link_tile_s) and the
process-memory columns (mem_*); every other file (kept streams, recon.tif
with the source's validity mask for CCSDS-123, ERR8 quicklooks) must be
byte-equal. The lossless rows are exact in every column. The quality and
spectral metrics of JPEG-LS's lossy recons are float32 sums taken in
another order by torch than by XLA: those columns are held within the
metric pass's tolerances (tests/test_torch_metrics.py: PSNR/SSIM rel 1e-4,
SAM/SID/LMSE rel 1e-3), every other column exactly."""

import csv
import math

import numpy as np
import pytest
import torch

from tpukit.codecs import ccsds123_codec as jax123
from tpukit.codecs.registry import create as jax_create
from tpukit.io import tiff, write_manifest
from tpukit.sweep.runner import SweepConfig as JaxSweepConfig
from tpukit.sweep.runner import run_sweep as jax_run_sweep
from tpukit_torch.convert import from_tpukit_codec
from tpukit_torch.kernels.fs_table import fs_table
from tpukit_torch.sweep.runner import SweepConfig, run_sweep

torch.set_num_threads(2)        # xdist workers share the host


def _volatile(col: str) -> bool:
    """Wall-clock and process-memory columns (and their means and IQRs)."""
    return ((col.startswith("t_") and not col.startswith("t_link_tile_s"))
            or col.startswith("mem_"))


def _read_csv(path):
    with open(path, newline="") as f:
        r = csv.reader(f, delimiter=";")
        header = next(r)
        return header, [dict(zip(header, row)) for row in r]


def _num(s: str) -> float:
    return float(s.replace(",", "."))


@pytest.fixture
def caseb_tile(tmp_path, rng):
    """One spectrally correlated 12-band int16 14-in-16 tile of 48×40 px
    with a nodata corner, an internal validity mask and a user mask."""
    base = rng.integers(500, 3000, (48, 40)).astype(np.float64)
    gains = 1.0 + 0.3 * np.sin(np.linspace(0, 6, 12))
    cube = (base[None] * gains[:, None, None]
            + rng.normal(0, 8, (12, 48, 40))).astype(np.int16)
    cube = ((cube.view(np.uint16) >> 2) << 2).view(np.int16)
    cube[:, 40:, :6] = -4                         # nodata pixels
    src_mask = np.full((48, 40), 255, np.uint8)
    src_mask[40:, :6] = 0
    p = tmp_path / "caseB_tile.tif"
    tiff.write_geotiff(p, cube, nodata=-4, mask=src_mask)
    mask = np.ones((48, 40), np.uint8)
    mask[:5, :] = 0
    mp = tmp_path / "caseB_tile_mask.tif"
    tiff.write_geotiff(mp, mask, nodata=0)
    idx = tmp_path / "index_caseB.json"
    write_manifest(idx, "caseB", "tile_512",
                   [{"tile_id": "T", "path": p, "mask": mp}])
    return idx, src_mask


def _compare_trees(root_j, root_p, reps, n_rates=1, lossy=False):
    for name in ["metrics.csv"] + (["metrics_mean.csv"] if reps > 1 else []):
        hj, rows_j = _read_csv(root_j / name)
        hp, rows_p = _read_csv(root_p / name)
        assert hp == hj, name
        assert len(rows_p) == len(rows_j) == \
            (reps * n_rates if name == "metrics.csv" else n_rates)
        for rp, rj in zip(rows_p, rows_j):
            for col in hj:
                if _volatile(col):
                    continue
                tol = (1e-4 if col.startswith(("psnr", "ssim")) else
                       1e-3 if col.startswith(("sam_deg", "sid", "lmse"))
                       else None)
                if tol and lossy and rj[col] != rp[col]:
                    a, b = _num(rj[col]), _num(rp[col])
                    assert math.isfinite(b) and abs(a - b) <= tol * abs(a), \
                        (name, col, rj[col], rp[col])
                else:
                    assert rp[col] == rj[col], (name, col)
    files_j = sorted(p.relative_to(root_j) for p in root_j.rglob("*")
                     if p.is_file())
    files_p = sorted(p.relative_to(root_p) for p in root_p.rglob("*")
                     if p.is_file())
    assert files_p == files_j
    for rel in files_j:
        if rel.suffix != ".csv":
            assert (root_p / rel).read_bytes() == (root_j / rel).read_bytes(), rel
    return files_j


SWEEPS = {
    "ccsds123_standard": ("ccsds123", dict(predictor="standard", tile=32),
                          "none", None, ".l123"),
    "ccsds123_standard_bip_block": (
        "ccsds123_ext", dict(predictor="standard", interleave="bip",
                             entropy="block", pred_bands=5,
                             pred_mode="reduced", local_sums="column"),
        "none", None, ".l123"),
    "ccsds123_ls_whole": ("ccsds123", dict(tile=64), "none", None, ".bit"),
    "ccsds123_ls_tiled_crop": ("ccsds123", dict(tile=16, crop_nodata=True),
                               "none", None, ".bit"),
    "jpegls": ("jpegls", {}, "none", None, ".jls"),
    "jpegls_diff1": ("jpegls_subproc", dict(preproc="diff1"), "none", None,
                     ".jls"),
    "jpegls_near": ("jpegls", {}, "nearlossless_eps", [1, 3], ".jls"),
    "jpegls_cr_bpp": ("jpegls", {}, "cr", [3, 8], ".jls"),
    "png": ("png", dict(zlevel=4), "none", None, ".png"),
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_port_sweep_equals_tpukit(tmp_path, caseb_tile, monkeypatch, case):
    idx, src_mask = caseb_tile
    name, opts, rate_key, rates, suffix = SWEEPS[case]
    jax_codec = jax_create(name, **opts)
    port_codec = from_tpukit_codec(jax_codec)
    assert type(port_codec).__module__.startswith("tpukit_torch.")
    reps = 2
    common = dict(indices=idx, codec_label=name, rate_key=rate_key,
                  rates=rates, reps=reps, keep_bitstream=True,
                  ql_err_zoom=40)

    if "_ls_" in case:
        # tpukit fits its weights in float32; the port takes them as they
        # are, in call order, and must then produce tpukit's bytes
        fitted = []
        encode_model = jax123.encode_model

        def recording(xu):
            mapped, wq = encode_model(xu)
            fitted.append(np.asarray(wq))
            return mapped, wq

        monkeypatch.setattr(jax123, "encode_model", recording)
    jax_run_sweep(JaxSweepConfig(codec=jax_codec, outdir=tmp_path / "jax",
                                 **common))
    if "_ls_" in case:
        assert fitted
        replay = iter(fitted)
        port_codec._fit_weights = lambda feats, c: next(replay)
    res = run_sweep(SweepConfig(codec=port_codec, outdir=tmp_path / "port",
                                device="cpu", **common))
    assert fs_table.launches == 0                 # CPU tensors: plain table

    n_rates = len(rates) if rates else 1
    files = _compare_trees(tmp_path / "jax", tmp_path / "port", reps, n_rates,
                           lossy=rate_key != "none")
    assert any(p.suffix == suffix for p in files), files
    assert any(p.name == "recon_ERR8_0_40.tif" for p in files)
    if rate_key == "none":
        assert all(r["lossless"] == 1 and r["max_abs_err"] == 0
                   for r in res["rows"])
    if rate_key == "nearlossless_eps":
        assert [r["max_abs_err"] <= r["rate_value"] for r in res["rows"]] \
            == [True] * (reps * n_rates)
        assert [r["nearlossless_eps"] for r in res["rows"]] == [1, 1, 3, 3]
    recon = next(p for p in files if p.name == "recon.tif")
    with tiff.open(tmp_path / "port" / recon) as ds:
        got_mask = ds.dataset_mask()
    if name.startswith("ccsds123"):
        # the source's validity mask travels into the recon
        np.testing.assert_array_equal(got_mask, src_mask)


def test_uint16_tile_recon_tensor_through_the_sweep(tmp_path, rng, monkeypatch):
    """A uint16 source: the ls codec hands the runner a ``torch.uint16``
    tensor (one tile) and the metric pass, recon.tif and its mask come out
    as tpukit's (tests/test_ccsds123.py::test_mask_passthrough_in_sweep)."""
    cube = rng.integers(0, 2048, (4, 32, 32)).astype(np.uint16)
    cube[:, :8, :] = 0
    mask = (cube[0] != 0).astype(np.uint8) * 255
    tiff.write_geotiff(tmp_path / "t.tif", cube, nodata=0.0, mask=mask)
    idx = tmp_path / "index.json"
    write_manifest(idx, "caseB", "tile", [{"tile_id": "T",
                                           "path": tmp_path / "t.tif"}])
    fitted = []
    encode_model = jax123.encode_model
    monkeypatch.setattr(
        jax123, "encode_model",
        lambda xu: (lambda m, w: fitted.append(np.asarray(w)) or (m, w))(
            *encode_model(xu)))
    common = dict(indices=idx, codec_label="ccsds123_ext", reps=1,
                  keep_bitstream=True)
    jax_codec = jax_create("ccsds123", tile=32)
    jax_run_sweep(JaxSweepConfig(codec=jax_codec, outdir=tmp_path / "jax",
                                 **common))
    port_codec = from_tpukit_codec(jax_codec)
    replay = iter(fitted)
    port_codec._fit_weights = lambda feats, c: next(replay)
    seen = []
    run = port_codec.run
    port_codec.run = lambda *a, **kw: (lambda r: seen.append(r.recon) or r)(
        run(*a, **kw))
    res = run_sweep(SweepConfig(codec=port_codec, outdir=tmp_path / "port",
                                device="cpu", **common))
    assert [type(r) for r in seen] == [torch.Tensor]
    assert seen[0].dtype == torch.uint16
    assert res["rows"][0]["lossless"] == 1
    files = _compare_trees(tmp_path / "jax", tmp_path / "port", 1)
    recon = next(p for p in files if p.name == "recon.tif")
    with tiff.open(tmp_path / "port" / recon) as ds:
        np.testing.assert_array_equal(ds.dataset_mask(), mask)
        np.testing.assert_array_equal(ds.read(), cube)
