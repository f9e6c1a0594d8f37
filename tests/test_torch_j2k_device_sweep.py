# -*- coding: utf-8 -*-
"""The J2K device fast mode (``entropy="device"``) end to end on the CPU:
tpukit's J2KCodec and tpukit_torch's on the same small 12-in-16 cubes.

The reversible point is integer throughout (5/3 DWT, exact size model), so
its bytes are held exactly and its recon equals the input. Lossy points go
through each package's own float32 9/7 DWT, which round differently
(XLA:CPU contracts the lifting into FMAs), so a few coefficients cross a
quantizer bin: their bytes are held within rel 5e-3 and their recon MSE
within rel 1e-2, tpukit's own cross-device tolerances
(tests/test_tpu_smoke.py). Within the port, the batched tiled sweep equals
the tile-by-tile run exactly, whatever the batch size. ``ebcot`` tiles at
bpp targets need no pricing, so their streams equal tpukit's byte for
byte.
"""

import csv
import math

import numpy as np
import pytest
import torch

import tpukit.codecs.j2k_codec as jj2k
from tpukit.cli.main import run_codec_main as jax_run_codec
from tpukit.codecs.base import RateSpec
from tpukit.io import tiff, write_manifest
from tpukit_torch.cli.main import run_codec_main
from tpukit_torch.codecs.base import RateSpec as TRateSpec
from tpukit_torch.codecs import j2k_codec as tj2k
from tpukit_torch.convert import from_tpukit_codec

torch.set_num_threads(2)        # xdist workers share the host

BYTES_REL = 5e-3
MSE_REL = 1e-2
TILE = 48
QUALITIES = [1, 10, 40, 100]


def _port(specs):
    """The port's own RateSpecs, with the values of tpukit's."""
    return [TRateSpec(s.key, s.value, s.lossless) for s in specs]


def _scene(rng, shape, amp=400):
    """4-band uint16 12-in-16 content: a gradient plus noise, as bench.py
    makes its Case A tiles."""
    _, H, W = shape
    gy, gx = np.mgrid[0:H, 0:W]
    base = (800 + 25 * gy + 15 * gx) % 4096
    return (np.clip(base[None] + rng.integers(-amp, amp, shape), 0, 4095)
            .astype(np.uint16) << 4).astype(np.uint16)


@pytest.fixture(scope="module")
def cubes():
    """An untiled cube off the 32 grid (50×70, padded to 64×96), a tiled
    one whose 48-px tiles take four shapes (48×48, 48×4, 12×48, 12×4), and
    an int16 14-in-16 cube with negative samples."""
    rng = np.random.default_rng(31)
    signed = (rng.integers(-2048, 2048, (4, 50, 70)) << 2).astype(np.int16)
    return {"untiled": _scene(rng, (4, 50, 70)),
            "tiled": _scene(rng, (4, 60, 100)),
            "int16": signed}


def _host(recon) -> np.ndarray:
    return recon.numpy() if isinstance(recon, torch.Tensor) \
        else np.asarray(recon)


def _mse(cube, recon) -> float:
    d = _host(recon).astype(np.float64) - cube.astype(np.float64)
    return float(np.mean(d * d))


def _close(cube, got, want):
    """Port result ``got`` against tpukit's ``want``: bytes within rel
    5e-3, recon MSE within rel 1e-2. Below 1 DN² (quality 100) the MSE is
    the recon's own rounding, where one flipped pixel moves it by more
    than 1e-2, so there the recons are held within 1 DN of each other."""
    assert abs(got.bitstream_bytes - want.bitstream_bytes) \
        <= BYTES_REL * want.bitstream_bytes, \
        (got.bitstream_bytes, want.bitstream_bytes)
    mg, mw = _mse(cube, got.recon), _mse(cube, want.recon)
    if mw >= 1.0:
        assert abs(mg - mw) <= MSE_REL * mw, (mg, mw)
    else:
        diff = (_host(got.recon).astype(np.int64)
                - _host(want.recon).astype(np.int64))
        assert np.abs(diff).max() <= 1, (mg, mw)
    assert _host(got.recon).dtype == cube.dtype
    assert got.extras["quality_used"] == want.extras["quality_used"]


@pytest.mark.parametrize("dtype", ["uint16", "int16"])
def test_lossless_run_equals_tpukit(cubes, dtype):
    cube = cubes["untiled" if dtype == "uint16" else "int16"]
    want = jj2k.J2KCodec(entropy="device").run(cube, dtype, RateSpec.none())
    got = tj2k.J2KCodec(entropy="device").run(cube, dtype, TRateSpec.none(),
                                              device="cpu")
    assert got.bitstream_bytes == want.bitstream_bytes
    assert got.extras == want.extras
    assert got.extras["lsb_shift"] == (4 if dtype == "uint16" else 2)
    assert isinstance(got.recon, torch.Tensor)
    np.testing.assert_array_equal(got.recon.numpy(), cube)


@pytest.mark.parametrize("key,value,rate_fit", [("quality", 40, False),
                                                ("cr", 8.0, False),
                                                ("bpp", 3.0, True)])
def test_lossy_run_equals_tpukit(cubes, key, value, rate_fit):
    """A quality point, a cr point mapped to a quality, and a bpp point
    whose base step is bisected on the device against its byte budget."""
    cube = cubes["untiled"]
    rate = RateSpec.of(key, value)
    want = jj2k.J2KCodec(entropy="device", rate_fit=rate_fit).run(
        cube, "uint16", rate)
    got = tj2k.J2KCodec(entropy="device", rate_fit=rate_fit).run(
        cube, "uint16", TRateSpec.of(key, value), device="cpu")
    _close(cube, got, want)
    if rate_fit:
        assert got.extras["target_bytes"] == want.extras["target_bytes"]
        assert got.bitstream_bytes <= got.extras["target_bytes"]
        assert got.extras["base_step"] == pytest.approx(
            want.extras["base_step"], rel=1e-3)


def test_sweep_qualities_equals_tpukit(cubes):
    """The model-first ladder through ``sweep_rates``, a lossless spec
    among the quality points."""
    cube = cubes["untiled"]
    specs = [RateSpec.of("quality", q) for q in QUALITIES] + [RateSpec.none()]
    want = jj2k.J2KCodec(entropy="device").sweep_rates(cube, "uint16", specs)
    cache = {}
    port = tj2k.J2KCodec(entropy="device")
    got = port.sweep_rates(cube, "uint16", _port(specs),
                           device_plan_cache=cache, device="cpu")
    for g, w in zip(got[:-1], want[:-1]):
        _close(cube, g, w)
    assert got[-1].bitstream_bytes == want[-1].bitstream_bytes
    # a second rep reuses the cached DWT and gives the same points
    again = port.sweep_rates(cube, "uint16", _port(specs),
                             device_plan_cache=cache, device="cpu")
    assert [r.bitstream_bytes for r in again] == \
        [r.bitstream_bytes for r in got]
    assert all(torch.equal(a.recon, g.recon) for a, g in zip(again, got))


@pytest.fixture(scope="module")
def tiled_runs(cubes):
    """tpukit's and the port's tiled device sweeps of the tiled cube: two
    quality points and the reversible point."""
    cube = cubes["tiled"]
    specs = [RateSpec.of("quality", 10), RateSpec.of("quality", 40),
             RateSpec.none()]
    codec = jj2k.J2KCodec(tilex=TILE, tiley=TILE, entropy="device")
    want = codec.sweep_rates(cube, "uint16", specs)
    got = from_tpukit_codec(codec).sweep_rates(cube, "uint16", _port(specs),
                                               device="cpu")
    return cube, _port(specs), want, got


def test_tiled_sweep_equals_tpukit(tiled_runs):
    cube, _, want, got = tiled_runs
    for g, w in zip(got[:2], want[:2]):
        _close(cube, g, w)
        assert (g.extras["tilex"], g.extras["tiley"]) == (TILE, TILE)
    assert got[2].bitstream_bytes == want[2].bitstream_bytes
    np.testing.assert_array_equal(_host(got[2].recon), cube)


@pytest.mark.parametrize("batch", [8, 1, 3])
def test_batched_tiled_sweep_equals_tile_by_tile(tiled_runs, monkeypatch,
                                                 batch):
    """The batched sweep (tiles grouped by shape, at most ``batch`` to a
    device batch) gives the sequential tiled run's bytes and recons."""
    cube, specs, _, got = tiled_runs
    monkeypatch.setattr(tj2k, "_TILE_BATCH", batch)
    codec = tj2k.J2KCodec(tilex=TILE, tiley=TILE, entropy="device")
    batched = codec.sweep_rates(cube, "uint16", specs[:2], device="cpu")
    for b, g, spec in zip(batched, got, specs):
        seq = codec.run(cube, "uint16", spec, device="cpu")
        for r in (b, g):
            assert r.bitstream_bytes == seq.bitstream_bytes
            assert torch.equal(r.recon, seq.recon)


def test_ebcot_tiles_at_bpp_equal_tpukit(cubes):
    """``ebcot`` tiles (lifted refusal): bpp points truncate each tile to
    its arithmetic budget, no pricing, so the streams equal tpukit's."""
    cube = cubes["tiled"]
    specs = [RateSpec.of("bpp", 1.0), RateSpec.of("bpp", 4.0)]
    codec = jj2k.J2KCodec(tilex=TILE, tiley=TILE)
    want = codec.sweep_rates(cube, "uint16", specs, keep_bitstream=True)
    got = from_tpukit_codec(codec).sweep_rates(cube, "uint16", _port(specs),
                                               keep_bitstream=True,
                                               device="cpu")
    for g, w in zip(got, want):
        assert g.bitstreams == w.bitstreams and len(g.bitstreams) == 6 * 4
        assert g.bitstream_bytes == w.bitstream_bytes
        np.testing.assert_array_equal(_host(g.recon), _host(w.recon))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter=";"))


def _num(s: str) -> float:
    return float(s.replace(",", ".")) if s else float("nan")


def test_cli_tiled_device_csv_matches_tpukit(tmp_path, cubes):
    """``run-codec --entropy device --tilex 48 --tiley 48`` on the CPU: the
    port's CSV against tpukit's, column by column. Byte-derived columns
    within rel 5e-3, the MSE behind every PSNR column within rel 1e-2;
    SSIM within 1e-3 and max|Δ| within 2 DN, which a coefficient crossing
    a bin moves; the wall-clock and memory columns are left out; every
    other column is exact."""
    p = tmp_path / "scene.tif"
    tiff.write_geotiff(p, cubes["tiled"])
    idx = tmp_path / "index.json"
    write_manifest(idx, "caseA", "scene", [{"tile_id": "S", "path": p}])
    argv = ["--indices", str(idx), "--codec", "j2k", "--entropy", "device",
            "--rate-key", "quality", "--rates", "10", "40", "--reps", "1",
            "--tilex", str(TILE), "--tiley", str(TILE)]
    jax_run_codec(argv + ["--outdir", str(tmp_path / "jax")])
    run_codec_main(argv + ["--outdir", str(tmp_path / "port"),
                           "--device", "cpu"])
    want = _rows(tmp_path / "jax" / "metrics.csv")
    got = _rows(tmp_path / "port" / "metrics.csv")
    assert len(got) == len(want) == 2 and list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        assert g["lossless"] == "0"
        for col, wv in w.items():
            gv = g[col]
            if (col.startswith(("t_", "mem_")) and col != "t_link_tile_s") \
                    or gv == wv:
                continue
            a, b = _num(gv), _num(wv)
            if col in ("bitstream_bytes", "cr", "bpp", "t_link_tile_s"):
                assert abs(a - b) <= BYTES_REL * abs(b), (col, gv, wv)
            elif col.startswith("psnr"):
                assert abs(10 ** ((b - a) / 10) - 1) <= MSE_REL, (col, gv, wv)
            elif col.startswith("ssim"):
                assert abs(a - b) <= 1e-3, (col, gv, wv)
            elif col.startswith("maxerr") or col == "max_abs_err":
                assert abs(a - b) <= 2, (col, gv, wv)
            else:
                assert math.isnan(a) and math.isnan(b), (col, gv, wv)
