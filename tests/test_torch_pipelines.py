# -*- coding: utf-8 -*-
"""The baseline pipelines of the port against tpukit's, on the CPU.

tpukit's fixtures (tests/test_pipelines.py: four synthetic Sentinel-2
bands; two adjacent synthetic EnMAP products with metadata XML, quality
flags and pixel masks) go through ``tpukit.pipelines`` and
``tpukit_torch.pipelines`` (``device="cpu"``); every output file — scenes,
tiles, masks, the GeoTIFF quicklooks, the PNG quicklooks and error maps —
must be byte-equal, and the index manifests equal up to their output
directory. ``scene_error_map`` is exact in every mode, ``pick_bands``
equal, and the two CLI commands write what tpukit's write."""

import json

import numpy as np
import pytest
import torch

from tpukit.cli.main import make_baseline_a_main as jax_make_a
from tpukit.cli.main import make_baseline_b_main as jax_make_b
from tpukit.io import tiff
from tpukit.pipelines import baseline_a as ja
from tpukit.pipelines import baseline_b as jb
from tpukit_torch.cli.main import main as port_main
from tpukit_torch.pipelines import baseline_a as ta
from tpukit_torch.pipelines import baseline_b as tb

torch.set_num_threads(2)        # xdist workers share the host


def _compare_outputs(root_j, root_p):
    """Every file byte for byte; a JSON manifest after replacing each
    package's output directory by a placeholder."""
    files_j = sorted(p.relative_to(root_j) for p in root_j.rglob("*")
                     if p.is_file())
    files_p = sorted(p.relative_to(root_p) for p in root_p.rglob("*")
                     if p.is_file())
    assert files_p == files_j and files_j
    for rel in files_j:
        bj, bp = (root_j / rel).read_bytes(), (root_p / rel).read_bytes()
        if rel.suffix == ".json":
            bj = bj.replace(str(root_j).encode(), b"OUT")
            bp = bp.replace(str(root_p).encode(), b"OUT")
        assert bp == bj, rel
    return files_j


@pytest.fixture
def s2_bands(tmp_path, rng):
    """Four synthetic 10 m "JP2" bands as GeoTIFFs, 300x200."""
    paths = []
    tr = (10.0, 0.0, 500000.0, 0.0, -10.0, 4600000.0)
    for name in ("B02", "B03", "B04", "B08"):
        arr = rng.integers(100, 4000, (1, 200, 300)).astype(np.uint16)
        arr[0, :3, :5] = 65530          # rounds past 2^16: wraps to 0
        p = tmp_path / f"T29TNH_{name}_10m.tif"
        tiff.write_geotiff(p, arr, transform=tr)
        paths.append(p)
    return paths


@pytest.fixture
def enmap_product(tmp_path, rng):
    """Two adjacent synthetic EnMAP tiles + metadata XML + flag products
    (tests/test_pipelines.py's fixture)."""
    nb = 12
    tr0 = (30.0, 0.0, 600000.0, 0.0, -30.0, 4700000.0)
    tr1 = (30.0, 0.0, 600000.0 + 30.0 * 64, 0.0, -30.0, 4700000.0)
    for k, tr in (("001", tr0), ("002", tr1)):
        cube = rng.integers(-2000, 8000, (nb, 48, 64)).astype(np.int16)
        tiff.write_geotiff(tmp_path / f"ENMAP-DT01-{k}-SPECTRAL_IMAGE.TIF",
                           cube, transform=tr, nodata=-32768)
        flags = np.zeros((1, 48, 64), np.uint16)
        flags[0, :6, :] = 0b10  # cloud bit (index 1)
        tiff.write_geotiff(tmp_path / f"ENMAP-DT01-{k}-QL_QUALITY_TESTFLAGS.TIF",
                           flags, transform=tr)
        pixm = np.zeros((1, 48, 64), np.uint8)
        pixm[0, -3:, :] = 1
        tiff.write_geotiff(tmp_path / f"ENMAP-DT01-{k}-QL_PIXELMASK.TIF",
                           pixm, transform=tr)
    bands_xml = "\n".join(
        f"<bandID number='{i+1}'><wavelengthCenterOfBand>{420+20*i}"
        f"</wavelengthCenterOfBand><badBand>{1 if i == 3 else 0}</badBand></bandID>"
        for i in range(nb))
    (tmp_path / "ENMAP-DT01-METADATA.XML").write_text(
        f"<root><bands>{bands_xml}</bands>"
        "<flagBit index='1' meaning='quality cloud'/>"
        "<flagBit index='2' meaning='quality shadow'/></root>")
    return tmp_path


def test_case_a_outputs_equal_tpukit(tmp_path, s2_bands):
    kw = dict(band_paths=s2_bands, scene_w=256, scene_h=128, tile_w=64,
              tile_h=64, hc_off=(10, 20), lc_off=(128, 30), col_off=0,
              row_off=0)
    want = ja.run(ja.CaseAConfig(outdir=tmp_path / "jax", **kw))
    got = ta.run(ta.CaseAConfig(outdir=tmp_path / "port", device="cpu",
                                **kw))
    assert sorted(got) == sorted(want)
    files = _compare_outputs(tmp_path / "jax", tmp_path / "port")
    assert {f.name for f in files} >= {
        "caseA_scene_2k10k_12in16.tif", "caseA_scene_2k10k_12in16_RGB8.tif",
        "caseA_tile_HC_1024_12in16.tif", "index_caseA.json"}
    with tiff.open(got["scene12"]) as ds:
        assert not np.any(ds.read() & 0xF)


@pytest.mark.parametrize("err_mode", ["max", "mean", "rms", "p95", "count3"])
def test_case_b_outputs_equal_tpukit(tmp_path, enmap_product, err_mode):
    kw = dict(input_raw=enmap_product, dt="DT01", target_bands=8,
              tile_size=32, lc=(4, 4), hc=(72, 8), k=2, err_mode=err_mode)
    want = jb.run(jb.CaseBConfig(output=tmp_path / "jax", **kw))
    got = tb.run(tb.CaseBConfig(output=tmp_path / "port", device="cpu",
                                **kw))
    assert got["used_bits"] == want["used_bits"] == {"cloud": 1, "shadow": 2}
    files = _compare_outputs(tmp_path / "jax", tmp_path / "port")
    names = {f.name for f in files}
    assert f"DT01_scene_180b_14in16.scene_ERR_{err_mode}.png" in names
    assert "DT01_quicklook_rgb.png" in names
    assert sum(n.endswith(".ERRmax_vs16.png") for n in names) == 2


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["max", "mean", "rms", "p95", "count3"])
def test_scene_error_map_exact(rng, mode, k):
    """Every mode and scale equal to tpukit's, with a validity mask and
    differences beyond the k-bit range (p95 clips them)."""
    a = rng.integers(-2000, 8000, (9, 24, 40)).astype(np.int16)
    b = tb.trunc_klsb(a, k).copy()
    b[:, :3] += rng.integers(-40, 40, (9, 3, 40)).astype(np.int16)
    valid = rng.random((24, 40)) > 0.2
    for v in (None, valid):
        for scale in ("fixed", "auto"):
            u8_j, e_j = jb.scene_error_map(a, b, v, mode, k, scale)
            u8_t, e_t = tb.scene_error_map(a, b, v, mode, k, scale,
                                           device="cpu")
            np.testing.assert_array_equal(u8_t, u8_j)
            assert e_t == e_j


def test_pick_bands_and_metadata_equal_tpukit(rng, enmap_product):
    for _ in range(20):
        n = int(rng.integers(10, 240))
        lam = np.sort(rng.uniform(400, 2500, n))
        bad = rng.random(n) < 0.1
        target = int(rng.integers(1, n + 5))
        for args in ((n, lam, bad, target), (n, None, bad, target),
                     (n, lam, None, target)):
            assert tb.pick_bands(*args) == jb.pick_bands(*args)
    xml = enmap_product / "ENMAP-DT01-METADATA.XML"
    (lj, bj, mj), (lt, bt, mt) = jb.parse_metadata(xml), tb.parse_metadata(xml)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(bt, bj)
    assert mt == mj


def test_cli_commands_equal_tpukit(tmp_path, s2_bands, enmap_product,
                                   capsys):
    """make-baseline-a and make-baseline-b through the port's CLI with
    --device cpu write what tpukit's commands write."""
    a_args = ["--bands", *map(str, s2_bands), "--scene", "256x128",
              "--tile", "64x64", "--hc", "10,20", "--lc", "128,30"]
    assert jax_make_a(a_args + ["--outdir", str(tmp_path / "jaxA")]) == 0
    assert port_main(["make-baseline-a", *a_args, "--outdir",
                      str(tmp_path / "portA"), "--device", "cpu"]) == 0
    b_args = ["--input-raw", str(enmap_product), "--dt", "DT01",
              "--target-bands", "8", "--tile-size", "32", "--lc", "4,4",
              "--hc", "72,8", "--err-mode", "p95"]
    assert jax_make_b(b_args + ["--output", str(tmp_path / "jaxB")]) == 0
    assert port_main(["make-baseline-b", *b_args, "--output",
                      str(tmp_path / "portB"), "--device", "cpu"]) == 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert len(printed) == 4 and sorted(printed[1]) == sorted(printed[0])
    _compare_outputs(tmp_path / "jaxA", tmp_path / "portA")
    _compare_outputs(tmp_path / "jaxB", tmp_path / "portB")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main(["make-baseline-b", *b_args, "--output",
                       str(tmp_path / "cuda")])
