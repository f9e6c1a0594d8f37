# -*- coding: utf-8 -*-
"""The port's own copies of tpukit's host modules behave as the originals.

tpukit_torch keeps copies of the host code it needs (``io``, ``sweep.csvio``,
``sweep.proc``, ``viz.quicklooks``, ``native`` with its C++ sources, the
codec API of ``codecs.base`` and the host codecs ``codecs.ccsds123_std``,
``codecs.jpegls_codec`` and ``codecs.png_codec``) instead of importing
tpukit. Here the copies are held to the originals as text (the package name
in the imports apart, and ``decode_to_device``, which uploads with torch),
the same seeded inputs go through both packages: the writers give byte-equal
files, the native library is built from the port's own sources and codes as
tpukit's does, and chip_smoke.py's input recipes give bench.py's arrays.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from tpukit.io import manifest as j_manifest
from tpukit.io import tiff as j_tiff
from tpukit.io.bitdepth import effective_data_range as j_range
from tpukit.native import ccsds121_host as j_ck
from tpukit.sweep import csvio as j_csvio
from tpukit.viz import quicklooks as j_ql
from tpukit_torch import native
from tpukit_torch.io import manifest as t_manifest
from tpukit_torch.io import tiff as t_tiff
from tpukit_torch.io.bitdepth import effective_data_range as t_range
from tpukit_torch.native import ccsds121_host as t_ck
from tpukit_torch.sweep import csvio as t_csvio
from tpukit_torch.viz import quicklooks as t_ql

REPO = Path(__file__).resolve().parent.parent


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# copies that differ from the original only in the package their imports
# name (and so in how an import statement wraps), and the function each
# leaves to the port's own code
COPIES = {
    "codecs/ccsds123_std.py": None,
    "codecs/jpegls_codec.py": None,
    "codecs/png_codec.py": None,
    "native/ccsds121_host.py": "decode_to_device",
    "io/tiff.py": None,
    "io/jp2.py": None,
    "io/j2c_enc.py": None,
    "io/manifest.py": None,
    "io/raw.py": None,
    "sweep/csvio.py": None,
    "sweep/proc.py": None,
    "viz/quicklooks.py": None,
}


def _source(path: Path, without):
    text = "\n".join(line for line in path.read_text().splitlines()
                     if not line.startswith("# The port's copy of"))
    if without:
        text, cuts = re.subn(r"\ndef %s\(.*?(?=\n\ndef )" % without, "", text,
                             flags=re.S)
        assert cuts == 1, (path, without)
    return " ".join(text.replace("tpukit_torch", "tpukit").split())


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_sources_equal_tpukit(rel):
    """A copy is the original's text, whitespace apart, with ``tpukit`` in
    the imports replaced by ``tpukit_torch``."""
    port = REPO / "tpukit_torch" / rel
    assert "# The port's copy of tpukit/" + rel in port.read_text()
    assert _source(port, COPIES[rel]) == \
        _source(REPO / "tpukit" / rel, COPIES[rel])


def test_native_sources_equal_tpukit():
    src = REPO / "tpukit" / "native" / "src"
    for path in sorted(src.iterdir()):
        assert (REPO / "tpukit_torch" / "native" / "src" / path.name
                ).read_bytes() == path.read_bytes(), path.name


@pytest.mark.parametrize("dtype,kw", [
    ("uint16", {"blockxsize": 32, "blockysize": 32}),
    ("int16", {"nodata": -9999, "tiled": False,
               "descriptions": ["b1", "b2", "b3"]}),
    ("uint8", {"compress": "deflate", "predictor": 2}),
])
def test_tiff_writer_bytes_equal(tmp_path, dtype, kw):
    rng = np.random.default_rng(11)
    info = np.iinfo(dtype)
    cube = rng.integers(max(info.min, -3000), min(info.max, 3000) + 1,
                        (3, 40, 56)).astype(dtype)
    geo = {"crs_wkt": None, "transform": (10.0, 0.0, 500000.0,
                                          0.0, -10.0, 4200000.0)}
    j_tiff.write_geotiff(tmp_path / "j.tif", cube, geo=geo, **kw)
    t_tiff.write_geotiff(tmp_path / "t.tif", cube, geo=geo, **kw)
    assert (tmp_path / "j.tif").read_bytes() == (tmp_path / "t.tif").read_bytes()
    with t_tiff.open(tmp_path / "j.tif") as ds:
        np.testing.assert_array_equal(ds.read(), cube)


def test_manifest_and_data_range_equal(tmp_path):
    items = [{"tile_id": "T1", "path": tmp_path / "a.tif"},
             {"tile_id": "T2", "path": tmp_path / "b.tif"}]
    j_manifest.write_manifest(tmp_path / "j.json", "caseA", "tile", items)
    t_manifest.write_manifest(tmp_path / "t.json", "caseA", "tile", items)
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()
    assert t_manifest.load_indices(tmp_path / "j.json") == \
        j_manifest.load_indices(tmp_path / "j.json")
    rng = np.random.default_rng(3)
    for arr, name in [((rng.integers(0, 4096, 500) << 4).astype(np.uint16),
                       "uint16"),
                      (rng.integers(0, 65536, 500).astype(np.uint16),
                       "uint16"),
                      ((rng.integers(-2048, 2048, 500) << 2).astype(np.int16),
                       "int16"),
                      (rng.integers(-9000, 9000, 500).astype(np.int16),
                       "int16"),
                      (rng.integers(0, 255, 500).astype(np.uint8), "uint8")]:
        assert t_range(arr, name) == j_range(arr, name)


def test_csv_writers_bytes_equal(tmp_path):
    rng = np.random.default_rng(5)
    rows = []
    for tile in ("T1", "T2"):
        for q in (10, 40):
            for rep in range(3):
                row = {"case": "caseA", "asset": "tile", "codec": "j2k",
                       "encoder": "tpukit", "rate_key": "quality",
                       "rate_value": q, "tile_id": tile, "width": 64,
                       "height": 48, "bands": 4, "in_bytes": 24576,
                       "bitstream_bytes": int(rng.integers(1000, 9000)),
                       "psnr_global": float(rng.normal(45, 3)),
                       "ssim_global": float(rng.uniform(0.9, 1.0)),
                       "max_abs_err": int(rng.integers(0, 40)),
                       "lossless": 0, "t_comp_s": float(rng.uniform(0, 1)),
                       "t_dec_s": float(rng.uniform(0, 1)),
                       "sam_deg": float("nan") if rep == 2 else 0.5}
                for b in range(1, 5):
                    row[f"psnr_b{b}"] = float(rng.normal(45, 3))
                rows.append(row)
    for name in ("write_metrics_csv", "write_mean_csv"):
        getattr(j_csvio, name)(tmp_path / f"j_{name}.csv", rows)
        getattr(t_csvio, name)(tmp_path / f"t_{name}.csv", rows)
        assert (tmp_path / f"j_{name}.csv").read_bytes() == \
            (tmp_path / f"t_{name}.csv").read_bytes()


def test_quicklook_writers_bytes_equal(tmp_path):
    rng = np.random.default_rng(9)
    a = (rng.integers(0, 4096, (4, 48, 64)) << 4).astype(np.uint16)
    b = np.clip(a.astype(np.int32) + rng.integers(-300, 300, a.shape), 0,
                65535).astype(np.uint16)
    valid = np.ones(a.shape[1:], bool)
    valid[:5] = False
    params = j_ql.stretch_params_from_arrays(a[[2, 1, 0]], valid)
    assert t_ql.stretch_params_from_arrays(a[[2, 1, 0]], valid) == params
    np.testing.assert_array_equal(t_ql.err8_lut(40), j_ql.err8_lut(40))
    for pkg, tag in ((j_ql, "j"), (t_ql, "t")):
        pkg.write_rgb_8bit_arrays(a[[2, 1, 0]], tmp_path / f"{tag}_rgb.tif",
                                  params, mask=valid)
        pkg.write_error_max8_arrays(a, b, valid, tmp_path / f"{tag}_err",
                                    err_max_global=255, err_max_zoom=40)
    files = sorted(p.name[2:] for p in tmp_path.glob("j_*"))
    assert files and files == sorted(p.name[2:] for p in tmp_path.glob("t_*"))
    for f in files:
        assert (tmp_path / f"j_{f}").read_bytes() == \
            (tmp_path / f"t_{f}").read_bytes(), f


def test_native_library_is_the_ports_own_and_codes_as_tpukits():
    src = REPO / "tpukit_torch" / "native" / "src"
    assert native._SRC_DIR == src
    lib = native.build_library()
    assert lib.parent == REPO / "tpukit_torch" / "native" / "build"
    assert sorted(p.name for p in src.iterdir()) == sorted(
        p.name for p in (REPO / "tpukit" / "native" / "src").iterdir())
    rng = np.random.default_rng(21)
    x = rng.integers(0, 1 << 14, 20001).astype(np.uint16)
    for bits, block, rsi in ((16, 8, 2), (14, 16, 64)):
        stream = t_ck.encode(x, bits, block, rsi)
        assert stream == j_ck.encode(x, bits, block, rsi)
        np.testing.assert_array_equal(
            t_ck.decode(stream, x.size, bits, block, rsi), x)
        np.testing.assert_array_equal(
            j_ck.decode(stream, x.size, bits, block, rsi), x)


def test_chip_smoke_recipes_equal_bench():
    bench = _load("bench_for_recipes", REPO / "bench.py")
    smoke = _load("chip_smoke_for_recipes", REPO / "chip_smoke.py")
    np.testing.assert_array_equal(
        smoke.make_caseb_cube(np.random.default_rng(2026), 6, 64),
        bench.make_caseb_cube(np.random.default_rng(2026), 6, 64))
    got = smoke.make_casea_tiles(np.random.default_rng(2026))
    want = bench.make_casea_tiles(np.random.default_rng(2026))
    assert sorted(got) == sorted(want) == ["HC", "LC"]
    for tid in want:
        np.testing.assert_array_equal(got[tid], want[tid])
