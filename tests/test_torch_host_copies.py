# -*- coding: utf-8 -*-
"""The port's own copies of tpukit's host modules behave as the originals.

tpukit_torch keeps copies of the host code it needs (``io``, ``sweep.csvio``,
``sweep.proc``, ``viz.quicklooks``, ``native`` with its C++ sources, the
codec API of ``codecs.base``, the host codecs ``codecs.ccsds123_std``,
``codecs.jpegls_codec`` and ``codecs.png_codec``, the wrapper seams
``codecs.shell`` and ``codecs.extern``, the figures of ``viz.figures``, the
BPE bindings ``codecs.bpe122`` and the host Rice / bit-plane / run-length
coder inside ``codecs.wavelet_common``) instead of importing tpukit. Here
the copies are
held to the originals as text (the package name in the imports apart, and
``decode_to_device``, which uploads with torch; ``wavelet_common`` function
by function, since the rest of that module is torch code),
the same seeded inputs go through both packages: the writers give byte-equal
files, the native library is built from the port's own sources and codes as
tpukit's does, and chip_smoke.py's input recipes give bench.py's arrays.
The definitions the port's torch modules keep as tpukit's text (``RangeScan``,
the float64 strip merges, ``stream_plan``, the pipelines' host functions)
are held to it one by one.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from tpukit.codecs import bpe122 as j_bpe
from tpukit.codecs import wavelet_common as j_wc
from tpukit.io import manifest as j_manifest
from tpukit.io import tiff as j_tiff
from tpukit.io.bitdepth import effective_data_range as j_range
from tpukit.native import ccsds121_host as j_ck
from tpukit.sweep import csvio as j_csvio
from tpukit.viz import quicklooks as j_ql
from tpukit_torch import native
from tpukit_torch.codecs import bpe122 as t_bpe
from tpukit_torch.codecs import wavelet_common as t_wc
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
    "codecs/bpe122.py": None,
    "codecs/extern.py": None,
    "codecs/shell.py": None,
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
    "viz/figures.py": None,
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


# the host coder's functions, copied by hand into the port's
# codecs/wavelet_common.py, and the constants they read
HOST_CODER = [
    "scan_order", "inverse_scan_order", "pad_to_multiple", "_rle_cap_bits",
    "subband_seg_bounds", "_rle_model_consts",
    "_tls_buf", "bpc_encode", "bpc_encode_quant_ck", "bpc_encode_quant",
    "bpc_decode", "_fits_rice", "_seg_lens", "rle_size_host", "rle_encode",
    "rle_decode", "_rice_cfg", "_rice_header", "_zigzag32", "_split_s",
    "split_encode", "split_decode", "split_size_host", "zigzag_np",
    "unzigzag_np", "wenc_encode", "wenc_decode", "wenc_quant_encode_ck"]
HOST_CODER_CONSTS = ["RICE_MARK", "RICE_BITS", "RICE_J", "RICE_RSI",
                     "RICE_J_SPARSE", "RICE_RSI_SPARSE", "RLE_MARK",
                     "RLE_CAP_BITS", "SPLIT_FLAG"]


def _function_source(path: Path, name: str) -> str:
    m = re.search(r"^def %s\(.*?(?=^\S|\Z)" % re.escape(name),
                  path.read_text(), flags=re.S | re.M)
    assert m, (path, name)
    text = m.group(0).replace("tpukit_torch", "tpukit")
    text = text.replace("dwtk.subband_slices", "subband_slices")
    # the port's copies may carry a docstring where tpukit has none
    return " ".join(text.split())


@pytest.mark.parametrize("name", HOST_CODER)
def test_host_coder_function_is_tpukits_text(name):
    port = _function_source(
        REPO / "tpukit_torch" / "codecs" / "wavelet_common.py", name)
    orig = _function_source(
        REPO / "tpukit" / "codecs" / "wavelet_common.py", name)
    if name == "pad_to_multiple":       # the port's copy adds a docstring
        port = re.sub(r'""".*?""" ', "", port)
    assert port == orig


def test_host_coder_constants_equal_tpukit():
    for name in HOST_CODER_CONSTS:
        assert getattr(t_wc, name) == getattr(j_wc, name), name


def _coefficient_regimes(rng, n=4096):
    dense = rng.integers(-300, 301, n) * (rng.random(n) < 0.9)
    sparse = rng.integers(-50, 51, n) * (rng.random(n) < 0.01)
    wide = rng.integers(-(1 << 20), 1 << 20, n) * (rng.random(n) < 0.5)
    mid = rng.integers(-40000, 40001, n) * (rng.random(n) < 0.4)
    extreme = wide.copy()
    extreme[:4] = [-(1 << 31), (1 << 31) - 1, 1 << 30, -(1 << 30)]
    return {"dense": dense, "sparse": sparse, "wide": wide, "mid": mid,
            "extreme": extreme, "zeros": np.zeros(n, np.int64),
            "odd_length": dense[:1000]}


@pytest.mark.parametrize("regime", ["dense", "sparse", "wide", "mid",
                                    "extreme", "zeros", "odd_length"])
def test_host_coder_streams_equal_tpukit(regime):
    """Every backend of the host coder, both packages' bindings over their
    own native libraries: byte-equal streams that decode to the input in
    either package."""
    rng = np.random.default_rng(17)
    qc = _coefficient_regimes(rng)[regime].astype(np.int32)
    n = qc.size
    segb = t_wc.subband_seg_bounds(64, 64, 3) if n == 4096 else None
    assert segb == (j_wc.subband_seg_bounds(64, 64, 3) if n == 4096 else None)
    stream = t_wc.wenc_encode(qc, segbounds=segb)
    assert stream == j_wc.wenc_encode(qc, segbounds=segb)
    for dec in (t_wc.wenc_decode, j_wc.wenc_decode):
        np.testing.assert_array_equal(dec(stream, n, segb), qc)
    for budget in (0, 1, 40, 700):
        s = t_wc.bpc_encode(qc, budget)
        assert s == j_wc.bpc_encode(qc, budget)
        if budget:                      # a budget forces this backend
            assert t_wc.wenc_encode(qc, budget) == s
        np.testing.assert_array_equal(t_wc.bpc_decode(s, n),
                                      j_wc.bpc_decode(s, n))
    if t_wc._fits_rice(qc):
        s = t_wc.rle_encode(qc, segb)
        assert s == j_wc.rle_encode(qc, segb)
        assert len(s) == t_wc.rle_size_host(qc, segb) == \
            j_wc.rle_size_host(qc, segb)
        np.testing.assert_array_equal(t_wc.rle_decode(s[1:], n, segb), qc)
    if n % t_wc.RICE_J == 0:
        s = t_wc.split_encode(qc)
        assert s == j_wc.split_encode(qc)
        assert len(s) == t_wc.split_size_host(qc) == j_wc.split_size_host(qc)
        np.testing.assert_array_equal(t_wc.split_decode(s, n), qc)
    assert t_wc._rice_cfg(qc) == j_wc._rice_cfg(qc)
    np.testing.assert_array_equal(t_wc._zigzag32(qc), j_wc._zigzag32(qc))


@pytest.mark.parametrize("inv_base", [1.0, 0.37, 1e-3, 40.0])
def test_fused_quantize_encode_equals_tpukit(inv_base):
    rng = np.random.default_rng(23)
    segb = t_wc.subband_seg_bounds(64, 64, 3)
    for n in (4096, 1000):
        coefs = (rng.laplace(0, 900, n)).astype(np.float32)
        inv_steps = rng.uniform(0.05, 2.0, n).astype(np.float32)
        sb = segb if n == 4096 else None
        got = t_wc.wenc_quant_encode_ck(coefs, inv_steps, np.float32(inv_base),
                                        segbounds=sb)
        want = j_wc.wenc_quant_encode_ck(coefs, inv_steps,
                                         np.float32(inv_base), segbounds=sb)
        assert got[0] == want[0] and got[2:] == want[2:]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(
            got[1], np.trunc(coefs * (inv_steps * np.float32(inv_base)))
            .astype(np.int32))
        np.testing.assert_array_equal(t_wc.wenc_decode(got[0], n, sb), got[1])
        bs, qc = t_wc.bpc_encode_quant(coefs, inv_steps, np.float32(inv_base))
        jbs, jqc = j_wc.bpc_encode_quant(coefs, inv_steps,
                                         np.float32(inv_base))
        assert bs == jbs
        np.testing.assert_array_equal(qc, jqc)


def test_bpe_bindings_equal_tpukit():
    rng = np.random.default_rng(29)
    for Hp, Wp in ((16, 16), (24, 40)):
        for a, b in zip(t_bpe.block_indices(Hp, Wp),
                        j_bpe.block_indices(Hp, Wp)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t_bpe.weight_exp_map(Hp, Wp),
                                      j_bpe.weight_exp_map(Hp, Wp))
        plane = rng.integers(-3000, 3000, (Hp, Wp)).astype(np.int32)
        for limit in (0, 64, 300):
            s = t_bpe.encode_plane(plane, limit, img_width=Wp)
            assert s == j_bpe.encode_plane(plane, limit, img_width=Wp)
            np.testing.assert_array_equal(t_bpe.decode_plane(s, Hp, Wp),
                                          j_bpe.decode_plane(s, Hp, Wp))
        np.testing.assert_array_equal(
            t_bpe.decode_plane(t_bpe.encode_plane(plane), Hp, Wp), plane)


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


# functions and classes of tpukit's modules that the port's modules keep
# as their text (the package name in the imports apart)
COPIED_DEFS = {
    "io/bitdepth.py": ["class RangeScan", "def effective_data_range"],
    "metrics/quality.py": ["def merge_quality_stats", "def assemble_quality",
                           "def _psnr_from", "def _ssim_from"],
    "metrics/spectral.py": ["def merge_spectral_stats",
                            "def assemble_spectral_many"],
    "sweep/streaming.py": ["def stream_plan"],
    "pipelines/baseline_a.py": ["def write_window_stack", "def cut_tile"],
    "pipelines/baseline_b.py": [
        "def parse_metadata", "def pick_bands", "def lambdas_from_descriptions",
        "def nearest_band", "def mosaic", "def _wb_gains", "def _wb_apply",
        "def _wb_whitepatch", "def _wb_grayworld", "def rgb_joint",
        "def _natural_key", "def _find", "def find_bit"],
}


def _def_source(path: Path, head: str) -> str:
    m = re.search(r"^%s\b.*?(?=^\S|\Z)" % re.escape(head),
                  path.read_text(), flags=re.S | re.M)
    assert m, (path, head)
    return " ".join(m.group(0).replace("tpukit_torch", "tpukit").split())


@pytest.mark.parametrize("rel,head", [(rel, head) for rel, heads in
                                      sorted(COPIED_DEFS.items())
                                      for head in heads])
def test_copied_definitions_are_tpukits_text(rel, head):
    assert _def_source(REPO / "tpukit_torch" / rel, head) == \
        _def_source(REPO / "tpukit" / rel, head)


def test_chip_smoke_scene_recipe_equals_bench():
    """chip_smoke.make_scene is the scene recipe inlined in bench.py's main
    (the lines from its mgrid to its 12-in-16 shift), at a small size."""
    smoke = _load("chip_smoke_for_scene", REPO / "chip_smoke.py")
    text = (REPO / "bench.py").read_text()
    m = re.search(r"^( *)gy, gx = np\.mgrid\[0:sc_h, 0:sc_w\]\n.*?<< 4\n",
                  text, flags=re.S | re.M)
    assert m and "scube" in m.group(0)
    recipe = "\n".join(line[len(m.group(1)):]
                       for line in m.group(0).splitlines())
    for shape in ((4, 48, 80), (2, 17, 33)):
        env = {"np": np, "rng": np.random.default_rng(2026),
               "sc_b": shape[0], "sc_h": shape[1], "sc_w": shape[2]}
        exec(recipe, env)
        got = smoke.make_scene(np.random.default_rng(2026), *shape)
        assert got.dtype == env["scube"].dtype == np.uint16
        np.testing.assert_array_equal(got, env["scube"])


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
