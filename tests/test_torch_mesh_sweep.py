# -*- coding: utf-8 -*-
"""``run-codec --mesh DP[,SP]`` on the CPU: the port's sweep runner on a
mesh of CPU positions against its own runs at ``--mesh 1`` and without a
mesh, and against tpukit's runner on its 8-device virtual CPU mesh, case
for case with the sweep cases of tests/test_parallel.py and the streamed
mesh case of tests/test_streaming.py.

Within the port a mesh changes where the work runs, never what it
computes: the CSV (without the wall-clock, process-memory and device-peak
columns) and every artifact are equal for any mesh, for every codec. Against
tpukit: integer codecs give the same bytes and files; the J2K device mode's
float32 transform rounds otherwise than XLA, so its bytes are held within
rel 5e-3 and its MSE within rel 1e-2 (tests/test_torch_j2k_device_streams.py),
exactly with tpukit's coefficients injected; streamed metrics within the
streaming tolerances (PSNR/SSIM rel 1e-5, SAM/SID/LMSE rel 1e-4)."""

import csv
import io
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukit.codecs.j2k_codec as jj2k
from tpukit.codecs.registry import create as jcreate
from tpukit.io import tiff, write_manifest
from tpukit.kernels import dwt as jdwt
from tpukit.sweep.runner import SweepConfig as JSweepConfig
from tpukit.sweep.runner import run_sweep as jrun_sweep
from tpukit_torch.cli.main import run_codec_main
from tpukit_torch.codecs import j2k_codec as tj2k
from tpukit_torch.codecs.registry import create as tcreate
from tpukit_torch.sweep.runner import SweepConfig, run_sweep

torch.set_num_threads(2)        # xdist workers share the host

BYTES_REL = 5e-3
MSE_REL = 1e-2


def _index(tmp_path, cube, case="caseA", name="t", nodata=None):
    p = tmp_path / f"{name}.tif"
    tiff.write_geotiff(p, cube, nodata=nodata)
    idx = tmp_path / f"index_{name}.json"
    write_manifest(idx, case, "tile", [{"tile_id": "T", "path": p}])
    return idx


def _cube(rng, bands=4, size=32, lo=300, hi=3000, amp=80):
    base = rng.integers(lo, hi, (size, size)).astype(np.int32)
    return np.clip(base[None] + rng.integers(-amp, amp, (bands, size, size)),
                   0, 4095).astype(np.uint16)


def _stable(path):
    """metrics.csv without its wall-clock, memory and device-peak
    columns."""
    rows = list(csv.reader(io.StringIO(path.read_text()), delimiter=";"))
    drop = {i for i, c in enumerate(rows[0])
            if c.startswith(("t_", "mem_", "hbm_"))}
    return [[v for i, v in enumerate(r) if i not in drop] for r in rows]


def _files(root):
    """{relative path: bytes} of every file of a run but its CSVs."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.suffix != ".csv"}


def _mse(psnr: float, peak: float) -> float:
    return peak * peak / 10.0 ** (psnr / 10.0)


def _close_to_tpukit(rows, jrows, peak):
    """Port rows against tpukit's: bytes within rel 5e-3, MSE within rel
    1e-2."""
    assert len(rows) == len(jrows)
    for r, j in zip(rows, jrows):
        assert (r["tile_id"], r["rate_value"]) == (j["tile_id"],
                                                   j["rate_value"])
        assert abs(r["bitstream_bytes"] - j["bitstream_bytes"]) \
            <= BYTES_REL * j["bitstream_bytes"]
        mj, mp = _mse(j["psnr_global"], peak), _mse(r["psnr_global"], peak)
        assert abs(mp - mj) <= MSE_REL * mj


@pytest.fixture
def tpukit_coefficients(monkeypatch):
    """The port computes with tpukit's 9/7 coefficients and subband norms."""
    def dwt(x, levels=5, **kw):
        return torch.from_numpy(np.array(jdwt.dwt2(jnp.asarray(x.numpy()),
                                                   "97", levels)))
    monkeypatch.setattr(tj2k, "dwt97", dwt)
    monkeypatch.setattr(tj2k, "_subband_norms", jj2k._subband_norms)


def test_sweep_csv_identical_dp1_vs_dp8(tmp_path, rng):
    """The CSV is identical at ``--mesh 1``, ``8`` and ``4,2`` and without
    a mesh; against tpukit's dp=1 CSV within the J2K tolerances."""
    cube = _cube(rng)
    idx = _index(tmp_path, cube)
    common = dict(indices=idx, codec_label="j2k", rate_key="quality",
                  rates=[20, 60], reps=2, write_artifacts=False,
                  quicklooks=False)
    csvs, rows = {}, {}
    for name, mesh in (("none", None), ("dp1", "1"), ("dp8", "8"),
                       ("dp4sp2", "4,2")):
        rows[name] = run_sweep(SweepConfig(
            codec=tcreate("j2k", entropy="device"), device="cpu",
            outdir=tmp_path / f"runs_{name}", mesh=mesh, **common))["rows"]
        csvs[name] = _stable(tmp_path / f"runs_{name}" / "metrics.csv")
    assert csvs["none"] == csvs["dp1"] == csvs["dp8"] == csvs["dp4sp2"]
    jrows = jrun_sweep(JSweepConfig(
        codec=jcreate("j2k", entropy="device"), outdir=tmp_path / "jax",
        mesh="1", **common))["rows"]
    _close_to_tpukit(rows["dp4sp2"], jrows, 4095.0)


def test_mesh_sweep_artifacts_match_single_device(tmp_path, rng):
    """With artifacts on, a ``--mesh 4`` J2K device sweep writes the same
    files as the single-device sweep (recon.tif and the ERR8 maps), byte
    for byte, under tpukit's names."""
    cube = _cube(rng)
    idx = _index(tmp_path, cube)
    common = dict(indices=idx, codec_label="j2k", rate_key="quality",
                  rates=[20], reps=1)
    for name, mesh in (("single", None), ("mesh", "4")):
        run_sweep(SweepConfig(codec=tcreate("j2k", entropy="device"),
                              device="cpu", outdir=tmp_path / name,
                              mesh=mesh, **common))
    jrun_sweep(JSweepConfig(codec=jcreate("j2k", entropy="device"),
                            outdir=tmp_path / "jax", mesh="4", **common))
    single, mesh = _files(tmp_path / "single"), _files(tmp_path / "mesh")
    assert single == mesh
    assert sorted(single) == sorted(_files(tmp_path / "jax"))
    assert any(k.endswith("rep_01/recon.tif") for k in single)
    assert any("recon_ERR8_0_" in k for k in single)


def test_sweep_rows_match_caseb_spectral_single_vs_mesh(tmp_path, rng,
                                                        tpukit_coefficients):
    """A Case B J2K device sweep at ``--mesh 4,2`` equals ``--mesh 1`` in
    every column, SAM/SID/LMSE included (one single-lane program per lane:
    no float32 sum is split); with tpukit's coefficients the bytes are
    tpukit's dp4sp2 run's, the metrics within rel 1e-2 (each package's own
    float32 inverse 9/7 rounds some pixels 1 DN apart)."""
    base = rng.integers(300, 3000, (24, 24)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (8, 24, 24)),
                   -8192, 8191).astype(np.int16)
    idx = _index(tmp_path, cube, case="caseB", name="tb")
    common = dict(indices=idx, codec_label="j2k", rate_key="quality",
                  rates=[15, 60], reps=2, write_artifacts=False,
                  quicklooks=False)
    rowsets = {}
    for name, mesh in (("dp1", "1"), ("dp4sp2", "4,2")):
        rowsets[name] = run_sweep(SweepConfig(
            codec=tcreate("j2k", entropy="device"), device="cpu",
            outdir=tmp_path / f"runs_{name}", mesh=mesh, **common))["rows"]
    jrows = jrun_sweep(JSweepConfig(
        codec=jcreate("j2k", entropy="device"), outdir=tmp_path / "jax",
        mesh="4,2", **common))["rows"]
    for a, b, j in zip(rowsets["dp1"], rowsets["dp4sp2"], jrows):
        assert np.isfinite(a["sam_deg"]) and a["sam_deg"] > 0
        for k in a:
            if not k.startswith(("t_", "mem_")):
                assert a[k] == b[k], k
        for k in ("bitstream_bytes", "lossless", "bpp", "cr"):
            assert b[k] == j[k], k
        for k in ("psnr_global", "ssim_global", "sam_deg", "sid", "lmse"):
            np.testing.assert_allclose(b[k], j[k], rtol=1e-2, err_msg=k)


def test_mesh_artifacts_match_single_device(tmp_path, rng):
    """A CCSDS-122 sweep at ``--mesh 4,2`` with RGB and ERR8 quicklooks:
    every TIFF byte-equal to the single-device sweep's and to tpukit's
    mesh sweep's (integer codec)."""
    cube = _cube(rng)
    idx = _index(tmp_path, cube)
    common = dict(indices=idx, codec_label="ccsds122", rate_key="bpp",
                  rates=[1.0, 4.0], reps=2, ql_rgb=True)
    for name, mesh in (("single", None), ("mesh", "4,2")):
        run_sweep(SweepConfig(codec=tcreate("ccsds122"), device="cpu",
                              outdir=tmp_path / name, mesh=mesh, **common))
    jrun_sweep(JSweepConfig(codec=jcreate("ccsds122"),
                            outdir=tmp_path / "jax", mesh="4,2", **common))
    single, mesh = _files(tmp_path / "single"), _files(tmp_path / "mesh")
    assert single == mesh == _files(tmp_path / "jax")
    assert any("ERR8" in k for k in single) and any("RGB8" in k
                                                    for k in single)
    assert _stable(tmp_path / "mesh" / "metrics.csv") == \
        _stable(tmp_path / "single" / "metrics.csv")


def test_mesh_honest_vs_dedupe_same_outputs(tmp_path, rng):
    """At ``--mesh 4``, honest reps (one lane per rate and rep, content
    groups uploaded once per position) and ``--dedupe-reps`` give the same
    CSV; its bytes are tpukit's within rel 5e-3."""
    cube = _cube(rng, bands=3, size=48, lo=100, amp=200)
    idx = _index(tmp_path, cube)
    outs = {}
    for name, ded in (("honest", False), ("dedupe", True)):
        common = dict(indices=idx, codec_label="j2k", rate_key="quality",
                      rates=[20, 60], reps=3, write_artifacts=False,
                      quicklooks=False, mesh="4", dedupe_reps=ded)
        res = run_sweep(SweepConfig(codec=tcreate("j2k", entropy="device"),
                                    device="cpu",
                                    outdir=tmp_path / f"runs_{name}",
                                    **common))
        outs[name] = _stable(tmp_path / f"runs_{name}" / "metrics.csv")
    assert outs["honest"] == outs["dedupe"]
    assert len(outs["honest"]) == 1 + 2 * 3
    jrows = jrun_sweep(JSweepConfig(
        codec=jcreate("j2k", entropy="device"), outdir=tmp_path / "jax",
        **common))["rows"]
    _close_to_tpukit(res["rows"], jrows, 4095.0)


def test_streamed_mesh_equals_single_device(tmp_path, rng):
    """``--mesh`` with ``--stream-rows`` (tests/test_streaming.py:343): the
    metric lanes go round-robin to the positions; rows and every artifact
    and strip stream equal the single-device streamed run's at ``--mesh 4``
    and ``2``, and tpukit's ``--mesh 4`` streamed run's (files byte-equal,
    metrics within the streaming tolerances)."""
    B, H, W = 5, 1024, 192
    gy = np.arange(H, dtype=np.int32)[:, None]
    base = (200 + 3 * gy + rng.integers(0, 900, (B, H, W))).astype(np.int32)
    cube = ((np.clip(base - 500, -8192, 8191).astype(np.int16)
             .view(np.uint16) >> 2) << 2).view(np.int16)
    cube[:, 40:60, :] = -9999
    p = tmp_path / "MS.tif"
    tiff.write_geotiff(p, cube, nodata=-9999)
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseB", "scene", [{"tile_id": "MS", "path": p}])

    common = dict(indices=idx, rate_key="none", keep_bitstream=True,
                  stream_rows=256, reps=2, quicklooks=True, ql_rgb=True)
    rows = {}
    for name, mesh in (("single", None), ("mesh", "4"), ("mesh2", "2")):
        codec = tcreate("ccsds121", tile=256, preproc="diff1")
        rows[name] = run_sweep(SweepConfig(
            codec=codec, codec_label=codec.name, device="cpu",
            outdir=tmp_path / name, mesh=mesh, **common))["rows"]
    jcodec = jcreate("ccsds121", tile=256, preproc="diff1")
    jrows = jrun_sweep(JSweepConfig(
        codec=jcodec, codec_label=jcodec.name, outdir=tmp_path / "jax",
        mesh="4", **common))["rows"]
    vol = ("t_", "mem_")
    for other in ("mesh", "mesh2"):
        assert len(rows[other]) == len(rows["single"]) == len(jrows)
        for ra, rb in zip(rows["single"], rows[other]):
            assert {k: v for k, v in ra.items() if not k.startswith(vol)} \
                == {k: v for k, v in rb.items() if not k.startswith(vol)}
        assert _files(tmp_path / other) == _files(tmp_path / "single")
    files = _files(tmp_path / "mesh")
    assert files == _files(tmp_path / "jax")
    assert any("ERR8" in k for k in files) and any("/bit/" in k
                                                   for k in files)
    for r, j in zip(rows["mesh"], jrows):
        for k, v in j.items():
            if k.startswith(vol):
                continue
            if isinstance(v, float) and math.isnan(v):
                assert math.isnan(r[k]), k
            elif isinstance(v, float) and k.startswith(("psnr", "ssim")):
                assert r[k] == pytest.approx(v, rel=1e-5), k
            elif isinstance(v, float) and k.startswith(("sam", "sid",
                                                        "lmse")):
                assert r[k] == pytest.approx(v, rel=1e-4), k
            else:
                assert r[k] == v, k


_CODECS = {
    "j2k_device": ["--codec", "j2k", "--entropy", "device", "--rate-key",
                   "quality", "--rates", "20", "60"],
    "j2k_ebcot": ["--codec", "j2k", "--rate-key", "quality", "--rates",
                  "20", "60"],
    "ccsds121": ["--codec", "ccsds121", "--tile", "16"],
    "ccsds122_bpe": ["--codec", "ccsds122", "--rate-key", "bpp", "--rates",
                     "1", "16"],
    "ccsds122_embedded": ["--codec", "ccsds122", "--entropy", "embedded",
                          "--rate-key", "bpp", "--rates", "1", "16"],
    "ccsds123": ["--codec", "ccsds123", "--tile", "16"],
    "jpegls": ["--codec", "jpegls"],
    "png": ["--codec", "png"],
    "stream_ccsds121": ["--codec", "ccsds121", "--tile", "16",
                        "--stream-rows", "16"],
}


@pytest.mark.parametrize("codec", sorted(_CODECS))
def test_cli_mesh_equals_mesh1_for_every_codec(tmp_path, codec):
    """``python -m tpukit_torch run-codec ... --mesh 4,2 --device cpu``
    for every codec and a streamed sweep: the CSV (without time and memory
    columns) equals ``--mesh 1``'s and the no-mesh run's, and every
    artifact, kept streams included, is byte-identical."""
    rng = np.random.default_rng(9)
    cube = (rng.integers(0, 2000, (6, 48, 40)).astype(np.int16) << 2)
    idx = _index(tmp_path, cube, case="caseB", nodata=-4)
    runs = {}
    for mesh in (None, "1", "4,2"):
        out = tmp_path / f"mesh_{mesh}"
        argv = ["--indices", str(idx), "--reps", "2", "--keep-bitstream",
                "--outdir", str(out), "--device", "cpu", *_CODECS[codec]]
        assert run_codec_main(argv + (["--mesh", mesh] if mesh else [])) == 0
        runs[mesh] = (_stable(out / "metrics.csv"), _files(out))
    assert runs[None] == runs["1"] == runs["4,2"]
    assert any(k.endswith("recon.tif") for k in runs["4,2"][1])
