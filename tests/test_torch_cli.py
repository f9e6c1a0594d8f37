# -*- coding: utf-8 -*-
"""The port's command line against tpukit's, the port on the CPU.

  * the six ``codec-*`` wrappers on one small GeoTIFF: the JSON last line
    has tpukit's keys and values (times and memory apart), the recon .tif
    and the kept streams are byte-equal (tpukit's 9/7 transform pair and
    subband norms injected for the J2K device mode and its CCSDS-123
    weights through ``CCSDS123Codec._fit_weights``, the seams of ROADMAP
    §3; an ``ebcot`` quality point is emitted whole, unpriced, in both);
  * ``run-codec --compressor-cmd`` over each package's own wrapper in a
    child process: CSVs equal but for the time and memory columns, the
    artifacts byte-equal;
  * ``--profile DIR`` writes a Chrome trace naming the sweep's ops;
  * ``doctor``, ``quicklooks``, ``tile-complexity`` and ``main([])``;
  * ``J2KCodec.sweep_rd`` with tpukit's 9/7 coefficients injected.
"""

import csv
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpukit.cli import main as jmain
from tpukit.cli import wrappers as jw
from tpukit.codecs import ccsds123_codec as j123
from tpukit.codecs import j2k_codec as jj2k
from tpukit.io import tiff, write_manifest
from tpukit_torch.cli import main as tmain
from tpukit_torch.cli import wrappers as tw
from tpukit_torch.codecs.ccsds123_codec import CCSDS123Codec
from tpukit_torch.codecs.j2k_codec import J2KCodec

torch.set_num_threads(2)        # xdist workers share the host

REPO = Path(__file__).resolve().parent.parent


def _volatile(key: str) -> bool:
    """Wall-clock and process-memory fields (and their means and IQRs)."""
    return ((key.startswith("t_") and not key.startswith("t_link_tile_s"))
            or key.startswith("mem_"))


def _read_csv(path):
    with open(path, newline="") as f:
        r = csv.reader(f, delimiter=";")
        header = next(r)
        return header, [dict(zip(header, row)) for row in r]


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def tile(tmp_path):
    """A 4-band 12-in-16 uint16 tile of 32x48 px with structure."""
    rng = np.random.default_rng(11)
    gy, gx = np.mgrid[0:32, 0:48]
    base = 1200 * np.sin(gy / 4.0) * np.cos(gx / 6.0) + 2000
    cube = np.stack([base + rng.normal(0, 30, base.shape) for _ in range(4)])
    cube = (cube.clip(0, 4095).astype(np.uint16) << 4).astype(np.uint16)
    p = tmp_path / "tile.tif"
    tiff.write_geotiff(p, cube)
    return p, cube


# name -> (wrapper arguments, seam)
WRAPPERS = {
    "ccsds121": ([], None),
    "ccsds121_bsq_none": (["--tile", "32", "--preproc", "none",
                           "--interleave", "bsq", "--validate-14bit"], None),
    "jpegls_near": (["--nearlossless_eps", "2"], None),
    "png": (["--zlevel", "3"], None),
    "j2k_lossless": (["--lossless"], None),
    "j2k_q40": (["--quality", "40"], None),
    "j2k_device_q40": (["--quality", "40", "--entropy", "device"],
                       "coefficients"),
    "ccsds122_bpp2": (["--bpp", "2"], None),
    "ccsds123": (["--tile", "32"], "weights"),
}


def _tpukit_transform(monkeypatch):
    """The port's J2K codec computes with tpukit's 9/7 transform pair and
    subband norms (each package's own float32 transform differs in the
    last bit, ROADMAP §3)."""
    import jax.numpy as jnp
    from tpukit.kernels import dwt as jdwt
    from tpukit_torch.codecs import j2k_codec as tj2k

    def dwt(x, levels=5, **kw):
        return torch.from_numpy(np.array(jdwt.dwt2(jnp.asarray(x.numpy()),
                                                   "97", levels)))

    def idwt(c, kind="97", levels=3):
        return torch.from_numpy(np.array(jdwt.idwt2(jnp.asarray(c.numpy()),
                                                    kind, levels)))
    monkeypatch.setattr(tj2k, "dwt97", dwt)
    monkeypatch.setattr(tj2k, "idwt2", idwt)
    monkeypatch.setattr(tj2k, "_subband_norms", jj2k._subband_norms)


def _seam(seam, monkeypatch):
    """Record what tpukit computes where ROADMAP §3 records a tolerated
    difference, and hand it to the port in call order."""
    queue = []
    if seam == "coefficients":
        _tpukit_transform(monkeypatch)
    elif seam == "weights":
        encode_model = j123.encode_model

        def recording(xu):
            mapped, wq = encode_model(xu)
            queue.append(np.asarray(wq))
            return mapped, wq
        monkeypatch.setattr(j123, "encode_model", recording)
        monkeypatch.setattr(CCSDS123Codec, "_fit_weights",
                            lambda self, feats, c: queue.pop(0))
    return queue


@pytest.mark.parametrize("case", sorted(WRAPPERS))
def test_wrapper_equals_tpukit(tmp_path, tile, case, capsys, monkeypatch):
    src, _ = tile
    argv, seam = WRAPPERS[case]
    name = case.split("_")[0]
    queue = _seam(seam, monkeypatch)
    from tpukit_torch.codecs import ccsds121 as model
    plans = []
    encode_plan = model.encode_plan
    monkeypatch.setattr(model, "encode_plan",
                        lambda *a, **kw: plans.append(1) or encode_plan(*a,
                                                                        **kw))
    metas = {}
    for tag, fn, extra in (("jax", getattr(jw, f"{name}_main"), []),
                           ("port", getattr(tw, f"{name}_main"),
                            ["--device", "cpu"])):
        out = tmp_path / tag
        rc = fn(["--in", str(src), "--out", str(out / "recon.tif"),
                 "--keep-bitstream", str(out / "bit"), *argv, *extra])
        assert rc == 0
        metas[tag] = json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1])
    if seam:
        assert queue == []                   # every recorded value was used
    # the port's wrapper hands the codec its upload, as the runner does:
    # CCSDS-121 plans from it (tpukit's wrapper codes serially)
    assert bool(plans) == (name == "ccsds121")
    assert list(metas["port"]) == list(metas["jax"])
    assert {k: v for k, v in metas["port"].items() if not _volatile(k)} == \
        {k: v for k, v in metas["jax"].items() if not _volatile(k)}
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert any(p.parent.name == "bit" for p in got)
    for rel in want:
        assert got[rel] == want[rel], rel


def test_wrapper_refuses_an_absent_card(tmp_path, tile):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    src, _ = tile
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.png_main(["--in", str(src), "--out", str(tmp_path / "r.tif")])


def _write_index(tmp_path: Path, src: Path) -> Path:
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseA", "tile_1024", [{"tile_id": "HC",
                                                "path": src}])
    return idx


def _wrapper_script(tmp_path: Path, pkg: str, command: str) -> str:
    """An executable wrapper: ``python -m <pkg> <command>`` in a child
    process (the port's on the CPU)."""
    extra = ', "--device", "cpu"' if pkg == "tpukit_torch" else ""
    p = tmp_path / f"{pkg}_{command}.py"
    p.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"from {pkg}.cli.main import main\n"
        f"sys.exit(main([{command!r}{extra}, *sys.argv[1:]]))\n")
    return str(p)


@pytest.mark.parametrize("command,label,extra", [
    ("codec-png", "png_lossless", []),
    ("codec-ccsds121", "ccsds121_ext", ["--", "--tile", "32", "--preproc",
                                        "none"]),
])
def test_compressor_cmd_equals_tpukit(tmp_path, tile, command, label, extra):
    """``run-codec --compressor-cmd <wrapper>``: the port's runner over the
    port's wrapper and tpukit's runner over tpukit's, one rep each."""
    src, _ = tile
    idx = _write_index(tmp_path, src)
    common = ["--indices", str(idx), "--codec", label, "--rate-key", "none",
              "--reps", "1", "--keep-bitstream"]
    assert jmain.run_codec_main(
        common + ["--outdir", str(tmp_path / "jax"), "--compressor-cmd",
                  sys.executable, _wrapper_script(tmp_path, "tpukit",
                                                  command), *extra]) == 0
    assert tmain.run_codec_main(
        common + ["--outdir", str(tmp_path / "port"), "--device", "cpu",
                  "--compressor-cmd", sys.executable,
                  _wrapper_script(tmp_path, "tpukit_torch", command),
                  *extra]) == 0
    hj, rows_j = _read_csv(tmp_path / "jax" / "metrics.csv")
    hp, rows_p = _read_csv(tmp_path / "port" / "metrics.csv")
    assert hp == hj and len(rows_p) == len(rows_j) == 1
    for col in hj:
        if not _volatile(col):
            assert rows_p[0][col] == rows_j[0][col], col
    assert rows_p[0]["lossless"] == "1"
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for rel in want:
        if rel.suffix != ".csv":
            assert got[rel] == want[rel], rel


def test_profile_writes_a_chrome_trace(tmp_path, tile):
    src, _ = tile
    idx = _write_index(tmp_path, src)
    trace_dir = tmp_path / "trace"
    rc = tmain.run_codec_main([
        "--indices", str(idx), "--codec", "png", "--rate-key", "none",
        "--outdir", str(tmp_path / "runs"), "--reps", "1", "--no-artifacts",
        "--device", "cpu", "--profile", str(trace_dir)])
    assert rc == 0
    trace = json.loads((trace_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    # the metric pass's reductions ran under the profiler
    assert any(n.startswith("aten::sum") for n in names), sorted(names)[:20]
    assert (tmp_path / "runs" / "metrics.csv").exists()


def test_doctor(capsys):
    """``--device cpu --smoke`` passes with a row for every codec; the
    default ``--device cuda`` fails where there is no card, naming it."""
    assert tmain.doctor_main(["--device", "cpu", "--smoke"]) == 0
    out = capsys.readouterr().out
    assert "all required checks passed" in out
    for name in ("ccsds121", "jpegls", "png", "j2k", "ccsds122",
                 "ccsds123"):
        assert f"[ok ] codec {name}: lossless round-trip on cpu" in out
    assert "[ok ] native library" in out
    if torch.cuda.is_available():
        return
    assert tmain.doctor_main([]) == 1
    cap = capsys.readouterr()
    assert "[FAIL] device: cuda" in cap.out
    assert "CUDA is not available" in cap.out
    assert "required check(s) failed" in cap.err


def test_quicklooks_equals_tpukit(tmp_path, tile):
    src, cube = tile
    rng = np.random.default_rng(2)
    noisy = (cube.astype(np.int32) + rng.integers(-900, 900, cube.shape))
    rec = tmp_path / "recon.tif"
    tiff.write_geotiff(rec, noisy.clip(0, 65535).astype(np.uint16))
    for tag, fn in (("jax", jmain.quicklooks_main),
                    ("port", tmain.quicklooks_main)):
        out = tmp_path / tag
        out.mkdir()
        assert fn(["--baseline", str(src), "--out", str(out / "rgb.tif"),
                   "--error-against", str(rec), "--err-out-base",
                   str(out / "recon"), "--err-max-zoom", "40",
                   "--rgb-order", "3", "2", "1"]) == 0
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(want) >= 3 and sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel


def test_main_lists_tpukits_commands(capsys):
    def listed(fn):
        assert fn([]) == 0
        return capsys.readouterr().out.split()[2:]
    got, want = listed(tmain.main), listed(jmain.main)
    assert got == want and len(got) == 15
    assert tmain.main(["no-such-command"]) == 2


def test_tile_complexity_cli_equals_tpukit(tmp_path, tile, capsys):
    src, cube = tile
    holed = cube.copy()
    holed[:, :4, :6] = 0
    p2 = tmp_path / "holed.tif"
    tiff.write_geotiff(p2, holed, nodata=0)
    outs = {}
    for tag, fn, extra in (("jax", jmain.tile_complexity_main, []),
                           ("port", tmain.tile_complexity_main,
                            ["--device", "cpu"])):
        assert fn([str(src), str(p2), "--json", *extra]) == 0
        outs[tag] = [json.loads(line) for line in
                     capsys.readouterr().out.strip().splitlines()]
        assert fn([str(src), *extra]) == 0        # the text form
        outs[tag + "_text"] = capsys.readouterr().out
    for got, want in zip(outs["port"], outs["jax"]):
        assert list(got) == list(want)
        for k in ("path", "width", "height", "bands"):
            assert got[k] == want[k]
        for k in set(want) - {"path", "width", "height", "bands"}:
            rel = 1e-5 if k.startswith("grad_") else 1e-4
            assert got[k] == pytest.approx(want[k], rel=rel, abs=1e-30), k
    assert outs["port_text"].split(":")[0] == outs["jax_text"].split(":")[0]


def test_sweep_rd_equals_tpukit(monkeypatch):
    """``sweep_rd`` on a 4x64x96 tile at four qualities, the port computing
    with tpukit's 9/7 transform pair and subband norms (the device mode's
    seam, ROADMAP §3; each package's own float32 inverse may differ by 1 DN,
    which moves the PSNR of the q 100 point by far more than 1e-4): bytes
    and recons equal, PSNR/SSIM within rel 1e-4 (float32 sums in another
    order), max|Δ| and the lossless flag exact."""
    from tpukit_torch.codecs import j2k_codec as tj2k
    _tpukit_transform(monkeypatch)
    rng = np.random.default_rng(23)
    gy, gx = np.mgrid[0:64, 0:96]
    base = 1500 * np.sin(gy / 6.0) * np.cos(gx / 10.0) + 2000
    cube = np.stack([base + rng.normal(0, 40, base.shape) for _ in range(4)])
    cube = (cube.clip(0, 4095).astype(np.uint16) << 4).astype(np.uint16)
    valid = np.ones(cube.shape[1:], bool)
    valid[:3, :5] = False
    qualities = [10, 40, 60, 100]
    want = jj2k.J2KCodec(entropy="device").sweep_rd(cube, "uint16",
                                                    qualities, valid=valid)
    got = tj2k.J2KCodec(entropy="device").sweep_rd(cube, "uint16", qualities,
                                                   valid=valid, device="cpu")
    assert len(got) == len(want) == 4
    for (gres, gm), (wres, wm) in zip(got, want):
        assert gres.bitstream_bytes == wres.bitstream_bytes
        assert gres.extras == wres.extras
        np.testing.assert_array_equal(gres.recon.numpy(),
                                      np.asarray(wres.recon))
        assert sorted(gm) == sorted(wm)
        for k in wm:
            if k.startswith(("psnr", "ssim")):
                assert gm[k] == pytest.approx(wm[k], rel=1e-4), k
            else:
                assert gm[k] == wm[k], k
