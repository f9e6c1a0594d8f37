# -*- coding: utf-8 -*-
"""The wrapper seams of the port against tpukit's: ``codecs/extern.py``
(the ``--enc-cmd/--dec-cmd`` template seam, reference ccsds121_wrap.py:
117-118, ccsds122_wrap.py:59-62, ccsds123_wrap.py:106-112) and
``codecs/shell.py`` (the L2 wrapper contract), driven by the same fake
"binaries" as tpukit's tests (``cp`` store codecs, a copying Python
one-liner, ``false``) and by each package's own wrapper CLI.

Every case runs both packages on the same seeded cube and holds the port's
result to tpukit's: recon, byte counts, kept streams and extras equal, then
the checks of tests/test_extern.py and tests/test_shell_codec.py."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from tpukit.codecs import extern as j_ext
from tpukit.codecs.base import RateSpec as JRate
from tpukit.codecs.shell import ShellCodec as JShell
from tpukit_torch.codecs import extern as t_ext
from tpukit_torch.codecs.base import RateSpec
from tpukit_torch.codecs.shell import ShellCodec
from tpukit_torch.convert import from_tpukit_codec

REPO = Path(__file__).resolve().parent.parent
CP_ENC = "cp {in} {out}"
CP_DEC = "cp {in} {out}"
PY_COPY = (sys.executable +
           " -c \"import shutil,sys;shutil.copy(sys.argv[1],sys.argv[2])\""
           " {in} {out}")


@pytest.fixture
def cube(rng):
    x = rng.integers(0, 4096, size=(3, 40, 56), dtype=np.uint16)
    return (x << 4).astype(np.uint16)


def _both(enc, dec, cube, rate, dtype="uint16", **kw):
    """Both packages' ExternalCodec on the same cube; the port's result
    equals tpukit's in every field but the times and memory peaks."""
    run_kw = kw.pop("run_kw", {})
    want = j_ext.ExternalCodec(enc, dec, **kw).run(
        cube, dtype, JRate.of(*rate) if rate else JRate.none(),
        keep_bitstream=True, **run_kw)
    got = t_ext.ExternalCodec(enc, dec, **kw).run(
        cube, dtype, RateSpec.of(*rate) if rate else RateSpec.none(),
        keep_bitstream=True, **run_kw)
    np.testing.assert_array_equal(np.asarray(got.recon),
                                  np.asarray(want.recon))
    assert (got.codec, got.encoder, got.bitstream_bytes, got.extras) == \
        (want.codec, want.encoder, want.bitstream_bytes, want.extras)
    assert got.bitstreams == want.bitstreams
    return got


def test_template_helpers_equal_tpukit():
    for tpl in ("aec -n {nbit} {in} {out}", ["a", "{in}"]):
        assert t_ext.template_to_list(tpl) == j_ext.template_to_list(tpl)
    assert t_ext.template_to_list("aec -n {nbit} {in} {out}") == \
        ["aec", "-n", "{nbit}", "{in}", "{out}"]
    with pytest.raises(TypeError):
        t_ext.template_to_list(7)
    toks = ["bpe", "-e", "{in}", "-o", "{out}", "-r", "{bpp}", "-w", "{w}"]
    assert t_ext.drop_rate_flag(toks) == j_ext.drop_rate_flag(toks) == \
        ["bpe", "-e", "{in}", "-o", "{out}", "-w", "{w}"]


@pytest.mark.parametrize("interleave", ["bip", "bil", "bsq"])
def test_tile_store_roundtrip(cube, interleave):
    res = _both(CP_ENC, CP_DEC, cube, None, structure="tile", tile=32,
                interleave=interleave, preproc="none", name="ext")
    np.testing.assert_array_equal(res.recon, cube)
    assert res.bitstream_bytes == cube.nbytes  # store codec: raw size
    assert res.t_comp_s > 0 and res.t_dec_s > 0
    # 40x56 at tile 32 -> 2x2 grid of tiles, one stream each
    assert len(res.bitstreams) == 4
    assert res.codec == "ext"


def test_tile_store_diff1_inverts(cube):
    """The store codec sees the diff1-preprocessed stream (the port's
    ``diff1_forward_np``); the recon is the input again."""
    res = _both(CP_ENC, CP_DEC, cube, None, structure="tile", tile=64,
                interleave="bsq", preproc="diff1")
    np.testing.assert_array_equal(res.recon, cube)


def test_tile_crop_nodata_skips(cube):
    cube = cube.copy()
    cube[:, :, :32] = 0                    # left 32-wide column of tiles
    res = _both(CP_ENC, CP_DEC, cube, None, structure="tile", tile=32,
                interleave="bsq", crop_nodata=True, run_kw={"nodata": 0})
    np.testing.assert_array_equal(res.recon, cube)
    assert res.extras["skipped_nodata_tiles"] == 2   # 2 tile rows x 1 col
    assert res.bitstream_bytes == cube[:, :, 32:].nbytes


def test_tile_crop_nodata_dataset_mask(cube):
    mask = np.ones(cube.shape[1:], np.uint8) * 255
    mask[:, :32] = 0
    res = _both(CP_ENC, CP_DEC, cube, None, structure="tile", tile=32,
                interleave="bsq", crop_nodata=True,
                run_kw={"dataset_mask": mask})
    assert res.extras["skipped_nodata_tiles"] == 2
    np.testing.assert_array_equal(res.recon, cube)


def test_band_store_roundtrip_and_bpp(cube):
    """Band mode: cr=4 on 16-bit is 4 bpp a band (the port's
    ``per_band_bpp``); no rate key is effective lossless."""
    res = _both(PY_COPY, PY_COPY, cube, ("cr", 4.0), structure="band",
                name="ext122")
    assert res.extras["bpp_req_band"] == pytest.approx(4.0)
    assert not res.extras["lossless_requested"]
    np.testing.assert_array_equal(res.recon, cube)
    res2 = _both("cp {in} {out}", CP_DEC, cube, None, structure="band")
    assert res2.extras["lossless_requested"]


def test_band_rate_drop_removes_tokens(cube):
    """A template carrying '-r {bpp}' loses the pair on effective lossless:
    `cp` would otherwise die on the unknown flag."""
    res = _both("cp -r {bpp} {in} {out}", CP_DEC, cube, None,
                structure="band")
    np.testing.assert_array_equal(res.recon, cube)


@pytest.mark.parametrize("case", ["failing", "rate", "signed"])
def test_refusals_equal_tpukit(cube, case):
    """A failing binary, a rate on a tile-structured codec and a signed
    cube in band mode raise in both packages with tpukit's messages."""
    args, kw, rate, dtype, data, match, err = {
        "failing": (("false", "false"), {"structure": "tile", "tile": 64},
                    None, "uint16", cube, "External codec failed",
                    RuntimeError),
        "rate": ((CP_ENC, CP_DEC), {"structure": "tile", "tile": 32},
                 ("bpp", 2.0), "uint16", cube, "lossless-only", ValueError),
        "signed": ((CP_ENC, CP_DEC), {"structure": "band"}, None, "int16",
                   cube.view(np.int16), "uint16/uint8", ValueError),
    }[case]
    for ext, spec in ((j_ext, JRate), (t_ext, RateSpec)):
        c = ext.ExternalCodec(*args, **kw)
        assert c.supports_lossy == (kw["structure"] == "band")
        with pytest.raises(err, match=match):
            c.run(data, dtype, spec.of(*rate) if rate else spec.none())


def test_external_codec_carries_across(cube):
    """``convert.from_tpukit_codec`` rebuilds tpukit's ExternalCodec with
    its templates and structure options, and it codes as tpukit's."""
    jc = j_ext.ExternalCodec(CP_ENC, CP_DEC, structure="tile", tile=32,
                             interleave="bil", preproc="diff1", nbit=14,
                             crop_nodata=True, bit_ext="aec", name="c121",
                             use_uss=True)
    tc = from_tpukit_codec(jc)
    assert isinstance(tc, t_ext.ExternalCodec)
    for k in ("enc_tpl", "dec_tpl", "structure", "tile", "interleave",
              "preproc", "nbit", "crop_nodata", "bit_ext", "name",
              "use_uss", "supports_lossy", "encoder_desc"):
        assert getattr(tc, k) == getattr(jc, k), k
    want = jc.run(cube, "uint16", JRate.none(), keep_bitstream=True)
    got = tc.run(cube, "uint16", RateSpec.none(), keep_bitstream=True)
    assert got.bitstreams == want.bitstreams
    np.testing.assert_array_equal(got.recon, np.asarray(want.recon))


def _wrapper_cli(pkg, tmp_path, cube, argv, capsys):
    mod = __import__(f"{pkg}.cli.wrappers", fromlist=["ccsds121_main"])
    tiff = __import__(f"{pkg}.io.tiff", fromlist=["write_geotiff"])
    out = tmp_path / pkg
    out.mkdir()
    src = out / "in.tif"
    tiff.write_geotiff(src, cube)
    extra = ["--device", "cpu"] if pkg == "tpukit_torch" else []
    rc = mod.ccsds121_main(["--in", str(src), "--out", str(out / "r.tif"),
                            *argv, *extra])
    cap = capsys.readouterr()
    return rc, cap, out


def test_wrapper_cli_enc_cmd(tmp_path, cube, capsys):
    """codec-ccsds121 --enc-cmd/--dec-cmd routes through ExternalCodec and
    keeps the JSON-last-line protocol; both packages write the same recon."""
    argv = ["--preproc", "diff1", "--tile", "32", "--enc-cmd", CP_ENC,
            "--dec-cmd", CP_DEC]
    metas = []
    for pkg in ("tpukit", "tpukit_torch"):
        rc, cap, out = _wrapper_cli(pkg, tmp_path, cube, argv, capsys)
        assert rc == 0
        metas.append(json.loads(cap.out.strip().splitlines()[-1]))
    jm, tm = metas
    assert tm["codec"] == jm["codec"] == "ccsds121_ext"
    assert tm["bitstream_bytes"] == jm["bitstream_bytes"] == cube.nbytes
    assert (tmp_path / "tpukit_torch" / "r.tif").read_bytes() == \
        (tmp_path / "tpukit" / "r.tif").read_bytes()


def test_wrapper_cli_requires_both(tmp_path, cube):
    from tpukit_torch.cli.wrappers import ccsds121_main
    from tpukit_torch.io import tiff
    src = tmp_path / "in.tif"
    tiff.write_geotiff(src, cube)
    with pytest.raises(SystemExit, match="must be given together"):
        ccsds121_main(["--in", str(src), "--out", str(tmp_path / "o.tif"),
                       "--enc-cmd", CP_ENC, "--device", "cpu"])


def test_wrapper_validate_14bit_warns(tmp_path, capsys):
    cube = np.full((2, 16, 16), 40000, np.uint16)   # > 16383
    argv = ["--preproc", "none", "--tile", "16", "--validate-14bit"]
    for pkg in ("tpukit", "tpukit_torch"):
        _, cap, _ = _wrapper_cli(pkg, tmp_path, cube, argv, capsys)
        assert "exceed unsigned 14-bit range" in cap.err


def _wrapper_script(tmp_path: Path, pkg: str, command: str) -> list:
    """A Python script that runs ``python -m <pkg> <command>`` in-process
    (the port on the CPU), as an external wrapper executable would."""
    extra = ', "--device", "cpu"' if pkg == "tpukit_torch" else ""
    p = tmp_path / f"{pkg}_{command}.py"
    p.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"from {pkg}.cli.main import main\n"
        f"sys.exit(main([{command!r}{extra}, *sys.argv[1:]]))\n")
    return [sys.executable, str(p)]


@pytest.mark.parametrize("case", ["ccsds121", "jpegls_near"])
def test_shell_codec_runs_wrapper_cli(tmp_path, rng, case):
    """The port's ShellCodec drives the port's wrapper CLI in a child
    process; the result equals tpukit's codec run in this process with the
    wrapper's options (tpukit's own wrapper child is held against the
    port's in tests/test_torch_cli.py)."""
    from tpukit.codecs.registry import create as jcreate
    cube = rng.integers(0, 4096, (3, 32, 32)).astype(np.uint16)
    command, extra, opts, rate = {
        "ccsds121": ("codec-ccsds121", ["--tile", "32", "--preproc", "none"],
                     dict(tile=32, interleave="bip", preproc="none",
                          nbit=16), None),
        "jpegls_near": ("codec-jpegls", [], dict(preproc="none"),
                        ("nearlossless_eps", 2)),
    }[case]
    want = jcreate(command[len("codec-"):], **opts).run(
        cube, "uint16", JRate.of(*rate) if rate else JRate.none(),
        keep_bitstream=True)
    tc = ShellCodec(_wrapper_script(tmp_path, "tpukit_torch", command),
                    extra)
    got = tc.run(cube, "uint16", RateSpec.of(*rate) if rate
                 else RateSpec.none(), keep_bitstream=True)
    np.testing.assert_array_equal(got.recon, np.asarray(want.recon))
    assert (got.codec, got.encoder, got.bitstream_bytes, got.bitstreams) == \
        (want.codec, want.encoder, want.bitstream_bytes, want.bitstreams)
    assert {k: v for k, v in got.extras.items() if not k.startswith("t_")} \
        == {k: v for k, v in json.loads(json.dumps(want.extras)).items()
            if not k.startswith("t_")}
    assert got.t_comp_s > 0
    if rate is None:
        np.testing.assert_array_equal(got.recon, cube)
        assert got.codec == "ccsds121_ext"
        assert any(k.endswith(".aec") for k in got.bitstreams)
    else:
        err = np.abs(got.recon.astype(int) - cube.astype(int)).max()
        assert err <= 2
        assert got.extras.get("nearlossless_eps") == 2


def test_shell_codec_carries_across():
    jc = JShell(["wrap", "-x"], ["--tile", "32"], label="mine")
    tc = from_tpukit_codec(jc)
    assert isinstance(tc, ShellCodec)
    assert (tc.command, tc.extra_args, tc.encoder_desc, tc.name) == \
        (jc.command, jc.extra_args, jc.encoder_desc, jc.name)
