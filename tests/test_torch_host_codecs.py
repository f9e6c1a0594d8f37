# -*- coding: utf-8 -*-
"""tpukit_torch's JPEG-LS and PNG codecs against tpukit's.

Both are host codecs (in-process C++ and zlib) with no device code in
either package, and the port's are copies: the same seeded cubes must give
equal bytes, equal kept streams, equal recons and equal ``extras`` (the
stage timers apart). Nothing is approximate, so every comparison is
exact."""

import importlib.util

import numpy as np
import pytest

from tpukit.codecs import jpegls_codec as jjls
from tpukit.codecs import png_codec as jpng
from tpukit.codecs.base import RateSpec as JRate
from tpukit_torch.codecs import base as tbase
from tpukit_torch.codecs import jpegls_codec as tjls
from tpukit_torch.codecs import png_codec as tpng
from tpukit_torch.codecs.base import RateSpec
from tpukit_torch.codecs.registry import create

HAVE_PILLOW = (importlib.util.find_spec("PIL") is not None
               or importlib.util.find_spec("imageio") is not None)


def _smooth_cube(rng, dtype) -> np.ndarray:
    """A smooth 5-band 40×48 cube with noise: JPEG-LS's NEAR ladder moves
    its size, and PNG's filters have something to choose between."""
    y, x = np.mgrid[:40, :48]
    base = 3000 + 2000 * np.sin(x / 7.0) * np.cos(y / 5.0)
    cube = base[None] * np.linspace(0.6, 1.4, 5)[:, None, None] \
        + rng.normal(0, 30, (5, 40, 48))
    if dtype == "int16":
        return (cube - 3000).astype(np.int16)
    if dtype == "uint8":
        return (cube / 32).clip(0, 255).astype(np.uint8)
    return cube.astype(np.uint16)


def _timeless(extras: dict) -> dict:
    return {k: v for k, v in extras.items() if not k.startswith("t_")}


def _same_result(got, want, cube):
    assert got.bitstreams == want.bitstreams and got.bitstreams
    assert got.bitstream_bytes == want.bitstream_bytes \
        == sum(len(b) for b in got.bitstreams.values())
    assert (got.codec, got.encoder) == (want.codec, want.encoder)
    assert _timeless(got.extras) == _timeless(want.extras)
    assert set(got.extras) == set(want.extras)
    assert isinstance(got.recon, np.ndarray) and got.recon.dtype == cube.dtype
    np.testing.assert_array_equal(got.recon, want.recon)


@pytest.mark.parametrize("dtype", ["int16", "uint16", "uint8"])
@pytest.mark.parametrize("preproc", ["none", "diff1"])
def test_jpegls_lossless_equals_tpukit(rng, dtype, preproc):
    cube = _smooth_cube(rng, dtype)
    want = jjls.JPEGLSCodec(preproc=preproc).run(cube, dtype, JRate.none(),
                                                 keep_bitstream=True)
    got = create("jpegls_subproc", preproc=preproc).run(
        cube, dtype, RateSpec.none(), keep_bitstream=True)
    _same_result(got, want, cube)
    np.testing.assert_array_equal(got.recon, cube)
    assert got.extras["preproc"] == preproc
    assert sorted(got.bitstreams) == [f"band_{i:02d}.jls" for i in range(1, 6)]


@pytest.mark.parametrize("key,value", [
    ("nearlossless_eps", 1), ("nearlossless_eps", 4), ("nearlossless_eps", 300),
    ("cr", 4), ("cr", 12), ("bpp", 3.0), ("bpp", 0.8), ("bpp", 15.9),
    ("quality", 50)])
def test_jpegls_rates_equal_tpukit(rng, key, value):
    """NEAR given, and NEAR found by the probe ladder and bisection for a
    cr or bpp target: the same NEAR, streams and recons, and the error
    bound NEAR holds."""
    cube = _smooth_cube(rng, "int16")
    want = jjls.JPEGLSCodec().run(cube, "int16", JRate.of(key, value),
                                  keep_bitstream=True)
    got = tjls.JPEGLSCodec().run(cube, "int16", RateSpec.of(key, value),
                                 keep_bitstream=True)
    _same_result(got, want, cube)
    near = got.extras["nearlossless_eps"]
    assert near == tjls.derive_near(RateSpec.of(key, value), cube[0], "int16") \
        == jjls.derive_near(JRate.of(key, value), cube[0], "int16")
    err = np.abs(got.recon.astype(np.int32) - cube.astype(np.int32)).max()
    assert err <= near
    if key == "nearlossless_eps":
        assert near == min(value, 255)
    if key == "quality":
        assert near == 0


def test_jpegls_near_disables_diff1(rng, capsys):
    cube = _smooth_cube(rng, "int16")
    want = jjls.JPEGLSCodec(preproc="diff1").run(
        cube, "int16", JRate.of("nearlossless_eps", 4), keep_bitstream=True)
    got = tjls.JPEGLSCodec(preproc="diff1").run(
        cube, "int16", RateSpec.of("nearlossless_eps", 4), keep_bitstream=True)
    _same_result(got, want, cube)
    assert got.extras["preproc"] == "none"
    assert capsys.readouterr().err.count("Disabling spectral diff1") == 2


def test_jpegls_plane_coder_and_domain_maps(rng):
    """jls_encode/jls_decode and the int16 <-> codec-domain maps."""
    img = rng.integers(0, 65536, (17, 23)).astype(np.uint16)
    for near in (0, 3):
        bs = tjls.jls_encode(img, near)
        assert bs == jjls.jls_encode(img, near)
        np.testing.assert_array_equal(tjls.jls_decode(bs, 23, 17),
                                      jjls.jls_decode(bs, 23, 17))
    band = np.array([[-32768, -1, 0, 1, 32767]], np.int16)
    dom = tbase.int16_to_codec_domain(band)
    assert dom.dtype == np.uint16 and dom.tolist() == [[0, 32767, 32768,
                                                        32769, 65535]]
    from tpukit.codecs import base as jbase
    np.testing.assert_array_equal(dom, jbase.int16_to_codec_domain(band))
    np.testing.assert_array_equal(tbase.codec_domain_to_int16(dom), band)
    with pytest.raises(RuntimeError):
        tjls.jls_decode(b"\xff\xd8 not a stream", 23, 17)


@pytest.mark.parametrize("dtype", ["int16", "uint16", "uint8"])
@pytest.mark.parametrize("zlevel", [1, 6, 9])
def test_png_default_writer_equals_tpukit(rng, dtype, zlevel):
    cube = _smooth_cube(rng, dtype)
    want = jpng.PNGCodec(zlevel=zlevel).run(cube, dtype, JRate.none(),
                                            keep_bitstream=True)
    got = create("png_lossless", zlevel=zlevel).run(
        cube, dtype, RateSpec.of("quality", 50), keep_bitstream=True)  # ignored
    _same_result(got, want, cube)
    np.testing.assert_array_equal(got.recon, cube)
    assert sorted(got.bitstreams) == [f"b{i:02d}.png" for i in range(1, 6)]
    assert all(b[:8] == b"\x89PNG\r\n\x1a\n" for b in got.bitstreams.values())
    # the pure-Python decoder reads what the writer wrote
    np.testing.assert_array_equal(
        tpng._png_decode_py(got.bitstreams["b01.png"]),
        cube[0].view(np.uint16) if dtype == "int16" else cube[0])


@pytest.mark.skipif(not HAVE_PILLOW,
                    reason="the compat writer needs imageio or Pillow")
@pytest.mark.parametrize("dtype", ["int16", "uint16"])
def test_png_compat_writer_equals_tpukit(rng, dtype):
    cube = _smooth_cube(rng, dtype)
    want = jpng.PNGCodec(writer="compat").run(cube, dtype, JRate.none(),
                                              keep_bitstream=True)
    got = tpng.PNGCodec(writer="compat").run(cube, dtype, RateSpec.none(),
                                             keep_bitstream=True)
    _same_result(got, want, cube)
    np.testing.assert_array_equal(got.recon, cube)
    assert got.extras["writer"] == "compat"


def test_png_bad_writer_rejected():
    with pytest.raises(ValueError, match="png writer"):
        tpng.PNGCodec(writer="libpng")


def test_codec_flags_equal_tpukit():
    for t, j in ((tjls.JPEGLSCodec, jjls.JPEGLSCodec),
                 (tpng.PNGCodec, jpng.PNGCodec)):
        for attr in ("name", "encoder_desc", "supports_lossy",
                     "mask_passthrough", "strip_exact"):
            assert getattr(t, attr, None) == getattr(j, attr, None), attr
        assert t.__module__.startswith("tpukit_torch.")


def test_registry_names_and_refusals():
    """tpukit's six codecs and its reference labels resolve, none is
    refused any more; an unknown name lists what is known."""
    from tpukit.codecs import registry as jreg
    from tpukit_torch.codecs import registry as treg
    assert treg.names() == ["ccsds121", "ccsds122", "ccsds123", "j2k",
                            "jpegls", "png"]
    assert treg.names() == jreg.names()
    assert treg._ALIASES == jreg._ALIASES
    for label in list(treg._ALIASES) + treg.names():
        assert type(create(label)).__name__ == type(jreg.create(label)).__name__
    for entropy in ("bpe", "embedded"):
        assert create("ccsds122", entropy=entropy).entropy == entropy
    with pytest.raises(ValueError, match="bpe|embedded"):
        create("ccsds122", entropy="ebcot")
    with pytest.raises(KeyError, match="ccsds122.*ccsds123.*jpegls.*png"):
        create("webp")
