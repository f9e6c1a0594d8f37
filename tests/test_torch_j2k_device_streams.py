# -*- coding: utf-8 -*-
"""The kept streams of the J2K device mode (``--entropy device
--keep-bitstream``) in tpukit_torch against tpukit's, on the CPU.

The streams are integer functions of the 9/7 coefficients and the step
map. The two packages' float32 transforms round differently (XLA:CPU
contracts the lifting into FMAs), so the byte-exact comparison feeds the
port tpukit's own coefficients and subband norms (``j2k_codec.dwt97`` and
``_subband_norms`` replaced for the test, as tests/test_torch_j2k_device.py
feeds them to the models): then every kept stream equals tpukit's byte for
byte, whole cubes, tiles, lossless and ``--rate-fit`` alike. With the
port's own transform the bytes agree within rel 5e-3 and the recon MSE
within rel 1e-2 (within 1 DN where the MSE is below 1 DN²). Lossless
points use the integer 5/3 and are exact either way.

Within the port: each kept stream is as long as ``wenc_size_bytes`` says
(a mismatch raises), the kept run's bytes and recon equal the model-first
run's, recon == decode(stream), and a checksum mismatch rebuilds the
recon from the host's coefficients with a warning."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukit.codecs.j2k_codec as jj2k
from tpukit.codecs.base import RateSpec as JRate
from tpukit.kernels import dwt as jdwt
from tpukit_torch.codecs import j2k_codec as tj2k
from tpukit_torch.codecs import wavelet_common as twc
from tpukit_torch.codecs.base import RateSpec as TRate

torch.set_num_threads(2)        # xdist workers share the host

BYTES_REL = 5e-3
MSE_REL = 1e-2
CASES = {
    "ladder": ({}, [("quality", 10), ("quality", 40), ("quality", 100),
                    ("bpp", 2)]),
    "lossless": ({}, [(None, None)]),
    "rate_fit": ({"rate_fit": True}, [("bpp", 1.0), ("cr", 6)]),
    "tiled": ({"tilex": 64, "tiley": 32}, [("quality", 30), (None, None)]),
}


@pytest.fixture(scope="module")
def cube():
    """A 3-band uint16 12-in-16 cube off the 32 grid (72x100 pads to
    96x128); 64x32 tiles take four shapes."""
    rng = np.random.default_rng(3)
    gy, gx = np.mgrid[0:72, 0:100]
    base = 1500 * np.sin(gy / 7.0) * np.cos(gx / 11.0) + 2000
    c = np.stack([base + rng.normal(0, 40, base.shape) for _ in range(3)])
    return (c.clip(0, 4095).astype(np.uint16) << 4).astype(np.uint16)


@pytest.fixture
def tpukit_coefficients(monkeypatch):
    """The port computes with tpukit's 9/7 coefficients and subband norms."""
    def dwt(x, levels=5, **kw):
        return torch.from_numpy(np.array(jdwt.dwt2(jnp.asarray(x.numpy()),
                                                   "97", levels)))
    monkeypatch.setattr(tj2k, "dwt97", dwt)
    monkeypatch.setattr(tj2k, "_subband_norms", jj2k._subband_norms)


def _both(cube, case, keep=True):
    opts, specs = CASES[case]
    want = jj2k.J2KCodec(entropy="device", **opts).sweep_rates(
        cube, "uint16", [JRate.of(*s) for s in specs], keep_bitstream=keep)
    got = tj2k.J2KCodec(entropy="device", **opts).sweep_rates(
        cube, "uint16", [TRate.of(*s) for s in specs], keep_bitstream=keep)
    return specs, want, got


def _mse(cube, recon) -> float:
    d = np.asarray(recon).astype(np.float64) - cube.astype(np.float64)
    return float(np.mean(d * d))


@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_streams_equal_tpukit_with_its_coefficients(
        cube, tpukit_coefficients, case):
    specs, want, got = _both(cube, case)
    for spec, w, g in zip(specs, want, got):
        assert g.bitstreams == w.bitstreams, spec
        assert g.bitstream_bytes == w.bitstream_bytes
        assert sum(map(len, g.bitstreams.values())) == g.bitstream_bytes
        assert g.extras.keys() == w.extras.keys()
        assert g.extras["quality_used"] == w.extras["quality_used"]
        if spec[0] is None:
            np.testing.assert_array_equal(g.recon.numpy(), cube)
        else:       # each package's own float32 inverse 9/7
            diff = g.recon.numpy().astype(np.int64) \
                - np.asarray(w.recon).astype(np.int64)
            assert np.abs(diff).max() <= 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_streams_with_the_ports_own_transform(cube, case):
    specs, want, got = _both(cube, case)
    _, _, model = _both(cube, case, keep=False)
    for spec, w, g, m in zip(specs, want, got, model):
        assert sorted(g.bitstreams) == sorted(w.bitstreams)
        assert sum(map(len, g.bitstreams.values())) == g.bitstream_bytes
        # the kept run is the model-first run plus the streams
        assert g.bitstream_bytes == m.bitstream_bytes
        assert torch.equal(torch.as_tensor(g.recon), torch.as_tensor(m.recon))
        if spec[0] is None:
            assert g.bitstreams == w.bitstreams
            np.testing.assert_array_equal(g.recon.numpy(), cube)
            continue
        assert abs(g.bitstream_bytes - w.bitstream_bytes) \
            <= BYTES_REL * w.bitstream_bytes
        mg, mw = _mse(cube, g.recon.numpy()), _mse(cube, w.recon)
        if mw >= 1.0:
            assert abs(mg - mw) <= MSE_REL * mw, (spec, mg, mw)
        else:
            diff = g.recon.numpy().astype(np.int64) \
                - np.asarray(w.recon).astype(np.int64)
            assert np.abs(diff).max() <= 1


@pytest.mark.parametrize("quality", [10, 40, 100])
def test_stream_length_is_wenc_size_bytes_and_decodes_to_the_recon(cube,
                                                                   quality):
    codec = tj2k.J2KCodec(entropy="device")
    (res,) = codec.sweep_qualities(cube, "uint16", [quality], True)
    B, H, W = cube.shape
    c = codec._shape_consts(96, 128, torch.device("cpu"))
    peak = float(cube.max())
    base = np.float32(tj2k.base_step_for_quality(quality, peak))
    coefs = tj2k.dwt97(tj2k.device_work(cube, {}, 32, torch.float32), 5)
    qc = tj2k.quantize(tj2k._perm(coefs, c.order),
                       c.inv_scale_perm * float(np.float32(1.0) / base))
    sizes = tj2k.wenc_size_bytes(qc, c.segbounds, c.rle)
    planes = np.empty((B, 96 * 128), np.int32)
    for b, (name, s) in enumerate(sorted(res.bitstreams.items())):
        assert name == f"b{b + 1:02d}.j2c"
        assert len(s) == int(sizes[b])
        dec = twc.wenc_decode(s, 96 * 128, c.segbounds)
        np.testing.assert_array_equal(dec, qc[b].numpy())
        planes[b, c.order_host] = dec
    back = tj2k._device_recon(torch.from_numpy(planes.reshape(B, 96, 128)),
                              c.scale, base, 5, H, W, 0, 65535, torch.uint16)
    assert torch.equal(back, res.recon)


def test_a_stream_that_disagrees_with_the_model_raises(cube, monkeypatch):
    """A byte more than the model priced (the decoders do not read it, so
    the round trip alone would pass)."""
    encode = twc.wenc_quant_encode_ck

    def longer(*a, **kw):
        s, qc, s1, s2 = encode(*a, **kw)
        return s + b"\0", qc, s1, s2
    monkeypatch.setattr(twc, "wenc_quant_encode_ck", longer)
    codec = tj2k.J2KCodec(entropy="device")
    with pytest.raises(RuntimeError, match="differ from the device size"):
        codec.sweep_qualities(cube, "uint16", [40], keep_bitstream=True)
    wenc = twc.wenc_encode
    monkeypatch.setattr(twc, "wenc_encode",
                        lambda *a, **kw: wenc(*a, **kw) + b"\0")
    for spec in (TRate.of("quality", 40), TRate.none()):
        with pytest.raises(RuntimeError, match="differ from the device size"):
            tj2k.J2KCodec(entropy="device").run(cube, "uint16", spec,
                                                keep_bitstream=True)


def test_checksum_mismatch_rebuilds_the_recon_from_host_coefficients(
        cube, monkeypatch):
    codec = tj2k.J2KCodec(entropy="device")
    (want,) = codec.sweep_qualities(cube, "uint16", [40], True)
    ladder = tj2k.requant_recon_ladder

    def wrong_sums(*a, **kw):
        recons, s1, s2 = ladder(*a, **kw)
        return torch.zeros_like(recons), s1 + 1, s2
    monkeypatch.setattr(tj2k, "requant_recon_ladder", wrong_sums)
    with pytest.warns(UserWarning, match="uploading host coefficients"):
        (got,) = codec.sweep_qualities(cube, "uint16", [40], True)
    assert got.bitstreams == want.bitstreams
    assert torch.equal(got.recon, want.recon)


def test_reps_reuse_the_cached_transform_and_fetch(cube, monkeypatch):
    calls = {"n": 0}
    dwt = tj2k.dwt97

    def counting(*a, **kw):
        calls["n"] += 1
        return dwt(*a, **kw)
    monkeypatch.setattr(tj2k, "dwt97", counting)
    codec = tj2k.J2KCodec(entropy="device")
    cache = {}
    first = codec.sweep_qualities(cube, "uint16", [10, 40], False, cache)
    kept = codec.sweep_qualities(cube, "uint16", [10, 40], True, cache)
    again = codec.sweep_qualities(cube, "uint16", [10, 40], True, cache)
    assert calls["n"] == 1
    (entry,) = [v for k, v in cache.items() if k[0] == "j2k_dwt"]
    assert isinstance(entry[1], np.ndarray)         # the fetched scan order
    for a, b, c in zip(first, kept, again):
        assert a.bitstream_bytes == b.bitstream_bytes == c.bitstream_bytes
        assert b.bitstreams == c.bitstreams and a.bitstreams is None
        assert torch.equal(a.recon, b.recon)


def test_signatures_and_positional_calls_equal_tpukit(cube):
    """tpukit's parameter lists, so one call fits both packages."""
    for name in ("sweep_qualities", "_sweep_tiled_device"):
        want = list(inspect.signature(getattr(jj2k.J2KCodec, name))
                    .parameters)
        got = list(inspect.signature(getattr(tj2k.J2KCodec, name))
                   .parameters)
        assert got[:len(want)] == want, name
    assert list(inspect.signature(tj2k.J2KCodec.sweep_qualities)
                .parameters) == ["self", "cube", "dtype_name", "qualities",
                                 "keep_bitstream", "cache", "device_cube",
                                 "mesh"]
    args = (cube, "uint16", [40], False, None, None, None)
    (w,) = jj2k.J2KCodec(entropy="device").sweep_qualities(*args)
    (g,) = tj2k.J2KCodec(entropy="device").sweep_qualities(*args)
    assert abs(g.bitstream_bytes - w.bitstream_bytes) \
        <= BYTES_REL * w.bitstream_bytes
    specs_j, specs_t = [JRate.of("quality", 40)], [TRate.of("quality", 40)]
    (w,) = [r for r in jj2k.J2KCodec(64, 32, entropy="device")
            ._sweep_tiled_device(cube, "uint16", specs_j, [0], 64, 32)]
    (g,) = [r for r in tj2k.J2KCodec(64, 32, entropy="device")
            ._sweep_tiled_device(cube, "uint16", specs_t, [0], 64, 32)]
    assert abs(g.bitstream_bytes - w.bitstream_bytes) \
        <= BYTES_REL * w.bitstream_bytes
    assert g.extras == w.extras
