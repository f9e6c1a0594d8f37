# -*- coding: utf-8 -*-
"""tpukit_torch's CCSDS-123 codec against tpukit's, on the CPU.

The same numpy cubes, made from a seed, go through tpukit's codec (JAX on
the CPU, K1 through ``_fs_table_jnp``) and through the port's (plain torch
paths on CPU tensors).

  * ``ls`` with tpukit's fitted weights handed to the port
    (``CCSDS123Codec._fit_weights`` is the seam): mapped residuals, decoded
    cubes, streams and recons are integers and bytes, compared exactly, and
    each package decodes the other's stream.
  * ``ls`` with the port's own fit (exact float64 sums, solved on the host)
    against tpukit's float32 fit: both lossless; the 4.12 weights within
    ``MAX_WEIGHT_LSB`` of each other (the largest seen on these inputs is
    21, on bands whose three predecessors are nearly collinear); stream
    sizes within rel 2e-2, the allowance tpukit gives its own streams
    across platforms.
  * ``standard``: a host codec, streams byte-equal for every order, mode
    and entropy option."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpukit.codecs import ccsds123_codec as j123
from tpukit.codecs import ccsds123_std as jstd
from tpukit.codecs.base import RateSpec as JRate
from tpukit_torch.codecs import ccsds123_codec as t123
from tpukit_torch.codecs import ccsds123_std as tstd
from tpukit_torch.codecs.base import RateSpec, device_work
from tpukit_torch.codecs.registry import create
from tpukit_torch.kernels.fs_table import fs_table

torch.set_num_threads(2)        # xdist workers share the host

MAX_WEIGHT_LSB = 32             # 4.12 LSBs between the two fits
BYTES_RTOL = 2e-2


def _spectral(rng, bands=16, size=32) -> np.ndarray:
    """Spectrally correlated int16 cube, 14-in-16 (tests/test_ccsds123.py)."""
    base = rng.integers(500, 3000, (size, size)).astype(np.float64)
    gains = 1.0 + 0.3 * np.sin(np.linspace(0, 6, bands))
    cube = (base[None] * gains[:, None, None]
            + rng.normal(0, 8, (bands, size, size))).astype(np.int16)
    return ((cube.view(np.uint16) >> 2) << 2).view(np.int16)


def _smooth(rng) -> np.ndarray:
    """The smooth 24-band cube of tpukit's spectral-predictor test."""
    base = rng.normal(0, 1, (64, 64))
    k = np.ones(9) / 9.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    gains = 0.6 + 0.8 * np.abs(np.sin(np.linspace(0.3, 5.8, 24)))[:, None, None]
    cube = np.clip((500 + 6000 * base)[None] * gains
                   + rng.normal(0, 12, (24, 64, 64)), -8192, 8191) \
        .astype(np.int16)
    return ((cube.view(np.uint16) >> 2) << 2).view(np.int16)


def _cube(rng, kind: str) -> np.ndarray:
    if kind == "int16_shift2":
        return _spectral(rng)
    if kind == "uint16_random":
        return rng.integers(0, 65536, (6, 16, 16)).astype(np.uint16)
    if kind == "uint16_odd":                 # 5*7*9 samples: no whole blocks
        return rng.integers(0, 4096, (5, 7, 9)).astype(np.uint16)
    if kind == "int16_negative":
        return rng.integers(-32768, 32768, (6, 16, 16)).astype(np.int16)
    if kind == "uint8":
        return rng.integers(0, 256, (6, 16, 16)).astype(np.uint8)
    raise KeyError(kind)


def _ring(cube: np.ndarray) -> np.ndarray:
    u = cube.view(np.uint16) if cube.dtype == np.int16 else cube.astype(np.uint16)
    return u >> t123.trailing_zero_shift(cube)


def _run_both(monkeypatch, cube, jax_kw=None, run_kw=None, **ctor):
    """tpukit's run, then the port's with tpukit's weights replayed tile by
    tile; returns (tpukit result, port result)."""
    fitted = []
    encode_model = j123.encode_model

    def recording(xu):
        mapped, wq = encode_model(xu)
        fitted.append(np.asarray(wq))
        return mapped, wq

    monkeypatch.setattr(j123, "encode_model", recording)
    name = str(cube.dtype)
    want = j123.CCSDS123Codec(**ctor).run(cube, name, JRate.none(),
                                          keep_bitstream=True,
                                          **(jax_kw or run_kw or {}))
    codec = t123.CCSDS123Codec(**ctor)
    replay = iter(fitted)
    codec._fit_weights = lambda feats, c: next(replay)
    got = codec.run(cube, name, RateSpec.none(), keep_bitstream=True,
                    **(run_kw or {}), device="cpu")
    assert next(replay, None) is None            # every tile's fit was used
    return want, got


def _np(recon) -> np.ndarray:
    return recon.numpy() if isinstance(recon, torch.Tensor) \
        else np.asarray(recon)


@pytest.mark.parametrize("kind", ["int16_shift2", "uint16_random",
                                  "int16_negative"])
def test_models_exact_with_tpukit_weights(rng, kind):
    """encode_model's mapped residuals and decode_model's cube equal
    tpukit's, integer for integer, and decode inverts encode."""
    xu = _ring(_cube(rng, kind))
    jm, jw = j123.encode_model(jnp.asarray(xu))
    jw = np.asarray(jw)
    x = torch.from_numpy(xu.astype(np.int32))
    mapped, wq = t123.encode_model(x, lambda feats, c: jw)
    assert mapped.dtype == torch.int32 and wq.dtype == np.int16
    np.testing.assert_array_equal(wq, jw)
    np.testing.assert_array_equal(mapped.numpy(), np.asarray(jm))
    back = t123.decode_model(mapped, torch.from_numpy(jw.astype(np.int32)))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j123.decode_model(jm, jnp.asarray(jw))))
    np.testing.assert_array_equal(back.numpy(), xu)


def test_model_pieces_match_tpukit(rng):
    """The small functions one by one, on ring values that wrap."""
    xu = rng.integers(0, 65536, (5, 6, 7)).astype(np.uint16)
    x = torch.from_numpy(xu.astype(np.int32))
    d = t123._row_diff_ring(x)
    np.testing.assert_array_equal(d.numpy(),
                                  np.asarray(j123._row_diff_ring(jnp.asarray(xu))))
    np.testing.assert_array_equal(t123._row_cumsum_ring(d).numpy(), xu)
    c = t123._signed_view(d)
    jc = j123._signed_view(jnp.asarray(d.numpy().astype(np.uint16)))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(t123._features(c).numpy(),
                                  np.asarray(j123._features(jc)))
    z = t123._zigzag(c)
    np.testing.assert_array_equal(z.numpy(), np.asarray(j123._zigzag(jc)))
    np.testing.assert_array_equal(t123._unzigzag(z).numpy(), c.numpy())
    np.testing.assert_array_equal(
        t123._unzigzag(z).numpy(),
        np.asarray(j123._unzigzag(jnp.asarray(z.numpy().astype(np.uint16)))))
    # extreme weights and features: the int32 prediction does not overflow
    w = np.array([[32767, 32767, 32767, 32767], [-32767] * 4], np.int32)
    feats = torch.full((2, 4, 3, 3), t123.FEAT_CLAMP, dtype=torch.int32)
    want = [np.asarray(j123._predict(jnp.asarray(feats[b].numpy()),
                                     jnp.asarray(w[b]))) for b in range(2)]
    np.testing.assert_array_equal(
        t123._predict(feats, torch.from_numpy(w)).numpy(), np.stack(want))


@pytest.mark.parametrize("kind,tile", [
    ("int16_shift2", 512), ("int16_shift2", 16), ("uint16_random", 512),
    ("uint16_random", 8), ("uint16_odd", 512), ("int16_negative", 0),
    ("uint8", 512)])
def test_codec_stream_exact_with_tpukit_weights(rng, monkeypatch, kind, tile):
    """Whole and tiled, int16 (with a trailing-zero shift), uint16, uint8,
    and a tile whose sample count is no multiple of the block (the host
    entropy fallback): streams, sizes, extras and recons equal tpukit's,
    and each package decodes the other's streams."""
    cube = _cube(rng, kind)
    want, got = _run_both(monkeypatch, cube, tile=tile)
    assert got.bitstreams == want.bitstreams and got.bitstreams
    assert got.bitstream_bytes == want.bitstream_bytes
    assert (got.codec, got.encoder, got.extras) == \
        (want.codec, want.encoder, want.extras)
    whole = not tile or tile >= max(cube.shape[1:])
    assert isinstance(got.recon, torch.Tensor) == whole
    assert _np(got.recon).dtype == cube.dtype
    np.testing.assert_array_equal(_np(got.recon), cube)
    np.testing.assert_array_equal(np.asarray(want.recon), cube)
    assert fs_table.launches == 0                 # CPU tensors: plain table

    B, H, W = cube.shape
    step = tile or max(H, W)
    for name, bs in got.bitstreams.items():
        x0, y0 = int(name[3:8]), int(name[10:15])
        part = cube[:, y0:y0 + step, x0:x0 + step]
        th, tw = part.shape[1:]
        ring = part.view(np.uint16) if part.dtype == np.int16 \
            else part.astype(np.uint16)
        np.testing.assert_array_equal(                # tpukit reads the port's
            j123.CCSDS123Codec._decode(bs, B, th, tw), ring)
        out = t123.CCSDS123Codec._decode(want.bitstreams[name], B, th, tw)
        assert out.dtype == np.uint16                 # the port reads tpukit's
        np.testing.assert_array_equal(out, ring)


def test_trailing_zero_shift_travels_in_the_header(rng):
    cube = _cube(rng, "int16_shift2")
    res = t123.CCSDS123Codec().run(cube, "int16", RateSpec.none(),
                                   keep_bitstream=True, device="cpu")
    (bs,) = res.bitstreams.values()
    assert bs[:6] == b"TK123\x02" and bs[6] == 2      # '<B' shift
    np.testing.assert_array_equal(res.recon.numpy(), cube)
    with pytest.raises(ValueError, match="geometry"):
        t123.CCSDS123Codec._decode(bs, 16, 32, 31)
    with pytest.raises(ValueError, match="bad TK123"):
        t123.CCSDS123Codec._decode(b"x" + bs[1:], 16, 32, 32)


@pytest.mark.parametrize("kind", ["spectral", "smooth", "uint16_random",
                                  "int16_negative"])
def test_own_fit_lossless_and_close_to_tpukit(rng, kind):
    """The port's exact fit against tpukit's float32 fit."""
    cube = (_spectral(rng) if kind == "spectral" else _smooth(rng)
            if kind == "smooth" else _cube(rng, kind))
    name = str(cube.dtype)
    want = j123.CCSDS123Codec().run(cube, name, JRate.none())
    got = t123.CCSDS123Codec().run(cube, name, RateSpec.none(),
                                   keep_bitstream=True, device="cpu")
    np.testing.assert_array_equal(got.recon.numpy(), cube)
    np.testing.assert_array_equal(np.asarray(want.recon), cube)
    assert abs(got.bitstream_bytes - want.bitstream_bytes) \
        <= BYTES_RTOL * want.bitstream_bytes
    xu = _ring(cube)
    _, jw = j123.encode_model(jnp.asarray(xu))
    _, tw = t123.encode_model(torch.from_numpy(xu.astype(np.int32)))
    diff = np.abs(np.asarray(jw).astype(np.int64) - tw.astype(np.int64))
    assert diff.max() <= MAX_WEIGHT_LSB, diff.max()
    # tpukit decodes the stream the port's own weights made
    (bs,) = got.bitstreams.values()
    np.testing.assert_array_equal(
        j123.CCSDS123Codec._decode(bs, *cube.shape),
        cube.view(np.uint16) if cube.dtype == np.int16 else cube)


def test_fit_sums_are_exact_and_order_free(rng, monkeypatch):
    """The normal equations are integer sums below 2^53: float64 gives the
    int64 result whatever the grouping of bands, so the weights cannot
    depend on the device or on the order of the sums."""
    xu = torch.from_numpy(_ring(_smooth(rng)).astype(np.int32))
    c = t123._signed_view(t123._row_diff_ring(xu))
    feats = t123._features(c)
    wq = t123.fit_weights(feats, c)
    assert wq.dtype == np.int16 and wq.shape == (24, 4)
    for group in (1, 5, 24):
        monkeypatch.setattr(t123, "_FIT_BANDS", group)
        np.testing.assert_array_equal(t123.fit_weights(feats, c), wq)
    F = feats[:, :, 1:].numpy().astype(np.int64).reshape(24, 4, -1)
    t = c[:, 1:].numpy().astype(np.int64).reshape(24, -1)
    M = np.einsum("bfn,bgn->bfg", F, F)
    v = np.einsum("bfn,bn->bf", F, t)
    assert max(np.abs(M).max(), np.abs(v).max()) < 1 << 53
    w = np.linalg.solve(M + 1e-3 * np.eye(4)[None], v[..., None])[..., 0]
    np.testing.assert_array_equal(
        np.clip(np.rint(w * 4096), -32767, 32767).astype(np.int16), wq)
    # a permutation of the pixels leaves the sums, and the weights, as they are
    perm = torch.from_numpy(rng.permutation(63 * 64))
    fp = feats.clone()
    cp = c.clone()
    fp[:, :, 1:] = feats[:, :, 1:].flatten(2)[..., perm].reshape(24, 4, 63, 64)
    cp[:, 1:] = c[:, 1:].flatten(1)[..., perm].reshape(24, 63, 64)
    np.testing.assert_array_equal(t123.fit_weights(fp, cp), wq)


@pytest.mark.parametrize("by", ["value", "mask", "mask_whole_tile"])
def test_crop_nodata(rng, monkeypatch, by):
    """All-nodata tiles are skipped (by nodata value; by a zero dataset-mask
    window, filled with 0): as tpukit, stream for stream."""
    cube = _spectral(rng).copy()
    kw = {}
    tile = 16
    if by == "value":
        cube[:, :16, :] = -9999
        kw = dict(nodata=float(-9999))
        skipped = 2
    else:
        mask = np.full((32, 32), 255, np.uint8)
        if by == "mask":
            mask[:16, :16] = 0
            skipped = 1
        else:
            mask[:] = 0
            tile, skipped = 32, 1
        kw = dict(dataset_mask=mask)
    want, got = _run_both(monkeypatch, cube, run_kw=kw, tile=tile,
                          crop_nodata=True)
    assert got.extras == want.extras
    assert got.extras["tiles_skipped_nodata"] == skipped
    assert got.bitstreams == want.bitstreams
    assert len(got.bitstreams) == (32 // tile) ** 2 - skipped
    np.testing.assert_array_equal(_np(got.recon), np.asarray(want.recon))
    if by == "value":
        np.testing.assert_array_equal(_np(got.recon), cube)
    elif by == "mask":
        assert (got.recon[:, :16, :16] == 0).all()
    else:
        assert isinstance(got.recon, np.ndarray) and not got.recon.any()
    # the run-time flag does what the constructor's does
    via_opt = t123.CCSDS123Codec(tile=tile).run(
        cube, "int16", RateSpec.none(), crop_nodata=True, **kw, device="cpu")
    assert via_opt.extras["tiles_skipped_nodata"] == skipped


@pytest.mark.parametrize("dtype", ["int16", "uint16"])
def test_device_cube_reuse_matches_host_upload(rng, dtype):
    """run(device_cube=...) takes its ring values from the runner's upload
    (an int16 upload through its bit view) and gives the same stream; an
    upload of another shape, or a float one, is left alone."""
    cube = _spectral(rng) if dtype == "int16" else \
        rng.integers(0, 65536, (6, 16, 16)).astype(np.uint16)
    dev = torch.from_numpy(cube.copy())
    base = t123.CCSDS123Codec().run(cube, dtype, RateSpec.none(),
                                    keep_bitstream=True, device="cpu")
    via = t123.CCSDS123Codec().run(cube, dtype, RateSpec.none(),
                                   keep_bitstream=True, device_cube=dev,
                                   device="cpu")
    assert base.bitstreams == via.bitstreams
    np.testing.assert_array_equal(via.recon.numpy(), cube)
    for other in (dev[:, :8, :8], dev.to(torch.float32) + 0.25):
        res = t123.CCSDS123Codec().run(cube, dtype, RateSpec.none(),
                                       keep_bitstream=True, device_cube=other,
                                       device="cpu")
        assert res.bitstreams == base.bitstreams
    ring = cube.view(np.uint16).astype(np.int32)
    for opts in ({"device": "cpu"}, {"device_cube": dev}):
        work = device_work(cube, opts, 1, "uint16")
        assert work.dtype == torch.int32
        np.testing.assert_array_equal(work.numpy(), ring)
    padded = device_work(cube, {"device_cube": dev}, 5, "uint16")
    assert padded.shape[1] % 5 == 0 and padded.shape[2] % 5 == 0
    np.testing.assert_array_equal(
        padded[:, :cube.shape[1], :cube.shape[2]].numpy(), ring)


def test_decode_with_and_without_plan(rng):
    """_decode_device with the encoder's plan (chunked host decode, each
    chunk uploaded as it lands) and without one (one host decode)."""
    cube = _spectral(rng)
    xu = torch.from_numpy(_ring(cube).astype(np.int32))
    mapped, wq = t123.encode_model(xu)
    stream, plan = t123.dev121.encode_device(
        mapped.reshape(-1), bits=16, J=16, rsi=64, chunk=16 * 64 * 3,
        preprocess=False, return_plan=True)
    assert len(plan["sizes"]) > 1
    import struct
    bs = (t123._MAGIC + struct.pack("<BHIII", 2, 3, *cube.shape)
          + wq.astype("<i2").tobytes() + stream)
    with_plan = t123.CCSDS123Codec._decode_device(bs, *cube.shape, plan=plan)
    without = t123.CCSDS123Codec._decode_device(bs, *cube.shape)
    assert with_plan.dtype == torch.int32
    assert torch.equal(with_plan, without)
    np.testing.assert_array_equal(with_plan.numpy(), cube.view(np.uint16))


STD_CASES = {
    "default": dict(),
    "tiled": dict(tile=16),
    "bip": dict(interleave="bip"),
    "bil": dict(interleave="bil"),
    "knobs": dict(pred_bands=5, pred_mode="reduced", local_sums="column"),
    "p0": dict(pred_bands=0),
    "p15_column": dict(pred_bands=15, local_sums="column"),
    "block": dict(entropy="block"),
    "block_bip_reduced": dict(entropy="block", interleave="bip",
                              pred_mode="reduced"),
}


@pytest.mark.parametrize("dtype", ["int16", "uint16"])
@pytest.mark.parametrize("case", sorted(STD_CASES))
def test_standard_streams_equal_tpukit(rng, case, dtype):
    """predictor='standard' is host C++ in both packages: streams, extras
    and recons equal for every order, mode and entropy option."""
    cube = _spectral(rng) if dtype == "int16" else \
        rng.integers(0, 65536, (6, 16, 16)).astype(np.uint16)
    kw = dict(predictor="standard", **STD_CASES[case])
    want = j123.CCSDS123Codec(**kw).run(cube, dtype, JRate.none(),
                                        keep_bitstream=True)
    got = create("ccsds123_ext", **kw).run(cube, dtype, RateSpec.none(),
                                           keep_bitstream=True, device="cpu")
    assert got.bitstreams == want.bitstreams
    assert all(k.endswith(".l123") for k in got.bitstreams)
    assert (got.codec, got.encoder, got.extras, got.bitstream_bytes) == \
        (want.codec, want.encoder, want.extras, want.bitstream_bytes)
    assert isinstance(got.recon, np.ndarray)
    np.testing.assert_array_equal(got.recon, cube)
    info = tstd.stream_info(next(iter(got.bitstreams.values())))
    assert info == jstd.stream_info(next(iter(want.bitstreams.values())))
    assert info["entropy"] == kw.get("entropy", "sample")


def test_standard_coder_direct(rng):
    """ccsds123_std's own interface: sub-frame depths, modes and the block
    entropy coder, byte-equal to tpukit's and decodable by both."""
    cube = rng.integers(0, 1 << 14, (7, 19, 13)).astype(np.uint16)
    for kw in (dict(subframe=2), dict(subframe=5), dict(order="bil"),
               dict(full_mode=False, colsum=True),
               dict(order="bip", entropy="block"), dict(P=0, D=14)):
        bs = tstd.encode(cube, is_signed=False, **kw)
        assert bs == jstd.encode(cube, is_signed=False, **kw)
        np.testing.assert_array_equal(tstd.decode(bs), cube)
        np.testing.assert_array_equal(jstd.decode(bs), cube)
    assert tstd.subframe_for_order("bip", 7) == jstd.subframe_for_order("bip", 7)


@pytest.mark.parametrize("kw", [
    dict(predictor="lms"), dict(interleave="weird"),
    dict(predictor="standard", pred_bands=16), dict(pred_bands=-1),
    dict(predictor="standard", pred_mode="banana"),
    dict(predictor="standard", local_sums="diag"),
    dict(entropy="huffman"), dict(predictor="ls", entropy="block")])
def test_bad_parameters_rejected(kw):
    with pytest.raises(ValueError):
        j123.CCSDS123Codec(**kw)
    with pytest.raises(ValueError):
        t123.CCSDS123Codec(**kw)


def test_codec_flags_and_descriptions():
    """What the sweep runner reads off the class."""
    for attr in ("name", "encoder_desc", "std_desc", "supports_lossy",
                 "mask_passthrough", "strip_exact"):
        assert getattr(t123.CCSDS123Codec, attr) == \
            getattr(j123.CCSDS123Codec, attr), attr
    assert (t123.P, t123.FRAC_BITS, t123.FEAT_CLAMP, t123._MAGIC,
            t123._ENTROPY) == (j123.P, j123.FRAC_BITS, j123.FEAT_CLAMP,
                               j123._MAGIC, j123._ENTROPY)


def test_spectral_predictor_beats_1d_coder(rng):
    """The port's CCSDS-123 stream is well below its CCSDS-121 + diff1
    stream on a spectrally correlated cube, as tpukit's is."""
    cube = _smooth(rng)
    r123 = create("ccsds123", tile=64).run(cube, "int16", RateSpec.none(),
                                           device="cpu")
    r121 = create("ccsds121", preproc="diff1", interleave="bsq",
                  tile=64).run(cube, "int16", RateSpec.none(), device="cpu")
    np.testing.assert_array_equal(r123.recon.numpy(), cube)
    assert r123.bitstream_bytes < r121.bitstream_bytes * 0.92
