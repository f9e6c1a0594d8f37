# -*- coding: utf-8 -*-
"""CCSDS-122 in tpukit_torch against tpukit's, on the CPU, both entropy
backends (``bpe`` and ``embedded``): ``sweep_rates`` on uint16 and int16
cubes whose sides are no multiples of 8, with bpp, cr and no rate key,
duplicate budgets, kept streams on and off. Everything is integer, so
bytes, streams, reconstructions and the results' descriptive fields are
compared exactly. The committed golden ``.bpe`` vectors are reproduced byte
for byte by the port."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.codecs import ccsds122_codec as jc
from tpukit.codecs.base import RateSpec as JRate
from tpukit_torch.codecs import bpe122 as tb
from tpukit_torch.codecs import bpe122_model as tbm
from tpukit_torch.codecs import ccsds122_codec as tc
from tpukit_torch.codecs import wavelet_common as twc
from tpukit_torch.codecs.base import RateSpec as TRate
from tpukit_torch.codecs.base import per_band_bpp
from tpukit_torch.convert import from_tpukit_codec
from tpukit_torch.kernels import dwt as tdwt

torch.set_num_threads(2)        # xdist workers share the host

VEC = os.path.join(os.path.dirname(__file__), "vectors")
LADDERS = {"bpp": ("bpp", [0.5, 1, 1, 4, 16]), "cr": ("cr", [8, 4, 1]),
           "none": (None, [None])}


def _cube(dtype: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    gy, gx = np.mgrid[0:40, 0:52]
    base = 1500 * np.sin(gy / 7.0) * np.cos(gx / 11.0) + 2000
    cube = np.stack([base + rng.normal(0, 40, base.shape) for _ in range(3)])
    if dtype == "uint16":                       # 12-in-16, as Case A
        return (cube.clip(0, 4095).astype(np.uint16) << 4).astype(np.uint16)
    return (cube - 2000).astype(np.int16)


@pytest.fixture(scope="module")
def cubes():
    return {d: _cube(d) for d in ("uint16", "int16")}


@pytest.mark.parametrize("keep", [False, True], ids=["model", "kept"])
@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("dtype", ["uint16", "int16"])
@pytest.mark.parametrize("entropy", ["bpe", "embedded"])
def test_sweep_rates_equals_tpukit(cubes, entropy, dtype, ladder, keep):
    cube = cubes[dtype]
    key, values = LADDERS[ladder]
    want = jc.CCSDS122Codec(entropy).sweep_rates(
        cube, dtype, [JRate.of(key, v) for v in values], keep_bitstream=keep)
    got = tc.CCSDS122Codec(entropy).sweep_rates(
        cube, dtype, [TRate.of(key, v) for v in values], keep_bitstream=keep)
    assert len(got) == len(want) == len(values)
    for w, g in zip(want, got):
        assert g.bitstream_bytes == w.bitstream_bytes
        assert isinstance(g.recon, torch.Tensor)
        assert g.recon.numpy().dtype == cube.dtype
        np.testing.assert_array_equal(g.recon.numpy(), np.asarray(w.recon))
        assert g.bitstreams == w.bitstreams
        assert (g.bitstreams is not None) == keep
        assert (g.codec, g.encoder, g.extras) == (w.codec, w.encoder,
                                                  w.extras)
        if keep:
            assert sum(map(len, g.bitstreams.values())) == g.bitstream_bytes
    if ladder != "bpp":
        np.testing.assert_array_equal(got[-1].recon.numpy(), cube)  # lossless
    else:
        assert torch.equal(got[1].recon, got[2].recon)
        if entropy == "bpe":                        # one point per budget
            assert got[1].recon is got[2].recon


@pytest.mark.parametrize("entropy", ["bpe", "embedded"])
def test_run_equals_sweep_and_band_groups_do_not_matter(cubes, entropy,
                                                        monkeypatch):
    cube = cubes["uint16"]
    specs = [TRate.of("bpp", 1.0), TRate.of("bpp", 2.5)]
    codec = tc.CCSDS122Codec(entropy)
    whole = codec.sweep_rates(cube, "uint16", specs)
    monkeypatch.setattr(tc, "band_group", lambda B, per, dev: 2)
    grouped = codec.sweep_rates(cube, "uint16", specs)
    for spec, w, g in zip(specs, whole, grouped):
        one = codec.run(cube, "uint16", spec)
        assert one.bitstream_bytes == w.bitstream_bytes == g.bitstream_bytes
        assert torch.equal(one.recon, w.recon)
        assert torch.equal(g.recon, w.recon)


@pytest.mark.parametrize("tag,bpp", [("bpp1", 1.0), ("bpp8", 8.0)])
def test_golden_bpe_vectors_reproduced(tag, bpp):
    with open(os.path.join(VEC, "expected.json")) as f:
        expected = json.load(f)[f"ccsds122_{tag}.bpe"]
    tile = np.load(os.path.join(VEC, expected["input"]))
    res = tc.CCSDS122Codec(entropy="bpe").run(
        tile, "uint16", TRate.of("bpp", bpp), keep_bitstream=True)
    (stream,) = res.bitstreams.values()
    with open(os.path.join(VEC, f"ccsds122_{tag}.bpe"), "rb") as f:
        golden = f.read()
    assert stream == golden
    assert len(stream) == expected["bytes"] == res.bitstream_bytes
    err = int(np.abs(res.recon.numpy().astype(np.int64)
                     - tile.astype(np.int64)).max())
    assert err == expected["recon_max_abs_err"]


def test_kept_streams_decode_to_the_recon(cubes):
    """recon == decode(stream) for both backends: the native decoders, the
    weights divided out, the inverse 9/7M."""
    cube = cubes["uint16"]
    B, H, W = cube.shape
    Hp, Wp = 40, 56
    spec = [TRate.of("bpp", 2.0), TRate.of("bpp", 16.0)]
    for res in tc.CCSDS122Codec("bpe").sweep_rates(cube, "uint16", spec,
                                                   keep_bitstream=True):
        planes = np.stack([tb.decode_plane(s, Hp, Wp)
                           for _, s in sorted(res.bitstreams.items())])
        rec = tdwt.idwt2(torch.from_numpy(planes), "97m", 3)[:, :H, :W]
        assert torch.equal(rec.clamp(0, 65535).to(torch.uint16), res.recon)
    lossy, lossless = tc.CCSDS122Codec("embedded").sweep_rates(
        cube, "uint16", spec, keep_bitstream=True)
    order = twc.scan_order(Hp, Wp, 3)
    segb = twc.subband_seg_bounds(Hp, Wp, 3)
    wmap = tc.subband_weight_map(Hp, Wp).reshape(-1)
    for res, weighted in ((lossy, True), (lossless, False)):
        planes = np.empty((B, Hp * Wp), np.int32)
        for b, (name, s) in enumerate(sorted(res.bitstreams.items())):
            assert name.endswith(".wbit" if weighted else ".bit")
            if weighted:
                dec = np.rint(twc.bpc_decode(s, Hp * Wp).astype(np.float32)
                              / wmap[order]).astype(np.int32)
            else:
                assert s[0] == 4                    # the 12-in-16 shift
                dec = twc.wenc_decode(s[1:], Hp * Wp, segb)
            planes[b, order] = dec
        rec = tdwt.idwt2(torch.from_numpy(planes.reshape(B, Hp, Wp)),
                         "97m", 3)[:, :H, :W]
        if not weighted:
            rec = rec << 4
        assert torch.equal(rec.clamp(0, 65535).to(torch.uint16), res.recon)


def test_a_stream_that_disagrees_with_the_model_raises(cubes, monkeypatch):
    cube = cubes["int16"]
    encode = tb.bpe_encode_blocks
    monkeypatch.setattr(tb, "bpe_encode_blocks",
                        lambda *a, **kw: encode(*a, **kw) + b"\0")
    with pytest.raises(RuntimeError, match="disagrees with the native"):
        tc.CCSDS122Codec("bpe").run(cube, "int16", TRate.of("bpp", 2.0),
                                    keep_bitstream=True)
    bpc = twc.bpc_encode
    monkeypatch.setattr(twc, "bpc_encode",
                        lambda *a, **kw: bpc(*a, **kw)[:-1])
    with pytest.raises(RuntimeError, match="disagrees with the host"):
        tc.CCSDS122Codec("embedded").run(cube, "int16", TRate.of("bpp", 2.0),
                                         keep_bitstream=True)


def test_codec_surface_equals_tpukit(cubes):
    for entropy in ("bpe", "embedded"):
        j = jc.CCSDS122Codec(entropy)
        t = from_tpukit_codec(j)
        assert type(t) is tc.CCSDS122Codec and t.entropy == entropy
        for attr in ("name", "encoder_desc", "bpe_desc", "supports_lossy"):
            assert getattr(t, attr) == getattr(j, attr), attr
        for key, value in (("bpp", 0.5), ("bpp", 16), ("cr", 3.0),
                           ("cr", 1.0), (None, None), ("quality", 40)):
            for name in ("uint16", "int16", "uint8"):
                assert t.budget_for(TRate.of(key, value), 5, 40, 52, name) \
                    == j.budget_for(JRate.of(key, value), 5, 40, 52, name)
    assert tc.LEVELS == jc.LEVELS and tc._WEIGHTS == jc._WEIGHTS
    np.testing.assert_array_equal(tc.subband_weight_map(40, 56),
                                  jc.subband_weight_map(40, 56))
    with pytest.raises(ValueError, match="bpe|embedded"):
        tc.CCSDS122Codec("ebcot")
    from tpukit.codecs.base import per_band_bpp as j_per_band_bpp
    for key, value in (("bpp", 2.0), ("cr", 4.0), (None, None)):
        assert per_band_bpp(TRate.of(key, value), 7, 16.0) == \
            j_per_band_bpp(JRate.of(key, value), 7, 16.0)


@pytest.mark.parametrize("entropy", ["bpe", "embedded"])
def test_mesh_is_refused_with_its_item(cubes, entropy):
    with pytest.raises(NotImplementedError, match="item 21"):
        tc.CCSDS122Codec(entropy).sweep_rates(
            cubes["uint16"], "uint16", [TRate.of("bpp", 1.0)], mesh=object())


def test_device_functions_equal_tpukit(cubes):
    """The ladder's parts, one by one, on tpukit's inputs."""
    cube = cubes["int16"]
    work = np.pad(cube.astype(np.int32), ((0, 0), (0, 0), (0, 4)),
                  mode="edge")
    gather, scatter = tb.block_indices(40, 56)
    wexp = tb.weight_exp_map(40, 56)
    budgets = [300, 0, 1000]
    jrec, jn, jblocks = jc._bpe_ladder_device(
        jnp.asarray(work), jnp.asarray(gather), jnp.asarray(wexp),
        jnp.asarray(budgets, jnp.int32))
    c = tc._consts(40, 56, torch.device("cpu"))
    rec, n, blocks = tc._bpe_ladder_device(torch.from_numpy(work), c.gather,
                                           c.wexp, budgets)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    assert n.tolist() == np.asarray(jn).tolist()
    assert tbm.LAYOUT_BYTES_PER_BLOCK > 32 * 63 * 4
    want = jc._bpe_synthesize_device(jrec[0], jnp.asarray(scatter),
                                     jnp.asarray(wexp), 40, 56, 40, 52,
                                     "int16", -32768, 32767)
    got = tc._bpe_synthesize_device(rec[0], c.scatter, c.wexp, 40, 56, 40,
                                    52, torch.int16, -32768, 32767)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
