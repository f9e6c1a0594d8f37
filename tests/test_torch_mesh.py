# -*- coding: utf-8 -*-
"""The device mesh (tpukit_torch/parallel/mesh.py) and the codecs' mesh
ladders against tpukit's, on the CPU, case for case with
tests/test_parallel.py.

tpukit runs its mesh on the suite's 8-device virtual CPU mesh
(tests/conftest.py); the port's mesh is eight CPU positions. Integer paths
must agree exactly: the CCSDS-121 stream sizes and plans, the CCSDS-122
ladders, the J2K size model given the same 9/7 coefficients. Float32
statistics are held to tpukit's own rtol 1e-5 (tests/test_parallel.py
:102-106), the float32 sums being taken in another order by torch than by
XLA. The J2K device ladder with the port's own 9/7 transform is held to
tpukit's within rel 5e-3 in bytes and rel 1e-2 in MSE, the tolerances of
tests/test_torch_j2k_device_streams.py; with tpukit's coefficients and
subband norms injected its bytes and kept streams are tpukit's exactly.
Within the port a mesh run equals the single-device run bit for bit, and
the K1 and K2 entry points restore the caller's CUDA device (a source
check: the kernels cannot run here; chip_smoke.py phase 11f checks it on
the card)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukit.codecs.j2k_codec as jj2k
from tpukit.codecs.base import RateSpec as JRate
from tpukit.codecs.registry import create as jcreate
from tpukit.kernels import dwt as jdwt
from tpukit.parallel import mesh as jm
from tpukit_torch.codecs import j2k_codec as tj2k
from tpukit_torch.codecs import wavelet_common as twc
from tpukit_torch.codecs.base import RateSpec as TRate
from tpukit_torch.codecs.registry import create as tcreate
from tpukit_torch.parallel import mesh as tm

torch.set_num_threads(2)        # xdist workers share the host

REPO = Path(__file__).resolve().parent.parent
BYTES_REL = 5e-3
MSE_REL = 1e-2


def jmesh(n, dp, sp):
    return jm.make_mesh(jax.devices("cpu")[:n], dp=dp, sp=sp)


def tmesh(n, dp, sp):
    return tm.make_mesh(["cpu"] * n, dp=dp, sp=sp)


def _cube(rng, bands=4, size=32):
    base = rng.integers(300, 3000, (size, size)).astype(np.int32)
    return np.clip(base[None] + rng.integers(-80, 80, (bands, size, size)),
                   0, 4095).astype(np.uint16)


def _mse(cube, recon) -> float:
    d = np.asarray(recon).astype(np.float64) - cube.astype(np.float64)
    return float(np.mean(d * d))


@pytest.fixture
def tpukit_coefficients(monkeypatch):
    """The port computes with tpukit's 9/7 coefficients and subband norms."""
    def dwt(x, levels=5, **kw):
        return torch.from_numpy(np.array(jdwt.dwt2(jnp.asarray(x.numpy()),
                                                   "97", levels)))
    monkeypatch.setattr(tj2k, "dwt97", dwt)
    monkeypatch.setattr(tj2k, "_subband_norms", jj2k._subband_norms)
    return dwt


def test_make_mesh_layout_and_errors():
    """tpukit's make_mesh contract: a (dp, sp) grid in row-major order, dp
    defaulting to n // sp, the same ValueError; a repeated device is a
    position of its own; pad_to_dp as tpukit's."""
    m = tmesh(8, 4, 2)
    assert m.shape == {"dp": 4, "sp": 2} == dict(jmesh(8, 4, 2).shape)
    pos = m.positions()
    assert [p.index for p in pos] == list(range(8))
    assert len(set(map(id, pos))) == 8 and m.home is pos[0]
    assert all(p.device == torch.device("cpu") and p.stream is None
               for p in pos)
    assert m.sharing(pos[3]) == 8
    assert tm.make_mesh(["cpu"] * 6, sp=2).shape == {"dp": 3, "sp": 2}
    for bad in ((8, 3, 2), (4, 3, 1)):
        n, dp, sp = bad
        with pytest.raises(ValueError) as want:
            jmesh(n, dp, sp)
        with pytest.raises(ValueError) as got:
            tmesh(n, dp, sp)
        assert str(got.value) == str(want.value)
    vals = np.arange(5)
    for dp in (1, 2, 4):
        got, pad = tm.pad_to_dp(tmesh(dp, dp, 1), vals)
        want, jpad = jm.pad_to_dp(jmesh(dp, dp, 1), vals)
        assert pad == jpad and np.array_equal(got, want)


@pytest.mark.parametrize("n", [8, 2])
def test_run_sharded_batch_equals_the_dryrun(n):
    """The counterpart of __graft_entry__.dryrun_multichip(n) and entry():
    the dry run's layout and inputs through both packages'
    run_sharded_batch, and entry()'s inputs through both
    analysis_step_fn."""
    import __graft_entry__ as ge

    sp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // sp
    rng = np.random.default_rng(0)
    T, B, H, W = dp * 2, sp * 4, 32, 32
    tiles = rng.integers(0, 4096, (T, B, H, W)).astype(np.uint16)
    valid = np.ones((T, H, W), bool)
    want = jm.run_sharded_batch(tiles, tiles.copy(), valid, jmesh(n, dp, sp))
    got = tm.run_sharded_batch(tiles, tiles.copy(), valid, tmesh(n, dp, sp))
    np.testing.assert_array_equal(got["bitstream_bytes"],
                                  want["bitstream_bytes"])
    assert (got["quality"]["maxerr"] == 0).all()
    np.testing.assert_array_equal(got["quality"]["sse"], 0)

    fn, args = ge.entry()
    want = jax.jit(fn)(*args)
    got = tm.analysis_step_fn(*(torch.from_numpy(np.array(a))
                                for a in args))
    np.testing.assert_array_equal(got["bitstream_bytes"].numpy(),
                                  np.asarray(want["bitstream_bytes"]))
    np.testing.assert_array_equal(got["quality"]["maxerr"].numpy(),
                                  np.asarray(want["quality"]["maxerr"]))
    assert (got["bitstream_bytes"].numpy() > 0).all()


def test_sharded_matches_single_device(rng):
    """Sharded == single device in the port (sizes and integers exact,
    float32 sums within tpukit's rtol), and == tpukit's sharded step."""
    T, B, H, W = 4, 4, 32, 32
    tiles = rng.integers(0, 4096, (T, B, H, W)).astype(np.uint16)
    recons = (tiles + rng.integers(0, 3, tiles.shape).astype(np.uint16))
    valid = rng.random((T, H, W)) > 0.2

    sharded = tm.run_sharded_batch(tiles, recons, valid, tmesh(4, 2, 2))
    single = tm.analysis_step_fn(torch.from_numpy(tiles),
                                 torch.from_numpy(recons),
                                 torch.from_numpy(valid))
    want = jm.run_sharded_batch(tiles, recons, valid, jmesh(4, 2, 2))
    for other, rtol in ((jax.tree_util.tree_map(lambda t: t.numpy(), single),
                         1e-6), (want, 1e-5)):
        np.testing.assert_array_equal(sharded["bitstream_bytes"],
                                      other["bitstream_bytes"])
        for k in ("maxerr", "max_abs_obs", "n"):
            np.testing.assert_array_equal(sharded["quality"][k],
                                          other["quality"][k])
        for k in ("sse", "sum_ac2", "sum_rc2", "sum_acrc", "c_a"):
            np.testing.assert_allclose(sharded["quality"][k],
                                       other["quality"][k], rtol=rtol)
        for k in ("sam_sum", "sid_sum", "lmse"):
            np.testing.assert_allclose(sharded["spectral"][k],
                                       other["spectral"][k], rtol=rtol)


def test_device_size_matches_cpp_through_step(rng):
    """The sharded step's size equals the host coder's stream length."""
    from tpukit_torch.native import ccsds121_host as ck

    T, B, H, W = 2, 4, 32, 32
    tiles = rng.integers(0, 2048, (T, B, H, W)).astype(np.uint16)
    valid = np.ones((T, H, W), bool)
    out = tm.run_sharded_batch(tiles, tiles, valid, tmesh(2, 2, 1))
    want = jm.run_sharded_batch(tiles, tiles, valid, jmesh(2, 2, 1))
    for t in range(T):
        flat = np.moveaxis(tiles[t], 0, -1).ravel()
        assert out["bitstream_bytes"][t] == len(ck.encode(flat, 16)) \
            == want["bitstream_bytes"][t]


def _close_stats(got, want, rtol):
    """Quality statistics within ``rtol``; the centred first moments, zero
    in exact arithmetic, are float32 rounding noise, held against the
    scale of the centred values instead (sqrt(n * sum of squares))."""
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k in ("sum_ac", "sum_rc"):
            x2 = np.asarray(want["sum_ac2" if k == "sum_ac" else "sum_rc2"])
            scale = np.sqrt(np.asarray(want["n"])[..., None] * x2)
            assert np.all(np.abs(g - w) <= rtol * scale), k
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("has_nodata", [False, True])
def test_sharded_metric_ladder_matches_single(rng, has_nodata):
    """The dp=4, sp=2 metric ladder on two codec families' recons: equal to
    the port's single-device ladder and to tpukit's sharded one within
    rtol 1e-5 (float32 sums), the recon-side NoData mask included."""
    from tpukit.metrics.quality import quality_stats_ladder as jq
    from tpukit_torch.metrics.quality import quality_stats_ladder
    from tpukit_torch.metrics.spectral import spectral_stats_ladder

    cube = _cube(rng)
    recons = [np.asarray(r.recon) for r in jcreate(
        "j2k", entropy="device").sweep_rates(
        cube, "uint16", [JRate.of("quality", q) for q in (15, 60)])]
    recons += [np.asarray(r.recon) for r in jcreate("ccsds122").sweep_rates(
        cube, "uint16", [JRate.of("bpp", v) for v in (1.0, 4.0)])]
    nodata = float(recons[0][0, 3, 3])
    vm = rng.random((32, 32)) > 0.1

    step = tm.sharded_metric_ladder(tmesh(8, 4, 2), has_nodata, True)
    ref, stack, vmp, samp, nod, n_real = tm.place_ladder_inputs(
        tmesh(8, 4, 2), cube, recons, vm, vm, nodata)
    assert n_real == 4 and stack.shape[0] == 4
    qs, ss = step(ref, stack, vmp, samp, nod)
    qs1 = quality_stats_ladder(torch.from_numpy(cube),
                               torch.from_numpy(np.stack(recons)),
                               torch.from_numpy(vm), nodata, has_nodata)
    ss1 = spectral_stats_ladder(torch.from_numpy(cube),
                                torch.from_numpy(np.stack(recons)),
                                torch.from_numpy(vm))
    jmsh = jmesh(8, 4, 2)
    jqs, jss = jm.sharded_metric_ladder(jmsh, has_nodata, True)(
        *jm.place_ladder_inputs(jmsh, cube, recons, vm, vm, nodata)[:5])
    jqs1 = jq(jnp.asarray(cube), jnp.asarray(np.stack(recons)),
              jnp.asarray(vm), jnp.float32(nodata), has_nodata)
    got = {k: v.numpy()[:n_real] for k, v in qs.items()}
    _close_stats(got, {k: v.numpy() for k, v in qs1.items()}, 1e-5)
    _close_stats(got, {k: np.asarray(v)[:n_real] for k, v in jqs.items()},
                 1e-5)
    _close_stats({k: np.asarray(v)[:n_real] for k, v in jqs.items()},
                 {k: np.asarray(v) for k, v in jqs1.items()}, 1e-5)
    for k in ss1:
        np.testing.assert_allclose(ss[k].numpy()[:n_real], ss1[k].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(ss[k].numpy()[:n_real],
                                   np.asarray(jss[k])[:n_real], rtol=1e-5)


@pytest.mark.parametrize("coefs", ["own", "tpukit"])
def test_sharded_j2k_model_matches_host_coder(rng, monkeypatch, coefs):
    """The sharded J2K model prices every tile byte-exactly against the host
    coder (both segment layouts); given tpukit's 9/7 coefficients it
    equals tpukit's sharded model."""
    import tpukit_torch.kernels.dwt97 as tdwt97
    from tpukit.codecs import wavelet_common as jwc
    from tpukit_torch.kernels.dwt import dwt2

    T, B, H, W = 4, 2, 32, 32
    L = tj2k.LEVELS
    tiles = rng.integers(0, 4096, (T, B, H, W)).astype(np.float32)
    order = twc.scan_order(H, W, L)
    scale = tj2k._subband_steps(H, W, 1.0)
    base = tj2k.base_step_for_quality(40, 4095.0)
    assert np.array_equal(order, jwc.scan_order(H, W, L))

    def coefs_of(t):
        if coefs == "tpukit":
            return np.asarray(jdwt.dwt2(jnp.asarray(t), "97", L))
        return dwt2(torch.from_numpy(t), "97", L).numpy()

    if coefs == "tpukit":
        monkeypatch.setattr(tdwt97, "dwt97", lambda x, levels: torch.from_numpy(
            coefs_of(x.numpy())))
        monkeypatch.setattr(tj2k, "_subband_norms", jj2k._subband_norms)
        scale = jj2k._subband_steps(H, W, 1.0)
    mesh, jmsh = tmesh(4, 4, 1), jmesh(4, 4, 1)
    for segb in (None, twc.subband_seg_bounds(H, W, L)):
        sizes = tm.sharded_j2k_model(mesh, levels=L, segbounds=segb)(
            tiles, scale, np.float32(base), order).numpy()
        sizes_sp = tm.sharded_j2k_model(tmesh(4, 2, 2), levels=L,
                                        segbounds=segb)(
            tiles, scale, np.float32(base), order).numpy()
        np.testing.assert_array_equal(sizes, sizes_sp)
        for t in range(T):
            qc = np.trunc(coefs_of(tiles[t]) / (scale * np.float32(base))[None])
            qc = qc.astype(np.int32)
            assert int(sizes[t]) == sum(
                len(twc.wenc_encode(qc[b].ravel()[order], segbounds=segb))
                for b in range(B))
        if coefs == "tpukit":
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(jmsh, P())
            want = np.asarray(jm.sharded_j2k_model(
                jmsh, levels=L, segbounds=segb)(
                jax.device_put(tiles, NamedSharding(jmsh, P("dp", None, None,
                                                             None))),
                jax.device_put(scale, rep),
                jax.device_put(np.float32(base), rep),
                jax.device_put(order.astype(np.int32), rep)))
            np.testing.assert_array_equal(sizes, want)


def test_sharded_ccsds122_ladder_matches_host_coder(rng):
    """dp x sp CCSDS-122 point: recon planes and per-band bytes equal the
    host coder's round trip, and tpukit's sharded step, exactly."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpukit_torch.codecs.ccsds122_codec import subband_weight_map
    from tpukit_torch.kernels.dwt import dwt2, idwt2

    T, B, H, W = 4, 2, 32, 32
    tiles = rng.integers(0, 4096, (T, B, H, W)).astype(np.int32)
    budget = int(1.5 * H * W / 8.0)
    order = twc.scan_order(H, W, 3)
    inv = twc.inverse_scan_order(H, W, 3)
    for weighted in (True, False):
        rec, sizes = tm.sharded_ccsds122_ladder(tmesh(8, 4, 2), levels=3,
                                                weighted=weighted)(
            tiles, order, inv, budget)
        rec, sizes = rec.numpy(), sizes.numpy()
        jmsh = jmesh(8, 4, 2)
        rep = NamedSharding(jmsh, P())
        jrec, jsizes = jm.sharded_ccsds122_ladder(jmsh, levels=3,
                                                  weighted=weighted)(
            jax.device_put(tiles, NamedSharding(jmsh, P("dp", "sp", None,
                                                        None))),
            jax.device_put(order.astype(np.int32), rep),
            jax.device_put(inv.astype(np.int32), rep),
            jax.device_put(np.int32(budget), rep))
        np.testing.assert_array_equal(rec, np.asarray(jrec))
        np.testing.assert_array_equal(sizes, np.asarray(jsizes))
        if not weighted:
            continue
        wmap = subband_weight_map(H, W)
        wperm = wmap.ravel()[order]
        for t in range(T):
            coefs = dwt2(torch.from_numpy(tiles[t]), "97m", 3).numpy() * wmap
            for b in range(B):
                c = coefs[b].ravel()[order].astype(np.int32)
                assert int(sizes[t, b]) == len(twc.bpc_encode(c, budget))
            want = idwt2(torch.from_numpy(np.stack([
                np.rint(twc.bpc_decode(twc.bpc_encode(
                    coefs[b].ravel()[order].astype(np.int32), budget),
                    H * W).astype(np.float32) / wperm).astype(np.int32)
                [inv].reshape(H, W) for b in range(B)])), "97m", 3).numpy()
            np.testing.assert_array_equal(rec[t], want)


@pytest.mark.parametrize("coefs", ["own", "tpukit"])
def test_mesh_j2k_quality_ladder_matches_single(rng, request, coefs):
    """The mesh J2K quality ladder equals the port's single-device ladder
    bit for bit (bytes, quality, recon) at any position count; against
    tpukit's mesh ladder: bytes within rel 5e-3 and MSE within rel 1e-2
    with the port's own transform, bytes exact and recon within 1 DN with
    tpukit's coefficients."""
    if coefs == "tpukit":
        request.getfixturevalue("tpukit_coefficients")
    cube = _cube(rng)
    qs = (10, 35, 80)
    specs = [TRate.of("quality", q) for q in qs]
    single = tcreate("j2k", entropy="device").sweep_rates(
        cube, "uint16", specs, device="cpu")
    meshed = tcreate("j2k", entropy="device").sweep_rates(
        cube, "uint16", specs, mesh=tmesh(8, 4, 2), device="cpu")
    meshed1 = tcreate("j2k", entropy="device").sweep_rates(
        cube, "uint16", specs, mesh=tmesh(1, 1, 1), device="cpu")
    want = jcreate("j2k", entropy="device").sweep_rates(
        cube, "uint16", [JRate.of("quality", q) for q in qs],
        mesh=jmesh(8, 4, 2))
    for s, m, m1, w in zip(single, meshed, meshed1, want):
        assert s.bitstream_bytes == m.bitstream_bytes == m1.bitstream_bytes
        assert s.extras == m.extras == {"quality_used": w.extras[
            "quality_used"]}
        assert torch.equal(s.recon, m.recon) and torch.equal(m.recon,
                                                             m1.recon)
        if coefs == "tpukit":
            assert m.bitstream_bytes == w.bitstream_bytes
            diff = m.recon.numpy().astype(np.int32) \
                - np.asarray(w.recon).astype(np.int32)
            assert np.abs(diff).max() <= 1
        else:
            assert abs(m.bitstream_bytes - w.bitstream_bytes) \
                <= BYTES_REL * w.bitstream_bytes
            mw, mp = _mse(cube, w.recon), _mse(cube, m.recon)
            assert abs(mp - mw) <= MSE_REL * mw


def test_mesh_bpe122_ladder_matches_single(rng):
    """The mesh CCSDS-122 BPE budget ladder equals the port's single-device
    ladder and tpukit's mesh ladder bit for bit (integer math), at sp=2
    and where sp does not divide the band count (all positions on dp)."""
    specs = [(0.5,), (1.5,), (16.0,)]
    for bands in (4, 3):
        cube = _cube(rng, bands)
        t = [TRate.of("bpp", v) for (v,) in specs]
        single = tcreate("ccsds122").sweep_rates(cube, "uint16", t,
                                                 device="cpu")
        meshed = tcreate("ccsds122").sweep_rates(cube, "uint16", t,
                                                 mesh=tmesh(8, 4, 2),
                                                 device="cpu")
        want = jcreate("ccsds122").sweep_rates(
            cube, "uint16", [JRate.of("bpp", v) for (v,) in specs],
            mesh=jmesh(8, 4, 2))
        for s, m, w in zip(single, meshed, want):
            assert s.bitstream_bytes == m.bitstream_bytes == w.bitstream_bytes
            np.testing.assert_array_equal(m.recon.numpy(), s.recon.numpy())
            np.testing.assert_array_equal(m.recon.numpy(), np.asarray(w.recon))


def test_mesh_for_bands_puts_every_position_on_dp():
    """sp must divide the band count, else the same positions (and
    streams) go all on dp, once per mesh; tpukit's shape."""
    m = tmesh(8, 4, 2)
    assert tj2k.mesh_for_bands(m, 4) is m
    flat = tj2k.mesh_for_bands(m, 3)
    assert flat.shape == {"dp": 8, "sp": 1} == dict(
        jj2k.mesh_for_bands(jmesh(8, 4, 2), 3).shape)
    assert flat.positions() == m.positions()
    assert tj2k.mesh_for_bands(m, 3) is flat


def test_ccsds121_mesh_codec_phase_plan_matches_single(rng):
    """The chunk analyses round-robin over the positions; the plan equals
    the single-device plan and tpukit's mesh plan, so the packed stream
    stays byte-exact against the serial coder."""
    from tpukit.codecs import ccsds121 as jdev
    from tpukit_torch.codecs import ccsds121 as dev
    from tpukit_torch.native import ccsds121_host as ck

    n = 16 * 4096
    x = (rng.integers(0, 1 << 14, n).astype(np.uint16) << 2)
    pm = dev.encode_plan(x, bits=16, chunk=8192,
                         devices=tmesh(8, 8, 1).positions())
    ps = dev.encode_plan(torch.from_numpy(x.astype(np.int32)), bits=16,
                         chunk=8192)
    want = jdev.encode_plan(x, bits=16, chunk=8192,
                            devices=jax.devices("cpu")[:8])
    assert pm is not None and pm == ps == want
    assert len(pm["sizes"]) == 8
    bs = ck.encode_parallel(x, pm)
    assert bs == ck.encode(x, 16)
    assert (pm["total_bits"] + 7) // 8 == len(bs)


def test_ccsds121_codec_mesh_run_matches_host(rng, monkeypatch):
    """CCSDS121Codec.run with a mesh in the context (the runner's mesh
    mode) computes the mesh plan once, in chunks small enough for every
    position, keeps it in the plan cache for the next rep, and codes
    tpukit's bytes (the serial coder's) and a lossless recon."""
    from tpukit.codecs.ccsds121_codec import CCSDS121Codec as JCodec
    from tpukit_torch.codecs import ccsds121 as dev
    from tpukit_torch.codecs.ccsds121_codec import CCSDS121Codec
    from tpukit_torch.native import ccsds121_host as ck

    B, H, W = 6, 64, 64
    cube = ((rng.integers(0, 1 << 14, (B, H, W)).astype(np.uint16)) << 2) \
        .view(np.int16)
    plans = []
    encode_plan = dev.encode_plan

    def spy(*a, **kw):
        plans.append(encode_plan(*a, **kw))
        return plans[-1]

    monkeypatch.setattr(dev, "encode_plan", spy)
    codec = CCSDS121Codec(tile=64, interleave="bip", preproc="none",
                          plan_chunk=4096)
    cache: dict = {}
    mesh = tmesh(4, 4, 1)
    for _ in range(2):
        res = codec.run(cube, "int16", TRate.of("none", None), mesh=mesh,
                        device_plan_cache=cache, device="cpu")
        assert np.array_equal(res.recon, cube)
    assert len(plans) == 1 and plans[0] is not None
    assert plans[0]["sizes"] == [3072] * 8    # n // 8, below plan_chunk
    (key,) = [k for k in cache if k[0] == "ck121_plan"]
    assert cache[key] == plans[0]
    flat = np.ascontiguousarray(
        np.moveaxis(cube.view(np.uint16), 0, -1)).ravel()
    assert res.bitstream_bytes == len(ck.encode(flat, 16))
    want = JCodec(tile=64, interleave="bip", preproc="none",
                  plan_chunk=4096).run(cube, "int16",
                                       JRate.of("none", None),
                                       mesh=jmesh(4, 4, 1))
    assert res.bitstream_bytes == want.bitstream_bytes


def test_mesh_keep_bitstream_j2k_matches_single(rng, tpukit_coefficients):
    """Mesh + kept streams: the host coder's streams after the mesh's size
    model, byte-equal to the single-device run's and, with tpukit's
    coefficients, to tpukit's mesh run's; each point as long as the mesh
    size model says."""
    cube = _cube(rng)
    qs = (10, 35, 80)
    specs = [TRate.of("quality", q) for q in qs]
    single = tcreate("j2k", entropy="device").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True, device="cpu")
    meshed = tcreate("j2k", entropy="device").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True, mesh=tmesh(8, 4, 2),
        device="cpu")
    want = jcreate("j2k", entropy="device").sweep_rates(
        cube, "uint16", [JRate.of("quality", q) for q in qs],
        keep_bitstream=True, mesh=jmesh(8, 4, 2))
    for s, m, w in zip(single, meshed, want):
        assert m.bitstreams and m.bitstreams == s.bitstreams == w.bitstreams
        assert m.bitstream_bytes == sum(map(len, m.bitstreams.values()))


def test_mesh_keep_bitstream_ccsds122_matches_single(rng):
    """Mesh + kept streams for the BPE ladder: real CCSDS 122.0-B segments
    per budget, byte-equal to the single-device run's and tpukit's mesh
    run's, as long as the model's byte counts."""
    cube = _cube(rng)
    vals = (0.5, 1.5)
    single = tcreate("ccsds122").sweep_rates(
        cube, "uint16", [TRate.of("bpp", v) for v in vals],
        keep_bitstream=True, device="cpu")
    meshed = tcreate("ccsds122").sweep_rates(
        cube, "uint16", [TRate.of("bpp", v) for v in vals],
        keep_bitstream=True, mesh=tmesh(8, 4, 2), device="cpu")
    want = jcreate("ccsds122").sweep_rates(
        cube, "uint16", [JRate.of("bpp", v) for v in vals],
        keep_bitstream=True, mesh=jmesh(8, 4, 2))
    for s, m, w in zip(single, meshed, want):
        assert m.bitstreams and m.bitstreams == s.bitstreams == w.bitstreams
        assert m.bitstream_bytes == sum(map(len, m.bitstreams.values()))


def test_mesh_size_model_mismatch_raises(rng, monkeypatch):
    """A kept stream that parts from the mesh's size model raises, for the
    J2K ladder and the BPE ladder alike (never an assert)."""
    from tpukit_torch.codecs import bpe122

    cube = _cube(rng)
    enc = twc.wenc_quant_encode_ck
    monkeypatch.setattr(twc, "wenc_quant_encode_ck",
                        lambda *a, **k: (enc(*a, **k)[0] + b"\0",)
                        + enc(*a, **k)[1:])
    with pytest.raises(RuntimeError, match="mesh size model / host coder"):
        tcreate("j2k", entropy="device").sweep_rates(
            cube, "uint16", [TRate.of("quality", 40)], keep_bitstream=True,
            mesh=tmesh(2, 2, 1), device="cpu")
    bpe = bpe122.bpe_encode_blocks
    monkeypatch.setattr(bpe122, "bpe_encode_blocks",
                        lambda *a, **k: bpe(*a, **k) + b"\0")
    with pytest.raises(RuntimeError, match="bpe122 mesh size model"):
        tcreate("ccsds122").sweep_rates(
            cube, "uint16", [TRate.of("bpp", 1.0)], keep_bitstream=True,
            mesh=tmesh(2, 2, 1), device="cpu")


def test_mesh_ebcot_identical_by_construction(rng, monkeypatch):
    """The ebcot backend ignores the mesh by design: the codec work is host
    C++ and one pricing ladder on the codec's device, so the mesh run's
    streams and recons equal the single-device run's; and with tpukit's
    priced targets injected, tpukit's mesh run's."""
    cube = _cube(rng, bands=2)
    qs = (20, 60)
    priced = []
    ladder = jj2k._device_ladder_sizes

    def spy(*a, **kw):
        priced.append(np.asarray(ladder(*a, **kw)))
        return priced[-1]

    monkeypatch.setattr(jj2k, "_device_ladder_sizes", spy)
    want = jcreate("j2k", entropy="ebcot").sweep_rates(
        cube, "uint16", [JRate.of("quality", q) for q in qs],
        keep_bitstream=True, mesh=jmesh(4, 2, 2))
    specs = [TRate.of("quality", q) for q in qs]
    single = tcreate("j2k", entropy="ebcot").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True, device="cpu")
    meshed = tcreate("j2k", entropy="ebcot").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True, mesh=tmesh(4, 2, 2),
        device="cpu")
    for s, m in zip(single, meshed):
        assert s.bitstreams == m.bitstreams
        np.testing.assert_array_equal(s.recon, m.recon)
    (p,) = priced
    targets = {i: int(v.sum()) for i, v in enumerate(p)}
    monkeypatch.setattr(tj2k.J2KCodec, "_price_targets",
                        lambda self, cube, qual_specs, device_cube=None:
                        (lambda: targets))
    injected = tcreate("j2k", entropy="ebcot").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True, mesh=tmesh(4, 2, 2),
        device="cpu")
    for g, w in zip(injected, want):
        assert g.bitstreams == w.bitstreams
        np.testing.assert_array_equal(g.recon, np.asarray(w.recon))


def test_from_tpukit_mesh():
    """A tpukit mesh's dp and sp carried over, on the positions asked for:
    eight distinct CPU positions here."""
    from tpukit_torch.convert import from_tpukit_mesh

    m = from_tpukit_mesh(jmesh(8, 4, 2), device="cpu")
    assert m.shape == {"dp": 4, "sp": 2}
    assert len({id(p) for p in m.positions()}) == 8
    assert {p.device for p in m.positions()} == {torch.device("cpu")}


_ENTRY = re.compile(r'^int (tpk_\w+)\(.*?\)\s*\{(.*?)^\}', re.M | re.S)


@pytest.mark.parametrize("source", ["fs_table.cu", "dwt97.cu"])
def test_kernel_entry_points_restore_the_device(source):
    """Every extern "C" launch entry of K1 and K2 makes its device current
    through a guard declared before anything else, which read the caller's
    device with cudaGetDevice and sets it back in its destructor, so every
    return, errors included, restores it; no bare cudaSetDevice is left."""
    text = (REPO / "tpukit_torch" / "csrc" / source).read_text()
    guard = re.search(r"struct DeviceGuard \{(.*?)^\};", text, re.M | re.S)
    assert guard, "no DeviceGuard"
    body = guard.group(1)
    assert "cudaGetDevice(&prev)" in body
    assert re.search(r"~DeviceGuard\(\)\s*\{[^}]*cudaSetDevice\(prev\)",
                     body)
    extern = text[text.index('extern "C" {'):]
    entries = _ENTRY.findall(extern)
    want = {"fs_table.cu": {"tpk_fs_table"},
            "dwt97.cu": {"tpk_dwt97_tile", "tpk_dwt97_tail"}}[source]
    assert {name for name, _ in entries} == want
    for name, fn in entries:
        lines = [ln.strip() for ln in fn.strip().splitlines()]
        assert lines[:2] == ["DeviceGuard guard;",
                             "cudaError_t err = guard.set(device);"], name
        assert "cudaSetDevice" not in fn, name
    assert text.count("cudaSetDevice(") == 2    # the guard's two calls
