# -*- coding: utf-8 -*-
"""The J2K device fast mode's models in tpukit_torch against tpukit's, on
the CPU.

Integer parts are held exactly: the reversible 5/3 DWT, the per-row
CCSDS-121 size (tpukit vmaps ``encode_size`` over the bands), the full
quadruple-backend size model ``wenc_size_bytes`` and, fed tpukit's own
9/7 coefficients and step maps as numpy, the quality ladder, the tiled
ladder, the lossless sizes, the requantization checksums and the
bisection's fitted base. The reconstructions from those coefficients go
through each package's own float32 inverse 9/7, which round differently
(XLA:CPU contracts the lifting into FMAs), so they are held within 1 DN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukit.codecs.j2k_codec as jj2k
from tpukit.codecs import ccsds121 as jck
from tpukit.codecs import wavelet_common as jwc
from tpukit.kernels import dwt as jdwt
from tpukit_torch.codecs import ccsds121 as tck
from tpukit_torch.codecs import j2k_codec as tj2k
from tpukit_torch.codecs import wavelet_common as twc
from tpukit_torch.kernels import dwt as tdwt

torch.set_num_threads(2)        # xdist workers share the host

LADDER = [1, 2, 4, 6, 8, 10, 15, 20, 25, 30, 35, 40, 60, 100]
POINTS = [1, 10, 40, 100]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", [(4, 64, 96), (2, 32, 32)])
def test_dwt53_equals_tpukit_and_round_trips(rng, shape):
    x = rng.integers(-32768, 32768, shape).astype(np.int32)
    x[0, :3] = -32768                            # int16 extremes
    x[-1, -3:] = 32767
    want = np.asarray(jdwt.dwt2(jnp.asarray(x), "53", 5))
    got = tdwt.dwt2(_t(x), "53", 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = tdwt.idwt2(got, "53", 5).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jdwt.idwt2(jnp.asarray(want), "53", 5)))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("J,rsi", [(64, 2), (32, 8)])
def test_encode_size_rows_equals_vmapped_encode_size(rng, J, rsi):
    n = 4096
    x = np.zeros((5, n), np.int32)
    x[0] = rng.integers(0, 65536, n)                            # dense
    x[1] = rng.integers(0, 300, n) * (rng.random(n) < 0.02)     # mostly zero
    x[3] = 65535                                                # all-65535
    x[4] = rng.integers(0, 40, n) * (rng.random(n) < 0.3)
    x[4, 2 * J * rsi:6 * J * rsi] = 0                           # long runs
    want = np.asarray(jax.vmap(lambda v: jck.encode_size(
        v, bits=16, J=J, rsi=rsi, preprocess=False))(
            jnp.asarray(x.astype(np.uint16))))
    got = tck.encode_size_rows(_t(x), 16, J, rsi)
    assert got.numpy().tolist() == want.tolist()


def _sparse(rng, shape, density, hi):
    v = rng.integers(-hi, hi + 1, shape) * (rng.random(shape) < density)
    return v.astype(np.int32)


def _regime(rng, name, n):
    if name == "dense":
        return _sparse(rng, (4, n), 0.9, 300)
    if name == "sparse":                        # nnz * 32 < n: J=32, RSI=8
        q = _sparse(rng, (4, n), 0.01, 50)
        q[3] = 0
        return q
    q = _sparse(rng, (4, n), 0.5, 1 << 20)      # beyond int16: split / bpc
    q[1, :5] = [-(1 << 31), (1 << 31) - 1, 1 << 30, -(1 << 30), 65536]
    q[2] = _sparse(rng, (n,), 0.4, 40000)
    return q


@pytest.mark.parametrize("name", ["dense", "sparse", "over_int16"])
def test_wenc_size_bytes_exact(rng, name):
    segb = jwc.subband_seg_bounds(64, 96, 5)
    q = _regime(rng, name, 64 * 96)
    want = np.asarray(jj2k.wenc_size_bytes(jnp.asarray(q), segb))
    got = tj2k.wenc_size_bytes(_t(q), segb)
    assert got.numpy().tolist() == want.tolist()


def test_wenc_size_bytes_exact_off_the_rice_block_grid(rng):
    q = _sparse(rng, (3, 1000), 0.3, 300)            # 1000 % 64 != 0
    q[2, 7] = 50000
    want = np.asarray(jj2k.wenc_size_bytes(jnp.asarray(q)))
    assert tj2k.wenc_size_bytes(_t(q)).numpy().tolist() == want.tolist()


def test_quantize_saturates_as_xla():
    x = np.array([1e10, -1e10, 3e9, -3e9, np.nan, np.inf, -np.inf,
                  2147483520.0, 2147483648.0, -2147483648.0, 1.7, -1.7, 0.0],
                 np.float32)
    want = np.asarray(jnp.trunc(jnp.asarray(x)).astype(jnp.int32))
    got = tj2k.quantize(_t(x), 1.0)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()


@pytest.fixture(scope="module")
def coefs_case():
    """tpukit's 9/7 coefficients of a padded 4×50×70 12-in-16 tile (to
    64×96), its step maps and a quality ladder, as numpy."""
    rng = np.random.default_rng(11)
    gy, gx = np.mgrid[0:50, 0:70]
    base = (800 + 25 * gy + 15 * gx) % 4096
    cube = (np.clip(base[None] + rng.integers(-400, 400, (4, 50, 70)), 0,
                    4095).astype(np.uint16) << 4)
    work, H0, W0 = jwc.pad_to_multiple(cube.astype(np.float32), 32)
    coefs = np.asarray(jdwt.dwt2(jnp.asarray(work), "97", 5))
    Hp, Wp = work.shape[-2:]
    order = jwc.scan_order(Hp, Wp, 5)
    scale = jj2k._subband_steps(Hp, Wp, 1.0)
    inv_scale = np.float32(1.0) / scale
    peak = float(cube.max())
    bases = np.array([jj2k.base_step_for_quality(q, peak) for q in POINTS],
                     np.float32)
    return dict(cube=cube, coefs=coefs, H0=H0, W0=W0, order=order,
                segb=jwc.subband_seg_bounds(Hp, Wp, 5), scale=scale,
                inv_scale=inv_scale,
                inv_scale_perm=np.ascontiguousarray(inv_scale.ravel()[order]),
                bases=bases, inv_bases=np.float32(1.0) / bases)


def test_ladder_sizes_equal_tpukit(coefs_case):
    c = coefs_case
    want = np.asarray(jj2k._device_ladder_sizes(
        jnp.asarray(c["coefs"]), jnp.asarray(c["order"]),
        jnp.asarray(c["inv_scale_perm"]), jnp.asarray(c["inv_bases"]),
        segbounds=c["segb"]))
    got = tj2k.ladder_sizes(_t(c["coefs"]), _t(c["order"]),
                            _t(c["inv_scale_perm"]), c["inv_bases"],
                            c["segb"])
    assert got.shape == (len(POINTS), 4)
    assert got.numpy().tolist() == want.tolist()


def test_tiled_ladder_sizes_equal_tpukit(coefs_case):
    """Two tiles of one shape: the second is the first's negative and
    quarter, so the tiles size differently."""
    c = coefs_case
    nb = np.stack([c["coefs"], -0.25 * c["coefs"]]).astype(np.float32)
    want = np.asarray(jj2k._tiled_ladder_sizes(
        jnp.asarray(nb), jnp.asarray(c["order"]),
        jnp.asarray(c["inv_scale_perm"]), jnp.asarray(c["inv_bases"]),
        segbounds=c["segb"]))
    got = tj2k.tiled_ladder_sizes(_t(nb), _t(c["order"]),
                                  _t(c["inv_scale_perm"]), c["inv_bases"],
                                  c["segb"])
    assert got.shape == (2, len(POINTS), 4)
    assert got.numpy().tolist() == want.tolist()


def test_lossless_sizes_equal_tpukit(coefs_case):
    c = coefs_case
    work, _, _ = jwc.pad_to_multiple(c["cube"].astype(np.int32) >> 4, 32)
    coefs = np.asarray(jdwt.dwt2(jnp.asarray(work), "53", 5))
    want = np.asarray(jj2k._device_lossless_sizes(
        jnp.asarray(coefs), jnp.asarray(c["order"]), segbounds=c["segb"]))
    got = tj2k.lossless_sizes(_t(coefs), _t(c["order"]), c["segb"])
    assert got.numpy().tolist() == want.tolist()


def test_requant_recon_ladder_checksums_exact_recons_within_1dn(coefs_case):
    c = coefs_case
    rj, s1j, s2j = jj2k._device_requant_recon_ladder(
        jnp.asarray(c["coefs"]), jnp.asarray(c["inv_scale"]),
        jnp.asarray(c["scale"]), jnp.asarray(c["inv_bases"]),
        jnp.asarray(c["bases"]), 5, c["H0"], c["W0"], 0, 65535, "uint16")
    rt, s1t, s2t = tj2k.requant_recon_ladder(
        _t(c["coefs"]), _t(c["inv_scale"]), _t(c["scale"]), c["inv_bases"],
        c["bases"], 5, c["H0"], c["W0"], 0, 65535, torch.uint16)
    assert s1t.numpy().tolist() == np.asarray(s1j).tolist()
    assert s2t.numpy().tolist() == np.asarray(s2j).tolist()
    assert rt.dtype == torch.uint16 and rt.shape == (len(POINTS), 4, 50, 70)
    diff = np.abs(rt.numpy().astype(np.int32)
                  - np.asarray(rj).astype(np.int32))
    assert diff.max() <= 1


@pytest.mark.parametrize("target", [3000.0, 1e12])
def test_fit_base_equals_tpukit(coefs_case, target):
    """A reachable byte target, and one above every size, which drives the
    bisection down to steps of 1e-3; there the coefficients, scaled by 4,
    saturate the quantizer."""
    c = coefs_case
    gain = np.float32(4.0 if target > 1e9 else 1.0)
    perm = np.ascontiguousarray(
        gain * c["coefs"].reshape(4, -1)[:, c["order"]])
    perm_scale = np.ascontiguousarray(c["scale"].ravel()[c["order"]])
    want = np.asarray(jj2k._fit_base_device(
        jnp.asarray(perm), jnp.asarray(perm_scale), jnp.float32(target),
        segbounds=c["segb"]))
    got = tj2k.fit_base(_t(perm), _t(perm_scale), target,
                        segbounds=c["segb"])
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()
    if target > 1e9:
        assert float(got) < 2e-3
        q = tj2k.quantize(_t(perm), (1.0 / _t(perm_scale)) * (1.0 / got))
        assert int(q.max()) == 2 ** 31 - 1      # the saturated range


def test_ladder_sizes_light_unchanged_by_the_saturating_quantizer(rng):
    """The light pricing ladder at bench.py's qualities gives what the
    plain truncating cast gave before the shared quantizer."""
    gy, gx = np.mgrid[0:64, 0:64]
    base = (800 + 25 * gy + 15 * gx) % 4096
    cube = (np.clip(base[None] + rng.integers(-400, 400, (4, 64, 64)), 0,
                    4095).astype(np.uint16) << 4)
    coefs = tdwt.dwt2(_t(cube.astype(np.float32)), "97", 5)
    order = twc.scan_order(64, 64, 5)
    segb = twc.subband_seg_bounds(64, 64, 5)
    inv_scale_perm = _t((np.float32(1.0) / tj2k._subband_steps(64, 64, 1.0))
                        .ravel()[order])
    inv_bases = np.float32(1.0) / np.array(
        [tj2k.base_step_for_quality(q, float(cube.max())) for q in LADDER],
        np.float32)
    got = tj2k.ladder_sizes_light(coefs, _t(order), inv_scale_perm,
                                  inv_bases, segb)
    perm = coefs.reshape(4, -1)[:, _t(order)]
    before = torch.stack([tj2k.wenc_size_bytes_light(
        torch.trunc(perm * (inv_scale_perm * float(ib))).to(torch.int32),
        segb) for ib in inv_bases])
    assert got.numpy().tolist() == before.numpy().tolist()
