# -*- coding: utf-8 -*-
"""Tile complexity on the port against tpukit's (tpukit/analysis/
complexity.py), on the same seeded tiles, the port on the CPU.

Tolerances: the counts exact (the radial bins ``Cnt`` with the port's own
frequency grid, the 2-D gradient histogram ``H2`` given tpukit's clip
``lim``); ``ps_median``'s midpoint and ``lim``'s float32-position
percentile equal to jnp.median's and jnp.percentile's on the same data, or
one ulp apart where XLA:CPU contracts ``lo·(1-f) + hi·f`` into an FMA;
``grad_mean``/``grad_std`` within rel 1e-5 and the spectral metrics and
``delentropy_bits`` within rel 1e-4 (XLA:CPU's FFT against pocketfft,
float32 sums in another order). Then tpukit's own checks
(tests/test_complexity.py) on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.analysis import complexity as jcx
from tpukit_torch.analysis import complexity as tcx

torch.set_num_threads(2)        # xdist workers share the host

EXACT = ("bands", "width", "height")
REL_GRAD = 1e-5
REL = 1e-4


def _tile(case: str):
    """(cube, nodata) of a named seeded case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "flat":
        return np.full((2, 32, 32), 500.0, np.float32), None
    if case in ("hc", "lc"):          # tests/test_complexity.py's pair
        gy, gx = np.mgrid[0:64, 0:64]
        if case == "lc":
            return ((1000.0 + 3.0 * gy + 2.0 * gx)[None]
                    * np.ones((3, 1, 1))).astype(np.float32), None
        return rng.integers(0, 4096, (3, 64, 64)).astype(np.float32), None
    shape = {"4x64x64": (4, 64, 64), "4x64x96": (4, 64, 96),
             "odd_3x63x65": (3, 63, 65)}[case.replace("_nodata", "")]
    B, H, W = shape
    gy, gx = np.mgrid[0:H, 0:W]
    base = 1500 * np.sin(gy / 5.0) * np.cos(gx / 9.0) + 2000
    cube = np.stack([base + rng.normal(0, 60, (H, W)) for _ in range(B)])
    cube = cube.clip(1, 4095).astype(np.float32)
    if case.endswith("_nodata"):
        cube[:, :6, :9] = 0
        cube[:, -3:, 20:31] = 0
        return cube, 0.0
    return cube, None


CASES = ["4x64x64", "4x64x64_nodata", "4x64x96", "4x64x96_nodata",
         "odd_3x63x65", "flat", "hc", "lc"]


def _metrics_close(got, want):
    """The tolerances above. ``grad_std`` is taken about ``grad_mean``, so
    its float32 round-off is that of the mean: on a tile whose gradient is
    constant (the LC ramp) the std is round-off alone, and it is held
    within rel 1e-5 of ``grad_mean``'s scale."""
    assert sorted(got) == sorted(want)
    for k in want:
        rel = REL_GRAD if k.startswith("grad_") else REL
        scale = max(abs(want[k]), abs(want["grad_mean"])) \
            if k == "grad_std" else abs(want[k])
        assert got[k] == want[k] or abs(got[k] - want[k]) <= \
            rel * max(scale, 1e-30), (k, got[k], want[k])


@pytest.mark.parametrize("case", CASES)
def test_metrics_equal_tpukit(case):
    cube, nodata = _tile(case)
    want = jcx.compute_all_arrays(cube, nodata=nodata)
    got = tcx.compute_all_arrays(cube, nodata=nodata, device="cpu")
    _metrics_close(got, want)


def test_compute_all_reads_the_file(tmp_path):
    from tpukit.io import tiff
    cube, nodata = _tile("4x64x96_nodata")
    p = tmp_path / "t.tif"
    tiff.write_geotiff(p, cube.astype(np.uint16), nodata=nodata)
    want = jcx.compute_all(p)
    got = tcx.compute_all(p, device="cpu")
    for k in EXACT + ("path",):
        assert got[k] == want[k], k
    _metrics_close(*({k: v for k, v in m.items() if k not in EXACT + ("path",)}
                     for m in (got, want)))


def _jax_radial_counts(H: int, W: int, nb: int = 256) -> np.ndarray:
    """tpukit's radial bin counts (complexity.py:86-100), jitted as
    tpukit's program is."""
    def counts():
        fy = jnp.fft.fftfreq(H)
        fx = jnp.fft.fftfreq(W)
        R = jnp.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
        binw = jnp.max(R) / nb
        idx = jnp.clip(jnp.ceil(R / jnp.maximum(binw, 1e-12))
                       .astype(jnp.int32) - 1, 0, nb - 1)
        return jax.ops.segment_sum(jnp.ones(H * W), idx.ravel(), nb)
    return np.asarray(jax.jit(counts)()).astype(np.int64)


@pytest.mark.parametrize("shape", [(64, 64), (64, 96), (63, 65), (100, 100),
                                   (1000, 1000), (1000, 777)])
def test_radial_bin_counts_are_exact(shape):
    _, _, _, cnt = tcx._radial_bins(*shape, 256, "cpu")
    np.testing.assert_array_equal(cnt.numpy(), _jax_radial_counts(*shape))


def _ulps(a, b) -> int:
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


@pytest.mark.parametrize("n", [4096, 4095, 6144, 12288, 99, 2])
def test_median_and_percentile_equal_jax(n):
    """``ps_median``: torch.quantile's midpoint equals jnp.median for even
    and odd counts; ``lim``: the float32-position percentile equals
    jnp.percentile(…, 99) or is one ulp from it. Both jitted with the
    percentile traced, as tpukit's program runs them."""
    median = jax.jit(jnp.median)
    percentile = jax.jit(jnp.percentile)
    rng = np.random.default_rng(n)
    for trial in range(20):
        x = np.abs(rng.normal(0, 1e3, n) ** 3).astype(np.float32)
        if trial % 2:
            x = np.round(x)                          # ties, as |∇| has
        want = np.float32(median(jnp.asarray(x)))
        got = np.float32(torch.quantile(torch.from_numpy(x), 0.5,
                                        interpolation="midpoint"))
        assert got == want, (n, trial)
        for pct in (99.0, 50.0, 12.5):
            want = np.float32(percentile(jnp.asarray(x), pct))
            got = np.float32(tcx._percentile_linear(torch.from_numpy(x),
                                                    pct))
            assert _ulps(got, want) <= 1, (n, trial, pct, got, want)


@jax.jit
def _jax_gray_grads(a, v):
    """tpukit's delentropy inputs (complexity.py:121-129) of a cube and its
    validity plane: the gradients of the per-pixel max band and the clip
    lim, jitted as tpukit's program is."""
    gray = jnp.max(jnp.where(v[None], a, -jnp.inf), axis=0)
    vf = v.astype(jnp.float32)
    gmean2 = jnp.sum(jnp.where(v, gray, 0.0) * vf) / jnp.maximum(
        jnp.sum(vf), 1.0)
    gray = jnp.where(v, gray, gmean2)
    Gx, Gy = jcx.finite_diff_grad(gray)
    absg = jnp.concatenate([jnp.abs(Gx).ravel(), jnp.abs(Gy).ravel()])
    lim = jnp.percentile(absg, 99.0)
    return Gx, Gy, jnp.where(lim > 0, lim, 1.0)


def _jax_histogram(Gx, Gy, lim, bins=256):
    """tpukit's 2-D gradient histogram (complexity.py:130-141)."""
    gxc = jnp.clip(Gx.ravel(), -lim, lim)
    gyc = jnp.clip(Gy.ravel(), -lim, lim)
    scale = bins / (2 * lim)
    bi = jnp.clip(((gxc + lim) * scale).astype(jnp.int32), 0, bins - 1)
    bj = jnp.clip(((gyc + lim) * scale).astype(jnp.int32), 0, bins - 1)
    return np.asarray(jax.ops.segment_sum(
        jnp.ones_like(gxc), bi * bins + bj, bins * bins)).astype(np.int64)


@pytest.mark.parametrize("case", ["4x64x64", "4x64x96_nodata",
                                  "odd_3x63x65", "hc"])
def test_gradient_histogram_is_exact_with_tpukits_lim(case):
    """The port's histogram of tpukit's gradients with tpukit's lim equals
    tpukit's count for count. Without nodata the port's own gradients are
    tpukit's and its own lim is tpukit's or one ulp from it (with nodata
    the fill value of the invalid pixels is a float32 mean, summed in
    another order)."""
    cube, nodata = _tile(case)
    valid = ((cube != nodata).all(0) if nodata is not None
             else np.ones(cube.shape[1:], bool))
    Gx, Gy, lim = _jax_gray_grads(jnp.asarray(cube), jnp.asarray(valid))
    want = _jax_histogram(Gx, Gy, lim)
    H2, _ = tcx._delentropy(torch.from_numpy(np.array(Gx)),
                            torch.from_numpy(np.array(Gy)),
                            torch.tensor(np.float32(lim)), 256)
    np.testing.assert_array_equal(H2.numpy(), want)
    if nodata is not None:
        return
    tGx, tGy = tcx.finite_diff_grad(_port_gray(cube, nodata))
    np.testing.assert_array_equal(tGx.numpy(), np.asarray(Gx))
    np.testing.assert_array_equal(tGy.numpy(), np.asarray(Gy))
    absg = torch.cat([tGx.abs().reshape(-1), tGy.abs().reshape(-1)])
    assert _ulps(tcx._percentile_linear(absg, 99.0), lim) <= 1


def _port_gray(cube, nodata) -> torch.Tensor:
    """The port's per-pixel max band with the invalid pixels filled as
    ``_compute_device`` fills them."""
    valid = torch.from_numpy((cube != nodata).all(0) if nodata is not None
                             else np.ones(cube.shape[1:], bool))
    a = torch.from_numpy(cube)
    v = valid.to(torch.float32)
    gray = torch.where(valid[None], a, -torch.inf).amax(0)
    gmean2 = (torch.where(valid, gray, 0.0) * v).sum() / torch.clamp(
        v.sum(), min=1.0)
    return torch.where(valid, gray, gmean2)


def test_interp_equals_jnp_interp():
    """``mdf``'s interpolation: jnp.interp's searchsorted form, flat runs
    (empty radial bins) and both ends included."""
    xp = np.array([0.0, 1.0, 1.0, 1.0, 2.5, 4.0, 4.0, 7.0], np.float32)
    fp = np.linspace(0.1, 0.8, xp.size).astype(np.float32)
    for x in (-1.0, 0.0, 0.5, 1.0, 1.0000001, 2.0, 4.0, 5.5, 7.0, 9.0):
        want = np.float32(jnp.interp(jnp.float32(x), jnp.asarray(xp),
                                     jnp.asarray(fp)))
        got = np.float32(tcx._interp(torch.tensor(np.float32(x)),
                                     torch.from_numpy(xp),
                                     torch.from_numpy(fp)))
        assert _ulps(got, want) <= 1, (x, got, want)


def test_two_runs_give_the_same_bits():
    cube, nodata = _tile("4x64x96_nodata")
    a = tcx.compute_all_arrays(cube, nodata=nodata, device="cpu")
    b = tcx.compute_all_arrays(cube, nodata=nodata, device="cpu")
    assert a == b


# ---- tpukit's tests/test_complexity.py, on the port ----

def _port(arr, **kw):
    return tcx.compute_all_arrays(arr, device="cpu", **kw)


def test_hc_vs_lc_ordering(rng):
    """High-frequency tile must score higher on every complexity axis."""
    gy, gx = np.mgrid[0:64, 0:64]
    lc = (1000.0 + 3.0 * gy + 2.0 * gx)[None] * np.ones((3, 1, 1))
    hc = rng.integers(0, 4096, (3, 64, 64)).astype(float)
    mlc = _port(lc)
    mhc = _port(hc)
    assert mhc["grad_mean"] > mlc["grad_mean"]
    assert mhc["hf_ratio"] > mlc["hf_ratio"]
    assert mhc["delentropy_bits"] > mlc["delentropy_bits"]


def test_flat_tile_degenerate():
    m = _port(np.full((2, 32, 32), 500.0))
    assert m["grad_mean"] == 0.0
    assert m["hf_ratio"] == 0.0  # zero power -> zeroed metrics
    assert m["alpha"] == 0.0


def test_alpha_negative_slope(rng):
    """1/f-like image -> positive alpha (power decays with frequency)."""
    H = W = 64
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    r = np.sqrt(fy * fy + fx * fx)
    r[0, 0] = 1.0
    spec = (rng.normal(size=(H, W)) + 1j * rng.normal(size=(H, W))) / r
    img = np.real(np.fft.ifft2(spec))
    img = (img - img.min()) / (img.max() - img.min()) * 4000
    m = _port(img[None].astype(np.float32))
    assert m["alpha"] > 0.5


def test_gradient_matches_numpy(rng):
    arr = rng.integers(0, 100, (2, 16, 16)).astype(np.float32)
    m = _port(arr)

    def fd(img):
        gx = np.empty_like(img)
        gy = np.empty_like(img)
        gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) * 0.5
        gx[:, 0] = img[:, 1] - img[:, 0]
        gx[:, -1] = img[:, -1] - img[:, -2]
        gy[1:-1] = (img[2:] - img[:-2]) * 0.5
        gy[0] = img[1] - img[0]
        gy[-1] = img[-1] - img[-2]
        return np.hypot(gx, gy)
    mags = np.stack([fd(arr[b]) for b in range(2)])
    expect = np.max(mags, axis=0).mean()
    assert m["grad_mean"] == pytest.approx(expect, rel=1e-5)


def test_nodata_ignored(rng):
    arr = rng.integers(1, 100, (2, 32, 32)).astype(np.float32)
    arr2 = arr.copy()
    arr2[:, :8, :] = 0  # nodata region
    m_masked = _port(arr2, nodata=0)
    m_plain = _port(arr)
    assert 0 < m_masked["grad_mean"] < 3 * m_plain["grad_mean"]


def test_nodata_border_has_no_gradient():
    """Gradients touching nodata are excluded (a flat tile with a nodata
    border must not rank as high-complexity)."""
    flat = np.full((1, 64, 64), 1000.0, np.float32)
    bordered = flat.copy()
    bordered[:, :, :4] = -9999.0
    assert _port(flat)["grad_mean"] == 0.0
    assert _port(bordered, nodata=-9999.0)["grad_mean"] == 0.0
