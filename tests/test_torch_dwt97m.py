# -*- coding: utf-8 -*-
"""The integer 9/7M DWT (CCSDS 122.0-B 3.3) of tpukit_torch against
tpukit's, on the CPU, exact.

tpukit rounds its two lifting steps in float32; the port computes them in
integers (``(9*(s+s_r) - (s_l+s_rr) + 8) >> 4`` and ``(2 - (d_l+d)) >> 2``).
The two must give the same int32 over the full uint16 and int16 ranges at 3
levels: uniform noise over the whole range, constant planes at both ends,
checkerboards and stripes between the extremes, on shapes whose half sizes
are odd after the first level (40x56), on the smallest plane (8x8, where a
level's low-pass row holds one sample) and on a square one. Tolerance: none
(``torch.equal`` / ``array_equal``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.kernels import dwt as jdwt
from tpukit_torch.kernels import dwt as tdwt

torch.set_num_threads(2)        # xdist workers share the host

SHAPES = [(3, 40, 56), (2, 8, 8), (2, 64, 64)]
RANGES = {"uint16": (0, 65535), "int16": (-32768, 32767)}
KINDS = ["noise", "low", "high", "checker", "stripes", "sparse"]


def _plane(kind: str, dtype: str, shape, seed: int) -> np.ndarray:
    lo, hi = RANGES[dtype]
    rng = np.random.default_rng(seed)
    if kind == "noise":
        x = rng.integers(lo, hi + 1, shape)
        x[0, :2] = lo                            # both extremes present
        x[-1, -2:] = hi
    elif kind in ("low", "high"):
        x = np.full(shape, lo if kind == "low" else hi)
    elif kind == "checker":
        gy, gx = np.mgrid[0:shape[1], 0:shape[2]]
        x = np.broadcast_to(np.where((gy + gx) % 2, hi, lo), shape).copy()
    elif kind == "stripes":
        gx = np.arange(shape[2])
        x = np.broadcast_to(np.where((gx // 3) % 2, hi, lo), shape).copy()
    else:
        x = np.where(rng.random(shape) < 0.05,
                     rng.integers(lo, hi + 1, shape), 0)
    return x.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", sorted(RANGES))
@pytest.mark.parametrize("kind", KINDS)
def test_forward_97m_equals_tpukit(kind, dtype, shape):
    x = _plane(kind, dtype, shape, 7)
    want = np.asarray(jdwt.dwt2(jnp.asarray(x), "97m", 3))
    got = tdwt.dwt2(_t(x), "97m", 3)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    # far below the magnitude where float32 would round tpukit's terms
    assert int(np.abs(want).max()) < 1 << 18


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", sorted(RANGES))
@pytest.mark.parametrize("kind", KINDS)
def test_inverse_97m_equals_tpukit_and_round_trips(kind, dtype, shape):
    x = _plane(kind, dtype, shape, 11)
    coefs = tdwt.dwt2(_t(x), "97m", 3)
    back = tdwt.idwt2(coefs, "97m", 3)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jdwt.idwt2(jnp.asarray(coefs.numpy()), "97m", 3)))


@pytest.mark.parametrize("levels", [1, 2])
def test_97m_other_depths_equal_tpukit(rng, levels):
    x = rng.integers(-32768, 65536, (2, 24, 20)).astype(np.int32)
    want = np.asarray(jdwt.dwt2(jnp.asarray(x), "97m", levels))
    got = tdwt.dwt2(_t(x), "97m", levels)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tdwt.idwt2(got, "97m", levels), _t(x))


def test_97m_inverse_of_truncated_coefficients_equals_tpukit(rng):
    """The decoder's case: coefficients that are no transform of anything
    (midpoint-filled, some zeroed)."""
    c = rng.integers(-40000, 40000, (3, 40, 56)).astype(np.int32)
    c[rng.random(c.shape) < 0.5] = 0
    want = np.asarray(jdwt.idwt2(jnp.asarray(c), "97m", 3))
    np.testing.assert_array_equal(tdwt.idwt2(_t(c), "97m", 3).numpy(), want)


def test_97m_takes_integer_inputs_of_any_width_and_leaves_them(rng):
    x16 = rng.integers(0, 65536, (2, 16, 24)).astype(np.uint16)
    x = _t(x16.astype(np.int32))
    keep = x.clone()
    got = tdwt.dwt2(_t(x16.astype(np.int64)), "97m", 3)
    assert got.dtype == torch.int32
    assert torch.equal(got, tdwt.dwt2(x, "97m", 3))
    assert torch.equal(x, keep)


def test_dwt_kinds_and_shapes_are_checked():
    x = torch.zeros((1, 16, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="97m"):
        tdwt.dwt2(x, "haar", 3)
    with pytest.raises(ValueError, match="divisible"):
        tdwt.dwt2(torch.zeros((1, 12, 16), dtype=torch.int32), "97m", 3)
