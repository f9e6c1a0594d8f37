# -*- coding: utf-8 -*-
"""The port's bit-depth ops against tpukit's, exactly.

``RangeScan`` over row strips equals tpukit's scan and
``effective_data_range`` of the whole cube (uint16, int16, uint8, with and
without the bit packing that the heuristics look for). ``to_12in16`` and
``trunc_klsb`` equal tpukit's on numpy arrays and on tensors (tpukit's on
JAX arrays), negative int16 and the top of the uint16 range included, for
k = 0..4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.io import bitdepth as jbd
from tpukit_torch.io import bitdepth as tbd


def _cubes(rng):
    return {
        "uint16_12in16": rng.integers(0, 4096, (3, 40, 24)).astype(np.uint16)
        << 4,
        "uint16_raw": rng.integers(0, 65536, (3, 40, 24)).astype(np.uint16),
        "int16_14in16": ((rng.integers(-8192, 8192, (3, 40, 24))
                          .astype(np.int16).view(np.uint16) >> 2) << 2)
        .view(np.int16),
        "int16_wide": rng.integers(-32768, 32768, (3, 40, 24))
        .astype(np.int16),
        "int16_positive": rng.integers(0, 3000, (3, 40, 24))
        .astype(np.int16) * 4,
        "uint8": rng.integers(0, 256, (3, 40, 24)).astype(np.uint8),
    }


@pytest.mark.parametrize("kind", ["uint16_12in16", "uint16_raw",
                                  "int16_14in16", "int16_wide",
                                  "int16_positive", "uint8"])
@pytest.mark.parametrize("rows", [1, 7, 16, 40])
def test_range_scan_equals_tpukit_and_whole_cube(rng, kind, rows):
    cube = _cubes(rng)[kind]
    name = str(cube.dtype)
    t, j = tbd.RangeScan(name), jbd.RangeScan(name)
    for y0 in range(0, cube.shape[1], rows):
        t.update(cube[:, y0:y0 + rows])
        j.update(cube[:, y0:y0 + rows])
    t.update(cube[:, :0])                       # an empty strip is a no-op
    assert (t.mn, t.mx, t.lsb_or) == (j.mn, j.mx, j.lsb_or)
    assert t.result() == j.result() == \
        tbd.effective_data_range(cube, name) == \
        jbd.effective_data_range(cube, name)


def test_range_scan_of_nothing_equals_tpukit():
    for name in ("uint16", "int16", "uint8", "int32", "float32", "bogus"):
        assert tbd.RangeScan(name).result() == jbd.RangeScan(name).result()


def _edge_uint16(rng):
    x = rng.integers(0, 65536, 4096).astype(np.uint16)
    x[:16] = [0, 7, 8, 15, 16, 23, 24, 65519, 65520, 65527, 65528, 65529,
              65534, 65535, 32767, 32768]
    return x


def test_to_12in16_equals_tpukit(rng):
    x = _edge_uint16(rng)
    want = np.asarray(jbd.to_12in16(jnp.asarray(x)))
    np.testing.assert_array_equal(jbd.to_12in16(x), want)
    np.testing.assert_array_equal(tbd.to_12in16(x), want)
    got = tbd.to_12in16(torch.from_numpy(x))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    # int32 ring values (the port's carrier of 16-bit samples) give the same
    ring = torch.from_numpy(x.astype(np.int32))
    np.testing.assert_array_equal(tbd.to_12in16(ring).numpy(), want)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.int16, np.uint16])
def test_trunc_klsb_equals_tpukit(rng, k, dtype):
    if dtype == np.int16:
        x = rng.integers(-32768, 32768, 4096).astype(np.int16)
        x[:6] = [-32768, -32767, -5, -1, 0, 32767]
    else:
        x = _edge_uint16(rng)
    want = np.asarray(jbd.trunc_klsb(jnp.asarray(x), k))
    np.testing.assert_array_equal(jbd.trunc_klsb(x, k), want)
    got_np = tbd.trunc_klsb(x, k)
    assert got_np.dtype == x.dtype
    np.testing.assert_array_equal(got_np, want)
    got = tbd.trunc_klsb(torch.from_numpy(x), k)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.any(want.view(np.uint16) & ((1 << k) - 1))
