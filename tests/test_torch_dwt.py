# -*- coding: utf-8 -*-
"""tpukit_torch's 9/7 DWT against tpukit's, on the CPU.

The port's plain ``dwt2`` follows a rounding contract (three separately
rounded float32 ops per lifting step, scaling by K and float32(1/K)) that
makes it bit-equal across the CPU and CUDA, and kernel K2 bit-equal to it
on the card. tpukit's jnp transform is compiled by XLA:CPU, which contracts
the lifting into FMAs and rewrites the scaling, so the two agree to f32
round-off: max abs error <= 1e-5 * max|coef| (6.9e-7 relative was measured
on a 12-in-16 (4, 1024, 1024) tile at 5 levels). The same holds against
tpukit's Pallas kernel ``dwt2_pallas`` run in interpret mode."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.codecs import j2k_codec as jj2k
from tpukit.kernels import dwt as jdwt
from tpukit.kernels.dwt_pallas import dwt2_pallas
from tpukit_torch.codecs import j2k_codec as tj2k
from tpukit_torch.kernels import dwt as tdwt
from tpukit_torch.kernels.dwt97 import dwt97, dwt97_ref

torch.set_num_threads(2)        # xdist workers share the host

REPO = Path(__file__).resolve().parent.parent
CASES = [((4, 64, 64), 5), ((3, 96, 160), 5), ((2, 32, 48), 3)]


def _tile(rng, shape) -> np.ndarray:
    """A 12-in-16 uint16 stack: a smooth ramp plus noise, shifted left 4."""
    B, H, W = shape
    gy, gx = np.mgrid[0:H, 0:W]
    base = (800 + 25 * gy + 15 * gx) % 4096
    t = np.clip(base[None] + rng.integers(-400, 400, shape), 0, 4095)
    return (t.astype(np.uint16) << 4).astype(np.float32)


@pytest.mark.parametrize("shape,levels", CASES)
def test_dwt2_matches_tpukit_jnp_and_pallas(rng, shape, levels):
    x = _tile(rng, shape)
    got = tdwt.dwt2(torch.from_numpy(x), "97", levels).numpy()
    want = np.asarray(jdwt.dwt2(jnp.asarray(x), "97", levels))
    pallas = np.asarray(dwt2_pallas(jnp.asarray(x), levels, interpret=True))
    tol = 1e-5 * np.abs(want).max()
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - pallas).max() <= tol


@pytest.mark.parametrize("shape,levels", CASES)
def test_idwt2_round_trips(rng, shape, levels):
    x = _tile(rng, shape)
    c = tdwt.dwt2(torch.from_numpy(x), "97", levels)
    back = tdwt.idwt2(c, "97", levels).numpy()
    # f32 round-off through 2 x levels lifting passes on values < 2^16
    assert np.abs(back - x).max() <= 1e-5 * np.abs(x).max()
    want = np.asarray(jdwt.idwt2(jnp.asarray(c.numpy()), "97", levels))
    assert np.abs(back - want).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("H,W,levels", [(64, 64, 5), (96, 160, 5),
                                        (1024, 1024, 5), (32, 48, 3)])
def test_subband_slices_equal_tpukit(H, W, levels):
    assert tdwt.subband_slices(H, W, levels) == \
        jdwt.subband_slices(H, W, levels)


def test_subband_norms_match_tpukit():
    got, want = tj2k._subband_norms(5), jj2k._subband_norms(5)
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        assert abs(got[name] - v) <= 1e-6 * v, name


def test_dwt97_on_the_cpu_is_the_plain_version(rng):
    x = torch.from_numpy(_tile(rng, (2, 64, 96)))
    before = dwt97.launches
    assert torch.equal(dwt97(x, 5), dwt97_ref(x, 5))
    assert torch.equal(dwt97_ref(x, 5), tdwt.dwt2(x, "97", 5))
    assert dwt97.launches == before


def test_kernel_constants_are_the_plain_versions():
    """K2's float32 lifting constants (hex literals in csrc/dwt97.cu) equal
    the plain version's: a different rounding of one constant would break
    the kernel's bit-equality on the card."""
    src = (REPO / "tpukit_torch" / "csrc" / "dwt97.cu").read_text()
    lits = dict(re.findall(r"constexpr float (k\w+) = (-?0x[0-9a-f.]+p[-+]\d+)f;",
                           src))
    want = {"kA": tdwt.A97, "kB": tdwt.B97, "kG": tdwt.G97, "kD": tdwt.D97,
            "kK": tdwt.K97, "kIK": tdwt.IK97}
    assert {k: float.fromhex(v) for k, v in lits.items()} == want
    assert tdwt.IK97 == float(np.float32(1.0 / jdwt._K97))
    assert tdwt.A97 == float(np.float32(jdwt._A97))


def test_other_kinds_and_sizes_raise():
    """Every kind tpukit has runs (the 9/7M too, held to tpukit's in
    tests/test_torch_dwt97m.py); an unknown one and a size off the level
    grid raise."""
    x = torch.zeros((1, 64, 64))
    for kind in sorted(jdwt._FWD):
        assert tuple(tdwt.dwt2(x, kind, 3).shape) == (1, 64, 64)
    assert sorted(tdwt._FWD) == sorted(jdwt._FWD)
    with pytest.raises(ValueError, match="97m"):
        tdwt.dwt2(x, "haar", 3)
    with pytest.raises(ValueError, match="divisible"):
        tdwt.dwt2(torch.zeros((1, 48, 64)), "97", 5)
