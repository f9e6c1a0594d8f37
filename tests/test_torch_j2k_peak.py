"""The J2K codec's quantizer peak, ``j2k_codec._cube_peak``, against
tpukit's expression (``tpukit/codecs/j2k_codec.py:1396``)::

    peak = float(np.abs(cube.astype(np.float64)).max()) or 1.0

The port takes min and max in the cube's own dtype and widens them to
Python numbers before ``abs``; the float must be tpukit's bit for bit for
every integer dtype the codec takes, the extremes of the signed ones
included (int16's -32768 wraps under a native-dtype ``np.abs``). A tiled
device sweep with tpukit's expression patched in must give the same bytes
and recons. CPU only, no subprocess."""

from pathlib import Path

import numpy as np
import pytest

from tpukit_torch.codecs import j2k_codec as tj2k
from tpukit_torch.codecs.base import RateSpec

TPUKIT_J2K = Path(__file__).resolve().parents[1] / "tpukit/codecs/j2k_codec.py"
EXPR = "float(np.abs(cube.astype(np.float64)).max()) or 1.0"


def tpukit_peak(cube: np.ndarray) -> float:
    return float(np.abs(cube.astype(np.float64)).max()) or 1.0


def test_expression_is_tpukits():
    line = TPUKIT_J2K.read_text().splitlines()[1395]
    assert line.strip() == f"peak = {EXPR}"


def _random(dtype, seed):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    return rng.integers(info.min, info.max, (3, 17, 29), dtype=dtype,
                        endpoint=True)


def _extremes(dtype, values):
    cube = np.zeros((2, 5, 7), dtype)
    cube.flat[[3, 41][:len(values)]] = values
    return cube


CASES = {
    **{f"random_{np.dtype(d).name}_{s}": (lambda d=d, s=s: _random(d, s))
       for d in (np.uint8, np.uint16, np.int16, np.int32) for s in (0, 1)},
    "random_12in16": lambda: (np.random.default_rng(3).integers(
        0, 4096, (4, 40, 50)).astype(np.uint16) << 4),
    **{f"zero_{np.dtype(d).name}": (lambda d=d: np.zeros((2, 3, 4), d))
       for d in (np.uint8, np.uint16, np.int16, np.int32)},
    "int16_min": lambda: _extremes(np.int16, [-32768]),
    "int16_max": lambda: _extremes(np.int16, [32767]),
    "int16_min_max": lambda: _extremes(np.int16, [-32768, 32767]),
    "int16_negative_only": lambda: _extremes(np.int16, [-5, -32767]),
    "int32_min": lambda: _extremes(np.int32, [-2**31]),
    "int32_min_max": lambda: _extremes(np.int32, [-2**31, 2**31 - 1]),
    "uint16_max": lambda: _extremes(np.uint16, [65535]),
    "single_uint16": lambda: np.full((1, 1, 1), 4080, np.uint16),
    "single_int16_min": lambda: np.full((1, 1, 1), -32768, np.int16),
    "single_zero": lambda: np.zeros((1, 1, 1), np.int16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cube_peak_is_tpukits_float(case):
    cube = CASES[case]()
    want = tpukit_peak(cube)
    got = tj2k._cube_peak(cube)
    assert type(got) is float
    assert got == want, (case, got, want)
    if not cube.any():
        assert got == 1.0


def test_tiled_device_sweep_unchanged(monkeypatch):
    """A tiled device sweep of a 12-in-16 cube with edge tiles: bytes and
    recons with ``_cube_peak`` equal those with tpukit's expression."""
    rng = np.random.default_rng(11)
    cube = (rng.integers(0, 4096, (2, 80, 96)).astype(np.uint16) << 4)
    specs = [RateSpec.of("quality", q) for q in (10, 40, 90)]
    codec = tj2k.J2KCodec(tilex=64, tiley=64, entropy="device")

    def sweep():
        return codec._sweep_tiled_device(cube, "uint16", specs, [0, 1, 2],
                                         64, 64, device="cpu")

    got = sweep()
    monkeypatch.setattr(tj2k, "_cube_peak", tpukit_peak)
    want = sweep()
    for g, w in zip(got, want):
        assert g.bitstream_bytes == w.bitstream_bytes
        assert g.recon.dtype == w.recon.dtype
        assert np.array_equal(g.recon.numpy(), w.recon.numpy())
        assert g.extras == w.extras
