# -*- coding: utf-8 -*-
"""tpukit_torch's CCSDS-121 encoder model against tpukit's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions and
their torch counterparts. Everything here is integer, so every comparison
is exact: the split-cost table (kernel K1's plain version against both JAX
forms, the Pallas kernel in interpret mode included), the per-block model,
the encode plan and its stream, and the flat stream that feeds it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpukit.codecs import ccsds121 as jdev
from tpukit.codecs.ccsds121_codec import _flat_stream_jit
from tpukit.kernels.diff1 import diff1_inverse as jdiff1_inverse
from tpukit.native import ccsds121_host as ck
from tpukit_torch.codecs import ccsds121 as tdev
from tpukit_torch.codecs.ccsds121_codec import flat_stream
from tpukit_torch.convert import PLAN_KEYS
from tpukit_torch.kernels.diff1 import diff1_forward, diff1_inverse
from tpukit_torch.kernels.fs_table import fs_table, fs_table_ref

torch.set_num_threads(2)        # xdist workers share the host


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))


def _mixed_stream(rng, bits: int, J: int, rsi: int) -> np.ndarray:
    """Random samples, a random walk, long zero runs that cross RSI and
    64-block segment boundaries, and a saturating run (all 2^bits - 1)."""
    top = (1 << bits) - 1
    seg = J * rsi
    parts = [
        rng.integers(0, top + 1, 5 * seg),
        np.cumsum(rng.integers(-5, 6, 4 * seg)) % (top + 1),
        np.zeros(3 * seg + 72 * J, np.int64),
        np.full(2 * seg, top),
        rng.integers(0, 4, 3 * seg) * (rng.random(3 * seg) < 0.1),
        np.zeros(J * 70, np.int64),
    ]
    x = np.concatenate(parts)
    x = x[:len(x) - len(x) % seg]
    return x.astype(np.uint16)


def test_fs_table_ref_matches_both_jax_forms(rng):
    """The plain table equals _fs_table_jnp and the Pallas kernel (interpret
    mode), for both block widths, an odd block count and saturating input."""
    for J, nb, top in ((8, 701, 65536), (16, 333, 65536), (8, 129, 1)):
        coded = rng.integers(0, top, (nb, J)).astype(np.int32)
        if top == 1:
            coded[:] = 65535
        want = np.asarray(jdev._fs_table_jnp(jnp.asarray(coded)))
        np.testing.assert_array_equal(
            np.asarray(jdev._fs_table_pallas(jnp.asarray(coded),
                                             interpret=True)), want)
        np.testing.assert_array_equal(fs_table_ref(_t(coded)).numpy(), want)
        before = fs_table.launches
        np.testing.assert_array_equal(fs_table(_t(coded)).numpy(), want)
        assert fs_table.launches == before      # CPU tensors launch nothing


def test_fs_table_rejects_other_devices():
    """Off the CPU the wrapper launches the CUDA kernel or raises; it never
    falls back to the plain version."""
    with pytest.raises(ValueError, match="unsupported device"):
        fs_table(torch.empty((4, 8), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("bits", [12, 14, 16])
@pytest.mark.parametrize("preprocess", [True, False])
def test_analyze_matches_tpukit(rng, bits, preprocess):
    """Per-block options and lengths, the stream's size and the outgoing
    split-k interval equal tpukit's, with the libaec geometry (J=8, rsi=2)
    and a long-RSI one (J=8, rsi=128) whose zero runs cross 64-block
    segments."""
    for J, rsi in ((8, 2), (8, 128)):
        x = _mixed_stream(rng, bits, J, rsi)
        want = jdev.analyze(jnp.asarray(x), bits=bits, J=J, rsi=rsi,
                            preprocess=preprocess)
        got = tdev.analyze(_t(x), bits=bits, J=J, rsi=rsi,
                           preprocess=preprocess)
        for key in ("nbytes", "total_bits", "k_lo_out", "k_hi_out",
                    "option", "blk_bits"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]),
                                          err_msg=f"{key} J={J} rsi={rsi}")
        assert got["option"].unique().numel() >= 3    # the mix is exercised


@pytest.mark.parametrize("chunk,rem_blocks", [(1024, 0), (1024, 37)])
def test_encode_plan_matches_tpukit(rng, chunk, rem_blocks):
    """The plan dict equals tpukit's, with and without a remainder chunk;
    the port's plan drives the host parallel coder to the serial coder's
    bytes, and decodes back."""
    n = 5 * chunk + rem_blocks * 16
    x = np.concatenate([_mixed_stream(rng, 16, 8, 2), np.zeros(n, np.uint16)])
    x = x[:n]
    want = jdev.encode_plan(jnp.asarray(x), chunk=chunk)
    got = tdev.encode_plan(_t(x), chunk=chunk)
    assert set(got) == set(PLAN_KEYS)
    assert got == want
    assert len(got["sizes"]) == 5 + (rem_blocks > 0)
    assert tdev.encode_size_chunked(_t(x), chunk=chunk) == \
        jdev.encode_size_chunked(jnp.asarray(x), chunk=chunk)
    bs = ck.encode_parallel(x, got)
    assert bs == ck.encode(x, 16, 8, 2)
    np.testing.assert_array_equal(ck.decode_parallel(bs, got), x)


def test_encode_size_pads_partial_blocks(rng):
    """A partial final block is padded with the last sample, as libaec."""
    for n in (13, 1000, 2051):
        x = rng.integers(0, 65536, n).astype(np.uint16)
        assert tdev.encode_size(_t(x)) == len(ck.encode(x, 16)) \
            == int(jdev.encode_size(jnp.asarray(x)))


@pytest.mark.parametrize("interleave", ["bip", "bil", "bsq"])
@pytest.mark.parametrize("preproc", ["none", "diff1"])
@pytest.mark.parametrize("dtype", [np.int16, np.uint16])
def test_flat_stream_matches_jax(rng, interleave, preproc, dtype):
    """Tile slice at a non-zero offset, diff1, the int16 -> uint16 bit view
    and the interleave equal tpukit's _flat_stream_jit."""
    info = np.iinfo(dtype)
    cube = rng.integers(info.min, info.max + 1, (5, 12, 10)).astype(dtype)
    y0, x0, th, tw = 4, 2, 6, 5
    want = np.asarray(_flat_stream_jit()(jnp.asarray(cube), y0, x0, th, tw,
                                         preproc, interleave))
    got = flat_stream(torch.from_numpy(cube), y0, x0, th, tw, preproc,
                      interleave)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_diff1_pair_matches_jax(rng):
    """The tensor diff1 pair is mod 2^16 like tpukit's and inverts."""
    u = rng.integers(0, 65536, (7, 9, 4)).astype(np.uint16)
    fwd = diff1_forward(_t(u))
    np.testing.assert_array_equal(
        diff1_inverse(fwd).numpy(),
        np.asarray(jdiff1_inverse(jnp.asarray(fwd.numpy().astype(np.uint16))))
        .astype(np.int32))
    np.testing.assert_array_equal(diff1_inverse(fwd).numpy(), u.astype(np.int32))
