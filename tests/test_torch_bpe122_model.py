# -*- coding: utf-8 -*-
"""The CCSDS 122.0-B BPE model of tpukit_torch (``codecs/bpe122_model.py``)
against tpukit's jnp model and against the native coder
(native/src/bpe122.cpp), on the CPU: every layout entry, the full byte
count, and for fuzzed byte budgets the exact stream length and the
truncated-decode reconstruction. Integers throughout: every comparison is
exact. The cases are those of tests/test_bpe122_model.py plus all-zero and
single-coefficient blocks, a negative DC, block counts that are no multiple
of the gaggle (S = 4, 15, 24), and bands batched on a leading axis."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.codecs import bpe122_model as jbm
from tpukit.kernels import dwt as jdwt
from tpukit_torch.codecs import bpe122 as tb
from tpukit_torch.codecs import bpe122_model as tbm

torch.set_num_threads(2)        # xdist workers share the host


def _blocks(c: np.ndarray) -> np.ndarray:
    Hp, Wp = c.shape
    g, _ = tb.block_indices(Hp, Wp)
    wexp = tb.weight_exp_map(Hp, Wp)
    return ((c.astype(np.int32) << wexp).reshape(-1))[g]


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "zeros":
        return np.zeros((16, 16), np.int32)
    if name == "dc_only":
        d = np.zeros((16, 16), np.int32)
        d[:2, :2] = [[100, -3], [7, 2]]
        return d
    if name == "negative_dc_one_coefficient":
        d = np.zeros((16, 16), np.int32)
        d[0, 0], d[1, 1], d[5, 9] = -4096, -1, 1
        return d
    if name == "small":
        return rng.integers(-5, 6, (16, 16)).astype(np.int32)
    if name == "rand":                              # S = 24
        return rng.integers(-2000, 2000, (32, 48)).astype(np.int32)
    if name == "ragged":                            # S = 15
        return rng.integers(-900, 900, (24, 40)).astype(np.int32)
    if name == "sparse":
        sp = rng.integers(-20, 21, (32, 32)).astype(np.int32)
        sp[rng.random((32, 32)) < 0.85] = 0
        return sp
    if name == "dwt":
        gy, gx = np.mgrid[0:64, 0:64]
        img = (2000 * np.sin(gy / 9.0) * np.cos(gx / 13.0) + 4000).astype(
            np.int32)
        return np.asarray(jdwt.dwt2(jnp.asarray(img), "97m", 3))
    mag = int(name.split("_")[1])
    return rng.integers(-mag, mag + 1, (32, 32)).astype(np.int32)


CASES = ["zeros", "dc_only", "negative_dc_one_coefficient", "small", "rand",
         "ragged", "sparse", "dwt", "fuzz_1", "fuzz_4", "fuzz_90",
         "fuzz_4000", "fuzz_150000"]


@pytest.fixture(scope="module")
def jitted():
    return jax.jit(jbm.bpe_stream_layout), jax.jit(jbm.bpe_decode_at)


@pytest.mark.parametrize("name", CASES)
def test_layout_equals_tpukit_and_sizes_the_coder(jitted, name):
    blocks = _blocks(_case(name))
    full = tb.bpe_encode_blocks(blocks)
    got = tbm.bpe_stream_layout(torch.from_numpy(blocks))
    want = jitted[0](jnp.asarray(blocks))
    assert int(got["full_bytes"]) == len(full) == int(want["full_bytes"])
    assert int(tbm.bpe_size_bytes(torch.from_numpy(blocks))) == len(full)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, key
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.astype(np.int64), err_msg=key)


@pytest.mark.parametrize("name", CASES)
def test_truncated_decode_equals_tpukit_and_the_coder(jitted, name):
    blocks = _blocks(_case(name))
    nb = blocks.shape[0]
    full = tb.bpe_encode_blocks(blocks)
    layout = tbm.bpe_stream_layout(torch.from_numpy(blocks))
    jlayout = jitted[0](jnp.asarray(blocks))
    rng = np.random.default_rng(len(full))
    budgets = sorted({0, 1, 27, 28, 30, 61, len(full) // 4, len(full) // 2,
                      len(full) - 3, len(full), len(full) + 50, 1 << 28}
                     | set(rng.integers(1, len(full) + 30, 3).tolist()))
    for budget in budgets:
        if budget < 0:
            continue
        stream = (tb.bpe_encode_blocks(blocks, seg_byte_limit=budget)
                  if budget > 0 else full)
        rec, nbytes = tbm.bpe_decode_at(layout, budget)
        assert rec.dtype == torch.int32
        assert int(nbytes) == len(stream), (name, budget)
        np.testing.assert_array_equal(rec.numpy()[:nb],
                                      tb.bpe_decode_blocks(stream, nb),
                                      err_msg=f"{name} {budget}")
        jrec, jn = jitted[1](jlayout, budget)
        np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
        assert int(jn) == int(nbytes)


def test_bands_on_a_leading_axis_equal_band_by_band():
    bands = np.stack([_blocks(_case(n)) for n in
                      ("fuzz_4", "fuzz_4000", "sparse", "fuzz_150000")])
    bands[2] = 0                              # an all-zero band in the group
    layout = tbm.bpe_stream_layout(torch.from_numpy(bands))
    assert tuple(layout["s4_pos"].shape) == (4, 32, 16, 63)
    for budget in (0, 40, 200, 1000, torch.tensor(333)):
        rec, nbytes = tbm.bpe_decode_at(layout, budget)
        assert tuple(rec.shape) == (4, 16, 64)
        for b in range(4):
            r1, n1 = tbm.bpe_truncated_decode(torch.from_numpy(bands[b]),
                                              budget)
            assert torch.equal(r1, rec[b]) and int(n1) == int(nbytes[b])
    assert tbm.bpe_size_bytes(torch.from_numpy(bands)).tolist() == \
        [len(tb.bpe_encode_blocks(b)) for b in bands]


def test_tables_equal_tpukit():
    np.testing.assert_array_equal(tbm._SYM_FULL, jbm._SYM_FULL)
    np.testing.assert_array_equal(tbm._SYM_RESTR, jbm._SYM_RESTR)
    np.testing.assert_array_equal(tbm._LEN_TAB, jbm._LEN_TAB)
    np.testing.assert_array_equal(tbm._NOPT, jbm._NOPT)
    np.testing.assert_array_equal(tbm._IDB, jbm._IDB)
    assert tbm._OPT_LENS == jbm._OPT_LENS and tbm._INF == int(jbm._INF)
    assert (tbm.GAGGLE, tbm.HDR_BYTES) == (jbm.GAGGLE, jbm.HDR_BYTES)


def test_twos_complement_width_and_q_equal_tpukit():
    v = np.array([0, 1, -1, 2, -2, 3, -3, 4, -4, 127, -128, -129, 32767,
                  -32768, (1 << 31) - 1, -(1 << 31)], np.int32)
    np.testing.assert_array_equal(
        tbm._bits_twoscomp(torch.from_numpy(v)).numpy(),
        np.asarray(jbm._bits_twoscomp(jnp.asarray(v))))
    dc, ac = np.meshgrid(np.arange(1, 33), np.arange(0, 33), indexing="ij")
    np.testing.assert_array_equal(
        tbm._select_q(torch.from_numpy(dc), torch.from_numpy(ac)).numpy(),
        np.asarray(jbm._select_q(jnp.asarray(dc), jnp.asarray(ac))))
