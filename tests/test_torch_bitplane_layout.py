# -*- coding: utf-8 -*-
"""The embedded bit-plane coder's truncated-decode model in tpukit_torch
(``bitplane_model.bpc_stream_layout`` / ``bpc_decode_at`` /
``bpc_truncated_decode``) against tpukit's and against the native coder
(``bpc_decode(bpc_encode(c, budget))``), on the CPU. Integers throughout:
every comparison is exact. Budgets are fuzzed and include 0 (untruncated),
1 and 2 (nothing but the header fits) and budgets beyond the stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.codecs import bitplane_model as jbm
from tpukit_torch.codecs import bitplane_model as tbm
from tpukit_torch.codecs import wavelet_common as twc

torch.set_num_threads(2)        # xdist workers share the host

REGIMES = ["laplace", "dense", "sparse", "zeros", "one", "extremes",
           "equal_planes"]


def _coefs(rng, name: str, n: int) -> np.ndarray:
    if name == "laplace":
        c = rng.laplace(0, 30, (3, n))
    elif name == "dense":
        c = rng.integers(-5000, 5001, (3, n))
    elif name == "sparse":
        c = rng.integers(-900, 901, (3, n)) * (rng.random((3, n)) < 0.03)
    elif name == "zeros":
        c = np.zeros((3, n))
    elif name == "one":
        c = np.zeros((3, n))
        c[0, n // 2], c[1, 0], c[2, n - 1] = -77, 1, 1 << 20
    elif name == "extremes":
        c = rng.integers(-(1 << 20), 1 << 20, (3, n)) \
            * (rng.random((3, n)) < 0.4)
        c[0, :5] = [-(1 << 31), (1 << 31) - 1, 0, 70000, -70000]
    else:       # many coefficients share an MSB plane: the sort must be stable
        c = rng.choice([-3, -2, 2, 3, 64, 65, -127], (3, n))
    return c.astype(np.int32)


def _budgets(rng, full: int):
    fixed = [0, 1, 2, 3, full - 1, full, full + 1, full + 1000, 1 << 28]
    return sorted({int(b) for b in fixed if b >= 0}
                  | {int(b) for b in rng.integers(1, full + 2, 4)})


@pytest.fixture(scope="module")
def jax_decode():
    return jax.jit(jbm.bpc_truncated_decode)


@pytest.mark.parametrize("n", [256, 1000])
@pytest.mark.parametrize("name", REGIMES)
def test_truncated_decode_equals_tpukit_and_the_coder(rng, jax_decode, name,
                                                      n):
    c = _coefs(rng, name, n)
    full = int(tbm.bpc_size_bytes(torch.from_numpy(c)).max())
    layout = tbm.bpc_stream_layout(torch.from_numpy(c))
    for budget in _budgets(rng, full):
        rec, nbytes = tbm.bpc_decode_at(layout, budget)
        assert rec.dtype == torch.int32 and nbytes.dtype == torch.int64
        rec = rec[:, :n]
        for b in range(c.shape[0]):
            stream = twc.bpc_encode(c[b], budget)
            assert int(nbytes[b]) == len(stream), (name, budget, b)
            np.testing.assert_array_equal(rec[b].numpy(),
                                          twc.bpc_decode(stream, n))
            want, want_n = jax_decode(jnp.asarray(c[b]), jnp.int32(
                min(budget, (1 << 31) - 1)))
            np.testing.assert_array_equal(rec[b].numpy(), np.asarray(want))
            assert int(want_n) == int(nbytes[b])


@pytest.mark.parametrize("name", ["laplace", "equal_planes", "extremes"])
def test_layout_entries_equal_tpukit(rng, name):
    n = 500                                     # pads to 512
    c = _coefs(rng, name, n)
    got = tbm.bpc_stream_layout(torch.from_numpy(c))
    for b in range(c.shape[0]):
        want = jbm.bpc_stream_layout(jnp.asarray(c[b]))
        assert sorted(want) == sorted(got)
        for key, w in want.items():
            w = np.asarray(w).astype(np.int64)
            g = got[key][b].numpy().astype(np.int64)
            assert g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_rank_is_a_stable_sort_by_plane(rng):
    c = _coefs(rng, "equal_planes", 4096)[:1]
    lay = tbm.bpc_stream_layout(torch.from_numpy(c))
    msb, rank = lay["msb"][0].numpy(), lay["rank"][0].numpy()
    order = np.argsort(rank)
    assert sorted(rank.tolist()) == list(range(4096))
    key = -msb[order]
    assert (np.diff(key) >= 0).all()
    for plane in np.unique(msb):        # scan position ascending in a plane
        assert (np.diff(order[msb[order] == plane]) > 0).all()


def test_valid_mask_and_batch_axes(rng):
    c = _coefs(rng, "laplace", 300)
    valid = np.arange(300) < 250
    cz = np.where(valid, c, 0).astype(np.int32)
    rec, nbytes = tbm.bpc_truncated_decode(torch.from_numpy(cz), 90,
                                           torch.from_numpy(valid))
    for b in range(3):
        want, want_n = jbm.bpc_truncated_decode(jnp.asarray(cz[b]), 90,
                                                jnp.asarray(valid))
        np.testing.assert_array_equal(rec[b].numpy(), np.asarray(want))
        assert int(want_n) == int(nbytes[b])
    # two leading axes, and a budget given as a tensor
    c4 = np.stack([c, c[::-1]])
    rec4, n4 = tbm.bpc_truncated_decode(torch.from_numpy(c4),
                                        torch.tensor(120))
    assert tuple(rec4.shape) == (2, 3, 300) and tuple(n4.shape) == (2, 3)
    rec1, n1 = tbm.bpc_truncated_decode(torch.from_numpy(c[1]), 120)
    assert torch.equal(rec4[0, 1], rec1) and int(n4[0, 1]) == int(n1)
    assert torch.equal(rec4[1, 1], rec1)


def test_untruncated_decode_is_the_input(rng):
    c = _coefs(rng, "dense", 1024)
    rec, nbytes = tbm.bpc_truncated_decode(torch.from_numpy(c), 0)
    np.testing.assert_array_equal(rec.numpy(), c)
    assert nbytes.tolist() == tbm.bpc_size_bytes(torch.from_numpy(c)).tolist()
