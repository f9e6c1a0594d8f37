# -*- coding: utf-8 -*-
"""tpukit_torch's on-device CCSDS-121 packer against tpukit's, on the CPU.

The same numpy streams, made from a seed, go through tpukit's ``analyze``,
``pack_words`` and ``encode_device`` (JAX on the CPU, K1 through
``_fs_table_jnp``) and through the port's (plain torch paths on CPU
tensors), and through the host C++ coder. Everything is an integer or a
byte string: every comparison is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpukit.codecs import ccsds121 as jdev
from tpukit.native import ccsds121_host as jck
from tpukit_torch.codecs import ccsds121 as tdev
from tpukit_torch.convert import PLAN_KEYS
from tpukit_torch.kernels.fs_table import KMAX, fs_table
from tpukit_torch.native import ccsds121_host as ck

torch.set_num_threads(2)        # xdist workers share the host

ANALYZE_KEYS = ("d", "coded", "k_sel", "lo_s", "hi_s", "is_ref", "allzero",
                "option", "gam_c", "blk_bits", "nbytes", "total_bits",
                "k_lo_out", "k_hi_out", "run_end", "head_idx", "z", "ros")


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))


def _gen(rng, n: int, kind: int, bits: int = 16) -> np.ndarray:
    """0: white noise (no-compression blocks), 1: a random walk (split
    blocks), 2: sparse small values (second extension, zero runs), 3: all
    zero, 4: saturating, 5: a mix of all of them."""
    top = (1 << bits) - 1
    if kind == 0:
        x = rng.integers(0, top + 1, n)
    elif kind == 1:
        x = np.cumsum(rng.integers(-5, 6, n)) % (top + 1)
    elif kind == 2:
        x = rng.integers(0, 4, n) * (rng.random(n) < 0.08)
    elif kind == 3:
        x = np.zeros(n, np.int64)
    elif kind == 4:
        x = np.full(n, top)
    else:
        cuts = np.sort(rng.integers(0, n, 4))
        x = np.concatenate([_gen(rng, m, k, bits) for k, m in enumerate(
            np.diff(np.concatenate([[0], cuts, [n]])))])
    return x.astype(np.uint16)


def _flags(preprocess: bool) -> int:
    return ck.FLAG_PREPROCESS if preprocess else 0


@pytest.mark.parametrize("kind", [3, 4, 5])
@pytest.mark.parametrize("preprocess", [True, False])
@pytest.mark.parametrize("J,rsi,bits", [(8, 2, 16), (16, 64, 16), (64, 3, 12)])
def test_analyze_full_dict_matches_tpukit(rng, J, rsi, bits, preprocess, kind):
    """Every key of analyze equals tpukit's: all-zero, saturating and mixed
    streams, preprocessor on and off, the three block widths, 12 and 16
    bits. One stream length per geometry keeps tpukit to one compile."""
    x = _gen(rng, J * rsi * 3 + J * 70, kind, bits)
    want = jdev.analyze(jnp.asarray(x), bits=bits, J=J, rsi=rsi,
                        preprocess=preprocess)
    got = tdev.analyze(_t(x), bits=bits, J=J, rsi=rsi, preprocess=preprocess)
    assert set(got) == set(want) == set(ANALYZE_KEYS)
    for key in ANALYZE_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    # the size-only form: the same sizes and outgoing interval, no scan
    lean = tdev.analyze(_t(x), bits=bits, J=J, rsi=rsi, preprocess=preprocess,
                        scan=False)
    assert set(lean) == set(ANALYZE_KEYS) - {"k_sel", "lo_s", "hi_s"}
    for key in ("total_bits", "nbytes", "k_lo_out", "k_hi_out", "blk_bits"):
        np.testing.assert_array_equal(lean[key].numpy(), got[key].numpy())


def test_size_only_callers_skip_the_scan(rng, monkeypatch):
    """chunk_stats, encode_plan, encode_size and encode_size_rows never run
    the per-block scan; pack_words runs it once."""
    calls = []
    scan = tdev._scan_clamps
    monkeypatch.setattr(tdev, "_scan_clamps",
                        lambda lo, hi: calls.append(1) or scan(lo, hi))
    x = _t(_gen(rng, 16 * 64, 5))
    tdev.chunk_stats(x)
    assert tdev.encode_plan(x, chunk=16 * 16) is not None
    tdev.encode_size(x[:1001])
    tdev.encode_size_chunked(x, chunk=16 * 16)
    tdev.encode_size_rows(x.reshape(4, -1))
    assert calls == []
    tdev.pack_words(x, torch.zeros((), dtype=torch.int32),
                    out_words=tdev.pack_cap_words(x.numel()))
    assert calls == [1]


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 1000, 4097])
def test_scan_clamps_equals_sequential_fold(rng, n):
    """The doubling scan equals a left-to-right Python fold of the clamp
    composition on random intervals, an operator that does not commute."""
    lo = rng.integers(0, KMAX + 1, n)
    hi = np.minimum(lo + rng.integers(0, 5, n), KMAX)
    ident = rng.random(n) < 0.3                  # zero blocks: identity
    lo[ident], hi[ident] = 0, KMAX
    want_lo, want_hi = [], []
    cur = (0, KMAX)
    for l, h in zip(lo.tolist(), hi.tolist()):
        cur = (min(max(cur[0], l), h), min(max(cur[1], l), h))
        want_lo.append(cur[0])
        want_hi.append(cur[1])
    got_lo, got_hi = tdev._scan_clamps(_t(lo), _t(hi))
    assert got_lo.tolist() == want_lo and got_hi.tolist() == want_hi
    red = tdev._compose_clamps(_t(lo), _t(hi))
    assert (int(red[0]), int(red[1])) == cur
    if n >= 3:
        # the order matters: the reversed chain ends elsewhere for some input
        a, b = (3, 3), (7, 7)
        assert (min(max(a[0], b[0]), b[1]),) != (min(max(b[0], a[0]), a[1]),)


@pytest.mark.parametrize("J,rsi,bits,preprocess", [
    (8, 2, 16, True), (16, 64, 16, False), (16, 2, 12, True),
    (64, 3, 16, False)])
def test_pack_words_matches_tpukit(rng, J, rsi, bits, preprocess):
    """pack_words' words (tpukit's uint32, here int64 in [0, 2^32)),
    total_bits and outgoing interval, from k_init 0 and from k_init 5."""
    x = _gen(rng, J * 96, 5, bits)
    cap = jdev.pack_cap_words(x.size, bits, J)
    assert tdev.pack_cap_words(x.size, bits, J) == cap
    assert tdev._reg_words(bits, J) == jdev._reg_words(bits, J)
    for k0 in (0, 5):
        want = jdev.pack_words(jnp.asarray(x), jnp.int32(k0), bits=bits, J=J,
                               rsi=rsi, out_words=cap, preprocess=preprocess)
        got = tdev.pack_words(_t(x), torch.tensor(k0, dtype=torch.int32),
                              bits=bits, J=J, rsi=rsi, out_words=cap,
                              preprocess=preprocess)
        assert got[0].dtype == torch.int64
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(want[0]).astype(np.int64))
        for g, w in zip(got[1:], want[1:]):
            assert int(g) == int(w)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 5])
def test_encode_device_monolithic_bytes(rng, kind):
    """One pack: bytes equal to tpukit's encode_device and to the host C++
    coder, and the single-chunk plan decodes."""
    x = _gen(rng, 8 * 200, kind)
    bs, plan = tdev.encode_device(_t(x), chunk=1 << 22, return_plan=True)
    jbs, jplan = jdev.encode_device(jnp.asarray(x), chunk=1 << 22,
                                    return_plan=True)
    assert bs == jbs == ck.encode(x, 16)
    assert plan == jplan
    assert set(plan) == set(PLAN_KEYS) - {"k_in"}
    np.testing.assert_array_equal(ck.decode_parallel(bs, plan), x)
    assert fs_table.launches == 0                 # CPU tensors: plain table


@pytest.mark.parametrize("J,rsi,preprocess", [(8, 2, True), (16, 64, False)])
def test_encode_device_chunked_bytes(rng, J, rsi, preprocess):
    """Chunked packs thread k between chunks: bytes equal to tpukit's and
    to the host coder; the plan equals tpukit's and drives decode_parallel,
    decode_to_device and tpukit's decode_parallel."""
    step = J * rsi
    chunk = step * 3
    for kind in (1, 5):
        x = _gen(rng, chunk * 3 + step, kind)
        bs, plan = tdev.encode_device(_t(x), J=J, rsi=rsi, chunk=chunk,
                                      preprocess=preprocess, return_plan=True)
        jbs, jplan = jdev.encode_device(jnp.asarray(x), J=J, rsi=rsi,
                                        chunk=chunk, preprocess=preprocess,
                                        return_plan=True)
        assert bs == jbs == ck.encode(x, 16, J, rsi, flags=_flags(preprocess))
        assert plan == jplan and len(plan["sizes"]) == 4
        assert any(o % 8 for o in plan["bit_off"][1:]) or kind == 5
        np.testing.assert_array_equal(ck.decode_parallel(bs, plan), x)
        np.testing.assert_array_equal(jck.decode_parallel(bs, plan), x)
        back = ck.decode_to_device(bs, plan, device="cpu")
        assert back.dtype == torch.int32 and back.device.type == "cpu"
        np.testing.assert_array_equal(back.numpy(), x)
        assert tdev.encode_device(_t(x), J=J, rsi=rsi, chunk=chunk,
                                  preprocess=preprocess) == bs


def test_encode_device_fuzz_against_host_coder(rng):
    """Random lengths, kinds and chunkings against the host C++ coder
    alone (tpukit would compile a program for every shape)."""
    for trial in range(24):
        J, rsi, pre = [(8, 2, True), (16, 64, False), (32, 2, True),
                       (8, 128, True)][trial % 4]
        step = J * rsi
        n = step * int(rng.integers(1, 6)) + J * int(rng.integers(0, rsi))
        x = _gen(rng, n, int(rng.integers(0, 6)))
        ref = ck.encode(x, 16, J, rsi, flags=_flags(pre))
        assert tdev.encode_device(_t(x), J=J, rsi=rsi, preprocess=pre) == ref
        bs, plan = tdev.encode_device(_t(x), J=J, rsi=rsi, preprocess=pre,
                                      chunk=step * int(rng.integers(1, 3)),
                                      return_plan=True)
        assert bs == ref, (trial, n)
        np.testing.assert_array_equal(
            ck.decode_to_device(bs, plan, "cpu").numpy(), x)


def test_encode_device_misaligned_tail(rng):
    """n not a multiple of J*rsi: full chunks end on reference-sample
    intervals and the tail chunk carries the leftover blocks."""
    chunk = 16 * 5
    x = _gen(rng, chunk * 2 + 8 * 3, 1)
    bs, plan = tdev.encode_device(_t(x), chunk=chunk, return_plan=True)
    jbs, jplan = jdev.encode_device(jnp.asarray(x), chunk=chunk,
                                    return_plan=True)
    assert bs == jbs == ck.encode(x, 16, 8, 2)
    assert plan == jplan and plan["sizes"] == [chunk, chunk, 24]
    np.testing.assert_array_equal(ck.decode_parallel(bs, plan), x)


@pytest.mark.parametrize("bits", [9, 12, 14])
def test_encode_device_sub16_bits(rng, bits):
    x = rng.integers(0, 1 << bits, 8 * 150).astype(np.uint16)
    assert tdev.encode_device(_t(x), bits=bits, chunk=1 << 22) \
        == ck.encode(x, bits)


def test_encode_device_guards():
    """Partial blocks are refused; a monolithic pack whose worst case could
    cross 2^31 bits is refused before anything is computed."""
    with pytest.raises(ValueError, match="whole blocks"):
        tdev.encode_device(torch.zeros(12, dtype=torch.int32))

    class FakeTensor:
        shape = (1 << 28,)
    with pytest.raises(ValueError, match="too large"):
        tdev.encode_device(FakeTensor(), chunk=0)


def test_reg_insert_drops_out_of_range(rng):
    """A masked-off value, and a value whose position lies past the register
    file, leave the file untouched; a value across a word boundary lands in
    both words."""
    W = torch.zeros((3, 2), dtype=torch.int64)
    pos = torch.tensor([28, 64, 70], dtype=torch.int32)
    val = torch.tensor([0xAB, 0xFF, 0xFF], dtype=torch.int32)
    mask = torch.tensor([True, True, False])
    tdev._reg_insert(W, pos, val, 8, mask)
    assert W.tolist() == [[0xA, 0xB << 28], [0, 0], [0, 0]]
    out = torch.zeros(2, dtype=torch.int64)
    tdev._add_words(out, torch.tensor([-1, 1, 2]), torch.tensor([7, 5, 9]))
    assert out.tolist() == [0, 5]
