# -*- coding: utf-8 -*-
"""The J2K quality-ladder pricing of tpukit_torch against tpukit's, on the
CPU.

The size models are integer, so they must equal tpukit's exactly: the
embedded bit-plane model (``bpc_size_bytes``), the run-length model
(``rle_size_bytes_model``, whose saturating int32 trees the port replaces
with exact int64 sums clamped once) and the light model that combines them
(``wenc_size_bytes_light``). The whole targets dict goes through a DWT in
float32, which the port rounds otherwise than XLA:CPU does, so it is held
within rel 5e-3 of tpukit's CPU pricing: the tolerance tpukit itself
accepts between devices (tests/test_tpu_smoke.py:186-187)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukit.codecs.j2k_codec as jj2k
from tpukit.codecs import bitplane_model as jbpc
from tpukit.codecs import wavelet_common as jwc
from tpukit.codecs.base import RateSpec
from tpukit_torch.codecs import bitplane_model as tbpc
from tpukit_torch.codecs import j2k_codec as tj2k
from tpukit_torch.codecs import wavelet_common as twc
from tpukit_torch.codecs.base import RateSpec as TRateSpec
from tpukit_torch.convert import from_tpukit_codec

torch.set_num_threads(2)        # xdist workers share the host

LADDER = [1, 2, 4, 6, 8, 10, 15, 20, 25, 30, 35, 40, 60, 100]


def _both(fn_j, fn_t, q, *a, **kw):
    return (np.asarray(fn_j(jnp.asarray(q), *a, **kw)),
            fn_t(torch.from_numpy(q), *a, **kw).numpy())


def _sparse(rng, shape, density, hi):
    v = rng.integers(-hi, hi + 1, shape) * (rng.random(shape) < density)
    return v.astype(np.int32)


@pytest.mark.parametrize("n,hi,masked", [(1024, 300, False), (1000, 300, True),
                                         (77, 1 << 30, True),
                                         (4096, 1 << 30, False)])
def test_bpc_size_bytes_exact(rng, n, hi, masked):
    q = _sparse(rng, (3, n), 0.4, hi)
    q[0, :5] = 0                                   # an all-zero group head
    q[1, -3:] = -(1 << 30)
    valid = None
    if masked:
        valid = rng.random(n) < 0.8
        valid[-17:] = False                        # a padded tail
    want = np.asarray(jbpc.bpc_size_bytes(
        jnp.asarray(q), None if valid is None else jnp.asarray(valid)))
    got = tbpc.bpc_size_bytes(
        torch.from_numpy(q), None if valid is None else torch.from_numpy(valid))
    assert got.numpy().tolist() == want.tolist()


def test_msb_index_exact():
    mag = np.array([0, 1, 2, 3, 4, 7, 8, (1 << 30) - 1, 1 << 30, 2 ** 31 - 1],
                   np.int64)
    want = [-1, 0, 1, 1, 2, 2, 3, 29, 30, 30]
    assert tbpc._msb_index(torch.from_numpy(mag)).tolist() == want


@pytest.mark.parametrize("density", [0.003, 0.05, 0.6])
def test_rle_model_exact_on_sparse_data(rng, density):
    segb = jwc.subband_seg_bounds(64, 64, 5)
    q = _sparse(rng, (4, 64 * 64), density, 32767)
    a, b = _both(jwc.rle_size_bytes_model, twc.rle_size_bytes_model, q, segb)
    assert b.tolist() == a.tolist()
    a, b = _both(jwc.rle_size_bytes_model, twc.rle_size_bytes_model, q)
    assert b.tolist() == a.tolist()


def test_rle_model_exact_on_segment_boundary_runs():
    """Nonzeros right at segment starts and ends, and zero runs that span
    segment boundaries: the prev-nonzero chain resets at every segment."""
    segb = jwc.subband_seg_bounds(64, 96, 5)
    n = 64 * 96
    q = np.zeros((3, n), np.int32)
    for a, b in segb:
        q[0, a] = 5
        q[0, b - 1] = -7
        q[1, b - 1] = 1
    q[2, n // 2] = 32767                      # one nonzero, long runs round it
    a, b = _both(jwc.rle_size_bytes_model, twc.rle_size_bytes_model, q, segb)
    assert b.tolist() == a.tolist()
    assert twc.subband_seg_bounds(64, 96, 5) == segb
    assert (twc.scan_order(64, 96, 5) == jwc.scan_order(64, 96, 5)).all()


@pytest.mark.parametrize("cap", [None, 4000, 70000])
def test_rle_model_exact_where_costs_reach_cap(rng, monkeypatch, cap):
    """Full-scale magnitudes: at the real ceiling the small-k magnitude
    candidates saturate (sum(m) over 2^15 samples exceeds 2^29); with a
    lowered ceiling (patched into both packages alike) the segment costs
    and the total saturate too."""
    if cap is not None:
        monkeypatch.setattr(jwc, "_rle_cap_bits", lambda n: cap)
        monkeypatch.setattr(twc, "_rle_cap_bits", lambda n: cap)
    n = 1 << 15
    q = np.full((3, n), 32767, np.int32)
    q[1, ::2] = -32768
    q[2] = _sparse(rng, (n,), 0.5, 32767)
    segb = jwc.subband_seg_bounds(128, 256, 5)
    a, b = _both(jwc.rle_size_bytes_model, twc.rle_size_bytes_model, q, segb)
    assert b.tolist() == a.tolist()
    if cap is not None:          # the segment total saturates at CAP
        assert (b == 1 + (cap + 7) // 8).all()
    a, b = _both(jwc.rle_size_bytes_model, twc.rle_size_bytes_model, q)
    assert b.tolist() == a.tolist()


def test_segment_sums_flat_form_equals_row_form(rng):
    """The form CUDA takes (one scan of the flattened tensor) against the
    CPU's row scans, on the CPU."""
    segb = jwc.subband_seg_bounds(64, 96, 5)
    c = twc.RleModelConsts(segb, torch.device("cpu"))
    x = torch.from_numpy(rng.integers(0, 1 << 16, (2, 3, 64 * 96)))
    rows = twc._seg_sums(x, c)
    assert rows.shape == (2, 3, len(segb))
    assert torch.equal(twc._seg_sums_flat(x, c), rows)
    want = np.stack([x.numpy()[..., a:b].sum(-1) for a, b in segb], -1)
    assert rows.numpy().tolist() == want.tolist()


def test_wenc_size_bytes_light_exact(rng):
    segb = jwc.subband_seg_bounds(64, 64, 5)
    q = _sparse(rng, (5, 64 * 64), 0.2, 300)
    q[1, 7] = 40000                             # beyond int16: bit-plane only
    q[2, 9] = -32769
    q[3] = _sparse(rng, (64 * 64,), 0.9, 1 << 20)
    a, b = _both(jj2k.wenc_size_bytes_light, tj2k.wenc_size_bytes_light, q,
                 segb)
    assert b.tolist() == a.tolist()


def _tile(rng, shape):
    B, H, W = shape
    gy, gx = np.mgrid[0:H, 0:W]
    base = (800 + 25 * gy + 15 * gx) % 4096
    t = np.clip(base[None] + rng.integers(-400, 400, shape), 0, 4095)
    return t.astype(np.uint16) << 4


def _tpukit_targets(monkeypatch, codec, cube, specs):
    """tpukit's CPU pricing through its own sweep: the light size ladder's
    (Q, B) output, summed over the bands, per quality spec index."""
    seen = []
    ladder = jj2k._device_ladder_sizes

    def spy(*a, **kw):
        seen.append(np.asarray(ladder(*a, **kw)))
        return seen[-1]

    monkeypatch.setattr(jj2k, "_device_ladder_sizes", spy)
    codec.sweep_rates(cube, "uint16", specs)
    assert len(seen) == 1
    return {i: int(s.sum()) for i, s in enumerate(seen[0])}


@pytest.mark.parametrize("shape", [(4, 64, 64), (4, 50, 70)])
def test_targets_match_tpukit_cpu_pricing(rng, monkeypatch, shape):
    """The whole targets dict (padded to a multiple of 32 when the tile is
    not one) within rel 5e-3 of tpukit's; the count of points that differ
    at all is printed."""
    cube = _tile(rng, shape)
    specs = [RateSpec.of("quality", q) for q in LADDER]
    jcodec = jj2k.J2KCodec()
    want = _tpukit_targets(monkeypatch, jcodec, cube, specs)
    got = from_tpukit_codec(jcodec)._price_targets(
        cube, {i: TRateSpec(s.key, s.value, s.lossless)
               for i, s in enumerate(specs)})()
    assert sorted(got) == sorted(want) == list(range(len(LADDER)))
    rel = {i: abs(got[i] - want[i]) / want[i] for i in want}
    print(f"{shape}: {sum(r > 0 for r in rel.values())} of {len(rel)} "
          f"targets differ, max rel {max(rel.values()):.2e}")
    assert max(rel.values()) <= 5e-3
    # more bytes at every higher quality
    assert all(got[i] <= got[i + 1] for i in range(len(LADDER) - 1))
