# -*- coding: utf-8 -*-
"""The arithmetic and schedules of kernels K1 and K2, on the CPU.

The CUDA kernels run only on the card, where chip_smoke.py holds them
against their plain versions. What decides their results is reachable
here:

  * K2 (tpukit_torch/csrc/dwt97.cu): ``kernels.dwt97.plan`` is replayed
    launch by launch with numpy float32 (every operation rounded once, as
    the kernel's __fadd_rn/__fmul_rn): each tile launch as the tile kernel
    computes it, a tile plus a halo of 4 filled by whole-point symmetric
    reflection, lifted over the same shrinking pair ranges, and each tail
    launch with the plain lifting. The result equals ``dwt2`` bit for bit,
    with the kernel's 56 x 64 tiles and with small ones that cut every
    window into partial tiles, down to windows of 2.
  * K1 (tpukit_torch/csrc/fs_table.cu): ``fs_table_planes``, the kernel's
    bit-plane arithmetic in torch, equals ``fs_table_ref`` exactly, with
    values up to 2^31 - 1 where the int32 sums wrap.
"""

import numpy as np
import pytest
import torch

from tpukit_torch.kernels.dwt import (A97, B97, D97, G97, IK97, K97, dwt2)
from tpukit_torch.kernels.dwt97 import TAIL_MAX, plan
from tpukit_torch.kernels.fs_table import fs_table_planes, fs_table_ref

HALO = 4
F = np.float32


def _lift(a, x, y, c):
    return a + F(c) * (x + y)


def _reflect(i, n):
    """Whole-point symmetric extension index of n >= 2 samples."""
    p = 2 * (n - 1)
    i = np.mod(i, p)
    return np.where(i < n, i, p - i)


def _lift_pairs(s, d, axis):
    """The tile kernel's four steps along ``axis`` of a halo-extended tile:
    the valid pairs shrink by one a side per step; returns the scaled
    inner (s, d), pairs 2 .. P-3."""
    P = s.shape[axis]

    def sl(a, b):
        idx = [slice(None)] * s.ndim
        idx[axis] = slice(a, b)
        return tuple(idx)

    d[sl(0, P - 1)] = _lift(d[sl(0, P - 1)], s[sl(0, P - 1)], s[sl(1, P)],
                            A97)
    s[sl(1, P - 1)] = _lift(s[sl(1, P - 1)], d[sl(0, P - 2)],
                            d[sl(1, P - 1)], B97)
    d[sl(1, P - 2)] = _lift(d[sl(1, P - 2)], s[sl(1, P - 2)],
                            s[sl(2, P - 1)], G97)
    s[sl(2, P - 2)] = _lift(s[sl(2, P - 2)], d[sl(1, P - 3)],
                            d[sl(2, P - 2)], D97)
    return s[sl(2, P - 2)] * F(K97), d[sl(2, P - 2)] * F(IK97)


def _tile_level(win, th, tw):
    """One tile launch on a (B, h, w) window: (LL, HL, LH, HH)."""
    B, h, w = win.shape
    q = [np.zeros((B, h // 2, w // 2), F) for _ in range(4)]
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            rows = _reflect(np.arange(r0 - HALO, r0 + th + HALO), h)
            cols = _reflect(np.arange(c0 - HALO, c0 + tw + HALO), w)
            t = win[:, rows][:, :, cols]
            L, H = _lift_pairs(t[..., 0::2].copy(), t[..., 1::2].copy(), 2)
            parts = [_lift_pairs(b[:, 0::2].copy(), b[:, 1::2].copy(), 1)
                     for b in (L, H)]
            (ll, lh), (hl, hh) = parts
            i0, j0 = r0 // 2, c0 // 2
            ni, nj = min(th // 2, h // 2 - i0), min(tw // 2, w // 2 - j0)
            for dst, src in zip(q, (ll, hl, lh, hh)):
                dst[:, i0:i0 + ni, j0:j0 + nj] = src[:, :ni, :nj]
    return q


def _replay(x, levels, tail_max, th, tw):
    B, H, W = x.shape
    out = np.zeros_like(x)
    bufs = {"x": x}
    for s in plan(H, W, levels, tail_max):
        win = bufs[s.src][:, :s.h, :s.w]
        if s.kind == "tail":
            out[:, :s.h, :s.w] = dwt2(torch.from_numpy(win.copy()), "97",
                                      s.levels).numpy()
            continue
        ll, hl, lh, hh = _tile_level(win, th, tw)
        h2, w2 = s.h // 2, s.w // 2
        out[:, :h2, w2:s.w] = hl
        out[:, h2:s.h, :w2] = lh
        out[:, h2:s.h, w2:s.w] = hh
        if s.ll == "out":
            out[:, :h2, :w2] = ll
        else:
            bufs[s.ll] = ll
    return out


@pytest.mark.parametrize("tail_max,th,tw", [(TAIL_MAX, 56, 64),
                                            (0, 56, 64), (0, 16, 32)])
@pytest.mark.parametrize("shape,levels", [((2, 64, 96), 3),
                                          ((3, 96, 160), 5),
                                          ((1, 256, 256), 5)])
def test_dwt97_plan_replay_equals_dwt2(shape, levels, tail_max, th, tw):
    rng = np.random.default_rng(sum(shape) + levels)
    x = (rng.integers(0, 4096, shape) << 4).astype(F)
    got = _replay(x, levels, tail_max, th, tw)
    want = dwt2(torch.from_numpy(x), "97", levels).numpy()
    np.testing.assert_array_equal(got, want)


def test_dwt97_plan_launches():
    """Four launches at every main-path shape (three tile levels and one
    tail of two), each level reading what the one before wrote."""
    for H, W in ((1024, 1024), (992, 1024), (1024, 800), (992, 800)):
        steps = plan(H, W, 5)
        assert [(s.kind, s.level, s.src, s.ll, s.levels) for s in steps] == [
            ("tile", 0, "x", "s0", 1), ("tile", 1, "s0", "s1", 1),
            ("tile", 2, "s1", "s0", 1), ("tail", 3, "s0", "out", 2)]
        assert [(s.h, s.w) for s in steps] == [(H >> k, W >> k)
                                               for k in range(4)]
    assert [s.kind for s in plan(96, 160, 5)] == ["tail"]
    assert [s.ll for s in plan(1024, 1024, 1)] == ["out"]
    assert [s.ll for s in plan(256, 256, 3, 0)] == ["s0", "s1", "out"]
    assert len(plan(4096, 4096, 5)) == 5
    assert plan(64, 64, 0) == []


@pytest.mark.parametrize("J", [1, 5, 8, 32, 64])
def test_fs_table_planes_equal_ref(J):
    g = torch.Generator().manual_seed(J)
    x = torch.cat([
        torch.randint(0, 1 << 16, (200, J), generator=g, dtype=torch.int32),
        torch.randint(0, 1 << 31, (200, J), generator=g, dtype=torch.int64)
        .to(torch.int32),
        torch.full((3, J), (1 << 31) - 1, dtype=torch.int32),
        torch.zeros((2, J), dtype=torch.int32)])
    assert torch.equal(fs_table_planes(x), fs_table_ref(x))
