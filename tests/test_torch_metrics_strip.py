# -*- coding: utf-8 -*-
"""The strip metrics of scene streaming and the library metric entry
points, port against tpukit on the CPU.

``quality_stats_dual``: integer keys exact, float keys within rel 1e-5
(the centred first sums, which are round-off around zero, within 1e-5 of
their scale), a strip with an empty mask contributing zeros; the band
groups change no result. The float64 merges (``merge_quality_stats``,
``merge_spectral_stats``) are tpukit's, exact on identical inputs, and the
merge of strips gives the whole image's metrics (PSNR/SSIM rel 1e-5,
SAM/SID/LMSE rel 1e-4). ``spectral_stats_strip`` with every halo
combination within rel 1e-4 of tpukit's. ``compute_metrics`` and
``compute_sam_sid_lmse`` against tpukit's and the numpy oracle of
tests/reference_impl.py, at the tolerances of tests/test_metrics.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.reference_impl import compute_metrics_oracle, sam_sid_lmse_oracle
from tpukit.metrics import quality as jq
from tpukit.metrics import spectral as js
from tpukit_torch.metrics import quality as tq
from tpukit_torch.metrics import spectral as ts

torch.set_num_threads(2)        # xdist workers share the host

INT_KEYS = ("maxerr", "max_abs_obs")
CENTRED = {"sum_ac": "sum_ac2", "sum_rc": "sum_rc2"}


def _pair(rng, dtype=np.int16, B=7, H=24, W=40, amp=30):
    if dtype == np.int16:
        ref = rng.integers(-2048, 6000, (B, H, W)).astype(np.int16)
    else:
        ref = (rng.integers(0, 4096, (B, H, W)).astype(np.uint16) << 4)
    info = np.iinfo(dtype)
    tst = np.clip(ref.astype(np.int64) + rng.integers(-amp, amp + 1,
                                                      ref.shape),
                  info.min, info.max).astype(dtype)
    return ref, tst


def _close_stats(got, want, n):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(w)
        if k in INT_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in CENTRED:
            scale = np.sqrt(np.maximum(np.asarray(want[CENTRED[k]]), 1) *
                            max(float(n), 1.0))
            assert np.all(np.abs(g - w) <= 1e-5 * scale), k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("dtype", [np.int16, np.uint16])
@pytest.mark.parametrize("mask", ["some", "all", "none"])
def test_quality_stats_dual_equals_tpukit(rng, dtype, mask):
    ref, tst = _pair(rng, dtype)
    valid = {"some": rng.random(ref.shape[1:]) > 0.3,
             "all": np.ones(ref.shape[1:], bool),
             "none": np.zeros(ref.shape[1:], bool)}[mask]
    jm, ju = jq.quality_stats_dual(jnp.asarray(ref), jnp.asarray(tst),
                                   jnp.asarray(valid))
    tm, tu = tq.quality_stats_dual(torch.from_numpy(ref),
                                   torch.from_numpy(tst),
                                   torch.from_numpy(valid))
    _close_stats(tm, {k: np.asarray(v) for k, v in jm.items()}, valid.sum())
    _close_stats(tu, {k: np.asarray(v) for k, v in ju.items()}, valid.size)
    if mask == "none":                # no fallback: zeros
        for k, v in tm.items():
            assert not v.any(), k


def test_quality_stats_dual_band_groups_change_nothing(rng, monkeypatch):
    ref, tst = _pair(rng, B=9)
    valid = torch.from_numpy(rng.random(ref.shape[1:]) > 0.3)
    one = tq.quality_stats_dual(torch.from_numpy(ref), torch.from_numpy(tst),
                                valid)
    monkeypatch.setattr(tq, "_DUAL_GROUP_SAMPLES", 2 * ref[0].size)
    grouped = tq.quality_stats_dual(torch.from_numpy(ref),
                                    torch.from_numpy(tst), valid)
    for a, b in zip(one, grouped):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _strip_parts(ref, tst, valid, rows, dual):
    parts_m, parts_u = [], []
    for y0 in range(0, ref.shape[1], rows):
        sl = slice(y0, y0 + rows)
        m, u = dual(ref[:, sl], tst[:, sl], valid[sl])
        parts_m.append({k: np.asarray(v) for k, v in m.items()})
        parts_u.append({k: np.asarray(v) for k, v in u.items()})
    return parts_m, parts_u


@pytest.mark.parametrize("rows", [5, 8, 24])
def test_merged_strips_equal_the_whole_image(rng, rows):
    ref, tst = _pair(rng, H=40)
    valid = rng.random(ref.shape[1:]) > 0.25
    valid[8:16] = False                        # a strip with no valid pixel
    dual = lambda a, b, v: tq.quality_stats_dual(
        torch.from_numpy(np.ascontiguousarray(a)),
        torch.from_numpy(np.ascontiguousarray(b)),
        torch.from_numpy(np.ascontiguousarray(v)))
    parts_m, _ = _strip_parts(ref, tst, valid, rows, dual)
    merged = tq.assemble_quality(tq.merge_quality_stats(parts_m), 8191.0)
    whole = tq.assemble_quality(
        {k: v.numpy() for k, v in tq.quality_stats(
            torch.from_numpy(ref), torch.from_numpy(tst),
            torch.from_numpy(valid)).items()}, 8191.0)
    for k, w in whole.items():
        if isinstance(w, int):
            assert merged[k] == w, k
        else:
            assert merged[k] == pytest.approx(w, rel=1e-5), k


def test_merges_equal_tpukit_exactly(rng):
    ref, tst = _pair(rng, H=32)
    valid = rng.random(ref.shape[1:]) > 0.2
    parts_m, parts_u = _strip_parts(
        ref, tst, valid, 8, lambda a, b, v: jq.quality_stats_dual(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(v)))
    for parts in (parts_m, parts_u, parts_m + [None], parts_m[:1]):
        got, want = tq.merge_quality_stats(parts), jq.merge_quality_stats(parts)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError):
        tq.merge_quality_stats([None])
    s_parts = [{k: np.float32(v) for k, v in zip(
        ("n", "sam_sum", "sid_sum", "lmse_sum", "lmse_n"),
        rng.random(5) * 100)} for _ in range(4)]
    for parts in (s_parts, s_parts + [None],
                  [dict(s_parts[0], n=np.float32(0))], []):
        got, want = ts.merge_spectral_stats(parts), \
            js.merge_spectral_stats(parts)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == want[k] or (math.isnan(got[k])
                                         and math.isnan(want[k])), k


@pytest.mark.parametrize("top,bot,left,right", [
    (t, b, l, r) for t in (0, 1) for b in (0, 1) for l in (0, 1)
    for r in (0, 1)])
def test_spectral_stats_strip_equals_tpukit(rng, top, bot, left, right):
    ref, tst = _pair(rng, B=9, H=14 + top + bot, W=20 + left + right,
                     amp=40)
    ref = np.abs(ref.astype(np.int32)).astype(np.int16) + 4
    tst = np.abs(tst.astype(np.int32)).astype(np.int16) + 4
    valid = rng.random((14, 20)) > 0.2
    want = js.spectral_stats_strip(jnp.asarray(ref), jnp.asarray(tst),
                                   jnp.asarray(valid), top, bot, left, right)
    got = ts.spectral_stats_strip(torch.from_numpy(ref),
                                  torch.from_numpy(tst),
                                  torch.from_numpy(valid),
                                  top, bot, left, right)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, err_msg=k)


def test_spectral_strips_merge_to_the_whole_image(rng):
    """Row strips with 1-row halos and column chunks with 1-px halos give
    the whole image's SAM/SID/LMSE."""
    ref, tst = _pair(rng, B=6, H=30, W=36, amp=50)
    ref = np.abs(ref.astype(np.int32)).astype(np.int16) + 4
    tst = np.abs(tst.astype(np.int32)).astype(np.int16) + 4
    valid = rng.random((30, 36)) > 0.2
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    parts = []
    for y0 in range(0, 30, 10):
        top, bot = int(y0 > 0), int(y0 + 10 < 30)
        for x0 in range(0, 36, 12):
            left, right = int(x0 > 0), int(x0 + 12 < 36)
            rs = slice(y0 - top, y0 + 10 + bot)
            cs = slice(x0 - left, x0 + 12 + right)
            parts.append({k: v.numpy() for k, v in ts.spectral_stats_strip(
                T(ref[:, rs, cs]), T(tst[:, rs, cs]),
                T(valid[y0:y0 + 10, x0:x0 + 12]), top, bot, left,
                right).items()})
    merged = ts.merge_spectral_stats(parts)
    whole = ts.compute_sam_sid_lmse(ref, tst, valid, device="cpu")
    for k in ("sam_deg", "sid", "lmse"):
        assert merged[k] == pytest.approx(whole[k], rel=1e-4), k


@pytest.mark.parametrize("case", ["caseA", "caseB_masked", "nodata",
                                  "empty_mask"])
def test_compute_metrics_equals_tpukit_and_oracle(rng, case):
    if case == "caseA":
        ref, tst = _pair(rng, np.uint16, B=4, H=32, W=32, amp=25)
        kw, vm, drange = {}, None, 4095
    else:
        ref, tst = _pair(rng, np.int16, B=6, H=32, W=32, amp=9)
        ref = ((ref.view(np.uint16) >> 2) << 2).view(np.int16)
        drange = jq.effective_data_range(ref, "int16")
        vm = rng.random((32, 32)) > 0.35
        kw = {"valid": vm}
        if case == "nodata":
            ref[:, :4] = tst[:, :4] = 0
            vm = np.all(ref != 0, axis=0) & np.all(tst != 0, axis=0)
            kw = {"nodata": 0}
        elif case == "empty_mask":
            kw, vm = {"valid": np.zeros((32, 32), bool)}, None
    want = jq.compute_metrics(ref, tst, **kw)
    got = tq.compute_metrics(ref, tst, device="cpu", **kw)
    exp = compute_metrics_oracle(ref, tst, drange, vm)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, int):
            assert got[k] == w == exp[k], k
        else:
            assert got[k] == pytest.approx(w, rel=1e-5), k
            assert got[k] == pytest.approx(exp[k], rel=1e-5), k


def test_compute_sam_sid_lmse_equals_tpukit_and_oracle(rng):
    ref, tst = _pair(rng, np.int16, B=12, H=32, W=32, amp=6)
    ref = np.abs(ref.astype(np.int32)).astype(np.int16) + 4
    tst = np.abs(tst.astype(np.int32)).astype(np.int16) + 4
    vm = rng.random((32, 32)) > 0.2
    got = ts.compute_sam_sid_lmse(ref, tst, vm, device="cpu")
    want = js.compute_sam_sid_lmse(ref, tst, vm)
    exp = sam_sid_lmse_oracle(ref, tst, vm)
    for k in ("sam_deg", "sid", "lmse"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert got["sam_deg"] == pytest.approx(exp["sam_deg"], rel=1e-3, abs=1e-4)
    assert got["sid"] == pytest.approx(exp["sid"], rel=5e-2, abs=1e-5)
    assert got["lmse"] == pytest.approx(exp["lmse"], rel=1e-3)
    empty = ts.compute_sam_sid_lmse(ref, ref, np.zeros((32, 32), bool),
                                    device="cpu")
    assert all(math.isnan(v) for v in empty.values())
