# -*- coding: utf-8 -*-
"""Fused image-quality metrics on a torch device (PSNR / global SSIM / max|Δ|).

Port of tpukit/metrics/quality.py:32-81 (``quality_stats``), :211-219
(``quality_stats_batched``) and :225-238 (``quality_stats_ladder``), with
JAX's vmap written out as a loop over lanes; :162-204 (``compute_metrics``,
with an explicit ``device``); and :254-310 (``quality_stats_dual``, the
per-strip stats of scene streaming). The host assembly (``_psnr_from``,
``_ssim_from``, ``assemble_quality``, ``assemble_quality_many``; :84-159,
:241-247) and the float64 strip merge (``merge_quality_stats``, :313-365)
are re-homed verbatim: importing them from tpukit would load JAX.

As in tpukit: second moments are accumulated in float32 about per-band
centres (the masked means), so there is no catastrophic cancellation;
max|Δ| and the observed peak are exact int32 reductions; masking is by
0/1 weights. The windowless global SSIM and the data-range-aware PSNR are
the reference's definitions (reference tools/run_codec.py:67-117).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from tpukit_torch.device import resolve_device
from tpukit_torch.io.bitdepth import effective_data_range


def quality_stats(ref: torch.Tensor, tst: torch.Tensor,
                  valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-band moments for PSNR/SSIM/max|Δ| under a validity mask.

    ref/tst: (B, H, W) cubes; valid: (H, W) bool/int mask. If the mask
    selects nothing, statistics fall back to all pixels (reference
    run_codec.py:264-285)."""
    # integer cubes difference exactly in int32; float cubes stay float32
    is_float = ref.is_floating_point() or tst.is_floating_point()
    work_dt = torch.float32 if is_float else torch.int32
    a = ref.to(work_dt)
    r = tst.to(work_dt)
    w = valid.to(torch.int32)
    w = torch.where((w > 0).any(), w, torch.ones_like(w))   # no host sync
    wf = w.to(torch.float32)[None]            # (1,H,W)
    wi = w[None].to(work_dt)

    af = a.to(torch.float32)
    rf = r.to(torch.float32)
    n = wf.sum()
    nn = torch.clamp(n, min=1.0)

    # pass 1: centre estimates; pass 2: centred moments
    c_a = (af * wf).sum((1, 2)) / nn
    c_r = (rf * wf).sum((1, 2)) / nn
    ac = (af - c_a[:, None, None]) * wf
    rc = (rf - c_r[:, None, None]) * wf

    d = (a - r) * wi                           # exact int32 difference
    df = d.to(torch.float32)
    return {
        "n": n,
        "c_a": c_a, "c_r": c_r,
        "sum_ac": ac.sum((1, 2)),
        "sum_rc": rc.sum((1, 2)),
        "sum_ac2": (ac * ac).sum((1, 2)),
        "sum_rc2": (rc * rc).sum((1, 2)),
        "sum_acrc": (ac * rc).sum((1, 2)),
        "sse": (df * df).sum((1, 2)),
        "maxerr": d.abs().amax((1, 2)),
        "max_abs_obs": (torch.maximum(a.abs(), r.abs()) * wi).amax((1, 2)),
    }


def quality_stats_ladder(ref: torch.Tensor, recons: torch.Tensor,
                         valid_base: torch.Tensor, nodata: float,
                         has_nodata: bool) -> Dict[str, torch.Tensor]:
    """Rate-ladder metrics against one (B, H, W) ref: recons is (N, B, H, W).
    Each lane's mask folds its own recon-side nodata exclusion (reference
    run_codec.py:249-263 builds the mask from BOTH cubes). Returns the
    per-lane stats stacked on a leading axis."""
    lanes = []
    for t in recons:
        vm = valid_base
        if has_nodata:
            vm = vm & (t.to(torch.float32) != float(nodata)).all(0)
        lanes.append(quality_stats(ref, t, vm))
    return {k: torch.stack([s[k] for s in lanes]) for k in lanes[0]}


def quality_stats_batched(ref: torch.Tensor, tst: torch.Tensor,
                          valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """quality_stats of each lane of (N, B, H, W) stacks under its own (N, H,
    W) mask, stacked on a leading axis."""
    lanes = [quality_stats(a, r, v) for a, r, v in zip(ref, tst, valid)]
    return {k: torch.stack([s[k] for s in lanes]) for k in lanes[0]}


def _psnr_from(sse: float, n: float, rng: float) -> float:
    if n <= 0:
        return float("nan")
    if sse == 0:
        return float("inf")
    m = sse / n
    return 20.0 * math.log10(rng) - 10.0 * math.log10(m)


def _ssim_from(mu_x, mu_y, sigma_x2, sigma_y2, sigma_xy, rng) -> float:
    """Windowless global SSIM (reference run_codec.py:67-80: population
    variance, den==0 -> 1, clipped to [0,1])."""
    L = rng
    C1 = (0.01 * L) ** 2
    C2 = (0.03 * L) ** 2
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x2 + sigma_y2 + C2)
    if den == 0:
        return 1.0
    return max(0.0, min(1.0, num / den))


def assemble_quality(stats: Dict[str, np.ndarray], data_range: float) -> Dict[str, float]:
    """Host-side float64 assembly of the reference metric dict
    (run_codec.py:294-304 keys: psnr/ssim band avg + global, max_abs_err,
    lossless, per-band psnr_b{i}/ssim_b{i}/maxerr_b{i})."""
    n = float(np.asarray(stats["n"], dtype=np.float64))
    c_a = np.asarray(stats["c_a"], dtype=np.float64)
    c_r = np.asarray(stats["c_r"], dtype=np.float64)
    sum_ac = np.asarray(stats["sum_ac"], dtype=np.float64)
    sum_rc = np.asarray(stats["sum_rc"], dtype=np.float64)
    sum_ac2 = np.asarray(stats["sum_ac2"], dtype=np.float64)
    sum_rc2 = np.asarray(stats["sum_rc2"], dtype=np.float64)
    sum_acrc = np.asarray(stats["sum_acrc"], dtype=np.float64)
    sse = np.asarray(stats["sse"], dtype=np.float64)
    maxerr = np.asarray(stats["maxerr"], dtype=np.float64)  # float cubes
    B = len(c_a)

    def _err(v: float):
        return int(v) if float(v).is_integer() else float(v)

    psnrs, ssims = [], []
    for i in range(B):
        psnrs.append(_psnr_from(sse[i], n, data_range))
        if n > 0:
            mu_x = c_a[i] + sum_ac[i] / n
            mu_y = c_r[i] + sum_rc[i] / n
            var_x = sum_ac2[i] / n - (sum_ac[i] / n) ** 2
            var_y = sum_rc2[i] / n - (sum_rc[i] / n) ** 2
            cov = sum_acrc[i] / n - (sum_ac[i] / n) * (sum_rc[i] / n)
            ssims.append(_ssim_from(mu_x, mu_y, var_x, var_y, cov, data_range))
        else:
            ssims.append(float("nan"))
    sse_total = float(np.sum(sse))
    n_total = n * B
    rng_obs = float(np.max(np.asarray(stats["max_abs_obs"])))
    if n_total > 0:
        rng_use = max(float(data_range), rng_obs) if math.isfinite(data_range) else rng_obs
        psnr_total = float("inf") if sse_total == 0.0 else (
            20.0 * math.log10(rng_use) - 10.0 * math.log10(sse_total / n_total))
    else:
        psnr_total = float("nan")
    ssim_total = float(np.nanmean(ssims)) if ssims else float("nan")
    out = {
        "psnr_band_avg": float(np.nanmean(psnrs)) if psnrs else float("nan"),
        "ssim_band_avg": float(np.nanmean(ssims)) if ssims else float("nan"),
        "psnr_global": psnr_total,
        "ssim_global": ssim_total,
        "max_abs_err": _err(maxerr.max()) if B else 0,
        "lossless": 1 if (B and maxerr.max() == 0) else 0,
    }
    for i in range(B):
        out[f"psnr_b{i+1}"] = psnrs[i]
        out[f"ssim_b{i+1}"] = ssims[i]
        out[f"maxerr_b{i+1}"] = _err(maxerr[i])
    return out


def assemble_quality_many(stacked: Dict[str, np.ndarray],
                          data_range: float) -> list:
    """Split a stacked (leading axis N) stats fetch into N reference metric
    dicts via assemble_quality."""
    n = len(np.asarray(stacked["maxerr"]))
    return [assemble_quality({k: np.asarray(v)[i] for k, v in stacked.items()},
                             data_range) for i in range(n)]


def compute_metrics(ref_cube: np.ndarray, tst_cube: np.ndarray,
                    dtype_name: Optional[str] = None,
                    valid: Optional[np.ndarray] = None,
                    nodata: Optional[float] = None,
                    ref_mask: Optional[np.ndarray] = None,
                    tst_mask: Optional[np.ndarray] = None,
                    data_range: Optional[float] = None,
                    device="cuda") -> Dict[str, float]:
    """End-to-end equivalent of reference run_codec.py:240-304 on arrays.

    The reference builds the validity map as dataset_mask(ref) ∧
    dataset_mask(tst) ∧ (band != nodata for every band of both) ∧ user mask
    (:249-263); pass those components here. ``data_range`` overrides the
    dtype/bit-packing heuristic (:86-117, computed from the *reference* cube).
    The moments are taken on ``device`` (CUDA unless the caller names the
    CPU).
    """
    ref_cube = np.asarray(ref_cube)
    tst_cube = np.asarray(tst_cube)
    if ref_cube.shape != tst_cube.shape:
        raise ValueError("Reference and test must match in size and band count.")
    B, H, W = ref_cube.shape
    if dtype_name is None:
        dtype_name = ref_cube.dtype.name
    if data_range is None:
        data_range = effective_data_range(ref_cube, dtype_name)

    vm = np.ones((H, W), dtype=bool)
    if ref_mask is not None:
        vm &= np.asarray(ref_mask) > 0
    if tst_mask is not None:
        vm &= np.asarray(tst_mask) > 0
    if nodata is not None and math.isfinite(nodata):
        for i in range(B):
            vm &= ref_cube[i] != nodata
            vm &= tst_cube[i] != nodata
    if valid is not None:
        v = np.asarray(valid)
        if v.shape != (H, W):
            raise ValueError(f"Mask shape {v.shape} != {(H, W)}")
        vm &= v.astype(bool)

    dev = resolve_device(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    stats = quality_stats(up(ref_cube), up(tst_cube), up(vm))
    stats = {k: v.cpu().numpy() for k, v in stats.items()}
    return assemble_quality(stats, float(data_range))


# ---------------------------------------------------------------------------
# Strip streaming: per-strip stats + exact float64 merge (scene-scale sweeps)
# ---------------------------------------------------------------------------

# samples of one band group in quality_stats_dual: a few float32
# temporaries of this size bound its working set, whatever the band count
_DUAL_GROUP_SAMPLES = 8 << 20

_STAT_KEYS = ("c_a", "c_r", "sum_ac", "sum_rc", "sum_ac2", "sum_rc2",
              "sum_acrc", "sse", "maxerr", "max_abs_obs")


def _band_stats(a, r, wf, wi, n, work_dt):
    """The moments of a group of bands (G, rows, W) under the weights wf/wi
    (broadcast over the bands), reduced per band."""
    a = a.to(work_dt)
    r = r.to(work_dt)
    af = a.to(torch.float32)
    rf = r.to(torch.float32)
    nn = torch.clamp(n, min=1.0)
    c_a = (af * wf).sum((1, 2)) / nn
    c_r = (rf * wf).sum((1, 2)) / nn
    ac = (af - c_a[:, None, None]) * wf
    rc = (rf - c_r[:, None, None]) * wf
    wi = wi.to(work_dt)
    d = (a - r) * wi
    df = d.to(torch.float32)
    return (c_a, c_r, ac.sum((1, 2)), rc.sum((1, 2)), (ac * ac).sum((1, 2)),
            (rc * rc).sum((1, 2)), (ac * rc).sum((1, 2)),
            (df * df).sum((1, 2)), d.abs().amax((1, 2)),
            (torch.maximum(a.abs(), r.abs()) * wi).amax((1, 2)))


def quality_stats_dual(ref: torch.Tensor, tst: torch.Tensor,
                       valid: torch.Tensor):
    """quality_stats twice for one strip: under the strip's validity mask
    (NO empty-mask fallback — a strip with zero valid pixels contributes
    zeros) and under an all-ones mask. The merge layer picks the all-ones
    accumulation only when the GLOBAL mask is empty, reproducing the
    reference's whole-image fallback (run_codec.py:264-266) without a
    second pass over the scene.

    Bands go in groups of at most ``_DUAL_GROUP_SAMPLES`` samples, so the
    float32 temporaries stay bounded by the strip's rows × W, not by the
    band count (tpukit's lax.map runs one band at a time for the same
    reason; per-band sums are independent, so grouping changes no result).
    Returns (masked, unmasked) dicts of per-band tensors."""
    is_float = ref.is_floating_point() or tst.is_floating_point()
    work_dt = torch.float32 if is_float else torch.int32
    B, rows, W = ref.shape
    wi_m = valid.to(torch.int32)[None]
    any_valid = (wi_m > 0).any()
    wf_m = wi_m.to(torch.float32)
    n_m = wf_m.sum()
    n_u = torch.tensor(float(rows * W), dtype=torch.float32,
                       device=ref.device)
    ones_f = torch.ones_like(wf_m)
    ones_i = torch.ones_like(wi_m)
    group = max(1, _DUAL_GROUP_SAMPLES // max(rows * W, 1))
    m_parts, u_parts = [], []
    for b0 in range(0, B, group):
        a, r = ref[b0:b0 + group], tst[b0:b0 + group]
        m_parts.append(_band_stats(a, r, wf_m, wi_m, n_m, work_dt))
        u_parts.append(_band_stats(a, r, ones_f, ones_i, n_u, work_dt))
    masked = {k: torch.cat([p[i] for p in m_parts])
              for i, k in enumerate(_STAT_KEYS)}
    masked["n"] = n_m
    # empty strip mask -> identically-zero masked contribution
    masked = {k: torch.where(any_valid, v, torch.zeros_like(v))
              for k, v in masked.items()}
    unmasked = {k: torch.cat([p[i] for p in u_parts])
                for i, k in enumerate(_STAT_KEYS)}
    unmasked["n"] = n_u
    return masked, unmasked


def merge_quality_stats(parts: list) -> Dict[str, np.ndarray]:
    """Combine per-strip quality_stats into whole-image stats, exactly
    (float64 pairwise/streamed Chan-Golub-LeVeque moment combination).

    Output feeds assemble_quality unchanged: the merged dict uses the
    combined means as the centers (sum_ac == sum_rc == 0), centered second
    moments as sum_*2, and the centered cross moment as sum_acrc."""
    parts = [p for p in parts if p is not None]
    if not parts:
        raise ValueError("no stats to merge")
    first = parts[0]
    Bn = len(np.asarray(first["c_a"]))
    n = 0.0
    mu_a = np.zeros(Bn)
    mu_r = np.zeros(Bn)
    m2_a = np.zeros(Bn)
    m2_r = np.zeros(Bn)
    cov = np.zeros(Bn)
    sse = np.zeros(Bn)
    maxerr = np.zeros(Bn)
    maxobs = np.zeros(Bn)
    for p in parts:
        nj = float(np.asarray(p["n"], np.float64))
        if nj <= 0:
            continue
        c_a = np.asarray(p["c_a"], np.float64)
        c_r = np.asarray(p["c_r"], np.float64)
        s_a = np.asarray(p["sum_ac"], np.float64)
        s_r = np.asarray(p["sum_rc"], np.float64)
        mj_a = c_a + s_a / nj
        mj_r = c_r + s_r / nj
        M2j_a = np.asarray(p["sum_ac2"], np.float64) - s_a * s_a / nj
        M2j_r = np.asarray(p["sum_rc2"], np.float64) - s_r * s_r / nj
        Cj = np.asarray(p["sum_acrc"], np.float64) - s_a * s_r / nj
        nt = n + nj
        da = mj_a - mu_a
        dr = mj_r - mu_r
        w = n * nj / nt
        m2_a += M2j_a + da * da * w
        m2_r += M2j_r + dr * dr * w
        cov += Cj + da * dr * w
        mu_a += da * nj / nt
        mu_r += dr * nj / nt
        n = nt
        sse += np.asarray(p["sse"], np.float64)
        maxerr = np.maximum(maxerr, np.asarray(p["maxerr"], np.float64))
        maxobs = np.maximum(maxobs, np.asarray(p["max_abs_obs"], np.float64))
    return {
        "n": np.float64(n), "c_a": mu_a, "c_r": mu_r,
        "sum_ac": np.zeros(Bn), "sum_rc": np.zeros(Bn),
        "sum_ac2": m2_a, "sum_rc2": m2_r, "sum_acrc": cov,
        "sse": sse, "maxerr": maxerr, "max_abs_obs": maxobs,
    }
