# -*- coding: utf-8 -*-
"""Fused image-quality metrics on a torch device (PSNR / global SSIM / max|Δ|).

Port of tpukit/metrics/quality.py:32-81 (``quality_stats``) and :225-238
(``quality_stats_ladder``, with JAX's vmap written out as a loop over
lanes). The host assembly (``_psnr_from``, ``_ssim_from``,
``assemble_quality``, ``assemble_quality_many``; :84-159, :241-247) is
re-homed verbatim: importing it from tpukit would load JAX.

As in tpukit: second moments are accumulated in float32 about per-band
centres (the masked means), so there is no catastrophic cancellation;
max|Δ| and the observed peak are exact int32 reductions; masking is by
0/1 weights. The windowless global SSIM and the data-range-aware PSNR are
the reference's definitions (reference tools/run_codec.py:67-117).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


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
