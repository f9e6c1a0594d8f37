# -*- coding: utf-8 -*-
"""Spectral-fidelity metrics for hyperspectral (Case B) cubes: SAM, SID, LMSE.

Port of tpukit/metrics/spectral.py:27-99 (``sobel_mag``, ``_sam_sid_sums``,
``spectral_stats``, ``spectral_stats_ladder``; the vmap is written out as a
loop over lanes), :128-156 (``spectral_stats_strip``, the per-strip sums
of scene streaming) and :179-195 (``compute_sam_sid_lmse``, with an
explicit ``device``). The host assembly ``assemble_spectral_many``
(:102-118) and the strip merge ``merge_spectral_stats`` (:159-176) are
re-homed verbatim. Definitions follow reference tools/run_codec.py:308-347:

  * SAM — mean spectral angle (degrees) over valid pixels, taken in the
    stable form 2·atan2(‖û−v̂‖, ‖û+v̂‖) on unit spectra;
  * SID — symmetric KL divergence of per-pixel positive-normalised spectra;
  * LMSE — MSE of 3×3 Sobel gradient magnitudes over all pixels, unmasked
    as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpukit_torch.device import resolve_device


def sobel_mag(img: torch.Tensor) -> torch.Tensor:
    """3×3 Sobel gradient magnitude of (B, H, W) with edge padding. Same
    kernel taps as reference run_codec.py:123-137."""
    x = img.to(torch.float32)
    H, W = x.shape[-2], x.shape[-1]
    p = F.pad(x, (1, 1, 1, 1), mode="replicate")

    def sh(di, dj):
        return p[..., di:di + H, dj:dj + W]

    # kx = [[1,0,-1],[2,0,-2],[1,0,-1]], ky = kx.T-flip (run_codec.py:126-127)
    gx = (sh(0, 0) - sh(0, 2)) + 2.0 * (sh(1, 0) - sh(1, 2)) + (sh(2, 0) - sh(2, 2))
    gy = (sh(0, 0) + 2.0 * sh(0, 1) + sh(0, 2)) - (sh(2, 0) + 2.0 * sh(2, 1) + sh(2, 2))
    return torch.sqrt(gx * gx + gy * gy)


def _sam_sid_sums(A: torch.Tensor, R: torch.Tensor, w: torch.Tensor):
    """Masked SAM/SID pixel sums over the band axis 0."""
    n = w.sum()

    # --- SAM (reference run_codec.py:328-332) ---
    na = torch.sqrt((A * A).sum(0)) + 1e-12
    nr = torch.sqrt((R * R).sum(0)) + 1e-12
    un = A / na[None]
    vn = R / nr[None]
    dnorm = torch.sqrt(((un - vn) ** 2).sum(0))
    snorm = torch.sqrt(((un + vn) ** 2).sum(0))
    ang = 2.0 * torch.atan2(dnorm, snorm)
    sam_sum = (ang * w).sum()

    # --- SID (reference run_codec.py:334-339) ---
    Ap = A - A.amin(0)[None] + 1e-12
    Rp = R - R.amin(0)[None] + 1e-12
    Ap = Ap / Ap.sum(0, keepdim=True)
    Rp = Rp / Rp.sum(0, keepdim=True)
    log_ratio = torch.log((Ap + 1e-15) / (Rp + 1e-15))
    sid_pix = (Ap * log_ratio).sum(0) - (Rp * log_ratio).sum(0)
    sid_sum = (sid_pix * w).sum()
    return n, sam_sum, sid_sum


def spectral_stats(ref: torch.Tensor, tst: torch.Tensor,
                   valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Device sums for SAM/SID/LMSE. ref/tst: (B,H,W); valid: (H,W) bool."""
    A = ref.to(torch.float32)
    R = tst.to(torch.float32)
    n, sam_sum, sid_sum = _sam_sid_sums(A, R, valid.to(torch.float32))
    d = sobel_mag(A) - sobel_mag(R)       # LMSE: unmasked by design
    return {"n": n, "sam_sum": sam_sum, "sid_sum": sid_sum,
            "lmse": (d * d).mean()}


def spectral_stats_ladder(ref: torch.Tensor, recons: torch.Tensor,
                          valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """spectral_stats of each (B, H, W) lane of recons against one ref, stacked
    on a leading axis (the SAM/SID mask does not depend on the recon —
    reference run_codec.py:523-531 passes the baseline validity mask)."""
    lanes = [spectral_stats(ref, t, valid) for t in recons]
    return {k: torch.stack([s[k] for s in lanes]) for k in lanes[0]}


def assemble_spectral_many(stacked) -> list:
    """Stacked spectral stats fetch -> list of reference metric dicts."""
    n_arr = np.asarray(stacked["n"])
    out = []
    for i in range(len(n_arr)):
        n = float(n_arr[i])
        if n == 0:
            out.append({"sam_deg": float("nan"), "sid": float("nan"),
                        "lmse": float("nan")})
        else:
            out.append({
                "sam_deg": float(np.degrees(
                    float(np.asarray(stacked["sam_sum"])[i]) / n)),
                "sid": float(np.asarray(stacked["sid_sum"])[i]) / n,
                "lmse": float(np.asarray(stacked["lmse"])[i]),
            })
    return out


# ---------------------------------------------------------------------------
# Strip streaming: per-strip sums + merge (scene-scale sweeps)
# ---------------------------------------------------------------------------

def spectral_stats_strip(ref: torch.Tensor, tst: torch.Tensor,
                         valid: torch.Tensor, top: int, bot: int,
                         left: int = 0, right: int = 0
                         ) -> Dict[str, torch.Tensor]:
    """Per-strip(-chunk) SAM/SID/LMSE sums for streamed merging.

    ref/tst are (B, rows+top+bot, cols+left+right) — the chunk plus halo
    rows/columns from the neighbouring chunks so the Sobel stencil sees the
    same neighbourhood it would in a whole-image pass (at true image edges
    the halo is 0 and edge padding applies, as in sobel_mag). ``valid``
    covers the interior only. SAM/SID are per-pixel spectral reductions,
    computed on the interior slice directly; LMSE returns a SUM plus count
    (the reference's mean over all pixels, run_codec.py:341-346, is
    reassembled by merge_spectral_stats)."""
    rows = ref.shape[1] - top - bot
    cols = ref.shape[2] - left - right

    def interior(x):
        return x[:, top:top + rows, left:left + cols]

    A = ref.to(torch.float32)
    R = tst.to(torch.float32)
    n, sam_sum, sid_sum = _sam_sid_sums(interior(A), interior(R),
                                        valid.to(torch.float32))
    d = interior(sobel_mag(A) - sobel_mag(R))
    return {"n": n, "sam_sum": sam_sum, "sid_sum": sid_sum,
            "lmse_sum": (d * d).sum(),
            "lmse_n": torch.tensor(float(d.numel()), dtype=torch.float32,
                                   device=d.device)}


def merge_spectral_stats(parts: list) -> Dict[str, float]:
    """Combine per-strip spectral sums into the reference metric dict."""
    n = sam = sid = lsum = ln = 0.0
    for p in parts:
        if p is None:
            continue
        n += float(np.asarray(p["n"], np.float64))
        sam += float(np.asarray(p["sam_sum"], np.float64))
        sid += float(np.asarray(p["sid_sum"], np.float64))
        lsum += float(np.asarray(p["lmse_sum"], np.float64))
        ln += float(np.asarray(p["lmse_n"], np.float64))
    if n == 0:
        # no valid pixels: all-NaN, matching compute_sam_sid_lmse and
        # assemble_spectral_many (the tile path's reference fallback)
        return {"sam_deg": float("nan"), "sid": float("nan"),
                "lmse": float("nan")}
    return {"sam_deg": float(np.degrees(sam / n)), "sid": sid / n,
            "lmse": (lsum / ln) if ln else float("nan")}


def compute_sam_sid_lmse(ref_cube: np.ndarray, tst_cube: np.ndarray,
                         valid: Optional[np.ndarray] = None,
                         device="cuda") -> Dict[str, float]:
    """Host wrapper matching reference compute_sam_sid_lmse_caseB
    (run_codec.py:308-347): returns NaNs when no valid pixels. The sums are
    taken on ``device`` (CUDA unless the caller names the CPU)."""
    ref_cube = np.asarray(ref_cube)
    tst_cube = np.asarray(tst_cube)
    B, H, W = ref_cube.shape
    vm = np.ones((H, W), dtype=bool) if valid is None else np.asarray(valid).astype(bool)
    dev = resolve_device(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    s = spectral_stats(up(ref_cube), up(tst_cube), up(vm))
    n = float(s["n"])
    if n == 0:
        return {"sam_deg": float("nan"), "sid": float("nan"), "lmse": float("nan")}
    return {
        "sam_deg": float(np.degrees(float(s["sam_sum"]) / n)),
        "sid": float(s["sid_sum"]) / n,
        "lmse": float(s["lmse"]),
    }
