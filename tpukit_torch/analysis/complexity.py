# -*- coding: utf-8 -*-
"""Tile complexity analytics on the device (port of
tpukit/analysis/complexity.py).

The metrics used to select HC/LC tiles (reference
tools/utils/tile_complexity.py):

  * Redies-style gradient complexity: per-band finite-difference |∇|,
    per-pixel max across bands, mean/std ignoring nodata (:80-102)
  * Fourier metrics on the composite (band-summed, mean-removed) power
    spectrum: HF ratio above a radial cutoff, radial-profile MDF/MNF and
    the 1/f^alpha log-log slope (:107-217)
  * delentropy: Shannon entropy of the 2-D gradient histogram of the
    per-pixel max-across-bands proxy (:222-257)

Every stage runs in torch on the caller's device (``cuda`` unless told
otherwise), and each quantity is taken as tpukit takes it:

  * ``ps_median`` is jnp.median's midpoint of the two middle values
    (``torch.median`` returns the lower one, ``torch.quantile``'s default
    interpolates linearly);
  * the delentropy clip ``lim`` is jnp.percentile's linear percentile, its
    position taken in float32 as XLA takes it (:func:`_percentile_linear`);
  * the frequency grid and its radius are XLA's float32 values of
    tpukit's formula (:func:`_fftfreq`, :func:`_radius`), so the radial
    bin counts are exact;
  * ``mdf`` is jnp.interp's ``searchsorted(side="right")`` form
    (:func:`_interp`);
  * the radial counts and the 2-D histogram are int64 counts
    (``bincount``), and the radial power sums are float64 sums over
    the samples sorted by bin, so two runs on the card give the same bits
    (a float ``index_add_`` on CUDA adds in whatever order its atomics
    land).

The FFTs differ at float32 round-off between XLA:CPU, pocketfft (torch on
the CPU) and cuFFT, and float32 sums go in another order, so the float
results agree with tpukit's within a relative 1e-4, the counts exactly.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tpukit_torch.device import resolve_device


def finite_diff_grad(img: torch.Tensor):
    """Centered differences inside, one-sided at borders (reference :62-78)."""
    gx_mid = (img[..., :, 2:] - img[..., :, :-2]) * 0.5
    gx = torch.cat([
        (img[..., :, 1:2] - img[..., :, 0:1]),
        gx_mid,
        (img[..., :, -1:] - img[..., :, -2:-1])], dim=-1)
    gy_mid = (img[..., 2:, :] - img[..., :-2, :]) * 0.5
    gy = torch.cat([
        (img[..., 1:2, :] - img[..., 0:1, :]),
        gy_mid,
        (img[..., -1:, :] - img[..., -2:-1, :])], dim=-2)
    return gx, gy


def _fftfreq(n: int, device) -> torch.Tensor:
    """jnp.fft.fftfreq(n) in float32 as XLA computes it inside a jitted
    program: the integer frequencies times float32(1/n) (XLA turns the
    division by the constant n into that product)."""
    k = (torch.arange(n, device=device) + n // 2) % n - n // 2
    return k.to(torch.float32) * float(np.float32(1.0) / np.float32(n))


def _radius(fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """sqrt(fy² + fx²) on the (H, W) grid, as XLA:CPU computes tpukit's
    float32 formula: its vector loops contract the sum into
    fma(fx, fx, fy·fy), which float64 holds exactly enough here, and the
    square root is correctly rounded (torch's float32 ``sqrt`` on the CPU
    is not)."""
    r2 = (fy * fy).to(torch.float64)[:, None] + \
        fx.to(torch.float64)[None, :] ** 2
    return torch.sqrt(r2.to(torch.float32).to(torch.float64)) \
        .to(torch.float32)


def _percentile_linear(x: torch.Tensor, pct: float) -> torch.Tensor:
    """jnp.percentile(x, pct) (method "linear") of a 1-D float32 tensor, as
    XLA compiles tpukit's program, where ``pct`` is traced: sort once; the
    position ``(pct/100)·(n-1)`` folded to ``pct·((n-1)·float32(1/100))``
    in float32; ``f = pos - floor(pos)``; and ``v[lo]·(1-f) + v[hi]·f``
    with the last product and the sum contracted into one FMA (float64
    holds the product exactly). ``torch.quantile`` rounds the position
    otherwise and refuses more than 2^24 elements."""
    v = torch.sort(x).values
    n = np.float32(v.numel())
    pos = np.float32(pct) * ((n - np.float32(1.0))
                             * (np.float32(1.0) / np.float32(100.0)))
    lo, hi = np.floor(pos), np.ceil(pos)
    f = pos - lo
    lo_i = int(min(max(lo, 0), n - 1))
    hi_i = int(min(max(hi, 0), n - 1))
    low = v[lo_i] * (np.float32(1.0) - f)
    return (v[hi_i].to(torch.float64) * float(f)
            + low.to(torch.float64)).to(torch.float32)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """jnp.interp of a scalar ``x`` over an increasing ``xp`` (flat runs
    allowed): ``searchsorted(side="right")`` clipped to [1, n-1]; a step of
    |dx| <= spacing(eps) takes ``fp[i-1]``; constant outside ``xp``."""
    n = xp.numel()
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True),
                    1, n - 1)[0]
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _segment_sum_f64(values: torch.Tensor, idx: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """Per-segment float64 sums of ``values`` (segment ids ``idx``, sizes
    ``counts``), in an order fixed by the data: the samples are sorted by
    segment (stably), laid out one segment a row, and each row summed."""
    nseg = counts.numel()
    order = torch.argsort(idx, stable=True)
    seg = idx[order]
    starts = torch.cumsum(counts, 0) - counts
    col = torch.arange(seg.numel(), device=seg.device) - starts[seg]
    width = max(int(counts.max()), 1)
    rows = torch.zeros(nseg, width, dtype=torch.float64, device=seg.device)
    rows[seg, col] = values[order].to(torch.float64)
    return rows.sum(1)


def _radial_bins(H: int, W: int, nbins: int, device):
    """The frequency radius R of the (H, W) grid, the radial bin width, each
    sample's bin (flat, int64) and the bins' sample counts (int64). Digitize
    semantics of the reference: bin i covers (edges[i], edges[i+1]]."""
    R = _radius(_fftfreq(H, device), _fftfreq(W, device))
    binw = R.max() / nbins
    idx = torch.clamp(
        torch.ceil(R / torch.clamp(binw, min=1e-12)).to(torch.int32) - 1,
        0, nbins - 1).reshape(-1).to(torch.int64)
    return R, binw, idx, torch.bincount(idx, minlength=nbins)


def _delentropy(Gx: torch.Tensor, Gy: torch.Tensor, lim: torch.Tensor,
                bins: int):
    """The 2-D gradient histogram with bin edges linspace(-lim, lim,
    bins+1) as int64 counts, and its Shannon entropy in bits."""
    gxc = torch.clamp(Gx.reshape(-1), -lim, lim)
    gyc = torch.clamp(Gy.reshape(-1), -lim, lim)
    scale = bins / (2 * lim)
    bi = torch.clamp(((gxc + lim) * scale).to(torch.int32), 0, bins - 1)
    bj = torch.clamp(((gyc + lim) * scale).to(torch.int32), 0, bins - 1)
    H2 = torch.bincount((bi * bins + bj).to(torch.int64),
                        minlength=bins * bins)
    total = H2.sum().to(torch.float32)
    pr = H2.to(torch.float32) / torch.clamp(total, min=1.0)
    logp = torch.where(pr > 0, torch.log2(torch.clamp(pr, min=1e-30)), 0.0)
    return H2, -(pr * logp).sum()


def _compute_device(a: torch.Tensor, valid: torch.Tensor, hf_cut: float,
                    nbins_radial: int, alpha_fit_min: float,
                    alpha_fit_max: float, delent_bins: int,
                    delent_clip_pct: float) -> Dict[str, torch.Tensor]:
    """tpukit's ``_compute_device`` on a (B, H, W) float32 tensor and its
    (H, W) bool validity plane; returns device scalars."""
    B, H, W = a.shape
    dev = a.device
    v = valid.to(torch.float32)
    nv = v.sum()
    nv_safe = torch.clamp(nv, min=1.0)

    # ---- gradient complexity ----
    # The reference NaN-masks nodata before differencing, so gradients that
    # touch an invalid pixel are excluded: zero-fill invalid samples and
    # keep only gradients whose whole stencil (a 3x3 cross, edge-replicated)
    # is valid.
    af = torch.where(valid[None], a, 0.0)
    gx, gy = finite_diff_grad(af)
    # the validity plane padded by one edge-replicated sample
    ri = torch.arange(-1, H + 1, device=dev).clamp(0, H - 1)
    ci = torch.arange(-1, W + 1, device=dev).clamp(0, W - 1)
    vp = valid[ri][:, ci]
    gvalid = (vp[1:-1, 1:-1] & vp[:-2, 1:-1] & vp[2:, 1:-1]
              & vp[1:-1, :-2] & vp[1:-1, 2:])
    gv = gvalid.to(torch.float32)
    ngv = torch.clamp(gv.sum(), min=1.0)
    mag = torch.sqrt(gx * gx + gy * gy)
    max_mag = torch.where(gvalid[None], mag, -torch.inf).amax(0)
    max_mag = torch.where(gvalid, max_mag, 0.0)
    gmean = (max_mag * gv).sum() / ngv
    gvar = ((max_mag - gmean) ** 2 * gv).sum() / ngv
    grad_std = torch.sqrt(gvar)

    # ---- composite power spectrum ----
    band_mean = (a * v[None]).sum((1, 2)) / nv_safe
    filled = torch.where(valid[None], a, band_mean[:, None, None])
    filled = filled - filled.mean((1, 2), keepdim=True)
    F = torch.fft.fft2(filled)
    P = (F.real * F.real + F.imag * F.imag).sum(0)
    del F, filled
    total_power = P.sum()
    ps_median = torch.quantile(P.reshape(-1), 0.5, interpolation="midpoint")
    ps_mean = P.mean()

    R, binw, idx, Cnt = _radial_bins(H, W, nbins_radial, dev)
    hf_power = torch.where(R >= hf_cut, P, 0.0).sum()
    hf_ratio = hf_power / torch.clamp(total_power, min=1e-30)

    # radial profile via segment sums
    Pr_sum = _segment_sum_f64(P.reshape(-1), idx, Cnt).to(torch.float32)
    Pr = Pr_sum / torch.clamp(Cnt.to(torch.float32), min=1.0)
    r_centers = (torch.arange(nbins_radial, device=dev,
                              dtype=torch.float32) + 0.5) * binw

    cumsum = torch.cumsum(Pr, 0)
    mdf = _interp(0.5 * cumsum[-1], cumsum, r_centers)
    mnf = (r_centers * Pr).sum() / torch.clamp(Pr.sum(), min=1e-30)

    # alpha: slope of log10(Pr) vs log10(r) in the fit window
    fit_mask = ((r_centers >= alpha_fit_min) & (r_centers <= alpha_fit_max)
                & (Pr > 0))
    nfit = fit_mask.sum()
    x = torch.where(fit_mask, torch.log10(torch.clamp(r_centers, min=1e-12)),
                    0.0)
    y = torch.where(fit_mask, torch.log10(torch.clamp(Pr, min=1e-30)), 0.0)
    n = torch.clamp(nfit.to(torch.float32), min=1.0)
    xm = x.sum() / n
    ym = y.sum() / n
    sxx = torch.where(fit_mask, (x - xm) ** 2, 0.0).sum()
    sxy = torch.where(fit_mask, (x - xm) * (y - ym), 0.0).sum()
    slope = sxy / torch.clamp(sxx, min=1e-30)
    alpha = torch.where(nfit >= 5, -slope, 0.0)

    # ---- delentropy on the per-pixel max band ----
    gray = torch.where(valid[None], a, -torch.inf).amax(0)
    gmean2 = (torch.where(valid, gray, 0.0) * v).sum() / nv_safe
    gray = torch.where(valid, gray, gmean2)
    Gx, Gy = finite_diff_grad(gray)
    absg = torch.cat([Gx.abs().reshape(-1), Gy.abs().reshape(-1)])
    lim = _percentile_linear(absg, delent_clip_pct)
    lim = torch.where(lim > 0, lim, 1.0)
    _, delentropy = _delentropy(Gx, Gy, lim, delent_bins)

    return {
        "grad_mean": gmean, "grad_std": grad_std,
        "hf_ratio": hf_ratio, "ps_median": ps_median, "ps_mean": ps_mean,
        "mdf": mdf, "mnf": mnf, "alpha": alpha,
        "delentropy_bits": delentropy,
        "total_power": total_power,
    }


def compute_all_arrays(arr: np.ndarray, nodata: Optional[float] = None,
                       hf_cut: float = 0.30, nbins_radial: int = 256,
                       alpha_fit_min: float = 0.02, alpha_fit_max: float = 0.45,
                       delent_bins: int = 256,
                       delent_clip_pct: float = 99.0,
                       device="cuda") -> Dict[str, float]:
    """All complexity metrics for one (B,H,W) array (reference compute_all
    :262-288 surface, minus file I/O), computed on ``device``."""
    dev = resolve_device(device)
    arr = np.asarray(arr, dtype=np.float32)
    if nodata is not None:
        # a pixel is valid iff NO band holds nodata (the reference masks
        # per band; for real products nodata pixels are nodata in every
        # band, where the two rules coincide)
        valid = (arr != nodata).all(axis=0)
    else:
        valid = np.ones(arr.shape[1:], bool)
    out = _compute_device(torch.from_numpy(arr).to(dev),
                          torch.from_numpy(valid).to(dev),
                          float(hf_cut), int(nbins_radial),
                          float(alpha_fit_min), float(alpha_fit_max),
                          int(delent_bins), float(delent_clip_pct))
    # one fetch for every scalar, in tpukit's key order (its jitted dict
    # comes back sorted)
    keys = sorted(out)
    vals = torch.stack([out[k].to(torch.float32) for k in keys]).cpu().numpy()
    res = {k: float(v) for k, v in zip(keys, vals)}
    if not np.isfinite(res["total_power"]) or res["total_power"] <= 0:
        for k in ("hf_ratio", "ps_median", "ps_mean", "mdf", "mnf", "alpha"):
            res[k] = 0.0
    res.pop("total_power")
    return res


def compute_all(path, device="cuda", **kw) -> Dict[str, object]:
    """File-level entry (reference :262-288): reads a GeoTIFF tile."""
    from tpukit_torch.io import tiff
    with tiff.open(path) as ds:
        arr = ds.read(out_dtype="float32")
        meta = {"path": str(path), "width": ds.width, "height": ds.height,
                "bands": ds.count}
        nodata = ds.nodata
    out = dict(meta)
    out.update(compute_all_arrays(arr, nodata=nodata, device=device, **kw))
    return out
