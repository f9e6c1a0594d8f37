# -*- coding: utf-8 -*-
"""JPEG 2000-class wavelet codec — port of tpukit/codecs/j2k_codec.py.

Two entropy backends, as in tpukit (``entropy=``):

* ``"ebcot"`` (default): per band, tpukit's host C++ writes ISO/IEC
  15444-1 codestreams (``tpukit.io.j2c_enc``: EBCOT tier-1 and PCRD-opt
  truncation) and decodes them (``tpukit.io.jp2.JP2Decoder``); the port
  imports both unchanged. A quality ladder costs one tier-1 analysis per
  tile (``J2CPlan``): each lossy point is a PCRD truncation of it to a byte
  target (``at_size_multi``). The device work is the pricing of those
  targets: for QUALITY points the target is the byte size that the light
  integer size model (``wenc_size_bytes_light``) gives the cube quantized
  at that quality's steps, after a 5-level 9/7 DWT (kernel K2,
  ``kernels.dwt97``, on CUDA) on the device of the sweep's cube upload
  (``device_cube``). The targets are budgets, so they must not depend on
  where they were computed (tpukit j2k_codec.py:1229-1237): the DWT follows
  a rounding contract that gives the same bits on the CPU and on CUDA, and
  the models are integer. The DWT and the ladder are enqueued on the CUDA
  stream before the host's tier-1 analysis and read back after it (tpukit
  used a worker thread with a 30 s timeout and an inline fallback).
* ``"device"``: the fast mode, where no host entropy coder runs. Lossy
  points quantize the 9/7 DWT (kernel K2) with per-subband deadzone steps,
  and their stream sizes come from the exact size model of the host coder
  (``wenc_size_bytes``: the smallest of the CCSDS-121 Rice candidates,
  whose cost tables go through kernel K1, the run-length model and the
  bit-plane model); the reconstructions are requantized from the same
  coefficients on the device. Lossless points use the reversible integer
  5/3 DWT, whose inverse is the decoder's output. ``rate_fit`` bisects the
  base step on the device against a bpp/cr byte budget. The streams
  themselves are built only when ``keep_bitstream`` asks: the host coder
  (``wavelet_common.wenc_quant_encode_ck`` / ``wenc_encode``) quantizes and
  codes the coefficients the device produced, fetched once per cube; each
  band's stream must be as long as the size model says, decode back to the
  coded values, and (in a ladder) sum to the device requantizer's
  wrap-around checksums, or the run raises.

Both backends take JP2-style independent tiles (``tilex``/``tiley``);
device-mode quality ladders batch same-shape tiles on the device.

Quantizing is ``trunc(c * inv_step)`` in float32 with the f32 -> int32
conversion saturating as XLA's does (:func:`quantize`). The device-mode
results on CUDA equal those on the CPU bit for bit (the transforms follow
the rounding contract of ``kernels.dwt``, the models are integer); against
tpukit they agree to the f32 round-off of the 9/7 DWT.
"""

from __future__ import annotations

import os
import time
import zlib
from functools import lru_cache
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpukit_torch.codecs import wavelet_common as wc
from tpukit_torch.codecs.base import (Codec, CodecResult, RateSpec,
                                     device_work, edge_pad,
                                     trailing_zero_shift, work_device)
from tpukit_torch.codecs.bitplane_model import _wrap_i32, bpc_size_bytes
from tpukit_torch.codecs.ccsds121 import encode_size_rows
from tpukit_torch.io.j2c_enc import J2CPlan, at_size_multi
from tpukit_torch.io.jp2 import JP2Decoder
from tpukit_torch.sweep.proc import mem_phase
from tpukit_torch.kernels.dwt import dwt2, idwt2, subband_slices
from tpukit_torch.kernels.dwt97 import dwt97

LEVELS = 5

# ebcot per-point (streams, recon) rep-cache budget: recon bytes held per
# tile; see the pcache insertion in _sweep_ebcot
_PCACHE_BYTES = int(2e9)

# tiles per device batch of the tiled device sweep: bounds its working set
# (32 planes of 1024² f32 = 128 MB per array); results do not depend on it
_TILE_BATCH = 8

# the harness context a tile-by-tile run hands on to each tile
_TILE_OPTS = ("device_plan_cache", "dedupe_reps", "device_cube", "device")


def quality_from_cr(cr: float) -> int:
    """≈100/CR clamped to [5,95] (reference j2k_wrap.py:32-35)."""
    q = int(round(100.0 / max(cr, 1e-6)))
    return max(5, min(95, q))


def quality_from_bpp(bpp_band: float) -> int:
    """Step table (reference j2k_wrap.py:38-47)."""
    if bpp_band >= 4.0:
        return 80
    if bpp_band >= 3.0:
        return 70
    if bpp_band >= 2.0:
        return 60
    if bpp_band >= 1.5:
        return 55
    if bpp_band >= 1.0:
        return 45
    if bpp_band >= 0.75:
        return 38
    if bpp_band >= 0.5:
        return 32
    return 28


def _cube_peak(cube: np.ndarray) -> float:
    """The cube's largest sample magnitude as a float, 1.0 for an all-zero
    cube: tpukit's ``float(np.abs(cube.astype(np.float64)).max()) or 1.0``
    without its two float64 copies of the cube. min and max are taken in
    the cube's own dtype and widened to Python numbers before ``abs``
    (int16's -32768 has no int16 magnitude); rounding to float64 is
    monotone, so the float is tpukit's for every dtype."""
    lo, hi = cube.min().item(), cube.max().item()
    return float(max(abs(lo), abs(hi))) or 1.0


def base_step_for_quality(q: int, data_peak: float) -> float:
    """Monotone QUALITY→quantization-step map. Calibrated so q=100 is
    near-transparent and low q reaches deep compression on 12/16-bit DN."""
    q = max(1, min(100, int(q)))
    return max(0.5, data_peak / 4096.0) * (2.0 ** ((70 - q) / 8.0))


def _decode_bands_into(recon: np.ndarray, streams, info, dtype) -> None:
    """Real per-band codestream decode into recon (clip + cast), band-
    parallel when the host has more than one core (the native tier-1
    decode releases the GIL), min(8, bands, cores) workers."""
    def one(b):
        dec = JP2Decoder(streams[b]).decode_component(0, 0, 0)
        recon[b] = np.clip(dec, info.min, info.max).astype(dtype)

    n = len(streams)
    workers = min(8, n, os.cpu_count() or 1)
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(workers) as tp:
            list(tp.map(one, range(n)))
    else:
        for b in range(n):
            one(b)


# The two band-parallel steps of the ``ebcot`` backend below run one job per
# band through ``pmap``: a band pool's map (:func:`_band_pool`) or the
# builtin map on one core. A job touches only its own band's plan, so the
# per-plan caches (``lossless()``, the truncated-decode model's per-band
# arrays) are never shared; the native calls release the GIL;
# ``native.load()`` is locked. ``j2c_enc._load_t1enc`` may run in two jobs
# at its first use, which is harmless: both set the same ``restype`` and
# ``argtypes`` on the same function. The caller enters ``mem_phase`` (a
# module global) around the map, never a job.

def _band_plans(cube: np.ndarray, depth: int, signed: bool, wavelet: str,
                base: float, pmap) -> list:
    """One :class:`J2CPlan` per band (the native DWT and the tier-1 of
    every code-block), in band order."""
    return list(pmap(lambda b: J2CPlan(cube[b], depth, signed,
                                       levels=LEVELS, wavelet=wavelet,
                                       base_step=base),
                     range(cube.shape[0])))


def _model_bands_into(recon: np.ndarray, plans, sels, info, pmap) -> None:
    """Each band's truncated-decode model recon of the selection ``sels``
    (bit-identical to JP2Decoder of the truncated stream) into recon,
    clipped to ``info``'s range and cast to recon's dtype."""
    def one(b):
        recon[b] = np.clip(plans[b].truncated_recon(sels[b]), info.min,
                           info.max).astype(recon.dtype)

    list(pmap(one, range(len(plans))))


def _cube_token(cube: np.ndarray) -> int:
    """Content token folded into every plan-cache key: a CRC of the full
    cube bytes, so a same-shape cube is never served another's streams."""
    return zlib.crc32(np.ascontiguousarray(cube).tobytes())


@lru_cache(maxsize=None)
def _subband_norms(levels: int = LEVELS) -> Dict[str, float]:
    """Interior L2 norm of the 9/7 synthesis basis per subband name: one
    batched inverse DWT of unit impulses on a small tile (plain version,
    on the CPU, once per process), averaged over the 2x2 polyphase
    positions. The interior norms do not depend on the tile size."""
    S = max(64, 8 << levels)
    subs = subband_slices(S, S, levels)
    imps = []
    for name, lv, sl in subs:
        ys, xs = sl
        y0, x0 = (ys.start + ys.stop) // 2, (xs.start + xs.stop) // 2
        for dy in (0, 1):
            for dx in (0, 1):
                z = np.zeros((S, S), np.float32)
                z[y0 + dy, x0 + dx] = 1.0
                imps.append(z)
    recs = idwt2(torch.from_numpy(np.stack(imps)), "97",
                 levels).numpy().astype(np.float64)
    norms: Dict[str, float] = {}
    for i, (name, lv, sl) in enumerate(subs):
        e = (recs[4 * i:4 * i + 4] ** 2).sum(axis=(1, 2)).mean()
        norms[name] = float(np.sqrt(e))
    return norms


def _subband_steps(H: int, W: int, base: float) -> np.ndarray:
    """Per-coefficient quantization step map for the packed layout:
    step_b = base / (synthesis basis L2 norm of subband b)."""
    steps = np.empty((H, W), np.float32)
    norms = _subband_norms(LEVELS)
    for name, lv, sl in subband_slices(H, W, LEVELS):
        steps[sl] = base / norms[name]
    return steps


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def quantize(c: torch.Tensor, inv_step) -> torch.Tensor:
    """The coder's multiply quantizer ``trunc(c * inv_step)`` as int32.
    The conversion saturates as XLA's does (tpukit's
    ``jnp.trunc(...).astype(int32)``): at or above 2^31 gives INT32_MAX, at
    or below -2^31 INT32_MIN, NaN 0. torch's own conversion of values out
    of range differs between the CPU and CUDA; the rate fit's bisection
    probes steps small enough to reach them."""
    t = torch.trunc(c * inv_step)
    q = t.clamp(float(_I32_MIN), float(1 << 31) - 128).nan_to_num(0.0)
    return torch.where(t >= float(1 << 31), _I32_MAX, q.to(torch.int32))


def wenc_size_bytes_light(qc: torch.Tensor, segbounds=None,
                          consts: wc.RleModelConsts | None = None
                          ) -> torch.Tensor:
    """Deterministic integer size model over the cheap backends (embedded
    bit-plane and run-length candidates) per band of scan-ordered int32
    coefficients (port of tpukit j2k_codec.py:278-297): the run-length
    size applies where the values fit int16."""
    fits = (qc.amax(-1) <= 32767) & (qc.amin(-1) >= -32768)
    size_rle = wc.rle_size_bytes_model(qc.clamp(-32768, 32767), segbounds,
                                       consts)
    size_bpc = bpc_size_bytes(qc)
    return torch.where(fits, torch.minimum(size_bpc, size_rle), size_bpc)


def wenc_size_bytes(qc: torch.Tensor, segbounds=None,
                    consts: wc.RleModelConsts | None = None) -> torch.Tensor:
    """Exact per-band byte length of the host coder's stream
    (tpukit ``wavelet_common.wenc_encode``) over the last axis of
    scan-ordered int32 coefficients, int64 (port of tpukit
    j2k_codec.py:300-361). Where the values fit int16: the smaller of the
    Rice backend (the CCSDS-121 coder over zigzag-mapped values, +1 header
    byte; dense J=64/RSI=2 or sparse J=32/RSI=8 by the rule nnz·32 < n) and
    the run-length model. Otherwise: the smaller of the bit-plane model and
    the Rice-split candidate (s raw LSBs per value, 2 header bytes, and the
    Rice size of the 16-bit high parts). The Rice sizes are
    :func:`ccsds121.encode_size_rows` of all bands at once (kernel K1 on
    CUDA). A band length that is not a whole number of Rice blocks leaves
    only the bit-plane and run-length candidates, as the host coder does.

    The zigzag maps are int64 with explicit 32-bit wrap-around in place of
    tpukit's int32/uint32 arithmetic."""
    fits = (qc.amax(-1) <= 32767) & (qc.amin(-1) >= -32768)
    qcc = qc.clamp(-32768, 32767)
    size_rle = wc.rle_size_bytes_model(qcc, segbounds, consts)
    size_bpc = bpc_size_bytes(qc)
    n = qc.shape[-1]
    if n % wc.RICE_J:
        return torch.where(fits, torch.minimum(size_bpc, size_rle), size_bpc)
    zf = torch.where(qcc >= 0, 2 * qcc, -2 * qcc - 1).reshape(-1, n)
    size_dense = encode_size_rows(zf, wc.RICE_BITS, wc.RICE_J, wc.RICE_RSI)
    size_sparse = encode_size_rows(zf, wc.RICE_BITS, wc.RICE_J_SPARSE,
                                   wc.RICE_RSI_SPARSE)
    sparse = ((qc != 0).sum(-1) * 32 < n).reshape(-1)
    size_rice = 1 + torch.where(sparse, size_sparse,
                                size_dense).reshape(fits.shape)
    # Rice-split: z = (qc << 1) ^ (qc >> 31) mod 2^32; s = how many bits of
    # max(z) lie above the low 16, so z >> s fits 16 bits
    q64 = qc.to(torch.int64)
    z32 = ((q64 << 1) ^ (q64 >> 31)) & 0xFFFFFFFF
    maxz = z32.amax(-1)
    s = torch.zeros_like(maxz)
    for i in range(16):
        s = s + (maxz >= (1 << (16 + i))).to(torch.int64)
    zhi = ((z32 >> s[..., None]) & 0xFFFF).reshape(-1, n)
    size_hi = encode_size_rows(zhi, wc.RICE_BITS, wc.RICE_J,
                               wc.RICE_RSI).reshape(fits.shape)
    lsb_bytes = (n // 8) * s + ((n % 8) * s + 7) // 8
    size_split = 2 + lsb_bytes + size_hi
    return torch.where(fits, torch.minimum(size_rice, size_rle),
                       torch.minimum(size_bpc, size_split))


def _ladder(perm: torch.Tensor, inv_scale_perm: torch.Tensor, inv_bases,
            size_fn) -> torch.Tensor:
    """(Q, B) sizes of the scan-ordered coefficients quantized at each
    float32 ``inv_bases`` point with ``trunc(c * (inv_scale * inv_base))``.
    One point's temporaries are alive at a time (``lax.map``'s
    counterpart)."""
    return torch.stack([size_fn(quantize(perm,
                                         inv_scale_perm * float(inv_base)))
                        for inv_base in inv_bases])


def _perm(coefs: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """(B, H, W) coefficients -> (B, H·W) in scan order."""
    return torch.index_select(coefs.reshape(coefs.shape[0], -1), 1, order)


def ladder_sizes_light(coefs: torch.Tensor, order: torch.Tensor,
                       inv_scale_perm: torch.Tensor, inv_bases,
                       segbounds, consts: wc.RleModelConsts | None = None
                       ) -> torch.Tensor:
    """(Q, B) int64 light-model stream sizes for a quality ladder (the
    ``light=True`` branch of tpukit ``_device_ladder_sizes``, :403-424).
    The scan-order gather runs once."""
    return _ladder(_perm(coefs, order), inv_scale_perm, inv_bases,
                   lambda q: wenc_size_bytes_light(q, segbounds, consts))


def ladder_sizes(coefs: torch.Tensor, order: torch.Tensor,
                 inv_scale_perm: torch.Tensor, inv_bases, segbounds,
                 consts: wc.RleModelConsts | None = None) -> torch.Tensor:
    """(Q, B) int64 exact stream sizes for a quality ladder (the full
    branch of tpukit ``_device_ladder_sizes``, :403-424; one point is
    tpukit's ``_device_perm_sizes``, :389-400)."""
    return _ladder(_perm(coefs, order), inv_scale_perm, inv_bases,
                   lambda q: wenc_size_bytes(q, segbounds, consts))


def tiled_ladder_sizes(coefs_nb: torch.Tensor, order: torch.Tensor,
                       inv_scale_perm: torch.Tensor, inv_bases, segbounds,
                       consts: wc.RleModelConsts | None = None
                       ) -> torch.Tensor:
    """(n_tiles, Q, B) exact stream sizes of a batch of same-shape tiles
    (n_tiles, B, Hp, Wp): tile by tile, each tile's ladder as
    :func:`ladder_sizes` (port of tpukit ``_tiled_ladder_sizes``,
    :427-448)."""
    return torch.stack([ladder_sizes(c, order, inv_scale_perm, inv_bases,
                                     segbounds, consts) for c in coefs_nb])


def lossless_sizes(coefs: torch.Tensor, order: torch.Tensor, segbounds,
                   consts: wc.RleModelConsts | None = None) -> torch.Tensor:
    """(B,) exact byte counts of the reversible streams over the 5/3
    coefficients (port of tpukit ``_device_lossless_sizes``, :451-458)."""
    return wenc_size_bytes(_perm(coefs.to(torch.int32), order), segbounds,
                           consts)


def _device_recon(qc: torch.Tensor, scale: torch.Tensor, base, levels: int,
                  H0: int, W0: int, lo: int, hi: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """Dequantize, inverse 9/7 DWT, round and clip the quantized cube
    ``qc`` (B, Hp, Wp) int32 (port of tpukit ``_device_recon``, :229-243):
    one point of :func:`requant_recon_ladder` from coefficients that are
    already quantized, the same float32 operations in the same order."""
    qf = qc.to(torch.float32)
    deq = torch.where(qc != 0,
                      (qf + torch.sign(qf) * 0.5) * (scale * float(base)),
                      0.0)
    rec = idwt2(deq, "97", levels)[:, :H0, :W0]
    return torch.clamp(torch.round(rec), lo, hi).to(dtype)


def _check_stream_sizes(streams, sizes, what: str) -> None:
    """The size model's contract: a kept band stream is exactly as long as
    the device model priced it."""
    got = [len(s) for s in streams]
    want = [int(v) for v in sizes]
    if got != want:
        raise RuntimeError(f"{what}: the host coder's stream lengths {got} "
                           f"differ from the device size model's {want}")


def _band_pool(B: int):
    """A thread pool over bands for the host coder (its C++ releases the
    GIL), min(8, bands, cores) workers; None on one core."""
    nw = min(8, B, os.cpu_count() or 1)
    if nw <= 1:
        return None
    from concurrent.futures import ThreadPoolExecutor
    return ThreadPoolExecutor(max_workers=nw)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array, through pinned memory on CUDA."""
    if x.device.type != "cuda":
        return x.numpy()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host.numpy()


def requant_recon_ladder(coefs: torch.Tensor, inv_scale: torch.Tensor,
                         scale: torch.Tensor, inv_bases, bases, levels: int,
                         H0: int, W0: int, lo: int, hi: int,
                         dtype: torch.dtype):
    """Quantize, dequantize and inverse-transform the (B, Hp, Wp) 9/7
    coefficients at each (float32) ladder point (port of tpukit
    ``_device_requant_recon_ladder``, :246-275). Returns the
    reconstructions (Q, B, H0, W0) in ``dtype`` and two int32 wrap-around
    checksums per point, sum(qc) and sum(qc·qc), as int64 tensors (Q,).

    The dequantizer restores a nonzero q to the middle of its bin,
    ``(q + sign(q)/2) * step``; the inverse DWT is the plain
    ``kernels.dwt.idwt2`` (tpukit has no inverse Pallas kernel); the
    result is rounded half to even and clipped to [lo, hi]."""
    recons, s1, s2 = [], [], []
    for inv_base, base in zip(inv_bases, bases):
        qc = quantize(coefs, (inv_scale * float(inv_base))[None])
        q64 = qc.to(torch.int64)
        s1.append(_wrap_i32(q64.sum()))
        s2.append(_wrap_i32(((q64 * q64) & 0xFFFFFFFF).sum()))
        recons.append(_device_recon(qc, scale, base, levels, H0, W0, lo, hi,
                                    dtype))
    return torch.stack(recons), torch.stack(s1), torch.stack(s2)


def fit_base(perm_coefs: torch.Tensor, perm_scale: torch.Tensor,
             target_bytes: float, iters: int = 24, segbounds=None,
             consts: wc.RleModelConsts | None = None) -> torch.Tensor:
    """Rate targeting on the device (port of tpukit ``_fit_base_device``,
    :195-226): a geometric bisection of the base quantization step over
    [1e-3, 1e7] in float32, each probe priced with the exact size model
    (:func:`wenc_size_bytes`) of the scan-ordered coefficients. Returns
    the smallest probed step whose total size is at most the target, as a
    float32 scalar tensor. Nothing comes back to the host inside the loop;
    the size is compared with the target in float32, as JAX promotes the
    int32 sum against the float32 target. Every float32 operation rounds
    as IEEE prescribes, so the CPU and CUDA probe the same steps."""
    dev = perm_coefs.device
    inv_scale = 1.0 / perm_scale
    target = torch.tensor(target_bytes, dtype=torch.float32, device=dev)
    lo = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    hi = torch.tensor(1e7, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for _ in range(iters):
        # the float32 square root, correctly rounded (through float64: the
        # CPU's vectorized float32 sqrt is not, and CUDA's is)
        mid = torch.sqrt((lo * hi).to(torch.float64)).to(torch.float32)
        qc = quantize(perm_coefs, inv_scale[None] * (one / mid))
        size = wenc_size_bytes(qc, segbounds, consts).sum()
        too_big = size.to(torch.float32) > target
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    return hi


def _mesh_quality_point(coefs: torch.Tensor, c: "_PricingConsts", inv_base,
                        base, H0: int, W0: int, lo: int, hi: int,
                        dtype: torch.dtype):
    """ONE quality point from a mesh position's 9/7 coefficients (port of
    tpukit ``_mesh_quality_point``, :364-386): the requantized recon and
    the exact per-band sizes. These are the operations of one point of the
    single-device ladder (:func:`requant_recon_ladder`,
    :func:`ladder_sizes`), so any number of positions gives the same
    bits."""
    qc = quantize(coefs, (c.inv_scale * float(inv_base))[None])
    recon = _device_recon(qc, c.scale, base, LEVELS, H0, W0, lo, hi, dtype)
    return recon, ladder_sizes(coefs, c.order, c.inv_scale_perm, [inv_base],
                               c.segbounds, c.rle)[0]


# the mesh steps and the dp-only meshes of meshes whose sp does not divide
# a cube's band count, built once per mesh
_MESH_LADDERS: Dict[tuple, object] = {}


def mesh_for_bands(mesh, B: int):
    """sp must divide the band axis; otherwise the mesh's positions (the
    same ones, with their streams) all go on dp, as tpukit's fallback does
    (j2k_codec.py:462-472)."""
    if B % mesh.shape["sp"] == 0:
        return mesh
    key = ("dp_only", mesh)
    if key not in _MESH_LADDERS:
        from tpukit_torch.parallel.mesh import Mesh
        _MESH_LADDERS[key] = Mesh([[p] for p in mesh.positions()])
    return _MESH_LADDERS[key]


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _mark(dev: torch.device):
    """An event after the work enqueued so far on ``dev``'s current
    stream (None on the CPU, where the work is done when enqueued)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _wait(ev) -> None:
    if ev is not None:
        ev.synchronize()


class _PricingConsts:
    """A padded shape's constants on one device (scan order, the step map
    and its inverse, the inverse step map in scan order, the run-length
    model's arrays), uploaded once: an upload from pageable memory waits
    for the stream."""

    def __init__(self, Hp: int, Wp: int, device: torch.device):
        self.segbounds = wc.subband_seg_bounds(Hp, Wp, LEVELS)
        scale = _subband_steps(Hp, Wp, 1.0)
        inv_scale = np.float32(1.0) / scale
        self.order, _ = wc.device_scan_orders(Hp, Wp, LEVELS, device)
        self.order_host = wc.scan_order(Hp, Wp, LEVELS)
        # the host coder's copy: the same float32 values the device holds
        self.inv_scale_perm_host = np.ascontiguousarray(
            inv_scale.ravel()[self.order_host])
        self.inv_scale_perm = torch.from_numpy(
            self.inv_scale_perm_host).to(device)
        self.scale = torch.from_numpy(scale).to(device)
        self.inv_scale = torch.from_numpy(inv_scale).to(device)
        self.rle = wc.RleModelConsts(self.segbounds, device)


class J2KCodec(Codec):
    name = "j2k"
    encoder_desc = ("tpukit J2K (EBCOT tier-1 + PCRD-opt, "
                    "standard-conformant codestreams)")
    supports_lossy = True

    def __init__(self, tilex: Optional[int] = None,
                 tiley: Optional[int] = None, rate_fit: bool = False,
                 entropy: str = "ebcot"):
        """tilex/tiley: JP2-style independent spatial tiles; rate_fit: the
        device bisection of the base step for bpp/cr keys (device backend
        only); entropy: "ebcot" (standard codestreams) or "device" (the
        fast mode). See tpukit's J2KCodec.__init__ (j2k_codec.py:481-509)."""
        if entropy not in ("device", "ebcot"):
            raise ValueError("entropy must be 'device' or 'ebcot'")
        self.tilex = tilex
        self.tiley = tiley
        self.rate_fit = rate_fit
        self.entropy = entropy
        if entropy == "device":
            self.encoder_desc = ("tpukit J2K-class (device 5/3 & 9/7 DWT + "
                                 "Rice/bit-plane entropy backend)")
        self._consts: Dict[tuple, _PricingConsts] = {}

    def _shape_consts(self, Hp: int, Wp: int,
                      device: torch.device) -> _PricingConsts:
        key = (Hp, Wp, str(device))
        if key not in self._consts:
            self._consts[key] = _PricingConsts(Hp, Wp, device)
        return self._consts[key]

    def quality_for(self, rate: RateSpec) -> Optional[int]:
        """RateSpec → QUALITY 1..100 via the reference heuristics
        (j2k_wrap.py:32-47, :94); None for lossless/reversible."""
        if rate.lossless or rate.key is None:
            return None
        if rate.key == "quality":
            return int(rate.value)
        if rate.key == "cr":
            return quality_from_cr(rate.value)
        if rate.key == "bpp":
            return quality_from_bpp(rate.value)
        return 35  # default (j2k_wrap.py:94)

    def _tiles(self, cube: np.ndarray, opts):
        """(tx, ty) when independent tiles smaller than the cube are asked
        for, else None."""
        B, H, W = cube.shape
        tx = opts.get("tilex") or self.tilex
        ty = opts.get("tiley") or self.tiley
        if (tx and tx < W) or (ty and ty < H):
            return int(tx or W), int(ty or H)
        return None

    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, **opts) -> CodecResult:
        tiles = self._tiles(cube, opts)
        if tiles is not None:
            return self._run_tiled(cube, dtype_name, rate, *tiles,
                                   keep_bitstream,
                                   **{k: v for k, v in opts.items()
                                      if k in _TILE_OPTS})
        if self.entropy == "ebcot":
            return self._run_ebcot(cube, dtype_name, rate, keep_bitstream,
                                   cache=opts.get("device_plan_cache"),
                                   dedupe=bool(opts.get("dedupe_reps")),
                                   peak_override=opts.get("peak_override"))
        q_used = self.quality_for(rate)
        B, H, W = cube.shape
        m = 1 << LEVELS
        Hp, Wp = H + (-H) % m, W + (-W) % m
        if q_used is None:
            return self._run_lossless_device(cube, Hp, Wp, keep_bitstream,
                                             **opts)
        return self._run_lossy_device(cube, dtype_name, rate, q_used,
                                      Hp, Wp, keep_bitstream, **opts)

    def _run_tiled(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
                   tx: int, ty: int, keep_bitstream: bool,
                   **opts) -> CodecResult:
        """Independent-tile coding (TILEXSIZE/TILEYSIZE, j2k_wrap.py:81;
        port of tpukit j2k_codec.py:524-563): each spatial tile goes through
        the whole codec on its own; streams are per (tile, band). Device
        lossy tiles quantize with image-global steps (the peak of the whole
        cube), the convention of :meth:`_sweep_tiled_device` too, so the
        sequential and batched tiled sweeps give the same bytes and
        recons. A tile's device work is a slice of the sweep's upload; the
        recon is assembled where the tiles' recons are (on the device for
        the device backend)."""
        B, H, W = cube.shape
        dc = opts.pop("device_cube", None)
        recon = None
        streams: Dict[str, bytes] = {}
        sum_bytes = 0
        t_comp = t_dec = 0.0
        q_used = None
        peak = _cube_peak(cube)
        for y0 in range(0, H, ty):
            for x0 in range(0, W, tx):
                th, tw = min(ty, H - y0), min(tx, W - x0)
                sub = np.ascontiguousarray(cube[:, y0:y0 + th, x0:x0 + tw])
                if dc is not None:
                    opts["device_cube"] = dc[:, y0:y0 + th, x0:x0 + tw]
                res = self.run(sub, dtype_name, rate,
                               keep_bitstream=keep_bitstream,
                               **{**opts, "tilex": None, "tiley": None,
                                  "peak_override": peak})
                if recon is None:
                    recon = (torch.empty(cube.shape, dtype=res.recon.dtype,
                                         device=res.recon.device)
                             if isinstance(res.recon, torch.Tensor)
                             else np.empty_like(cube))
                recon[:, y0:y0 + th, x0:x0 + tw] = res.recon
                sum_bytes += res.bitstream_bytes
                t_comp += res.t_comp_s
                t_dec += res.t_dec_s
                q_used = res.extras.get("quality_used")
                if keep_bitstream and res.bitstreams:
                    for name, data in res.bitstreams.items():
                        streams[f"t_x{x0:05d}_y{y0:05d}_{name}"] = data
        return CodecResult(
            codec="j2k_gdal", encoder=self.encoder_desc,
            bitstream_bytes=sum_bytes, recon=recon,
            t_comp_s=t_comp, t_dec_s=t_dec,
            bitstreams=streams if keep_bitstream else None,
            extras={"quality_used": q_used,
                    "tilex": int(tx), "tiley": int(ty)})

    def sweep_rates(self, cube: np.ndarray, dtype_name: str, specs,
                    keep_bitstream: bool = False, **opts) -> list:
        """Amortized rate ladder (port of tpukit j2k_codec.py:565-625).
        Tiles: device-mode quality points go through the batched
        :meth:`_sweep_tiled_device`, everything else tile by tile through
        :meth:`run`. Whole cubes: ``ebcot`` ladders through
        :meth:`_sweep_ebcot`; device-mode quality points (and bpp/cr points
        without ``rate_fit``, mapped to a quality) share one DWT in
        :meth:`sweep_qualities`, and the rest go through :meth:`run`."""
        specs = list(specs)
        tiles = self._tiles(cube, opts)
        if tiles is not None:
            pp = {k: opts[k] for k in _TILE_OPTS if k in opts}
            q_ix = [i for i, s in enumerate(specs)
                    if not s.lossless and s.key == "quality"]
            out: list = [None] * len(specs)
            # kept streams go tile by tile through run(), as in tpukit
            if self.entropy == "device" and q_ix and not keep_bitstream:
                out = self._sweep_tiled_device(cube, dtype_name, specs, q_ix,
                                               *tiles,
                                               opts.get("device_cube"),
                                               opts.get("device"))
            return [r if r is not None else
                    self.run(cube, dtype_name, s,
                             keep_bitstream=keep_bitstream, **pp)
                    for r, s in zip(out, specs)]
        if self.entropy == "ebcot":
            return self._sweep_ebcot(cube, dtype_name, specs, keep_bitstream,
                                     **opts)
        qmap = [None if (self.rate_fit and s.key in ("bpp", "cr"))
                else self.quality_for(s) for s in specs]
        out = [None] * len(specs)
        lossy_ix = [i for i, q in enumerate(qmap) if q is not None]
        if lossy_ix:
            res = self.sweep_qualities(cube, dtype_name,
                                       [qmap[i] for i in lossy_ix],
                                       keep_bitstream=keep_bitstream,
                                       cache=opts.get("device_plan_cache"),
                                       device_cube=opts.get("device_cube"),
                                       mesh=opts.get("mesh"),
                                       device=opts.get("device"))
            for i, r in zip(lossy_ix, res):
                out[i] = r
        return [r if r is not None else
                self.run(cube, dtype_name, s, keep_bitstream=keep_bitstream,
                         **opts)
                for r, s in zip(out, specs)]

    # -- device entropy backend (fast mode) ---------------------------------
    def sweep_qualities(self, cube: np.ndarray, dtype_name: str, qualities,
                        keep_bitstream: bool = False,
                        cache: dict | None = None,
                        device_cube: torch.Tensor | None = None,
                        mesh=None, device=None) -> list:
        """Quality ladder of the device backend (port of tpukit
        j2k_codec.py:627-846): one 9/7 DWT (kernel K2 on CUDA) of the
        padded cube, kept in the harness ``cache`` across reps, whose wall
        counts into every point's ``t_comp_s``; the reconstructions of
        every point are enqueued first, then the exact size ladder.

        Model-first (``keep_bitstream=False``): the sizes' read-back waits
        for both. Per point: ``t_comp_s`` = DWT + an equal share of the
        sizes' wall, ``t_dec_s`` = an equal share of the residual wait for
        the recons.

        With kept streams the scan-ordered coefficients are fetched once
        per cube (cached across reps, the fetch billed with the DWT) and
        the host coder quantizes and codes them per point and band on a
        thread pool while the device works (``wenc_quant_encode_ck``, the
        same float32 multiply as :func:`quantize`). Every stream is decoded
        back and compared with the coded values, its length is held to the
        device size model, and the host's wrap-around checksums to the
        device requantizer's: a point that disagrees there gets its recon
        rebuilt from the host's coefficients (with a warning), so that
        recon == decode(stream) holds either way. ``t_comp_s`` = DWT +
        the point's coding wall, ``t_dec_s`` = its decode wall + an equal
        share of the residual wait for the device.

        ``CodecResult.recon`` is a tensor on the codec's device
        (``base.work_device``: ``device``, else ``device_cube``'s, else
        CUDA).

        With a device mesh (``mesh``, parallel/mesh.py) the ladder runs on
        its positions instead (:meth:`_sweep_qualities_mesh`), and the
        recon of point i lies on position i mod n's device. Kept streams
        are then built by the host coder from one single-device transform
        on the codec's device, and each point's total length must equal
        the mesh's size model, or the run raises."""
        B, H, W = cube.shape
        m = 1 << LEVELS
        Hp, Wp = H + (-H) % m, W + (-W) % m
        peak = _cube_peak(cube)
        info = np.iinfo(cube.dtype)
        opts = {"device_cube": device_cube, "device": device}
        dev = work_device(opts)
        c = self._shape_consts(Hp, Wp, dev)
        qualities = [int(q) for q in qualities]
        bases = np.array([base_step_for_quality(q, peak)
                          for q in qualities], np.float32)
        inv_bases = np.float32(1.0) / bases

        ckey = ("j2k_dwt", B, Hp, Wp, cube.dtype.name)

        def coefs_cached(need_perm: bool):
            """(coefs, scan-ordered host coefficients or None, DWT wall)
            through the harness cache, across reps."""
            if cache is not None and ckey in cache:
                coefs, perm_coefs, t_dwt = cache[ckey]
            else:
                t0 = time.perf_counter()
                coefs = dwt97(device_work(cube, opts, m, torch.float32),
                              LEVELS)
                _wait(_mark(dev))
                perm_coefs = None
                t_dwt = time.perf_counter() - t0
            if need_perm and perm_coefs is None:
                # the host coder's input: one bulk fetch per cube
                t0 = time.perf_counter()
                perm_coefs = _to_host(_perm(coefs, c.order))
                t_dwt += time.perf_counter() - t0
            if cache is not None:
                cache[ckey] = (coefs, perm_coefs, t_dwt)
            return coefs, perm_coefs, t_dwt

        if mesh is not None:
            res = self._sweep_qualities_mesh(mesh, cube, qualities, bases,
                                             inv_bases, Hp, Wp)
            if keep_bitstream:
                _, perm_coefs, _ = coefs_cached(need_perm=True)
                for r, inv_base in zip(res, inv_bases):
                    t0 = time.perf_counter()
                    with mem_phase("comp"):
                        enc = [wc.wenc_quant_encode_ck(
                            cf, c.inv_scale_perm_host, inv_base,
                            segbounds=c.segbounds)[0] for cf in perm_coefs]
                    r.t_comp_s += time.perf_counter() - t0
                    got = sum(len(e) for e in enc)
                    if got != r.bitstream_bytes:
                        raise RuntimeError(
                            "mesh size model / host coder mismatch: "
                            f"{got} != {r.bitstream_bytes}")
                    r.bitstreams = {f"b{b+1:02d}.j2c": e
                                    for b, e in enumerate(enc)}
            return res

        coefs, perm_coefs, t_dwt = coefs_cached(keep_bitstream)
        # the recon ladder goes first: the device works on it while the
        # host enqueues the sizes (and codes, with kept streams)
        recons, s1d, s2d = requant_recon_ladder(
            coefs, c.inv_scale, c.scale, inv_bases, bases, LEVELS, H, W,
            int(info.min), int(info.max), _torch_dtype(cube.dtype))
        if keep_bitstream:
            return self._sweep_qualities_kept(
                cube, qualities, bases, inv_bases, coefs, perm_coefs, t_dwt,
                recons, s1d, s2d, c, dev)
        t0 = time.perf_counter()
        with mem_phase("comp"):
            sizes = ladder_sizes(coefs, c.order, c.inv_scale_perm, inv_bases,
                                 c.segbounds, c.rle).cpu().numpy()
        t_sizes = time.perf_counter() - t0
        t0 = time.perf_counter()
        with mem_phase("dec"):
            _wait(_mark(dev))
        t_rec = time.perf_counter() - t0
        Q = max(len(qualities), 1)
        return [CodecResult(
            codec="j2k_gdal", encoder=self.encoder_desc,
            bitstream_bytes=int(sizes[i].sum()), recon=recons[i],
            t_comp_s=t_dwt + t_sizes / Q, t_dec_s=t_rec / Q,
            bitstreams=None, extras={"quality_used": q})
            for i, q in enumerate(qualities)]

    def _sweep_qualities_mesh(self, mesh, cube, qualities, bases, inv_bases,
                              Hp: int, Wp: int) -> list:
        """The quality ladder on the mesh's positions (port of tpukit
        j2k_codec.py:1477-1533): point i runs on position i mod n, each
        position computes its own 9/7 DWT (kernel K2 on CUDA) of its own
        upload of the cube once, and every point is the same single-point
        program (:func:`_mesh_quality_point`, kernel K1 in its size model)
        on its position's stream. The results are the single-device
        ladder's bit for bit, for any number of positions. ``t_comp_s`` is
        an equal share of the wall up to the sizes' read-back, ``t_dec_s``
        of the wait for the recons."""
        positions = mesh.positions()
        B, H0, W0 = cube.shape
        info = np.iinfo(cube.dtype)
        dtype = _torch_dtype(cube.dtype)
        m = 1 << LEVELS
        # the constants are made on the caller's stream, before any
        # position starts (a position waits for that stream)
        consts = {p.device: self._shape_consts(Hp, Wp, p.device)
                  for p in positions[:len(qualities)]}
        t0 = time.perf_counter()
        with mem_phase("comp"):
            coefs_by_pos: Dict[object, torch.Tensor] = {}
            points = []
            for i, (base, inv_base) in enumerate(zip(bases, inv_bases)):
                pos = positions[i % len(positions)]
                with pos.run():
                    if pos not in coefs_by_pos:
                        coefs_by_pos[pos] = dwt97(device_work(
                            cube, {"device": pos.device}, m, torch.float32),
                            LEVELS)
                    points.append((pos,) + _mesh_quality_point(
                        coefs_by_pos[pos], consts[pos.device], inv_base,
                        base, H0, W0, int(info.min), int(info.max), dtype))
            sizes = [pos.fetch(s) for pos, _, s in points]
        t_comp = time.perf_counter() - t0
        t0 = time.perf_counter()
        with mem_phase("dec"):
            recons = [pos.handoff(r) for pos, r, _ in points]
            for pos in coefs_by_pos:
                pos.synchronize()
        t_rec = time.perf_counter() - t0
        Q = max(len(qualities), 1)
        return [CodecResult(
            codec="j2k_gdal", encoder=self.encoder_desc,
            bitstream_bytes=int(sizes[i].sum()), recon=recons[i],
            t_comp_s=t_comp / Q, t_dec_s=t_rec / Q,
            bitstreams=None, extras={"quality_used": q})
            for i, q in enumerate(qualities)]

    def sweep_rd(self, cube: np.ndarray, dtype_name: str, qualities,
                 valid: np.ndarray | None = None, device=None) -> list:
        """Full RD ladder (tpukit j2k_codec.py:848-874):
        :meth:`sweep_qualities`, then ``quality_stats`` of every point on
        the same device (``base.work_device``: ``device``, else CUDA),
        stacked there and fetched after the last point. Returns
        ``[(CodecResult, metrics dict)]`` with the reference metric keys
        (run_codec.py:294-304)."""
        from tpukit_torch.io.bitdepth import effective_data_range
        from tpukit_torch.metrics.quality import (assemble_quality_many,
                                                  quality_stats)

        dev = work_device({"device": device})
        ref_dev = torch.from_numpy(cube.astype(np.int32)).to(dev)
        vm = (torch.ones(cube.shape[-2:], dtype=torch.bool, device=dev)
              if valid is None
              else torch.from_numpy(np.asarray(valid).astype(bool)).to(dev))
        dr = float(effective_data_range(cube, dtype_name))
        results = self.sweep_qualities(cube, dtype_name, qualities,
                                       device=dev)
        if not results:
            return []
        stats = [quality_stats(ref_dev, r.recon.to(torch.int32), vm)
                 for r in results]
        # stacked on the device, copied back once all points are done
        host = {k: torch.stack([s[k] for s in stats]).cpu().numpy()
                for k in stats[0]}
        return list(zip(results, assemble_quality_many(host, dr)))

    def _sweep_qualities_kept(self, cube, qualities, bases, inv_bases, coefs,
                              perm_coefs, t_dwt, recons, s1d, s2d, c,
                              dev) -> list:
        """The kept-stream branch of :meth:`sweep_qualities` (tpukit
        j2k_codec.py:765-846), entered with the recon ladder enqueued."""
        B, H, W = cube.shape
        Hp, Wp = coefs.shape[-2:]
        info = np.iinfo(cube.dtype)
        # the device prices what the host codes, behind the recon ladder
        sizes_dev = ladder_sizes(coefs, c.order, c.inv_scale_perm, inv_bases,
                                 c.segbounds, c.rle)
        results = []
        pend = []   # (index, base, host checksums)
        pool = _band_pool(B)
        pmap = pool.map if pool is not None else map
        try:
            for i, q in enumerate(qualities):
                inv_base = inv_bases[i]
                t0 = time.perf_counter()
                with mem_phase("comp"):
                    # fused native quantize + encode: trunc(c * (inv_step *
                    # inv_base)), the device requantizer's float32 operations
                    # in its association order; the wrap-around checksums
                    # accumulate in the same pass
                    enc_qc = list(pmap(
                        lambda cf: wc.wenc_quant_encode_ck(
                            cf, c.inv_scale_perm_host, inv_base,
                            segbounds=c.segbounds), perm_coefs))
                    encoded = [e for e, _, _, _ in enc_qc]
                t_comp = time.perf_counter() - t0 + t_dwt
                t0 = time.perf_counter()
                with mem_phase("dec"):
                    decs = list(pmap(
                        lambda e: wc.wenc_decode(e, Hp * Wp, c.segbounds),
                        encoded))
                    for b in range(B):
                        if not np.array_equal(decs[b], enc_qc[b][1]):
                            raise RuntimeError(
                                "host coder round-trip mismatch (quality "
                                f"{q}, band {b + 1})")
                t_dec = time.perf_counter() - t0
                # per-band sums mod 2^32 fold into the cube's total
                s1h = sum(s1 for _, _, s1, _ in enc_qc) & 0xFFFFFFFF
                s2h = sum(s2 for _, _, _, s2 in enc_qc) & 0xFFFFFFFF
                to_i32 = lambda v: v - (1 << 32) if v >= (1 << 31) else v
                pend.append((i, bases[i], to_i32(s1h), to_i32(s2h)))
                results.append(CodecResult(
                    codec="j2k_gdal", encoder=self.encoder_desc,
                    bitstream_bytes=sum(len(e) for e in encoded),
                    recon=recons[i], t_comp_s=t_comp, t_dec_s=t_dec,
                    bitstreams={f"b{b+1:02d}.j2c": e
                                for b, e in enumerate(encoded)},
                    extras={"quality_used": q}))
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        # settle the ladder: one wait and one small fetch. Only the device
        # time still outstanding after the host's coding is billed, shared
        # equally by the points' t_dec
        t0 = time.perf_counter()
        sizes = sizes_dev.cpu().numpy()
        s1d_h, s2d_h = s1d.cpu().tolist(), s2d.cpu().tolist()
        t_dev = time.perf_counter() - t0
        for r, sz in zip(results, sizes):
            r.t_dec_s += t_dev / max(len(results), 1)
            _check_stream_sizes(r.bitstreams.values(), sz,
                                f"j2k device mode, quality "
                                f"{r.extras['quality_used']}")
        for (idx, base, s1h, s2h), s1, s2 in zip(pend, s1d_h, s2d_h):
            if (int(s1), int(s2)) != (s1h, s2h):
                # the device's float32 multiply disagreed with the host's:
                # rebuild this point's recon from the host's coefficients so
                # that recon == decode(stream) stays exact
                import warnings
                warnings.warn("device requantization checksum mismatch; "
                              "uploading host coefficients")
                inv_base = np.float32(1.0) / base
                perm = (perm_coefs * (c.inv_scale_perm_host
                                      * inv_base)[None]).astype(np.int32)
                qc = np.empty((B, Hp * Wp), np.int32)
                qc[:, c.order_host] = perm     # undo the coder scan order
                results[idx].recon = _device_recon(
                    torch.from_numpy(qc.reshape(B, Hp, Wp)).to(dev), c.scale,
                    base, LEVELS, H, W, int(info.min), int(info.max),
                    _torch_dtype(cube.dtype))
        return results

    def _run_lossy_device(self, cube, dtype_name, rate, q_used, Hp, Wp,
                          keep_bitstream: bool = False, **opts):
        """One lossy point (port of tpukit j2k_codec.py:1535-1607, and of
        :944-1002 with kept streams): the 9/7 DWT (K2), the scan-order
        gather, with ``rate_fit`` and a bpp/cr key the base step fitted on
        the device (:func:`fit_base`), the exact sizes, and the requantized
        reconstruction. Without kept streams nothing bulky moves: only the
        byte counts (and the fitted base) come to the host.

        With ``keep_bitstream`` the coefficients come to the host once, are
        quantized there (``trunc(c * (inv_scale * inv_base))`` in float32,
        the device's operations) and coded band by band
        (``wenc_encode``); each stream's length must equal the device size
        model's; the reconstruction is the decoded streams' values,
        uploaded and run through :func:`_device_recon`."""
        B, H, W = cube.shape
        info = np.iinfo(cube.dtype)
        peak = float(opts.get("peak_override") or 0.0) or _cube_peak(cube)
        fit_mode = self.rate_fit and rate.key in ("bpp", "cr")
        dev = work_device(opts)
        c = self._shape_consts(Hp, Wp, dev)

        t0 = time.perf_counter()
        with mem_phase("comp"):
            coefs = dwt97(device_work(cube, opts, 1 << LEVELS,
                                      torch.float32), LEVELS)
            # one scan-order gather serves the fit and the sizes
            perm = _perm(coefs, c.order)
            target = None
            if fit_mode:
                if rate.key == "bpp":
                    target = rate.value * H * W * B / 8.0
                else:
                    target = (W * H * B * 2.0) / max(rate.value, 1e-6)
                base = float(fit_base(perm, c.scale.reshape(-1)[c.order],
                                      target, segbounds=c.segbounds,
                                      consts=c.rle))
                q_used = None
            else:
                base = base_step_for_quality(q_used, peak)
            inv_base = np.float32(1.0) / np.float32(base)
            sizes = ladder_sizes(coefs, c.order, c.inv_scale_perm,
                                 [inv_base], c.segbounds, c.rle)[0]
            encoded = None
            if keep_bitstream:
                inv_steps = c.inv_scale_perm_host * inv_base
                qc = np.trunc(_to_host(perm) * inv_steps[None]) \
                    .astype(np.int32)
                encoded = [wc.wenc_encode(qc[b], segbounds=c.segbounds)
                           for b in range(B)]
                _check_stream_sizes(encoded, sizes.cpu().numpy(),
                                    "j2k device mode")
            sum_bytes = int(sizes.sum())
        t_comp = time.perf_counter() - t0

        t0 = time.perf_counter()
        with mem_phase("dec"):
            if keep_bitstream:
                dec = np.empty((B, Hp * Wp), np.int32)
                for b in range(B):
                    dec[b, c.order_host] = wc.wenc_decode(
                        encoded[b], Hp * Wp, c.segbounds)
                recon = _device_recon(
                    torch.from_numpy(dec.reshape(B, Hp, Wp)).to(dev),
                    c.scale, np.float32(base), LEVELS, H, W, int(info.min),
                    int(info.max), _torch_dtype(cube.dtype))
            else:
                recons, _, _ = requant_recon_ladder(
                    coefs, c.inv_scale, c.scale, [inv_base],
                    [np.float32(base)], LEVELS, H, W, int(info.min),
                    int(info.max), _torch_dtype(cube.dtype))
                recon = recons[0]
            _wait(_mark(dev))
        t_dec = time.perf_counter() - t0

        extras = {"quality_used": (int(q_used) if q_used is not None
                                   else None)}
        if fit_mode:
            extras.update(rate_fit=1, base_step=float(base),
                          target_bytes=int(target))
        return CodecResult(
            codec="j2k_gdal", encoder=self.encoder_desc,
            bitstream_bytes=sum_bytes, recon=recon,
            t_comp_s=t_comp, t_dec_s=t_dec,
            bitstreams=({f"b{b+1:02d}.j2c": e for b, e in enumerate(encoded)}
                        if keep_bitstream else None),
            extras=extras)

    def _run_lossless_device(self, cube, Hp, Wp, keep_bitstream: bool = False,
                             **opts):
        """Reversible point (port of tpukit j2k_codec.py:1609-1646, and of
        :912-943 with kept streams): the common trailing zero bits are
        shifted out, the integer 5/3 DWT runs on the device, the exact
        sizes of the full streams are summed (+1 byte per band, the
        stream's shift prefix), and the reconstruction is the inverse
        transform, which restores the input exactly. With
        ``keep_bitstream`` the scan-ordered coefficients come to the host
        and each band is coded as the shift byte + ``wenc_encode``; the
        lengths must equal the model's, and the reconstruction is the
        inverse transform of the decoded streams, shifted back by the
        stream's own prefix."""
        H0, W0 = cube.shape[-2:]
        B = cube.shape[0]
        dev = work_device(opts)
        c = self._shape_consts(Hp, Wp, dev)
        t0 = time.perf_counter()
        with mem_phase("comp"):
            shift = trailing_zero_shift(cube)
            wi = device_work(cube, opts, 1 << LEVELS, torch.int32)
            if shift:
                wi = wi >> shift        # exact: the dropped LSBs are zero
            coefs = dwt2(wi, "53", LEVELS)
            sizes = lossless_sizes(coefs, c.order, c.segbounds, c.rle) + 1
            encoded = None
            if keep_bitstream:
                perm = _to_host(_perm(coefs, c.order))
                encoded = [bytes([shift]) + wc.wenc_encode(
                    perm[b], segbounds=c.segbounds) for b in range(B)]
                _check_stream_sizes(encoded, sizes.cpu().numpy(),
                                    "j2k device mode, lossless")
            sum_bytes = int(sizes.sum())
        t_comp = time.perf_counter() - t0

        t0 = time.perf_counter()
        with mem_phase("dec"):
            if keep_bitstream:
                dec = np.empty((B, Hp * Wp), np.int32)
                for b in range(B):
                    dec[b, c.order_host] = wc.wenc_decode(
                        encoded[b][1:], Hp * Wp, c.segbounds)
                coefs = torch.from_numpy(dec.reshape(B, Hp, Wp)).to(dev)
                # the decoder trusts the stream's own shift prefix
                shift = encoded[0][0]
            rec = idwt2(coefs, "53", LEVELS)[:, :H0, :W0]
            if shift:
                rec = rec << shift
            recon = rec.to(_torch_dtype(cube.dtype))
            _wait(_mark(dev))
        t_dec = time.perf_counter() - t0
        return CodecResult(
            codec="j2k_gdal", encoder=self.encoder_desc,
            bitstream_bytes=sum_bytes, recon=recon,
            t_comp_s=t_comp, t_dec_s=t_dec,
            bitstreams=({f"b{b+1:02d}.j2c": e for b, e in enumerate(encoded)}
                        if keep_bitstream else None),
            # tpukit's kept-stream run reports no lsb_shift: the stream's
            # prefix byte carries it
            extras=({"quality_used": None} if keep_bitstream
                    else {"quality_used": None, "lsb_shift": shift}))

    def _sweep_tiled_device(self, cube: np.ndarray, dtype_name: str, specs,
                            q_ix, tx: int, ty: int,
                            device_cube: torch.Tensor | None = None,
                            device=None) -> list:
        """Batched tiled device sweep of the QUALITY specs ``q_ix`` (port of
        tpukit j2k_codec.py:1381-1475): tiles grouped by shape, at most
        ``_TILE_BATCH`` to a batch, each batch stacked along the band axis
        as one (n_tiles·B, th, tw) cube with one DWT (K2), one size ladder
        (tile by tile) and one recon ladder. Quantizer steps are
        image-global, as in :meth:`_run_tiled`, so the result equals the
        sequential tiled run. The tiles are cut from ``device_cube`` (from
        the host cube without one) on the codec's device
        (``base.work_device``), and the recons are assembled there.
        ``t_comp_s`` is the wall up to the last batch's sizes, ``t_dec_s``
        that of reading the sizes and assembling the recons, each shared
        equally by the points. Returns a list aligned with ``specs``; other
        entries are None."""
        B, H, W = cube.shape
        info = np.iinfo(cube.dtype)
        m = 1 << LEVELS
        peak = _cube_peak(cube)
        qualities = [self.quality_for(specs[i]) for i in q_ix]
        bases = np.array([base_step_for_quality(q, peak)
                          for q in qualities], np.float32)
        inv_bases = np.float32(1.0) / bases
        Q = len(q_ix)
        dev = work_device({"device": device, "device_cube": device_cube})
        src = (device_cube if device_cube is not None
               else torch.from_numpy(np.ascontiguousarray(cube))).to(dev)

        groups: Dict[tuple, list] = {}
        for y0 in range(0, H, ty):
            for x0 in range(0, W, tx):
                th, tw = min(ty, H - y0), min(tx, W - x0)
                groups.setdefault((th, tw), []).append((y0, x0))
        batches = [(shape, tiles[c0:c0 + _TILE_BATCH])
                   for shape, tiles in groups.items()
                   for c0 in range(0, len(tiles), _TILE_BATCH)]

        recons = torch.empty((Q, B, H, W), dtype=_torch_dtype(cube.dtype),
                             device=dev)
        bytes_q = np.zeros(Q, np.int64)
        t0 = time.perf_counter()
        pend = []
        sized = None
        with mem_phase("comp"):
            for (th, tw), tiles in batches:
                Hp, Wp = th + (-th) % m, tw + (-tw) % m
                c = self._shape_consts(Hp, Wp, dev)
                work = torch.stack([src[:, y0:y0 + th, x0:x0 + tw]
                                    .to(torch.float32) for y0, x0 in tiles])
                coefs = dwt97(edge_pad(work.reshape(len(tiles) * B, th, tw),
                                       Hp, Wp), LEVELS)
                sizes = tiled_ladder_sizes(
                    coefs.reshape(len(tiles), B, Hp, Wp), c.order,
                    c.inv_scale_perm, inv_bases, c.segbounds, c.rle)
                sized = _mark(dev)
                recs, _, _ = requant_recon_ladder(
                    coefs, c.inv_scale, c.scale, inv_bases, bases, LEVELS,
                    th, tw, int(info.min), int(info.max), recons.dtype)
                pend.append(((th, tw), tiles, sizes, recs))
            # bill the encode-side device work (DWT and size ladders) to
            # t_comp, as tpukit does (:1449-1453)
            _wait(sized)
        t_comp = time.perf_counter() - t0

        t0 = time.perf_counter()
        with mem_phase("dec"):
            for (th, tw), tiles, sizes, recs in pend:
                bytes_q += sizes.cpu().numpy().sum(axis=(0, 2))
                rh = recs.reshape(Q, len(tiles), B, th, tw)
                for n, (y0, x0) in enumerate(tiles):
                    recons[:, :, y0:y0 + th, x0:x0 + tw] = rh[:, n]
            _wait(_mark(dev))
        t_dec = time.perf_counter() - t0

        out: list = [None] * len(specs)
        for qi, i in enumerate(q_ix):
            out[i] = CodecResult(
                codec="j2k_gdal", encoder=self.encoder_desc,
                bitstream_bytes=int(bytes_q[qi]), recon=recons[qi],
                t_comp_s=t_comp / Q, t_dec_s=t_dec / Q, bitstreams=None,
                extras={"quality_used": int(qualities[qi]),
                        "tilex": int(tx), "tiley": int(ty)})
        return out

    # -- standard-conformant EBCOT backend ----------------------------------
    def _ebcot_target(self, rate: RateSpec, B: int, H: int, W: int) -> int:
        """Total byte budget for bpp/cr rate keys (bpp is per band-pixel,
        cr is against raw 16-bit)."""
        if rate.key == "bpp":
            return int(rate.value * H * W * B / 8.0)
        return int((W * H * B * 2.0) / max(rate.value, 1e-6))

    def _quality_bases(self, cube: np.ndarray, qual_specs) -> np.ndarray:
        """float32 base steps of the QUALITY specs, at the cube's peak."""
        peak = _cube_peak(cube)
        return np.array([base_step_for_quality(self.quality_for(s), peak)
                         for s in qual_specs], np.float32)

    def _price_targets(self, cube: np.ndarray,
                       qual_specs: Dict[int, RateSpec],
                       device_cube: torch.Tensor | None = None
                       ) -> Callable[[], Dict[int, int]]:
        """Enqueue the pricing of the QUALITY points ``qual_specs`` ({spec
        index: spec}) on ``device_cube``'s device (the CPU without one) and
        return ``wait``, which returns the byte targets {spec index: total
        bytes over the bands}.

        On CUDA nothing here waits for the device: the constants are
        uploaded first, the DWT (kernel K2) and the size ladder are
        enqueued, and the sizes start their copy to pinned host memory, so
        the caller's host work runs while the device prices."""
        B, H, W = cube.shape
        m = 1 << LEVELS
        Hp, Wp = H + (-H) % m, W + (-W) % m
        if device_cube is None:
            device_cube = torch.from_numpy(np.ascontiguousarray(cube))
        c = self._shape_consts(Hp, Wp, device_cube.device)
        inv_bases = np.float32(1.0) / self._quality_bases(
            cube, qual_specs.values())

        coefs = dwt97(edge_pad(device_cube.to(torch.float32), Hp, Wp),
                      LEVELS)
        sizes = ladder_sizes_light(coefs, c.order, c.inv_scale_perm,
                                   inv_bases, c.segbounds, c.rle)
        done = None
        if sizes.device.type == "cuda":
            host = torch.empty(sizes.shape, dtype=sizes.dtype,
                               pin_memory=True)
            host.copy_(sizes, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(sizes.device))
        else:
            host = sizes

        def wait() -> Dict[int, int]:
            if done is not None:
                done.synchronize()
            return {i: int(s.sum()) for i, s in zip(qual_specs, host)}
        return wait

    def _run_ebcot(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
                   keep_bitstream: bool, cache=None,
                   dedupe: bool = False,
                   peak_override=None) -> CodecResult:
        """One rate point through the standard-codestream backend (port of
        tpukit j2k_codec.py:1033-1149, host only): per-band .j2c streams,
        bpp/cr points truncated by PCRD to their byte budget, lossless and
        quality points emitted whole. With a harness ``cache``, reps reuse
        the tier-1 analysis; the finished point only under
        ``dedupe_reps``. ``t_dec_s`` is one real decode per point; later
        reps reconstruct through the truncated-decode model (pinned
        bit-identical to JP2Decoder) and report its wall separately."""
        B, H, W = cube.shape
        info = np.iinfo(cube.dtype)
        depth, signed = info.bits, info.min < 0
        q_used = self.quality_for(rate)
        lossless = q_used is None

        pkey = ("j2c_single", B, H, W, cube.dtype.name,
                _cube_token(cube), float(peak_override or 0.0), rate.key,
                None if rate.value is None else float(rate.value),
                bool(rate.lossless))
        hit = (cache.get(pkey) if (cache is not None and dedupe)
               else None)
        if hit is None:
            if lossless:
                wavelet, base = "53", 1.0
            elif rate.key in ("bpp", "cr"):
                wavelet, base = "97", 1.0
            else:
                peak = float(peak_override or 0.0) or _cube_peak(cube)
                wavelet, base = "97", base_step_for_quality(q_used, peak)
            plankey = ("j2c_single_plans", B, H, W, cube.dtype.name,
                       _cube_token(cube), wavelet, float(base))
            cached_plans = (cache.get(plankey) if cache is not None
                            else None)
            # the plans and the model recon band-parallel (the contract
            # above _band_plans); the truncation stays one serial call
            pool = _band_pool(B)
            pmap = pool.map if pool is not None else map
            try:
                with mem_phase("comp"):
                    t0 = time.perf_counter()
                    if cached_plans is None:
                        plans = _band_plans(cube, depth, signed, wavelet,
                                            base, pmap)
                        t_plan = time.perf_counter() - t0
                        if cache is not None:
                            cache[plankey] = (plans, t_plan)
                    else:
                        plans, t_plan = cached_plans
                    t0 = time.perf_counter()
                    if lossless or rate.key not in ("bpp", "cr"):
                        sels = [p._select_all() for p in plans]
                        streams = [p.lossless() for p in plans]
                    else:
                        streams, sels = at_size_multi(
                            plans, self._ebcot_target(rate, B, H, W),
                            return_sel=True)
                        q_used = None
                t_comp = t_plan + (time.perf_counter() - t0)
                rdkey = ("j2c_realdec_single",) + pkey[1:]
                t_real = cache.get(rdkey) if cache is not None else None
                t_model = None
                t0 = time.perf_counter()
                with mem_phase("dec"):
                    recon = np.empty_like(cube)
                    if t_real is None:
                        _decode_bands_into(recon, streams, info, cube.dtype)
                        t_real = time.perf_counter() - t0
                        if cache is not None:
                            cache[rdkey] = t_real
                    else:
                        _model_bands_into(recon, plans, sels, info, pmap)
                        t_model = time.perf_counter() - t0
            finally:
                if pool is not None:
                    pool.shutdown()
            t_dec = t_real
            hit = (streams, recon, t_comp, t_dec, q_used, t_model)
            if cache is not None and dedupe:
                held = sum(
                    v[1].nbytes + sum(len(s) for s in v[0])
                    for k, v in cache.items()
                    if isinstance(k, tuple) and k and k[0] == "j2c_single")
                if held + recon.nbytes + sum(len(s) for s in streams) \
                        <= _PCACHE_BYTES:
                    cache[pkey] = hit
        streams, recon, t_comp, t_dec, q_used, t_model = hit

        extras = {"quality_used": (int(q_used) if q_used is not None
                                   else None), "entropy": "ebcot"}
        if t_model is not None:
            extras["t_dec_model_s"] = t_model
        return CodecResult(
            codec="j2k_gdal", encoder=self.encoder_desc,
            bitstream_bytes=sum(len(s) for s in streams), recon=recon,
            t_comp_s=t_comp, t_dec_s=t_dec,
            bitstreams=({f"b{b+1:02d}.j2c": s for b, s in
                         enumerate(streams)} if keep_bitstream else None),
            extras=extras)

    def _sweep_ebcot(self, cube: np.ndarray, dtype_name: str, specs,
                     keep_bitstream: bool, **opts) -> list:
        """Amortized standard-codestream ladder (port of tpukit
        j2k_codec.py:1151-1379): ONE tier-1 analysis of the whole cube
        feeds every lossy point via PCRD truncation. bpp/cr points truncate
        to the requested byte budget; QUALITY points to the budget priced
        by :meth:`_price_targets`. Lossless points go through _run_ebcot.

        The plan set and the priced targets are pure functions of the input
        and are reused across reps through the harness ``cache``. Reusing a
        finished point (streams, recon, timings) happens only under
        ``dedupe_reps``; honest reps (the default) re-run every point's
        truncation and synthesis, so their timings are per-rep.
        ``t_comp_s`` is the analysis wall, plus the residual wait for the
        priced sizes after it (``t_extra``), plus the point's truncation.

        A device mesh (``opts["mesh"]``) is ignored here by design, not as
        a fallback (tpukit :1167-1175): the codec work is host C++ (tier-1
        analysis, PCRD truncation, synthesis) plus one pricing ladder, which
        runs on one fixed device, the codec's, so that the byte targets do
        not depend on the mesh's layout (tpukit :1229-1237) and a ``--mesh``
        CSV equals the single-device one; the runner spreads the metric
        pass over the mesh."""
        B, H, W = cube.shape
        info = np.iinfo(cube.dtype)
        depth, signed = info.bits, info.min < 0
        specs = list(specs)
        out: list = [None] * len(specs)
        ladder = [i for i, s in enumerate(specs)
                  if not s.lossless and s.key in ("bpp", "cr", "quality")]
        cache = opts.get("device_plan_cache")
        dedupe = bool(opts.get("dedupe_reps"))
        # one band pool for the call: the plans and every point's model
        # recon run on it (the contract above _band_plans). The points
        # stay one after another, so t_comp_s, t_dec_s and t_dec_model_s
        # time that point's own work, as in tpukit; at_size_multi stays
        # one serial call a point (a pool inside its bisection pays more
        # per step than the step costs), and the real decode is already
        # band-parallel (_decode_bands_into)
        pool = _band_pool(B) if ladder else None
        pmap = pool.map if pool is not None else map
        try:
            if ladder:
                qual_ix = [i for i in ladder if specs[i].key == "quality"]
                targets: Dict[int, int] = {}
                base = 1.0
                t_extra = 0.0
                pending = None
                tkey = ("j2c_targets", B, H, W, cube.dtype.name,
                        _cube_token(cube),
                        tuple((specs[i].key, specs[i].value) for i in qual_ix))
                if qual_ix and cache is not None and tkey in cache:
                    targets.update(cache[tkey][0])
                    base, t_extra = cache[tkey][1], cache[tkey][2]
                elif qual_ix:
                    qual_specs = {i: specs[i] for i in qual_ix}
                    # enqueued before the host analysis below, read after it
                    dc = opts.get("device_cube")
                    if dc is None:
                        dc = torch.from_numpy(np.ascontiguousarray(cube))
                    pending = self._price_targets(cube, qual_specs,
                                                  dc.to(work_device(opts)))
                    base = min(1.0, float(self._quality_bases(
                        cube, qual_specs.values()).min()))
                for i in ladder:
                    if specs[i].key != "quality":
                        targets[i] = self._ebcot_target(specs[i], B, H, W)

                ckey = ("j2c_plans", B, H, W, cube.dtype.name,
                        _cube_token(cube), base)
                plans = t_plan = None
                if cache is not None and ckey in cache:
                    plans, t_plan = cache[ckey]
                if plans is None:
                    t0 = time.perf_counter()
                    with mem_phase("comp"):
                        plans = _band_plans(cube, depth, signed, "97", base,
                                            pmap)
                    t_plan = time.perf_counter() - t0
                    if cache is not None:
                        cache[ckey] = (plans, t_plan)
                if pending is not None:
                    # the residual wait for the priced sizes bills here
                    t0 = time.perf_counter()
                    targets.update(pending())
                    t_extra += time.perf_counter() - t0
                    if cache is not None:
                        cache[tkey] = ({i: targets[i] for i in qual_ix},
                                       base, t_extra)
                # point-level reuse across reps only under --dedupe-reps;
                # honest reps get a call-local dict, so identical targets
                # WITHIN one ladder still share
                pcache = (cache.setdefault(("j2c_points",) + ckey[1:], {})
                          if (cache is not None and dedupe) else {})
                # t_dec_s comes from ONE real decode per (tile, rate); later
                # reps re-report it and reconstruct through the
                # truncated-decode model
                rdcache = (cache.setdefault(("j2c_realdec",) + ckey[1:], {})
                           if cache is not None else {})
                for i in ladder:
                    hit = pcache.get(targets[i])
                    if hit is None:
                        t0 = time.perf_counter()
                        with mem_phase("comp"):
                            streams, sels = at_size_multi(plans, targets[i],
                                                          return_sel=True)
                        t_trunc = time.perf_counter() - t0
                        t_real = rdcache.get(targets[i])
                        t_model = None
                        t0 = time.perf_counter()
                        with mem_phase("dec"):
                            recon = np.empty_like(cube)
                            if t_real is None:
                                _decode_bands_into(recon, streams, info,
                                                   cube.dtype)
                                t_real = time.perf_counter() - t0
                                rdcache[targets[i]] = t_real
                            else:
                                _model_bands_into(recon, plans, sels, info,
                                                  pmap)
                                t_model = time.perf_counter() - t0
                        hit = (streams, recon, t_trunc, t_real, t_model)
                        # bounded: each entry pins a full-cube recon
                        held = sum(r.nbytes for _, r, _, _, _ in
                                   pcache.values())
                        if held + recon.nbytes <= _PCACHE_BYTES:
                            pcache[targets[i]] = hit
                    streams, recon, t_trunc, t_real, t_model = hit
                    q_used = (self.quality_for(specs[i])
                              if specs[i].key == "quality" else None)
                    extras = {"quality_used": q_used, "entropy": "ebcot"}
                    if t_model is not None:
                        extras["t_dec_model_s"] = t_model
                    out[i] = CodecResult(
                        codec="j2k_gdal", encoder=self.encoder_desc,
                        bitstream_bytes=sum(len(s) for s in streams),
                        recon=recon, t_comp_s=t_plan + t_extra + t_trunc,
                        t_dec_s=t_real,
                        bitstreams=({f"b{b+1:02d}.j2c": s for b, s in
                                     enumerate(streams)} if keep_bitstream
                                    else None),
                        extras=extras)
        finally:
            if pool is not None:
                pool.shutdown()
        for i, s in enumerate(specs):
            if out[i] is None:
                out[i] = self._run_ebcot(cube, dtype_name, s,
                                         keep_bitstream, cache=cache,
                                         dedupe=dedupe)
        return out
