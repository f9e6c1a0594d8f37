# -*- coding: utf-8 -*-
"""JPEG 2000 codec, standard-codestream (``ebcot``) backend — port of
tpukit/codecs/j2k_codec.py.

Per band, tpukit's host C++ writes ISO/IEC 15444-1 codestreams
(``tpukit.io.j2c_enc``: EBCOT tier-1 and PCRD-opt truncation) and decodes
them (``tpukit.io.jp2.JP2Decoder``); the port imports both unchanged. A
quality ladder costs one tier-1 analysis per tile (``J2CPlan``): each lossy
point is a PCRD truncation of it to a byte target (``at_size_multi``).

The device work is the pricing of those targets: for QUALITY points the
target is the byte size that the light integer size model
(``wenc_size_bytes_light``: embedded bit-plane and run-length candidates)
gives the cube quantized at that quality's steps. That is a 5-level 9/7
DWT of the padded cube (kernel K2, ``kernels.dwt97``, on CUDA) and a
ladder of size models, on the device of the sweep's cube upload
(``device_cube``). The targets are budgets, so they must not depend on
where they were computed (tpukit j2k_codec.py:1229-1237): the DWT follows
a rounding contract that gives the same bits on the CPU and on CUDA, and
the models are integer, so the port prices the same targets on either.
tpukit priced on its local CPU in a worker thread with a 30 s timeout and
an inline fallback; here the DWT and the ladder are enqueued on the CUDA
stream before the host's tier-1 analysis and read back after it, so the
overlap comes from CUDA's asynchrony and nothing can time out.

Not ported yet: the device entropy backend (``entropy="device"``) and
JP2-style independent tiles (``tilex``/``tiley`` smaller than the cube),
ROADMAP.md 'Modules to port', item 14.
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
from tpukit_torch.codecs.bitplane_model import bpc_size_bytes
from tpukit_torch.host import (Codec, CodecResult, J2CPlan, JP2Decoder,
                               RateSpec, at_size_multi, mem_phase)
from tpukit_torch.kernels.dwt import idwt2, subband_slices
from tpukit_torch.kernels.dwt97 import dwt97

LEVELS = 5

# ebcot per-point (streams, recon) rep-cache budget: recon bytes held per
# tile; see the pcache insertion in _sweep_ebcot
_PCACHE_BYTES = int(2e9)

_NOT_PORTED = "ROADMAP.md 'Modules to port', item 14 (J2K device fast mode)"


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


def ladder_sizes_light(coefs: torch.Tensor, order: torch.Tensor,
                       inv_scale_perm: torch.Tensor, inv_bases,
                       segbounds, consts: wc.RleModelConsts | None = None
                       ) -> torch.Tensor:
    """(Q, B) int64 light-model stream sizes for a quality ladder (the
    ``light=True`` branch of tpukit ``_device_ladder_sizes``, :403-424).
    The scan-order gather runs once; each point is quantized with the
    coder's multiply quantizer ``trunc(c * (inv_scale * inv_base))`` and
    sized in turn, so only one point's temporaries are alive at a time
    (the loop is ``lax.map``'s counterpart). ``inv_bases`` are float32
    values."""
    B = coefs.shape[0]
    perm = torch.index_select(coefs.reshape(B, -1), 1, order)
    out = []
    for inv_base in inv_bases:
        qc = torch.trunc(perm * (inv_scale_perm * float(inv_base))).to(
            torch.int32)
        out.append(wenc_size_bytes_light(qc, segbounds, consts))
    return torch.stack(out)


class _PricingConsts:
    """A padded shape's pricing constants on one device (scan order, the
    inverse step map in scan order, the run-length model's arrays),
    uploaded once: an upload from pageable memory waits for the stream."""

    def __init__(self, Hp: int, Wp: int, device: torch.device):
        order = wc.scan_order(Hp, Wp, LEVELS)
        self.segbounds = wc.subband_seg_bounds(Hp, Wp, LEVELS)
        inv_scale = np.float32(1.0) / _subband_steps(Hp, Wp, 1.0)
        self.order = torch.from_numpy(order).to(device)
        self.inv_scale_perm = torch.from_numpy(
            np.ascontiguousarray(inv_scale.ravel()[order])).to(device)
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
        only); entropy: "ebcot" (standard codestreams). See tpukit's
        J2KCodec.__init__ (j2k_codec.py:481-509)."""
        if entropy not in ("device", "ebcot"):
            raise ValueError("entropy must be 'device' or 'ebcot'")
        if entropy == "device":
            raise NotImplementedError(
                f"j2k --entropy device is not ported to tpukit_torch yet "
                f"({_NOT_PORTED})")
        self.tilex = tilex
        self.tiley = tiley
        self.rate_fit = rate_fit
        self.entropy = entropy
        self._consts: Dict[tuple, _PricingConsts] = {}

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

    def _refuse_tiles(self, cube: np.ndarray, opts):
        B, H, W = cube.shape
        tx = opts.get("tilex") or self.tilex
        ty = opts.get("tiley") or self.tiley
        if (tx and tx < W) or (ty and ty < H):
            raise NotImplementedError(
                f"j2k independent tiles (tilex/tiley smaller than the "
                f"{W}x{H} cube) are not ported to tpukit_torch yet "
                f"({_NOT_PORTED})")

    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, **opts) -> CodecResult:
        self._refuse_tiles(cube, opts)
        return self._run_ebcot(cube, dtype_name, rate, keep_bitstream,
                               cache=opts.get("device_plan_cache"),
                               dedupe=bool(opts.get("dedupe_reps")),
                               peak_override=opts.get("peak_override"))

    def sweep_rates(self, cube: np.ndarray, dtype_name: str, specs,
                    keep_bitstream: bool = False, **opts) -> list:
        """Amortized rate ladder: one tier-1 analysis feeds every lossy
        point; lossless points go through _run_ebcot."""
        self._refuse_tiles(cube, opts)
        return self._sweep_ebcot(cube, dtype_name, specs, keep_bitstream,
                                 **opts)

    # -- standard-conformant EBCOT backend ----------------------------------
    def _ebcot_target(self, rate: RateSpec, B: int, H: int, W: int) -> int:
        """Total byte budget for bpp/cr rate keys (bpp is per band-pixel,
        cr is against raw 16-bit)."""
        if rate.key == "bpp":
            return int(rate.value * H * W * B / 8.0)
        return int((W * H * B * 2.0) / max(rate.value, 1e-6))

    def _quality_bases(self, cube: np.ndarray, qual_specs) -> np.ndarray:
        """float32 base steps of the QUALITY specs, at the cube's peak."""
        peak = float(np.abs(cube.astype(np.float64)).max()) or 1.0
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
        dev = device_cube.device
        key = (Hp, Wp, str(dev))
        if key not in self._consts:
            self._consts[key] = _PricingConsts(Hp, Wp, dev)
        c = self._consts[key]
        inv_bases = np.float32(1.0) / self._quality_bases(
            cube, qual_specs.values())

        x = device_cube.to(torch.float32)
        if Hp > H:      # edge padding, as np.pad(mode="edge")
            x = torch.cat([x, x[:, -1:, :].expand(B, Hp - H, W)], 1)
        if Wp > W:
            x = torch.cat([x, x[:, :, -1:].expand(B, Hp, Wp - W)], 2)
        coefs = dwt97(x.contiguous(), LEVELS)
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
                peak = float(peak_override or 0.0) \
                    or float(np.abs(cube.astype(np.float64)).max()) or 1.0
                wavelet, base = "97", base_step_for_quality(q_used, peak)
            plankey = ("j2c_single_plans", B, H, W, cube.dtype.name,
                       _cube_token(cube), wavelet, float(base))
            cached_plans = (cache.get(plankey) if cache is not None
                            else None)
            with mem_phase("comp"):
                t0 = time.perf_counter()
                if cached_plans is None:
                    plans = [J2CPlan(cube[b], depth, signed, levels=LEVELS,
                                     wavelet=wavelet, base_step=base)
                             for b in range(B)]
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
                    for b, (p, s) in enumerate(zip(plans, sels)):
                        recon[b] = np.clip(p.truncated_recon(s), info.min,
                                           info.max).astype(cube.dtype)
                    t_model = time.perf_counter() - t0
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
        priced sizes after it (``t_extra``), plus the point's truncation."""
        B, H, W = cube.shape
        info = np.iinfo(cube.dtype)
        depth, signed = info.bits, info.min < 0
        specs = list(specs)
        out: list = [None] * len(specs)
        ladder = [i for i, s in enumerate(specs)
                  if not s.lossless and s.key in ("bpp", "cr", "quality")]
        cache = opts.get("device_plan_cache")
        dedupe = bool(opts.get("dedupe_reps"))
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
                pending = self._price_targets(cube, qual_specs,
                                              opts.get("device_cube"))
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
                    plans = [J2CPlan(cube[b], depth, signed,
                                     levels=LEVELS, wavelet="97",
                                     base_step=base) for b in range(B)]
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
                            for b, (p, s) in enumerate(zip(plans, sels)):
                                recon[b] = np.clip(p.truncated_recon(s),
                                                   info.min,
                                                   info.max).astype(
                                                       cube.dtype)
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
        for i, s in enumerate(specs):
            if out[i] is None:
                out[i] = self._run_ebcot(cube, dtype_name, s,
                                         keep_bitstream, cache=cache,
                                         dedupe=dedupe)
        return out
