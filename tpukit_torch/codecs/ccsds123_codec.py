# -*- coding: utf-8 -*-
"""CCSDS-123-class hyperspectral lossless codec on a torch device: port of
tpukit/codecs/ccsds123_codec.py.

The design is tpukit's (closed-form adaptation instead of the standard's
per-sample LMS, same structure: spatial + adaptive inter-band prediction +
mapped residuals + block-adaptive Golomb coding):

  1. spatial stage: per-band row difference on the mod-2^16 ring,
     inverted by a modular cumulative sum along the rows;
  2. spectral stage: per-band least-squares weights over the 3 previous
     bands' difference planes (+bias), quantized to 4.12 fixed point and
     *transmitted*; prediction is pure int32 arithmetic, so encoder and
     decoder agree exactly by construction;
  3. residuals zigzag-mapped on the ring and coded with the CCSDS-121
     block-adaptive coder (no preprocessor), on the device
     (``ccsds121.encode_device``, kernel K1 under ``analyze``).

Decode is a band loop (each step vectorized over H×W) plus the modular
cumsum. The stream layout (magic, ``<BHIII`` header, ``<i2`` weights, the
CCSDS-121 payload) is tpukit's byte for byte: either package decodes the
other's stream.

Where the port differs from the JAX code, and why:

  * ring values: torch has few ops on ``torch.uint16``, so every mod-2^16
    quantity (samples, row differences, mapped residuals) is an int32 in
    [0, 65535], masked with ``& 0xFFFF`` where tpukit casts to uint16;
  * **the least-squares fit.** tpukit forms the 4×4 normal equations in
    float32 on the device, where the order of the sums decides the last
    bits, and a last-ULP difference can flip a 4.12 weight: its streams
    differ between platforms. Here the sums are exact. Features are
    clamped to |f| <= 8191, targets are |c| <= 2^15 and a tile has at most
    2^18 pixels, so every entry of ``M`` and ``v`` is an integer below
    2^46: float64 accumulates them exactly in any order, on any device.
    The 4×4 systems are then solved in one place for every device, the
    host in numpy float64. So a CUDA run and a CPU run give the same
    weights and the same stream, byte for byte. Against tpukit's float32
    fit the weights may differ by a few 4.12 LSBs; both streams are valid,
    and with tpukit's weights injected (``CCSDS123Codec._fit_weights`` is
    the seam) the port's stream is tpukit's byte for byte;
  * ``decode_model``'s ``lax.scan`` over the bands is a Python loop of
    small launches; the carried planes are kept already clamped, and the
    ring plane of a band is its row difference, so nothing is recomputed.
"""

from __future__ import annotations

import struct
import time
from typing import Dict, Tuple

import numpy as np
import torch

from tpukit_torch.codecs import ccsds121 as dev121
from tpukit_torch.codecs.base import (Codec, CodecResult, RateSpec,
                                      device_work, trailing_zero_shift,
                                      work_device)
from tpukit_torch.native import ccsds121_host
from tpukit_torch.sweep.proc import mem_phase

P = 3              # previous bands used by the spectral predictor
FRAC_BITS = 12     # 4.12 fixed-point weights
FEAT_CLAMP = 8191  # keeps products inside int32
_MAGIC = b"TK123\x02"

_ENTROPY = dict(bits=16, block_size=16, rsi=64, flags=0)  # no preprocessor

# bands per step of the normal-equation sums: bounds the float64 copies of
# the features (16 bands of a 512² tile: 134 MB)
_FIT_BANDS = 16

_TORCH_DTYPES = {np.dtype(np.int16): torch.int16,
                 np.dtype(np.uint16): torch.uint16,
                 np.dtype(np.uint8): torch.uint8}


def _signed_view(ring: torch.Tensor) -> torch.Tensor:
    """Ring value in [0, 65535] -> signed int32 in [-32768, 32767]."""
    return torch.where(ring >= 32768, ring - 65536, ring)


def _zigzag(srel: torch.Tensor) -> torch.Tensor:
    return torch.where(srel >= 0, 2 * srel, -2 * srel - 1)


def _unzigzag(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_zigzag`; ``m`` is non-negative, so ``>>`` is the
    floor division tpukit writes."""
    return torch.where(m & 1 == 0, m >> 1, -((m + 1) >> 1))


def _row_diff_ring(xu: torch.Tensor) -> torch.Tensor:
    """D[0]=X[0]; D[y]=X[y]-X[y-1] (mod 2^16) along rows of (B,H,W)."""
    d = xu.clone()
    d[:, 1:] = (xu[:, 1:] - xu[:, :-1]) & 0xFFFF
    return d


def _row_cumsum_ring(d: torch.Tensor) -> torch.Tensor:
    """Modular cumulative sum along the rows: int32 holds it (at most 2^9
    rows of values below 2^16 where tiles are 512², 2^15 rows at most)."""
    return torch.cumsum(d, 1, dtype=torch.int32) & 0xFFFF


def _features(c: torch.Tensor) -> torch.Tensor:
    """(B,4,H,W) clamped features: previous 1..3 band planes + bias."""
    B = c.shape[0]
    feats = torch.zeros((B, P + 1) + tuple(c.shape[1:]), dtype=torch.int32,
                        device=c.device)
    for j in range(1, P + 1):
        if j < B:
            feats[j:, j - 1] = c[:-j].clamp(-FEAT_CLAMP, FEAT_CLAMP)
    feats[:, P] = 1
    return feats


def _predict(feats: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Integer prediction: (..., 4, H, W) feats × (..., 4) 4.12 weights,
    int32 throughout (four products below 2^28 and the rounding term)."""
    acc = feats[..., 0, :, :] * wq[..., 0, None, None]
    for i in range(1, P + 1):
        acc = acc + feats[..., i, :, :] * wq[..., i, None, None]
    return (acc + (1 << (FRAC_BITS - 1))) >> FRAC_BITS


def fit_weights(feats: torch.Tensor, c: torch.Tensor) -> np.ndarray:
    """(B, 4) int16 4.12 least-squares weights of each band's difference
    plane ``c`` on its features, over rows >= 1 (row 0 holds raw samples,
    not differences).

    The normal equations ``M = F F^T``, ``v = F t`` are summed in float64
    on the tensors' device, exactly (see the module docstring), a group of
    bands at a time; the ridge 1e-3·I, the solve, the rounding (half to
    even) and the clip to ±32767 are numpy float64 on the host."""
    B = feats.shape[0]
    M = torch.empty((B, P + 1, P + 1), dtype=torch.float64,
                    device=feats.device)
    v = torch.empty((B, P + 1), dtype=torch.float64, device=feats.device)
    for b0 in range(0, B, _FIT_BANDS):
        F = feats[b0:b0 + _FIT_BANDS, :, 1:].to(torch.float64).flatten(2)
        t = c[b0:b0 + _FIT_BANDS, 1:].to(torch.float64).flatten(1)
        M[b0:b0 + _FIT_BANDS] = F @ F.transpose(1, 2)
        v[b0:b0 + _FIT_BANDS] = (F @ t[..., None])[..., 0]
    M = M.cpu().numpy() + 1e-3 * np.eye(P + 1)[None]
    w = np.linalg.solve(M, v.cpu().numpy()[..., None])[..., 0]
    return np.clip(np.rint(w * (1 << FRAC_BITS)), -32767,
                   32767).astype(np.int16)


def encode_model(xu: torch.Tensor,
                 fit=fit_weights) -> Tuple[torch.Tensor, np.ndarray]:
    """Device model: (B,H,W) ring samples (int32 in [0, 65535]) ->
    (mapped residuals, int32 in [0, 65535] on xu's device; per-band int16
    weights, a host array). ``fit(feats, c)`` gives the weights."""
    c = _signed_view(_row_diff_ring(xu))
    feats = _features(c)                       # (B,4,H,W)
    wq = np.asarray(fit(feats, c), np.int16)
    pred = _predict(feats, torch.from_numpy(wq.astype(np.int32)).to(xu.device))
    srel = _signed_view((c - pred) & 0xFFFF)
    return _zigzag(srel), wq


def decode_model(mapped: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Inverse: a band loop rebuilding the difference planes (each band's
    prediction reads the three before it), then the modular cumsum.
    ``mapped`` (B,H,W) int32 in [0, 65535], ``wq`` (B,4) integer weights on
    the same device; returns the ring samples."""
    B = mapped.shape[0]
    srel = _unzigzag(mapped.to(torch.int32))
    w = wq.to(torch.int32)
    d = torch.empty_like(srel)
    # previous signed difference planes, most recent first, clamped once
    prev = [torch.zeros_like(srel[0]) for _ in range(P)]
    half = 1 << (FRAC_BITS - 1)
    for b in range(B):
        acc = w[b, P] + half
        for j in range(P):
            acc = acc + prev[j] * w[b, j]
        ring = ((acc >> FRAC_BITS) + srel[b]) & 0xFFFF
        d[b] = ring
        prev = [_signed_view(ring).clamp_(-FEAT_CLAMP, FEAT_CLAMP)] + prev[:-1]
    return _row_cumsum_ring(d)


class CCSDS123Codec(Codec):
    """predictor='ls' (default) is tpukit's device-first redesign:
    closed-form least-squares band weights transmitted in the stream,
    device band-loop decode. predictor='standard' codes CCSDS 123.0-B
    conformant streams: the Blue Book's sample-adaptive predictor (local
    sums + per-sample LMS weight updates) and sample-adaptive GPO2 coder
    with the §5.3 header (native/src/ccsds123std.cpp), the same algorithm
    the reference runs through the CNES enc123/dec123 binaries
    (ccsds123_wrap.py:8)."""

    name = "ccsds123"
    encoder_desc = ("tpukit CCSDS-123-class (LS-adaptive inter-band predictor "
                    "+ block-adaptive Golomb)")
    std_desc = ("tpukit CCSDS-123.0-B (sample-adaptive predictor + "
                "sample-adaptive GPO2)")
    supports_lossy = False
    # the reference wrapper copies the source's validity mask into the
    # reconstruction (ccsds123_wrap.py:279-283 dst.write_mask)
    mask_passthrough = True
    # independent 512² tiles: row strips on the tile grid code
    # byte-identically to the whole image
    strip_exact = True

    def __init__(self, tile: int = 512, interleave: str = "bsq",
                 crop_nodata: bool = False, predictor: str = "ls",
                 pred_bands: int = 3, pred_mode: str = "full",
                 local_sums: str = "neighbor", entropy: str = "sample"):
        """``interleave`` is the §4.2 ENCODING order in standard mode
        (bsq|bil|bip, the reference wrapper's --interleave,
        ccsds123_wrap.py:116); the ls mode's streams are order-free
        (whole-cube device model) and record it as metadata only.
        ``pred_bands`` (P, 0..15), ``pred_mode`` (full|reduced) and
        ``local_sums`` (neighbor|column) parameterize the standard
        predictor (the CNES binaries' knobs, ccsds123_wrap.py:129-153);
        the ls predictor fixes its own P=3 transmitted-weights design."""
        if predictor not in ("ls", "standard"):
            raise ValueError(f"predictor must be ls|standard, "
                             f"got {predictor!r}")
        if interleave not in ("bsq", "bil", "bip"):
            raise ValueError(f"interleave must be bsq|bil|bip, "
                             f"got {interleave!r}")
        if pred_mode not in ("full", "reduced"):
            raise ValueError(f"pred_mode must be full|reduced, "
                             f"got {pred_mode!r}")
        if local_sums not in ("neighbor", "column"):
            raise ValueError(f"local_sums must be neighbor|column, "
                             f"got {local_sums!r}")
        if not 0 <= int(pred_bands) <= 15:
            raise ValueError(f"pred_bands must be in [0, 15], "
                             f"got {pred_bands}")
        if entropy not in ("sample", "block"):
            raise ValueError(f"entropy must be sample|block, "
                             f"got {entropy!r}")
        if entropy == "block" and predictor != "standard":
            raise ValueError("entropy='block' is a standard-mode option "
                             "(the ls predictor has its own fixed "
                             "CCSDS-121 backend)")
        self.entropy = entropy
        self.tile = tile
        self.interleave = interleave
        self.crop_nodata = crop_nodata
        self.predictor = predictor
        self.pred_bands = int(pred_bands)
        self.pred_mode = pred_mode
        self.local_sums = local_sums

    @staticmethod
    def _tile_all_nodata(tile_bsq: np.ndarray, nd, mask_win) -> bool:
        """Reference _tile_is_all_nodata (ccsds123_wrap.py:191-205):
        dataset-mask window all zero wins; else every band == nodata."""
        if mask_win is not None and (np.asarray(mask_win) == 0).all():
            return True
        if nd is not None:
            return bool((tile_bsq == np.asarray(nd, tile_bsq.dtype)).all())
        return False

    def _fit_weights(self, feats: torch.Tensor, c: torch.Tensor) -> np.ndarray:
        """The (B, 4) int16 weights of one tile: the seam a test replaces
        to inject another fit's weights."""
        return fit_weights(feats, c)

    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, nodata=None, dataset_mask=None,
            **opts) -> CodecResult:
        B, H, W = cube.shape
        tile = int(self.tile) if self.tile else max(H, W)
        crop = self.crop_nodata or bool(opts.get("crop_nodata", False))
        nd = None
        if nodata is not None and np.isfinite(nodata):
            nd = nodata

        # single-tile case (the canonical 512² tile): the reconstruction
        # stays on the device; the runner's metric and artifact phases
        # fetch it batched (or not at all), the same contract as the J2K
        # device ladder. Multi-tile scenes assemble on the host.
        single = tile >= H and tile >= W
        recon = None if single else np.empty_like(cube)
        # bit-packed baselines (14-in-16 etc): code (x >> k) of the k
        # exactly-zero LSBs and shift back on decode (carried in the tile
        # header)
        shift = trailing_zero_shift(cube)
        # device-resident ring source (rides the runner's upload when
        # present); tiles slice from it on the device. The standard path
        # is host-only (serial per-sample recurrence): no upload.
        devw = device = None
        if self.predictor == "ls":
            devw = device_work(cube, opts, 1, "uint16")
            device = work_device(opts)
        streams: Dict[str, bytes] = {}
        sum_bytes = 0
        t_comp = t_dec = 0.0
        skipped = 0

        for y0 in range(0, H, tile):
            for x0 in range(0, W, tile):
                th = min(tile, H - y0)
                tw = min(tile, W - x0)
                tile_bsq = cube[:, y0:y0 + th, x0:x0 + tw]

                if crop and self._tile_all_nodata(
                        tile_bsq, nd,
                        None if dataset_mask is None
                        else dataset_mask[y0:y0 + th, x0:x0 + tw]):
                    # fast path: nothing coded, recon block filled with
                    # nodata (reference ccsds123_wrap.py:218-229)
                    fill = nd if nd is not None else 0
                    if single:
                        recon = np.full(cube.shape, fill, cube.dtype)
                    else:
                        recon[:, y0:y0 + th, x0:x0 + tw] = np.asarray(
                            fill, cube.dtype)
                    skipped += 1
                    continue

                if self.predictor == "standard":
                    # CCSDS 123.0-B conformant stream: the Blue Book's
                    # sample-adaptive recurrence is serial per sample, so
                    # this path runs in-process C++ (ccsds123_std)
                    from tpukit_torch.codecs import ccsds123_std as std
                    signed = cube.dtype == np.int16
                    t0 = time.perf_counter()
                    with mem_phase("comp"):
                        bs = std.encode(
                            np.ascontiguousarray(tile_bsq).view(np.uint16),
                            is_signed=signed, P=self.pred_bands,
                            full_mode=self.pred_mode == "full",
                            colsum=self.local_sums == "column",
                            order=self.interleave, entropy=self.entropy)
                    t_comp += time.perf_counter() - t0
                    sum_bytes += len(bs)
                    if keep_bitstream:
                        streams[f"t_x{x0:05d}_y{y0:05d}.l123"] = bs
                    t0 = time.perf_counter()
                    with mem_phase("dec"):
                        rec = std.decode(bs).view(cube.dtype)
                        if single:
                            recon = rec
                        else:
                            recon[:, y0:y0 + th, x0:x0 + tw] = rec
                    t_dec += time.perf_counter() - t0
                    continue

                t0 = time.perf_counter()
                with mem_phase("comp"):
                    xd = devw[:, y0:y0 + th, x0:x0 + tw]
                    if shift:
                        xd = xd >> shift
                    mapped, wq_np = encode_model(xd, self._fit_weights)
                    plan = None
                    if mapped.numel() % _ENTROPY["block_size"] == 0:
                        # entropy-code on the device (pack_words with the
                        # preprocessor off: residuals are already mapped):
                        # the download is the compressed stream, not the
                        # 2-byte/sample mapped cube, and the returned plan
                        # lets the decode phase run chunk by chunk with
                        # overlapped uploads
                        stream, plan = dev121.encode_device(
                            mapped.reshape(-1), bits=_ENTROPY["bits"],
                            J=_ENTROPY["block_size"], rsi=_ENTROPY["rsi"],
                            preprocess=False, return_plan=True)
                    else:
                        stream = ccsds121_host.encode(
                            mapped.cpu().numpy().ravel(), **_ENTROPY)
                    header = (_MAGIC +
                              struct.pack("<BHIII", shift, P, B, th, tw) +
                              wq_np.astype("<i2").tobytes())
                    bs = header + stream
                t_comp += time.perf_counter() - t0
                sum_bytes += len(bs)
                if keep_bitstream:
                    streams[f"t_x{x0:05d}_y{y0:05d}.bit"] = bs

                t0 = time.perf_counter()
                with mem_phase("dec"):
                    rec_dev = self._decode_device(bs, B, th, tw, plan=plan,
                                                  device=device)
                    if cube.dtype == np.int16:
                        # the int16 bit view of the ring values
                        rec_dev = _signed_view(rec_dev)
                    rec_dev = rec_dev.to(_TORCH_DTYPES[cube.dtype])
                    if single:
                        recon = rec_dev
                        if device.type == "cuda":
                            torch.cuda.current_stream(device).synchronize()
                    else:
                        recon[:, y0:y0 + th, x0:x0 + tw] = \
                            rec_dev.cpu().numpy()
                t_dec += time.perf_counter() - t0

        total_pixels = H * W
        bpp_total = sum_bytes * 8.0 / max(total_pixels, 1)
        return CodecResult(
            codec="ccsds123_ext",
            encoder=(self.std_desc if self.predictor == "standard"
                     else self.encoder_desc),
            bitstream_bytes=sum_bytes,
            recon=recon,
            t_comp_s=t_comp,
            t_dec_s=t_dec,
            bitstreams=streams if keep_bitstream else None,
            extras={
                "mode": "lossless_only",
                "predictor": self.predictor,
                "bands": int(B), "dtype": dtype_name, "tile": int(tile),
                "bpp_effective_total": float(bpp_total),
                "bpp_effective_per_band": float(bpp_total / max(B, 1)),
                "interleave": self.interleave,
                "tiles_skipped_nodata": int(skipped),
                **({"pred_bands": self.pred_bands,
                    "pred_mode": self.pred_mode,
                    "local_sums": self.local_sums,
                    "entropy": self.entropy}
                   if self.predictor == "standard" else {}),
            },
        )

    @staticmethod
    def _decode_device(bs: bytes, B: int, H: int, W: int, plan=None,
                       device="cpu") -> torch.Tensor:
        """Decode to a (B,H,W) cube of ring values (int32 in [0, 65535])
        on ``device``. With an encode plan (chunk bit offsets), the host
        entropy decode runs chunk by chunk with each chunk's upload started
        as soon as it lands, so the upload hides behind the host decode."""
        if bs[:len(_MAGIC)] != _MAGIC:
            raise ValueError("bad TK123 stream")
        off = len(_MAGIC)
        shift, p, b, h, w = struct.unpack_from("<BHIII", bs, off)
        off += struct.calcsize("<BHIII")
        if (p, b, h, w) != (P, B, H, W):
            raise ValueError("geometry mismatch")
        wq = np.frombuffer(bs, "<i2", count=B * (P + 1), offset=off)
        wq = torch.from_numpy(wq.reshape(B, P + 1).astype(np.int32)).to(device)
        off += B * (P + 1) * 2
        if plan is not None:
            mapped = ccsds121_host.decode_to_device(bs[off:], plan, device)
        else:
            mapped = torch.from_numpy(
                ccsds121_host.decode(bs[off:], B * H * W, **_ENTROPY)
                .astype(np.int32)).to(device)
        rec = decode_model(mapped.reshape(B, H, W), wq)
        return ((rec << shift) & 0xFFFF) if shift else rec

    @staticmethod
    def _decode(bs: bytes, B: int, H: int, W: int) -> np.ndarray:
        """Host decode of one tile's stream to a uint16 array."""
        return CCSDS123Codec._decode_device(bs, B, H, W).numpy() \
            .astype(np.uint16)
