# -*- coding: utf-8 -*-
"""Codec API and work-cube adoption: the port's copy of the parts of
tpukit/codecs/base.py it uses.

``RateSpec``, ``CodecResult``, ``Codec``, ``int16_to_codec_domain``,
``codec_domain_to_int16``, ``per_band_bpp`` and ``trailing_zero_shift``
(:67-159, :206-240) are copied verbatim. ``device_work`` (:162-203) is
ported to torch: the sweep runner uploads each tile once
(``opts["device_cube"]``); a codec takes its device work from that upload
when the shape fits, converting on the device, and otherwise converts on
the host and uploads once, to the same device. Without an upload the work
stays on the CPU: the device is always the caller's, never a default.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from tpukit_torch.codecs.wavelet_common import pad_to_multiple


@dataclass(frozen=True)
class RateSpec:
    """Rate-control request, mirroring the runner's --rate-key surface
    (reference run_codec.py:378-380: none | cr | bpp | nearlossless_eps |
    quality; plus explicit lossless)."""
    key: Optional[str] = None      # None == lossless anchor ("norate")
    value: Optional[float] = None
    lossless: bool = False

    @staticmethod
    def none() -> "RateSpec":
        return RateSpec(None, None, False)

    @staticmethod
    def of(key: Optional[str], value) -> "RateSpec":
        if key in (None, "none"):
            return RateSpec.none()
        return RateSpec(key, float(value), key == "lossless")


@dataclass
class CodecResult:
    codec: str
    encoder: str
    bitstream_bytes: int
    # (B, H, W) reconstructed cube. run() paths return a numpy array;
    # batched sweep paths (J2KCodec.sweep_qualities) return a DEVICE array
    # so downstream device metrics cost no host round-trip — call
    # np.asarray(recon) when host bytes are needed.
    recon: "np.ndarray | object"
    t_comp_s: float
    t_dec_s: float
    bitstreams: Optional[Dict[str, bytes]] = None  # name -> stream (kept on request)
    mem_comp_peak_bytes: Optional[int] = None
    mem_dec_peak_bytes: Optional[int] = None
    extras: Dict[str, object] = field(default_factory=dict)

    def to_meta(self) -> Dict[str, object]:
        """The wrapper-JSON dict (reference j2k_wrap.py:119-130 field set)."""
        def mib(x):
            return None if not x else round(x / (1024 * 1024), 2)
        meta = {
            "codec": self.codec,
            "encoder": self.encoder,
            "bitstream_bytes": int(self.bitstream_bytes),
            "t_comp_s": float(self.t_comp_s),
            "t_dec_s": float(self.t_dec_s),
            "mem_comp_peak_mb": mib(self.mem_comp_peak_bytes),
            "mem_dec_peak_mb": mib(self.mem_dec_peak_bytes),
            "mem_comp_peak_bytes": self.mem_comp_peak_bytes,
            "mem_dec_peak_bytes": self.mem_dec_peak_bytes,
        }
        meta.update(self.extras)
        return meta


class Codec(ABC):
    """A tpukit codec: encode+decode an in-memory cube under a RateSpec."""

    name: str = "codec"
    encoder_desc: str = ""
    supports_lossy: bool = False

    @abstractmethod
    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, **opts) -> CodecResult:
        """Encode + decode; return result with recon and exact stream size."""

    def sweep_rates(self, cube: np.ndarray, dtype_name: str, specs,
                    keep_bitstream: bool = False, **opts) -> List[CodecResult]:
        """Run a whole rate ladder on one cube; returns one CodecResult per
        RateSpec, in order. Transform codecs override this to amortize the
        device transform across the ladder (the reference re-runs the full
        codec per rate point, run_codec.py:472-495); the default is the
        plain per-point loop."""
        return [self.run(cube, dtype_name, s, keep_bitstream=keep_bitstream,
                         **opts) for s in specs]

    def timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0


_NUMPY = {torch.int32: np.int32, torch.float32: np.float32}


def work_device(opts: dict) -> torch.device:
    """The device of the runner's upload, the CPU without one."""
    dev = opts.get("device_cube")
    return dev.device if dev is not None else torch.device("cpu")


def edge_pad(x: torch.Tensor, Hp: int, Wp: int) -> torch.Tensor:
    """Pad the last two axes of (..., H, W) to (Hp, Wp) by repeating the
    last row and column, as ``np.pad(mode="edge")`` does, for any dtype."""
    H, W = x.shape[-2:]
    if Hp > H:
        x = torch.cat([x, x[..., -1:, :].expand(*x.shape[:-2], Hp - H, W)],
                      -2)
    if Wp > W:
        x = torch.cat([x, x[..., -1:].expand(*x.shape[:-1], Wp - W)], -1)
    return x.contiguous()


def int16_to_codec_domain(band: np.ndarray) -> np.ndarray:
    """int16 -> uint16 via +32768, the mapping the reference applies before
    handing int16 planes to 16-bit unsigned codecs (jpegls_wrap.py:199)."""
    return (band.astype(np.int32) + 32768).astype(np.uint16)


def codec_domain_to_int16(band_u16: np.ndarray) -> np.ndarray:
    """Inverse of int16_to_codec_domain (jpegls_wrap.py:247-249)."""
    return np.clip(band_u16.astype(np.int32) - 32768, -32768, 32767).astype(np.int16)


def device_work(cube: np.ndarray, opts: dict, multiple: int = 1,
                target=torch.int32) -> torch.Tensor:
    """(B, Hp, Wp) tensor of ``cube`` in the ``target`` domain, edge-padded
    so that Hp and Wp are multiples of ``multiple``, on :func:`work_device`.
    The runner's upload is converted on the device when its shape is the
    cube's; otherwise the cube is converted on the host and uploaded once.

    ``target`` is ``torch.int32``, ``torch.float32`` or the string
    ``"uint16"``: the mod-2^16 ring values of the samples, an int16 source
    through its uint16 **bit view** (-1 -> 65535), as tpukit's bitcast
    gives them. torch has few ops on ``torch.uint16``, so the ring values
    are carried as int32 in [0, 65535]; a float upload (a lossy source)
    does not qualify and the host cube is converted instead."""
    ring = isinstance(target, str) and target == "uint16"
    if ring:
        target = torch.int32
    B, H, W = cube.shape
    Hp, Wp = H + (-H) % multiple, W + (-W) % multiple
    dev = opts.get("device_cube")
    if (dev is not None and tuple(dev.shape) == (B, H, W)
            and not (ring and dev.dtype.is_floating_point)):
        work = dev.to(target)
        if ring:
            work = work & 0xFFFF
        return edge_pad(work, Hp, Wp)
    if ring:
        host = (cube.view(np.uint16) if cube.dtype == np.int16
                else cube.astype(np.uint16)).astype(np.int32)
    else:
        host = cube.astype(_NUMPY[target])
    host, _, _ = pad_to_multiple(host, multiple)
    return torch.from_numpy(np.ascontiguousarray(host)).to(work_device(opts))

def per_band_bpp(rate: "RateSpec", bands: int, bits_per_sample: float):
    """CCSDS-122-style per-band rate request -> (target_bpp_band,
    lossless_requested): --bpp is taken per band; --cr converts via
    bits·B/CR spread over B bands; no/insufficient rate == effectively
    lossless (reference ccsds122_wrap.py:97-107). Shared by the native
    codec and the external-binary band wrapper so the semantics can't
    drift."""
    if rate.key == "bpp" and rate.value is not None:
        target = float(rate.value)
    elif rate.key == "cr" and rate.value is not None:
        target = (bits_per_sample * bands / max(float(rate.value), 1e-6)) \
            / bands
    else:
        target = bits_per_sample
    return target, target >= bits_per_sample - 1e-9



def trailing_zero_shift(cube: "np.ndarray") -> int:
    """Common trailing-zero LSBs across all samples (uint bit view).

    The benchmark's baselines are bit-packed — Case A 12-in-16 carries 4
    exactly-zero LSBs, Case B 14-in-16 carries 2 — and a lossless coder
    pays ~k bits/sample for them. tpukit-format codecs (J2K reversible,
    CCSDS-122 effective-lossless, CCSDS-123) code (x >> k) and shift back
    on decode: exactly invertible because the dropped bits are zero by
    construction, and a pure function of the input so every size model and
    coder derives the same k. Byte-parity codecs (CCSDS-121 vs libaec,
    JPEG-LS vs CharLS) deliberately do NOT shift — the reference engines
    pay for those bits and parity wins."""
    u = cube.view(np.uint16) if cube.dtype.itemsize == 2 else \
        cube.view(np.uint8) if cube.dtype.itemsize == 1 else cube
    acc = int(np.bitwise_or.reduce(u, axis=None))
    if acc == 0:
        return 0
    return min((acc & -acc).bit_length() - 1, 8)
