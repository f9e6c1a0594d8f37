# -*- coding: utf-8 -*-
"""Codec API and work-cube adoption: the port's copy of the parts of
tpukit/codecs/base.py it uses.

``RateSpec``, ``CodecResult``, ``Codec`` and ``trailing_zero_shift``
(:67-148, :223-240) are copied verbatim. ``device_work`` (:162-203) is
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


def device_work(cube: np.ndarray, opts: dict, multiple: int = 1,
                target: torch.dtype = torch.int32) -> torch.Tensor:
    """(B, Hp, Wp) tensor of ``cube`` in ``target`` dtype, edge-padded so
    that Hp and Wp are multiples of ``multiple``, on :func:`work_device`.
    The runner's upload is converted on the device when its shape is the
    cube's; otherwise the cube is converted on the host and uploaded once.
    (tpukit's uint16 bit view of int16 sources has no caller in the port
    yet.)"""
    B, H, W = cube.shape
    Hp, Wp = H + (-H) % multiple, W + (-W) % multiple
    dev = opts.get("device_cube")
    if dev is not None and tuple(dev.shape) == (B, H, W):
        return edge_pad(dev.to(target), Hp, Wp)
    host, _, _ = pad_to_multiple(cube.astype(_NUMPY[target]), multiple)
    return torch.from_numpy(np.ascontiguousarray(host)).to(work_device(opts))


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
