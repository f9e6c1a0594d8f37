# -*- coding: utf-8 -*-
# The port's copy of tpukit/codecs/shell.py: only its imports point at the port.
"""Reference-shell codec: drive an external wrapper executable through the
reference's L2 contract.

This is the compatibility seam SURVEY §5.8 calls for: the sweep runner can
execute any wrapper that speaks the reference protocol —
``cmd --in <tif> --out <recon.tif> --keep-bitstream <dir> [--<rate-key> v]``
with a JSON object as the last stdout line (reference tools/run_codec.py:485-501)
— including the reference's own wrappers, for side-by-side parity testing
against tpukit's in-framework codecs.
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from tpukit_torch.codecs.base import Codec, CodecResult, RateSpec
from tpukit_torch.io import tiff
from tpukit_torch.sweep.proc import run_and_measure


class ShellCodec(Codec):
    name = "shell"
    supports_lossy = True

    def __init__(self, command: Sequence[str], extra_args: Sequence[str] = (),
                 label: Optional[str] = None):
        self.command = list(command)
        self.extra_args = list(extra_args)
        self.encoder_desc = label or " ".join(self.command)

    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, **opts) -> CodecResult:
        with tempfile.TemporaryDirectory(prefix="tpukit_shell_") as td:
            td = Path(td)
            src = td / "in.tif"
            out = td / "recon.tif"
            bit_dir = td / "bit"
            tiff.write_geotiff(src, cube)
            cmd = (self.command +
                   ["--in", src.as_posix(), "--out", out.as_posix(),
                    "--keep-bitstream", bit_dir.as_posix()] + self.extra_args)
            if rate.key is not None:
                v = rate.value
                vs = str(int(v)) if (isinstance(v, float) and v.is_integer()) else str(v)
                cmd += [f"--{rate.key}", vs]
            t0 = time.perf_counter()
            elapsed, peak, stdout, stderr, rc = run_and_measure(cmd)
            t_wrap = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(
                    f"Wrapper failed ({rc}). Stderr:\n{stderr}\nStdout:\n{stdout}")
            meta: Dict[str, object] = {}
            txt = (stdout or "").strip()
            if txt:
                try:
                    meta = json.loads(txt.splitlines()[-1])
                except (ValueError, IndexError):
                    pass
            with tiff.open(out) as ds:
                recon = ds.read()
            streams = None
            if keep_bitstream and bit_dir.exists():
                streams = {p.name: p.read_bytes()
                           for p in sorted(bit_dir.rglob("*")) if p.is_file()}
            bs_bytes = meta.get("bitstream_bytes")
            if not bs_bytes and bit_dir.exists():
                bs_bytes = sum(p.stat().st_size for p in bit_dir.rglob("*")
                               if p.is_file())
            extras = {k: v for k, v in meta.items()
                      if k not in ("codec", "encoder", "bitstream_bytes",
                                   "t_comp_s", "t_dec_s", "mem_comp_peak_mb",
                                   "mem_dec_peak_mb", "mem_comp_peak_bytes",
                                   "mem_dec_peak_bytes")}
            return CodecResult(
                codec=str(meta.get("codec", "shell")),
                encoder=str(meta.get("encoder", self.encoder_desc)),
                bitstream_bytes=int(bs_bytes or 0),
                recon=recon,
                t_comp_s=float(meta.get("t_comp_s") or t_wrap),
                t_dec_s=float(meta.get("t_dec_s") or 0.0),
                bitstreams=streams,
                mem_comp_peak_bytes=(int(meta["mem_comp_peak_bytes"])
                                     if meta.get("mem_comp_peak_bytes") else peak),
                mem_dec_peak_bytes=(int(meta["mem_dec_peak_bytes"])
                                    if meta.get("mem_dec_peak_bytes") else peak),
                extras=extras,
            )
