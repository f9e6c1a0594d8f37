# -*- coding: utf-8 -*-
"""The tpukit host modules the port shares, loaded without JAX.

The port reuses tpukit's JAX-free host code as it is: the C++ CCSDS-121
coder (``tpukit.native.ccsds121_host``), the JPEG 2000 tier-1 analysis and
PCRD truncation (``tpukit.io.j2c_enc``: ``J2CPlan``, ``at_size_multi``) and
decoder (``tpukit.io.jp2.JP2Decoder``), GeoTIFF, manifest and RAW I/O
(``tpukit.io``), the CSV contract and the process-memory sampler
(``tpukit.sweep.csvio``/``proc``), the quicklook writers
(``tpukit.viz.quicklooks``) and the codec API (``tpukit.codecs.base``).
Every module of the port, and chip_smoke.py, reaches tpukit through here.

One of them reaches for JAX whenever it is installed:
``tpukit/io/bitdepth.py:19-22`` imports ``jax.numpy`` inside a ``try`` to
serve JAX arrays, which the port never passes. So unless the process
already holds JAX (the parity tests load both packages), these modules are
imported with JAX refused, and bitdepth takes its numpy-only branch. The
functions of theirs that do import JAX (``codecs.base.device_work``,
``ccsds121_host.decode_to_device``) are not called by the port.
"""

from __future__ import annotations

import importlib.abc
import sys
from contextlib import contextmanager


class _RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError(f"tpukit_torch does not use {name}")
        return None


@contextmanager
def _jax_refused():
    if "jax" in sys.modules:
        yield
        return
    finder = _RefuseJax()
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)


with _jax_refused():
    from tpukit.codecs.base import (Codec, CodecResult, RateSpec,
                                    trailing_zero_shift)
    from tpukit.io import manifest, raw, tiff
    from tpukit.io.bitdepth import effective_data_range
    from tpukit.io.j2c_enc import J2CPlan, at_size_multi
    from tpukit.io.jp2 import JP2Decoder
    from tpukit import native
    from tpukit.native import ccsds121_host
    from tpukit.sweep import csvio
    from tpukit.sweep.proc import MemorySampler, mem_phase
    from tpukit.viz import quicklooks

__all__ = ["Codec", "CodecResult", "RateSpec", "trailing_zero_shift",
           "manifest", "raw", "tiff",
           "effective_data_range", "J2CPlan", "at_size_multi", "JP2Decoder",
           "native", "ccsds121_host", "csvio",
           "MemorySampler", "mem_phase", "quicklooks"]
