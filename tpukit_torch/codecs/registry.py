# -*- coding: utf-8 -*-
"""Codec registry: name -> constructor, with the reference-label aliases of
tpukit/codecs/registry.py:10-17 so CSV codec ids map onto codecs.

The port has tpukit's six codecs: CCSDS-121, CCSDS-122 (both entropy
backends), CCSDS-123 (both predictors), JPEG-LS, PNG and J2K (both entropy
backends)."""

from __future__ import annotations

_ALIASES = {
    "ccsds121_ext": "ccsds121",
    "ccsds122_ext": "ccsds122",
    "ccsds123_ext": "ccsds123",
    "jpegls_subproc": "jpegls",
    "j2k_gdal": "j2k",
    "png_lossless": "png",
}

# name -> (module under tpukit_torch.codecs, class); imported at first use
_CODECS = {
    "ccsds121": ("ccsds121_codec", "CCSDS121Codec"),
    "ccsds122": ("ccsds122_codec", "CCSDS122Codec"),
    "ccsds123": ("ccsds123_codec", "CCSDS123Codec"),
    "j2k": ("j2k_codec", "J2KCodec"),
    "jpegls": ("jpegls_codec", "JPEGLSCodec"),
    "png": ("png_codec", "PNGCodec"),
}


def create(name: str, **opts):
    key = _ALIASES.get(name, name)
    if key in _CODECS:
        from importlib import import_module
        module, cls = _CODECS[key]
        return getattr(import_module(f"tpukit_torch.codecs.{module}"),
                       cls)(**opts)
    raise KeyError(f"Unknown codec '{name}'. Known: {names()}")


def names():
    return sorted(_CODECS)
