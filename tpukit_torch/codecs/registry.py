# -*- coding: utf-8 -*-
"""Codec registry: name -> constructor, with the reference-label aliases of
tpukit/codecs/registry.py:10-17 so CSV codec ids map onto codecs.

The port has CCSDS-121, CCSDS-123 (both predictors), JPEG-LS, PNG and J2K
(both entropy backends). CCSDS-122 raises ``NotImplementedError`` naming
the ROADMAP.md item that ports it."""

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
    "ccsds123": ("ccsds123_codec", "CCSDS123Codec"),
    "j2k": ("j2k_codec", "J2KCodec"),
    "jpegls": ("jpegls_codec", "JPEGLSCodec"),
    "png": ("png_codec", "PNGCodec"),
}

_NOT_PORTED = {
    "ccsds122": "ROADMAP.md 'Modules to port', item 15 (CCSDS-122)",
}


def create(name: str, **opts):
    key = _ALIASES.get(name, name)
    if key in _CODECS:
        from importlib import import_module
        module, cls = _CODECS[key]
        return getattr(import_module(f"tpukit_torch.codecs.{module}"),
                       cls)(**opts)
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"codec '{name}' is not ported to tpukit_torch yet: "
            f"{_NOT_PORTED[key]}")
    raise KeyError(f"Unknown codec '{name}'. Known: {names()}")


def names():
    return sorted(_CODECS)
