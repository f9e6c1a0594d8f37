# -*- coding: utf-8 -*-
"""Codec registry: name -> constructor, with the reference-label aliases of
tpukit/codecs/registry.py:10-17 so CSV codec ids map onto codecs.

The port has CCSDS-121 and J2K (both entropy backends) so far. The other
tpukit codecs raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them."""

from __future__ import annotations

_ALIASES = {
    "ccsds121_ext": "ccsds121",
    "ccsds122_ext": "ccsds122",
    "ccsds123_ext": "ccsds123",
    "jpegls_subproc": "jpegls",
    "j2k_gdal": "j2k",
    "png_lossless": "png",
}

_NOT_PORTED = {
    "ccsds122": "ROADMAP.md 'Modules to port', item 15 (CCSDS-122)",
    "ccsds123": "ROADMAP.md 'Modules to port', item 16 (CCSDS-123)",
    "jpegls": "ROADMAP.md 'Modules to port', item 17 (JPEG-LS and PNG)",
    "png": "ROADMAP.md 'Modules to port', item 17 (JPEG-LS and PNG)",
}


def create(name: str, **opts):
    key = _ALIASES.get(name, name)
    if key == "ccsds121":
        from tpukit_torch.codecs.ccsds121_codec import CCSDS121Codec
        return CCSDS121Codec(**opts)
    if key == "j2k":
        from tpukit_torch.codecs.j2k_codec import J2KCodec
        return J2KCodec(**opts)
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"codec '{name}' is not ported to tpukit_torch yet: "
            f"{_NOT_PORTED[key]}")
    raise KeyError(f"Unknown codec '{name}'. Known: ['ccsds121', 'j2k']")
