# -*- coding: utf-8 -*-
"""The state carried between tpukit and the port.

This system has no weights. What crosses between the two packages is the
codec configuration, the CCSDS-121 encode plan and the J2K byte targets:

  * ``from_tpukit_codec`` builds the port's codec from a tpukit one;
  * the plan is tpukit's plain dict in both packages (keys ``n``,
    ``sizes``, ``k_in``, ``bit_off``, ``seg_bits``, ``total_bits``,
    ``bits``, ``J``, ``rsi``, ``preprocess``), so the host coder
    (``native.ccsds121_host`` in either package) consumes a plan from
    either side as it is;
  * the J2K quality ladder's priced targets are ``{spec index: bytes}`` in
    both packages, which both truncate to with ``io.j2c_enc.at_size_multi``.

Reads the tpukit codec's attributes only, so this module imports nothing
of tpukit's JAX code.
"""

from __future__ import annotations

from tpukit_torch.codecs.ccsds121_codec import CCSDS121Codec
from tpukit_torch.codecs.j2k_codec import J2KCodec

PLAN_KEYS = ("n", "sizes", "k_in", "bit_off", "seg_bits", "total_bits",
             "bits", "J", "rsi", "preprocess")


def from_tpukit_codec(codec):
    """The port's codec with a tpukit codec's configuration (CCSDS121Codec
    or J2KCodec)."""
    name = getattr(codec, "name", None)
    if name == "ccsds121":
        return CCSDS121Codec(tile=codec.tile, interleave=codec.interleave,
                             preproc=codec.preproc, nbit=codec.nbit,
                             block_size=codec.block_size, rsi=codec.rsi,
                             plan_chunk=codec.plan_chunk)
    if name == "j2k":
        return J2KCodec(tilex=codec.tilex, tiley=codec.tiley,
                        rate_fit=codec.rate_fit, entropy=codec.entropy)
    raise NotImplementedError(
        f"only CCSDS-121 and J2K are ported; got codec {name or codec!r}")
