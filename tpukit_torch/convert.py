# -*- coding: utf-8 -*-
"""The state carried between tpukit and the port.

This system has no weights. What crosses between the two packages is the
codec configuration and the CCSDS-121 encode plan:

  * ``from_tpukit_codec`` builds the port's codec from a tpukit one;
  * the plan is tpukit's plain dict in both packages (keys ``n``,
    ``sizes``, ``k_in``, ``bit_off``, ``seg_bits``, ``total_bits``,
    ``bits``, ``J``, ``rsi``, ``preprocess``), so
    ``tpukit.native.ccsds121_host`` consumes a plan from either side as it
    is.

Reads the tpukit codec's attributes only, so this module imports nothing
of tpukit's JAX code.
"""

from __future__ import annotations

from tpukit_torch.codecs.ccsds121_codec import CCSDS121Codec

PLAN_KEYS = ("n", "sizes", "k_in", "bit_off", "seg_bits", "total_bits",
             "bits", "J", "rsi", "preprocess")


def from_tpukit_codec(codec) -> CCSDS121Codec:
    """The port's CCSDS121Codec with a tpukit CCSDS121Codec's configuration."""
    if getattr(codec, "name", None) != "ccsds121":
        raise NotImplementedError(
            f"only CCSDS-121 is ported; got codec {getattr(codec, 'name', codec)!r}")
    return CCSDS121Codec(tile=codec.tile, interleave=codec.interleave,
                         preproc=codec.preproc, nbit=codec.nbit,
                         block_size=codec.block_size, rsi=codec.rsi,
                         plan_chunk=codec.plan_chunk)
