# -*- coding: utf-8 -*-
"""The state carried between tpukit and the port.

This system has no weights file. What crosses between the two packages is
the codec configuration, the CCSDS-121 plans, the J2K byte targets and the
CCSDS-123 band weights:

  * ``from_tpukit_codec`` builds the port's codec from a tpukit one (every
    constructor argument of CCSDS121Codec, CCSDS122Codec, CCSDS123Codec,
    JPEGLSCodec, PNGCodec and J2KCodec, and of the wrapper seams ShellCodec
    and ExternalCodec);
  * the plan is tpukit's plain dict in both packages (keys ``n``,
    ``sizes``, ``k_in``, ``bit_off``, ``seg_bits``, ``total_bits``,
    ``bits``, ``J``, ``rsi``, ``preprocess``), so the host coder
    (``native.ccsds121_host`` in either package) consumes a plan from
    either side as it is. ``encode_device`` returns the same dict without
    ``k_in`` (only the parallel host encoder reads it), in both packages;
  * the J2K quality ladder's priced targets are ``{spec index: bytes}`` in
    both packages, which both truncate to with ``io.j2c_enc.at_size_multi``;
  * a device mesh: ``from_tpukit_mesh`` gives the port's ``Mesh`` with a
    tpukit mesh's ("dp", "sp") shape, its positions on the caller's device
    type;
  * the CCSDS-123 ``ls`` predictor's fitted weights are a (bands, 4) int16
    numpy array of 4.12 fixed-point values in both packages (tpukit's
    ``encode_model`` returns them as a device array: ``np.asarray`` it),
    and they travel in the stream header, so either package decodes the
    other's stream.

Reads the tpukit objects' attributes only, so this module imports nothing
of tpukit's JAX code.
"""

from __future__ import annotations

from tpukit_torch.codecs.registry import create, names

PLAN_KEYS = ("n", "sizes", "k_in", "bit_off", "seg_bits", "total_bits",
             "bits", "J", "rsi", "preprocess")

# constructor arguments, which both packages also keep as attributes
_ARGS = {
    "ccsds121": ("tile", "interleave", "preproc", "nbit", "block_size",
                 "rsi", "plan_chunk"),
    "ccsds122": ("entropy",),
    "ccsds123": ("tile", "interleave", "crop_nodata", "predictor",
                 "pred_bands", "pred_mode", "local_sums", "entropy"),
    "j2k": ("tilex", "tiley", "rate_fit", "entropy"),
    "jpegls": ("preproc",),
    "png": ("zlevel", "writer"),
}


# ExternalCodec's structure options, kept as attributes of the same names
_EXTERNAL_ARGS = ("structure", "tile", "interleave", "preproc", "nbit",
                  "crop_nodata", "bit_ext", "name", "use_uss")


def from_tpukit_codec(codec):
    """The port's codec with a tpukit codec's configuration."""
    kind = type(codec).__name__
    if kind == "ShellCodec":
        from tpukit_torch.codecs.shell import ShellCodec
        return ShellCodec(codec.command, codec.extra_args,
                          label=codec.encoder_desc)
    if kind == "ExternalCodec":
        from tpukit_torch.codecs.extern import ExternalCodec
        return ExternalCodec(codec.enc_tpl, codec.dec_tpl,
                             **{k: getattr(codec, k) for k in _EXTERNAL_ARGS})
    name = getattr(codec, "name", None)
    if name not in _ARGS:
        raise NotImplementedError(
            f"the port has {names()}; got codec {name or codec!r}")
    return create(name, **{k: getattr(codec, k) for k in _ARGS[name]})


def from_tpukit_mesh(mesh, device="cuda"):
    """The port's ``parallel.mesh.Mesh`` with a tpukit mesh's dp and sp, its
    positions on the cards of ``device``'s type, wrapped round-robin
    (``sweep.runner._build_mesh``), or all on the CPU."""
    from tpukit_torch.device import resolve_device
    from tpukit_torch.sweep.runner import _build_mesh

    return _build_mesh(f"{int(mesh.shape['dp'])},{int(mesh.shape['sp'])}",
                       resolve_device(device))
