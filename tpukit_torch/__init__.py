"""tpukit_torch — the PyTorch/CUDA port of tpukit, beside the JAX package.

The port runs bench.py's canonical pair on an NVIDIA card: the Case B
anchor sweep (CCSDS-121 lossless coding of a band-interleaved tile with the
full metric pass), the Case A J2K quality ladder and the J2K device fast
mode; and tpukit's other codecs under the same runner: CCSDS-123, JPEG-LS,
PNG and CCSDS-122 (all six of ``run-codec``):

  * the flat stream, the CCSDS-121 encode plan and packer, the J2K
    byte-target pricing, the device size models, the CCSDS-122 rate ladders
    (the BPE and embedded truncated-decode models over the integer 9/7M
    DWT) and the metric pass are torch code on an explicit device; the
    split-sample cost table and the 9/7 DWT are CUDA kernels written for
    Hopper (``tpukit_torch/csrc/fs_table.cu``,
    ``tpukit_torch/csrc/dwt97.cu``);
  * the entropy coding and decoding are host C++ (``native.ccsds121_host``,
    ``io.j2c_enc``, ``io.jp2``, the Rice / bit-plane / run-length coder of
    ``codecs.wavelet_common``, ``codecs.bpe122``), built from the port's
    own copy of tpukit's sources (``tpukit_torch/native/src``).

Module names mirror ``tpukit/`` so each counterpart is easy to find. The
package imports ``torch`` and never ``jax``, and nothing of tpukit: the host
modules it needs are its own copies (``io.{tiff,jp2,j2c_enc,manifest,raw,
bitdepth}``, ``sweep.{csvio,proc}``, ``viz.quicklooks``, ``native``,
``codecs.base``, ``codecs.bpe122``, the host coder in
``codecs.wavelet_common``).
"""

__version__ = "0.1.0"
