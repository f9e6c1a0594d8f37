"""tpukit_torch — the PyTorch/CUDA port of tpukit, beside the JAX package.

The port runs bench.py's canonical pair on an NVIDIA card: the Case B
anchor sweep (CCSDS-121 lossless coding of a band-interleaved tile with the
full metric pass) and the Case A J2K quality ladder:

  * the flat stream, the CCSDS-121 encode plan, the J2K byte-target pricing
    and the metric pass are torch code on an explicit device; the plan's
    split-sample cost table and the pricing's 9/7 DWT are CUDA kernels
    written for Hopper (``tpukit_torch/csrc/fs_table.cu``,
    ``tpukit_torch/csrc/dwt97.cu``);
  * the entropy coding and decoding stay tpukit's host C++
    (``tpukit.native.ccsds121_host``, ``tpukit.io.j2c_enc``,
    ``tpukit.io.jp2``), which both packages share.

Module names mirror ``tpukit/`` so each counterpart is easy to find. The
package imports ``torch`` and never ``jax``: it reaches only the tpukit
modules that load without JAX (``tpukit.native``, ``tpukit.io``,
``tpukit.sweep.{csvio,proc}``, ``tpukit.viz.quicklooks`` and
``tpukit.codecs.base``) and re-homes the host helpers of the others.
"""

__version__ = "0.1.0"
