"""tpukit_torch — the PyTorch/CUDA port of tpukit, beside the JAX package.

The port runs tpukit's Case B anchor sweep (CCSDS-121 lossless coding of a
band-interleaved tile with the full metric pass) on an NVIDIA card:

  * the flat stream, the CCSDS-121 encode plan and the metric pass are
    torch code on an explicit device; the plan's split-sample cost table is
    a CUDA kernel written for Hopper (``tpukit_torch/csrc/fs_table.cu``);
  * the entropy pack and decode stay tpukit's host C++ coder
    (``tpukit.native.ccsds121_host``), which both packages share.

Module names mirror ``tpukit/`` so each counterpart is easy to find. The
package imports ``torch`` and never ``jax``: it reaches only the tpukit
modules that load without JAX (``tpukit.native``, ``tpukit.io``,
``tpukit.sweep.{csvio,proc}``, ``tpukit.viz.quicklooks`` and
``tpukit.codecs.base``) and re-homes the host helpers of the others.
"""

__version__ = "0.1.0"
