# -*- coding: utf-8 -*-
"""CCSDS-121 split-sample cost table: kernel K1 and its plain version.

``fs_table`` replaces tpukit's ``_fs_table`` dispatch and its Pallas kernel
``_fs_table_pallas`` (tpukit/codecs/ccsds121.py:63-107). For an (nb, J)
int32 table of mapped residuals it returns the (nb, KMAX+1) int32 table
``fs[b, k] = Σ_j (coded[b, j] >> k)``.

  * A CUDA tensor launches the hand-written Hopper kernel
    (tpukit_torch/csrc/fs_table.cu) on the current stream, or raises.
  * A CPU tensor takes the plain version ``fs_table_ref``, the port of
    ``_fs_table_jnp`` (:57-60).

``fs_table.launches`` counts kernel launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import torch

KMAX = 13
MAX_J = 64


def fs_table_ref(coded: torch.Tensor) -> torch.Tensor:
    """Plain torch version: one shifted int32 row sum per k."""
    return torch.stack([(coded >> k).sum(1, dtype=torch.int32)
                        for k in range(KMAX + 1)], 1)


def fs_table(coded: torch.Tensor) -> torch.Tensor:
    """(nb, J) int32 -> (nb, KMAX+1) int32 split-sample cost table."""
    if coded.device.type == "cpu":
        return fs_table_ref(coded)
    if coded.device.type != "cuda":
        raise ValueError(f"fs_table: unsupported device {coded.device}")
    if coded.dtype != torch.int32 or coded.dim() != 2:
        raise ValueError(f"fs_table: need a 2-D int32 tensor, got "
                         f"{coded.dtype} of shape {tuple(coded.shape)}")
    if not coded.is_contiguous():
        raise ValueError("fs_table: the input must be contiguous")
    nb, J = coded.shape
    if not 1 <= J <= MAX_J:
        raise ValueError(f"fs_table: block size J={J} outside 1..{MAX_J}")
    out = torch.empty((nb, KMAX + 1), dtype=torch.int32, device=coded.device)
    if nb == 0:
        return out
    from tpukit_torch.kernels import build

    lib = build.load()
    err = lib.tpk_fs_table(coded.data_ptr(), out.data_ptr(), nb, J,
                           coded.get_device(),
                           torch.cuda.current_stream(coded.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fs_table kernel launch failed: CUDA error {err} "
                           f"({lib.tpk_error_string(err).decode()})")
    fs_table.launches += 1
    return out


fs_table.launches = 0
