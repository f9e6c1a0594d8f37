# -*- coding: utf-8 -*-
"""CCSDS-121 split-sample cost table: kernel K1 and its plain version.

``fs_table`` replaces tpukit's ``_fs_table`` dispatch and its Pallas kernel
``_fs_table_pallas`` (tpukit/codecs/ccsds121.py:63-107). For an (nb, J)
int32 table of mapped residuals it returns the (nb, KMAX+1) int32 table
``fs[b, k] = Σ_j (coded[b, j] >> k)``.

  * A CUDA tensor launches the hand-written Hopper kernel
    (tpukit_torch/csrc/fs_table.cu) on its device's current stream, or
    raises; the caller's current device is left as it was. It
    sums from bit-plane counts; ``fs_table_planes`` is that arithmetic in
    torch, held equal to the plain version by the CPU tests.
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


def fs_table_planes(coded: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic, in torch: per row, bit-sliced counters
    (plane i holds bit i of every bit-plane count c_t) fed eight samples
    at a time through a Harley-Seal tree of carry-save adders and the rest
    one at a time; then ``fs[k] = sum_i (plane_i >> k) << i`` mod 2^32
    over the bit_length(J) planes. Non-negative int32 input."""
    nb, J = coded.shape
    x = coded.to(torch.int64)
    np_ = J.bit_length()
    p = [torch.zeros(nb, dtype=torch.int64, device=coded.device)
         for _ in range(7)]

    def csa(a, b, c):
        return (a & b) | (a & c) | (b & c), a ^ b ^ c

    def ripple(v, first):
        for i in range(first, np_):
            p[i], v = p[i] ^ v, p[i] & v

    j = 0
    while j + 8 <= J:
        col = [x[:, j + i] for i in range(8)]
        twos_a, p[0] = csa(p[0], col[0], col[1])
        twos_b, p[0] = csa(p[0], col[2], col[3])
        fours_a, p[1] = csa(p[1], twos_a, twos_b)
        twos_a, p[0] = csa(p[0], col[4], col[5])
        twos_b, p[0] = csa(p[0], col[6], col[7])
        fours_b, p[1] = csa(p[1], twos_a, twos_b)
        eights, p[2] = csa(p[2], fours_a, fours_b)
        ripple(eights, 3)
        j += 8
    for jj in range(j, J):
        ripple(x[:, jj], 0)
    fs = torch.stack([sum(((p[i] >> k) << i) for i in range(np_))
                      for k in range(KMAX + 1)], 1) & 0xFFFFFFFF
    return torch.where(fs >= 1 << 31, fs - (1 << 32), fs).to(torch.int32)


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
    with torch.cuda.device(coded.device):
        err = lib.tpk_fs_table(
            coded.data_ptr(), out.data_ptr(), nb, J, coded.get_device(),
            torch.cuda.current_stream(coded.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fs_table kernel launch failed: CUDA error {err} "
                           f"({lib.tpk_error_string(err).decode()})")
    fs_table.launches += 1
    return out


fs_table.launches = 0
