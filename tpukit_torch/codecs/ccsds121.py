# -*- coding: utf-8 -*-
"""CCSDS-121 block-adaptive Rice coder: the encoder model on a torch device.

Port of tpukit/codecs/ccsds121.py:42-280 and :524-666. The whole encoder
model (residual mapping, per-block option costs, libaec's split-k state,
zero-run/ROS segmentation and the exact output length) runs as tensor code
over a flattened sample stream; the split-sample cost table goes through
kernel K1 (``tpukit_torch.kernels.fs_table``). ``encode_plan`` turns the
model into the parallel-encode plan that tpukit's host C++ coder
(``tpukit.native.ccsds121_host.encode_parallel``/``decode_parallel``)
consumes: the plan keeps tpukit's dict schema, so a plan from either
package drives the same coder.

Where the port differs from the JAX code, and why:

  * the clamp-composition chain: JAX runs ``associative_scan`` over every
    block, but the plan needs only each chunk's composed (lo, hi)
    (tpukit/codecs/ccsds121.py:529-541), so the port takes an
    order-preserving pairwise reduction (``_compose_clamps``);
  * integer sums are kept exact (torch sums int32 into int64) and the plan
    folds the chunk chain in Python ints, as tpukit does (:644-655);
  * ``pack_words``/``encode_device`` (the on-device bit packer) are not on
    the anchor path and are not ported yet;
  * ``encode_size_rows`` sizes each row of a 2-D tensor with one pass over
    the flattened rows (one K1 launch), where tpukit vmaps ``encode_size``
    over the rows (tpukit/codecs/j2k_codec.py:328-334, :352-355).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tpukit_torch.kernels.fs_table import KMAX, fs_table

ID_LEN = 4        # 8 < bits <= 16
SEGMENT_BLOCKS = 64


def _map_residuals(x: torch.Tensor, ref_period: int,
                   bits: int = 16) -> torch.Tensor:
    """Unit-delay predictor + standard residual mapping; raw samples at
    reference positions (every ref_period samples)."""
    xi = x.to(torch.int32)
    prev = torch.cat([xi.new_zeros(1), xi[:-1]])
    xmax = (1 << bits) - 1
    theta = torch.minimum(prev, xmax - prev)
    delta = xi - prev
    d = torch.where((delta >= 0) & (delta <= theta), 2 * delta,
                    torch.where((delta < 0) & (-delta <= theta),
                                -2 * delta - 1, theta + delta.abs()))
    pos = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return torch.where(pos % ref_period == 0, xi, d)


def _clip(v, lo, hi):
    """jnp.clip's order: min(max(v, lo), hi)."""
    return torch.minimum(torch.maximum(v, lo), hi)


def _compose_clamps(lo: torch.Tensor,
                    hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose the per-block clamps ``k -> clip(k, lo_b, hi_b)`` in block
    order: the (lo, hi) of block 0's clamp followed by block 1's, and so on
    (tpukit's ``_clip_compose`` folded over the whole chain). Composition
    is associative but not commutative, so each level combines neighbours
    (left = earlier, right = later), padding an odd level with the
    identity clamp (0, KMAX). Log-depth, exact."""
    while lo.numel() > 1:
        if lo.numel() % 2:
            lo = torch.cat([lo, lo.new_zeros(1)])
            hi = torch.cat([hi, hi.new_full((1,), KMAX)])
        lo_l, lo_r = lo[0::2], lo[1::2]
        hi_l, hi_r = hi[0::2], hi[1::2]
        lo, hi = _clip(lo_l, lo_r, hi_r), _clip(hi_l, lo_r, hi_r)
    return lo[0], hi[0]


def analyze(x: torch.Tensor, bits: int = 16, J: int = 8, rsi: int = 2,
            preprocess: bool = True) -> Dict[str, torch.Tensor]:
    """Full encoder model for a flattened sample stream (port of tpukit
    ``analyze``, tpukit/codecs/ccsds121.py:119-264).

    Returns device tensors: ``option`` (nb,) 0=split,1=SE,2=nocomp,
    3=zero-head-or-member; ``blk_bits`` (nb,) emitted bits attributed to
    each block; ``total_bits`` and ``nbytes`` (int64 scalars); and the
    chunk's outgoing split-k interval ``k_lo_out``/``k_hi_out``
    (k_out = clip(k_in, k_lo_out, k_hi_out)).

    ``preprocess=False`` models the coder with the unit-delay preprocessor
    off (native flags=0): no reference samples; zero-run segmentation still
    resets at RSI and 64-block boundaries."""
    n = x.shape[0]
    if n % J:
        raise ValueError(f"whole blocks required: {n} samples, J={J}")
    _check_bits(bits)
    dev = x.device
    nb = n // J

    d_flat = (_map_residuals(x, J * rsi, bits) if preprocess
              else x.to(torch.int32))
    d = d_flat.reshape(nb, J)
    bidx = torch.arange(nb, dtype=torch.int32, device=dev)
    is_ref = ((bidx % rsi) == 0) if preprocess \
        else torch.zeros(nb, dtype=torch.bool, device=dev)
    m = torch.where(is_ref, J - 1, J).to(torch.int32)

    # coded residuals (slot 0 excluded on ref blocks)
    coded = d.clone()
    if preprocess:
        coded[0::rsi, 0] = 0        # the ref blocks are every rsi-th block

    # ---- split-k cost table (kernel K1 on CUDA) ------------------------
    ks = torch.arange(KMAX + 1, dtype=torch.int32, device=dev)
    split_len = fs_table(coded) + m[:, None] * (ks[None, :] + 1)

    # minimizer interval [mlo, mhi] of the convex split_len row: first and
    # last argmin (int8 for argmax, which takes the first maximum)
    best = split_len.amin(1, keepdim=True)
    is_min = (split_len == best).to(torch.int8)
    mlo = torch.argmax(is_min, 1).to(torch.int32)
    mhi = (KMAX - torch.argmax(is_min.flip(1), 1)).to(torch.int32)

    option, blk_bits, allzero = _block_bits(coded, best[:, 0], is_ref, m,
                                            bits, rsi, nb)

    # k-state chain: zero blocks are the identity clamp (0, KMAX)
    lo_e = torch.where(allzero, 0, mlo)
    hi_e = torch.where(allzero, KMAX, mhi)
    k_lo_out, k_hi_out = _compose_clamps(lo_e, hi_e)

    total_bits = blk_bits.sum(dtype=torch.int64)
    return {
        "option": option,
        "blk_bits": blk_bits,
        "total_bits": total_bits,
        "nbytes": (total_bits + 7) // 8,
        "k_lo_out": k_lo_out,
        "k_hi_out": k_hi_out,
    }


def _check_bits(bits: int):
    # ID_LEN/KMAX are the 4-bit-ID regime of the standard
    if not 8 < bits <= 16:
        raise ValueError(f"device model supports 8 < bits <= 16, got {bits}")


def _block_bits(coded: torch.Tensor, split_min: torch.Tensor,
                is_ref: torch.Tensor, m: torch.Tensor, bits: int, rsi: int,
                row_blocks: int):
    """(option, blk_bits, allzero) per block from the (nb, J) coded
    residuals and each block's least split length: the option choice and
    the zero-run segmentation of tpukit ``analyze`` (:173-240). Runs are
    segmented within rows of ``row_blocks`` blocks (the whole stream when
    that is nb): a row starts and ends a segment."""
    nb = coded.shape[0]
    dev = coded.device
    bidx = torch.arange(nb, dtype=torch.int32, device=dev)

    # ---- second extension (γ capped: SE only wins below nc_len bits) ---
    GCAP = 1 << 20
    a = coded[:, 0::2]
    b = coded[:, 1::2]
    ssum = torch.clamp(a + b, max=2048)
    gam = ssum * (ssum + 1) // 2 + torch.clamp(b, max=65535)
    gam_c = torch.clamp(gam, max=GCAP)
    se_len = 1 + (gam_c + 1).sum(1, dtype=torch.int32)
    se_len = torch.where((gam_c >= GCAP).any(1), 1 << 28, se_len)

    nc_len = m * bits

    # ---- zero blocks ---------------------------------------------------
    allzero = (coded == 0).all(1)

    # option choice (mirrors native emit_block: SE wins ties vs split); the
    # selected k lies in [mlo, mhi], so the split length is the row minimum
    use_se = (se_len <= split_min) & (se_len < nc_len)
    use_nc = (~use_se) & (split_min >= nc_len)
    option = torch.where(allzero, 3,
                         torch.where(use_se, 1, torch.where(use_nc, 2, 0)))
    payload = torch.where(use_se, se_len,
                          torch.where(use_nc, nc_len, split_min))
    nonzero_bits = ID_LEN + torch.where(is_ref, bits, 0) + payload

    # ---- zero-run segmentation -----------------------------------------
    local = bidx % row_blocks             # block index within its row
    cb = local % rsi                      # position within RSI chunk
    seg_break_before = (cb == 0) | (cb % SEGMENT_BLOCKS == 0)
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    prev_zero = torch.cat([false1, allzero[:-1]])
    run_start = allzero & (seg_break_before | ~prev_zero | is_ref)
    # head index for every block (running max of run-start positions)
    head_idx = torch.cummax(torch.where(run_start, bidx, -1), 0).values
    nxt = cb + 1
    at_seg_end = ((nxt == rsi) | (nxt % SEGMENT_BLOCKS == 0)
                  | (local == row_blocks - 1))
    nxt_break = at_seg_end | torch.cat([~allzero[1:] | is_ref[1:], ~false1])
    run_end = allzero & nxt_break
    z = bidx - head_idx + 1
    ros = run_end & at_seg_end & (z > 4)
    fs_bits = torch.where(ros, 5, torch.where(z <= 4, z, z + 1))
    head_is_ref = is_ref[head_idx.clamp(0, nb - 1).long()]
    marker_bits = ID_LEN + 1 + torch.where(head_is_ref, bits, 0) + fs_bits
    zero_bits = torch.where(run_end, marker_bits, 0)

    blk_bits = torch.where(allzero, zero_bits, nonzero_bits).to(torch.int32)
    return option.to(torch.int32), blk_bits, allzero


def encode_size_rows(x: torch.Tensor, bits: int = 16, J: int = 8,
                     rsi: int = 2) -> torch.Tensor:
    """(R,) int64 exact byte sizes of each row of the (R, n) samples,
    coded on its own with the preprocessor off: the counterpart of
    ``jax.vmap(lambda v: encode_size(v, bits, J, rsi, preprocess=False))``.

    Without the preprocessor a block's cost depends on its own samples
    only, and the zero-run segmentation is cut at every row's start and
    end, so one pass over the flattened rows gives every row's blocks (one
    K1 launch for all rows); the k-state chain, which sizes do not need,
    is skipped. A partial final block of a row is padded by repeating the
    row's last sample, as ``encode_size`` does."""
    _check_bits(bits)
    R, n = x.shape
    pad = (-n) % J
    if pad:
        x = torch.cat([x, x[:, -1:].expand(R, pad)], 1)
    nbr = (n + pad) // J
    coded = x.to(torch.int32).reshape(R * nbr, J).contiguous()
    ks = torch.arange(KMAX + 1, dtype=torch.int32, device=x.device)
    split_min = (fs_table(coded) + J * (ks + 1)).amin(1)
    is_ref = torch.zeros(R * nbr, dtype=torch.bool, device=x.device)
    m = torch.full((R * nbr,), J, dtype=torch.int32, device=x.device)
    _, blk_bits, _ = _block_bits(coded, split_min, is_ref, m, bits, rsi, nbr)
    return (blk_bits.reshape(R, nbr).sum(1, dtype=torch.int64) + 7) // 8


def encode_size(x: torch.Tensor, bits: int = 16, J: int = 8, rsi: int = 2,
                preprocess: bool = True) -> int:
    """Exact compressed byte size (== native/libaec encoder output length).
    A partial final block is padded by repeating the last sample, the libaec
    convention the host coder also follows."""
    pad = (-x.shape[0]) % J
    if pad:
        x = torch.cat([x, x[-1:].expand(pad)])
    return int(analyze(x, bits=bits, J=J, rsi=rsi,
                       preprocess=preprocess)["nbytes"])


def chunk_stats(x: torch.Tensor, bits: int = 16, J: int = 8, rsi: int = 2,
                preprocess: bool = True):
    """Per-chunk model: (total_bits, k_lo_out, k_hi_out) as device scalars.

    The chunk's bit length does not depend on the incoming split-k state:
    every block's k lands inside its argmin interval, where every k costs
    the row minimum (tpukit/codecs/ccsds121.py:527-539). Only the emitted
    bits depend on k, so the plan threads k_out = clip(k_in, lo, hi)."""
    a = analyze(x, bits=bits, J=J, rsi=rsi, preprocess=preprocess)
    return a["total_bits"], a["k_lo_out"], a["k_hi_out"]


def encode_plan(x: torch.Tensor, bits: int = 16, J: int = 8, rsi: int = 2,
                chunk: int = 1 << 22,
                preprocess: bool = True) -> Optional[dict]:
    """Device-computed parallel-encode plan (tpukit/codecs/ccsds121.py:566-655).

    Splits the stream into chunks that end on reference-sample intervals,
    models every chunk on x's device (the launches queue asynchronously),
    brings the (nch, 3) table to the host in one copy and folds the split-k
    chain in Python ints. Returns tpukit's plan dict (``n``, ``sizes``,
    ``k_in``, ``bit_off``, ``seg_bits``, ``total_bits``, ``bits``, ``J``,
    ``rsi``, ``preprocess``), or None when the stream is too small or
    misaligned to chunk (callers then take the monolithic coder)."""
    n = int(x.shape[0])
    chunk -= chunk % (J * rsi)       # chunks must end on an RSI boundary
    if chunk <= 0 or n <= chunk or n % (J * rsi) != 0 or n % J != 0:
        return None
    sizes = [chunk] * (n // chunk)
    if n % chunk:
        sizes.append(n % chunk)
    stats = []
    start = 0
    for sz in sizes:
        stats.append(torch.stack([v.to(torch.int64) for v in chunk_stats(
            x[start:start + sz], bits=bits, J=J, rsi=rsi,
            preprocess=preprocess)]))
        start += sz
    table = torch.stack(stats).cpu().tolist()
    k = 0
    off = 0
    k_in, bit_off, seg_bits = [], [], []
    for t, lo, hi in table:
        k_in.append(k)
        bit_off.append(off)
        seg_bits.append(t)
        off += t
        k = min(max(k, lo), hi)
    return {"n": n, "sizes": sizes, "k_in": k_in, "bit_off": bit_off,
            "seg_bits": seg_bits, "total_bits": off,
            "bits": bits, "J": J, "rsi": rsi, "preprocess": preprocess}


def encode_size_chunked(x: torch.Tensor, bits: int = 16, J: int = 8,
                        rsi: int = 2, chunk: int = 1 << 22,
                        preprocess: bool = True) -> int:
    """Exact encoded byte size using fixed-shape chunks (see encode_plan)."""
    plan = encode_plan(x, bits=bits, J=J, rsi=rsi, chunk=chunk,
                       preprocess=preprocess)
    if plan is None:
        return encode_size(x, bits=bits, J=J, rsi=rsi, preprocess=preprocess)
    return (plan["total_bits"] + 7) // 8
