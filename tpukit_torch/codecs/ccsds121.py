# -*- coding: utf-8 -*-
"""CCSDS-121 block-adaptive Rice coder: the encoder model and the bit
packer on a torch device.

Port of tpukit/codecs/ccsds121.py:42-666. The whole encoder model (residual
mapping, per-block option costs, libaec's split-k state, zero-run/ROS
segmentation and the exact output length) runs as tensor code over a
flattened sample stream; the split-sample cost table goes through kernel K1
(``tpukit_torch.kernels.fs_table``). ``encode_plan`` turns the model into
the parallel-encode plan that the host C++ coder
(``native.ccsds121_host.encode_parallel``/``decode_parallel``) consumes,
and ``pack_words``/``encode_device`` build the bitstream itself on the
device; ``encode``/``decode`` are tpukit's host-coder API. The plan keeps
tpukit's dict schema, so a plan from either package drives the same
coder.

Where the port differs from the JAX code, and why:

  * the clamp-composition chain: JAX runs ``associative_scan`` over every
    block. The packer needs every block's composed clamp, and gets it from
    a doubling scan (``_scan_clamps``); the size-only callers
    (``chunk_stats``, ``encode_plan``, ``encode_size``) need only the whole
    chunk's composed (lo, hi) (tpukit/codecs/ccsds121.py:529-541) and take
    an order-preserving pairwise reduction (``_compose_clamps``), which
    costs a fraction of the scan: ``analyze(..., scan=False)``;
  * integer sums are kept exact (torch sums int32 into int64) and the plan
    folds the chunk chain in Python ints, as tpukit does (:644-655);
  * codewords: tpukit builds them in uint32 with logical shifts. torch has
    no uint32 arithmetic on CUDA, so the packer carries each 32-bit word as
    an int64 in [0, 2^32) and masks after every left shift; the register
    file and the output buffer are filled with ``index_add_`` (integer
    adds, so the result does not depend on the order of the atomics), the
    addends never share set bits, so add == or, and indices that tpukit
    leaves to XLA's ``mode="drop"`` are masked off first;
  * ``encode_size_rows`` sizes each row of a 2-D tensor with one pass over
    the flattened rows (one K1 launch), where tpukit vmaps ``encode_size``
    over the rows (tpukit/codecs/j2k_codec.py:328-334, :352-355).
"""

from __future__ import annotations

import contextlib

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpukit_torch.kernels.fs_table import KMAX, fs_table
from tpukit_torch.native import ccsds121_host

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


def _scan_clamps(lo: torch.Tensor,
                 hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the per-block clamps in block order: element b is
    the (lo, hi) of blocks 0..b composed (``jax.lax.associative_scan`` of
    tpukit's ``_clip_compose``, tpukit/codecs/ccsds121.py:196). A doubling
    scan: step s replaces x[i] by compose(x[i - 2^s], x[i]) for i >= 2^s,
    the earlier span always as the left operand, since composition is
    associative but not commutative. ceil(log2 nb) steps, exact."""
    s = 1
    while s < lo.numel():
        lo_r, hi_r = lo[s:], hi[s:]
        lo = torch.cat([lo[:s], _clip(lo[:-s], lo_r, hi_r)])
        hi = torch.cat([hi[:s], _clip(hi[:-s], lo_r, hi_r)])
        s *= 2
    return lo, hi


def analyze(x: torch.Tensor, bits: int = 16, J: int = 8, rsi: int = 2,
            preprocess: bool = True,
            scan: bool = True) -> Dict[str, torch.Tensor]:
    """Full encoder model for a flattened sample stream (port of tpukit
    ``analyze``, tpukit/codecs/ccsds121.py:119-264).

    Returns tpukit's dict of device tensors: ``d`` (nb, J) mapped residuals
    (slot 0 raw on reference blocks) and ``coded`` (slot 0 zeroed there);
    ``k_sel`` (nb,) the split k entering from k = 0, with ``lo_s``/``hi_s``
    the composed clamp up to each block; ``is_ref``, ``allzero``;
    ``option`` (nb,) 0=split,1=SE,2=nocomp,3=zero-head-or-member; ``gam_c``
    (nb, J/2) the capped second-extension symbols; ``blk_bits`` (nb,)
    emitted bits attributed to each block; ``total_bits`` and ``nbytes``
    (int64 scalars); the chunk's outgoing split-k interval
    ``k_lo_out``/``k_hi_out`` (k_out = clip(k_in, k_lo_out, k_hi_out));
    and the zero-run segmentation ``run_end``, ``head_idx``, ``z``, ``ros``.

    ``scan=False`` is for callers that need sizes only: the per-block scan
    is replaced by the reduction, and ``k_sel``, ``lo_s``, ``hi_s`` are
    left out.

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

    out = _block_bits(coded, best[:, 0], is_ref, m, bits, rsi, nb)
    allzero = out["allzero"]

    # k-state chain: zero blocks are the identity clamp (0, KMAX)
    lo_e = torch.where(allzero, 0, mlo)
    hi_e = torch.where(allzero, KMAX, mhi)
    if scan:
        lo_s, hi_s = _scan_clamps(lo_e, hi_e)
        # k_sel: the composed clamp applied to k_init = 0
        out.update(k_sel=lo_s, lo_s=lo_s, hi_s=hi_s,
                   k_lo_out=lo_s[-1], k_hi_out=hi_s[-1])
    else:
        out["k_lo_out"], out["k_hi_out"] = _compose_clamps(lo_e, hi_e)

    total_bits = out["blk_bits"].sum(dtype=torch.int64)
    out.update(d=d, coded=coded, is_ref=is_ref, total_bits=total_bits,
               nbytes=(total_bits + 7) // 8)
    return out


def _check_bits(bits: int):
    # ID_LEN/KMAX are the 4-bit-ID regime of the standard
    if not 8 < bits <= 16:
        raise ValueError(f"device model supports 8 < bits <= 16, got {bits}")


def _block_bits(coded: torch.Tensor, split_min: torch.Tensor,
                is_ref: torch.Tensor, m: torch.Tensor, bits: int, rsi: int,
                row_blocks: int):
    """Per-block ``option``, ``blk_bits``, ``allzero``, ``gam_c``,
    ``run_end``, ``head_idx``, ``z`` and ``ros`` from the (nb, J) coded
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
    return {"option": option.to(torch.int32), "blk_bits": blk_bits,
            "allzero": allzero, "gam_c": gam_c, "run_end": run_end,
            "head_idx": head_idx, "z": z, "ros": ros}


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
    blk_bits = _block_bits(coded, split_min, is_ref, m, bits, rsi,
                           nbr)["blk_bits"]
    return (blk_bits.reshape(R, nbr).sum(1, dtype=torch.int64) + 7) // 8


def encode_size(x: torch.Tensor, bits: int = 16, J: int = 8, rsi: int = 2,
                preprocess: bool = True) -> int:
    """Exact compressed byte size (== native/libaec encoder output length).
    A partial final block is padded by repeating the last sample, the libaec
    convention the host coder also follows."""
    pad = (-x.shape[0]) % J
    if pad:
        x = torch.cat([x, x[-1:].expand(pad)])
    return int(analyze(x, bits=bits, J=J, rsi=rsi, preprocess=preprocess,
                       scan=False)["nbytes"])


# ---------------------------------------------------------------------------
# Device bit-packer: the full encoder on the device (per-block codeword
# registers, prefix-sum bit offsets, and a disjoint-bit scatter-add into the
# output word buffer). Port of tpukit/codecs/ccsds121.py:288-516.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _reg_words(bits: int, J: int) -> int:
    """Register words per block: the worst codeword is ID_LEN + 1 (SE
    selector) + J*bits (no-compression payload, reference sample included)."""
    return (ID_LEN + 1 + J * bits + 31) // 32


def _add_words(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor):
    """``buf[idx] += val`` for a flat int64 word buffer, dropping indices
    outside it (XLA's ``mode="drop"``): their addend is zeroed and the
    index clamped, since torch raises or corrupts where XLA drops."""
    ok = (idx >= 0) & (idx < buf.numel())
    buf.index_add_(0, idx.clamp(0, buf.numel() - 1),
                   torch.where(ok, val, 0))


def _reg_insert(W: torch.Tensor, pos, value, width, mask) -> torch.Tensor:
    """OR the ``width``-bit ``value`` (MSB-first) at local bit ``pos`` into
    the (nb, reg_words) register file, in place. ``pos``, ``value``,
    ``width`` and ``mask`` are ints or tensors that broadcast to (nb,), one
    insert a block, or to (nb, m), m inserts a block at once (tpukit makes
    those one by one, tpukit/codecs/ccsds121.py:299-317; the file comes out
    the same, since the inserts of a block never share a set bit).
    Out-of-range positions drop silently (callers gate by mask, which
    zeroes the value). Words are int64 values in [0, 2^32); every insert's
    two addends go into the flattened file with ``index_add_``: integer
    adds in any order, and add == or."""
    nb, R = W.shape
    as64 = lambda x: torch.as_tensor(x, device=W.device).to(torch.int64)
    pos, value, width, mask = torch.broadcast_tensors(
        as64(pos), as64(value), as64(width),
        torch.as_tensor(mask, device=W.device))
    value = torch.where(mask, value & _M32, 0)
    l = pos >> 5
    left_space = 32 - (pos & 31)
    rsh = width - left_space            # > 0: the value spans two words
    hi = torch.where(rsh > 0, value >> rsh.clamp(0, 31),
                     (value << (left_space - width).clamp(0, 31)) & _M32)
    lo = torch.where(rsh > 0, (value << (32 - rsh).clamp(0, 31)) & _M32, 0)
    row = torch.arange(nb, dtype=torch.int64, device=W.device) * R
    if pos.dim() == 2:
        row = row[:, None]
    flat = W.view(-1)
    for word, v in ((l, hi), (l + 1, lo)):
        v = torch.where((word >= 0) & (word < R), v, 0)
        flat.index_add_(0, (row + word.clamp(0, R - 1)).reshape(-1),
                        v.reshape(-1))
    return W


def _excl_cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exclusive prefix sum. Along the short last axis of an (nb, J) tensor
    the scan runs over the transposed view: torch's CUDA scan of an
    innermost axis takes one pass per row (3.4 ms at (524288, 16) on an
    H100, 0.3 ms through the transpose; chip_smoke.py logs both)."""
    if x.dim() == 2 and axis == 1:
        return torch.cumsum(x.t(), 0).t() - x
    return torch.cumsum(x, axis) - x


def pack_words(x: torch.Tensor, k_init: torch.Tensor, bits: int = 16,
               J: int = 8, rsi: int = 2, out_words: int = 0,
               preprocess: bool = True):
    """Full CCSDS-121 encode on x's device.

    Returns (words[out_words], total_bits, k_lo_out, k_hi_out): the packed
    stream as int64 words in [0, 2^32) plus the chunk's outgoing split-k
    interval, all device tensors, so callers can chain chunks as device
    scalars without a host sync.

    Bit-exact with the C++/libaec coder: every block's codeword is built in
    a fixed-width register file sized for the worst codeword of (bits, J),
    block bit offsets come from a prefix sum of the modeled lengths, and the
    registers scatter-add into the output; contributions never share set
    bits, so add == or. The bitstream is the big-endian byte view of the
    words' low 32 bits. ``k_init`` (0-dim tensor) is the split-k search
    state entering the chunk (0 for a whole stream)."""
    a = analyze(x, bits=bits, J=J, rsi=rsi, preprocess=preprocess)
    dev = x.device
    nb = x.shape[0] // J
    d = a["d"]
    coded = a["coded"]
    is_ref = a["is_ref"]
    option = a["option"]
    run_end = a["run_end"]
    k_sel = _clip(k_init.to(torch.int32), a["lo_s"], a["hi_s"])

    blk_off = _excl_cumsum(a["blk_bits"].to(torch.int64), 0)
    R = _reg_words(bits, J)
    W = torch.zeros((nb, R), dtype=torch.int64, device=dev)
    coded_mask = torch.ones((nb, J), dtype=torch.bool, device=dev)
    coded_mask[:, 0] = ~is_ref

    is_split = option == 0
    is_se = option == 1
    is_nc = option == 2

    # --- ID fields -------------------------------------------------------
    _reg_insert(W, 0, k_sel + 1, ID_LEN, is_split)
    _reg_insert(W, 0, 1, ID_LEN + 1, is_se)
    _reg_insert(W, 0, (1 << ID_LEN) - 1, ID_LEN, is_nc)
    # zero-run marker ID+selector are all-zero bits: nothing to set

    # --- reference samples -----------------------------------------------
    ref_bits = torch.where(is_ref, bits, 0)
    _reg_insert(W, torch.where(is_se, ID_LEN + 1, ID_LEN), d[:, 0], bits,
                is_ref & (is_split | is_se))

    # --- no-compression body: J raw (preprocessed) samples ---------------
    lane = torch.arange(J, dtype=torch.int32, device=dev)[None]
    _reg_insert(W, ID_LEN + bits * lane, d, bits, is_nc[:, None])

    # --- split option: fs codes then k-bit LSBs ---------------------------
    base = ID_LEN + ref_bits
    q = coded >> k_sel[:, None]
    fs_len = torch.where(coded_mask, q + 1, 0)
    cumex = _excl_cumsum(fs_len, 1)
    one_pos = base[:, None] + cumex + q          # position of each fs '1'
    _reg_insert(W, one_pos, 1, 1, is_split[:, None] & coded_mask)
    base2 = base + cumex[:, -1] + fs_len[:, -1]
    # slot 0 is the only one a block can leave out
    rank = lane - is_ref[:, None].to(torch.int32)
    kmask = (1 << k_sel) - 1
    split_k = is_split & (k_sel > 0)
    _reg_insert(W, base2[:, None] + rank * k_sel[:, None],
                coded & kmask[:, None], k_sel[:, None],
                split_k[:, None] & coded_mask)

    # --- second extension: gamma fs codes ---------------------------------
    gam = a["gam_c"]
    gbase = ID_LEN + 1 + ref_bits
    gcum = _excl_cumsum(gam + 1, 1)
    _reg_insert(W, gbase[:, None] + gcum + gam, 1, 1, is_se[:, None])

    # --- zero-run markers (attributed to the run-end block) ---------------
    head = a["head_idx"].clamp(0, nb - 1).long()
    head_is_ref = is_ref[head]
    _reg_insert(W, ID_LEN + 1, d[:, 0][head], bits, run_end & head_is_ref)
    z = a["z"]
    v = torch.where(a["ros"], 4, torch.where(z <= 4, z - 1, z))
    _reg_insert(W, ID_LEN + 1 + torch.where(head_is_ref, bits, 0) + v, 1, 1,
                run_end)

    # --- scatter the registers into the global word buffer ----------------
    out = torch.zeros(out_words, dtype=torch.int64, device=dev)
    s = (blk_off & 31)[:, None]         # the same for every word of a block
    g = ((blk_off >> 5)[:, None]
         + torch.arange(R, dtype=torch.int64, device=dev)[None]).reshape(-1)
    _add_words(out, g, (W >> s).reshape(-1))
    _add_words(out, g + 1, ((W << (32 - s)) & _M32).reshape(-1))
    return out, a["total_bits"], a["k_lo_out"], a["k_hi_out"]


def pack_cap_words(n: int, bits: int = 16, J: int = 8) -> int:
    """Static output-word capacity for pack_words. The exact worst case per
    block is ID_LEN + 1 (SE selector) + J*bits (reference samples are
    included in the J*bits of the no-compression payload), so this bound
    can never be exceeded; a word beyond it would be dropped."""
    nb = (n + J - 1) // J
    cap_bits = nb * (ID_LEN + 1) + n * bits + 64
    return cap_bits // 32 + 2


def _words_to_host(words) -> list:
    """Bring int64 word tensors (values in [0, 2^32)) to the host as
    big-endian uint8 arrays. Each is narrowed on the device to the int32
    with the same low 32 bits (values from 2^31 up map to v - 2^32), so
    the copy is 4 bytes a word; on CUDA the copies go to pinned memory
    without waiting and one synchronize covers them all."""
    host = []
    for w in words:
        w32 = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
        if w32.device.type == "cuda":
            buf = torch.empty(w32.shape, dtype=torch.int32, pin_memory=True)
            buf.copy_(w32, non_blocking=True)
            w32 = buf
        host.append(w32)
    if words and words[0].device.type == "cuda":
        torch.cuda.current_stream(words[0].device).synchronize()
    return [h.numpy().view(np.uint32).astype(">u4").view(np.uint8)
            for h in host]


def encode_device(x: torch.Tensor, bits: int = 16, J: int = 8, rsi: int = 2,
                  chunk: int = 1 << 23, preprocess: bool = True,
                  return_plan: bool = False):
    """Produce the actual CCSDS-121 bitstream on x's device.

    Chunks end on reference-sample intervals, and the split-k chain threads
    between chunks as device scalars (k_next = clip(k, lo_out, hi_out)), so
    every chunk's pack is queued without a host sync and ``analyze`` runs
    exactly once per chunk. The bit lengths come down in one copy, then the
    word buffers trimmed on the device to the used prefix, and the host
    splices them at their bit offsets (the only host work). Byte-identical
    to ``native.ccsds121_host.encode`` and to libaec.

    With ``return_plan=True`` returns ``(bytes, plan)``: the plan carries
    the chunk sample counts and exact bit offsets, enough for
    ``ccsds121_host.decode_parallel``/``decode_to_device`` to decode every
    chunk independently (tpukit's plan without ``k_in``, which only the
    parallel host *encoder* needs)."""
    from tpukit_torch.native.ccsds121_host import splice_segments

    n = int(x.shape[0])
    step = J * rsi
    if n % J:
        raise ValueError(f"whole blocks required: {n} samples, J={J}")
    chunk -= chunk % step
    if chunk <= 0 or n <= chunk:
        # monolithic pack: refuse streams whose worst-case output could
        # cross 2^31 bits, tpukit's limit (chunked callers never get here)
        if pack_cap_words(n, bits, J) * 32 >= (1 << 31):
            raise ValueError(
                f"stream of {n} samples too large for a monolithic pack; "
                f"pass a positive chunk size")
        sizes = [n]
    else:
        sizes = [chunk] * (n // chunk)
        if n % chunk:
            sizes.append(n % chunk)
    parts = []
    start = 0
    k = torch.zeros((), dtype=torch.int32, device=x.device)
    for sz in sizes:
        words, tb, lo, hi = pack_words(
            x[start:start + sz], k, bits=bits, J=J, rsi=rsi,
            out_words=pack_cap_words(sz, bits, J), preprocess=preprocess)
        parts.append((words, tb))
        k = _clip(k, lo, hi)
        start += sz
    # two-phase fetch: the bit lengths first (one tiny copy, the only wait
    # for the packs), then the word buffers trimmed on the device to the
    # used prefix (+2 words of zero slack for the splicer)
    seg_bits = torch.stack([tb for _, tb in parts]).cpu().tolist()
    host_words = _words_to_host(
        [w[:(t + 31) // 32 + 2] for (w, _), t in zip(parts, seg_bits)])
    off = 0
    bit_off = []
    for tb in seg_bits:
        bit_off.append(off)
        off += tb
    plan = {"n": n, "sizes": sizes, "bit_off": bit_off,
            "seg_bits": seg_bits, "total_bits": off, "bits": bits, "J": J,
            "rsi": rsi, "preprocess": preprocess}
    if len(sizes) == 1:
        bs = host_words[0][:(off + 7) // 8].tobytes()
    else:
        bs = splice_segments(list(zip(host_words, seg_bits)), plan)
    return (bs, plan) if return_plan else bs


def chunk_stats(x: torch.Tensor, bits: int = 16, J: int = 8, rsi: int = 2,
                preprocess: bool = True):
    """Per-chunk model: (total_bits, k_lo_out, k_hi_out) as device scalars.

    The chunk's bit length does not depend on the incoming split-k state:
    every block's k lands inside its argmin interval, where every k costs
    the row minimum (tpukit/codecs/ccsds121.py:527-539). Only the emitted
    bits depend on k, so the plan threads k_out = clip(k_in, lo, hi)."""
    a = analyze(x, bits=bits, J=J, rsi=rsi, preprocess=preprocess,
                scan=False)
    return a["total_bits"], a["k_lo_out"], a["k_hi_out"]


def encode_plan(x, bits: int = 16, J: int = 8, rsi: int = 2,
                chunk: int = 1 << 22, preprocess: bool = True,
                devices=None) -> Optional[dict]:
    """Device-computed parallel-encode plan (tpukit/codecs/ccsds121.py:566-655).

    Splits the stream into chunks that end on reference-sample intervals,
    models every chunk on x's device (the launches queue asynchronously),
    brings the (nch, 3) table to the host in one copy and folds the split-k
    chain in Python ints. Returns tpukit's plan dict (``n``, ``sizes``,
    ``k_in``, ``bit_off``, ``seg_bits``, ``total_bits``, ``bits``, ``J``,
    ``rsi``, ``preprocess``), or None when the stream is too small or
    misaligned to chunk (callers then take the monolithic coder).

    ``devices``: positions of a device mesh (parallel/mesh.py) to spread
    the chunks over, round-robin. ``x`` is then the host stream (numpy);
    each chunk is uploaded by its position and modelled on its stream, and
    its three scalars are fetched from there once every chunk is enqueued.
    The model is integer and the k chain folds on the host, so the plan
    equals the single-device plan for any layout."""
    n = int(x.shape[0])
    chunk -= chunk % (J * rsi)       # chunks must end on an RSI boundary
    if chunk <= 0 or n <= chunk or n % (J * rsi) != 0 or n % J != 0:
        return None
    sizes = [chunk] * (n // chunk)
    if n % chunk:
        sizes.append(n % chunk)
    stats = []
    start = 0
    for i, sz in enumerate(sizes):
        pos = devices[i % len(devices)] if devices is not None else None
        xs = x[start:start + sz]
        with (pos.run() if pos is not None else contextlib.nullcontext()):
            if pos is not None:
                xs = pos.put(xs).to(torch.int32)
            stats.append(torch.stack([v.to(torch.int64) for v in chunk_stats(
                xs, bits=bits, J=J, rsi=rsi, preprocess=preprocess)]))
        start += sz
    if devices is None:
        table = torch.stack(stats).cpu().tolist()
    else:
        table = [devices[i % len(devices)].fetch(t).tolist()
                 for i, t in enumerate(stats)]
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


# ---- tpukit's codec API (tpukit/codecs/ccsds121.py:673-682): the host coder

def encode(samples: np.ndarray, bits: int = 16, J: int = 8,
           rsi: int = 2) -> bytes:
    """The CCSDS-121 bitstream of ``samples`` from the host C++ coder
    (bit-exact with libaec)."""
    return ccsds121_host.encode(np.asarray(samples).ravel(), bits, J, rsi)


def decode(bitstream: bytes, n_samples: int, bits: int = 16, J: int = 8,
           rsi: int = 2) -> np.ndarray:
    """``n_samples`` uint16 samples of ``bitstream``, by the host coder."""
    return ccsds121_host.decode(bitstream, n_samples, bits, J, rsi)
