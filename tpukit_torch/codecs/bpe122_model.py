# -*- coding: utf-8 -*-
"""Exact model of the CCSDS 122.0-B BPE coder (native/src/bpe122.cpp) on
torch tensors: stream byte counts and truncated-decode reconstructions as
functions of the (S, 64) weighted block coefficients.

Port of tpukit/codecs/bpe122_model.py. Like ``bitplane_model`` for the
embedded coder, every bit the BPE emits sits at a position that is a closed
form of the coefficients' MSB indices and the per-gaggle code-option
selections, both deterministic. So a rate ladder prices and reconstructs
every SegByteLimit point on the device: DWT -> gather -> model -> inverse
DWT with no coefficient-plane transfers; the host coder builds real
segments only when the streams are kept.

Scope: single-segment streams (one segment per band; S <= 2^20). The
atomicity rules mirrored here are documented in bpe122.cpp: DC/depth
gaggles atomic, the depth section all-or-nothing, stage-1..3 units (word +
signs) atomic, per-bit elsewhere.

What differs from tpukit's jnp code, and why the integers are the same:

  * bands are a leading axis (tpukit maps over bands with ``jax.vmap``):
    every function takes (S, 64) or (B, S, 64) blocks. A 1024² band holds
    S = 16384 blocks and its layout about 230 MB (``LAYOUT_BYTES_PER_BLOCK``),
    so callers group bands by the memory they have;
  * the 32 bit planes are a loop from the top plane down that writes into
    preallocated outputs (tpukit: ``jax.vmap`` over the plane index). Going
    down, a plane's start is known when it is reached (the planes above it
    are summed already), so each coefficient's acquisition end is taken
    from its own plane's unit ends on the spot; tpukit stacks the 32
    planes' unit ends and gathers from them afterwards. Planes at or above
    the group's deepest ``bd_ac`` emit nothing and are skipped;
  * magnitudes and reconstructions are int64 in [0, 2^32) (torch has no
    uint32 arithmetic), the two's-complement width of a DC value masks with
    ``0xFFFFFFFF`` where tpukit wraps in uint32, and every shift amount is
    clamped below the width of its type. Positions are int32 as in tpukit;
    the ``_INF`` sentinel (2^30) keeps its value.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from tpukit_torch.codecs.bitplane_model import _msb_index, _wrap_i32

GAGGLE = 16
HDR_BYTES = 20                    # Part 1A + 1B + 2 + 3 + 4 (single seg)
HDR_BITS = 8 * HDR_BYTES
NSLOT = 22
_INF = 1 << 30

# bytes of device memory one block of a band's layout and the temporaries
# of building and evaluating it take (the (32, Sp, 63) int32 stage-4
# positions are 8 KB of it): what callers size their band groups with
LAYOUT_BYTES_PER_BLOCK = 14 * 1024

# ---------------------------------------------------------------------------
# VLC tables — mirror native/src/bpe122.cpp exactly
# ---------------------------------------------------------------------------

_OPT_LENS = {
    2: [[1, 2, 3, 3]],
    3: [[1, 2, 3, 4, 5, 6, 7, 7],
        [2, 2, 3, 3, 4, 4, 5, 5]],
    4: [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 15],
        [2, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7],
        [3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5]],
}


def _sym_tables():
    """(5,16) word-value -> symbol maps, full and restricted (popcount
    asc, value asc; restricted drops the all-zero word)."""
    full = np.zeros((5, 16), np.int32)
    restr = np.zeros((5, 16), np.int32)
    for L in (2, 3, 4):
        n = 1 << L
        order = sorted(range(n), key=lambda v: (bin(v).count("1"), v))
        for s, v in enumerate(order):
            full[L, v] = s
            if s >= 1:
                restr[L, v] = s - 1
    return full, restr


def _len_tables():
    """(5, 3, 16) code length per (class, option, symbol); absent options
    are +inf so they never win the min."""
    t = np.full((5, 3, 16), 1 << 20, np.int64)
    for L, opts in _OPT_LENS.items():
        for o, lens in enumerate(opts):
            t[L, o, :len(lens)] = lens
    return t.astype(np.int32)


_SYM_FULL, _SYM_RESTR = _sym_tables()
_LEN_TAB = _len_tables()
_NOPT = np.asarray([0, 0, 1, 2, 3], np.int32)         # coded options / class
_IDB = np.asarray([0, 0, 1, 2, 2], np.int32)          # ID field bits / class


def _slot_of() -> np.ndarray:
    """Per AC coefficient, the slot that declares it at its MSB plane:
    parent k=21f -> slot 0; child -> slot 3+f; grandchild (f, group j) ->
    slot 8+5f+j."""
    slot_of = np.zeros(63, np.int64)
    for f in range(3):
        slot_of[21 * f] = 0
        slot_of[21 * f + 1: 21 * f + 5] = 3 + f
        for j in range(4):
            slot_of[21 * f + 5 + 4 * j: 21 * f + 9 + 4 * j] = 8 + 5 * f + j
    return slot_of


@lru_cache(maxsize=8)
def _tables(device: torch.device) -> dict:
    """The lookup tables on one device, uploaded once."""
    slot_stage = np.ones(NSLOT, np.int32)
    slot_stage[1:6] = 2
    slot_stage[6:] = 3
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"sym_full": up(_SYM_FULL.reshape(-1)),
            "sym_restr": up(_SYM_RESTR.reshape(-1)),
            "len": up(_LEN_TAB.reshape(5, 48)),
            "slot_stage": up(slot_stage), "slot_of": up(_slot_of())}


def _msb(mag: torch.Tensor) -> torch.Tensor:
    return _msb_index(mag).to(torch.int32)


def _bits_twoscomp(v: torch.Tensor) -> torch.Tensor:
    vi = v.to(torch.int64)
    mag_pos = torch.where(vi > 0, _msb(vi) + 1, 0)
    m = (-vi) & 0xFFFFFFFF                            # |v| for v<0 (mod 2^32)
    mag_neg = _msb(m) + 1
    pow2 = (m & (m - 1)) == 0
    return torch.where(vi >= 0, mag_pos + 1,
                       torch.where(pow2, mag_neg, mag_neg + 1))


def _select_q(bd_dc, bd_ac):
    half = 1 + (bd_ac + 1) // 2
    qp = torch.where(bd_dc <= 3, 0,
                     torch.where(bd_dc - half <= 1, bd_dc - 3,
                                 torch.where(bd_dc - half > 10, bd_dc - 10,
                                             half)))
    return qp.clamp(min=3)


def _option_field_bits(N):
    return torch.where(N <= 2, 1, torch.where(N <= 4, 2,
                                              torch.where(N <= 8, 3, 4)))


def _dpcm_section(vals, real, N, is_signed: bool, range_top, S: int):
    """Bit accounting of one DPCM/Rice gaggle section (encode_dpcm).

    vals: (B, Sp) int32 (padded), real: (Sp,) bool, N and range_top: (B,).
    Returns (section_bits (B,), per-block unit-end offsets (B, Sp)), both
    as if the section started at bit 0. For N == 1 the section is per-bit:
    block m's value ends at bit m+1.
    """
    B, Sp = vals.shape
    G = Sp // GAGGLE
    N = N.to(torch.int64)
    one = torch.ones_like(N)
    if is_signed:
        vmin, vmax = -(one << (N - 1)), (one << (N - 1)) - 1
    else:
        vmin, vmax = torch.zeros_like(N), range_top.to(torch.int64)
    vals = vals.to(torch.int64)
    prev = torch.cat([vals[:, :1], vals[:, :-1]], 1)
    theta = torch.minimum(prev - vmin[:, None], vmax[:, None] - prev)
    d = vals - prev
    mapped = torch.where((d >= 0) & (d <= theta), 2 * d,
                         torch.where((d < 0) & (d >= -theta), -2 * d - 1,
                                     theta + d.abs()))
    idx = torch.arange(Sp, dtype=torch.int64, device=vals.device)
    is_mapped = real & (idx >= 1)                      # index 0 is the ref
    mapped = torch.where(is_mapped, mapped, 0)

    Fb = _option_field_bits(N)
    kmax = torch.minimum(N - 2, (one << Fb) - 2)
    mg = mapped.reshape(B, G, GAGGLE)
    rg = is_mapped.reshape(G, GAGGLE)
    cnt = rg.sum(1)
    best = cnt * N[:, None]                            # uncoded
    for k in range(9):                                 # kmax <= 8 always
        ck = torch.where(rg, (mg >> k) + 1 + k, 0).sum(-1)
        best = torch.minimum(best, torch.where(k <= kmax[:, None], ck, _INF))
    # every gaggle in [0, ceil(S/16)) exists in the stream: F-bit option
    # field + codes; gaggle 0 adds the N-bit reference sample
    gbits = Fb[:, None] + best
    gbits[:, 0] += N
    gend = gbits.cumsum(1)
    per_block_end = gend[:, idx // GAGGLE]
    # N == 1: S uncoded bits, per-bit granularity
    n1 = (N == 1)
    per_block_end = torch.where(n1[:, None], idx + 1, per_block_end)
    section = torch.where(n1, S, gend[:, -1])
    return section, per_block_end.to(torch.int32)


def _pack_bits(open_: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """The word of the entries where ``open_`` holds, MSB first: bit = 1
    where ``new`` holds. (..., L) bools -> (...,) int32."""
    val = torch.zeros(open_.shape[:-1], dtype=torch.int32,
                      device=open_.device)
    for i in range(open_.shape[-1]):
        val = torch.where(open_[..., i], val * 2 + new[..., i], val)
    return val


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(-1, dtype=torch.int32)


def _layout(blocks: torch.Tensor) -> dict:
    """:func:`bpe_stream_layout` of (B, S, 64) blocks."""
    B, S = blocks.shape[0], blocks.shape[1]
    dev = blocks.device
    T = _tables(dev)
    Sp = ((S + GAGGLE - 1) // GAGGLE) * GAGGLE
    blk = blocks.to(torch.int32)
    if Sp != S:
        blk = F.pad(blk, (0, 0, 0, Sp - S))
    idx = torch.arange(Sp, dtype=torch.int32, device=dev)
    real = idx < S

    dc = blk[..., 0]                                   # (B, Sp)
    ac = blk[..., 1:]                                  # (B, Sp, 63)
    mag = ac.to(torch.int64).abs()
    msb = torch.where(mag > 0, _msb(mag), -1)          # (B, Sp, 63) int32

    fam = msb.reshape(B, Sp, 3, 21)
    msbP = fam[..., 0]                                 # (B, Sp, 3)
    child_msb = fam[..., 1:5]                          # (B, Sp, 3, 4)
    msbC = child_msb.amax(-1)
    gm = fam[..., 5:].reshape(B, Sp, 3, 4, 4)          # (.., family, group, 4)
    msbH = gm.amax(-1)                                 # (B, Sp, 3, 4)
    msbG = msbH.amax(-1)
    msbD = torch.maximum(msbC, msbG)
    msbB = msbD.amax(-1)                               # (B, Sp)
    dmax = torch.where(real, msb.amax(-1) + 1, 0)      # (B, Sp)

    bd_dc = torch.where(real, _bits_twoscomp(dc), 1).amax(-1).clamp(min=1)
    bd_ac = dmax.amax(-1)                              # (B,)
    q = _select_q(bd_dc, bd_ac)
    N = (bd_dc - q).clamp(min=1)
    qdc = torch.where(real, dc >> q[:, None], 0)

    # ---- DC section ----
    dc_bits, dc_end = _dpcm_section(qdc, real, N, True, None, S)
    # ---- additional DC planes ----
    n_add = (q - bd_ac.clamp(min=0)).clamp(min=0)
    add_start = dc_bits
    # ---- depth section ----
    Nd = torch.where(bd_ac > 0, _msb(bd_ac) + 1, 1)
    dpt_bits, _ = _dpcm_section(torch.where(real, dmax, 0), real, Nd, False,
                                bd_ac, S)
    dpt_bits = torch.where(bd_ac > 0, dpt_bits, 0)
    dpt_end = add_start + n_add * S + dpt_bits         # (B,) int64

    # ---- per-plane slot grid ----
    # slots per block: 0 parent word (stage 1); 1 tranB, 2 tranD,
    # 3..5 typesC (stage 2); 6 tranG, then per family f: 7+5f tranH,
    # 8+5f+j typesH (stage 3). 22 slots total.
    G = Sp // GAGGLE
    gidx = (idx // GAGGLE).to(torch.int64)
    slot = torch.arange(NSLOT, dtype=torch.int32, device=dev)
    # emission-order key per slot: stage-major, then block, then slot
    ordkey = (T["slot_stage"][None, :] * (Sp * NSLOT)
              + idx[:, None] * NSLOT + slot[None, :])  # (Sp, 22) int32

    plane_bits = torch.zeros((B, 32), dtype=torch.int64, device=dev)
    stage0_all = torch.zeros_like(plane_bits)
    words_tot_all = torch.zeros_like(plane_bits)
    plane_start = torch.zeros_like(plane_bits)
    s4_pos_all = torch.full((B, 32, Sp, 63), _INF, dtype=torch.int32,
                            device=dev)
    acq_end = torch.full((B, Sp, 63), _INF, dtype=torch.int32, device=dev)

    def grid(dtype):
        return torch.zeros((B, Sp, NSLOT), dtype=dtype, device=dev)

    above = dpt_end.clone()           # where the next plane down starts
    top = int(bd_ac.max()) if B else 0
    plane_start[:, top:] = above[:, None]
    for b in range(top - 1, -1, -1):
        live_p = b < bd_ac                            # (B,) plane is on
        live = (dmax > b) & real                      # (B, Sp)

        wlen, wval, nsign = grid(torch.int32), grid(torch.int32), \
            grid(torch.int32)
        restr, active, rawbit = grid(torch.bool), grid(torch.bool), \
            grid(torch.bool)

        def put(s, a, length, val, ns=None, rs=None, omitted=None):
            """Slot ``s``: active where ``a``; a word of ``length`` bits
            and value ``val`` unless ``omitted``; ``ns`` sign bits."""
            emits = a if omitted is None else a & ~omitted
            wlen[..., s] = torch.where(emits, length, 0)
            if val is not None:
                wval[..., s] = val
            if ns is not None:
                nsign[..., s] = torch.where(a, ns, 0)
            if rs is not None:
                restr[..., s] = rs
            active[..., s] = a
            rawbit[..., s] = emits & (length == 1)

        # slot 0: parents
        popen, pnew = msbP <= b, msbP == b
        plen = _count(popen)
        put(0, live & (plen >= 1), plen, _pack_bits(popen, pnew),
            ns=_count(pnew))

        bsig = live & (msbB >= b)
        # slot 1: tranB (raw bit, possibly forced-omitted)
        forcedB = (dmax - 1 == b) & ~pnew.any(-1)
        put(1, live & (msbB <= b) & ~forcedB, torch.ones_like(plen), None)

        # slot 2: tranD
        d_open, d_new = msbD <= b, msbD == b
        dlen = _count(d_open)
        drestr = (msbB == b) & ~(msbD > b).any(-1)
        put(2, bsig & (dlen >= 1) & ~((dlen == 1) & drestr), dlen,
            _pack_bits(d_open, d_new), rs=drestr)

        # slots 3..5: typesC per family
        copen, cnew = child_msb <= b, child_msb == b   # (B, Sp, 3, 4)
        clen = _count(copen)                           # (B, Sp, 3)
        cval = _pack_bits(copen, cnew)
        cns = _count(cnew)
        for f in range(3):
            put(3 + f, bsig & (msbD[..., f] >= b) & (clen[..., f] >= 1),
                clen[..., f], cval[..., f], ns=cns[..., f])

        # slot 6: tranG
        forcedG = d_new & ~cnew.any(-1) & ~(child_msb >= b).any(-1)
        g_in = (msbD >= b) & (msbG <= b) & ~forcedG
        glen = _count(g_in)
        put(6, bsig & (glen >= 1), glen, _pack_bits(g_in, msbG == b))

        g_known = (msbD >= b) & (msbG >= b)            # (B, Sp, 3)
        # slots 7+5f: tranH per family
        hopen, hnew = msbH <= b, msbH == b             # (B, Sp, 3, 4)
        hlen = _count(hopen)
        hval = _pack_bits(hopen, hnew)
        hrestr = (msbG == b) & ~(msbH > b).any(-1)
        # slots 8+5f+j: typesH per (family, group)
        topen, tnew = gm <= b, gm == b                 # (B, Sp, 3, 4, 4)
        tlen = _count(topen)                           # (B, Sp, 3, 4)
        tval = _pack_bits(topen, tnew)
        tns = _count(tnew)
        for f in range(3):
            known = bsig & g_known[..., f]
            put(7 + 5 * f, known & (hlen[..., f] >= 1)
                & ~((hlen[..., f] == 1) & hrestr[..., f]),
                hlen[..., f], hval[..., f], rs=hrestr[..., f])
            for j in range(4):
                trestr = hnew[..., f, j]
                tl = tlen[..., f, j]
                put(8 + 5 * f + j,
                    known & (msbH[..., f, j] >= b) & (tl >= 1), tl,
                    tval[..., f, j], ns=tns[..., f, j], rs=trestr,
                    omitted=(tl == 1) & trestr)

        # nothing emits on dead planes
        active &= live_p[:, None, None]
        wlen = torch.where(active, wlen, 0)
        nsign = torch.where(active, nsign, 0)

        # ---- option selection per (gaggle, class) ----
        wix = (wlen * 16 + wval).to(torch.int64)
        sym = torch.where(restr, T["sym_restr"][wix],
                          T["sym_full"][wix]).to(torch.int64)
        coded = active & (wlen >= 2)
        code_len = (rawbit & active).to(torch.int32)   # raw 1-bit words
        id_extra = grid(torch.int32)
        for L in (2, 3, 4):
            mk = coded & (wlen == L)
            mkg = mk.reshape(B, G, GAGGLE * NSLOT)
            best = mkg.sum(-1) * L                     # uncoded
            nopt = int(_NOPT[L])
            best_is = torch.full((B, G), 3, dtype=torch.int64, device=dev)
            for o in range(nopt - 1, -1, -1):
                # reverse order with <= : ties resolve to the lowest option
                # index; uncoded wins only on strict <
                lo = T["len"][L, o * 16:(o + 1) * 16][sym]
                co = torch.where(mk, lo, 0).reshape(B, G, -1).sum(-1)
                pick = co <= best
                best = torch.where(pick, co, best)
                best_is = torch.where(pick, o, best_is)
            sel = best_is[:, gidx]                     # (B, Sp)
            len_sel = torch.where(
                sel[..., None] >= nopt, L,
                T["len"][L][sel.clamp(0, 2)[..., None] * 16 + sym])
            code_len = torch.where(mk, len_sel, code_len)
            # ID field on the first coded word of the class per gaggle
            first = torch.where(mk, ordkey, _INF) \
                .reshape(B, G, GAGGLE * NSLOT).amin(-1)
            isf = mk & (ordkey == first[:, gidx][..., None])
            id_extra = id_extra + torch.where(isf, int(_IDB[L]), 0)

        unit_len = code_len + id_extra + nsign         # (B, Sp, 22)

        # ---- emission-order prefix sums ----
        ends = torch.cat([unit_len[..., 0],
                          unit_len[..., 1:6].reshape(B, -1),
                          unit_len[..., 6:].reshape(B, -1)], 1).cumsum(1)
        unit_end = torch.cat([ends[:, :Sp, None],
                              ends[:, Sp:6 * Sp].reshape(B, Sp, 5),
                              ends[:, 6 * Sp:].reshape(B, Sp, 16)], -1)
        words_total = ends[:, -1]

        # ---- stage 4 ----
        refmask = (msb > b) & (live_p[:, None] & real)[..., None]
        cnt4 = refmask.sum(-1)                         # (B, Sp) int64
        blk_off = cnt4.cumsum(1) - cnt4
        within = refmask.cumsum(-1) - 1
        s4_pos_all[:, b] = torch.where(refmask, blk_off[..., None] + within,
                                       _INF).to(torch.int32)

        stage0 = torch.where(live_p & (b < q), S, 0)
        stage0_all[:, b] = stage0
        words_tot_all[:, b] = torch.where(live_p, words_total, 0)
        plane_bits[:, b] = torch.where(
            live_p, stage0 + words_total + cnt4.sum(-1), 0)
        plane_start[:, b] = above

        # the unit that declares a coefficient at its MSB plane ends its
        # acquisition
        unit_abs = (above + stage0)[:, None, None] + unit_end
        acq_end = torch.where(msb == b,
                              unit_abs[..., T["slot_of"]].to(torch.int32),
                              acq_end)
        above = above + plane_bits[:, b]

    words_start = plane_start + stage0_all
    s4_start = words_start + words_tot_all
    total_bits = dpt_end + plane_bits.sum(-1)
    full_bytes = HDR_BYTES + (total_bits + 7) // 8

    return {
        "S": S,
        "mag": mag, "msb": msb, "neg": ac < 0,
        "qdc": qdc, "q": q, "bd_ac": bd_ac,
        "dc_orig": torch.where(real, dc, 0),
        "dc_end": dc_end,                              # (B, Sp)
        "add_start": add_start, "n_add": n_add,
        "dpt_end": dpt_end,
        "plane_start": plane_start, "s4_start": s4_start,
        "s4_pos": s4_pos_all,                          # (B, 32, Sp, 63)
        "acq_end": acq_end,                            # (B, Sp, 63)
        "total_bits": total_bits, "full_bytes": full_bytes,
        "real": real,
    }


def bpe_stream_layout(blocks: torch.Tensor) -> dict:
    """Budget-independent layout of (S, 64) or (B, S, 64) weighted integer
    blocks: everything :func:`bpe_decode_at` needs (per-coefficient
    acquisition ends, refinement positions, DC offsets, the full byte
    count). The block axis is padded to ``Sp = ceil(S/16)*16``; ``S`` is a
    Python int and ``real`` (Sp,) is shared by the bands."""
    if blocks.dim() == 3:
        return _layout(blocks)
    lay = _layout(blocks[None])
    return {k: (v[0] if isinstance(v, torch.Tensor) and k != "real" else v)
            for k, v in lay.items()}


def bpe_size_bytes(blocks: torch.Tensor) -> torch.Tensor:
    """Exact untruncated stream byte count per band, int64."""
    return bpe_stream_layout(blocks)["full_bytes"]


def _decode(layout: dict, budget_bytes):
    """:func:`bpe_decode_at` of a layout with a band axis."""
    msb, mag = layout["msb"], layout["mag"]
    dev = mag.device
    budget = torch.as_tensor(budget_bytes, device=dev).to(torch.int64)
    eff = budget.clamp(min=HDR_BYTES + 8)              # encoder's floor
    full = layout["full_bytes"]
    nbytes = torch.where(budget > 0, torch.minimum(full, eff), full)
    cut = torch.where(budget > 0, 8 * eff.clamp(max=1 << 27) - HDR_BITS,
                      _INF)

    B, Sp = layout["qdc"].shape
    S = layout["S"]
    q = layout["q"][:, None, None].to(torch.int64)     # (B, 1, 1)
    idx = torch.arange(Sp, dtype=torch.int64, device=dev)
    dc_orig = layout["dc_orig"].to(torch.int64)[:, None, :]   # (B, 1, Sp)

    # ---- DC ----
    got_dc = layout["dc_end"] <= cut                   # (B, Sp)
    dc = torch.where(got_dc, layout["qdc"].to(torch.int64) << q[:, 0], 0)
    dc_known = torch.where(got_dc, q[:, 0], 32)

    def dc_planes(dc, dc_known, ok, plane):
        """OR in the DC bits of ``plane`` (B, P, 1) received where ``ok``
        (B, P, Sp)."""
        pc = plane.clamp(min=0)
        bits = (dc_orig >> pc) & 1
        dc = dc | torch.where(ok, bits << pc, 0).sum(1)
        return dc, torch.minimum(dc_known,
                                 torch.where(ok, plane, 32).amin(1))

    # additional planes: bit (plane b = q-1-i, block m) at
    # add_start + i*S + m, received iff pos < cut
    iv = torch.arange(29, dtype=torch.int64, device=dev)[None, :, None]
    pos = layout["add_start"][:, None, None] + iv * S + idx
    ok = (iv < layout["n_add"][:, None, None]) & (pos < cut) & (idx < S)
    dc, dc_known = dc_planes(dc, dc_known, ok, q - 1 - iv)
    # stage-0 DC refinement: plane b < min(q, bd_ac), position
    # plane_start[b] + m
    b0 = torch.arange(32, dtype=torch.int64, device=dev)[None, :, None]
    pos = layout["plane_start"][:, :, None] + idx
    ok = (b0 < layout["bd_ac"][:, None, None]) & (b0 < q) & (pos < cut) \
        & (idx < S)
    dc, dc_known = dc_planes(dc, dc_known, ok, b0)

    dcv = torch.where(dc_known >= 32, 0,
                      torch.where(dc_known > 0,
                                  dc + (1 << (dc_known - 1).clamp(min=0)),
                                  dc))

    # ---- AC ----
    acq = (msb >= 0) & (layout["acq_end"] <= cut)      # (B, Sp, 63)
    msb_c = msb.clamp(0, 31).to(torch.int64)
    rec = torch.where(acq, 1 << msb_c, 0)
    known = msb_c
    s4_start = layout["s4_start"]
    for b in range(int(layout["bd_ac"].max()) if B else 0):
        # planes at or above bd_ac refine nothing (msb < bd_ac)
        inc = (b < msb) & (s4_start[:, b, None, None]
                           + layout["s4_pos"][:, b] < cut)
        rec = rec + torch.where(inc, mag & (1 << b), 0)
        known = torch.where(inc, known.clamp(max=b), known)
    m = rec + torch.where(acq & (known > 0), 1 << (known - 1).clamp(min=0), 0)
    acv = torch.where(acq, torch.where(layout["neg"], -m, m), 0)

    out = torch.cat([dcv[..., None], acv], -1)
    return _wrap_i32(out).to(torch.int32), nbytes


def bpe_decode_at(layout: dict, budget_bytes):
    """Evaluate one byte budget (an int or a scalar tensor; <= 0 means
    unbounded): returns ((Sp, 64) or (B, Sp, 64) int32 reconstructed
    weighted blocks, gaggle-PADDED, slice [:S] yourself, midpoint-filled
    exactly like the native decoder; the exact encoded byte count, int64)."""
    if layout["qdc"].dim() == 2:
        return _decode(layout, budget_bytes)
    lay = {k: (v[None] if isinstance(v, torch.Tensor) and k != "real" else v)
           for k, v in layout.items()}
    out, nbytes = _decode(lay, budget_bytes)
    return out[0], nbytes[0]


def bpe_truncated_decode(blocks: torch.Tensor, budget_bytes):
    """Model decode(encode(blocks, budget)) per band."""
    return bpe_decode_at(bpe_stream_layout(blocks), budget_bytes)
