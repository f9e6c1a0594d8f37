// Embedded bit-plane coder for wavelet coefficients (group-significance
// coding, EZW/SPECK-family). Shared entropy backend of tpukit's transform
// codecs:
//   * j2k     — reversible 5/3 (lossless) or quantized 9/7 (quality mode)
//   * ccsds122 — integer 9/7M with per-band bpp-targeted truncation
//
// The stream is *embedded*: truncating it at any byte yields a valid
// lower-rate reconstruction (decoder mid-point fills unseen planes), which
// is what gives the CCSDS-122-style `-r {bpp}` rate control surface
// (reference tools/codecs/ccsds122/ccsds122_wrap.py:110-121) a principled
// in-framework implementation.
//
// Layout: [u8 0x40|nplanes][bit stream MSB-first] (bit 6 of the header
// byte is a format-version marker; see unit layout below). Coefficients
// arrive in the caller's scan order (coarse subbands first for best
// embedded quality). Per plane p (MSB first), in group order (16
// coefficients per group):
//   * a group whose max magnitude has its MSB below p emits one 0 gate bit;
//   * the plane where the max's MSB == p emits a 1 gate bit followed by the
//     group's first significance unit;
//   * an already-active group emits a significance unit per plane:
//     one "becomes significant at p" bit per still-insignificant member
//     (in member order), then one sign bit per newly significant member
//     (in the same order) — sig bits first, THEN signs, so both directions
//     move whole units through the bit window branchlessly;
//   * after all groups, one refinement bit per previously-significant
//     coefficient in significance-acquisition order.
// The total bit count is identical member-for-member to the interleaved
// hit/sign layout, so the exact on-device size model
// (codecs/bitplane_model.py) is layout-independent.
//
// Throughput design (the hot significance passes on both sides):
//   * per-plane ELIGIBLE-GROUP lists — groups are bucketed by their max
//     member's MSB plane at setup; each plane visits only groups that have
//     activated (merge of the surviving list with this plane's bucket),
//     (fully-significant groups stay listed — the inactive-gap accounting
//    counts every unlisted group as one gate bit, so they must pass
//    through at zero bits, not fall into the gap). Inactive groups'
//     gate zeros are accounted as bulk zero runs (encoder: put_zeros
//     memset; decoder: 64-bit window CLZ scans that only pay per
//     *activation*, not per group).
//   * branchless unit coding — "becomes significant" member bits come from
//     one SSE2 compare + movemask against the per-member MSB lanes,
//     compressed over the still-insignificant mask with PEXT and emitted
//     as one put_bits; signs are PEXT-gathered from a per-group sign mask
//     computed at setup. The decoder reads whole units from the bit
//     window and PDEP-expands them back onto member positions.
//   * newly significant magnitudes append to the dense refinement array
//     with one AVX-512 compress-store per unit.
//   * refinement passes are linear over the dense magnitude array and
//     move 16 bits (AVX-512 mask ops) per step on both sides.
//   * decoder bookkeeping for still-insignificant members is skipped
//     entirely (they reconstruct to 0 regardless), and truncation midpoint
//     planes are recovered from three scalars (lowest fully-refined plane,
//     partial-plane cursor) + per-entry acquisition planes instead of a
//     per-coefficient "known plane" array.
// Truncated-stream semantics: significance units are atomic — a unit the
// budget cut mid-way contributes nothing (the decoder restores its state
// and stops), refinement bits apply bit-by-bit up to the cut.

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>
#if defined(__SSE2__) || defined(__AVX2__) || defined(__AVX512F__)
#include <immintrin.h>
#endif
#include "bitio.hpp"

using namespace tpukit;

namespace {
constexpr int GROUP = 16;
constexpr uint8_t FMT_MARK = 0x40;   // header-byte format-version bit

inline int msb_index(uint32_t v) {  // -1 for 0
    return v ? 31 - __builtin_clz(v) : -1;
}

// 8-bit reverse LUT (the stream wants member 0 most-significant; PEXT/
// movemask pack member 0 into bit 0)
struct Rev8 {
    uint8_t t[256];
    Rev8() {
        for (int i = 0; i < 256; ++i) {
            uint8_t r = 0;
            for (int b = 0; b < 8; ++b) r |= ((i >> b) & 1) << (7 - b);
            t[i] = r;
        }
    }
};
const Rev8 REV8;

inline uint32_t rev16(uint32_t x) {  // bit-reverse the low 16 bits
    return ((uint32_t)REV8.t[x & 0xFF] << 8) | REV8.t[(x >> 8) & 0xFF];
}

// reverse the low nb (<=16) bits: LSB-first member order <-> MSB-first
// stream order (an involution)
inline uint32_t revn(uint32_t x, int nb) { return rev16(x) >> (16 - nb); }

inline uint32_t pext32(uint32_t v, uint32_t m) {
#ifdef __BMI2__
    return _pext_u32(v, m);
#else
    uint32_t r = 0;
    int k = 0;
    while (m) {
        int j = __builtin_ctz(m);
        m &= m - 1;
        r |= ((v >> j) & 1u) << k;
        ++k;
    }
    return r;
#endif
}

inline uint32_t pdep32(uint32_t v, uint32_t m) {
#ifdef __BMI2__
    return _pdep_u32(v, m);
#else
    uint32_t r = 0;
    int k = 0;
    while (m) {
        int j = __builtin_ctz(m);
        m &= m - 1;
        r |= ((v >> k) & 1u) << j;
        ++k;
    }
    return r;
#endif
}
}

static int64_t encode_body(const int32_t* coef, int64_t n, uint8_t* out,
                           int64_t out_cap, int64_t max_bytes) {
    if (n <= 0 || out_cap < 2) return -1;
    int64_t ngroups = (n + GROUP - 1) / GROUP;
    // magnitudes padded to whole groups so unit-width vector loads are safe
    std::vector<uint32_t> mag((size_t)ngroups * GROUP, 0);
    std::vector<int8_t> topg((size_t)ngroups);       // msb plane per group
    std::vector<uint16_t> rem((size_t)ngroups);      // insignificant members
    std::vector<uint16_t> sgn((size_t)ngroups);      // sign bit per member
    // per-member MSB planes, one 16-byte lane per group (pad = -1)
    std::vector<int8_t> msb8((size_t)ngroups * GROUP, -1);
    uint32_t maxmag = 0;
    int64_t g0 = 0;
#if defined(__AVX512F__) && defined(__AVX512CD__)
    // fused setup: one 16-lane pass per group computes |coef|, the sign
    // mask, the per-member MSB planes (31 - lzcnt; -1 for zero), the group
    // max, and the running magnitude max
    {
        __m512i maxv = _mm512_setzero_si512();
        const __m512i c31 = _mm512_set1_epi32(31);
        const __m512i zero = _mm512_setzero_si512();
        int64_t gfull = n / GROUP;
        for (; g0 < gfull; ++g0) {
            const int64_t lo = g0 * GROUP;
            __m512i v = _mm512_loadu_si512((const void*)(coef + lo));
            __m512i m = _mm512_abs_epi32(v);
            _mm512_storeu_si512((void*)&mag[(size_t)lo], m);
            sgn[g0] = (uint16_t)_mm512_cmplt_epi32_mask(v, zero);
            maxv = _mm512_max_epu32(maxv, m);
            __m512i msb = _mm512_sub_epi32(c31, _mm512_lzcnt_epi32(m));
            _mm_storeu_si128((__m128i*)&msb8[(size_t)lo],
                             _mm512_cvtepi32_epi8(msb));
            topg[g0] = (int8_t)_mm512_reduce_max_epi32(msb);
            rem[g0] = 0xFFFF;
        }
        maxmag = _mm512_reduce_max_epu32(maxv);
    }
#endif
    for (int64_t g = g0; g < ngroups; ++g) {
        int64_t lo = g * GROUP, hi = lo + GROUP < n ? lo + GROUP : n;
        int t = -1;
        uint16_t sg = 0;
        for (int64_t i = lo; i < hi; ++i) {
            uint32_t m = (uint32_t)(coef[i] < 0 ? -(int64_t)coef[i]
                                                : coef[i]);
            mag[(size_t)i] = m;
            sg |= (uint16_t)((coef[i] < 0) ? (1u << (i - lo)) : 0u);
            if (m > maxmag) maxmag = m;
            int c = msb_index(m);
            msb8[(size_t)(g * GROUP + (i - lo))] = (int8_t)c;
            t = c > t ? c : t;
        }
        topg[g] = (int8_t)t;
        sgn[g] = sg;
        rem[g] = (uint16_t)((hi - lo == GROUP) ? 0xFFFF
                                               : ((1u << (hi - lo)) - 1u));
    }
    int nplanes = msb_index(maxmag) + 1;
    out[0] = (uint8_t)(FMT_MARK | nplanes);

    // bucket groups by activation plane (counting sort; ascending g within
    // each bucket). topg == -1 groups never activate.
    std::vector<int32_t> byplane((size_t)ngroups);
    int64_t cnt[33] = {0};
    for (int64_t g = 0; g < ngroups; ++g)
        if (topg[g] >= 0) ++cnt[topg[g]];
    int64_t start[34];
    start[0] = 0;
    for (int i = 0; i < 33; ++i) start[i + 1] = start[i] + cnt[i];
    {
        int64_t pos[33];
        std::memcpy(pos, start, sizeof(pos));
        for (int64_t g = 0; g < ngroups; ++g)
            if (topg[g] >= 0) byplane[(size_t)pos[topg[g]]++] = (int32_t)g;
    }
    // eligible lists (ping-pong): groups that are active AND still have
    // insignificant members, ascending group id
    std::vector<int32_t> elig_a((size_t)ngroups), elig_b((size_t)ngroups);
    int32_t* elig = elig_a.data();
    int32_t* elig_nxt = elig_b.data();
    int64_t nelig = 0;

    int64_t budget = max_bytes > 0 ? (max_bytes < out_cap ? max_bytes : out_cap)
                                   : out_cap;
    BitWriter bw(out + 1, budget - 1);   // put_zeros memsets its own runs
    // significant magnitudes, dense, in acquisition order (refinement
    // source — no index gather in the hot loop); uninitialized upper-bound
    // buffer + cursor, same as the decoder
    std::unique_ptr<uint32_t[]> sig_mag_v(new uint32_t[(size_t)n]);
    uint32_t* sig_mag = sig_mag_v.get();
    size_t n_sig = 0;

    for (int p = nplanes - 1; p >= 0 && !bw.overflow; --p) {
        size_t n_sig_before = n_sig;
#ifdef __SSE2__
        const __m128i pv = _mm_set1_epi8((char)p);
#endif
        // significance pass: merge the surviving eligible list with this
        // plane's activation bucket; groups outside both are 1-bit zeros
        const int32_t* addv = byplane.data() + start[p];
        const int64_t nadd = cnt[p];
        int64_t ia = 0, ib = 0, nout = 0;
        int64_t zrun = 0, prev = -1;
        while ((ia < nelig || ib < nadd) && !bw.overflow) {
            int64_t g;
            bool fresh;
            if (ib >= nadd || (ia < nelig && elig[ia] < addv[ib])) {
                g = elig[ia++];
                fresh = false;
            } else {
                g = addv[ib++];
                fresh = true;
            }
            zrun += g - prev - 1;
            prev = g;
            const uint16_t mask = rem[g];
#ifdef __SSE2__
            const __m128i mv = _mm_loadu_si128(
                (const __m128i*)&msb8[(size_t)g * GROUP]);
            const uint32_t hit =
                (uint32_t)_mm_movemask_epi8(_mm_cmpeq_epi8(mv, pv)) & mask;
#else
            uint32_t hit = 0;
            for (int j = 0; j < GROUP; ++j)
                hit |= (uint32_t)(msb8[(size_t)g * GROUP + j] == (int8_t)p)
                       << j;
            hit &= mask;
#endif
            if (!fresh && hit == 0) {
                // active group: nothing becomes significant on this plane
                // (fully-significant groups pass through at zero bits —
                // they must stay OUT of the inactive gap accounting)
                zrun += __builtin_popcount(mask);
                elig_nxt[nout++] = (int32_t)g;
                continue;
            }
            // fresh => the max member hits exactly at topg, so hit != 0
            if (zrun) { bw.put_zeros(zrun); zrun = 0; }
            if (bw.overflow) break;
            const int nb = __builtin_popcount(mask);
            const int nh = __builtin_popcount(hit);
            uint64_t acc = fresh ? 1u : 0u;
            acc = (acc << nb) | revn(pext32(hit, mask), nb);
            acc = (acc << nh) | revn(pext32(sgn[g], hit), nh);
            bw.put_bits(acc, (fresh ? 1 : 0) + nb + nh);   // <= 33 bits
            if (bw.overflow) break;
            rem[g] = (uint16_t)(mask & ~hit);
#if defined(__AVX512F__)
            _mm512_mask_compressstoreu_epi32(
                sig_mag + n_sig, (__mmask16)hit,
                _mm512_loadu_si512((const void*)&mag[(size_t)g * GROUP]));
            n_sig += (size_t)nh;
#else
            for (uint32_t hh = hit; hh; hh &= hh - 1)
                sig_mag[n_sig++] = mag[(size_t)(g * GROUP +
                                                __builtin_ctz(hh))];
#endif
            elig_nxt[nout++] = (int32_t)g;
        }
        zrun += ngroups - 1 - prev;
        if (zrun && !bw.overflow) bw.put_zeros(zrun);
        std::swap(elig, elig_nxt);
        nelig = nout;
        // refinement pass: previously-significant only, acquisition order,
        // SIMD-extracted bits from the dense magnitude array
        {
            const uint32_t* sm = sig_mag;
            size_t s = 0;
#if defined(__AVX512F__)
            {
                const __m512i bp512 = _mm512_set1_epi32((int)(1u << p));
                while (s + 48 <= n_sig_before && !bw.overflow) {
                    uint64_t acc = 0;
                    for (int k = 0; k < 3; ++k) {
                        __m512i v = _mm512_loadu_si512(
                            (const void*)(sm + s + (size_t)k * 16));
                        uint32_t mk = (uint32_t)_mm512_test_epi32_mask(
                            v, bp512);
                        acc = (acc << 16) | rev16(mk);
                    }
                    bw.put_bits(acc, 48);
                    s += 48;
                }
            }
#elif defined(__AVX2__)
            const int sh = 31 - p;
            while (s + 48 <= n_sig_before && !bw.overflow) {
                uint64_t acc = 0;
                for (int k = 0; k < 6; ++k) {
                    __m256i v = _mm256_loadu_si256(
                        (const __m256i*)(sm + s + (size_t)k * 8));
                    uint32_t m8 = (uint32_t)_mm256_movemask_ps(
                        _mm256_castsi256_ps(_mm256_slli_epi32(v, sh)));
                    acc = (acc << 8) | REV8.t[m8];
                }
                bw.put_bits(acc, 48);
                s += 48;
            }
#endif
            uint64_t acc = 0;
            int nb = 0;
            for (; s < n_sig_before && !bw.overflow; ++s) {
                acc = (acc << 1) | ((sm[s] >> p) & 1u);
                if (++nb == 48) { bw.put_bits(acc, nb); acc = 0; nb = 0; }
            }
            if (nb) bw.put_bits(acc, nb);
        }
    }
    return 1 + bw.bytes();
}

extern "C" int64_t bpc_encode(const int32_t* coef, int64_t n, uint8_t* out,
                              int64_t out_cap, int64_t max_bytes) {
    return encode_body(coef, n, out, out_cap, max_bytes);
}

// Fused deadzone quantize + encode: qc[i] = (int32)(coefs[i] *
// (inv_steps[i] * inv_base)), the exact operation (and association order,
// hence rounding) of the host numpy path and the device requantizer
// (j2k_codec._device_requant_recon_ladder) — then the regular embedded
// coder over qc. Saves a full numpy pass + temporaries per rate point;
// the quantized coefficients land in caller-provided qc for round-trip
// verification and checksums.
extern "C" int64_t bpc_encode_quant(const float* coefs,
                                    const float* inv_steps, float inv_base,
                                    int32_t* qc, int64_t n, uint8_t* out,
                                    int64_t out_cap, int64_t max_bytes,
                                    uint32_t* sums_out) {
    // sums_out (nullable): {sum(qc), sum(qc*qc)} mod 2^32, accumulated in
    // the quantize pass — the caller's coefficient checksums (against the
    // device requantizer) then cost no extra O(n) host passes.
    int64_t i = 0;
    uint32_t s1 = 0, s2 = 0;
#ifdef __AVX2__
    const __m256 ib = _mm256_set1_ps(inv_base);
    __m256i a1 = _mm256_setzero_si256(), a2 = _mm256_setzero_si256();
    for (; i + 8 <= n; i += 8) {
        __m256 s = _mm256_mul_ps(_mm256_loadu_ps(inv_steps + i), ib);
        __m256 c = _mm256_mul_ps(_mm256_loadu_ps(coefs + i), s);
        __m256i q = _mm256_cvttps_epi32(c);
        _mm256_storeu_si256((__m256i*)(qc + i), q);
        a1 = _mm256_add_epi32(a1, q);
        a2 = _mm256_add_epi32(a2, _mm256_mullo_epi32(q, q));
    }
    {
        // lane-sum mod 2^32 == total mod 2^32 (32-bit adds wrap)
        alignas(32) uint32_t t1[8], t2[8];
        _mm256_storeu_si256((__m256i*)t1, a1);
        _mm256_storeu_si256((__m256i*)t2, a2);
        for (int j = 0; j < 8; ++j) { s1 += t1[j]; s2 += t2[j]; }
    }
#endif
    for (; i < n; ++i) {
        float s = inv_steps[i] * inv_base;
        int32_t q = (int32_t)(coefs[i] * s);
        qc[i] = q;
        s1 += (uint32_t)q;
        s2 += (uint32_t)q * (uint32_t)q;
    }
    if (sums_out) { sums_out[0] = s1; sums_out[1] = s2; }
    return encode_body(qc, n, out, out_cap, max_bytes);
}

extern "C" int64_t bpc_decode(const uint8_t* in, int64_t nbytes, int32_t* coef,
                              int64_t n) {
    if (nbytes < 1 || n <= 0) return -1;
    // format-version marker + <= 32 planes (int32 magnitudes); anything
    // else is a foreign/corrupt stream
    if (!(in[0] & FMT_MARK) || (in[0] & ~FMT_MARK & 0x80)) return -2;
    int nplanes = in[0] & 0x3F;
    if (nplanes > 32) return -2;
    BitReader br(in + 1, nbytes - 1);
    int64_t ngroups = (n + GROUP - 1) / GROUP;
    std::vector<uint16_t> rem((size_t)ngroups);
    // dense significant-entry state, acquisition order; preallocated
    // (uninitialized) at the n upper bound so the hot loops append with a
    // bare cursor — no push_back capacity branches, no zero-fill pass.
    // posneg carries the sign in bit 0.
    std::unique_ptr<uint32_t[]> sig_mag_v(new uint32_t[(size_t)n]);
    std::unique_ptr<int64_t[]> sig_posneg_v(new int64_t[(size_t)n]);
    std::unique_ptr<int8_t[]> sig_pa_v(new int8_t[(size_t)n]);
    uint32_t* sig_mag = sig_mag_v.get();
    int64_t* sig_posneg = sig_posneg_v.get();
    int8_t* sig_pa = sig_pa_v.get();
    size_t nsig = 0;
    for (int64_t g = 0; g < ngroups; ++g) {
        int64_t lo = g * GROUP, hi = lo + GROUP < n ? lo + GROUP : n;
        rem[g] = (uint16_t)((hi - lo == GROUP) ? 0xFFFF
                                               : ((1u << (hi - lo)) - 1u));
    }
    // active lists (ping-pong), ascending group id: activated groups that
    // still have insignificant members
    std::vector<int32_t> act_a((size_t)ngroups), act_b((size_t)ngroups);
    int32_t* act = act_a.data();
    int32_t* act_nxt = act_b.data();
    int64_t nact = 0;
    // truncation midpoint bookkeeping: the lowest plane whose refinement
    // pass completed, and the cursor of the one partially-completed pass
    int p_done_ref = nplanes;
    int p_part = -1;
    size_t s_part = 0;

    for (int p = nplanes - 1; p >= 0 && !br.error; --p) {
        size_t n_sig_before = nsig;
        int64_t nout = 0;
        const uint32_t bitp = 1u << p;
        // one significance unit: `fresh` groups (just activated) parse all
        // members, active ones parse the still-insignificant mask. Atomic:
        // on budget exhaustion mid-unit the reader state is restored and
        // nothing is incorporated.
        auto parse_unit = [&](int64_t g) -> bool {
            const uint16_t mask = rem[g];
            const int nb = __builtin_popcount(mask);
            br.refill();
            if (br.avail < nb) { br.error = true; return false; }
            const uint32_t hit = nb ? pdep32(
                revn((uint32_t)(br.window >> (64 - nb)) &
                         ((1u << nb) - 1u), nb), mask)
                                    : 0u;
            const int nh = __builtin_popcount(hit);
            if (br.avail < nb + nh) { br.error = true; return false; }
            uint64_t w = br.window << nb;
            const uint32_t sgn = nh ? pdep32(
                revn((uint32_t)(w >> (64 - nh)) & ((1u << nh) - 1u), nh),
                hit)
                                    : 0u;
            br.window = w << nh;
            br.avail -= nb + nh;
            rem[g] = (uint16_t)(mask & ~hit);
            const int64_t lo = g * GROUP;
            if (nh) {
                std::memset(sig_pa + nsig, p, (size_t)nh);
                size_t k = nsig;
                for (uint32_t hh = hit; hh; hh &= hh - 1, ++k) {
                    int j = __builtin_ctz(hh);
                    sig_mag[k] = bitp;
                    sig_posneg[k] = ((lo + j) << 1) |
                                    (int64_t)((sgn >> j) & 1u);
                }
                nsig += (size_t)nh;
            }
            return true;
        };
        // scan the gate bits of groups [gfrom, gto): zeros in bulk via
        // CLZ, each 1 activates that group and parses its first unit
        auto scan_gap = [&](int64_t gfrom, int64_t gto) {
            int64_t remaining = gto - gfrom;
            while (remaining > 0 && !br.error) {
                br.refill();
                if (br.avail == 0) { br.error = true; return; }
                int take = br.avail < remaining ? br.avail : (int)remaining;
                uint64_t w = br.window;
                if ((take == 64 ? w : (w >> (64 - take))) == 0) {
                    // all `take` gate bits are zero
                    br.window = take == 64 ? 0 : (w << take);
                    br.avail -= take;
                    gfrom += take;
                    remaining -= take;
                    continue;
                }
                int z = __builtin_clzll(w);   // w != 0 within `take` bits
                // z zeros, then an activation at group gfrom + z
                // (z+1 < 64 since avail is capped at 63, but guard the UB)
                br.window = (z + 1 >= 64) ? 0 : (w << (z + 1));
                br.avail -= z + 1;
                int64_t g = gfrom + z;
                gfrom = g + 1;
                remaining -= z + 1;
                if (!parse_unit(g)) return;
                act_nxt[nout++] = (int32_t)g;
            }
        };
        int64_t gcur = 0;
        for (int64_t ia = 0; ia < nact && !br.error; ++ia) {
            const int64_t a = act[ia];
            if (a > gcur) scan_gap(gcur, a);
            if (br.error) break;
            // active group: peek the still-insignificant members' bits; a
            // zero unit is the common case and consumes nb bits flat
            const uint16_t mask = rem[a];
            const int nb = __builtin_popcount(mask);
            if (nb == 0) {          // fully significant: zero bits, stays
                act_nxt[nout++] = (int32_t)a;
                gcur = a + 1;
                continue;
            }
            br.refill();
            if (br.avail < nb) { br.error = true; break; }
            if ((br.window >> (64 - nb)) == 0) {
                br.window <<= nb;
                br.avail -= nb;
                act_nxt[nout++] = (int32_t)a;
            } else {
                if (!parse_unit(a)) break;
                act_nxt[nout++] = (int32_t)a;
            }
            gcur = a + 1;
        }
        if (!br.error && gcur < ngroups) scan_gap(gcur, ngroups);
        std::swap(act, act_nxt);
        nact = nout;
        // refinement pass: linear over the dense magnitudes, SIMD-applied
        // 16 bits per step where the window allows
        uint32_t* sm = sig_mag;
#if defined(__AVX512F__)
        const __m512i bitp512 = _mm512_set1_epi32((int)bitp);
#endif
#ifdef __AVX2__
        const __m256i sel = _mm256_setr_epi32(0x80, 0x40, 0x20, 0x10,
                                              8, 4, 2, 1);
        const __m256i bitpv = _mm256_set1_epi32((int)bitp);
#endif
        size_t s = 0;
        while (s < n_sig_before && !br.error) {
            br.refill();
            int take = br.avail < 48 ? br.avail : 48;
            size_t left = n_sig_before - s;
            if ((size_t)take > left) take = (int)left;
            if (take >= 8 || (size_t)take == left) {
                uint64_t w = br.window;
                int t = 0;
#if defined(__AVX512F__)
                for (; t + 16 <= take; t += 16, s += 16) {
                    __mmask16 k = (__mmask16)rev16((uint32_t)(w >> 48));
                    w <<= 16;
                    __m512i cur = _mm512_loadu_si512((void*)(sm + s));
                    _mm512_storeu_si512(
                        (void*)(sm + s),
                        _mm512_mask_or_epi32(cur, k, cur, bitp512));
                }
#endif
#ifdef __AVX2__
                for (; t + 8 <= take; t += 8, s += 8) {
                    __m256i bits = _mm256_set1_epi32((int)(w >> 56));
                    w <<= 8;
                    __m256i on = _mm256_cmpeq_epi32(
                        _mm256_and_si256(bits, sel), sel);
                    __m256i cur = _mm256_loadu_si256((__m256i*)(sm + s));
                    _mm256_storeu_si256(
                        (__m256i*)(sm + s),
                        _mm256_or_si256(cur, _mm256_and_si256(on, bitpv)));
                }
#endif
                for (; t < take; ++t, ++s) {
                    if (w >> 63) sm[s] |= bitp;
                    w <<= 1;
                }
                br.window = w;
                br.avail -= take;
                if (take == 0) { br.error = true; break; }
            } else {
                int b = (int)br.get_bits(1);
                if (br.error) break;
                if (b) sm[s] |= bitp;
                ++s;
            }
        }
        if (!br.error) {
            p_done_ref = p;
        } else if (s > 0 || n_sig_before > 0) {
            p_part = p;
            s_part = s;
        }
    }

    // scatter: insignificant coefficients are 0; significant ones get the
    // truncation midpoint of their last-incorporated plane (known):
    //   known(s) = p_part        if the partial pass reached s
    //            = p_done_ref    if s existed before that pass (pa > done)
    //            = pa(s)         otherwise (acquired at/after the lowest
    //                            completed refinement plane)
    std::memset(coef, 0, (size_t)n * sizeof(int32_t));
    for (size_t s = 0; s < nsig; ++s) {
        uint32_t m = sig_mag[s];
        int known;
        if (p_part >= 0 && s < s_part) {
            known = p_part;
        } else {
            int pa = sig_pa[s];
            known = pa > p_done_ref ? p_done_ref : pa;
        }
        if (known > 0) m += 1u << (known - 1);
        int64_t pn = sig_posneg[s];
        coef[pn >> 1] = (pn & 1) ? -(int32_t)m : (int32_t)m;
    }
    return n;
}
