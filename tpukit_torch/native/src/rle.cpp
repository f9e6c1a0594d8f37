// wrle: sparse run-length + magnitude Rice backend for the wenc container
// (tpukit's own per-band wavelet-coefficient format — the reference's J2K
// engine is an external binary, reference tools/codecs/j2k/j2k_wrap.py, so
// the lossy bitstream format is tpukit's to define).
//
// Motivation (measured, docs/SCALING.md §7c): at low rates (<1.5 bpp) the
// quantized DWT coefficient planes are sparse (nnz < 20%), and the
// block-adaptive Rice backend spends 1.2-2.6x the order-0 entropy on them
// (zero-block/2nd-extension runs amortize poorly at extreme sparsity).
// Coding (gap, magnitude, sign) triples per nonzero with per-segment
// optimal Rice parameters lands within a few % of the order-0 entropy.
//
// Stream layout (bit-packed MSB-first; the 0x20 marker byte is added by
// the Python wrapper, mirroring the Rice backend's header convention):
//   per segment (segments = subbands in scan order, passed out-of-band):
//     nnz    : w bits, w = bit_length(seglen)   (holds 0..seglen)
//     if nnz > 0:
//       kbyte: 8 bits, (k_gap << 4) | k_mag     (k in 0..15)
//       per nonzero, in scan order:
//         gap : FS(gap >> k_gap) + k_gap low bits   (zeros since prev nz)
//         mag : FS(m >> k_mag)  + k_mag low bits    (m = |v| - 1)
//         sign: 1 bit (1 = negative)
//
// k_gap/k_mag minimize the exact bit count (ties -> smallest k), the same
// argmin the device size model computes (wavelet_common.rle_size_bytes_model)
// so model and coder agree byte-for-byte.

#include "bitio.hpp"
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// smallest w with 2^w > len (python: int.bit_length(len))
static inline int nnz_width(int64_t len) {
    int w = 0;
    while ((1LL << w) <= len) ++w;
    return w;
}

struct SegPlan {
    int64_t nnz = 0;
    int kg = 0, km = 0;
    uint64_t bits = 0;
};

static SegPlan plan_segment(const int32_t* q, int64_t len,
                            std::vector<uint32_t>& gaps,
                            std::vector<uint32_t>& mags,
                            std::vector<uint8_t>& signs) {
    gaps.clear(); mags.clear(); signs.clear();
    int64_t prev = -1;
    for (int64_t i = 0; i < len; ++i) {
        int32_t v = q[i];
        if (v == 0) continue;
        gaps.push_back((uint32_t)(i - prev - 1));
        prev = i;
        int64_t av = v < 0 ? -(int64_t)v : (int64_t)v;  // |INT32_MIN| exact
        mags.push_back((uint32_t)(av - 1));
        signs.push_back(v < 0 ? 1 : 0);
    }
    SegPlan p;
    p.nnz = (int64_t)gaps.size();
    p.bits = (uint64_t)nnz_width(len);
    if (!p.nnz) return p;
    uint64_t best_g = ~0ull, best_m = ~0ull;
    for (int k = 0; k < 16; ++k) {
        uint64_t cg = 0, cm = 0;
        for (uint32_t g : gaps) cg += g >> k;
        for (uint32_t m : mags) cm += m >> k;
        cg += (uint64_t)p.nnz * (uint64_t)(k + 1);
        cm += (uint64_t)p.nnz * (uint64_t)(k + 1);
        if (cg < best_g) { best_g = cg; p.kg = k; }
        if (cm < best_m) { best_m = cm; p.km = k; }
    }
    p.bits += 8 + best_g + best_m + (uint64_t)p.nnz;  // kbyte + codes + signs
    return p;
}

}  // namespace

extern "C" {

// exact payload bit count (marker byte NOT included); <0 on bad args
int64_t wrle_size_bits(const int32_t* qc, int64_t n,
                       const int64_t* segs, int32_t nsegs) {
    if (n < 0 || nsegs <= 0) return -2;
    std::vector<uint32_t> gaps, mags;
    std::vector<uint8_t> signs;
    uint64_t total = 0;
    int64_t off = 0;
    for (int32_t s = 0; s < nsegs; ++s) {
        int64_t len = segs[s];
        if (len < 0 || off + len > n) return -2;
        total += plan_segment(qc + off, len, gaps, mags, signs).bits;
        off += len;
    }
    if (off != n) return -2;
    return (int64_t)total;
}

// payload bytes written (marker byte NOT included); -1 overflow, -2 bad args
int64_t wrle_encode(const int32_t* qc, int64_t n,
                    const int64_t* segs, int32_t nsegs,
                    uint8_t* out, int64_t cap) {
    if (n < 0 || nsegs <= 0) return -2;
    tpukit::BitWriter bw(out, cap);
    std::vector<uint32_t> gaps, mags;
    std::vector<uint8_t> signs;
    int64_t off = 0;
    for (int32_t s = 0; s < nsegs; ++s) {
        int64_t len = segs[s];
        if (len < 0 || off + len > n) return -2;
        SegPlan p = plan_segment(qc + off, len, gaps, mags, signs);
        bw.put_bits((uint64_t)p.nnz, nnz_width(len));
        if (p.nnz) {
            bw.put_bits(((uint64_t)p.kg << 4) | (uint64_t)p.km, 8);
            const uint32_t gm = p.kg ? (1u << p.kg) - 1u : 0u;
            const uint32_t mm = p.km ? (1u << p.km) - 1u : 0u;
            for (int64_t i = 0; i < p.nnz; ++i) {
                bw.put_fs(gaps[i] >> p.kg);
                if (p.kg) bw.put_bits(gaps[i] & gm, p.kg);
                bw.put_fs(mags[i] >> p.km);
                if (p.km) bw.put_bits(mags[i] & mm, p.km);
                bw.put_bits(signs[i], 1);
            }
        }
        off += len;
    }
    if (off != n) return -2;
    int64_t nb = bw.bytes();
    return bw.overflow ? -1 : nb;
}

// n on success; -2 bad args, -3 malformed stream
int64_t wrle_decode(const uint8_t* in, int64_t nbytes,
                    const int64_t* segs, int32_t nsegs,
                    int32_t* out, int64_t n) {
    if (n < 0 || nsegs <= 0 || nbytes < 0) return -2;
    std::memset(out, 0, (size_t)n * sizeof(int32_t));
    tpukit::BitReader br(in, nbytes);
    int64_t off = 0;
    for (int32_t s = 0; s < nsegs; ++s) {
        int64_t len = segs[s];
        if (len < 0 || off + len > n) return -2;
        int64_t nnz = (int64_t)br.get_bits(nnz_width(len));
        if (br.error || nnz > len) return -3;
        if (nnz) {
            uint64_t kb = br.get_bits(8);
            int kg = (int)(kb >> 4), km = (int)(kb & 15);
            int64_t pos = -1;
            for (int64_t i = 0; i < nnz; ++i) {
                uint64_t g = (uint64_t)br.get_fs() << kg;
                if (kg) g |= br.get_bits(kg);
                pos += (int64_t)g + 1;
                if (br.error || pos >= len) return -3;
                uint64_t m = (uint64_t)br.get_fs() << km;
                if (km) m |= br.get_bits(km);
                uint64_t sgn = br.get_bits(1);
                if (br.error) return -3;
                int64_t v = (int64_t)m + 1;
                out[off + pos] = (int32_t)(sgn ? -v : v);
            }
        }
        off += len;
    }
    if (off != n) return -2;
    return n;
}

}  // extern "C"
