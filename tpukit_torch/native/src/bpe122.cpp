// CCSDS 122.0-B-style Bit-Plane Encoder (BPE) — segment-structured
// bitstream for the tpukit ccsds122 codec.
//
// The reference invokes a user-supplied external `bpe.exe` per band
// (reference tools/codecs/ccsds122/ccsds122_wrap.py:110-133, `-e {in} -o
// {out} -r {bpp}`); tpukit implements the coder in-framework. This file
// implements the CCSDS 122.0-B SEGMENT STRUCTURE:
//
//   * segment headers (Part 1A/1B mandatory; Parts 2, 3, 4 emitted always
//     so every stream is self-describing): flags, BitDepthDC/AC,
//     SegByteLimit, S, pixel metadata — all parts are whole bytes, so the
//     header is 19 bytes (20 with Part 1B on the last segment);
//   * block organization: 1 DC + 63 AC per 8x8 image block — per family
//     (HL, LH, HH): parent, 4 children, 16 grandchildren in four 2x2
//     H-groups, gathered across the 3-level 9/7M DWT pyramid;
//   * initial DC coding: quantization by q (the standard's BitDepthDC/
//     BitDepthAC rule, 4.3.1), DPCM with theta-mapped deltas, Rice/
//     split-sample coding in gaggles of 16 with per-gaggle optimal k
//     (OptDCSelect=1), split-field layout (all FS parts, then all k-bit
//     remainders);
//   * additional DC bit planes (planes q-1 .. BitDepthAC, uncoded);
//   * BitDepthAC_Block coding with the same DPCM/gaggle machinery;
//   * bit-plane passes b = BitDepthAC-1 .. 0, each in five stages over
//     the whole segment: stage 0 DC refinement (b < q), stage 1 parent
//     significance, stage 2 tranB/tranD/children, stage 3 tranG/tranH/
//     grandchildren, stage 4 refinement of previously-significant AC;
//   * entropy coding of the stage-1..3 words (lengths 2..4) with
//     per-(gaggle, word-length) code options re-selected every bit plane
//     (OptACSelect=1), ID fields at first use, restricted symbol mappings
//     where an all-zero word is impossible, and forced-bit omission where
//     the decoder can infer significance;
//   * SegByteLimit truncation: the writer drops overflowing bits and the
//     decoder reconstructs from the prefix with midpoint fills.
//
// Conformance note (honest): this environment ships neither the 122.0-B
// Blue Book text nor any reference BPE binary to validate against (the
// reference repo requires the user to supply `bpe.exe`; none exists
// here), so the variable-length code tables and symbol mappings below
// are tpukit-specified (documented exhaustively in this file) rather
// than verified against Tables 4-9..4-17 of the Blue Book. The segment/
// gaggle/stage STRUCTURE, field widths and coding procedures follow the
// standard; tpukit's encoder and independent decoder round-trip exactly
// (fuzz-pinned in tests/test_bpe122.py) and the device size model
// (tpukit/codecs/bpe122_model.py) reproduces byte counts and truncated
// reconstructions bit-exactly.
//
// Atomicity rules for truncated decode (normative for this format, and
// mirrored by the device model):
//   * DC and depth GAGGLES are atomic: a gaggle cut mid-way contributes
//     nothing and decoding stops (the depth section discards entirely if
//     cut — the plane passes cannot start without every block's depth).
//   * additional-DC-plane bits, stage-0 bits and stage-4 refinement bits
//     are per-BIT granular.
//   * each stage-1..3 unit (one word plus its sign bits) is atomic.
//   * once any read falls short, decoding stops for good (the stream is
//     a strict prefix; later sections cannot be located).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include "bitio.hpp"

namespace {

using tpukit::BitWriter;
using tpukit::BitReader;

constexpr int GAGGLE = 16;

static inline int bits_twoscomp(int32_t v) {
    // two's-complement bits needed to represent v
    if (v >= 0) {
        uint32_t m = (uint32_t)v;
        int mag = m ? 32 - __builtin_clz(m) : 0;
        return mag + 1;
    }
    uint32_t m = (uint32_t)(-(int64_t)v);
    int mag = 32 - __builtin_clz(m);
    return ((m & (m - 1)) == 0) ? mag : mag + 1;   // -2^(mag-1) fits in mag
}

static inline int msb_index(uint32_t m) {          // -1 for 0
    return m ? 31 - __builtin_clz(m) : -1;
}

// --------------------------------------------------------------------------
// Word entropy coding: canonical VLC tables per word length (2..4) and
// code option (lengths are tpukit-specified; see conformance note).
// --------------------------------------------------------------------------

struct VlcTable {
    int n;
    uint16_t code[16];       // canonical codes (MSB-first)
    uint8_t len[16];
};

static VlcTable make_canonical(const uint8_t* lens, int n) {
    VlcTable t{};
    t.n = n;
    uint32_t code = 0;
    int prev = lens[0];
    for (int i = 0; i < n; ++i) {
        code <<= (lens[i] - prev);
        prev = lens[i];
        t.code[i] = (uint16_t)code;
        t.len[i] = lens[i];
        ++code;
    }
    return t;
}

static const uint8_t L2_OPT0[4]  = {1, 2, 3, 3};
static const uint8_t L3_OPT0[8]  = {1, 2, 3, 4, 5, 6, 7, 7};
static const uint8_t L3_OPT1[8]  = {2, 2, 3, 3, 4, 4, 5, 5};
static const uint8_t L4_OPT0[16] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                                    13, 14, 15, 15};
static const uint8_t L4_OPT1[16] = {2, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 6,
                                    7, 7, 7};
static const uint8_t L4_OPT2[16] = {3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5,
                                    5, 5, 5};

struct ClassSpec {
    int n_coded_options;     // options with VLC tables
    int id_bits;             // option-ID field width; all-ones = uncoded
    VlcTable opts[3];
};

static ClassSpec CLASSES[5];     // index by word length 2..4
static uint8_t SYM_FULL[5][16];  // word value -> symbol
static uint8_t VAL_FULL[5][16];  // symbol -> word value
static uint8_t SYM_RESTR[5][16]; // mapping when all-zero is impossible
static uint8_t VAL_RESTR[5][16];

static void init_tables() {
    static bool done = false;
    if (done) return;
    CLASSES[2] = {1, 1, {make_canonical(L2_OPT0, 4)}};
    CLASSES[3] = {2, 2, {make_canonical(L3_OPT0, 8),
                         make_canonical(L3_OPT1, 8)}};
    CLASSES[4] = {3, 2, {make_canonical(L4_OPT0, 16),
                         make_canonical(L4_OPT1, 16),
                         make_canonical(L4_OPT2, 16)}};
    // symbol mapping: rank words by (popcount asc, value asc) — sparse
    // significance makes low-population words most probable. Restricted
    // mapping excludes the (impossible) all-zero word.
    for (int L = 2; L <= 4; ++L) {
        int n = 1 << L;
        std::vector<int> order((size_t)n);
        for (int i = 0; i < n; ++i) order[(size_t)i] = i;
        std::stable_sort(order.begin(), order.end(), [](int a, int b) {
            int pa = __builtin_popcount((unsigned)a);
            int pb = __builtin_popcount((unsigned)b);
            return pa != pb ? pa < pb : a < b;
        });
        for (int s = 0; s < n; ++s) {
            SYM_FULL[L][order[(size_t)s]] = (uint8_t)s;
            VAL_FULL[L][s] = (uint8_t)order[(size_t)s];
        }
        for (int s = 1; s < n; ++s) {          // 0 is always rank 0
            SYM_RESTR[L][order[(size_t)s]] = (uint8_t)(s - 1);
            VAL_RESTR[L][s - 1] = (uint8_t)order[(size_t)s];
        }
    }
    done = true;
}

// --------------------------------------------------------------------------
// Per-block derived data.  Family f in {0=HL,1=LH,2=HH} occupies AC index
// range [21f, 21f+21): +0 parent, +1..+4 children (2x2 raster),
// +5..+20 grandchildren as four H-groups of 4 (group j <-> child j).
// --------------------------------------------------------------------------

struct BlockInfo {
    int32_t dc;
    int32_t ac[63];
    uint32_t mag[63];
    int8_t msb[63];          // MSB plane of |ac|; -1 for zero
    int8_t dmax;             // BitDepthAC_Block
    int8_t msbP[3], msbC[3], msbG[3], msbD[3], msbB;
    int8_t msbH[3][4];
};

static void fill_block(const int32_t* src, BlockInfo& B) {
    B.dc = src[0];
    B.msbB = -1;
    int dm = 0;
    for (int f = 0; f < 3; ++f) {
        int base = 21 * f;
        int8_t mP = -1, mC = -1, mG = -1;
        for (int k = 0; k < 21; ++k) {
            int32_t v = src[1 + base + k];
            B.ac[base + k] = v;
            uint32_t m = (uint32_t)(v < 0 ? -(int64_t)v : v);
            B.mag[base + k] = m;
            int8_t e = (int8_t)msb_index(m);
            B.msb[base + k] = e;
            if (k == 0) mP = e;
            else if (k <= 4) mC = std::max(mC, e);
            else mG = std::max(mG, e);
        }
        for (int j = 0; j < 4; ++j) {
            int8_t mh = -1;
            for (int t = 0; t < 4; ++t)
                mh = std::max(mh, B.msb[base + 5 + 4 * j + t]);
            B.msbH[f][j] = mh;
        }
        B.msbP[f] = mP;
        B.msbC[f] = mC;
        B.msbG[f] = mG;
        B.msbD[f] = std::max(mC, mG);
        B.msbB = std::max(B.msbB, B.msbD[f]);
        dm = std::max({dm, mP + 1, B.msbD[f] + 1});
    }
    B.dmax = (int8_t)dm;
}

// --------------------------------------------------------------------------
// DPCM + Rice gaggle coding shared by the DC and depth sections
// --------------------------------------------------------------------------

static inline int option_field_bits(int N) {
    return N <= 2 ? 1 : N <= 4 ? 2 : N <= 8 ? 3 : 4;
}

static inline uint32_t map_delta(int32_t delta, int32_t prev,
                                 int32_t vmin, int32_t vmax) {
    int32_t theta = std::min(prev - vmin, vmax - prev);
    if (delta >= 0 && delta <= theta) return (uint32_t)(2 * delta);
    if (delta < 0 && delta >= -theta) return (uint32_t)(-2 * delta - 1);
    return (uint32_t)(theta + (delta < 0 ? -delta : delta));
}

static void encode_dpcm(BitWriter& bw, const int32_t* vals, int64_t n,
                        int N, bool is_signed, int32_t range_top) {
    if (N == 1) {                    // single-bit values, uncoded
        for (int64_t i = 0; i < n; ++i)
            bw.put_bits((uint32_t)vals[i] & 1u, 1);
        return;
    }
    const int F = option_field_bits(N);
    const int UNCODED = (1 << F) - 1;
    const int kmax = std::min(N - 2, UNCODED - 1);
    const int32_t vmin = is_signed ? -(1 << (N - 1)) : 0;
    const int32_t vmax = is_signed ? (1 << (N - 1)) - 1 : range_top;

    std::vector<uint32_t> mapped((size_t)(n > 0 ? n : 1), 0);
    for (int64_t i = 1; i < n; ++i)
        mapped[(size_t)i] = map_delta(vals[i] - vals[i - 1], vals[i - 1],
                                      vmin, vmax);

    for (int64_t g0 = 0; g0 < n; g0 += GAGGLE) {
        int64_t g1 = std::min(n, g0 + GAGGLE);
        int64_t m0 = (g0 == 0) ? 1 : g0;       // first mapped index
        int64_t best_bits = (g1 - m0) * N;     // uncoded
        int best_k = UNCODED;
        for (int k = 0; k <= kmax; ++k) {
            int64_t bits = 0;
            for (int64_t i = m0; i < g1; ++i)
                bits += (int64_t)(mapped[(size_t)i] >> k) + 1 + k;
            if (bits < best_bits) { best_bits = bits; best_k = k; }
        }
        bw.put_bits((uint32_t)best_k, F);
        if (g0 == 0)
            bw.put_bits((uint32_t)vals[0] & ((1u << N) - 1u), N);
        if (best_k == UNCODED) {
            for (int64_t i = m0; i < g1; ++i)
                bw.put_bits(mapped[(size_t)i], N);
        } else {
            // split-field layout: all FS parts, then all k-bit remainders
            for (int64_t i = m0; i < g1; ++i)
                bw.put_fs(mapped[(size_t)i] >> best_k);
            if (best_k > 0)
                for (int64_t i = m0; i < g1; ++i)
                    bw.put_bits(mapped[(size_t)i], best_k);
        }
    }
}

// decode counterpart; fills vals[0..ret); whole-gaggle atomicity
static int64_t decode_dpcm(BitReader& br, int32_t* vals, int64_t n,
                           int N, bool is_signed, int32_t range_top) {
    if (N == 1) {
        for (int64_t i = 0; i < n; ++i) {
            uint32_t b = (uint32_t)br.get_bits(1);
            if (br.error) return i;
            vals[i] = is_signed ? -(int32_t)b : (int32_t)b;
        }
        return n;
    }
    const int F = option_field_bits(N);
    const int UNCODED = (1 << F) - 1;
    const int32_t vmin = is_signed ? -(1 << (N - 1)) : 0;
    const int32_t vmax = is_signed ? (1 << (N - 1)) - 1 : range_top;
    std::vector<uint32_t> mapped((size_t)n, 0);

    for (int64_t g0 = 0; g0 < n; g0 += GAGGLE) {
        int64_t g1 = std::min(n, g0 + GAGGLE);
        int64_t m0 = (g0 == 0) ? 1 : g0;
        int k = (int)br.get_bits(F);
        if (g0 == 0) {
            uint32_t raw = (uint32_t)br.get_bits(N);
            if (br.error) return 0;
            int32_t v = (int32_t)raw;
            if (is_signed && (raw >> (N - 1)))
                v = (int32_t)(raw | (~0u << N));
            vals[0] = v;
        }
        if (k == UNCODED) {
            for (int64_t i = m0; i < g1; ++i)
                mapped[(size_t)i] = (uint32_t)br.get_bits(N);
        } else {
            for (int64_t i = m0; i < g1; ++i)
                mapped[(size_t)i] = br.get_fs() << k;
            if (k > 0)
                for (int64_t i = m0; i < g1; ++i)
                    mapped[(size_t)i] |= (uint32_t)br.get_bits(k);
        }
        if (br.error) return g0 == 0 ? 0 : g0;
        for (int64_t i = m0; i < g1; ++i) {
            int32_t prev = vals[i - 1];
            int32_t theta = std::min(prev - vmin, vmax - prev);
            uint32_t mp = mapped[(size_t)i];
            int32_t d;
            if ((int32_t)mp <= 2 * theta)
                d = (mp & 1u) ? -(int32_t)((mp + 1) >> 1)
                              : (int32_t)(mp >> 1);
            else {
                int32_t mag = (int32_t)mp - theta;
                d = (prev + mag > vmax) ? -mag : mag;
            }
            vals[i] = prev + d;
        }
    }
    return n;
}

// q selection (CCSDS 122.0-B 4.3.1)
static int select_q(int bitdepth_dc, int bitdepth_ac) {
    int qp;
    int half = 1 + (bitdepth_ac + 1) / 2;       // 1 + ceil(AC/2)
    if (bitdepth_dc <= 3) qp = 0;
    else if (bitdepth_dc - half <= 1) qp = bitdepth_dc - 3;
    else if (bitdepth_dc - half > 10) qp = bitdepth_dc - 10;
    else qp = half;
    return std::max(qp, 3);
}

// --------------------------------------------------------------------------
// Stage 1-3 word generation (encoder side). Mirrored by the decoder and
// by the device size model — any change here must change all three.
// --------------------------------------------------------------------------

struct Word {
    int32_t block;
    uint8_t stage;           // 1..3
    uint8_t len;             // 1..4; 0 = omitted/forced word, signs only
    uint8_t value;
    uint8_t restricted;      // all-zero impossible
    uint8_t nsigns;
    uint8_t signs;           // first sign in the MSB of the nsigns field
};

static void gen_words(const BlockInfo& B, int b, int32_t m,
                      std::vector<Word>& words) {
    if (B.dmax <= b) return;

    // ---- stage 1: parents ----
    {
        uint8_t len = 0, val = 0, ns = 0, sg = 0;
        for (int f = 0; f < 3; ++f) {
            if (B.msbP[f] <= b) {               // not yet selected
                val = (uint8_t)((val << 1) | (B.msbP[f] == b));
                ++len;
                if (B.msbP[f] == b) {
                    sg = (uint8_t)((sg << 1) | (B.ac[21 * f] < 0));
                    ++ns;
                }
            }
        }
        if (len)
            words.push_back({m, 1, len, val, 0, ns, sg});
    }

    // ---- stage 2: tranB, tranD, children ----
    if (B.msbB <= b) {
        // forced-1 inference: at the block's top plane, if no parent is
        // new, significance must lie in B — the tranB bit is omitted
        bool forced = (b == B.dmax - 1) &&
                      (B.msbP[0] < b && B.msbP[1] < b && B.msbP[2] < b);
        if (!forced)
            words.push_back({m, 2, 1, (uint8_t)(B.msbB == b), 0, 0, 0});
        if (B.msbB < b) return;                 // B still insignificant
    }
    {
        uint8_t len = 0, val = 0;
        bool any_selected = false;
        for (int f = 0; f < 3; ++f) {
            if (B.msbD[f] > b) { any_selected = true; continue; }
            val = (uint8_t)((val << 1) | (B.msbD[f] == b));
            ++len;
        }
        if (len) {
            // all-zero impossible iff B newly significant with no family
            // selected earlier (the new significance must be in some D)
            uint8_t restr = (B.msbB == b && !any_selected) ? 1 : 0;
            if (!(len == 1 && restr))           // forced single bit: omit
                words.push_back({m, 2, len, val, restr, 0, 0});
        }
    }
    for (int f = 0; f < 3; ++f) {
        if (B.msbD[f] < b) continue;            // D_f not selected
        uint8_t len = 0, val = 0, ns = 0, sg = 0;
        for (int c = 0; c < 4; ++c) {
            int idx = 21 * f + 1 + c;
            if (B.msb[idx] > b) continue;       // already significant
            val = (uint8_t)((val << 1) | (B.msb[idx] == b));
            ++len;
            if (B.msb[idx] == b) {
                sg = (uint8_t)((sg << 1) | (B.ac[idx] < 0));
                ++ns;
            }
        }
        if (len)
            words.push_back({m, 2, len, val, 0, ns, sg});
    }

    // ---- stage 3: tranG, tranH, grandchildren ----
    bool g_known_sig[3];
    {
        uint8_t len = 0, val = 0;
        for (int f = 0; f < 3; ++f) {
            g_known_sig[f] = (B.msbG[f] >= b);
            if (B.msbD[f] < b) { g_known_sig[f] = false; continue; }
            if (B.msbG[f] > b) continue;        // G already selected
            bool child_new = false, child_any = false;
            for (int c = 0; c < 4; ++c) {
                int idx = 21 * f + 1 + c;
                if (B.msb[idx] == b) child_new = true;
                if (B.msb[idx] >= b) child_any = true;
            }
            // D newly significant but no child carries it => G must:
            // the tranG bit for this family is forced 1 and omitted
            if ((B.msbD[f] == b) && !child_new && !child_any) continue;
            val = (uint8_t)((val << 1) | (B.msbG[f] == b));
            ++len;
        }
        if (len)
            words.push_back({m, 3, len, val, 0, 0, 0});
    }
    for (int f = 0; f < 3; ++f) {
        if (B.msbD[f] < b || !g_known_sig[f]) continue;
        {
            uint8_t len = 0, val = 0;
            bool any_sel = false;
            for (int j = 0; j < 4; ++j) {
                if (B.msbH[f][j] > b) { any_sel = true; continue; }
                val = (uint8_t)((val << 1) | (B.msbH[f][j] == b));
                ++len;
            }
            if (len) {
                // G newly significant with no group selected earlier:
                // some group must be new => all-zero impossible
                uint8_t restr = (B.msbG[f] == b && !any_sel) ? 1 : 0;
                if (!(len == 1 && restr))       // forced: omit
                    words.push_back({m, 3, len, val, restr, 0, 0});
            }
        }
        for (int j = 0; j < 4; ++j) {
            if (B.msbH[f][j] < b) continue;
            uint8_t len = 0, val = 0, ns = 0, sg = 0;
            for (int t = 0; t < 4; ++t) {
                int idx = 21 * f + 5 + 4 * j + t;
                if (B.msb[idx] > b) continue;
                val = (uint8_t)((val << 1) | (B.msb[idx] == b));
                ++len;
                if (B.msb[idx] == b) {
                    sg = (uint8_t)((sg << 1) | (B.ac[idx] < 0));
                    ++ns;
                }
            }
            if (!len) continue;
            // group newly significant => some member new => restricted
            uint8_t restr = (B.msbH[f][j] == b) ? 1 : 0;
            if (len == 1 && restr)
                words.push_back({m, 3, 0, 0, 0, ns, sg});  // sign only
            else
                words.push_back({m, 3, len, val, restr, ns, sg});
        }
    }
}

static void emit_words(BitWriter& bw, const std::vector<Word>& words,
                       int64_t ngaggles) {
    const int NG = (int)ngaggles;
    std::vector<int32_t> cost((size_t)(NG * 3 * 4), 0);  // [g][L-2][opt]
    std::vector<uint8_t> used((size_t)(NG * 3), 0);
    auto cix = [](int g, int L, int o) { return (g * 3 + (L - 2)) * 4 + o; };

    for (const Word& w : words) {
        if (w.len < 2) continue;
        int g = w.block / GAGGLE;
        const ClassSpec& cs = CLASSES[w.len];
        const uint8_t* symmap = w.restricted ? SYM_RESTR[w.len]
                                             : SYM_FULL[w.len];
        int sym = symmap[w.value];
        for (int o = 0; o < cs.n_coded_options; ++o)
            cost[(size_t)cix(g, w.len, o)] += cs.opts[o].len[sym];
        cost[(size_t)cix(g, w.len, 3)] += w.len;         // uncoded
        used[(size_t)(g * 3 + (w.len - 2))] = 1;
    }
    // first strict minimum wins, in order (opt0, opt1, opt2, uncoded)
    std::vector<uint8_t> sel((size_t)(NG * 3), 0);
    for (int g = 0; g < NG; ++g)
        for (int L = 2; L <= 4; ++L) {
            if (!used[(size_t)(g * 3 + (L - 2))]) continue;
            const ClassSpec& cs = CLASSES[L];
            int best_o = 0, best_c = cost[(size_t)cix(g, L, 0)];
            for (int o = 1; o < cs.n_coded_options; ++o)
                if (cost[(size_t)cix(g, L, o)] < best_c) {
                    best_c = cost[(size_t)cix(g, L, o)];
                    best_o = o;
                }
            if (cost[(size_t)cix(g, L, 3)] < best_c)
                best_o = cs.n_coded_options;               // uncoded
            sel[(size_t)(g * 3 + (L - 2))] = (uint8_t)best_o;
        }
    std::vector<uint8_t> id_done((size_t)(NG * 3), 0);
    for (const Word& w : words) {
        int g = w.block / GAGGLE;
        if (w.len == 1) {
            bw.put_bits(w.value, 1);
        } else if (w.len >= 2) {
            const ClassSpec& cs = CLASSES[w.len];
            int o = sel[(size_t)(g * 3 + (w.len - 2))];
            if (!id_done[(size_t)(g * 3 + (w.len - 2))]) {
                int idv = (o >= cs.n_coded_options)
                          ? ((1 << cs.id_bits) - 1) : o;
                bw.put_bits((uint32_t)idv, cs.id_bits);
                id_done[(size_t)(g * 3 + (w.len - 2))] = 1;
            }
            if (o >= cs.n_coded_options) {
                bw.put_bits(w.value, w.len);
            } else {
                const uint8_t* symmap = w.restricted ? SYM_RESTR[w.len]
                                                     : SYM_FULL[w.len];
                int sym = symmap[w.value];
                bw.put_bits(cs.opts[o].code[sym], cs.opts[o].len[sym]);
            }
        }
        if (w.nsigns)
            bw.put_bits(w.signs, w.nsigns);
    }
}

static int vlc_decode(BitReader& br, const VlcTable& t) {
    uint32_t code = 0;
    int len = 0;
    for (int s = 0; s < t.n; ++s) {
        while (len < t.len[s]) {
            code = (code << 1) | (uint32_t)br.get_bits(1);
            if (br.error) return -1;
            ++len;
        }
        if (code == t.code[s]) return s;
    }
    br.error = true;
    return -1;
}

constexpr int HDR_BYTES_BASE = 3 + 5 + 3 + 8;   // Parts 1A + 2 + 3 + 4
// Part 1B adds 1 byte on the last segment.

} // namespace

// ==========================================================================
// Encoder
// ==========================================================================

extern "C" int64_t tpukit_bpe122_encode(
        const int32_t* blocks, int64_t nblocks, int64_t seg_size,
        int64_t seg_byte_limit, int32_t img_width, int32_t pad_rows,
        int32_t pixel_bitdepth, int32_t signed_pixels,
        uint8_t* out, int64_t cap) {
    init_tables();
    if (nblocks <= 0 || seg_size <= 0 || seg_size > (1 << 20) - 1)
        return -1;
    int64_t written = 0;
    int64_t nseg = (nblocks + seg_size - 1) / seg_size;

    for (int64_t s = 0; s < nseg; ++s) {
        int64_t b0 = s * seg_size;
        int64_t S = std::min(seg_size, nblocks - b0);
        bool last = (s == nseg - 1);
        int hdr_bytes = HDR_BYTES_BASE + (last ? 1 : 0);
        if (cap - written < hdr_bytes + 8) return -1;  // caller sizes cap

        std::vector<BlockInfo> bi((size_t)S);
        int bd_dc = 1, bd_ac = 0;
        for (int64_t m = 0; m < S; ++m) {
            fill_block(blocks + (b0 + m) * 64, bi[(size_t)m]);
            bd_dc = std::max(bd_dc, bits_twoscomp(bi[(size_t)m].dc));
            bd_ac = std::max(bd_ac, (int)bi[(size_t)m].dmax);
        }
        const int q = select_q(bd_dc, bd_ac);
        const int N = std::max(bd_dc - q, 1);

        int64_t seg_cap = cap - written;
        if (seg_byte_limit > 0)
            seg_cap = std::min(seg_cap,
                               std::max<int64_t>(seg_byte_limit,
                                                 hdr_bytes + 8));
        BitWriter bw(out + written, seg_cap);

        // ---- segment header ----
        bw.put_bits(s == 0, 1);                  // StartImgFlag
        bw.put_bits(last, 1);                    // EndImgFlag
        bw.put_bits((uint32_t)(s & 0xFF), 8);    // SegmentCount
        bw.put_bits((uint32_t)bd_dc, 5);         // BitDepthDC
        bw.put_bits((uint32_t)bd_ac, 5);         // BitDepthAC
        bw.put_bits(0, 1);                       // Reserved
        bw.put_bits(1, 1);                       // Part2Flag
        bw.put_bits(1, 1);                       // Part3Flag
        bw.put_bits(1, 1);                       // Part4Flag
        if (last) {                              // Part 1B
            bw.put_bits((uint32_t)(pad_rows & 7), 3);
            bw.put_bits(0, 5);
        }
        uint32_t sbl = seg_byte_limit > 0
                       ? (uint32_t)std::min<int64_t>(seg_cap, (1 << 27) - 1)
                       : 0;
        bw.put_bits(sbl, 27);                    // SegByteLimit (0 = none)
        bw.put_bits(0, 1);                       // DCStop
        bw.put_bits(0, 5);                       // BitPlaneStop
        bw.put_bits(0, 2);                       // StageStop
        bw.put_bits(0, 1);                       // UseFill
        bw.put_bits(0, 4);                       // Reserved
        bw.put_bits((uint32_t)S, 20);            // S
        bw.put_bits(1, 1);                       // OptDCSelect (optimal)
        bw.put_bits(1, 1);                       // OptACSelect (optimal)
        bw.put_bits(0, 2);                       // Reserved
        bw.put_bits(1, 1);                       // DWTtype: integer 9/7M
        bw.put_bits(0, 1);                       // ExtendedPixelBitDepth
        bw.put_bits((uint32_t)(signed_pixels & 1), 1);
        bw.put_bits((uint32_t)(pixel_bitdepth & 15), 4);  // 0 encodes 16
        bw.put_bits((uint32_t)(img_width & ((1 << 20) - 1)), 20);
        bw.put_bits(0, 1);                       // TransposeImg
        bw.put_bits(0, 3);                       // CodeWordLength (8-bit)
        bw.put_bits(0, 1);                       // CustomWtFlag
        bw.put_bits(0, 20);                      // CustomWt fields (unused)
        bw.put_bits(0, 12);                      // Reserved

        // ---- initial DC coding ----
        std::vector<int32_t> qdc((size_t)S);
        for (int64_t m = 0; m < S; ++m)
            qdc[(size_t)m] = bi[(size_t)m].dc >> q;   // arithmetic shift
        encode_dpcm(bw, qdc.data(), S, N, true, 0);

        // ---- additional DC bit planes (q-1 .. BitDepthAC), uncoded ----
        for (int b = q - 1; b >= bd_ac; --b)
            for (int64_t m = 0; m < S; ++m)
                bw.put_bits((uint32_t)(bi[(size_t)m].dc >> b) & 1u, 1);

        // ---- BitDepthAC_Block coding ----
        if (bd_ac > 0) {
            int Nd = 1;
            while ((1 << Nd) <= bd_ac) ++Nd;     // ceil(log2(bd_ac+1))
            std::vector<int32_t> depths((size_t)S);
            for (int64_t m = 0; m < S; ++m)
                depths[(size_t)m] = bi[(size_t)m].dmax;
            encode_dpcm(bw, depths.data(), S, Nd, false, bd_ac);
        }

        // ---- bit-plane passes ----
        int64_t ngaggles = (S + GAGGLE - 1) / GAGGLE;
        std::vector<Word> words;
        for (int b = bd_ac - 1; b >= 0 && !bw.overflow; --b) {
            if (b < q)                           // stage 0
                for (int64_t m = 0; m < S; ++m)
                    bw.put_bits((uint32_t)(bi[(size_t)m].dc >> b) & 1u, 1);
            words.clear();
            for (int64_t m = 0; m < S; ++m)
                gen_words(bi[(size_t)m], b, (int32_t)m, words);
            std::stable_sort(words.begin(), words.end(),
                             [](const Word& a, const Word& c) {
                                 return a.stage < c.stage;
                             });
            emit_words(bw, words, ngaggles);
            for (int64_t m = 0; m < S; ++m) {    // stage 4
                const BlockInfo& B = bi[(size_t)m];
                if (B.dmax <= b) continue;
                for (int k = 0; k < 63; ++k)
                    if (B.msb[k] > b)
                        bw.put_bits((B.mag[k] >> b) & 1u, 1);
            }
        }
        written += bw.bytes();                   // flush w/ zero fill
    }
    return written;
}

// ==========================================================================
// Decoder
// ==========================================================================

namespace {

struct DecBlock {
    int32_t dc = 0;
    int dc_known = 32;       // lowest DC plane received (32 = none)
    int dmax = 0;
    uint32_t mag[63];
    int8_t sig[63];          // acquisition plane; -1 = not selected
    uint8_t neg[63];
    int8_t low[63];          // lowest plane received; 32 = none
    bool b_sig = false;
    bool d_sig[3] = {false, false, false};
    bool g_sig[3] = {false, false, false};
    bool h_sig[3][4] = {};
    DecBlock() {
        std::memset(mag, 0, sizeof mag);
        std::memset(neg, 0, sizeof neg);
        for (int i = 0; i < 63; ++i) { sig[i] = -1; low[i] = 32; }
    }
};

// Optional decode trace (tpukit_bpe122_decode_trace): one record of 7
// int32 per stage-1..3 word — [plane, stage, gaggle, word_len,
// restricted, option ((n_coded_options) = uncoded, -1 = single-bit),
// value] — the field-level inventory a future Blue-Book table
// transcription diffs against (tests/test_golden_vectors.py).
struct TraceSink {
    int32_t* buf = nullptr;
    int64_t cap = 0, n = 0;
    int plane = 0, stage = 0;
    void rec(int g, int len, int restr, int opt, int val) {
        if (!buf) return;
        if (n + 7 > cap) { buf = nullptr; n = -1; return; }
        buf[n++] = plane; buf[n++] = stage; buf[n++] = g;
        buf[n++] = len; buf[n++] = restr; buf[n++] = opt; buf[n++] = val;
    }
};
// thread_local: plain decodes touch the sink's plane/stage fields too,
// so a shared global would race if bpe decodes ever fan out across
// threads (the j2k band-pool pattern); each thread gets its own sink
// and tracing stays scoped to the thread that called decode_trace.
static thread_local TraceSink g_trace;

struct WordReader {
    BitReader& br;
    std::vector<int8_t> sel;     // per (gaggle, class): option or -1
    WordReader(BitReader& b, int64_t ng) : br(b), sel((size_t)(ng * 3), -1) {}
    void new_plane() { std::fill(sel.begin(), sel.end(), -1); }
    int read(int g, int len, bool restricted) {
        if (len == 1) {
            int v = (int)br.get_bits(1);
            if (br.error) return -1;
            g_trace.rec(g, len, restricted ? 1 : 0, -1, v);
            return v;
        }
        const ClassSpec& cs = CLASSES[len];
        int8_t& o = sel[(size_t)(g * 3 + (len - 2))];
        if (o < 0) {
            int idv = (int)br.get_bits(cs.id_bits);
            if (br.error) return -1;
            o = (int8_t)(idv >= cs.n_coded_options ? cs.n_coded_options
                                                   : idv);
        }
        if (o >= cs.n_coded_options) {
            int v = (int)br.get_bits(len);
            if (br.error) return -1;
            g_trace.rec(g, len, restricted ? 1 : 0, (int)o, v);
            return v;
        }
        int sym = vlc_decode(br, cs.opts[o]);
        if (sym < 0) return -1;
        int navail = restricted ? (1 << len) - 1 : (1 << len);
        if (sym >= navail) { br.error = true; return -1; }
        int v = restricted ? VAL_RESTR[len][sym] : VAL_FULL[len][sym];
        g_trace.rec(g, len, restricted ? 1 : 0, (int)o, v);
        return v;
    }
};

} // namespace

extern "C" int64_t tpukit_bpe122_decode(
        const uint8_t* in, int64_t nbytes, int64_t nblocks,
        int32_t* blocks_out) {
    init_tables();
    int64_t pos = 0;
    int64_t done_blocks = 0;

    while (done_blocks < nblocks && pos < nbytes) {
        // ---- header (fixed 19/20 whole bytes) ----
        BitReader hb(in + pos, std::min<int64_t>(nbytes - pos, 24));
        hb.get_bits(1);                              // StartImgFlag
        int end_flag = (int)hb.get_bits(1);
        hb.get_bits(8);                              // SegmentCount
        int bd_dc = (int)hb.get_bits(5);
        int bd_ac = (int)hb.get_bits(5);
        hb.get_bits(4);                              // Reserved + flags
        if (end_flag) hb.get_bits(8);                // Part 1B
        uint32_t sbl = (uint32_t)hb.get_bits(27);
        hb.get_bits(13);                             // Part 2 rest
        int64_t S = (int64_t)hb.get_bits(20);
        hb.get_bits(4);                              // Part 3 rest
        hb.get_bits(56);                             // Part 4 (64 bits)
        hb.get_bits(8);
        if (hb.error || S <= 0 || done_blocks + S > nblocks) return -1;
        if (bd_dc < 1 || bd_dc > 32 || bd_ac > 31) return -1;

        const int hdr_bytes = HDR_BYTES_BASE + (end_flag ? 1 : 0);
        int64_t seg_avail = nbytes - pos;
        if (sbl > 0) seg_avail = std::min<int64_t>(seg_avail, (int64_t)sbl);

        const int q = select_q(bd_dc, bd_ac);
        const int N = std::max(bd_dc - q, 1);
        std::vector<DecBlock> dec((size_t)S);
        bool short_read = false;

        // body reader strictly bounded by the segment window, so bits of
        // a following segment can never leak into a truncated decode
        BitReader br(in + pos + hdr_bytes,
                     std::max<int64_t>(seg_avail - hdr_bytes, 0));

        {
            // ---- initial DC ----
            std::vector<int32_t> qdc((size_t)S, 0);
            int64_t got = decode_dpcm(br, qdc.data(), S, N, true, 0);
            for (int64_t m = 0; m < got; ++m) {
                dec[(size_t)m].dc = qdc[(size_t)m] << q;
                dec[(size_t)m].dc_known = q;
            }
            if (got < S) { short_read = true; goto reconstruct; }
        }
        // ---- additional DC planes ----
        for (int b = q - 1; b >= bd_ac; --b)
            for (int64_t m = 0; m < S; ++m) {
                uint32_t bit = (uint32_t)br.get_bits(1);
                if (br.error) { short_read = true; goto reconstruct; }
                dec[(size_t)m].dc |= (int32_t)(bit << b);
                dec[(size_t)m].dc_known = b;
            }
        // ---- depths ----
        if (bd_ac > 0) {
            int Nd = 1;
            while ((1 << Nd) <= bd_ac) ++Nd;
            std::vector<int32_t> depths((size_t)S, 0);
            int64_t got = decode_dpcm(br, depths.data(), S, Nd, false,
                                      bd_ac);
            if (got < S) { short_read = true; goto reconstruct; }
            for (int64_t m = 0; m < S; ++m) {
                if (depths[(size_t)m] < 0 || depths[(size_t)m] > bd_ac) {
                    short_read = true; goto reconstruct;
                }
                dec[(size_t)m].dmax = depths[(size_t)m];
            }
        }
        // ---- planes ----
        {
            WordReader wr(br, (S + GAGGLE - 1) / GAGGLE);
            for (int b = bd_ac - 1; b >= 0; --b) {
                if (b < q)
                    for (int64_t m = 0; m < S; ++m) {
                        uint32_t bit = (uint32_t)br.get_bits(1);
                        if (br.error) { short_read = true; goto reconstruct; }
                        dec[(size_t)m].dc |= (int32_t)(bit << b);
                        dec[(size_t)m].dc_known = b;
                    }
                wr.new_plane();
                g_trace.plane = b;
                g_trace.stage = 1;
                // ---- stage 1 ----
                for (int64_t m = 0; m < S; ++m) {
                    DecBlock& D = dec[(size_t)m];
                    if (D.dmax <= b) continue;
                    int open[3], no = 0;
                    for (int f = 0; f < 3; ++f)
                        if (D.sig[21 * f] < 0) open[no++] = f;
                    if (!no) continue;
                    int g = (int)(m / GAGGLE);
                    int val = wr.read(g, no, false);
                    if (val < 0) { short_read = true; goto reconstruct; }
                    int nnew = __builtin_popcount((unsigned)val);
                    uint32_t signs = nnew ? (uint32_t)br.get_bits(nnew) : 0;
                    if (br.error) { short_read = true; goto reconstruct; }
                    int si = 0;
                    for (int i = 0; i < no; ++i)
                        if ((val >> (no - 1 - i)) & 1) {
                            int idx = 21 * open[i];
                            D.sig[idx] = (int8_t)b;
                            D.mag[idx] |= 1u << b;
                            D.low[idx] = (int8_t)b;
                            D.neg[idx] =
                                (uint8_t)((signs >> (nnew - 1 - si)) & 1);
                            ++si;
                        }
                }
                // ---- stage 2 ----
                g_trace.stage = 2;
                for (int64_t m = 0; m < S; ++m) {
                    DecBlock& D = dec[(size_t)m];
                    if (D.dmax <= b) continue;
                    int g = (int)(m / GAGGLE);
                    if (!D.b_sig) {
                        bool no_parent_new = true;
                        for (int f = 0; f < 3; ++f)
                            if (D.sig[21 * f] == b) no_parent_new = false;
                        bool forced = (b == D.dmax - 1) && no_parent_new;
                        int bit = 1;
                        if (!forced) {
                            bit = wr.read(g, 1, false);
                            if (bit < 0) { short_read = true;
                                           goto reconstruct; }
                        }
                        if (!bit) continue;
                        D.b_sig = true;
                        // B newly significant, nothing selected before:
                        // tranD covers all 3 families, restricted
                        int val = wr.read(g, 3, true);
                        if (val < 0) { short_read = true; goto reconstruct; }
                        for (int f = 0; f < 3; ++f)
                            if ((val >> (2 - f)) & 1) D.d_sig[f] = true;
                    } else {
                        int open[3], no = 0;
                        for (int f = 0; f < 3; ++f)
                            if (!D.d_sig[f]) open[no++] = f;
                        if (no) {
                            int val = wr.read(g, no, false);
                            if (val < 0) { short_read = true;
                                           goto reconstruct; }
                            for (int i = 0; i < no; ++i)
                                if ((val >> (no - 1 - i)) & 1)
                                    D.d_sig[open[i]] = true;
                        }
                    }
                    for (int f = 0; f < 3; ++f) {
                        if (!D.d_sig[f]) continue;
                        int open[4], no = 0;
                        for (int c = 0; c < 4; ++c)
                            if (D.sig[21 * f + 1 + c] < 0) open[no++] = c;
                        if (!no) continue;
                        int val = wr.read(g, no, false);
                        if (val < 0) { short_read = true; goto reconstruct; }
                        int nnew = __builtin_popcount((unsigned)val);
                        uint32_t signs = nnew ? (uint32_t)br.get_bits(nnew)
                                              : 0;
                        if (br.error) { short_read = true; goto reconstruct; }
                        int si = 0;
                        for (int i = 0; i < no; ++i)
                            if ((val >> (no - 1 - i)) & 1) {
                                int idx = 21 * f + 1 + open[i];
                                D.sig[idx] = (int8_t)b;
                                D.mag[idx] |= 1u << b;
                                D.low[idx] = (int8_t)b;
                                D.neg[idx] = (uint8_t)(
                                    (signs >> (nnew - 1 - si)) & 1);
                                ++si;
                            }
                    }
                }
                // ---- stage 3 ----
                g_trace.stage = 3;
                for (int64_t m = 0; m < S; ++m) {
                    DecBlock& D = dec[(size_t)m];
                    if (D.dmax <= b || !D.b_sig) continue;
                    int g = (int)(m / GAGGLE);
                    int open[3], no = 0;
                    bool forcedG[3] = {false, false, false};
                    for (int f = 0; f < 3; ++f) {
                        if (!D.d_sig[f] || D.g_sig[f]) continue;
                        bool child_new = false, child_any = false,
                             child_before = false;
                        for (int c = 0; c < 4; ++c) {
                            int8_t sc = D.sig[21 * f + 1 + c];
                            if (sc == b) child_new = true;
                            if (sc >= 0) child_any = true;
                            if (sc > b) child_before = true;
                        }
                        // with G unselected, D's earlier significance can
                        // only come from children: D newly significant
                        // here iff no child was significant before b
                        bool d_new_now = !child_before;
                        if (d_new_now && !child_new && !child_any) {
                            forcedG[f] = true;       // G must carry it
                            continue;
                        }
                        open[no++] = f;
                    }
                    if (no) {
                        int val = wr.read(g, no, false);
                        if (val < 0) { short_read = true; goto reconstruct; }
                        for (int i = 0; i < no; ++i)
                            if ((val >> (no - 1 - i)) & 1)
                                D.g_sig[open[i]] = true;
                    }
                    for (int f = 0; f < 3; ++f)
                        if (forcedG[f]) D.g_sig[f] = true;
                    for (int f = 0; f < 3; ++f) {
                        if (!D.d_sig[f] || !D.g_sig[f]) continue;
                        int openH[4], nh = 0;
                        bool any_sel = false;
                        for (int j = 0; j < 4; ++j) {
                            if (D.h_sig[f][j]) { any_sel = true; continue; }
                            openH[nh++] = j;
                        }
                        if (nh) {
                            // G selected earlier iff some H was: so with
                            // no H selected, G is newly significant here
                            bool restr = !any_sel;
                            if (nh == 1 && restr) {
                                D.h_sig[f][openH[0]] = true;   // forced
                            } else {
                                int val = wr.read(g, nh, restr);
                                if (val < 0) { short_read = true;
                                               goto reconstruct; }
                                for (int i = 0; i < nh; ++i)
                                    if ((val >> (nh - 1 - i)) & 1)
                                        D.h_sig[f][openH[i]] = true;
                            }
                        }
                        for (int j = 0; j < 4; ++j) {
                            if (!D.h_sig[f][j]) continue;
                            int openT[4], nt = 0;
                            bool member_before = false;
                            for (int t = 0; t < 4; ++t) {
                                int idx = 21 * f + 5 + 4 * j + t;
                                if (D.sig[idx] < 0) openT[nt++] = t;
                                else if (D.sig[idx] > b) member_before = true;
                            }
                            if (!nt) continue;
                            // group newly significant here iff no member
                            // was significant before this plane
                            bool restr = !member_before && nt == 4;
                            // nt < 4 with no member_before means members
                            // became significant AT b in an earlier...
                            // impossible: acquisitions at plane b happen
                            // in this very pass. nt==4 is the clean test.
                            int val;
                            if (nt == 1 && restr) {
                                val = 1;
                            } else {
                                val = wr.read(g, nt, restr);
                                if (val < 0) { short_read = true;
                                               goto reconstruct; }
                            }
                            int nnew = __builtin_popcount((unsigned)val);
                            uint32_t signs = nnew
                                ? (uint32_t)br.get_bits(nnew) : 0;
                            if (br.error) { short_read = true;
                                            goto reconstruct; }
                            int si = 0;
                            for (int i = 0; i < nt; ++i)
                                if ((val >> (nt - 1 - i)) & 1) {
                                    int idx = 21 * f + 5 + 4 * j + openT[i];
                                    D.sig[idx] = (int8_t)b;
                                    D.mag[idx] |= 1u << b;
                                    D.low[idx] = (int8_t)b;
                                    D.neg[idx] = (uint8_t)(
                                        (signs >> (nnew - 1 - si)) & 1);
                                    ++si;
                                }
                        }
                    }
                }
                // ---- stage 4 ----
                for (int64_t m = 0; m < S; ++m) {
                    DecBlock& D = dec[(size_t)m];
                    if (D.dmax <= b) continue;
                    for (int k = 0; k < 63; ++k)
                        if (D.sig[k] > b) {
                            uint32_t bit = (uint32_t)br.get_bits(1);
                            if (br.error) { short_read = true;
                                            goto reconstruct; }
                            D.mag[k] |= bit << b;
                            D.low[k] = (int8_t)b;
                        }
                }
            }
        }

    reconstruct:
        for (int64_t m = 0; m < S; ++m) {
            DecBlock& D = dec[(size_t)m];
            int32_t* dst = blocks_out + (done_blocks + m) * 64;
            int32_t dcv = D.dc;
            if (D.dc_known >= 32) dcv = 0;               // nothing received
            else if (D.dc_known > 0)
                dcv += 1 << (D.dc_known - 1);            // midpoint fill
            dst[0] = dcv;
            for (int k = 0; k < 63; ++k) {
                uint32_t mag = D.mag[k];
                if (D.sig[k] >= 0 && D.low[k] > 0 && D.low[k] < 32)
                    mag += 1u << (D.low[k] - 1);
                dst[1 + k] = D.neg[k] ? -(int32_t)mag : (int32_t)mag;
            }
        }
        done_blocks += S;

        int64_t consumed;
        if (short_read) {
            // the encoder filled this segment's whole window
            consumed = seg_avail;
        } else {
            consumed = hdr_bytes + (br.bytepos - (br.avail >> 3));
        }
        pos += std::min<int64_t>(seg_avail,
                                 std::max<int64_t>(consumed, 1));
    }
    return done_blocks;
}

// Decode with the stage-1..3 word trace enabled (see TraceSink). Returns
// the number of int32 slots written to `trace` (a multiple of 7), or -2
// if the trace buffer overflowed, or the decoder's negative error.
extern "C" int64_t tpukit_bpe122_decode_trace(
        const uint8_t* in, int64_t nbytes, int64_t nblocks,
        int32_t* blocks_out, int32_t* trace, int64_t trace_cap) {
    g_trace.buf = trace;
    g_trace.cap = trace_cap;
    g_trace.n = 0;
    int64_t r = tpukit_bpe122_decode(in, nbytes, nblocks, blocks_out);
    int64_t n = g_trace.n;
    g_trace.buf = nullptr;
    g_trace.cap = g_trace.n = 0;
    if (r < 0) return r;
    return n < 0 ? -2 : n;
}
