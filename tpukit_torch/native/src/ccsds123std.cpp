// CCSDS 123.0-B-1 lossless multispectral/hyperspectral compression:
// the STANDARD's sample-adaptive predictor (local sums + weight-adaptive
// linear prediction with per-sample LMS updates) and sample-adaptive
// GPO2 entropy coder, with the Blue Book §5.3 header bit layout.
//
// This is the standard-conformant companion to tpukit's TPU-first
// CCSDS-123-class LS predictor (codecs/ccsds123_codec.py): the reference
// pipeline wraps the CNES enc123/dec123 binaries implementing this
// algorithm (reference tools/codecs/ccsds123/ccsds123_wrap.py:8,
// :129-153), and the per-sample weight-update recurrence is inherently
// serial in raster order — exactly the kind of sequential bit-exact
// stage tpukit runs in-process C++ (like the J2K MQ coder and the
// CCSDS-121 packers) while the batched modeling stages stay on device.
//
// Coverage (all parameters recorded in the header, §5.3):
//   * prediction: full or reduced mode, neighbor- or column-oriented
//     local sums, P in [0,15] previous bands, default weight init,
//     register size R, weight resolution Om, update scaling v_min/v_max
//     with interval 2^kappa
//   * entropy: sample-adaptive GPO2 with unary limit U_max, counter
//     gamma0/gamma*, accumulator init constant K; the first sample of
//     each band rides uncompressed in D bits
//   * encoding order: BSQ (the reference wrapper's default interleave,
//     ccsds123_wrap.py:116) or band-interleaved (§4.2) with sub-frame
//     interleaving depth M — M=1 is BIL, M=Nz is BIP (the reference
//     wrapper's --interleave bip/bil, ccsds123_wrap.py:116). Under BI
//     every band's predictor/entropy state advances in lockstep; the
//     central local differences are only ever read at the current
//     sample position, so BI needs just an (Nz, Nx) row buffer where
//     BSQ keeps (P+1) full planes.
// Lossless only — the reference pipeline runs the CNES coder with
// quantizer_fidelity_control_method = 0 (ccsds123_wrap.py:8).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "bitio.hpp"

namespace {

using tpukit::BitReader;
using tpukit::BitWriter;

struct Params {
    int32_t Nx, Ny, Nz;
    int D = 16;
    bool is_signed = false;
    int P = 3;
    bool full = true;      // full (directional + central) prediction mode
    bool colsum = false;   // column-oriented local sums
    int32_t subM = 0;      // 0 = BSQ; >=1 = band-interleaved, depth M
    int ec = 0;            // entropy coder: 0 sample-adaptive, 1 block-
                           // adaptive (§5.4.2 — the CCSDS-121 block coder
                           // over the mapped residuals, no preprocessor)
    int bJ = 64;           // block-adaptive: block size (8/16/32/64)
    int bR = 64;           // block-adaptive: reference sample interval
    int R = 32;            // register size (max(32, D+Om+2) <= R <= 64)
    int Om = 13;           // weight component resolution (4..19)
    int kappa = 6;         // weight update interval t_inc = 2^kappa (4..11)
    int vmin = -1, vmax = 3;  // update scaling exponents (-6..9)
    int Umax = 16;         // unary length limit (8..32)
    int g0 = 1;            // initial count exponent (1..8)
    int gstar = 6;         // rescaling counter size (max(4,g0+1)..9)
    int K = 5;             // accumulator init constant (0..min(D-2,14))

    int64_t smin() const { return is_signed ? -(1ll << (D - 1)) : 0; }
    int64_t smax() const {
        return is_signed ? (1ll << (D - 1)) - 1 : (1ll << D) - 1;
    }
    int64_t smid() const { return is_signed ? 0 : 1ll << (D - 1); }
};

inline int64_t mod_star(int64_t x, int R) {
    // mod*_R[x] = ((x + 2^(R-1)) mod 2^R) - 2^(R-1)
    uint64_t mask = (R >= 64) ? ~0ull : ((1ull << R) - 1);
    uint64_t y = ((uint64_t)x + (1ull << (R - 1))) & mask;
    return (int64_t)y - (1ll << (R - 1));
}

inline int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// ---- header (§5.3): 12-byte image + 5-byte predictor + 2-byte entropy ----

void write_header(BitWriter& bw, const Params& p) {
    // image metadata (96 bits)
    bw.put_bits(0, 8);                        // user-defined data
    bw.put_bits((uint64_t)p.Nx & 0xFFFF, 16); // X size mod 2^16
    bw.put_bits((uint64_t)p.Ny & 0xFFFF, 16); // Y size mod 2^16
    bw.put_bits((uint64_t)p.Nz & 0xFFFF, 16); // Z size mod 2^16
    bw.put_bits(p.is_signed ? 1 : 0, 1);      // sample type
    bw.put_bits(0, 2);                        // reserved
    bw.put_bits((uint64_t)(p.D & 15), 4);     // dynamic range mod 16
    bw.put_bits(p.subM > 0 ? 0 : 1, 1);       // encoding order: 1=BSQ 0=BI
    bw.put_bits(p.subM > 0                    // sub-frame interleaving
                ? (uint64_t)p.subM & 0xFFFF   // depth M mod 2^16 (BI only)
                : 0, 16);
    bw.put_bits(0, 2);                        // reserved
    bw.put_bits(1, 3);                        // output word size (bytes)
    bw.put_bits((uint64_t)(p.ec & 1), 1);     // entropy: 0 sample, 1 block
    bw.put_bits(0, 10);                       // reserved
    // predictor metadata (40 bits)
    bw.put_bits(0, 2);                        // reserved
    bw.put_bits((uint64_t)p.P, 4);            // prediction bands
    bw.put_bits(p.full ? 0 : 1, 1);           // mode: 0 full, 1 reduced
    bw.put_bits(0, 1);                        // reserved
    bw.put_bits(p.colsum ? 1 : 0, 1);         // local sum: 1 column-oriented
    bw.put_bits(0, 1);                        // reserved
    bw.put_bits((uint64_t)(p.R & 63), 6);     // register size mod 64
    bw.put_bits((uint64_t)(p.Om - 4), 4);     // weight resolution - 4
    bw.put_bits((uint64_t)(p.kappa - 4), 4);  // log2(t_inc) - 4
    bw.put_bits((uint64_t)(p.vmin + 6), 4);   // v_min + 6
    bw.put_bits((uint64_t)(p.vmax + 6), 4);   // v_max + 6
    bw.put_bits(0, 1);                        // reserved
    bw.put_bits(0, 1);                        // weight init method: default
    bw.put_bits(0, 1);                        // weight init table flag
    bw.put_bits(0, 5);                        // weight init resolution
    if (p.ec == 0) {
        // entropy coder metadata, sample-adaptive (16 bits)
        bw.put_bits((uint64_t)(p.Umax & 31), 5);  // unary limit mod 32
        bw.put_bits((uint64_t)(p.gstar - 4), 3);  // rescale counter - 4
        bw.put_bits((uint64_t)(p.g0 & 7), 3);     // init count exp mod 8
        bw.put_bits((uint64_t)p.K, 4);            // accumulator init K
        bw.put_bits(0, 1);                        // accum init table flag
    } else {
        // entropy coder metadata, block-adaptive (16 bits): block size
        // encoded 00/01/10/11 = 8/16/32/64
        int bsf = p.bJ == 8 ? 0 : p.bJ == 16 ? 1 : p.bJ == 32 ? 2 : 3;
        bw.put_bits(0, 1);                        // reserved
        bw.put_bits((uint64_t)bsf, 2);            // block size
        bw.put_bits(0, 1);                        // restricted code options
        bw.put_bits((uint64_t)(p.bR & 0xFFF), 12);  // ref sample interval
    }
}

bool read_header(BitReader& br, Params& p) {
    br.get_bits(8);
    p.Nx = (int32_t)br.get_bits(16);
    p.Ny = (int32_t)br.get_bits(16);
    p.Nz = (int32_t)br.get_bits(16);
    if (p.Nx == 0) p.Nx = 1 << 16;   // mod-2^16 encoding of the full range
    if (p.Ny == 0) p.Ny = 1 << 16;
    if (p.Nz == 0) p.Nz = 1 << 16;
    p.is_signed = br.get_bits(1) != 0;
    br.get_bits(2);
    p.D = (int)br.get_bits(4);
    if (p.D == 0) p.D = 16;
    bool bsq = br.get_bits(1) == 1;
    int64_t depth = (int64_t)br.get_bits(16);
    if (bsq) {
        p.subM = 0;
    } else {
        if (depth == 0) depth = 1 << 16;      // M mod 2^16 (M in [1, Nz])
        p.subM = (int32_t)std::min<int64_t>(depth, p.Nz);
    }
    br.get_bits(2);
    br.get_bits(3);
    p.ec = (int)br.get_bits(1);               // 0 sample, 1 block-adaptive
    br.get_bits(10);
    br.get_bits(2);
    p.P = (int)br.get_bits(4);
    p.full = br.get_bits(1) == 0;
    br.get_bits(1);
    p.colsum = br.get_bits(1) != 0;
    br.get_bits(1);
    p.R = (int)br.get_bits(6);
    if (p.R == 0) p.R = 64;
    p.Om = (int)br.get_bits(4) + 4;
    p.kappa = (int)br.get_bits(4) + 4;
    p.vmin = (int)br.get_bits(4) - 6;
    p.vmax = (int)br.get_bits(4) - 6;
    br.get_bits(1);
    if (br.get_bits(1) != 0) return false;    // only default weight init
    br.get_bits(1);
    br.get_bits(5);
    if (p.ec == 0) {
        p.Umax = (int)br.get_bits(5);
        if (p.Umax == 0) p.Umax = 32;
        p.gstar = (int)br.get_bits(3) + 4;
        p.g0 = (int)br.get_bits(3);
        if (p.g0 == 0) p.g0 = 8;
        p.K = (int)br.get_bits(4);
        br.get_bits(1);
    } else {
        br.get_bits(1);
        p.bJ = 8 << (int)br.get_bits(2);
        br.get_bits(1);
        p.bR = (int)br.get_bits(12);
        if (p.bR == 0) p.bR = 4096;
    }
    return !br.error;
}

// ---- shared predictor state for one band ----
//
// Encoder and decoder run the IDENTICAL per-sample recurrence; they
// differ only in whether the sample is read (encode) or reconstructed
// from the mapped residual (decode). Lossless, so the "reconstructed"
// plane equals the source plane and feed-forward prediction is exact.

struct BandPredictor {
    const Params& p;
    int z, Pz, C;
    int64_t wmin_, wmax_, lo_, hi_;
    int64_t W[19];        // weights: [dN dW dNW] (full) + central 1..Pz
    int64_t U[19];        // local-difference vector of the current sample
    int64_t sigma = 0, shat = 0, sddr = 0;

    // planes: s_cur/s_prev = sample values as int64-convertible getters
    const int32_t* cdiff_prev[15];  // previous bands' central differences
    int32_t* cdiff_cur;

    BandPredictor(const Params& pp, int zz, int32_t* cd_cur,
                  const int32_t* const* cd_prev)
        : p(pp), z(zz) {
        Pz = std::min(z, p.P);
        C = Pz + (p.full ? 3 : 0);
        wmin_ = -(1ll << (p.Om + 3));
        wmax_ = (1ll << (p.Om + 3)) - 1;
        lo_ = (p.smin() << (p.Om + 2)) + (1ll << (p.Om + 1));
        hi_ = (p.smax() << (p.Om + 2)) + (1ll << (p.Om + 1));
        // default weight initialization (§4.6.3.2): central weight 1 is
        // (7/8)*2^Om, each next an eighth of the previous; directional 0
        int base = p.full ? 3 : 0;
        for (int i = 0; i < base; i++) W[i] = 0;
        int64_t wc = 7ll << (p.Om - 3);
        for (int j = 0; j < Pz; j++) { W[base + j] = wc; wc >>= 3; }
        cdiff_cur = cd_cur;
        for (int j = 0; j < Pz; j++) cdiff_prev[j] = cd_prev[j];
    }

    // prediction for sample t (y,x); prev-row/current-row samples are
    // read through `row` (current band, reconstructed == original).
    // `ci` indexes the central-difference buffers (== t for BSQ full
    // planes, == x for the BI row buffer — differences are only ever
    // read at the CURRENT sample position, never behind it)
    template <class Row>
    void predict(int64_t t, int32_t y, int32_t x, Row&& sample_at,
                 int64_t s_z1_first, int64_t ci) {
        if (t == 0) {
            shat = (z > 0 && p.P > 0) ? s_z1_first : p.smid();
            sddr = 2 * shat;
            return;
        }
        const int32_t Nx = p.Nx;
        if (y == 0) {
            sigma = 4 * sample_at(t - 1);
        } else if (p.colsum) {
            sigma = 4 * sample_at(t - Nx);
        } else if (x == 0) {
            sigma = 2 * (sample_at(t - Nx) + sample_at(t - Nx + 1));
        } else if (x == Nx - 1) {
            sigma = sample_at(t - 1) + sample_at(t - Nx - 1)
                    + 2 * sample_at(t - Nx);
        } else {
            sigma = sample_at(t - 1) + sample_at(t - Nx - 1)
                    + sample_at(t - Nx) + sample_at(t - Nx + 1);
        }
        int ui = 0;
        if (p.full) {
            if (y == 0) {
                U[ui++] = 0; U[ui++] = 0; U[ui++] = 0;
            } else {
                int64_t sN = sample_at(t - Nx);
                U[ui++] = 4 * sN - sigma;                        // d_N
                U[ui++] = 4 * (x > 0 ? sample_at(t - 1) : sN) - sigma;
                U[ui++] = 4 * (x > 0 ? sample_at(t - Nx - 1) : sN) - sigma;
            }
        }
        for (int j = 0; j < Pz; j++) U[ui++] = cdiff_prev[j][ci];
        int64_t dhat = 0;
        for (int i = 0; i < C; i++) dhat += W[i] * U[i];
        int64_t stilde = clampi(
            mod_star(dhat + ((sigma - 4 * p.smid()) << p.Om), p.R)
                + (p.smid() << (p.Om + 2)) + (1ll << (p.Om + 1)),
            lo_, hi_);
        sddr = stilde >> (p.Om + 1);
        shat = sddr >> 1;
    }

    // after the sample value s is known: record the central local
    // difference and update the weights (§4.6.3.3)
    void update(int64_t t, int64_t s, int64_t ci) {
        if (t > 0) cdiff_cur[ci] = (int32_t)(4 * s - sigma);
        else cdiff_cur[ci] = 0;
        if (t == 0) return;
        int64_t e = 2 * s - sddr;
        int64_t step = (t - p.Nx) >> p.kappa;           // floor division
        int rho = (int)clampi(p.vmin + step, p.vmin, p.vmax) + p.D - p.Om;
        int sgn = (e >= 0) ? 1 : -1;
        for (int i = 0; i < C; i++) {
            int64_t su = (int64_t)sgn * U[i];
            int64_t scaled = (rho >= 0) ? (su >> rho) : (su << (-rho));
            W[i] = clampi(W[i] + ((scaled + 1) >> 1), wmin_, wmax_);
        }
    }
};

// mapped-residual transform (§4.8) and inverse
inline uint32_t map_residual(int64_t s, int64_t shat, int64_t sddr,
                             int64_t smin, int64_t smax) {
    int64_t delta = s - shat;
    int64_t theta = std::min(shat - smin, smax - shat);
    int64_t a = delta < 0 ? -delta : delta;
    if (a > theta) return (uint32_t)(a + theta);
    bool even = (sddr & 1) == 0;
    if ((even && delta >= 0) || (!even && delta <= 0))
        return (uint32_t)(2 * a);
    return (uint32_t)(2 * a - 1);
}

inline int64_t unmap_residual(uint32_t mapped, int64_t shat, int64_t sddr,
                              int64_t smin, int64_t smax) {
    int64_t theta = std::min(shat - smin, smax - shat);
    int64_t m = (int64_t)mapped;
    bool even = (sddr & 1) == 0;
    int64_t delta;
    if (m > 2 * theta) {
        int64_t mag = m - theta;
        delta = (smax - shat > theta) ? mag : -mag;
    } else if ((m & 1) == 0) {
        delta = even ? m / 2 : -(m / 2);
    } else {
        delta = even ? -((m + 1) / 2) : (m + 1) / 2;
    }
    return shat + delta;
}

// sample-adaptive GPO2 state (§5.4.3): counter/accumulator per band
struct SampleAdaptive {
    uint64_t cnt, acc;
    int D, Umax, gstar;

    SampleAdaptive(const Params& p) : D(p.D), Umax(p.Umax), gstar(p.gstar) {
        cnt = 1ull << p.g0;
        acc = (((3ull << (p.K + 6)) - 49) * cnt) >> 7;
    }
    inline int select_k() const {
        uint64_t thresh = acc + ((49 * cnt) >> 7);
        int k = 0;
        while (k < D - 2 && (cnt << (k + 1)) <= thresh) k++;
        return (2 * cnt > thresh) ? 0 : k;
    }
    inline void update(uint32_t mapped) {
        if (cnt < (1ull << gstar) - 1) { acc += mapped; cnt += 1; }
        else { acc = (acc + mapped + 1) >> 1; cnt = (cnt + 1) >> 1; }
    }
};

inline void put_gpo2(BitWriter& bw, uint32_t v, int k, int D, int Umax) {
    uint32_t q = v >> k;
    if (q < (uint32_t)Umax) {
        bw.put_zeros(q);
        bw.put_bits(1, 1);
        if (k) bw.put_bits(v, k);
    } else {
        bw.put_zeros(Umax);
        bw.put_bits(v, D);
    }
}

inline uint32_t get_gpo2(BitReader& br, int k, int D, int Umax) {
    uint32_t q = 0;
    while (q < (uint32_t)Umax) {
        if (br.get_bits(1)) return (q << k) | (uint32_t)br.get_bits(k);
        q++;
    }
    return (uint32_t)br.get_bits(D);
}

inline int64_t sample_value(uint16_t raw, bool is_signed) {
    return is_signed ? (int64_t)(int16_t)raw : (int64_t)raw;
}

// One sample through the codec: ENCODE reads the sample and emits its
// mapped residual; decode pulls the residual and reconstructs. Shared so
// the BSQ and BI drivers below cannot drift apart. With ``resid`` set
// (block-adaptive mode, §5.4.2) the mapped residual goes to/comes from
// the residual sequence in encoding order instead of the sample-adaptive
// GPO2 bit codec — entropy is then a separate whole-sequence CCSDS-121
// block-adaptive pass, decoupled from prediction.
template <bool ENCODE, class Bits>
inline int64_t code_sample(const Params& p, Bits& bits, BandPredictor& bp,
                           SampleAdaptive& sa, uint16_t* plane, int64_t t,
                           int64_t smin, int64_t smax, bool& bad,
                           uint16_t* resid, int64_t* rpos) {
    int64_t s;
    if constexpr (ENCODE) {
        s = sample_value(plane[t], p.is_signed);
        uint32_t mapped = map_residual(s, bp.shat, bp.sddr, smin, smax);
        if (resid) {
            resid[(*rpos)++] = (uint16_t)mapped;
        } else if (t == 0) {
            bits.put_bits(mapped, p.D);
        } else {
            put_gpo2(bits, mapped, sa.select_k(), p.D, p.Umax);
            sa.update(mapped);
        }
    } else {
        uint32_t mapped;
        if (resid) {
            mapped = resid[(*rpos)++];
        } else if (t == 0) {
            mapped = (uint32_t)bits.get_bits(p.D);
        } else {
            mapped = get_gpo2(bits, sa.select_k(), p.D, p.Umax);
            sa.update(mapped);
        }
        s = unmap_residual(mapped, bp.shat, bp.sddr, smin, smax);
        if (s < smin || s > smax || (!resid && bits.error)) {
            bad = true;
            return 0;
        }
        plane[t] = (uint16_t)(p.is_signed ? (int16_t)s : s);
    }
    return s;
}

// Band-interleaved driver (§4.2 BI order, sub-frame depth M: M=1 is
// BIL, M=Nz is BIP): every band's predictor + entropy state lives for
// the whole image and advances in lockstep — central differences need
// only an (Nz, Nx) row buffer because they are read solely at the
// current sample position. `plane_of(z)` is the source (encode) or
// destination (decode) BSQ plane of band z.
template <bool ENCODE, class Bits>
bool run_bi(const Params& p, Bits& bits, uint16_t* cube,
            uint16_t* resid = nullptr) {
    const int32_t Nz = p.Nz, Ny = p.Ny, Nx = p.Nx;
    const int64_t NP = (int64_t)Ny * Nx;
    const int64_t smin = p.smin(), smax = p.smax();
    const int M = std::min(std::max(p.subM, 1), Nz);
    int64_t rpos = 0;

    std::vector<int32_t> cdiff_row((size_t)Nz * Nx);
    std::vector<BandPredictor> bps;
    std::vector<SampleAdaptive> sas;
    bps.reserve(Nz);
    sas.reserve(Nz);
    for (int z = 0; z < Nz; z++) {
        const int32_t* prev[15];
        int Pz = std::min(z, p.P);
        for (int j = 0; j < Pz; j++)
            prev[j] = cdiff_row.data() + (size_t)(z - 1 - j) * Nx;
        bps.emplace_back(p, z, cdiff_row.data() + (size_t)z * Nx, prev);
        sas.emplace_back(p);
    }

    const int ngroups = (Nz + M - 1) / M;
    bool bad = false;
    for (int32_t y = 0; y < Ny && !bad; y++) {
        for (int g = 0; g < ngroups && !bad; g++) {
            const int zlo = g * M, zhi = std::min(zlo + M, Nz);
            for (int32_t x = 0; x < Nx && !bad; x++) {
                const int64_t t = (int64_t)y * Nx + x;
                for (int z = zlo; z < zhi; z++) {
                    uint16_t* plane = cube + (size_t)z * NP;
                    auto sample_at = [&](int64_t tt) {
                        return sample_value(plane[tt], p.is_signed);
                    };
                    // band z's t=0 prediction seeds from band z-1's
                    // first sample — under BI order band z-1 is always
                    // coded at (0,0) before band z gets there
                    int64_t s_z1 = (z > 0 && t == 0)
                        ? sample_value(cube[(size_t)(z - 1) * NP],
                                       p.is_signed) : 0;
                    bps[z].predict(t, y, x, sample_at, s_z1, x);
                    int64_t s = code_sample<ENCODE>(
                        p, bits, bps[z], sas[z], plane, t, smin, smax,
                        bad, resid, &rpos);
                    if (bad) break;
                    bps[z].update(t, s, x);
                }
            }
        }
    }
    return !bad;
}

// BSQ driver: one band at a time, (P+1) full central-difference planes
// in a ring (band z reads bands z-1..z-P at positions the previous
// bands finished a whole plane ago).
template <bool ENCODE, class Bits>
bool run_bsq(const Params& p, Bits& bits, uint16_t* cube,
             uint16_t* resid = nullptr) {
    const int32_t Nz = p.Nz, Ny = p.Ny, Nx = p.Nx;
    const int P = p.P;
    const int64_t NP = (int64_t)Ny * Nx;
    const int64_t smin = p.smin(), smax = p.smax();
    int64_t rpos = 0;

    std::vector<int32_t> cdiff((size_t)(P + 1) * NP);
    std::vector<int32_t*> ring;
    for (int j = 0; j <= P; j++)
        ring.push_back(cdiff.data() + (size_t)j * NP);

    bool bad = false;
    for (int z = 0; z < Nz && !bad; z++) {
        uint16_t* plane = cube + (size_t)z * NP;
        const int32_t* prev[15];
        int Pz = std::min(z, P);
        for (int j = 0; j < Pz; j++)
            prev[j] = ring[(z - 1 - j) % (P + 1)];
        BandPredictor bp(p, z, ring[P > 0 ? z % (P + 1) : 0], prev);
        SampleAdaptive sa(p);
        int64_t s_z1 = z > 0
            ? sample_value(cube[(size_t)(z - 1) * NP], p.is_signed) : 0;
        auto sample_at = [&](int64_t t) {
            return sample_value(plane[t], p.is_signed);
        };
        int64_t t = 0;
        for (int32_t y = 0; y < Ny && !bad; y++) {
            for (int32_t x = 0; x < Nx; x++, t++) {
                bp.predict(t, y, x, sample_at, s_z1, t);
                int64_t s = code_sample<ENCODE>(p, bits, bp, sa, plane, t,
                                                smin, smax, bad, resid,
                                                &rpos);
                if (bad) break;
                bp.update(t, s, t);
            }
        }
    }
    return !bad;
}

}  // namespace

// CCSDS-121 block-adaptive coder (same shared library, ccsds121.cpp):
// the §5.4.2 block-adaptive entropy option IS this coder applied to the
// mapped residual sequence with no preprocessor.
extern "C" int64_t ck121_encode(const uint16_t* in, int64_t n, int bits,
                                int block_size, int rsi, int flags,
                                uint8_t* out, int64_t out_cap);
extern "C" int64_t ck121_decode(const uint8_t* in, int64_t nbytes,
                                int bits, int block_size, int rsi,
                                int flags, uint16_t* out, int64_t n);

extern "C" {

// Encode a BSQ-laid-out (Nz, Ny, Nx) cube of uint16-viewed samples.
// `subframe` selects the ENCODING order (§4.2): 0 = BSQ, otherwise
// band-interleaved with sub-frame depth M (1 = BIL, Nz = BIP).
// `block_adaptive` selects the §5.4.2 entropy option (CCSDS-121 block
// coder over the residual sequence; needs D >= 5). Returns the stream
// byte count, or -1 on overflow / bad parameters.
long long ck123std_encode(const uint16_t* cube, int32_t Nz, int32_t Ny,
                          int32_t Nx, int32_t D, int32_t is_signed,
                          int32_t P, int32_t full_mode, int32_t colsum,
                          int32_t subframe, int32_t block_adaptive,
                          uint8_t* out, long long cap) {
    if (Nz <= 0 || Ny <= 0 || Nx <= 0 || D < 2 || D > 16 || P < 0 ||
        P > 15 || subframe < 0 || subframe > Nz)
        return -1;
    if (block_adaptive && D < 5)
        return -1;                 // the 121 coder's minimum sample size
    Params p;
    p.Nx = Nx; p.Ny = Ny; p.Nz = Nz; p.D = D;
    p.is_signed = is_signed != 0;
    p.P = P; p.full = full_mode != 0; p.colsum = colsum != 0;
    p.subM = subframe;
    p.ec = block_adaptive ? 1 : 0;

    BitWriter bw(out, cap);
    write_header(bw, p);
    uint16_t* cc = const_cast<uint16_t*>(cube);
    if (p.ec == 1) {
        const int64_t total = (int64_t)Nz * Ny * Nx;
        // the 121 block coder consumes whole blocks: zero-pad the final
        // one (the standard's fill convention; the decoder knows the
        // true sample count from the image geometry)
        const int64_t padded = (total + p.bJ - 1) / p.bJ * p.bJ;
        std::vector<uint16_t> resid((size_t)padded, 0);
        bool ok = p.subM > 0 ? run_bi<true>(p, bw, cc, resid.data())
                             : run_bsq<true>(p, bw, cc, resid.data());
        if (!ok || bw.overflow) return -1;
        int64_t hdr = bw.bytes();              // header is whole bytes
        int64_t body = ck121_encode(resid.data(), padded, p.D, p.bJ, p.bR,
                                    /*flags=*/0, out + hdr, cap - hdr);
        return body < 0 ? -1 : hdr + body;
    }
    bool ok = p.subM > 0 ? run_bi<true>(p, bw, cc)
                         : run_bsq<true>(p, bw, cc);
    int64_t n = bw.bytes();
    return (!ok || bw.overflow) ? -1 : n;
}

// Parse only the header: fills info[0..10] with Nz, Ny, Nx, D, signed,
// P, full, colsum, Umax, subframe depth (0 = BSQ), entropy coder
// (0 sample-adaptive, 1 block-adaptive). Returns 0 on success.
long long ck123std_info(const uint8_t* in, long long nbytes,
                        int32_t* info) {
    BitReader br(in, nbytes);
    Params p;
    p.Nx = p.Ny = p.Nz = 0;
    if (!read_header(br, p)) return -1;
    info[0] = p.Nz; info[1] = p.Ny; info[2] = p.Nx; info[3] = p.D;
    info[4] = p.is_signed ? 1 : 0; info[5] = p.P;
    info[6] = p.full ? 1 : 0; info[7] = p.colsum ? 1 : 0;
    info[8] = p.Umax; info[9] = p.subM; info[10] = p.ec;
    return 0;
}

// Decode a stream produced by ck123std_encode (either encoding order)
// into a BSQ uint16-viewed cube. Returns the sample count, or -1.
long long ck123std_decode(const uint8_t* in, long long nbytes,
                          uint16_t* out, long long cap_samples) {
    BitReader br(in, nbytes);
    Params p;
    if (!read_header(br, p)) return -1;
    const int64_t total = (int64_t)p.Ny * p.Nx * p.Nz;
    if (total > cap_samples) return -1;
    if (p.ec == 1) {
        // block-adaptive: entropy is a whole-sequence 121 pass decoupled
        // from prediction — decode the residual sequence first, then run
        // the predictor-driven reconstruction consuming it in order
        const int64_t hdr = 19;                // §5.3 header, whole bytes
        if (nbytes <= hdr) return -1;
        const int64_t padded = (total + p.bJ - 1) / p.bJ * p.bJ;
        std::vector<uint16_t> resid((size_t)padded);
        if (ck121_decode(in + hdr, nbytes - hdr, p.D, p.bJ, p.bR, 0,
                         resid.data(), padded) < 0)
            return -1;
        bool ok = p.subM > 0 ? run_bi<false>(p, br, out, resid.data())
                             : run_bsq<false>(p, br, out, resid.data());
        return ok ? total : -1;
    }
    bool ok = p.subM > 0 ? run_bi<false>(p, br, out)
                         : run_bsq<false>(p, br, out);
    return ok ? total : -1;
}

}  // extern "C"
