// CCSDS 121.0-B — block-adaptive (Rice/GPO2) lossless entropy coder.
//
// Clean-room implementation of the standard's preprocessor + block-adaptive
// entropy coder, bit-compatible with libaec's stream format (validated in
// tests/test_ccsds121.py against the system libaec, which is what the
// reference pipeline invokes through the `aec` CLI —
// reference tools/codecs/ccsds121/ccsds121_wrap.py:129-136).
//
// Supported here: unsigned samples, 4 < bits <= 16 (and bits<=8 with 3-bit
// IDs), PREPROCESS on/off, any block size J in {8,16,32,64}, any RSI.
// This C++ path is the host-side packer/decoder; the per-block option
// modeling also runs on TPU (tpukit/codecs/ccsds121.py) and must agree
// bit-for-bit with the encoder below.

#include <cstdint>
#include <cstring>
#include <vector>
#ifdef __SSE2__
#include <immintrin.h>
#endif
#include "bitio.hpp"

using namespace tpukit;

namespace {

constexpr int FLAG_SIGNED = 1;      // AEC_DATA_SIGNED (not used by reference)
constexpr int FLAG_PREPROCESS = 8;  // AEC_DATA_PREPROCESS
constexpr int SEGMENT_BLOCKS = 64;  // zero-run segment length

inline int id_len_for_bits(int bits) {
    if (bits > 16) return 5;
    if (bits > 8) return 4;
    if (bits > 4) return 3;
    return 2;
}

struct Params {
    int bits;
    int J;       // block size
    int rsi;     // blocks per reference sample interval
    bool preprocess;
    int id_len;
    int kmax;    // max split-sample k
    uint32_t xmax;
};

Params make_params(int bits, int block_size, int rsi, int flags) {
    Params p;
    p.bits = bits;
    p.J = block_size;
    p.rsi = rsi;
    p.preprocess = (flags & FLAG_PREPROCESS) != 0;
    p.id_len = id_len_for_bits(bits);
    p.kmax = (1 << p.id_len) - 3;
    p.xmax = (bits >= 32) ? 0xFFFFFFFFu : ((1u << bits) - 1u);
    return p;
}

// Standard unit-delay predictor + residual mapping (CCSDS 121.0-B-3 §3):
// d = 2Δ (0<=Δ<=θ), 2|Δ|-1 (-θ<=Δ<0), θ+|Δ| otherwise, θ=min(pred, xmax-pred).
inline uint32_t map_residual(uint32_t x, uint32_t pred, uint32_t xmax) {
    int32_t delta = (int32_t)x - (int32_t)pred;
    uint32_t theta = pred < (xmax - pred) ? pred : (xmax - pred);
    uint32_t neg = (uint32_t)(delta < 0);
    uint32_t absd = (uint32_t)(neg ? -delta : delta);
    // 2|Δ|-neg inside the θ zone; θ+|Δ| outside (branchless-friendly)
    return absd <= theta ? (2 * absd - neg) : (theta + absd);
}

inline uint32_t unmap_residual(uint32_t d, uint32_t pred, uint32_t xmax) {
    uint32_t theta = pred < (xmax - pred) ? pred : (xmax - pred);
    int32_t delta;
    if (__builtin_expect(d <= 2 * theta, 1)) {
        // branchless zig-zag: odd d -> -(d+1)/2, even d -> d/2
        delta = (int32_t)((d >> 1) ^ (0u - (d & 1u)));
    } else {
        uint32_t mag = d - theta;
        // sign disambiguated by which side saturates
        // (theta=pred → neg side exhausted)
        delta = (pred < xmax - pred) ? (int32_t)mag : -(int32_t)mag;
    }
    return (uint32_t)((int32_t)pred + delta);
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

// Stateful split-k search, mirroring libaec's assess_splitting_option:
// start from the previous block's k, climb while the CDS length strictly
// improves, then turn around once from (k_prev - 1) downward. The length
// function is unimodal in k (Kiely, IPN PR 42-159), so this finds the
// minimum; on ties the first-evaluated k wins, which is why the search
// *order* (and the carried k state) matters for bit-exactness.
// sum of (d[i] >> k) over the coded samples; SSE2 for the standard J=8
// block (sums fit 32 bits: 8 samples of <= 2^17 each)
static inline uint64_t fs_len_at(const uint32_t* d, int start, int J,
                                 int k) {
#ifdef __SSE2__
    if (J == 8) {
        const __m128i sh = _mm_cvtsi32_si128(k);
        __m128i a = _mm_srl_epi32(_mm_loadu_si128((const __m128i*)d), sh);
        __m128i b = _mm_srl_epi32(_mm_loadu_si128((const __m128i*)(d + 4)),
                                  sh);
        if (start == 1)
            a = _mm_and_si128(a, _mm_setr_epi32(0, -1, -1, -1));
        __m128i s = _mm_add_epi32(a, b);
        s = _mm_add_epi32(s, _mm_srli_si128(s, 8));
        s = _mm_add_epi32(s, _mm_srli_si128(s, 4));
        return (uint32_t)_mm_cvtsi128_si32(s);
    }
#endif
    uint64_t f = 0;
    for (int i = start; i < J; ++i) f += d[i] >> k;
    return f;
}

static int assess_split(const uint32_t* d, int start, int J, int kmax,
                        int& k_state, uint64_t& out_len) {
    const int this_bs = J - start;
    uint64_t len_min = UINT64_MAX;
    int k = k_state;
    int k_min = k;
    bool no_turn = (k == 0);
    bool dir = true;  // increasing k
    for (;;) {
        uint64_t fs_len = fs_len_at(d, start, J, k);
        uint64_t len = fs_len + (uint64_t)this_bs * (k + 1);
        if (len < len_min) {
            if (len_min != UINT64_MAX) no_turn = true;
            len_min = len;
            k_min = k;
            if (dir) {
                if (fs_len < (uint64_t)this_bs || k >= kmax) {
                    if (no_turn) break;
                    k = k_state - 1;
                    dir = false;
                } else {
                    ++k;
                }
            } else {
                if (k == 0) break;
                --k;
            }
        } else {
            if (no_turn) break;
            k = k_state - 1;
            dir = false;
            no_turn = true;
        }
        if (k < 0) break;
    }
    k_state = k_min;
    out_len = len_min;
    return k_min;
}

// Emit one non-zero block with the cheapest option.
// d: J mapped samples (d[0] is the *raw reference* if ref==true).
void emit_block(BitWriter& bw, const uint32_t* d, const Params& p, bool ref,
                int& k_state) {
    const int J = p.J;
    const int start = ref ? 1 : 0;  // samples entropy-coded
    const int m = J - start;

    uint64_t best_cost;
    int best_k = assess_split(d, start, J, p.kmax, k_state, best_cost);
    uint64_t nc_cost = (uint64_t)m * p.bits;  // no-compression

    // Second extension (validated bit-exact against libaec): pairs are
    // (d0,d1)(d2,d3)... with γ = (a+b)(a+b+1)/2 + b; in reference blocks
    // the slot-0 element is zero, i.e. the first pair is (0, d1).
    // Decision-equivalent early exit: c only grows, so once it can no
    // longer win (se wins iff se <= best AND se < nc) the gammas are
    // never emitted and the scan stops. Stack storage: J <= 64 -> <= 32
    // pairs (a heap vector here costs an allocation per block).
    uint64_t se_cost = UINT64_MAX;
    uint32_t gammas[32];
    int ngam = 0;
    if ((J % 2) == 0 && J <= 64) {
        const uint64_t lose = best_cost < nc_cost ? best_cost + 1 : nc_cost;
        bool ok = true;
        uint64_t c = 1;  // the extra low-entropy selector bit
        for (int i = 0; i + 1 < J; i += 2) {
            uint64_t a = (ref && i == 0) ? 0 : d[i];
            uint64_t s = a + d[i + 1];
            uint64_t g = s * (s + 1) / 2 + d[i + 1];
            if (g > (1u << 30)) { ok = false; break; }
            gammas[ngam++] = (uint32_t)g;
            c += g + 1;
            if (c >= lose) { ok = false; break; }
        }
        if (ok) se_cost = c;
    }

    if (se_cost <= best_cost && se_cost < nc_cost) {
        // low-entropy ID (all zeros, id_len bits) + '1' selector
        bw.put_bits(0, p.id_len);
        bw.put_bits(1, 1);
        if (ref) bw.put_bits(d[0], p.bits);
        for (int i = 0; i < ngam; ++i) bw.put_fs(gammas[i]);
    } else if (best_cost < nc_cost) {
        int k = best_k;
        bw.put_bits((uint64_t)(k + 1), p.id_len);
        if (ref) bw.put_bits(d[0], p.bits);
        // batch the FS codes (z zeros + a 1) into <= 56-bit words
        {
            uint64_t acc = 0;
            int nb = 0;
            for (int i = start; i < J; ++i) {
                uint32_t z = d[i] >> k;
                if (nb + (int64_t)z + 1 > 56) {
                    if (nb) { bw.put_bits(acc, nb); acc = 0; nb = 0; }
                    if (z + 1 > 56) { bw.put_fs(z); continue; }
                }
                acc = (acc << (z + 1)) | 1;
                nb += (int)z + 1;
            }
            if (nb) bw.put_bits(acc, nb);
        }
        if (k > 0) {
            // batch the split LSB fields the same way
            const uint32_t mk = (1u << k) - 1;
            const int per = 56 / k;
            int i = start;
            while (i < J) {
                int g = J - i < per ? J - i : per;
                uint64_t v = 0;
                for (int j = 0; j < g; ++j, ++i)
                    v = (v << k) | (d[i] & mk);
                bw.put_bits(v, g * k);
            }
        }
    } else {
        // no compression: ID all-ones + the J preprocessed samples
        // (slot 0 holds the raw reference in ref blocks), n bits each
        bw.put_bits((1u << p.id_len) - 1, p.id_len);
        for (int i = 0; i < J; ++i) bw.put_bits(d[i], p.bits);
    }
}

// Emit a zero-run marker: run of z zero blocks; `ros` when the run reached
// the end of a 64-block segment (and more data follows semantics per std).
void emit_zero_run(BitWriter& bw, int z, bool ros, const Params& p) {
    bw.put_bits(0, p.id_len);
    bw.put_bits(0, 1);  // low-entropy selector: 0 = zero-block
    if (ros) bw.put_fs(4);
    else if (z <= 4) bw.put_fs((uint32_t)(z - 1));
    else bw.put_fs((uint32_t)z);
}

}  // namespace

namespace {

// Encode a whole stream (or a chunk starting at an RSI boundary, with the
// split-k state carried in from the previous chunk). Returns the exact BIT
// length of the emitted codewords (the buffer is flushed with zero padding
// to a byte boundary, so chunks can be OR-spliced at arbitrary bit offsets).
int64_t encode_core(const uint16_t* in, int64_t n, const Params& p,
                    int k_state_init, uint8_t* out, int64_t out_cap) {
    const int J = p.J;
    if (n % J != 0) return -2;  // framework guarantees whole blocks
    int64_t nblocks = n / J;
    BitWriter bw(out, out_cap);

    std::vector<uint32_t> d(J);
    int k_state = k_state_init;  // split-k carried across blocks
    // zero-run state
    int zrun = 0;
    bool zrun_has_ref = false;
    uint32_t zref = 0;

    auto flush_zero_run = [&](bool ros) {
        if (zrun == 0) return;
        if (zrun_has_ref) {
            // ref emitted before the zero-run marker
            bw.put_bits(0, p.id_len);
            bw.put_bits(0, 1);
            bw.put_bits(zref, p.bits);
            if (ros) bw.put_fs(4);
            else if (zrun <= 4) bw.put_fs((uint32_t)(zrun - 1));
            else bw.put_fs((uint32_t)zrun);
        } else {
            emit_zero_run(bw, zrun, ros, p);
        }
        zrun = 0;
        zrun_has_ref = false;
    };

    uint32_t prev = 0;
#ifdef __AVX2__
    // vectorized unit-delay mapping for the standard J=8 block: the
    // predictor of lane i is lane i-1 (lane 0 takes the carried prev), so
    // one rotate + insert yields all eight predictors and map_residual
    // becomes eight branchless lanes (exact same arithmetic as the scalar
    // path; values <= 2^16 so signed compares are safe)
    const __m256i kROT = _mm256_setr_epi32(7, 0, 1, 2, 3, 4, 5, 6);
    const __m256i kXMAX = _mm256_set1_epi32((int)p.xmax);
#endif
    for (int64_t b = 0; b < nblocks; ++b) {
        bool new_rsi = p.preprocess && (b % p.rsi == 0);
        const uint16_t* x = in + b * J;
        bool ref = new_rsi;
        bool allzero = true;
#ifdef __AVX2__
        if (J == 8 && p.preprocess) {
            __m256i xv = _mm256_cvtepu16_epi32(
                _mm_loadu_si128((const __m128i*)x));
            __m256i pv = _mm256_insert_epi32(
                _mm256_permutevar8x32_epi32(xv, kROT), (int)prev, 0);
            __m256i delta = _mm256_sub_epi32(xv, pv);
            __m256i theta = _mm256_min_epu32(pv,
                                             _mm256_sub_epi32(kXMAX, pv));
            __m256i negm = _mm256_cmpgt_epi32(_mm256_setzero_si256(),
                                              delta);
            __m256i absd = _mm256_abs_epi32(delta);
            __m256i over = _mm256_cmpgt_epi32(absd, theta);
            __m256i dv = _mm256_blendv_epi8(
                _mm256_add_epi32(_mm256_slli_epi32(absd, 1), negm),
                _mm256_add_epi32(theta, absd), over);
            if (ref) dv = _mm256_insert_epi32(dv, (int)(uint32_t)x[0], 0);
            _mm256_storeu_si256((__m256i*)d.data(), dv);
            prev = x[7];
            __m256i t = ref ? _mm256_insert_epi32(dv, 0, 0) : dv;
            allzero = _mm256_testz_si256(t, t) != 0;
        } else
#endif
        for (int i = 0; i < J; ++i) {
            uint32_t xi = x[i];
            if (!p.preprocess) {
                d[i] = xi;
            } else if (ref && i == 0) {
                d[i] = xi;  // raw reference sample
            } else {
                d[i] = map_residual(xi, prev, p.xmax);
            }
            prev = xi;
            if (d[i] != 0 && !(ref && i == 0)) allzero = false;
        }
        if (allzero) {
            if (ref) {
                // a reference block cannot join a previous run
                flush_zero_run(false);
                zrun = 1;
                zrun_has_ref = true;
                zref = d[0];
            } else {
                ++zrun;
            }
        } else {
            flush_zero_run(false);
            emit_block(bw, d.data(), p, ref, k_state);
        }
        // libaec buffers and encodes data in RSI chunks (preprocessing or
        // not), with 64-block zero-run segments *within* each chunk. A run
        // flushed at a segment/RSI end uses the ROS codeword when longer
        // than 4 blocks.
        int rsi_rel = (int)(b % p.rsi);
        bool seg_end = (rsi_rel + 1 == p.rsi) || ((rsi_rel + 1) % SEGMENT_BLOCKS == 0);
        if (seg_end) flush_zero_run(zrun > 4);
    }
    // end of data terminates the last (possibly short) RSI chunk, which is
    // a segment end for ROS purposes
    flush_zero_run(zrun > 4);
    if (bw.overflow) return -3;
    int64_t nbits = bw.bitpos_now();
    int64_t used = bw.bytes();  // flush (zero padding)
    if (bw.overflow) return -3;
    // zero splice slack: ck121_splice shifts through up to 8 bytes past a
    // chunk's last data byte (the buffer is no longer pre-zeroed)
    int64_t tail = out_cap - used < 16 ? out_cap - used : 16;
    if (tail > 0) std::memset(out + used, 0, (size_t)tail);
    return nbits;
}

}  // namespace

extern "C" int64_t ck121_encode(const uint16_t* in, int64_t n, int bits,
                                int block_size, int rsi, int flags,
                                uint8_t* out, int64_t out_cap) {
    if (bits < 5 || bits > 16 || n <= 0) return -1;
    Params p = make_params(bits, block_size, rsi, flags);
    int64_t nbits = encode_core(in, n, p, 0, out, out_cap);
    if (nbits < 0) return nbits;
    return (nbits + 7) / 8;
}

// Fused deadzone quantize + zigzag + CCSDS-121 encode: the J2K Rice
// backend's host path (wavelet_common.wenc_quant_encode_ck) in ONE pass.
// qc[i] = (int32)(coefs[i] * (inv_steps[i] * inv_base)) — the same f32
// association order as the device requantizer — with wraparound sum /
// sum-of-squares checksums accumulated in-pass; the zigzag
// z = (q << 1) ^ (q >> 31) feeds encode_core (nbit=16, no preprocessing).
// Block config is picked by the shared sparsity rule (nnz*32 < n selects
// the sparse (J2, rsi2) config — mirrored exactly by the device size
// model); sums_out[2] reports the choice (1 = sparse). Returns byte
// length, or -3 when some qc falls outside int16 (the caller falls back
// to the embedded bit-plane backend).
extern "C" int64_t ck121_quant_encode(const float* coefs,
                                      const float* inv_steps,
                                      float inv_base, int32_t* qc,
                                      int64_t n, int block_size, int rsi,
                                      int block2, int rsi2,
                                      uint8_t* out, int64_t out_cap,
                                      uint32_t* sums_out) {
    if (n <= 0) return -1;
    std::vector<uint16_t> z((size_t)n);
    uint32_t s1 = 0, s2 = 0;
    int64_t i = 0;
    int32_t qmin = 0, qmax = 0;
#ifdef __AVX2__
    {
        const __m256 ib = _mm256_set1_ps(inv_base);
        __m256i a1 = _mm256_setzero_si256(), a2 = _mm256_setzero_si256();
        __m256i mn = _mm256_setzero_si256(), mx = _mm256_setzero_si256();
        for (; i + 8 <= n; i += 8) {
            __m256 st = _mm256_mul_ps(_mm256_loadu_ps(inv_steps + i), ib);
            __m256 c = _mm256_mul_ps(_mm256_loadu_ps(coefs + i), st);
            __m256i q = _mm256_cvttps_epi32(c);
            _mm256_storeu_si256((__m256i*)(qc + i), q);
            a1 = _mm256_add_epi32(a1, q);
            a2 = _mm256_add_epi32(a2, _mm256_mullo_epi32(q, q));
            mn = _mm256_min_epi32(mn, q);
            mx = _mm256_max_epi32(mx, q);
            __m256i zz = _mm256_xor_si256(_mm256_slli_epi32(q, 1),
                                          _mm256_srai_epi32(q, 31));
            __m128i z16 = _mm_packus_epi32(
                _mm256_castsi256_si128(
                    _mm256_and_si256(zz, _mm256_set1_epi32(0xFFFF))),
                _mm256_extracti128_si256(
                    _mm256_and_si256(zz, _mm256_set1_epi32(0xFFFF)), 1));
            _mm_storeu_si128((__m128i*)&z[(size_t)i], z16);
        }
        alignas(32) int32_t t[8];
        alignas(32) uint32_t u1[8], u2[8];
        _mm256_storeu_si256((__m256i*)u1, a1);
        _mm256_storeu_si256((__m256i*)u2, a2);
        for (int j = 0; j < 8; ++j) { s1 += u1[j]; s2 += u2[j]; }
        _mm256_storeu_si256((__m256i*)t, mn);
        for (int j = 0; j < 8; ++j) qmin = t[j] < qmin ? t[j] : qmin;
        _mm256_storeu_si256((__m256i*)t, mx);
        for (int j = 0; j < 8; ++j) qmax = t[j] > qmax ? t[j] : qmax;
    }
#endif
    for (; i < n; ++i) {
        float st = inv_steps[i] * inv_base;
        int32_t q = (int32_t)(coefs[i] * st);
        qc[i] = q;
        s1 += (uint32_t)q;
        s2 += (uint32_t)q * (uint32_t)q;
        qmin = q < qmin ? q : qmin;
        qmax = q > qmax ? q : qmax;
        z[(size_t)i] = (uint16_t)(((uint32_t)q << 1) ^
                                  (uint32_t)(q >> 31));
    }
    int64_t nnz = 0;
    for (int64_t j = 0; j < n; ++j) nnz += (qc[j] != 0);
    const bool sparse = (block2 > 0) && (nnz * 32 < n);
    if (sums_out) {
        sums_out[0] = s1;
        sums_out[1] = s2;
        sums_out[2] = sparse ? 1u : 0u;
    }
    if (qmin < -32768 || qmax > 32767) return -3;
    Params p = make_params(16, sparse ? block2 : block_size,
                           sparse ? rsi2 : rsi, 0);
    int64_t nbits = encode_core(z.data(), n, p, 0, out, out_cap);
    // -3 is reserved for the int16-overflow fallback signal; a bitwriter
    // overflow (undersized out_cap) must stay a LOUD error, never a
    // silent backend switch that would break model==coder agreement
    if (nbits < 0) return -4;
    return (nbits + 7) / 8;
}

// Encode one chunk of a device-planned parallel encode: the chunk must
// start at a reference-sample-interval boundary (the predictor restarts
// there, so the only inter-chunk coupling is the split-k search state,
// which the TPU-side plan supplies — tpukit/codecs/ccsds121.py
// encode_plan). Returns the exact BIT length.
extern "C" int64_t ck121_encode_seg(const uint16_t* in, int64_t n, int bits,
                                    int block_size, int rsi, int flags,
                                    int k_in, uint8_t* out, int64_t out_cap) {
    if (bits < 5 || bits > 16 || n <= 0) return -1;
    Params p = make_params(bits, block_size, rsi, flags);
    if (k_in < 0 || k_in > p.kmax) return -7;
    return encode_core(in, n, p, k_in, out, out_cap);
}

// OR-splice `nbits` MSB-first bits of `src` (starting at src bit 0) into
// `dst` starting at bit `bit_off`. Word-batched. Trailing bits of src's
// last byte must be zero (encode_core zero-pads), destination bits in the
// spliced range must be zero beforehand (callers memset), and `dst` needs
// 8 bytes of slack past the spliced region. All writes OR, so splices of
// adjacent chunks compose in any order — but not concurrently (the shared
// boundary byte is a plain read-modify-write).
extern "C" void ck121_splice(uint8_t* dst, int64_t bit_off,
                             const uint8_t* src, int64_t nbits) {
    if (nbits <= 0) return;
    int64_t nbytes = (nbits + 7) >> 3;
    uint8_t* d = dst + (bit_off >> 3);
    const int sh = (int)(bit_off & 7);
    if (sh == 0) {
        // byte-aligned: first/last bytes may be shared with neighbors
        d[0] |= src[0];
        if (nbytes > 2) std::memcpy(d + 1, src + 1, (size_t)(nbytes - 2));
        if (nbytes > 1) d[nbytes - 1] |= src[nbytes - 1];
        return;
    }
    int64_t i = 0;
    for (; i + 8 <= nbytes; i += 8) {
        uint64_t v;
        std::memcpy(&v, src + i, 8);
        v = __builtin_bswap64(v);          // MSB-first bit order
        uint64_t cur;
        std::memcpy(&cur, d + i, 8);
        cur = __builtin_bswap64(cur);
        cur |= v >> sh;
        cur = __builtin_bswap64(cur);
        std::memcpy(d + i, &cur, 8);
        d[i + 8] |= (uint8_t)(v << (8 - sh));  // low sh bits carry over
    }
    for (; i < nbytes; ++i) {
        d[i] |= (uint8_t)(src[i] >> sh);
        d[i + 1] |= (uint8_t)(src[i] << (8 - sh));
    }
}

static int64_t decode_stream(BitReader& br, const Params& p,
                             uint16_t* out, int64_t n) {
    const int J = p.J;
    if (n % J != 0) return -2;
    int64_t nblocks = n / J;

    std::vector<uint32_t> d(J);
    uint32_t prev = 0;
    int64_t b = 0;

    auto unpreprocess_block = [&](bool ref) {
        uint16_t* x = out + b * J;
        for (int i = 0; i < J; ++i) {
            uint32_t xi;
            if (!p.preprocess) xi = d[i];
            else if (ref && i == 0) xi = d[i];
            else xi = unmap_residual(d[i], prev, p.xmax);
            x[i] = (uint16_t)xi;
            prev = xi;
        }
    };

    while (b < nblocks) {
        bool ref = p.preprocess && (b % p.rsi == 0);
        uint32_t id = (uint32_t)br.get_bits(p.id_len);
        if (br.error) return -5;
        if (id == 0) {
            uint32_t sel = (uint32_t)br.get_bits(1);
            if (sel == 0) {
                // zero-block run
                uint32_t zref = 0;
                if (ref) zref = (uint32_t)br.get_bits(p.bits);
                uint32_t fs = br.get_fs();
                int run;
                int seg_pos = (int)((b % p.rsi) % SEGMENT_BLOCKS);
                if (fs == 4) run = SEGMENT_BLOCKS - seg_pos;  // ROS
                else if (fs < 4) run = (int)fs + 1;
                else run = (int)fs;
                // runs never cross an RSI boundary (encoder flushes
                // there); also clamp to the remaining blocks so a corrupt
                // or truncated stream cannot run the fill past `out`
                {
                    int to_rsi_end = p.rsi - (int)(b % p.rsi);
                    if (run > to_rsi_end) run = to_rsi_end;
                    if ((int64_t)run > nblocks - b) run = (int)(nblocks - b);
                }
                for (int i = 0; i < J; ++i) d[i] = 0;
                if (ref) d[0] = zref;
                unpreprocess_block(ref);
                ++b;
                if (run > 1) {
                    // zero residuals decode to a constant run: with
                    // preprocessing unmap(0, prev) == prev for every
                    // sample; without, plain zeros — fill the whole run
                    // in one pass (runs never span an RSI boundary: the
                    // clamp above enforces it)
                    const uint16_t fill = p.preprocess ? (uint16_t)prev : 0;
                    std::fill(out + b * J, out + (b + run - 1) * J, fill);
                    b += run - 1;
                }
            } else {
                // second extension (pairing as in emit_block)
                uint32_t zref = 0;
                if (ref) zref = (uint32_t)br.get_bits(p.bits);
                int npairs = J / 2;
                auto unpair = [&](uint32_t g, uint32_t& a, uint32_t& bq) {
                    uint64_t s = 0;
                    while ((s + 1) * (s + 2) / 2 <= g) ++s;
                    uint64_t base = s * (s + 1) / 2;
                    bq = (uint32_t)(g - base);
                    a = (uint32_t)(s - bq);
                };
                uint32_t gs[32];            // J <= 64 -> npairs <= 32
                br.get_fs_multi(gs, npairs);
                for (int i = 0; i < npairs; ++i) {
                    uint32_t a, bq;
                    unpair(gs[i], a, bq);
                    d[2 * i] = a; d[2 * i + 1] = bq;
                }
                if (ref) d[0] = zref;  // first pair was (0, d1)
                unpreprocess_block(ref);
                ++b;
            }
        } else if (id == (uint32_t)((1 << p.id_len) - 1)) {
            // no compression: J preprocessed samples, n bits each
            for (int i = 0; i < J; ++i) d[i] = (uint32_t)br.get_bits(p.bits);
            unpreprocess_block(ref);
            ++b;
        } else {
            int k = (int)id - 1;
            uint32_t zref = 0;
            if (ref) zref = (uint32_t)br.get_bits(p.bits);
            int start = ref ? 1 : 0;
            // all FS prefixes of the block in one windowed CLZ scan (the
            // common case fits a single refill), then the split LSB fields
            // batched into as few windowed reads as fit (≤ 56 bits each:
            // 3 reads instead of 16 for J=16)
            br.get_fs_multi(d.data() + start, J - start);
            if (k > 0) {
                const uint32_t mk = (1u << k) - 1;
                const int per = 56 / k;          // samples per read (k<=16)
                int i = start;
                while (i < J) {
                    int g = J - i < per ? J - i : per;
                    uint64_t v = br.get_bits(g * k);
                    for (int j = g - 1; j >= 0; --j, ++i)
                        d[i] = (d[i] << k) | ((uint32_t)(v >> (j * k)) & mk);
                }
            }
            if (ref) d[0] = zref;
            unpreprocess_block(ref);
            ++b;
        }
        if (br.error) return -6;
    }
    return b * J;
}

extern "C" int64_t ck121_decode(const uint8_t* in, int64_t nbytes, int bits,
                                int block_size, int rsi, int flags,
                                uint16_t* out, int64_t n) {
    // J outside the standard's {8,16,32,64} would overflow the fixed
    // per-block gs[] buffers in the SE path — reject like bits
    if (bits < 5 || bits > 16 || n <= 0 || rsi < 1 ||
        !(block_size == 8 || block_size == 16 || block_size == 32 ||
          block_size == 64))
        return -1;
    Params p = make_params(bits, block_size, rsi, flags);
    BitReader br(in, nbytes);
    return decode_stream(br, p, out, n);
}

// Decode a chunk starting at an arbitrary BIT offset. Valid whenever the
// offset is an encode_plan chunk boundary: chunks begin at reference-sample
// intervals, so the first sample is absolute and the block/RSI phase is
// zero — no cross-chunk state exists on the decode side (the split-k
// search state is an encoder-only concern; every block id is in-stream).
// This is what makes PARALLEL decode possible for a stream that stays
// byte-identical to libaec's (reference ccsds121_wrap.py:129-136 shells
// out to the strictly serial `aec` for both directions).
extern "C" int64_t ck121_decode_seg(const uint8_t* in, int64_t nbytes,
                                    int64_t bit_off, int bits,
                                    int block_size, int rsi, int flags,
                                    uint16_t* out, int64_t n) {
    if (bits < 5 || bits > 16 || n <= 0 || bit_off < 0 || rsi < 1 ||
        !(block_size == 8 || block_size == 16 || block_size == 32 ||
          block_size == 64))
        return -1;
    Params p = make_params(bits, block_size, rsi, flags);
    int64_t byte0 = bit_off >> 3;
    if (byte0 >= nbytes) return -7;
    BitReader br(in + byte0, nbytes - byte0);
    int skip = (int)(bit_off & 7);
    if (skip) (void)br.get_bits(skip);
    return decode_stream(br, p, out, n);
}
