// JPEG 2000 Part 1 tier-1 code-block decoder: MQ arithmetic decoder +
// EBCOT bit-plane passes (ITU-T T.800 Annex C/D semantics, clean-room).
//
// tpukit uses this for JP2 ingest of Sentinel-2 band files
// (reference tools/make_baseline_A.py:13-19 reads them via rasterio/GDAL —
// tpukit decodes the codestream in-framework instead). Scope: the styles
// those products and OpenJPEG defaults use — MQ-coded passes with optional
// segmentation symbols, predictable termination, reset, and vertically
// causal contexts. Selective AC bypass and termall are NOT decodable yet:
// the entry check rejects them (the packet layer cannot slice their
// multi-segment lengths); RawDec and the cur_raw branches are the
// scaffolding for when that lands.
//
// Output: sign-magnitude int32 per coefficient; for truncated blocks the
// caller applies the dequant midpoint. The decoder is exact for complete
// (lossless) blocks.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- MQ decoder (T.800 Annex C / T.88) ------------------------------------
struct MQState { uint16_t qe; uint8_t nmps, nlps, sw; };
static const MQState kMQ[47] = {
    {0x5601,1,1,1},{0x3401,2,6,0},{0x1801,3,9,0},{0x0AC1,4,12,0},
    {0x0521,5,29,0},{0x0221,38,33,0},{0x5601,7,6,1},{0x5401,8,14,0},
    {0x4801,9,14,0},{0x3801,10,14,0},{0x3001,11,17,0},{0x2401,12,18,0},
    {0x1C01,13,20,0},{0x1601,29,21,0},{0x5601,15,14,1},{0x5401,16,14,0},
    {0x5101,17,15,0},{0x4801,18,16,0},{0x3801,19,17,0},{0x3401,20,18,0},
    {0x3001,21,19,0},{0x2801,22,19,0},{0x2401,23,20,0},{0x2201,24,21,0},
    {0x1C01,25,22,0},{0x1801,26,23,0},{0x1601,27,24,0},{0x1401,28,25,0},
    {0x1201,29,26,0},{0x1101,30,27,0},{0x0AC1,31,28,0},{0x09C1,32,29,0},
    {0x08A1,33,30,0},{0x0521,34,31,0},{0x0441,35,32,0},{0x02A1,36,33,0},
    {0x0221,37,34,0},{0x0141,38,35,0},{0x0111,39,36,0},{0x0085,40,37,0},
    {0x0049,41,38,0},{0x0025,42,39,0},{0x0015,43,40,0},{0x0009,44,41,0},
    {0x0005,45,42,0},{0x0001,45,43,0},{0x5601,46,46,0},
};

struct MQDec {
    const uint8_t* bp;
    const uint8_t* start;
    const uint8_t* end;
    uint32_t c = 0, a = 0;
    int ct = 0;
    uint8_t idx[19];   // context state index
    uint8_t mps[19];

    void reset_ctx() {
        std::memset(idx, 0, sizeof(idx));
        std::memset(mps, 0, sizeof(mps));
        idx[0] = 4;    // ctx 0 (ZC all-insignificant)
        idx[17] = 3;   // run-length
        idx[18] = 46;  // uniform
    }

    uint8_t cur() const { return bp < end ? *bp : 0xFF; }
    uint8_t nxt() const { return (bp + 1) < end ? *(bp + 1) : 0xFF; }

    void bytein() {
        if (cur() == 0xFF) {
            if (nxt() > 0x8F) {  // marker (or synthesized past-end 0xFF)
                c += 0xFF00;
                ct = 8;
            } else {
                ++bp;
                c += (uint32_t)cur() << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += (uint32_t)cur() << 8;
            ct = 8;
        }
    }

    void init(const uint8_t* data, int64_t n) {
        start = data; bp = data; end = data + n;
        c = (uint32_t)cur() << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }

    int decode(int cx) {
        const MQState& s = kMQ[idx[cx]];
        int d;
        a -= s.qe;
        if (((c >> 16) & 0xFFFF) < s.qe) {
            // LPS exchange path
            if (a < s.qe) { d = mps[cx]; idx[cx] = s.nmps; }
            else { d = 1 - mps[cx]; if (s.sw) mps[cx] ^= 1; idx[cx] = s.nlps; }
            a = s.qe;
        } else {
            c -= (uint32_t)s.qe << 16;
            if ((a & 0x8000) != 0) return mps[cx];
            if (a < s.qe) { d = 1 - mps[cx]; if (s.sw) mps[cx] ^= 1; idx[cx] = s.nlps; }
            else { d = mps[cx]; idx[cx] = s.nmps; }
        }
        // RENORMD with the shift count batched via CLZ (mirror of the
        // encoder's renorm): `a` is nonzero and below 0x8000 here, so
        // the per-bit loop shifts exactly clz32(a)-16 times, calling
        // bytein whenever ct hits 0 BEFORE a shift. Batching the shifts
        // between bytein boundaries performs the identical
        // shift/bytein sequence, so the decoded bits are unchanged.
        int n = __builtin_clz(a) - 16;
        while (n > 0) {
            if (ct == 0) bytein();
            int k = n < ct ? n : ct;
            a <<= k; c <<= k; ct -= k; n -= k;
        }
        return d;
    }
};

// raw (bypass) bit reader with 0xFF stuffing (T.800 D.4.3)
struct RawDec {
    const uint8_t* bp = nullptr;
    const uint8_t* end = nullptr;
    uint8_t cbyte = 0;
    int ct = 0;
    bool last_ff = false;

    void init(const uint8_t* data, int64_t n) {
        bp = data; end = data + n; ct = 0; last_ff = false;
    }
    int bit() {
        if (ct == 0) {
            if (bp < end) { cbyte = *bp++; } else { cbyte = 0xFF; }
            ct = last_ff ? 7 : 8;
            last_ff = (cbyte == 0xFF);
        }
        --ct;
        return (cbyte >> ct) & 1;
    }
};

// ---- context formation (T.800 Annex D) -------------------------------------
// flags per coefficient position in a (h+2)x(w+2) padded grid
enum : uint32_t {
    F_SIG = 1u << 0,      // significant
    F_VISIT = 1u << 1,    // coded in current SPP
    F_NEG = 1u << 2,      // sign
    F_REFINED = 1u << 3,  // had a refinement pass already
};

static inline int zc_context(uint32_t fN, uint32_t fS, uint32_t fW,
                             uint32_t fE, uint32_t fNW, uint32_t fNE,
                             uint32_t fSW, uint32_t fSE, int orient) {
    int h = ((fW & F_SIG) != 0) + ((fE & F_SIG) != 0);
    int v = ((fN & F_SIG) != 0) + ((fS & F_SIG) != 0);
    int d = ((fNW & F_SIG) != 0) + ((fNE & F_SIG) != 0) +
            ((fSW & F_SIG) != 0) + ((fSE & F_SIG) != 0);
    if (orient == 1) { int t = h; h = v; v = t; }  // HL: transpose
    if (orient == 3) {                              // HH
        int hv = h + v;
        if (d >= 3) return 8;
        if (d == 2) return hv >= 1 ? 7 : 6;
        if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
        return hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
    }
    if (h == 2) return 8;
    if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
    if (v == 2) return 4;
    if (v == 1) return 3;
    if (d >= 2) return 2;
    return d == 1 ? 1 : 0;
}

// Selective AC bypass (T.800 D.6): SPP/MRP raw-coded from the 5th
// significant bit-plane (absolute pass index k >= 10); cleanup stays MQ.
static inline bool pass_is_raw_k(int style, int k) {
    return (style & 1) && k >= 10 && ((k - 1) % 3) != 2;
}

// Codeword-segment boundary between passes k-1 and k (D.4.1): termall
// terminates every pass; bypass terminates at each MQ<->raw transition.
static inline bool seg_boundary_k(int style, int k) {
    if (k <= 0) return false;
    if (style & 4) return true;
    if (style & 1)
        return pass_is_raw_k(style, k) != pass_is_raw_k(style, k - 1);
    return false;
}

static inline int sign_contrib(uint32_t f) {
    if (!(f & F_SIG)) return 0;
    return (f & F_NEG) ? -1 : 1;
}

static inline void sc_context(uint32_t fN, uint32_t fS, uint32_t fW,
                              uint32_t fE, int* cx, int* xorbit) {
    int hc = sign_contrib(fW) + sign_contrib(fE);
    int vc = sign_contrib(fN) + sign_contrib(fS);
    hc = hc > 1 ? 1 : (hc < -1 ? -1 : hc);
    vc = vc > 1 ? 1 : (vc < -1 ? -1 : vc);
    int xb = 0;
    if (hc < 0) { hc = -hc; vc = -vc; xb = 1; }
    if (hc == 1) {
        *cx = vc == 1 ? 13 : (vc == 0 ? 12 : 11);
    } else {  // hc == 0 (after normalization): V=±1 -> ctx 10, V=0 -> 9
        *cx = vc == 0 ? 9 : 10;
        if (vc == -1) xb = 1;
    }
    *xorbit = xb;
}

struct T1 {
    int w, h;
    std::vector<uint32_t> flags;  // (h+2) x (w+2)
    std::vector<uint32_t> mag;    // h x w
    int stride;

    uint32_t& F(int y, int x) { return flags[(size_t)(y + 1) * stride + (x + 1)]; }
    uint32_t nbr(int y, int x, bool causal, int strip_y0) {
        // vertically-causal mode hides the row below the current strip
        if (causal && y >= strip_y0 + 4) return 0;
        return flags[(size_t)(y + 1) * stride + (x + 1)];
    }

    // OR of the flag words over rows [y0-1, y0+rows] x cols [x-1, x+1]:
    // a superset of every 8-neighbourhood (and of every centre flag) of
    // the column strip, used for conservative whole-strip skips — a
    // strip whose window carries no F_SIG cannot contain an SPP-coded
    // coefficient, and one with no centre F_SIG has nothing to refine.
    // Conservative under vertically-causal mode too: the window only
    // ADDS the hidden row, so it can suppress a skip, never allow a
    // wrong one.
    uint32_t window_or(int y0, int x, int rows) const {
        uint32_t acc = 0;
        const uint32_t* p = &flags[(size_t)y0 * stride + x];  // (y0-1,x-1)
        for (int r = 0; r < rows + 2; ++r, p += stride)
            acc |= p[0] | p[1] | p[2];
        return acc;
    }
    uint32_t center_or(int y0, int x, int rows) const {
        uint32_t acc = 0;
        const uint32_t* p = &flags[(size_t)(y0 + 1) * stride + (x + 1)];
        for (int r = 0; r < rows; ++r, p += stride) acc |= p[0];
        return acc;
    }
};

}  // namespace

// Decode one code-block.
//   data/nbytes : concatenated (layer-appended) coded segments
//   seg_lens    : byte length per coding segment (termall/bypass create
//                 multiple segments; default style = 1 segment)
//   seg_raw     : 1 if the segment is raw (bypass), else MQ
//   nsegs       : number of segments
//   passes      : total coding pass count
//   numbps      : magnitude bit-planes in this block (Mb - zero_bitplanes)
//   orient      : 0=LL, 1=HL, 2=LH, 3=HH
//   style       : Scod code-block style bits (bypass=1, reset=2, termall=4,
//                 causal=8, predictable-termination=16, segsym=32)
//   out         : w*h int32, sign-magnitude (negative = negative coef)
//   lastp       : optional w*h int32; per coefficient, the bit-plane of its
//                 last magnitude update (significance or refinement), or -1
//                 if never significant.  The dequant midpoint for coefficient
//                 i is 0.5 * 2^lastp[i] — per-coefficient, matching the
//                 encoder's pass_dist bookkeeping (j2k_t1enc.cpp) and
//                 OpenJPEG's in-pass half updates, so PCRD's predicted
//                 distortion is exactly what a decoder reconstructs.
// Returns number of planes decoded (>=0) or <0 on error.
extern "C" int64_t j2k_t1_decode_full(const uint8_t* data, int64_t nbytes,
                                      const int64_t* seg_lens,
                                      const uint8_t* seg_raw, int nsegs,
                                      int passes, int numbps, int orient,
                                      int style, int w, int h, int32_t* out,
                                      int32_t* lastp) {
    if (w <= 0 || h <= 0 || w > 4096 || h > 4096) return -1;
    if (numbps > 32) return -5;   // int32 magnitudes: 1u<<plane is UB past 31
    if (numbps <= 0 || passes <= 0) {
        std::memset(out, 0, sizeof(int32_t) * (size_t)w * h);
        if (lastp)
            for (size_t i = 0; i < (size_t)w * h; ++i) lastp[i] = -1;
        return 0;
    }
    std::vector<int32_t> lp((size_t)w * h, -1);
    if (nsegs < 1) return -2;
    const bool causal = (style & 8) != 0;
    const bool segsym = (style & 32) != 0;
    const bool resetctx = (style & 2) != 0;

    T1 t1;
    t1.w = w; t1.h = h; t1.stride = w + 2;
    t1.flags.assign((size_t)(h + 2) * (w + 2), 0);
    t1.mag.assign((size_t)w * h, 0);

    MQDec mq;
    mq.reset_ctx();
    RawDec raw;
    int seg = 0;
    const uint8_t* segp = data;
    int64_t seg_used = 0;
    auto open_seg = [&](int s) {
        const uint8_t* p = data;
        for (int i = 0; i < s; ++i) p += seg_lens[i];
        segp = p;
        if (seg_raw && seg_raw[s]) raw.init(segp, seg_lens[s]);
        else mq.init(segp, seg_lens[s]);
    };
    (void)seg_used; (void)nbytes;
    open_seg(0);
    bool cur_raw = seg_raw && seg_raw[0];

    // pass schedule: plane numbps-1 has only a cleanup pass; lower planes
    // run SPP, MRP, CUP
    int plane = numbps - 1;
    int pass_kind = 2;  // 0=SPP 1=MRP 2=CUP
    int planes_done = 0;

    for (int pi = 0; pi < passes; ++pi) {
        if (pi > 0 && seg_boundary_k(style, pi)) {
            if (++seg >= nsegs) return -6;  // fewer segments than schedule
            open_seg(seg);
            cur_raw = seg_raw && seg_raw[seg];
        }
        const uint32_t bit = 1u << plane;
        if (pass_kind == 0) {
            // significance propagation
            for (int y0 = 0; y0 < h; y0 += 4) {
                int rows = y0 + 4 < h ? 4 : h - y0;
                for (int x = 0; x < w; ++x) {
                    // strip skip: no F_SIG anywhere in the 3-column
                    // window => no coefficient here has a significant
                    // neighbour, so SPP codes nothing in this strip
                    // (bits set DURING the strip require a prior coded
                    // coefficient, which requires a window F_SIG)
                    if (!(t1.window_or(y0, x, rows) & F_SIG))
                        continue;
                    int ymax = y0 + rows;
                    for (int y = y0; y < ymax; ++y) {
                        uint32_t& f = t1.F(y, x);
                        if (f & F_SIG) continue;
                        uint32_t fN = t1.F(y - 1, x);
                        uint32_t fS = t1.nbr(y + 1, x, causal, y0);
                        uint32_t fW = t1.F(y, x - 1);
                        uint32_t fE = t1.F(y, x + 1);
                        uint32_t fNW = t1.F(y - 1, x - 1);
                        uint32_t fNE = t1.F(y - 1, x + 1);
                        uint32_t fSW = t1.nbr(y + 1, x - 1, causal, y0);
                        uint32_t fSE = t1.nbr(y + 1, x + 1, causal, y0);
                        if (!((fN | fS | fW | fE | fNW | fNE | fSW | fSE) & F_SIG))
                            continue;  // no significant neighbor: not in SPP
                        int d;
                        int cx = zc_context(fN, fS, fW, fE, fNW, fNE, fSW, fSE,
                                            orient);
                        d = cur_raw ? raw.bit() : mq.decode(cx);
                        f |= F_VISIT;
                        if (d) {
                            int scx, xorbit;
                            sc_context(fN, fS, fW, fE, &scx, &xorbit);
                            int sbit = cur_raw ? raw.bit()
                                               : (mq.decode(scx) ^ xorbit);
                            f |= F_SIG | (sbit ? F_NEG : 0);
                            t1.mag[(size_t)y * w + x] = bit;
                            lp[(size_t)y * w + x] = plane;
                        }
                    }
                }
            }
        } else if (pass_kind == 1) {
            // magnitude refinement
            for (int y0 = 0; y0 < h; y0 += 4) {
                int rows = y0 + 4 < h ? 4 : h - y0;
                for (int x = 0; x < w; ++x) {
                    // strip skip: nothing significant in the column =>
                    // nothing to refine
                    if (!(t1.center_or(y0, x, rows) & F_SIG))
                        continue;
                    int ymax = y0 + rows;
                    for (int y = y0; y < ymax; ++y) {
                        uint32_t& f = t1.F(y, x);
                        if (!(f & F_SIG) || (f & F_VISIT)) continue;
                        int d;
                        if (cur_raw) {
                            d = raw.bit();
                        } else {
                            int cx;
                            if (f & F_REFINED) cx = 16;
                            else {
                                uint32_t fN = t1.F(y - 1, x);
                                uint32_t fS = t1.nbr(y + 1, x, causal, y0);
                                uint32_t fW = t1.F(y, x - 1);
                                uint32_t fE = t1.F(y, x + 1);
                                uint32_t fNW = t1.F(y - 1, x - 1);
                                uint32_t fNE = t1.F(y - 1, x + 1);
                                uint32_t fSW = t1.nbr(y + 1, x - 1, causal, y0);
                                uint32_t fSE = t1.nbr(y + 1, x + 1, causal, y0);
                                cx = ((fN | fS | fW | fE | fNW | fNE | fSW | fSE)
                                      & F_SIG) ? 15 : 14;
                            }
                            d = mq.decode(cx);
                        }
                        if (d) t1.mag[(size_t)y * w + x] |= bit;
                        lp[(size_t)y * w + x] = plane;
                        f |= F_REFINED;
                    }
                }
            }
        } else {
            // cleanup (always MQ)
            for (int y0 = 0; y0 < h; y0 += 4) {
                int rows = y0 + 4 < h ? 4 : h - y0;
                for (int x = 0; x < w; ++x) {
                    int y = y0;
                    int ymax = y0 + rows;
                    // run-length mode: full 4-strip, all insignificant,
                    // no significant neighbors anywhere in the strip.
                    // Fast path: an all-clear window answers both
                    // conditions with one OR sweep (the common case in
                    // early planes); otherwise fall back to the exact
                    // per-coefficient probe.
                    bool runable = (rows == 4);
                    if (runable) {
                        uint32_t wn = t1.window_or(y0, x, rows);
                        if (wn & F_SIG ||
                            (t1.center_or(y0, x, rows) & F_VISIT)) {
                            runable = false;
                            for (int yy = y0; yy < ymax; ++yy) {
                                uint32_t f = t1.F(yy, x);
                                if (f & (F_SIG | F_VISIT)) break;
                                uint32_t fN = t1.F(yy - 1, x);
                                uint32_t fS = t1.nbr(yy + 1, x, causal, y0);
                                uint32_t fW = t1.F(yy, x - 1);
                                uint32_t fE = t1.F(yy, x + 1);
                                uint32_t fNW = t1.F(yy - 1, x - 1);
                                uint32_t fNE = t1.F(yy - 1, x + 1);
                                uint32_t fSW = t1.nbr(yy + 1, x - 1, causal, y0);
                                uint32_t fSE = t1.nbr(yy + 1, x + 1, causal, y0);
                                if ((fN | fS | fW | fE | fNW | fNE | fSW | fSE)
                                    & F_SIG)
                                    break;
                                if (yy == ymax - 1) runable = true;
                            }
                        }
                    }
                    if (runable) {
                        if (mq.decode(17) == 0) {
                            for (int yy = y0; yy < ymax; ++yy)
                                t1.F(yy, x) &= ~F_VISIT;
                            continue;  // whole strip stays zero
                        }
                        int r = (mq.decode(18) << 1) | mq.decode(18);
                        y = y0 + r;
                        // first significant coefficient: sign only
                        uint32_t& f = t1.F(y, x);
                        uint32_t fN = t1.F(y - 1, x);
                        uint32_t fS = t1.nbr(y + 1, x, causal, y0);
                        uint32_t fW = t1.F(y, x - 1);
                        uint32_t fE = t1.F(y, x + 1);
                        int scx, xorbit;
                        sc_context(fN, fS, fW, fE, &scx, &xorbit);
                        int sbit = mq.decode(scx) ^ xorbit;
                        f |= F_SIG | (sbit ? F_NEG : 0);
                        t1.mag[(size_t)y * w + x] = bit;
                        lp[(size_t)y * w + x] = plane;
                        ++y;
                    }
                    for (; y < ymax; ++y) {
                        uint32_t& f = t1.F(y, x);
                        if (f & F_VISIT) { f &= ~F_VISIT; continue; }
                        if (f & F_SIG) continue;
                        uint32_t fN = t1.F(y - 1, x);
                        uint32_t fS = t1.nbr(y + 1, x, causal, y0);
                        uint32_t fW = t1.F(y, x - 1);
                        uint32_t fE = t1.F(y, x + 1);
                        uint32_t fNW = t1.F(y - 1, x - 1);
                        uint32_t fNE = t1.F(y - 1, x + 1);
                        uint32_t fSW = t1.nbr(y + 1, x - 1, causal, y0);
                        uint32_t fSE = t1.nbr(y + 1, x + 1, causal, y0);
                        int cx = zc_context(fN, fS, fW, fE, fNW, fNE, fSW, fSE,
                                            orient);
                        if (mq.decode(cx)) {
                            int scx, xorbit;
                            sc_context(fN, fS, fW, fE, &scx, &xorbit);
                            int sbit = mq.decode(scx) ^ xorbit;
                            f |= F_SIG | (sbit ? F_NEG : 0);
                            t1.mag[(size_t)y * w + x] = bit;
                            lp[(size_t)y * w + x] = plane;
                        }
                    }
                }
            }
            // strip VISIT flags after cleanup
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < w; ++x)
                    t1.F(y, x) &= ~F_VISIT;
            if (segsym) {
                int v = (mq.decode(18) << 3) | (mq.decode(18) << 2) |
                        (mq.decode(18) << 1) | mq.decode(18);
                if (v != 0xA) return -3;  // segmentation symbol mismatch
            }
            ++planes_done;
        }

        // advance pass schedule
        if (pass_kind == 2) { pass_kind = 0; --plane; }
        else ++pass_kind;
        if (plane < 0 && pi + 1 < passes) return -4;  // too many passes
        if (resetctx)  // RESET: context states restart each pass boundary
            mq.reset_ctx();
    }
    (void)seg; (void)cur_raw;

    // emit sign-magnitude
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            uint32_t m = t1.mag[(size_t)y * w + x];
            out[(size_t)y * w + x] = (t1.F(y, x) & F_NEG) ? -(int32_t)m
                                                          : (int32_t)m;
        }
    if (lastp) std::memcpy(lastp, lp.data(), sizeof(int32_t) * lp.size());
    return planes_done;
}

extern "C" int64_t j2k_t1_decode(const uint8_t* data, int64_t nbytes,
                                 const int64_t* seg_lens,
                                 const uint8_t* seg_raw, int nsegs,
                                 int passes, int numbps, int orient,
                                 int style, int w, int h, int32_t* out) {
    return j2k_t1_decode_full(data, nbytes, seg_lens, seg_raw, nsegs, passes,
                              numbps, orient, style, w, h, out, nullptr);
}
