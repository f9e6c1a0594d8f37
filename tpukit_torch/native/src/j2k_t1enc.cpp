// JPEG 2000 Part 1 tier-1 code-block ENCODER: MQ arithmetic encoder +
// EBCOT bit-plane passes (ITU-T T.800 Annex C/D semantics, clean-room).
//
// Mirror of the tier-1 decoder in j2k_t1.cpp: identical context formation,
// pass schedule (CUP on the top plane, then SPP/MRP/CUP per lower plane),
// strip order, and flag evolution, so enc->dec round-trips are exact for
// any pass prefix. The reference's J2K path delegates this stage to
// OpenJPEG inside gdal_translate (reference tools/codecs/j2k/j2k_wrap.py:
// 79-105); tpukit runs it in-process so the sweep can truncate one encode
// at many rate points.
//
// Rate-distortion bookkeeping for PCRD-opt truncation:
//   * after every coding pass the MQ registers are snapshotted and a
//     termination is SIMULATED (T.800 C.2.8 FLUSH on a copy), yielding the
//     exact minimal byte length at which a decoder reproduces that pass
//     prefix; the flush tail bytes are recorded so any truncation point
//     can be materialized as immutable-prefix + tail without re-encoding
//   * every coded bit updates the exact squared-error reduction of the
//     midpoint reconstruction (mag + 0.5*2^plane), accumulated per pass in
//     integer coefficient units; callers scale by (step * basis-norm)^2
//
// Output styles: MQ-coded passes, single codeword segment (no bypass /
// termall / reset / causal), optional segmentation symbols — exactly the
// subset j2k_t1_decode accepts.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

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

// ---- MQ encoder (T.800 Annex C software conventions) -----------------------
struct MQEnc {
    // bytes[0] is a sentinel standing in for the byte before the segment
    // start (BP = BPST-1 at INITENC); bytes.back() is the pending byte B.
    // A carry can only reach the sentinel before the first byteout, and
    // C < 2^27 holds there (C starts at 0 and gains < 2^15 per shift), so
    // the sentinel is never incremented.
    std::vector<uint8_t> bytes;
    uint32_t c = 0, a = 0x8000;
    int ct = 12;
    uint8_t idx[19];
    uint8_t mps[19];

    void reset_ctx() {
        std::memset(idx, 0, sizeof(idx));
        std::memset(mps, 0, sizeof(mps));
        idx[0] = 4;    // ZC all-insignificant
        idx[17] = 3;   // run-length
        idx[18] = 46;  // uniform
    }

    void init() {
        bytes.clear();
        bytes.push_back(0);
        c = 0; a = 0x8000; ct = 12;
        reset_ctx();
    }

    void byteout() {
        if (bytes.back() == 0xFF) {
            bytes.push_back((uint8_t)(c >> 20));
            c &= 0xFFFFF; ct = 7;
        } else if (c < 0x8000000) {
            bytes.push_back((uint8_t)(c >> 19));
            c &= 0x7FFFF; ct = 8;
        } else {
            bytes.back() += 1;
            if (bytes.back() == 0xFF) {
                c &= 0x7FFFFFF;
                bytes.push_back((uint8_t)(c >> 20));
                c &= 0xFFFFF; ct = 7;
            } else {
                bytes.push_back((uint8_t)(c >> 19));
                c &= 0x7FFFF; ct = 8;
            }
        }
    }

    // RENORME with the shift count batched via CLZ: `a` is nonzero and
    // below 0x8000 here, so the per-bit loop shifts exactly
    // clz32(a)-16 times, with a byteout each time the shift counter
    // crosses ct. Splitting the batch at the byteout boundaries performs
    // the identical shift/byteout sequence, so the emitted bytes are
    // unchanged. 32-bit envelope: between byteouts at most ct shifts
    // happen in either formulation — ct <= 8 after any byteout, and up
    // to 12 in the initial window after INITENC (ct starts at 12
    // there). Both windows keep C < 2^28 before its byteout, exactly as
    // the per-bit loop does: the batched form shifts by the same total
    // with byteouts at the same points, so it inherits the per-bit
    // loop's C-register bound rather than needing a separate one.
    void renorm() {
        int n = __builtin_clz(a) - 16;
        while (n >= ct) {
            a <<= ct; c <<= ct; n -= ct;
            ct = 0; byteout();
        }
        if (n > 0) { a <<= n; c <<= n; ct -= n; }
    }

    void encode(int d, int cx) {
        const MQState& s = kMQ[idx[cx]];
        if (d == mps[cx]) {  // CODEMPS
            a -= s.qe;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) a = s.qe; else c += s.qe;
                idx[cx] = s.nmps;
                renorm();
            } else {
                c += s.qe;
            }
        } else {             // CODELPS
            a -= s.qe;
            if (a < s.qe) c += s.qe; else a = s.qe;
            if (s.sw) mps[cx] ^= 1;
            idx[cx] = s.nlps;
            renorm();
        }
    }

    // Simulate FLUSH (T.800 C.2.8) from the CURRENT register state without
    // mutating it. Writes the termination tail (the pending byte B after a
    // possible carry, plus the flushed bytes) into tail[]; returns the tail
    // length AFTER dropping a trailing 0xFF. The stream truncated at this
    // point is bytes[1..size-1) + tail[0..n).
    int sim_flush(uint8_t* tail) const {
        uint32_t C = c, A = a;
        int CT = ct;
        uint8_t tb[8];
        int n = 0;
        tb[0] = bytes.back();  // pending B (may be the sentinel)
        n = 1;
        auto bout = [&]() {
            if (tb[n - 1] == 0xFF) {
                tb[n++] = (uint8_t)(C >> 20); C &= 0xFFFFF; CT = 7;
            } else if (C < 0x8000000) {
                tb[n++] = (uint8_t)(C >> 19); C &= 0x7FFFF; CT = 8;
            } else {
                tb[n - 1] += 1;
                if (tb[n - 1] == 0xFF) {
                    C &= 0x7FFFFFF;
                    tb[n++] = (uint8_t)(C >> 20); C &= 0xFFFFF; CT = 7;
                } else {
                    tb[n++] = (uint8_t)(C >> 19); C &= 0x7FFFF; CT = 8;
                }
            }
        };
        // SETBITS
        uint32_t tempc = C + A;
        C |= 0xFFFF;
        if (C >= tempc) C -= 0x8000;
        C <<= CT; bout();
        C <<= CT; bout();
        if (tb[n - 1] == 0xFF) --n;  // a trailing 0xFF is not transmitted
        // drop the sentinel if B was it (no byteout had happened yet)
        int skip = (bytes.size() == 1) ? 1 : 0;
        int m = 0;
        for (int i = skip; i < n; ++i) tail[m++] = tb[i];
        return m;
    }
};

// ---- context formation: identical to j2k_t1.cpp ----------------------------
enum : uint32_t {
    F_SIG = 1u << 0,
    F_VISIT = 1u << 1,
    F_NEG = 1u << 2,
    F_REFINED = 1u << 3,
};

static inline int zc_context(uint32_t fN, uint32_t fS, uint32_t fW,
                             uint32_t fE, uint32_t fNW, uint32_t fNE,
                             uint32_t fSW, uint32_t fSE, int orient) {
    int h = ((fW & F_SIG) != 0) + ((fE & F_SIG) != 0);
    int v = ((fN & F_SIG) != 0) + ((fS & F_SIG) != 0);
    int d = ((fNW & F_SIG) != 0) + ((fNE & F_SIG) != 0) +
            ((fSW & F_SIG) != 0) + ((fSE & F_SIG) != 0);
    if (orient == 1) { int t = h; h = v; v = t; }
    if (orient == 3) {
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
    } else {
        *cx = vc == 0 ? 9 : 10;
        if (vc == -1) xb = 1;
    }
    *xorbit = xb;
}

struct T1E {
    int w, h, stride;
    std::vector<uint32_t> flags;   // (h+2) x (w+2)
    std::vector<uint32_t> mag;     // |coef|
    std::vector<double> err;       // current midpoint squared error

    uint32_t& F(int y, int x) {
        return flags[(size_t)(y + 1) * stride + (x + 1)];
    }

    // conservative strip-skip probes (same construction as the
    // decoder's, j2k_t1.cpp): OR of the flag words over rows
    // [y0-1, y0+rows] x cols [x-1, x+1] — a superset of every
    // 8-neighbourhood (and every centre flag) in the column strip.
    // No F_SIG in the window => SPP codes nothing here (in-strip
    // propagation needs a previously-coded significant coefficient);
    // no centre F_SIG => nothing to refine.
    uint32_t window_or(int y0, int x, int rows) const {
        uint32_t acc = 0;
        const uint32_t* p = &flags[(size_t)y0 * stride + x];
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

// Encode one code-block.
//   coefs     : w*h signed int32 coefficients (row-major)
//   orient    : 0=LL, 1=HL, 2=LH, 3=HH
//   style     : Scod code-block style; only segsym (32) supported
//   out/cap   : output buffer for the full terminated stream
//   pass_len  : per-pass minimal truncation length (bytes), >= 1 entries
//   pass_dist : per-pass CUMULATIVE squared-error reduction vs recon=0,
//               midpoint reconstruction, in integer coefficient units^2
//   pass_tail : per-pass termination tail, 8 bytes each: [len, b0..b6]
//   maxpasses : capacity of the per-pass arrays
//   info_out  : [0]=npasses, [1]=numbps, [2]=full stream length
// Returns 0, or <0 on error (-1 bad dims, -2 style, -3 overflow,
// -4 pass arrays too small).
extern "C" int64_t j2k_t1_encode(const int32_t* coefs, int w, int h,
                                 int orient, int style,
                                 uint8_t* out, int64_t cap,
                                 int32_t* pass_len, double* pass_dist,
                                 uint8_t* pass_tail, int maxpasses,
                                 int64_t* info_out) {
    if (w <= 0 || h <= 0 || w > 4096 || h > 4096) return -1;
    if (style & ~32) return -2;  // only segsym; matches decoder support
    const bool segsym = (style & 32) != 0;

    T1E t1;
    t1.w = w; t1.h = h; t1.stride = w + 2;
    t1.flags.assign((size_t)(h + 2) * (w + 2), 0);
    t1.mag.resize((size_t)w * h);
    t1.err.resize((size_t)w * h);

    uint32_t maxmag = 0;
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int32_t v = coefs[(size_t)y * w + x];
            uint32_t m = (uint32_t)(v < 0 ? -(int64_t)v : v);
            t1.mag[(size_t)y * w + x] = m;
            t1.err[(size_t)y * w + x] = (double)m * (double)m;
            if (v < 0) t1.F(y, x) |= F_NEG;
            if (m > maxmag) maxmag = m;
        }
    int numbps = 0;
    while (maxmag >> numbps) ++numbps;
    if (numbps > 31) return -1;

    info_out[0] = 0;
    info_out[1] = numbps;
    info_out[2] = 0;
    if (numbps == 0) return 0;

    MQEnc mq;
    mq.init();

    double dist_cum = 0.0;   // total squared-error reduction so far
    int npasses = 0;

    auto pass_end = [&]() -> bool {
        if (npasses >= maxpasses) return false;
        uint8_t tail[8];
        int tn = mq.sim_flush(tail);
        int64_t plen = (int64_t)mq.bytes.size() - 2;  // immutable prefix
        if (plen < 0) plen = 0;
        pass_len[npasses] = (int32_t)(plen + tn);
        pass_dist[npasses] = dist_cum;
        uint8_t* pt = pass_tail + (size_t)npasses * 8;
        pt[0] = (uint8_t)tn;
        for (int i = 0; i < tn; ++i) pt[1 + i] = tail[i];
        ++npasses;
        return true;
    };

    int plane = numbps - 1;
    int pass_kind = 2;  // top plane starts with cleanup

    while (plane >= 0) {
        const uint32_t bit = 1u << plane;
        const double half = 0.5 * (double)bit;
        if (pass_kind == 0) {
            // significance propagation
            for (int y0 = 0; y0 < h; y0 += 4) {
                int rows = y0 + 4 < h ? 4 : h - y0;
                for (int x = 0; x < w; ++x) {
                    if (!(t1.window_or(y0, x, rows) & F_SIG))
                        continue;          // strip not in SPP (see probe)
                    int ymax = y0 + rows;
                    for (int y = y0; y < ymax; ++y) {
                        uint32_t& f = t1.F(y, x);
                        if (f & F_SIG) continue;
                        uint32_t fN = t1.F(y - 1, x);
                        uint32_t fS = t1.F(y + 1, x);
                        uint32_t fW = t1.F(y, x - 1);
                        uint32_t fE = t1.F(y, x + 1);
                        uint32_t fNW = t1.F(y - 1, x - 1);
                        uint32_t fNE = t1.F(y - 1, x + 1);
                        uint32_t fSW = t1.F(y + 1, x - 1);
                        uint32_t fSE = t1.F(y + 1, x + 1);
                        if (!((fN | fS | fW | fE | fNW | fNE | fSW | fSE)
                              & F_SIG))
                            continue;
                        size_t k = (size_t)y * w + x;
                        int d = (t1.mag[k] & bit) != 0;
                        int cx = zc_context(fN, fS, fW, fE, fNW, fNE, fSW,
                                            fSE, orient);
                        mq.encode(d, cx);
                        f |= F_VISIT;
                        if (d) {
                            int scx, xorbit;
                            sc_context(fN, fS, fW, fE, &scx, &xorbit);
                            int sbit = (f & F_NEG) ? 1 : 0;
                            mq.encode(sbit ^ xorbit, scx);
                            f |= F_SIG;
                            double r = 1.5 * (double)bit;
                            double e = (double)t1.mag[k] - r;
                            dist_cum += t1.err[k] - e * e;
                            t1.err[k] = e * e;
                        }
                    }
                }
            }
        } else if (pass_kind == 1) {
            // magnitude refinement
            for (int y0 = 0; y0 < h; y0 += 4) {
                int rows = y0 + 4 < h ? 4 : h - y0;
                for (int x = 0; x < w; ++x) {
                    if (!(t1.center_or(y0, x, rows) & F_SIG))
                        continue;          // nothing significant: no MRP
                    int ymax = y0 + rows;
                    for (int y = y0; y < ymax; ++y) {
                        uint32_t& f = t1.F(y, x);
                        if (!(f & F_SIG) || (f & F_VISIT)) continue;
                        size_t k = (size_t)y * w + x;
                        int d = (t1.mag[k] & bit) != 0;
                        int cx;
                        if (f & F_REFINED) cx = 16;
                        else {
                            uint32_t nb = t1.F(y - 1, x) | t1.F(y + 1, x) |
                                          t1.F(y, x - 1) | t1.F(y, x + 1) |
                                          t1.F(y - 1, x - 1) |
                                          t1.F(y - 1, x + 1) |
                                          t1.F(y + 1, x - 1) |
                                          t1.F(y + 1, x + 1);
                            cx = (nb & F_SIG) ? 15 : 14;
                        }
                        mq.encode(d, cx);
                        f |= F_REFINED;
                        // midpoint recon moves from the +-2^(p+1) bracket
                        // to the +-2^p bracket around the known bits
                        double m = (double)t1.mag[k];
                        double known = (double)(t1.mag[k] &
                                                ~(uint32_t)(2 * bit - 1));
                        double r_new = known + (d ? (double)bit : 0.0) + half;
                        double e = m - r_new;
                        dist_cum += t1.err[k] - e * e;
                        t1.err[k] = e * e;
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
                    bool runable = (rows == 4);
                    if (runable) {
                        // fast path: an all-clear window answers both
                        // run-mode conditions with one OR sweep
                        uint32_t wn = t1.window_or(y0, x, rows);
                        if ((wn & F_SIG) ||
                            (t1.center_or(y0, x, rows) & F_VISIT)) {
                            for (int yy = y0; yy < ymax && runable; ++yy) {
                                uint32_t f = t1.F(yy, x);
                                if (f & (F_SIG | F_VISIT)) { runable = false; break; }
                                uint32_t nb = t1.F(yy - 1, x) | t1.F(yy + 1, x) |
                                              t1.F(yy, x - 1) | t1.F(yy, x + 1) |
                                              t1.F(yy - 1, x - 1) |
                                              t1.F(yy - 1, x + 1) |
                                              t1.F(yy + 1, x - 1) |
                                              t1.F(yy + 1, x + 1);
                                if (nb & F_SIG) runable = false;
                            }
                        }
                    }
                    if (runable) {
                        int r = -1;
                        for (int yy = y0; yy < ymax; ++yy)
                            if (t1.mag[(size_t)yy * w + x] & bit) { r = yy - y0; break; }
                        if (r < 0) {
                            mq.encode(0, 17);
                            for (int yy = y0; yy < ymax; ++yy)
                                t1.F(yy, x) &= ~F_VISIT;
                            continue;
                        }
                        mq.encode(1, 17);
                        mq.encode((r >> 1) & 1, 18);
                        mq.encode(r & 1, 18);
                        y = y0 + r;
                        uint32_t& f = t1.F(y, x);
                        uint32_t fN = t1.F(y - 1, x);
                        uint32_t fS = t1.F(y + 1, x);
                        uint32_t fW = t1.F(y, x - 1);
                        uint32_t fE = t1.F(y, x + 1);
                        int scx, xorbit;
                        sc_context(fN, fS, fW, fE, &scx, &xorbit);
                        int sbit = (f & F_NEG) ? 1 : 0;
                        mq.encode(sbit ^ xorbit, scx);
                        f |= F_SIG;
                        size_t k = (size_t)y * w + x;
                        double rr = 1.5 * (double)bit;
                        double e = (double)t1.mag[k] - rr;
                        dist_cum += t1.err[k] - e * e;
                        t1.err[k] = e * e;
                        ++y;
                    }
                    for (; y < ymax; ++y) {
                        uint32_t& f = t1.F(y, x);
                        if (f & F_VISIT) { f &= ~F_VISIT; continue; }
                        if (f & F_SIG) continue;
                        uint32_t fN = t1.F(y - 1, x);
                        uint32_t fS = t1.F(y + 1, x);
                        uint32_t fW = t1.F(y, x - 1);
                        uint32_t fE = t1.F(y, x + 1);
                        uint32_t fNW = t1.F(y - 1, x - 1);
                        uint32_t fNE = t1.F(y - 1, x + 1);
                        uint32_t fSW = t1.F(y + 1, x - 1);
                        uint32_t fSE = t1.F(y + 1, x + 1);
                        size_t k = (size_t)y * w + x;
                        int d = (t1.mag[k] & bit) != 0;
                        int cx = zc_context(fN, fS, fW, fE, fNW, fNE, fSW,
                                            fSE, orient);
                        mq.encode(d, cx);
                        if (d) {
                            int scx, xorbit;
                            sc_context(fN, fS, fW, fE, &scx, &xorbit);
                            int sbit = (f & F_NEG) ? 1 : 0;
                            mq.encode(sbit ^ xorbit, scx);
                            f |= F_SIG;
                            double rr = 1.5 * (double)bit;
                            double e = (double)t1.mag[k] - rr;
                            dist_cum += t1.err[k] - e * e;
                            t1.err[k] = e * e;
                        }
                    }
                }
            }
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < w; ++x)
                    t1.F(y, x) &= ~F_VISIT;
            if (segsym) {
                mq.encode(1, 18); mq.encode(0, 18);
                mq.encode(1, 18); mq.encode(0, 18);
            }
        }

        if (!pass_end()) return -4;
        if (pass_kind == 2) { pass_kind = 0; --plane; }
        else ++pass_kind;
    }

    // materialize the full terminated stream = prefix + last pass tail
    uint8_t tail[8];
    int tn = mq.sim_flush(tail);
    int64_t plen = (int64_t)mq.bytes.size() - 2;
    if (plen < 0) plen = 0;
    int64_t total = plen + tn;
    if (total > cap) return -3;
    if (plen > 0) std::memcpy(out, mq.bytes.data() + 1, (size_t)plen);
    for (int i = 0; i < tn; ++i) out[plen + i] = tail[i];

    info_out[0] = npasses;
    info_out[1] = numbps;
    info_out[2] = total;
    return 0;
}

// ---------------------------------------------------------------------------
// Significance plan: the pass index at which each coefficient becomes
// significant, WITHOUT any MQ/context work.  This is the only
// data-dependent part of a tier-1 truncated decode — given it, the
// reconstruction any decoder produces from the first K passes is closed
// form per coefficient (the MSB plane is bit_length(|c|)-1; refinement
// bits live in fixed MRP pass indexes), which lets the rate ladder
// reconstruct every PCRD truncation point without entropy-decoding the
// streams (io/j2c_enc.J2CPlan.truncated_recon).
//
// Membership rules replayed exactly from j2k_t1_encode above (and the
// decoder in j2k_t1.cpp): 4-row strip column scan; SPP visits
// insignificant coefficients with a significant 8-neighbor AT VISIT TIME
// (intra-pass propagation via the shared flags array); MRP never changes
// significance; cleanup covers the unvisited rest.  Run-mode coding
// changes symbols, not membership, so the replay skips it.
//
//   coefs : w*h int32 sign-magnitude block
//   out   : w*h int32 — global pass index (0-based) where the coefficient
//           becomes significant, or -1 (zero magnitude)
// Returns numbps (0 for an all-zero block) or <0 on error.
extern "C" int64_t j2k_t1_sig_plan(const int32_t* coefs, int w, int h,
                                   int32_t* out) {
    if (w <= 0 || h <= 0 || w > 4096 || h > 4096) return -1;
    T1E t1;
    t1.w = w; t1.h = h; t1.stride = w + 2;
    t1.flags.assign((size_t)(h + 2) * (w + 2), 0);
    t1.mag.resize((size_t)w * h);

    uint32_t maxmag = 0;
    for (size_t k = 0; k < (size_t)w * h; ++k) {
        int32_t v = coefs[k];
        uint32_t m = (uint32_t)(v < 0 ? -(int64_t)v : v);
        t1.mag[k] = m;
        out[k] = -1;
        if (m > maxmag) maxmag = m;
    }
    int numbps = 0;
    while (maxmag >> numbps) ++numbps;
    if (numbps > 31) return -1;
    if (numbps == 0) return 0;

    int plane = numbps - 1;
    int pass_kind = 2;  // top plane starts with cleanup
    int pass_idx = 0;

    while (plane >= 0) {
        const uint32_t bit = 1u << plane;
        if (pass_kind == 0) {
            for (int y0 = 0; y0 < h; y0 += 4)
                for (int x = 0; x < w; ++x) {
                    int ymax = y0 + 4 < h ? y0 + 4 : h;
                    for (int y = y0; y < ymax; ++y) {
                        uint32_t& f = t1.F(y, x);
                        if (f & F_SIG) continue;
                        uint32_t nb = t1.F(y - 1, x) | t1.F(y + 1, x) |
                                      t1.F(y, x - 1) | t1.F(y, x + 1) |
                                      t1.F(y - 1, x - 1) |
                                      t1.F(y - 1, x + 1) |
                                      t1.F(y + 1, x - 1) |
                                      t1.F(y + 1, x + 1);
                        if (!(nb & F_SIG)) continue;
                        f |= F_VISIT;
                        size_t k = (size_t)y * w + x;
                        if (t1.mag[k] & bit) {
                            f |= F_SIG;
                            out[k] = pass_idx;
                        }
                    }
                }
        } else if (pass_kind == 2) {
            for (int y0 = 0; y0 < h; y0 += 4)
                for (int x = 0; x < w; ++x) {
                    int ymax = y0 + 4 < h ? y0 + 4 : h;
                    for (int y = y0; y < ymax; ++y) {
                        uint32_t& f = t1.F(y, x);
                        if (f & F_VISIT) { f &= ~F_VISIT; continue; }
                        if (f & F_SIG) continue;
                        size_t k = (size_t)y * w + x;
                        if (t1.mag[k] & bit) {
                            f |= F_SIG;
                            out[k] = pass_idx;
                        }
                    }
                }
        }
        // MRP (pass_kind == 1) never changes significance
        ++pass_idx;
        if (pass_kind == 2) { pass_kind = 0; --plane; }
        else ++pass_kind;
    }
    return numbps;
}
