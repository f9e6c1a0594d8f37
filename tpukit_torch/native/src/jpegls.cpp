// JPEG-LS (ITU-T T.87 / ISO 14495-1) encoder/decoder, single component,
// 2..16 bit samples, NEAR-lossless (0..255), regular + run modes.
//
// The reference encodes/decodes per-band planes through CharLS via
// imagecodecs (reference tools/codecs/jpegls/encode_one_band.py:56,
// decode_one_band.py:30). This is a clean-room implementation of the same
// interchange format (SOI/SOF55/SOS/EOI framing, LSE preset parsing on
// decode, run mode, NEAR) whose entropy-coded payload is BYTE-IDENTICAL
// to libcharls's output — fuzz-pinned across bit depths 2..16, NEAR
// 0..255, and content classes in tests/test_jpegls_charls_parity.py;
// round-trip and NEAR-bound properties in tests/test_jpegls.py.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int DEFAULT_RESET = 64;
constexpr int MIN_C = -128, MAX_C = 127;

const int J[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                   4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct Params {
    int maxval, near, range, qbpp, bpp, limit;
    int t1, t2, t3, reset;
};

static int clampv(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

static Params make_params(int maxval, int near) {
    Params p;
    p.maxval = maxval;
    p.near = near;
    p.reset = DEFAULT_RESET;
    p.range = (maxval + 2 * near) / (2 * near + 1) + 1;
    int v = 1;
    p.qbpp = 0;
    while (v < p.range) { v <<= 1; ++p.qbpp; }
    v = 1; p.bpp = 0;
    while (v < maxval + 1) { v <<= 1; ++p.bpp; }
    if (p.bpp < 2) p.bpp = 2;
    p.limit = 2 * (p.bpp + (p.bpp < 8 ? 8 : p.bpp));
    // Default thresholds (T.87 C.2.4.1.1.1 formulas, WITHOUT the CLAMP to
    // [NEAR+1, MAXVAL]). CharLS — the de-facto interchange reference and
    // the engine the reference pipeline runs through imagecodecs — applies
    // the raw formulas only; applying the clamps breaks interop whenever
    // they are active (empirically pinned byte-for-byte against libcharls
    // across maxval 3..65535, NEAR 0..255 — tests/test_jpegls_charls_parity.py).
    if (maxval >= 128) {
        int factor = ((maxval < 4095 ? maxval : 4095) + 128) / 256;
        p.t1 = factor * (3 - 2) + 2 + 3 * near;
        p.t2 = factor * (7 - 3) + 3 + 5 * near;
        p.t3 = factor * (21 - 4) + 4 + 7 * near;
    } else {
        int factor = 256 / (maxval + 1);
        p.t1 = 3 / factor + 3 * near; if (p.t1 < 2) p.t1 = 2;
        p.t2 = 7 / factor + 5 * near; if (p.t2 < 3) p.t2 = 3;
        p.t3 = 21 / factor + 7 * near; if (p.t3 < 4) p.t3 = 4;
    }
    return p;
}

struct Ctx {
    int A[367], B[365], C[365], N[367], Nn[2];
    void init(const Params& p) {
        int a0 = (p.range + 32) / 64;
        if (a0 < 2) a0 = 2;
        for (int i = 0; i < 367; ++i) { A[i] = a0; N[i] = 1; }
        std::memset(B, 0, sizeof(B));
        std::memset(C, 0, sizeof(C));
        Nn[0] = Nn[1] = 0;
    }
};

// --- JPEG-LS bit I/O with 0xFF bit-stuffing --------------------------------

struct JlsWriter {
    std::vector<uint8_t>& out;
    uint32_t acc = 0;
    int nfree = 8;
    explicit JlsWriter(std::vector<uint8_t>& o) : out(o) {}

    inline void put_bit(int b) {
        acc = (acc << 1) | (b & 1);
        if (--nfree == 0) flush_byte();
    }
    inline void put_bits(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; --i) put_bit((v >> i) & 1);
    }
    inline void put_zeros(int n) { for (int i = 0; i < n; ++i) put_bit(0); }
    inline void flush_byte() {
        out.push_back((uint8_t)acc);
        nfree = (acc == 0xFF) ? 7 : 8;  // byte after FF carries 7 bits, MSB=0
        acc = 0;
    }
    void align() {
        while (nfree != 8) put_bit(0);
    }
};

struct JlsReader {
    const uint8_t* buf;
    int64_t n;
    int64_t pos = 0;
    uint32_t acc = 0;
    int navail = 0;
    bool prev_ff = false;
    bool error = false;

    JlsReader(const uint8_t* b, int64_t nn) : buf(b), n(nn) {}

    inline int get_bit() {
        if (navail == 0) {
            if (pos >= n) { error = true; return 0; }
            uint8_t byte = buf[pos++];
            if (prev_ff) {
                acc = byte & 0x7F;
                navail = 7;
                prev_ff = false;
            } else {
                acc = byte;
                navail = 8;
                prev_ff = (byte == 0xFF);
            }
        }
        --navail;
        return (acc >> navail) & 1;
    }
    inline uint32_t get_bits(int k) {
        uint32_t v = 0;
        for (int i = 0; i < k; ++i) v = (v << 1) | get_bit();
        return v;
    }
    inline uint32_t get_unary() {
        uint32_t z = 0;
        while (!error && get_bit() == 0) {
            if (++z > (1u << 20)) { error = true; break; }
        }
        return z;
    }
};

// --- shared helpers --------------------------------------------------------

static inline int quantize_gradient(int d, const Params& p) {
    if (d <= -p.t3) return -4;
    if (d <= -p.t2) return -3;
    if (d <= -p.t1) return -2;
    if (d < -p.near) return -1;
    if (d <= p.near) return 0;
    if (d < p.t1) return 1;
    if (d < p.t2) return 2;
    if (d < p.t3) return 3;
    return 4;
}

static inline int med_predict(int a, int b, int c) {
    int mn = a < b ? a : b, mx = a < b ? b : a;
    if (c >= mx) return mn;
    if (c <= mn) return mx;
    return a + b - c;
}

static inline int modrange(int e, int range) {
    if (e < 0) e += range;
    if (e >= (range + 1) / 2) e -= range;
    return e;
}

struct Scan {
    Params p;
    Ctx cx;
    int W = 0, H = 0;
    std::vector<uint16_t> prev, cur;
    int prev_first_above = 0;  // Rb at the previous line's first sample -> Rc(col 0)

    void init(int w, int h, int maxval, int near) {
        W = w; H = h;
        p = make_params(maxval, near);
        cx.init(p);
        prev.assign(w, 0);
        cur.assign(w, 0);
        prev_first_above = 0;
    }

    inline void neighbors(int col, int& a, int& b, int& c, int& d) const {
        b = prev[col];
        c = (col == 0) ? prev_first_above : prev[col - 1];
        a = (col == 0) ? b : cur[col - 1];
        d = (col + 1 < W) ? prev[col + 1] : b;
    }

    void next_line() {
        prev_first_above = prev[0];
        std::swap(prev, cur);
    }
};

static inline void regular_update(Ctx& cx, int q, int errval, int near,
                                  int reset) {
    cx.B[q] += errval * (2 * near + 1);
    cx.A[q] += std::abs(errval);
    if (cx.N[q] == reset) {
        cx.A[q] >>= 1;
        cx.B[q] = cx.B[q] >= 0 ? cx.B[q] >> 1 : -((1 - cx.B[q]) >> 1);
        cx.N[q] >>= 1;
    }
    ++cx.N[q];
    if (cx.B[q] <= -cx.N[q]) {
        if (cx.C[q] > MIN_C) --cx.C[q];
        cx.B[q] += cx.N[q];
        if (cx.B[q] <= -cx.N[q]) cx.B[q] = -cx.N[q] + 1;
    } else if (cx.B[q] > 0) {
        if (cx.C[q] < MAX_C) ++cx.C[q];
        cx.B[q] -= cx.N[q];
        if (cx.B[q] > 0) cx.B[q] = 0;
    }
}

// --- encoder ---------------------------------------------------------------

static void encode_golomb(JlsWriter& bw, uint32_t merr, int k, int limit, int qbpp) {
    uint32_t hi = merr >> k;
    if ((int)hi < limit) {
        bw.put_zeros((int)hi);
        bw.put_bit(1);
        bw.put_bits(merr & ((1u << k) - 1u), k);
    } else {
        bw.put_zeros(limit);
        bw.put_bit(1);
        bw.put_bits(merr - 1, qbpp);
    }
}

static int64_t jls_encode_impl(const uint16_t* img, int W, int H, int near,
                               int bits, std::vector<uint8_t>& out) {
    int maxval = (1 << bits) - 1;
    Scan s;
    s.init(W, H, maxval, near);
    const Params& p = s.p;
    Ctx& cx = s.cx;

    auto put16 = [&](int v) { out.push_back((v >> 8) & 0xFF); out.push_back(v & 0xFF); };
    out.push_back(0xFF); out.push_back(0xD8);            // SOI
    out.push_back(0xFF); out.push_back(0xF7);            // SOF55
    put16(11); out.push_back((uint8_t)bits);
    put16(H); put16(W);
    out.push_back(1);
    out.push_back(1); out.push_back(0x11); out.push_back(0);
    if (bits > 12) {
        // CharLS emits an LSE preset marker (T.87 C.2.4.1.1, id=1) for
        // precision > 12, carrying MAXVAL and the DEFAULT thresholds it
        // uses anyway; emit the identical marker for full-file parity
        // (reference runs CharLS via imagecodecs, encode_one_band.py:56).
        out.push_back(0xFF); out.push_back(0xF8);        // LSE
        put16(13); out.push_back(1);
        put16(maxval);
        put16(p.t1); put16(p.t2); put16(p.t3);
        put16(p.reset);
    }
    out.push_back(0xFF); out.push_back(0xDA);            // SOS
    put16(8); out.push_back(1); out.push_back(1); out.push_back(0);
    out.push_back((uint8_t)near); out.push_back(0); out.push_back(0);

    JlsWriter bw(out);
    int run_index = 0;

    for (int row = 0; row < H; ++row) {
        const uint16_t* x = img + (int64_t)row * W;
        for (int col = 0; col < W; ) {
            int a, b, c, d;
            s.neighbors(col, a, b, c, d);
            int q1 = quantize_gradient(d - b, p);
            int q2 = quantize_gradient(b - c, p);
            int q3 = quantize_gradient(c - a, p);

            if (q1 == 0 && q2 == 0 && q3 == 0) {
                // ---- run mode ----
                int runval = a;
                int runcnt = 0;
                while (col < W && std::abs((int)x[col] - runval) <= p.near) {
                    s.cur[col] = (uint16_t)runval;
                    ++col; ++runcnt;
                }
                bool hit_eol = (col == W);
                while (runcnt >= (1 << J[run_index])) {
                    bw.put_bit(1);
                    runcnt -= (1 << J[run_index]);
                    if (run_index < 31) ++run_index;
                }
                if (!hit_eol) {
                    bw.put_bit(0);
                    bw.put_bits((uint32_t)runcnt, J[run_index]);
                    // ---- run interruption sample ----
                    s.neighbors(col, a, b, c, d);
                    int ritype = (std::abs(a - b) <= p.near) ? 1 : 0;
                    int px = ritype ? a : b;
                    int sign = (!ritype && a > b) ? -1 : 1;
                    int errval = (int)x[col] - px;
                    if (sign < 0) errval = -errval;
                    if (p.near > 0) {
                        if (errval > 0) errval = (errval + p.near) / (2 * p.near + 1);
                        else errval = -((p.near - errval) / (2 * p.near + 1));
                        s.cur[col] = (uint16_t)clampv(
                            px + sign * errval * (2 * p.near + 1), 0, p.maxval);
                    } else {
                        s.cur[col] = x[col];
                    }
                    errval = modrange(errval, p.range);
                    int ctx = 365 + ritype;
                    int temp = ritype ? (cx.A[366] + (cx.N[366] >> 1)) : cx.A[365];
                    int k = 0;
                    while ((cx.N[ctx] << k) < temp) ++k;
                    int map;
                    if (k == 0 && errval > 0 && 2 * cx.Nn[ritype] < cx.N[ctx]) map = 1;
                    else if (errval < 0 && 2 * cx.Nn[ritype] >= cx.N[ctx]) map = 1;
                    else if (errval < 0 && k != 0) map = 1;
                    else map = 0;
                    uint32_t emerr = (uint32_t)(2 * std::abs(errval) - ritype - map);
                    // T.87 A.7.3: the run-interruption LIMIT is
                    // LIMIT - J[RUNindex] - 1, and A.5.3's escape threshold
                    // subtracts a further qbpp + 1 from the LIMIT in effect
                    encode_golomb(bw, emerr, k,
                                  p.limit - J[run_index] - 1 - p.qbpp - 1,
                                  p.qbpp);
                    if (errval < 0) ++cx.Nn[ritype];
                    cx.A[ctx] += ((int)emerr + 1 - ritype) >> 1;
                    if (cx.N[ctx] == p.reset) {
                        cx.A[ctx] >>= 1; cx.N[ctx] >>= 1; cx.Nn[ritype] >>= 1;
                    }
                    ++cx.N[ctx];
                    if (run_index > 0) --run_index;
                    ++col;
                } else {
                    if (runcnt > 0) bw.put_bit(1);
                }
                continue;
            }

            // ---- regular mode ----
            int sign = 1;
            int q = 81 * q1 + 9 * q2 + q3;
            if (q < 0) { q = -q; sign = -1; }
            int px = clampv(med_predict(a, b, c) + sign * cx.C[q], 0, p.maxval);
            int errval = (int)x[col] - px;
            if (sign < 0) errval = -errval;
            if (p.near > 0) {
                if (errval > 0) errval = (errval + p.near) / (2 * p.near + 1);
                else errval = -((p.near - errval) / (2 * p.near + 1));
                s.cur[col] = (uint16_t)clampv(
                    px + sign * errval * (2 * p.near + 1), 0, p.maxval);
            } else {
                s.cur[col] = x[col];
            }
            errval = modrange(errval, p.range);
            int k = 0;
            while ((cx.N[q] << k) < cx.A[q]) ++k;
            uint32_t merr;
            if (p.near == 0 && k == 0 && 2 * cx.B[q] <= -cx.N[q]) {
                merr = (errval >= 0) ? (uint32_t)(2 * errval + 1)
                                     : (uint32_t)(-2 * (errval + 1));
            } else {
                merr = (errval >= 0) ? (uint32_t)(2 * errval)
                                     : (uint32_t)(-2 * errval - 1);
            }
            encode_golomb(bw, merr, k, p.limit - p.qbpp - 1, p.qbpp);
            regular_update(cx, q, errval, p.near, p.reset);
            ++col;
        }
        s.next_line();
    }
    bw.align();
    out.push_back(0xFF); out.push_back(0xD9);  // EOI
    return (int64_t)out.size();
}

// --- decoder ---------------------------------------------------------------

static uint32_t decode_golomb(JlsReader& br, int k, int limit, int qbpp) {
    uint32_t hi = br.get_unary();
    if ((int)hi < limit) return (hi << k) | br.get_bits(k);
    return br.get_bits(qbpp) + 1;
}

static int64_t jls_decode_impl(const uint8_t* in, int64_t nbytes, uint16_t* img,
                               int* out_w, int* out_h, int expect_w, int expect_h) {
    int64_t pos = 0;
    auto rd16 = [&](int64_t at) { return ((int)in[at] << 8) | in[at + 1]; };
    if (nbytes < 4 || in[0] != 0xFF || in[1] != 0xD8) return -1;
    pos = 2;
    int bits = 0, W = 0, H = 0, near = 0;
    // LSE (0xFFF8 id=1) preset overrides; -1 == absent, 0 == keep default
    int lse_maxval = -1, lse_t1 = -1, lse_t2 = -1, lse_t3 = -1,
        lse_reset = -1;
    bool got_sos = false;
    while (pos + 4 <= nbytes && !got_sos) {
        if (in[pos] != 0xFF) return -2;
        int marker = in[pos + 1];
        int len = rd16(pos + 2);
        // every segment read below must stay inside the buffer — a
        // truncated/hostile stream must fail cleanly, not overread
        if (len < 2 || pos + 2 + len > nbytes) return -2;
        if (marker == 0xF7) {                 // SOF55
            if (len < 7) return -2;
            bits = in[pos + 4];
            H = rd16(pos + 5);
            W = rd16(pos + 7);
        } else if (marker == 0xF8 && len >= 3 && in[pos + 4] == 1) {
            // LSE preset coding parameters (T.87 C.2.4.1.1); CharLS emits
            // one on >12-bit streams. A field value of 0 keeps the default.
            if (len < 13) return -2;
            lse_maxval = rd16(pos + 5);
            lse_t1 = rd16(pos + 7);
            lse_t2 = rd16(pos + 9);
            lse_t3 = rd16(pos + 11);
            lse_reset = rd16(pos + 13);
        } else if (marker == 0xDA) {          // SOS
            if (len < 4) return -2;
            int ns = in[pos + 4];
            if (len < 2 + 1 + 2 * ns + 3) return -2;
            near = in[pos + 5 + 2 * ns];
            got_sos = true;
        } else if (marker == 0xD9) {
            return -3;
        }
        pos += 2 + len;
    }
    if (!got_sos || W <= 0 || H <= 0 || bits < 2 || bits > 16) return -4;
    // dimension-discovery mode (expect_w <= 0) has no output-capacity
    // contract; reject it for decode so a stream-declared size can never
    // overflow the caller's buffer (callers probe headers separately)
    if (expect_w <= 0) return -7;
    if (W != expect_w || H != expect_h) return -5;
    *out_w = W; *out_h = H;

    int maxval = (1 << bits) - 1;
    if (lse_maxval > 0) {
        if (lse_maxval > maxval) return -9;
        maxval = lse_maxval;               // lowers RANGE/qbpp/LIMIT too
    }
    Scan s;
    s.init(W, H, maxval, near);
    if (lse_t1 > 0) s.p.t1 = lse_t1;
    if (lse_t2 > 0) s.p.t2 = lse_t2;
    if (lse_t3 > 0) s.p.t3 = lse_t3;
    if (lse_reset > 2) s.p.reset = lse_reset;
    if (s.p.t1 < near + 1 || s.p.t2 < s.p.t1 || s.p.t3 < s.p.t2) return -9;
    const Params& p = s.p;
    Ctx& cx = s.cx;
    JlsReader br(in + pos, nbytes - pos);
    int run_index = 0;
    const int wrap = p.range * (2 * p.near + 1);

    for (int row = 0; row < H; ++row) {
        for (int col = 0; col < W; ) {
            int a, b, c, d;
            s.neighbors(col, a, b, c, d);
            int q1 = quantize_gradient(d - b, p);
            int q2 = quantize_gradient(b - c, p);
            int q3 = quantize_gradient(c - a, p);

            if (q1 == 0 && q2 == 0 && q3 == 0) {
                // ---- run mode ----
                int runval = a;
                bool interrupted = false;
                while (col < W) {
                    int bit = br.get_bit();
                    if (br.error) return -6;
                    if (bit == 1) {
                        int cnt = 1 << J[run_index];
                        if (cnt <= W - col) {
                            for (int i = 0; i < cnt; ++i) s.cur[col + i] = (uint16_t)runval;
                            col += cnt;
                            if (run_index < 31) ++run_index;
                            if (col == W) break;        // exact fill
                        } else {
                            // final '1' at EOL: leftover samples to line end
                            while (col < W) s.cur[col++] = (uint16_t)runval;
                            break;
                        }
                    } else {
                        int cnt = (int)br.get_bits(J[run_index]);
                        // the interruption SAMPLE must still fit on the
                        // line (cnt == W - col would push col to W and
                        // index past the row buffers)
                        if (cnt >= W - col) return -7;
                        for (int i = 0; i < cnt; ++i) s.cur[col + i] = (uint16_t)runval;
                        col += cnt;
                        interrupted = true;
                        break;
                    }
                }
                if (interrupted) {
                    // ---- run interruption sample ----
                    s.neighbors(col, a, b, c, d);
                    int ritype = (std::abs(a - b) <= p.near) ? 1 : 0;
                    int px = ritype ? a : b;
                    int sign = (!ritype && a > b) ? -1 : 1;
                    int ctx = 365 + ritype;
                    int temp = ritype ? (cx.A[366] + (cx.N[366] >> 1)) : cx.A[365];
                    int k = 0;
                    while ((cx.N[ctx] << k) < temp) ++k;
                    // A.7.3 + A.5.3: escape threshold is
                    // (LIMIT - J[RUNindex] - 1) - qbpp - 1
                    uint32_t emerr = decode_golomb(
                        br, k, p.limit - J[run_index] - 1 - p.qbpp - 1,
                        p.qbpp);
                    if (br.error) return -8;
                    // invert EMErrval = 2|e| - RItype - map
                    int tmp = (int)emerr + ritype;
                    int map = tmp & 1;
                    int mag = (tmp + map) / 2;
                    bool pred = (k != 0 || 2 * cx.Nn[ritype] >= cx.N[ctx]);
                    int errval = (map == (int)pred) ? -mag : mag;
                    int rx = px + sign * errval * (2 * p.near + 1);
                    if (rx < -p.near) rx += wrap;
                    else if (rx > p.maxval + p.near) rx -= wrap;
                    s.cur[col] = (uint16_t)clampv(rx, 0, p.maxval);
                    if (errval < 0) ++cx.Nn[ritype];
                    cx.A[ctx] += ((int)emerr + 1 - ritype) >> 1;
                    if (cx.N[ctx] == p.reset) {
                        cx.A[ctx] >>= 1; cx.N[ctx] >>= 1; cx.Nn[ritype] >>= 1;
                    }
                    ++cx.N[ctx];
                    if (run_index > 0) --run_index;
                    ++col;
                }
                continue;
            }

            // ---- regular mode ----
            int sign = 1;
            int q = 81 * q1 + 9 * q2 + q3;
            if (q < 0) { q = -q; sign = -1; }
            int px = clampv(med_predict(a, b, c) + sign * cx.C[q], 0, p.maxval);
            int k = 0;
            while ((cx.N[q] << k) < cx.A[q]) ++k;
            uint32_t merr = decode_golomb(br, k, p.limit - p.qbpp - 1, p.qbpp);
            if (br.error) return -9;
            int errval;
            if (p.near == 0 && k == 0 && 2 * cx.B[q] <= -cx.N[q]) {
                errval = (merr & 1) ? (int)((merr - 1) / 2) : -(int)(merr / 2) - 1;
            } else {
                errval = (merr & 1) ? -(int)((merr + 1) / 2) : (int)(merr / 2);
            }
            int rx = px + sign * errval * (2 * p.near + 1);
            if (rx < -p.near) rx += wrap;
            else if (rx > p.maxval + p.near) rx -= wrap;
            s.cur[col] = (uint16_t)clampv(rx, 0, p.maxval);
            regular_update(cx, q, errval, p.near, p.reset);
            ++col;
        }
        uint16_t* outrow = img + (int64_t)row * W;
        std::memcpy(outrow, s.cur.data(), (size_t)W * sizeof(uint16_t));
        s.next_line();
    }
    return (int64_t)W * H;
}

}  // namespace

extern "C" int64_t jls_encode(const uint16_t* img, int W, int H, int near,
                              int bits, uint8_t* out, int64_t out_cap) {
    if (W <= 0 || H <= 0 || W > 65535 || H > 65535) return -11;
    if (bits < 2 || bits > 16 || near < 0 || near > 255) return -12;
    std::vector<uint8_t> buf;
    buf.reserve((int64_t)W * H * 2 + 1024);
    int64_t n = jls_encode_impl(img, W, H, near, bits, buf);
    if (n < 0) return n;
    if (n > out_cap) return -100;
    std::memcpy(out, buf.data(), (size_t)n);
    return n;
}

extern "C" int64_t jls_decode(const uint8_t* in, int64_t nbytes, uint16_t* img,
                              int expect_w, int expect_h, int* out_w, int* out_h) {
    return jls_decode_impl(in, nbytes, img, out_w, out_h, expect_w, expect_h);
}
