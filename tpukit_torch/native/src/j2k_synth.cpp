// DWT lifting (T.800): inverse synthesis (F.3.8 reversible 5/3,
// F.4.8.2 irreversible 9/7) and forward analysis (F.4.8.1), bit-for-bit
// equal to the numpy references in io/jp2.py (_sr1d_53/_sr1d_97 + sr2d
// interleave) and io/j2c_enc.py (_fd1d_53/_fd1d_97).  Used by the EBCOT
// rate ladder's truncated-decode model (J2CPlan.truncated_recon), the
// plan build (J2CPlan.__init__ forward DWT) and the clean-room decoder
// (jp2.JP2Decoder), where host lifting is the wall once packet sizing
// and tier-1 analysis are amortized; the numpy implementations stay as
// the oracle the parity tests pin against.
//
// Exactness notes: IEEE double ops in the same per-element order as the
// numpy expressions; the library builds with -ffp-contract=off so no FMA
// contraction perturbs the 9/7 lifting.  Two structural deviations from
// the 1D-at-a-time numpy form, both value-preserving:
//   * in-place sequential update == numpy's simultaneous vectorized one,
//     because every lifting step writes one parity class while reading
//     only the other;
//   * the VERTICAL pass runs row-wise over the 2D block (contiguous SIMD
//     across x) instead of column-at-a-time: columns are independent, so
//     each element's arithmetic expression — including the whole-point
//     symmetric boundary mirror (index -1 -> 1, n -> n-2), which numpy
//     realizes through its re-extended ext buffer — is unchanged.
//   * `x - c*s` is computed as `x + (-c)*s`: IEEE negation is exact and
//     (-c)*s == -(c*s), so the sum is bit-identical.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double A97 = -1.586134342059924;
constexpr double B97 = -0.052980118572961;
constexpr double G97 = 0.882911075530934;
constexpr double D97 = 0.443506852043971;
constexpr double K97 = 1.230174104914001;

inline int par(int i0) { return ((i0 % 2) + 2) % 2; }

// ---------------------------------------------------------------------------
// 9/7 (float64)
// ---------------------------------------------------------------------------

// one vertical lifting step: rows y = start, start+2, ... get
// a[y] += c * (a[y-1] + a[y+1]) with whole-point mirror at the edges.
// Neighbour rows are always the opposite parity, so in-place is safe and
// the row order is free.
void vstep97(double* a, int64_t h, int64_t w, int64_t start, double c) {
    for (int64_t y = start; y < h; y += 2) {
        const double* up = a + (y == 0 ? 1 : y - 1) * w;
        const double* dn = a + (y == h - 1 ? h - 2 : y + 1) * w;
        double* row = a + y * w;
        for (int64_t x = 0; x < w; ++x) row[x] += c * (up[x] + dn[x]);
    }
}

// vertical scaling: rows of even absolute coordinate apply `ev`, odd `od`
// (op 0 = multiply, 1 = divide — division is NOT folded into a
// reciprocal multiply, matching numpy exactly).
void vscale97(double* a, int64_t h, int64_t w, int v0, bool even_div) {
    const int pe = par(v0);   // y%2 of even-absolute rows
    for (int64_t y = 0; y < h; ++y) {
        double* row = a + y * w;
        const bool even = ((y % 2) == pe);
        if (even == even_div) {
            for (int64_t x = 0; x < w; ++x) row[x] /= K97;
        } else {
            for (int64_t x = 0; x < w; ++x) row[x] *= K97;
        }
    }
}

// one horizontal lifting step over every row.
void hstep97(double* a, int64_t h, int64_t w, int64_t start, double c) {
    for (int64_t y = 0; y < h; ++y) {
        double* r = a + y * w;
        int64_t x = start;
        if (x == 0) {                     // mirror: x-1 -> 1
            r[0] += c * (r[1] + r[1]);
            x = 2;
        }
        const int64_t stop = (w - 1);
        for (; x < stop; x += 2) r[x] += c * (r[x - 1] + r[x + 1]);
        if (x == w - 1)                   // mirror: w -> w-2
            r[x] += c * (r[x - 1] + r[w - 2]);
    }
}

void hscale97(double* a, int64_t h, int64_t w, int u0, bool even_div) {
    const int pe = par(u0);
    for (int64_t y = 0; y < h; ++y) {
        double* r = a + y * w;
        for (int64_t x = 0; x < w; ++x) {
            const bool even = ((x % 2) == pe);
            if (even == even_div) r[x] /= K97;
            else r[x] *= K97;
        }
    }
}

// n==1 1D special cases (scaling only), applied to a whole row / column
// vector of the 2D array.
void one97_rows(double* a, int64_t w, int i0, bool synth) {
    // single ROW (vertical n==1): synthesis multiplies by K (even) or
    // 1/K (odd); forward divides by K (even) or multiplies by K (odd).
    if (synth) {
        const double f = (par(i0) == 0) ? K97 : (1.0 / K97);
        for (int64_t x = 0; x < w; ++x) a[x] *= f;
    } else if (par(i0) == 0) {
        for (int64_t x = 0; x < w; ++x) a[x] /= K97;
    } else {
        for (int64_t x = 0; x < w; ++x) a[x] *= K97;
    }
}

void one97_cols(double* a, int64_t h, int64_t w, int i0, bool synth) {
    // single COLUMN (horizontal n==1) across all rows.
    if (synth) {
        const double f = (par(i0) == 0) ? K97 : (1.0 / K97);
        for (int64_t y = 0; y < h; ++y) a[y * w] *= f;
    } else if (par(i0) == 0) {
        for (int64_t y = 0; y < h; ++y) a[y * w] /= K97;
    } else {
        for (int64_t y = 0; y < h; ++y) a[y * w] *= K97;
    }
}

// ---------------------------------------------------------------------------
// 5/3 (int64)
// ---------------------------------------------------------------------------

// kind 0: += (l + r) >> 1        (synthesis odd step)
// kind 1: -= (l + r + 2) >> 2    (synthesis even step)
// kind 2: -= (l + r) >> 1        (forward odd step)
// kind 3: += (l + r + 2) >> 2    (forward even step)
inline int64_t lift53(int64_t v, int64_t l, int64_t r, int kind) {
    switch (kind) {
        case 0: return v + ((l + r) >> 1);
        case 1: return v - ((l + r + 2) >> 2);
        case 2: return v - ((l + r) >> 1);
        default: return v + ((l + r + 2) >> 2);
    }
}

void vstep53(int64_t* a, int64_t h, int64_t w, int64_t start, int kind) {
    for (int64_t y = start; y < h; y += 2) {
        const int64_t* up = a + (y == 0 ? 1 : y - 1) * w;
        const int64_t* dn = a + (y == h - 1 ? h - 2 : y + 1) * w;
        int64_t* row = a + y * w;
        for (int64_t x = 0; x < w; ++x)
            row[x] = lift53(row[x], up[x], dn[x], kind);
    }
}

void hstep53(int64_t* a, int64_t h, int64_t w, int64_t start, int kind) {
    for (int64_t y = 0; y < h; ++y) {
        int64_t* r = a + y * w;
        int64_t x = start;
        if (x == 0) {
            r[0] = lift53(r[0], r[1], r[1], kind);
            x = 2;
        }
        const int64_t stop = (w - 1);
        for (; x < stop; x += 2)
            r[x] = lift53(r[x], r[x - 1], r[x + 1], kind);
        if (x == w - 1)
            r[x] = lift53(r[x], r[x - 1], r[w - 2], kind);
    }
}

inline int64_t half_floor(int64_t x) {
    // floor(x/2) via the numpy sign trick: x - sign(x)*(|x|%2) is even,
    // then exact division (identical to the reference expression).
    int64_t m = x < 0 ? -((-x) % 2) : x % 2;
    return (x - m) / 2;
}

}  // namespace

// ---------------------------------------------------------------------------
// public entry points
// ---------------------------------------------------------------------------

// One 2D 9/7 synthesis level, in place on the ALREADY-INTERLEAVED (h, w)
// row-major array (caller does the F.3.3 subband interleave in numpy —
// cheap strided stores).  u0/v0 are the absolute coords of the region's
// top-left (parity selects the even/odd phase, exactly as jp2.sr2d_97).
// Pass order matches numpy sr2d_97: horizontal rows first, then vertical.
extern "C" int64_t j2k_sr2d_97(double* a, int64_t h, int64_t w,
                               int32_t u0, int32_t v0) {
    if (h < 0 || w < 0) return -1;
    if (h == 0 || w == 0) return 0;
    // horizontal (per-row 1D synthesis along x)
    if (w == 1) {
        one97_cols(a, h, w, u0, true);
    } else {
        const int64_t se = par(u0), so = 1 - par(u0);
        hscale97(a, h, w, u0, /*even_div=*/false);   // even *K, odd /K
        hstep97(a, h, w, se, -D97);
        hstep97(a, h, w, so, -G97);
        hstep97(a, h, w, se, -B97);
        hstep97(a, h, w, so, -A97);
    }
    // vertical (row-wise steps)
    if (h == 1) {
        one97_rows(a, w, v0, true);
    } else {
        const int64_t se = par(v0), so = 1 - par(v0);
        vscale97(a, h, w, v0, /*even_div=*/false);
        vstep97(a, h, w, se, -D97);
        vstep97(a, h, w, so, -G97);
        vstep97(a, h, w, se, -B97);
        vstep97(a, h, w, so, -A97);
    }
    return 0;
}

// One 2D 5/3 synthesis level, in place (int64), same contract.
extern "C" int64_t j2k_sr2d_53(int64_t* a, int64_t h, int64_t w,
                               int32_t u0, int32_t v0) {
    if (h < 0 || w < 0) return -1;
    if (h == 0 || w == 0) return 0;
    if (w == 1) {
        if (par(u0)) for (int64_t y = 0; y < h; ++y)
            a[y * w] = half_floor(a[y * w]);
    } else {
        const int64_t se = par(u0), so = 1 - par(u0);
        hstep53(a, h, w, se, 1);    // even -= (l+r+2)>>2
        hstep53(a, h, w, so, 0);    // odd  += (l+r)>>1
    }
    if (h == 1) {
        if (par(v0)) for (int64_t x = 0; x < w; ++x)
            a[x] = half_floor(a[x]);
    } else {
        const int64_t se = par(v0), so = 1 - par(v0);
        vstep53(a, h, w, se, 1);
        vstep53(a, h, w, so, 0);
    }
    return 0;
}

// One 2D 9/7 ANALYSIS level, in place; exact inverse of j2k_sr2d_97 and
// bit-equal to j2c_enc.fd2d_97's lifting (deinterleave stays in numpy).
// Pass order matches numpy fd2d_97: vertical first, then horizontal;
// each 1D pass is alpha(odd), beta(even), gamma(odd), delta(even), then
// scaling even /K, odd *K.
extern "C" int64_t j2k_fd2d_97(double* a, int64_t h, int64_t w,
                               int32_t u0, int32_t v0) {
    if (h < 0 || w < 0) return -1;
    if (h == 0 || w == 0) return 0;
    if (h == 1) {
        one97_rows(a, w, v0, false);
    } else {
        const int64_t se = par(v0), so = 1 - par(v0);
        vstep97(a, h, w, so, A97);
        vstep97(a, h, w, se, B97);
        vstep97(a, h, w, so, G97);
        vstep97(a, h, w, se, D97);
        vscale97(a, h, w, v0, /*even_div=*/true);    // even /K, odd *K
    }
    if (w == 1) {
        one97_cols(a, h, w, u0, false);
    } else {
        const int64_t se = par(u0), so = 1 - par(u0);
        hstep97(a, h, w, so, A97);
        hstep97(a, h, w, se, B97);
        hstep97(a, h, w, so, G97);
        hstep97(a, h, w, se, D97);
        hscale97(a, h, w, u0, /*even_div=*/true);
    }
    return 0;
}

// One 2D 5/3 ANALYSIS level, in place (int64); exact inverse of
// j2k_sr2d_53 and bit-equal to j2c_enc.fd2d_53's lifting.
extern "C" int64_t j2k_fd2d_53(int64_t* a, int64_t h, int64_t w,
                               int32_t u0, int32_t v0) {
    if (h < 0 || w < 0) return -1;
    if (h == 0 || w == 0) return 0;
    if (h == 1) {
        if (par(v0)) for (int64_t x = 0; x < w; ++x) a[x] *= 2;
    } else {
        const int64_t se = par(v0), so = 1 - par(v0);
        vstep53(a, h, w, so, 2);    // odd  -= (l+r)>>1
        vstep53(a, h, w, se, 3);    // even += (l+r+2)>>2
    }
    if (w == 1) {
        if (par(u0)) for (int64_t y = 0; y < h; ++y) a[y * w] *= 2;
    } else {
        const int64_t se = par(u0), so = 1 - par(u0);
        hstep53(a, h, w, so, 2);
        hstep53(a, h, w, se, 3);
    }
    return 0;
}

// Truncated-decode model band reconstruction (J2CPlan._band_recon hot
// path): one fused pass over the band instead of ~10 numpy temporaries.
// Per coefficient (same closed forms as the numpy reference, which the
// parity tests keep as oracle):
//   alive   = 0 <= sig < K          (became significant before the cut)
//   lastp   = min(p0, ql)           (last decoded magnitude plane)
//   mag_dec = alive ? mag & ~((1<<lastp)-1) : 0
//   rev:   out = sgn * (mag_dec + (lastp>=1 ? 1<<(lastp-1) : 0))
//   irrev: out = sgn * (mag_dec + 0.5*2^lastp) * step   (float64)
// K and ql ride as per-coefficient int32 maps (the caller broadcasts its
// per-block picks); out is int64 (rev) or float64.
extern "C" int64_t j2k_band_recon(const int32_t* sig, const int32_t* mag,
                                  const int8_t* sgn, const int8_t* p0,
                                  const int32_t* km, const int32_t* ql,
                                  int64_t n, double step, int32_t rev,
                                  void* out) {
    if (n < 0) return -1;
    if (rev) {
        int64_t* o = static_cast<int64_t*>(out);
        for (int64_t i = 0; i < n; ++i) {
            const int32_t K = km[i];
            const bool alive = sig[i] >= 0 && sig[i] < K;
            int64_t v = 0;
            if (alive) {
                const int lp = p0[i] < ql[i] ? p0[i] : ql[i];
                const int64_t md =
                    (int64_t)mag[i] & ~(((int64_t)1 << lp) - 1);
                if (md > 0) {
                    const int64_t half =
                        lp >= 1 ? ((int64_t)1 << (lp - 1)) : 0;
                    v = (int64_t)sgn[i] * (md + half);
                }
            }
            o[i] = v;
        }
    } else {
        double* o = static_cast<double*>(out);
        for (int64_t i = 0; i < n; ++i) {
            const int32_t K = km[i];
            const bool alive = sig[i] >= 0 && sig[i] < K;
            double v = 0.0;
            if (alive) {
                const int lp = p0[i] < ql[i] ? p0[i] : ql[i];
                const int64_t md =
                    (int64_t)mag[i] & ~(((int64_t)1 << lp) - 1);
                if (md > 0) {
                    const double half = 0.5 * (double)((int64_t)1 << lp);
                    v = (double)sgn[i] * ((double)md + half) * step;
                }
            }
            o[i] = v;
        }
    }
    return 0;
}

// Decoder-side irreversible dequantization with per-coefficient midpoint
// (jp2.band_array_f's hot inner expression, fused): for each coefficient
// v with last decoded plane lastp, out = sign(v) * (|v| + 0.5*2^max(lastp,0))
// * step, and 0 for v == 0 — identical per-element arithmetic and
// association order to the numpy form (abs/exp2 of small ints are exact
// in f64), which stays as the oracle.
extern "C" int64_t j2k_dequant_mid(const int32_t* blk, const int32_t* lastp,
                                   int64_t n, double step, double* out) {
    if (n < 0) return -1;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t v = blk[i];
        if (v == 0) { out[i] = 0.0; continue; }
        const double mag = v < 0 ? -(double)v : (double)v;
        const int lp = lastp[i] > 0 ? lastp[i] : 0;
        const double half = 0.5 * (double)((int64_t)1 << lp);
        const double s = v < 0 ? -1.0 : 1.0;
        out[i] = (s * (mag + half)) * step;
    }
    return 0;
}
