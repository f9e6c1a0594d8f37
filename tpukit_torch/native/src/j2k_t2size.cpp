// Exact single-layer J2K packet-header size (tier-2), without emitting
// bytes.  Bit-for-bit mirror of io/j2c_enc.J2CPlan._packet for the
// one-precinct, one-layer case the PCRD bisection evaluates: inclusion
// tag tree at threshold 1, zero-bitplane tag tree, the B.10.6
// number-of-passes codeword, Lblock signalling, and the 0xFF bit-stuffing
// rule of the header bit writer.  The rate-control bisection in
// at_size_multi calls this per trial instead of assembling whole
// codestreams (reference j2k_wrap.py re-runs gdal_translate per rate
// point; here a trial is a few microseconds).
//
// The body contribution needs no emission at all: pass_len[p] already IS
// the minimal truncated length of the pass-p prefix, so the caller sums
// it in numpy.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Mirror of j2c_enc.HdrBitWriter, counting flushed bytes only.  After a
// full 0xFF byte the next byte holds 7 bits (stuffing); flush pads the
// partial byte with zeros, or appends the stuffed zero byte when the
// last full byte was 0xFF.
struct BitCounter {
    int64_t nbytes = 0;
    uint32_t cur = 0;
    int bits = 0, cap = 8;

    void put(int b) {
        cur = (cur << 1) | (uint32_t)(b & 1);
        if (++bits == cap) {
            ++nbytes;
            cap = (cur == 0xFFu) ? 7 : 8;
            cur = 0;
            bits = 0;
        }
    }
    void put_bits(int64_t v, int n) {
        for (int k = n - 1; k >= 0; --k) put((int)((v >> k) & 1));
    }
    int64_t flush() const {
        if (bits) return nbytes + 1;      // zero-padded partial byte
        if (cap == 7) return nbytes + 1;  // stuffed zero after 0xFF
        return nbytes;
    }
};

// Mirror of j2c_enc.TagTreeEnc (itself the encoder dual of
// jp2.TagTree.decode).
struct TagTree {
    int nlv = 0;
    int dw[32], dh[32];
    int off[33];
    std::vector<int64_t> value, vmin;
    std::vector<uint8_t> known;

    void init(int w, int h, const int64_t* leaves) {
        nlv = 0;
        int ww = w, hh = h;
        for (;;) {
            dw[nlv] = ww; dh[nlv] = hh; ++nlv;
            if (ww == 1 && hh == 1) break;
            ww = (ww + 1) >> 1; hh = (hh + 1) >> 1;
        }
        int o = 0;
        for (int lv = 0; lv < nlv; ++lv) { off[lv] = o; o += dw[lv] * dh[lv]; }
        off[nlv] = o;
        value.assign(o, 0);
        vmin.assign(o, 0);
        known.assign(o, 0);
        // level 0 = leaves; each parent = min over its (up to) 2x2 children
        for (int k = 0; k < w * h; ++k) value[k] = leaves[k];
        for (int lv = 1; lv < nlv; ++lv) {
            int pw = dw[lv - 1], phh = dh[lv - 1];
            for (int j = 0; j < dh[lv]; ++j)
                for (int i = 0; i < dw[lv]; ++i) {
                    int64_t m = INT64_MAX;
                    for (int dj = 0; dj < 2; ++dj)
                        for (int di = 0; di < 2; ++di) {
                            int ci = 2 * i + di, cj = 2 * j + dj;
                            if (ci < pw && cj < phh) {
                                int64_t v = value[off[lv - 1] + cj * pw + ci];
                                if (v < m) m = v;
                            }
                        }
                    value[off[lv] + j * dw[lv] + i] = m;
                }
        }
    }

    bool encode(BitCounter& bw, int i, int j, int64_t thr) {
        int path[32];
        int n = 0;
        int ii = i, jj = j;
        for (int lv = 0; lv < nlv; ++lv) {
            path[n++] = off[lv] + jj * dw[lv] + ii;
            ii >>= 1; jj >>= 1;
        }
        int64_t low = 0;
        for (int k = n - 1; k >= 0; --k) {
            int node = path[k];
            if (vmin[node] < low) vmin[node] = low;
            while (!known[node] && vmin[node] < thr) {
                if (vmin[node] < value[node]) { bw.put(0); ++vmin[node]; }
                else { bw.put(1); known[node] = 1; }
            }
            low = vmin[node];
            if (low >= thr) return false;
        }
        return true;
    }
};

// B.10.6 number-of-coding-passes codeword (mirror of _put_npasses)
void put_npasses(BitCounter& bw, int n) {
    if (n == 1) bw.put(0);
    else if (n == 2) { bw.put(1); bw.put(0); }
    else if (n <= 5) { bw.put_bits(3, 2); bw.put_bits(n - 3, 2); }
    else if (n <= 36) { bw.put_bits(3, 2); bw.put_bits(3, 2);
                        bw.put_bits(n - 6, 5); }
    else { bw.put_bits(3, 2); bw.put_bits(3, 2); bw.put_bits(31, 5);
           bw.put_bits(n - 37, 7); }
}

int bitlen64(int64_t v) {
    int n = 0;
    while (v >> n) ++n;
    return n;
}

}  // namespace

// Header size in bytes of ONE single-layer packet covering nb bands, each
// a pw[b] x ph[b] code-block grid in raster order (arrays concatenated
// band-major):
//   npn[k]    passes included for block k (pick+1), 0 = not included
//   zbp[k]    zero-bitplane tag-tree leaf (band numbps - block numbps;
//             0 for null blocks, exactly as the Python assembler builds it)
//   seglen[k] body bytes of the included prefix (ignored when npn==0)
// Returns >= 1 (an all-excluded packet is the 1-byte empty packet), or
// < 0 on error.  Total packet size = return value + sum(seglen[npn>0]).
extern "C" int64_t j2k_pkt1_hdr_size(int nb, const int32_t* pw,
                                     const int32_t* ph, const int32_t* npn,
                                     const int64_t* zbp,
                                     const int64_t* seglen) {
    if (nb <= 0 || nb > 4) return -1;
    int boff[5];
    boff[0] = 0;
    for (int b = 0; b < nb; ++b) {
        if (pw[b] < 0 || ph[b] < 0 || pw[b] > (1 << 20) || ph[b] > (1 << 20))
            return -1;
        boff[b + 1] = boff[b] + pw[b] * ph[b];
    }
    bool any_new = false;
    for (int k = 0; k < boff[nb]; ++k)
        if (npn[k] > 0) { any_new = true; break; }
    BitCounter bw;
    if (!any_new) {
        bw.put(0);
        return bw.flush();
    }
    bw.put(1);
    std::vector<int64_t> first;
    TagTree itree, ztree;
    for (int b = 0; b < nb; ++b) {
        int w = pw[b], h = ph[b];
        if (w == 0 || h == 0) continue;
        const int32_t* bn = npn + boff[b];
        const int64_t* bz = zbp + boff[b];
        const int64_t* bs = seglen + boff[b];
        first.assign((size_t)w * h, 1);  // single layer: L=1 means "never"
        for (int k = 0; k < w * h; ++k)
            if (bn[k] > 0) first[k] = 0;
        itree.init(w, h, first.data());
        ztree.init(w, h, bz);
        for (int cj = 0; cj < h; ++cj)
            for (int ci = 0; ci < w; ++ci) {
                int k = cj * w + ci;
                bool newb = bn[k] > 0;
                bool inc = itree.encode(bw, ci, cj, 1);
                if (inc != newb) return -2;  // parity violation
                if (!newb) continue;
                int64_t zb = 1;
                while (!ztree.encode(bw, ci, cj, zb)) ++zb;
                put_npasses(bw, bn[k]);
                int lblock = 3;  // fresh per block in a single-layer stream
                int nfloor = bitlen64(bn[k]) - 1;
                int need = bitlen64(bs[k]) - nfloor - lblock;
                if (need < 0) need = 0;
                for (int t = 0; t < need; ++t) bw.put(1);
                bw.put(0);
                lblock += need;
                bw.put_bits(bs[k], lblock + nfloor);
            }
    }
    return bw.flush();
}
