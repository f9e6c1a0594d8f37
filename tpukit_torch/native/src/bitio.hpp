// Bit-level writer/reader (MSB-first within bytes), shared by the entropy
// coders. tpukit native runtime.
#pragma once
#include <cstdint>
#include <cstring>

namespace tpukit {

struct BitWriter {
    uint8_t* buf;
    int64_t cap;          // bytes
    uint64_t acc = 0;     // bit accumulator (MSB-first semantics)
    int nacc = 0;         // bits held in acc
    int64_t bytepos = 0;  // bytes already flushed
    bool overflow = false;

    BitWriter(uint8_t* b, int64_t c) : buf(b), cap(c) {}

    inline void raw(uint32_t value, int nbits) {  // nbits <= 32
        acc = (acc << nbits) | (value & (nbits == 32 ? 0xFFFFFFFFu
                                                     : ((1u << nbits) - 1u)));
        nacc += nbits;
        if (nacc >= 32) {
            nacc -= 32;
            uint32_t out32 = (uint32_t)(acc >> nacc);
            if (bytepos + 4 <= cap) {
                uint32_t be = __builtin_bswap32(out32);
                std::memcpy(buf + bytepos, &be, 4);
                bytepos += 4;
            } else {
                for (int s = 24; s >= 0; s -= 8) {
                    if (bytepos < cap) buf[bytepos++] = (uint8_t)(out32 >> s);
                    else overflow = true;
                }
            }
        }
    }

    inline void put_bits(uint64_t value, int nbits) {
        // MSB-first: value's nbits LSBs are written most-significant first.
        while (nbits > 32) {
            raw((uint32_t)(value >> (nbits - 32)), 32);
            nbits -= 32;
        }
        if (nbits > 0) raw((uint32_t)value, nbits);
    }

    inline void put_fs(uint32_t value) {
        // fundamental sequence: `value` zeros then a one
        while (value >= 32) { raw(0, 32); value -= 32; }
        raw(1, (int)value + 1);
    }

    inline void put_zeros(int64_t n) {
        // bulk zero emission: whole zero bytes are memset in one shot
        // instead of being shifted through the accumulator (no pre-zeroed
        // buffer required).
        int k = (8 - (nacc & 7)) & 7;          // align acc to a byte edge
        if (k && n >= k) { raw(0, k); n -= k; }
        if ((nacc & 7) == 0 && n >= 64) {
            while (nacc > 0) {                 // drain acc whole bytes
                nacc -= 8;
                if (bytepos < cap) buf[bytepos++] = (uint8_t)(acc >> nacc);
                else { overflow = true; nacc = 0; }
            }
            acc = 0;
            int64_t nb = n >> 3;
            if (bytepos + nb <= cap) {
                std::memset(buf + bytepos, 0, (size_t)nb);
                bytepos += nb;
            } else {
                if (bytepos < cap)
                    std::memset(buf + bytepos, 0, (size_t)(cap - bytepos));
                bytepos = cap;
                overflow = true;
            }
            n &= 7;
        }
        while (n > 0) { int t = n < 32 ? (int)n : 32; raw(0, t); n -= t; }
    }

    inline int64_t bitpos_now() const { return bytepos * 8 + nacc; }

    inline int64_t bytes() {
        // flush: pad the last partial byte with zeros, then drain
        if (nacc % 8) raw(0, 8 - (nacc % 8));
        while (nacc > 0) {
            nacc -= 8;
            if (bytepos < cap) buf[bytepos++] = (uint8_t)(acc >> nacc);
            else overflow = true;
        }
        return bytepos;
    }
};

struct BitReader {
    // 64-bit left-aligned window; MSB-first consumption. FS decode uses CLZ.
    const uint8_t* buf;
    int64_t nbytes;
    int64_t bytepos = 0;     // next byte to pull into the window
    uint64_t window = 0;     // upcoming bits, MSB-aligned
    int avail = 0;           // valid bits in window
    bool error = false;

    BitReader(const uint8_t* b, int64_t n) : buf(b), nbytes(n) {}

    inline void refill() {
        // branchless wide refill: load 8 bytes, OR them below the claimed
        // bits, and claim whole bytes up to avail in [56, 63]. Unclaimed
        // look-ahead bits stay in the window's low part; re-ORing the same
        // bytes on the next refill is idempotent, so consumers may also
        // advance the window manually (window <<= k; avail -= k).
        if (bytepos + 8 <= nbytes) {
            uint64_t chunk;
            std::memcpy(&chunk, buf + bytepos, 8);
            window |= __builtin_bswap64(chunk) >> avail;
            int adv = (63 - avail) >> 3;
            bytepos += adv;
            avail += adv << 3;
        } else {
            // cap at 63 bits: avail must never reach 64, or downstream
            // full-window shifts (w << (z+1) with z+1 == 64) become UB
            while (avail <= 55 && bytepos < nbytes) {
                window |= (uint64_t)buf[bytepos++] << (56 - avail);
                avail += 8;
            }
        }
    }

    inline uint64_t get_bits(int n) {  // n <= 56
        if (n == 0) return 0;
        refill();
        if (avail < n) { error = true; avail = 0; window = 0; return 0; }
        uint64_t v = window >> (64 - n);
        window <<= n;
        avail -= n;
        return v;
    }

    inline uint32_t get_fs() {
        uint32_t zeros = 0;
        for (;;) {
            refill();
            if (avail == 0) { error = true; return zeros; }
            if (window == 0) {           // whole window is zeros
                zeros += avail;
                avail = 0;
                continue;
            }
            int z = __builtin_clzll(window);
            if (z >= avail) { zeros += avail; avail = 0; window = 0; continue; }
            zeros += z;
            window = (z + 1 >= 64) ? 0 : (window << (z + 1));  // z+1==64 is UB
            avail -= z + 1;
            return zeros;
        }
    }

    inline void get_fs_multi(uint32_t* vals, int count) {
        // decode `count` fundamental-sequence codes: as many as fit in the
        // current window per refill (one CLZ each, no per-code refill),
        // falling back to get_fs() for codes that span a window boundary
        // or long zero runs. On error the remaining vals are whatever
        // get_fs() returned (callers check `error`).
        int i = 0;
        while (i < count) {
            refill();
            uint64_t w = window;
            int av = avail;
            while (i < count && w != 0) {
                int z = __builtin_clzll(w);
                if (z + 1 > av) break;   // code spans the refill boundary
                vals[i++] = (uint32_t)z;
                // z+1 <= av <= 63 (refill caps avail at 63), but keep the
                // guard so a future refill change cannot reintroduce the
                // shift-by-64 UB
                w = (z + 1 >= 64) ? 0 : (w << (z + 1));
                av -= z + 1;
            }
            window = w;
            avail = av;
            if (i < count) {
                vals[i++] = get_fs();
                if (error) return;
            }
        }
    }
};

}  // namespace tpukit
