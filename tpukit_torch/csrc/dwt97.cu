// The multilevel forward CDF 9/7 DWT, hand-written for Hopper (sm_90a).
//
// Replaces tpukit/kernels/dwt_pallas.py::_level97 (the Pallas kernels
// _hkernel and _vkernel, driven by dwt2_pallas). The schedule, which level
// reads which buffer and how many launches a transform takes, is made in
// Python (tpukit_torch/kernels/dwt97.py::plan); this file has two kernels:
//
//   tile: one level of a (B, h, w) float32 window, rows and columns fused.
//         A block of 128 threads fills a tile of 56 x 64 samples plus a
//         halo of 4 on every side (64 x 72) into shared memory with
//         cp.async. Two threads per row lift its two halves along the row,
//         halo rows included, streaming the four steps through registers;
//         then two threads per inner column lift it down the column the
//         same way and store their quarter-tile columns straight to their
//         packed places: each warp stores runs of 32 floats. HL, LH and HH
//         go into the output; LL goes into a small buffer the next level
//         reads (or into the output at the last level), so no level reads
//         what another block writes, the input stays untouched and nothing
//         is cloned.
//   tail: the last levels of a window small enough for shared memory
//         (h * w <= 16384 samples), one block per plane: every level in
//         shared memory, LL kept there from one level to the next, each
//         line cut into segments of at least 8 pairs, a thread each.
//
// At 1024 x 1024 with 5 levels that is 4 launches: 3 tile levels and one
// tail for the 128 x 128 and 64 x 64 windows.
//
// Halo. A lifting output at pair i needs the input pairs i-2 .. i+2 (four
// steps, each one pair to one side), so 4 samples each side suffice. The
// halo is filled by whole-point symmetric reflection of the window
// (x[-k] = x[k], x[n-1+k] = x[n-1-k], folded again for windows shorter
// than the halo). Lifting keeps that symmetry, and every value computed in
// the reflected halo is bit-equal to the split-domain edge rule of the
// plain version (s[n] := s[n-1], d[-1] := d[0]): each step's sum x + y is
// computed on the same two values in the other order, and IEEE addition
// is commutative. So interior and edge tiles run the same code.
//
// Rounding contract: each lifting step is t = x + y, t = c * t, a = a + t,
// three separately rounded IEEE float32 operations (__fadd_rn/__fmul_rn,
// which nvcc never contracts into an FMA; the library is also built with
// --fmad=false), and the scaling multiplies by K and by IK = float32(1/K).
// That is exactly what the plain torch version (tpukit_torch/kernels/dwt.py)
// computes, so the two are bit-equal on the card.
//
// What bounds it: device memory. The bound reads each sample once and
// writes it once; a transform here moves about 4/3 of that (each level's
// LL window is read again by the next level) plus the halo, which the
// neighbouring blocks find in L2. 14 rounded float32 operations a sample
// and level stay far below the card's float32 rate; what costs is latency.
// Hence: each thread streams a line through registers (one barrier
// between the row and the column pass, not one per lifting step), the
// lines are halved so a block's serial chain is short, and the fill is
// asynchronous so a block has its whole tile in flight. 19 KB of shared
// memory a block lets eleven blocks share an SM. The levels whose grids are a wave or less (level 3
// at 1024², the tail) remain latency bound.
//
// Plain C interface, loaded with ctypes by tpukit_torch/kernels/build.py.
// Launches go on the caller's stream; nothing is synchronised and nothing
// is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32 lifting constants, bit-equal to tpukit_torch/kernels/dwt.py
constexpr float kA = -0x1.960ce6p+0f;   // -1.586134342059924
constexpr float kB = -0x1.b2035cp-5f;   // -0.052980118572961
constexpr float kG = 0x1.c40cecp-1f;    //  0.882911075530934
constexpr float kD = 0x1.c626aap-2f;    //  0.443506852043971
constexpr float kK = 0x1.3aecb0p+0f;    //  1.230174104914001
constexpr float kIK = 0x1.a03386p-1f;   //  float32(1 / K)

// tile kernel: kTH x kTW samples of a level, kHalo samples of halo a side;
// two threads per row of the tile, then two per column, each lifting half
// of the line's outputs
constexpr int kTH = 56;
constexpr int kTW = 64;
constexpr int kHalo = 4;
constexpr int kRows = kTH + 2 * kHalo;      // 64 rows in shared memory
constexpr int kCols = kTW + 2 * kHalo;      // 72 columns
constexpr int kStride = kCols + 4;          // 76: rows 16-byte aligned
constexpr int kQ = kTW / 2;                 // 32 output columns a half
constexpr int kRowOut = kTW / 4;            // 16 pairs a row half lifts
constexpr int kColOut = kTH / 4;            // 14 pairs a column half lifts
constexpr int kTileThreads = 2 * kRows;
static_assert(kTW == kRows, "a thread pair per row, then per column");

// tail kernel: the window and its LL in shared memory
constexpr int kTailMax = 128 * 128;         // samples of the largest window
constexpr int kTailThreads = 512;

// a + c * (x + y), three rounded float32 operations
__device__ __forceinline__ float lift(float a, float x, float y, float c) {
  return __fadd_rn(a, __fmul_rn(c, __fadd_rn(x, y)));
}

// index i of a whole-point symmetric extension of n >= 2 samples
__device__ __forceinline__ int reflect(int i, int n) {
  if (i >= 0 && i < n) return i;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - i;
}

// Asynchronous copies from device to shared memory (cp.async): a thread
// issues all its copies of a fill back to back and waits once, so a block
// keeps its whole tile in flight instead of one load per thread.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void copy8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The four lifting steps streamed along a line of n >= 5 (s, d) pairs held
// in registers a few at a time: pair(j) gives (s0[j], d0[j]) and is called
// for j = 0, 1, .. n-1 in order; emit(s, d) then receives the lifted,
// unscaled pairs 2, 3, .. n-3 in order, the pairs whose inputs j-2 .. j+2
// all lie on the line. With kN > 0 the line has kN pairs and the loop is
// unrolled (the emits of a thread can then go to registers); with kN = 0
// it has n and the loop stays a loop.
template <int kN, class Pair, class Emit>
__device__ __forceinline__ void lift_line(int n, Pair pair, Emit emit) {
  const float2 p0 = pair(0), p1 = pair(1), p2 = pair(2), p3 = pair(3);
  const float d10 = lift(p0.y, p0.x, p1.x, kA);
  const float d11 = lift(p1.y, p1.x, p2.x, kA);
  const float s11 = lift(p1.x, d10, d11, kB);
  float d1m = lift(p2.y, p2.x, p3.x, kA);     // d1[j-1]
  float s1m = lift(p2.x, d11, d1m, kB);       // s1[j-1]
  float d2mm = lift(d11, s11, s1m, kG);       // d2[j-2]
  float s0 = p3.x, d0 = p3.y;                 // s0[j], d0[j]
  auto step = [&](int j) {
    const float2 nx = pair(j + 1);
    const float d1 = lift(d0, s0, nx.x, kA);
    const float s1 = lift(s0, d1m, d1, kB);
    const float d2m = lift(d1m, s1m, s1, kG);        // d2[j-1]
    emit(lift(s1m, d2mm, d2m, kD), d2m);             // pair j-1
    d2mm = d2m;
    d1m = d1;
    s1m = s1;
    s0 = nx.x;
    d0 = nx.y;
  };
  if (kN > 0) {
#pragma unroll
    for (int j = 3; j <= kN - 2; ++j) step(j);
  } else {
#pragma unroll 2
    for (int j = 3; j <= n - 2; ++j) step(j);
  }
}

// One level of an h x w window (h, w even) of band blockIdx.z: the tile at
// rows blockIdx.y * kTH, columns blockIdx.x * kTW.
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const float* __restrict__ src, long long src_band,
            long long src_row, int h, int w, float* __restrict__ out,
            long long out_band, long long out_row, float* __restrict__ ll,
            long long ll_band, long long ll_row) {
  __shared__ __align__(16) float t[kRows * kStride];
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
  const float* in = src + blockIdx.z * src_band;
  const int tid = threadIdx.x;

  // fill: sample (r0 - 4 + r, c0 - 4 + c) at t[r * kStride + c], reflected
  // into the window at its edges; inside it, 16-byte copies (8-byte ones
  // where the window's rows are not 16-byte aligned)
  if (r0 >= kHalo && r0 + kTH + kHalo <= h && c0 >= kHalo &&
      c0 + kTW + kHalo <= w) {
    const float* base = in + (r0 - kHalo) * src_row + (c0 - kHalo);
    if (((reinterpret_cast<uintptr_t>(base) | (src_row * 4)) & 15) == 0) {
      for (int k = tid; k < kRows * (kCols / 4); k += kTileThreads) {
        const int r = k / (kCols / 4);
        const int j = k - r * (kCols / 4);
        copy16(t + r * kStride + 4 * j, base + r * src_row + 4 * j);
      }
    } else {
      for (int k = tid; k < kRows * (kCols / 2); k += kTileThreads) {
        const int r = k / (kCols / 2);
        const int j = k - r * (kCols / 2);
        copy8(t + r * kStride + 2 * j, base + r * src_row + 2 * j);
      }
    }
  } else {
    for (int k = tid; k < kRows * kCols; k += kTileThreads) {
      const int r = k / kCols;
      const int c = k - r * kCols;
      copy4(t + r * kStride + c, in + reflect(r0 - kHalo + r, h) * src_row +
                                     reflect(c0 - kHalo + c, w));
    }
  }
  copies_done();

  // rows: threads tid and tid + kRows lift the first and the second half of
  // row tid's inner pairs (2 .. kRowOut+1, then kRowOut+2 .. 2kRowOut+1);
  // the halves overlap in what they read, so the results wait in
  // registers until both have read
  {
    const int half = tid / kRows;
    float2* row = reinterpret_cast<float2*>(t + (tid % kRows) * kStride) +
                  half * kRowOut;
    float2 res[kRowOut];
    int k = 0;
    lift_line<kRowOut + 4>(
        0, [&](int j) { return row[j]; },
        [&](float s, float d) {
          res[k++] = make_float2(__fmul_rn(s, kK), __fmul_rn(d, kIK));
        });
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowOut; ++i) row[2 + i] = res[i];
  }
  __syncthreads();

  // columns: threads tid and tid + kRows lift the first and the second half
  // of inner column q of the L half (tid % kRows < kQ) or of the H half,
  // down the rows, and store their quarter-tile columns: s rows to LL (or
  // HL), d rows to LH (or HH)
  const int half = tid / kRows;
  const int cc = tid % kRows;
  const bool high_col = cc >= kQ;
  const int q = high_col ? cc - kQ : cc;
  const int h2 = h >> 1, w2 = w >> 1;
  const int gq = (c0 >> 1) + q;
  if (gq >= w2) return;
  const int gi = (r0 >> 1) + half * kColOut;  // global row of the first pair
  const int rows = min(kColOut, h2 - gi);     // pairs of this half inside
  float* o = out + blockIdx.z * out_band + gq + (high_col ? w2 : 0);
  float* lo = high_col ? o + gi * out_row
                       : ll + blockIdx.z * ll_band + gi * ll_row + gq;
  const long long lo_row = high_col ? out_row : ll_row;
  float* hi = o + (h2 + gi) * out_row;
  const float* col = t + 2 * half * kColOut * kStride + kHalo + 2 * q +
                     high_col;
  int i = 0;
  lift_line<kColOut + 4>(
      0,
      [&](int j) {
        return make_float2(col[2 * j * kStride], col[(2 * j + 1) * kStride]);
      },
      [&](float s, float d) {
        if (i++ < rows) {
          *lo = __fmul_rn(s, kK);
          *hi = __fmul_rn(d, kIK);
        }
        lo += lo_row;
        hi += out_row;
      });
}

// The last `levels` levels of an h x w window (h * w <= kTailMax) of band
// blockIdx.x, in shared memory. Per level: the window a (rows of ww + 2
// floats, padded so that float2 reads of 16 rows hit 32 distinct banks),
// its row-lifted copy r (same layout) and the next level's window b. Each
// line is cut into segments of at least 8 pairs, as many as the block's
// threads allow, and a thread lifts a segment: rows from a into r, then
// columns from r, writing HL, LH and HH to `out` and LL to b (to `out` at
// the last level). Pairs beyond the window's edges come from whole-point
// symmetric reflection, which equals the plain edge rule bit for bit (see
// the top).
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(const float* __restrict__ src, long long src_band,
            long long src_row, int h, int w, int levels,
            float* __restrict__ out, long long out_band, long long out_row) {
  extern __shared__ __align__(16) float sh[];
  float* a = sh;
  float* r = a + h * (w + 2);
  float* b = r + h * (w + 2);
  const float* in = src + blockIdx.x * src_band;
  float* o = out + blockIdx.x * out_band;
  const int tid = threadIdx.x;
  for (int k = tid; k < h * (w >> 1); k += kTailThreads) {
    const int y = k / (w >> 1);
    const int x = 2 * (k - y * (w >> 1));
    copy8(a + y * (w + 2) + x, in + y * src_row + x);
  }
  copies_done();

  for (int lv = 0; lv < levels; ++lv) {
    const int hh = h >> lv, ww = w >> lv;
    const int st = ww + 2;
    const int n = ww >> 1, m = hh >> 1;       // pairs a row, a column
    const bool last = lv == levels - 1;
    // rows: each line is cut into S segments of `seg` pairs, one thread
    // each; a segment's extended line holds its pairs and two more a side
    int S = max(1, min(kTailThreads / hh, n / 8));
    int seg = (n + S - 1) / S;
    for (int task = tid; task < hh * S; task += kTailThreads) {
      const int y = task % hh;                // neighbours: other rows
      const int p0 = (task / hh) * seg;
      const float* line = a + y * st;
      float2* dst = reinterpret_cast<float2*>(r + y * st) + p0;
      lift_line<0>(min(seg, n - p0) + 4,
                   [&](int j) {
                     const int p = p0 + j - 2;
                     if (p >= 0 && p < n)
                       return reinterpret_cast<const float2*>(line)[p];
                     return make_float2(line[reflect(2 * p, ww)],
                                        line[reflect(2 * p + 1, ww)]);
                   },
                   [&](float s, float d) {
                     *dst++ = make_float2(__fmul_rn(s, kK), __fmul_rn(d, kIK));
                   });
    }
    __syncthreads();
    // columns: column x of r is L column x / 2 (x even) or H column x / 2
    const int n2 = n + 2;                     // stride of b
    S = max(1, min(kTailThreads / ww, m / 8));
    seg = (m + S - 1) / S;
    for (int task = tid; task < ww * S; task += kTailThreads) {
      const int x = task % ww;
      const int p0 = (task / ww) * seg;
      const float* line = r + x;
      const bool high_col = x & 1;
      const int q = x >> 1;
      const int lo_row = high_col || last ? static_cast<int>(out_row) : n2;
      float* lo = (high_col ? o + n + q : (last ? o + q : b + q)) +
                  p0 * lo_row;
      float* hi = o + (m + p0) * out_row + q + (high_col ? n : 0);
      lift_line<0>(min(seg, m - p0) + 4,
                   [&](int j) {
                     const int p = p0 + j - 2;
                     if (p >= 0 && p < m)
                       return make_float2(line[2 * p * st],
                                          line[(2 * p + 1) * st]);
                     return make_float2(line[reflect(2 * p, hh) * st],
                                        line[reflect(2 * p + 1, hh) * st]);
                   },
                   [&](float s, float d) {
                     *lo = __fmul_rn(s, kK);
                     *hi = __fmul_rn(d, kIK);
                     lo += lo_row;
                     hi += out_row;
                   });
    }
    __syncthreads();
    float* tmp = a;
    a = b;
    b = tmp;
  }
}

}  // namespace

extern "C" {

// One level of an h x w window (h, w even, >= 2) of B bands: reads `src`
// (band and row strides in floats), writes HL, LH and HH into the level's
// window of `out` and LL into `ll` (their own strides). Returns
// cudaGetLastError() after the launch.
int tpk_dwt97_tile(const void* src, long long src_band, long long src_row,
                   int B, int h, int w, void* out, long long out_band,
                   long long out_row, void* ll, long long ll_band,
                   long long ll_row, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || B > 65535 || h < 2 || w < 2 || (h | w) & 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, B);
  tile_kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), src_band, src_row, h, w,
      static_cast<float*>(out), out_band, out_row, static_cast<float*>(ll),
      ll_band, ll_row);
  return static_cast<int>(cudaGetLastError());
}

// The last `levels` levels of an h x w window of B bands, h * w <= 16384
// and h, w divisible by 2^levels: reads `src`, writes every level's HL, LH
// and HH and the last LL into `out`. Returns cudaGetLastError().
int tpk_dwt97_tail(const void* src, long long src_band, long long src_row,
                   int B, int h, int w, int levels, void* out,
                   long long out_band, long long out_row, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || B > 65535 || levels < 1 || h * w > kTailMax ||
      h % (2 << (levels - 1)) || w % (2 << (levels - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) *
                   (2 * h * (w + 2) + (h / 2) * (w / 2 + 2));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(tail_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tail_kernel<<<B, kTailThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), src_band, src_row, h, w, levels,
      static_cast<float*>(out), out_band, out_row);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
