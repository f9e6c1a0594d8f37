// One level of the forward CDF 9/7 DWT, hand-written for Hopper (sm_90a).
//
// Replaces tpukit/kernels/dwt_pallas.py::_level97 (the Pallas kernels
// _hkernel and _vkernel, driven by dwt2_pallas). A level of a (B, h, w)
// float32 window is two launches:
//
//   rows:    each row's even/odd samples s, d are lifted along the row
//            (alpha, beta, gamma, delta, then s*K and d*IK) and written
//            packed as [s | d] into a scratch window;
//   columns: each column of the scratch window is lifted the same way and
//            written packed as [s ; d] back into the level's window.
//
// The result is the packed Mallat layout [LL | HL; LH | HH], so the pack
// costs nothing extra. The window is the top-left h x w corner of a
// (B, H, W) buffer, addressed through the band and row strides: level l+1
// runs in place on level l's LL quadrant with no copy.
//
// Rounding contract: each lifting step is t = x + y, t = c * t, a = a + t,
// three separately rounded IEEE float32 operations (__fadd_rn/__fmul_rn,
// which nvcc never contracts into an FMA; the library is also built with
// --fmad=false), and the scaling multiplies by K and by IK = float32(1/K).
// That is exactly what the plain torch version (tpukit_torch/kernels/dwt.py)
// computes, so the two are bit-equal on the card.
//
// Edges: whole-point symmetric extension, s[n] := s[n-1] and d[-1] := d[0].
//
// What bounds it: device memory. A level reads and writes the window twice
// (8 bytes per sample and pass) for ~12 flops per sample. The TPU kernel
// lifted in the interleaved domain with parity masks because Mosaic cannot
// slice lanes with a stride, and packed with a separate XLA pass; here each
// line is split into s and d while it is loaded into shared memory, the
// four steps run there with a barrier between them, and the stores go
// straight to their packed places. Row loads are float2 and coalesced;
// the column pass stages a strip of C adjacent columns (C a power of two,
// at most 32, as wide as a 128 KiB budget allows for h rows) so that its
// loads and stores are runs of C floats along a row.
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

constexpr int kThreads = 256;
constexpr int kMaxStrip = 32;                   // columns per column block
constexpr int kColBudget = 128 * 1024;          // column strip, bytes
constexpr int kMaxSmem = 227 * 1024;            // Hopper's per-block limit

// a + c * (x + y), three rounded float32 operations
__device__ __forceinline__ float lift(float a, float x, float y, float c) {
  return __fadd_rn(a, __fmul_rn(c, __fadd_rn(x, y)));
}

// The four lifting steps over n (s, d) pairs per lane in shared memory:
// pair i of lane c at s[(i << lane_shift) + c], d[...], lanes < 2^lane_shift
// of them in use. Each step reads one array and writes the other.
__device__ __forceinline__ void lift_line(float* s, float* d, int n,
                                          int lanes, int lane_shift) {
  const int total = n << lane_shift;
  const int last = (n - 1) << lane_shift;
  const int step = 1 << lane_shift;
  for (int k = threadIdx.x; k < total; k += blockDim.x)
    if ((k & (step - 1)) < lanes)
      d[k] = lift(d[k], s[k], s[k < last ? k + step : k], kA);
  __syncthreads();
  for (int k = threadIdx.x; k < total; k += blockDim.x)
    if ((k & (step - 1)) < lanes)
      s[k] = lift(s[k], d[k >= step ? k - step : k], d[k], kB);
  __syncthreads();
  for (int k = threadIdx.x; k < total; k += blockDim.x)
    if ((k & (step - 1)) < lanes)
      d[k] = lift(d[k], s[k], s[k < last ? k + step : k], kG);
  __syncthreads();
  for (int k = threadIdx.x; k < total; k += blockDim.x)
    if ((k & (step - 1)) < lanes)
      s[k] = lift(s[k], d[k >= step ? k - step : k], d[k], kD);
  __syncthreads();
}

// One block per (row, band): the row's w samples, lifted along the row.
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ src, float* __restrict__ dst, int w,
            long long band_stride, long long row_stride) {
  extern __shared__ float sh[];
  const int n = w >> 1;
  float* s = sh;
  float* d = sh + n;
  const long long base = blockIdx.y * band_stride + blockIdx.x * row_stride;
  const float2* in = reinterpret_cast<const float2*>(src + base);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 v = in[i];
    s[i] = v.x;
    d[i] = v.y;
  }
  __syncthreads();
  lift_line(s, d, n, 1, 0);
  float* out = dst + base;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[i] = __fmul_rn(s[i], kK);
    out[n + i] = __fmul_rn(d[i], kIK);
  }
}

// One block per (strip of 2^strip_shift columns, band): the strip's h rows
// in shared memory, lifted down each column.
__global__ void __launch_bounds__(kThreads)
cols_kernel(const float* __restrict__ src, float* __restrict__ dst, int h,
            int w, long long band_stride, long long row_stride,
            int strip_shift) {
  extern __shared__ float sh[];
  const int n = h >> 1;
  const int C = 1 << strip_shift;
  float* s = sh;
  float* d = sh + (n << strip_shift);
  const int c0 = blockIdx.x * C;
  const int lanes = min(C, w - c0);
  const long long base = blockIdx.y * band_stride + c0;
  const float* in = src + base;
  const int total = h << strip_shift;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int r = k >> strip_shift;
    const int c = k & (C - 1);
    if (c < lanes) {
      const float v = in[r * row_stride + c];
      const int at = ((r >> 1) << strip_shift) + c;
      if (r & 1)
        d[at] = v;
      else
        s[at] = v;
    }
  }
  __syncthreads();
  lift_line(s, d, n, lanes, strip_shift);
  float* out = dst + base;
  const int half = n << strip_shift;
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    const int i = k >> strip_shift;
    const int c = k & (C - 1);
    if (c < lanes) {
      out[i * row_stride + c] = __fmul_rn(s[k], kK);
      out[(n + i) * row_stride + c] = __fmul_rn(d[k], kIK);
    }
  }
}

cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Columns per block of the column pass for a window of h rows: the widest
// power of two <= 32 whose strip fits the 128 KiB budget (at least 1).
// Returns -1 when even one column of h rows exceeds a block's shared memory.
int strip_width(int h) {
  const long long col = 4LL * h;
  if (col > kMaxSmem) return -1;
  int c = kMaxStrip;
  while (c > 1 && col * c > kColBudget) c >>= 1;
  return c;
}

}  // namespace

extern "C" {

// Row pass of one level: reads the h x w window of each of B bands of `src`
// and writes the row-lifted, [s | d]-packed window into `dst`, both with
// the given band and row strides (in floats, even) and 8-byte aligned. h, w
// even and >= 2, w <= 58112. Returns cudaGetLastError() after the launch.
int tpk_dwt97_rows(const void* src, void* dst, int B, int h, int w,
                   long long band_stride, long long row_stride, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || B > 65535 || h < 2 || w < 2 || (h | w) & 1 ||
      4LL * w > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * w;
  err = allow_smem(reinterpret_cast<const void*>(rows_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_kernel<<<dim3(h, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), w, band_stride,
      row_stride);
  return static_cast<int>(cudaGetLastError());
}

// Column pass of one level: reads the h x w window of `src`, lifts each
// column, and writes the [s ; d]-packed window into `dst` (same strides).
// Returns cudaGetLastError() after the launch.
int tpk_dwt97_cols(const void* src, void* dst, int B, int h, int w,
                   long long band_stride, long long row_stride, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = strip_width(h);
  if (B <= 0 || B > 65535 || h < 2 || w < 2 || (h | w) & 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int shift = 0;
  while ((1 << shift) < C) ++shift;
  const int smem = 4 * h * C;
  err = allow_smem(reinterpret_cast<const void*>(cols_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = (w + C - 1) / C;
  cols_kernel<<<dim3(strips, B), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), h, w,
      band_stride, row_stride, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
