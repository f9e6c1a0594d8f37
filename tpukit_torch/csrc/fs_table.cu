// CCSDS-121 split-sample cost table, hand-written for Hopper (sm_90a).
//
// Replaces tpukit/codecs/ccsds121.py::_fs_table_pallas (the Pallas kernel
// of the CCSDS-121 encoder model). For a row-major (nb, J) int32 table of
// mapped residuals, 1 <= J <= 64, it writes the (nb, 14) int32 table
//
//     out[b, k] = sum_j (coded[b, j] >> k),    k = 0 .. KMAX = 13,
//
// which is exactly what _fs_table_jnp computes. The inputs are non-negative
// and >> is an arithmetic shift on int32, as in JAX.
//
// What bounds it: device memory. Per block of J = 8 samples the kernel reads
// 32 B and writes 56 B, and does 14 shift-adds per sample, far below the
// card's integer rate. So the design moves each byte once: one thread owns
// one block row, reads it with 16-byte loads when the rows are 16-byte
// aligned, and keeps the 14 sums in registers; the thread block stages its
// rows of the table in shared memory so that its stores to device memory
// are contiguous. The TPU kernel's transposed (J, lanes) layout served VMEM
// tiling and is not carried over. Fusing analyze()'s other per-block terms
// (split_len, the argmin interval, the second-extension length, allzero)
// into this pass would keep the table out of device memory altogether.
//
// Plain C interface, loaded with ctypes by tpukit_torch/kernels/build.py.
// The launch goes on the caller's stream; nothing is synchronised and
// nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 14;          // KMAX + 1 split options
constexpr int kThreads = 256;   // block rows per thread block

__device__ __forceinline__ void accumulate(int32_t (&acc)[kK], int32_t v) {
#pragma unroll
  for (int k = 0; k < kK; ++k) acc[k] += v >> k;
}

__global__ void __launch_bounds__(kThreads)
fs_table_kernel(const int32_t* __restrict__ coded, int32_t* __restrict__ out,
                long long nb, int J, int vec16) {
  __shared__ int32_t rows[kThreads * kK];
  const long long b0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long b = b0 + threadIdx.x;

  int32_t acc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) acc[k] = 0;
  if (b < nb) {
    const int32_t* row = coded + b * J;
    if (vec16) {
      const int4* row4 = reinterpret_cast<const int4*>(row);
      for (int q = 0; q < J / 4; ++q) {
        const int4 v = __ldg(row4 + q);
        accumulate(acc, v.x);
        accumulate(acc, v.y);
        accumulate(acc, v.z);
        accumulate(acc, v.w);
      }
    } else {
      for (int j = 0; j < J; ++j) accumulate(acc, __ldg(row + j));
    }
  }

#pragma unroll
  for (int k = 0; k < kK; ++k) rows[threadIdx.x * kK + k] = acc[k];
  __syncthreads();

  // this thread block's rows of `out` are one contiguous run of n ints
  const long long left = nb - b0;
  const int n = static_cast<int>((left < kThreads ? left : kThreads) * kK);
  int32_t* dst = out + b0 * kK;
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = rows[i];
}

}  // namespace

extern "C" {

// Launches the table for `nb` block rows of width J on `stream` of CUDA
// device `device`. Returns cudaGetLastError() after the launch: 0 when the
// launch was accepted.
int tpk_fs_table(const void* coded, void* out, long long nb, int J,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb <= 0) return 0;
  const int vec16 =
      (J % 4 == 0) && ((reinterpret_cast<uintptr_t>(coded) & 15u) == 0);
  const long long blocks = (nb + kThreads - 1) / kThreads;
  fs_table_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coded), static_cast<int32_t*>(out), nb, J,
      vec16);
  return static_cast<int>(cudaGetLastError());
}

const char* tpk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
