// CCSDS-121 split-sample cost table, hand-written for Hopper (sm_90a).
//
// Replaces tpukit/codecs/ccsds121.py::_fs_table_pallas (the Pallas kernel
// of the CCSDS-121 encoder model). For a row-major (nb, J) int32 table of
// mapped residuals, 1 <= J <= 64, it writes the (nb, 14) int32 table
//
//     out[b, k] = sum_j (coded[b, j] >> k),    k = 0 .. KMAX = 13,
//
// which is exactly what _fs_table_jnp computes (mod 2^32 where the int32
// sum wraps). The inputs are non-negative.
//
// What bounds it: device memory, once the instructions are cut. Summing
// 14 shifted copies of every sample costs 28 integer operations a sample,
// as much time on the card's integer units as the bytes take. So the sum
// is taken from bit-plane counts instead: with c_t the number of samples
// of the row whose bit t is set, out[b, k] = sum_t c_t 2^(t-k) over t >= k.
// Each thread keeps its row's counts c_t as bit-sliced counters: plane i
// holds bit i of every c_t (bit t of plane i is bit i of c_t), fed by a
// Harley-Seal tree of carry-save adders (two 3-input logic operations
// compress three words into two), about 3 operations a sample. Then
// out[b, k] = sum_i (plane_i >> k) << i, over the bit_length(J) planes.
// kernels/fs_table.py::fs_table_planes is the same arithmetic in torch.
//
// Loads and stores are coalesced: a block of 128 threads owns 128 rows,
// which are one contiguous run of 128 * J ints in and 128 * 14 ints out.
// The block reads its run with 16-byte loads into shared memory (rows
// padded to an odd stride, so that thread t reading row t hits no bank
// twice), and stages its 14-int rows there to write its output run with
// 16-byte stores. The TPU kernel's transposed (J, lanes) layout served
// VMEM tiling and is not carried over.
//
// Plain C interface, loaded with ctypes by tpukit_torch/kernels/build.py.
// The launch goes on the caller's stream; nothing is synchronised and
// nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 14;          // KMAX + 1 split options
constexpr int kRowsPerBlock = 128;
constexpr int kMaxJ = 64;

// carry-save adder: a + b + c == 2 * hi + lo, bit by bit
__device__ __forceinline__ void csa(uint32_t& hi, uint32_t& lo, uint32_t a,
                                   uint32_t b, uint32_t c) {
  lo = a ^ b ^ c;
  hi = (a & b) | (a & c) | (b & c);
}

// adds x (weight 2^first) into the planes first .. kNP-1
template <int kNP>
__device__ __forceinline__ void ripple(uint32_t (&p)[7], uint32_t x,
                                       int first) {
#pragma unroll
  for (int i = 0; i < kNP; ++i) {
    if (i < first) continue;
    const uint32_t carry = p[i] & x;
    p[i] ^= x;
    x = carry;
  }
}

// kNP = bit_length(J) planes hold any count 0 .. J
template <int kNP>
__global__ void __launch_bounds__(kRowsPerBlock)
fs_table_kernel(const int32_t* __restrict__ coded, int32_t* __restrict__ out,
                long long nb, int J, int vec16) {
  extern __shared__ uint32_t sh[];
  const int stride = J | 1;                       // odd: no bank conflicts
  uint32_t* rows = sh;                            // kRowsPerBlock x stride
  uint32_t* res = sh + kRowsPerBlock * stride;    // kRowsPerBlock x kK
  const long long b0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const int nrows = static_cast<int>(
      nb - b0 < kRowsPerBlock ? nb - b0 : kRowsPerBlock);
  const int n = nrows * J;
  const int32_t* src = coded + b0 * J;

  if (vec16) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (int q = threadIdx.x; q < n / 4; q += kRowsPerBlock) {
      const int4 v = __ldg(src4 + q);
      const int f = 4 * q;
      int r = f / J, c = f - r * J;               // J % 4 == 0: one row
      rows[r * stride + c] = v.x;
      rows[r * stride + c + 1] = v.y;
      rows[r * stride + c + 2] = v.z;
      rows[r * stride + c + 3] = v.w;
    }
  } else {
    for (int f = threadIdx.x; f < n; f += kRowsPerBlock) {
      const int r = f / J;
      rows[r * stride + f - r * J] = __ldg(src + f);
    }
  }
  __syncthreads();

  if (threadIdx.x < nrows) {
    const uint32_t* row = rows + threadIdx.x * stride;
    uint32_t p[7] = {0, 0, 0, 0, 0, 0, 0};        // planes of weight 2^i
    int j = 0;
    // Harley-Seal: eight samples fold into ones, twos, fours and a carry
    // of weight 8 that ripples into the planes above
    for (; j + 8 <= J; j += 8) {
      uint32_t twos_a, twos_b, fours_a, fours_b, eights;
      csa(twos_a, p[0], p[0], row[j], row[j + 1]);
      csa(twos_b, p[0], p[0], row[j + 2], row[j + 3]);
      csa(fours_a, p[1], p[1], twos_a, twos_b);
      csa(twos_a, p[0], p[0], row[j + 4], row[j + 5]);
      csa(twos_b, p[0], p[0], row[j + 6], row[j + 7]);
      csa(fours_b, p[1], p[1], twos_a, twos_b);
      csa(eights, p[2], p[2], fours_a, fours_b);
      ripple<kNP>(p, eights, 3);
    }
    for (; j < J; ++j) ripple<kNP>(p, row[j], 0);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      uint32_t s = 0;
#pragma unroll
      for (int i = 0; i < kNP; ++i) s += (p[i] >> k) << i;
      res[threadIdx.x * kK + k] = s;
    }
  }
  __syncthreads();

  // this block's rows of `out` are one contiguous run of nrows * kK ints,
  // 16-byte aligned (kRowsPerBlock * kK * 4 is a multiple of 16)
  int32_t* dst = out + b0 * kK;
  const int m = nrows * kK;
  int4* dst4 = reinterpret_cast<int4*>(dst);
  for (int q = threadIdx.x; q < m / 4; q += kRowsPerBlock)
    dst4[q] = make_int4(res[4 * q], res[4 * q + 1], res[4 * q + 2],
                        res[4 * q + 3]);
  for (int f = (m / 4) * 4 + threadIdx.x; f < m; f += kRowsPerBlock)
    dst[f] = res[f];
}

template <int kNP>
cudaError_t launch(const int32_t* coded, int32_t* out, long long nb, int J,
                   int vec16, cudaStream_t stream) {
  const long long blocks = (nb + kRowsPerBlock - 1) / kRowsPerBlock;
  const int smem =
      static_cast<int>(sizeof(uint32_t)) * kRowsPerBlock * ((J | 1) + kK);
  fs_table_kernel<kNP><<<static_cast<unsigned>(blocks), kRowsPerBlock, smem,
                         stream>>>(coded, out, nb, J, vec16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the table for `nb` block rows of width J (1 .. 64) on `stream`
// of CUDA device `device`; `out` 16-byte aligned. Returns
// cudaGetLastError() after the launch: 0 when the launch was accepted.
int tpk_fs_table(const void* coded, void* out, long long nb, int J,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (J < 1 || J > kMaxJ || (reinterpret_cast<uintptr_t>(out) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb <= 0) return 0;
  const int vec16 =
      (J % 4 == 0) && ((reinterpret_cast<uintptr_t>(coded) & 15u) == 0);
  const auto* in = static_cast<const int32_t*>(coded);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  int np = 0;
  while ((1 << np) <= J) ++np;                    // bit_length(J)
  switch (np) {
    case 1: err = launch<1>(in, o, nb, J, vec16, s); break;
    case 2: err = launch<2>(in, o, nb, J, vec16, s); break;
    case 3: err = launch<3>(in, o, nb, J, vec16, s); break;
    case 4: err = launch<4>(in, o, nb, J, vec16, s); break;
    case 5: err = launch<5>(in, o, nb, J, vec16, s); break;
    case 6: err = launch<6>(in, o, nb, J, vec16, s); break;
    default: err = launch<7>(in, o, nb, J, vec16, s); break;
  }
  return static_cast<int>(err);
}

const char* tpk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
