// coded_matmul: out[n] = (W @ A)[n] @ B, the SPACDC encode fused with all N
// worker products.
//
//   W   (N, J)          coding matrix, float32
//   A   (J, blk, d)     the round's J stacked blocks, float32 or bfloat16
//   B   (d, n_out)      the shared right factor, float32 or bfloat16
//   out (N, blk, n_out) per-worker results, in A's dtype
//
// Replaces the Pallas TPU kernel `coded_matmul_kernel`
// (src/repro/kernels/coded_matmul.py, body `_kernel`).  As there, the coded
// shards (N, blk, d) never reach device memory: each block builds the
// coded stripe it needs in shared memory and multiplies it at once.
//
// Bound on the H100: float32 operations on the CUDA cores.  The worker
// products are 2 * N * blk * d * n_out FLOP (about 2.09 TFLOP at the full
// qwen2-7b FFN width, ~31 ms at the 67 TFLOP/s float32 peak).  Re-building
// the coded stripe for every n_out tile adds J / kBK of that again in FMAs,
// and J / kBK loads of A per product FMA, served from L2.
//
// Design (one thread block per (worker n, row tile of blk, column tile of
// n_out)):
//  * per d-step of kBD columns, the block forms the coded stripe
//    sum_j W[n, j] * A[j, rows, d-step] in shared memory (J FMAs per element,
//    W's row staged in shared memory), loads the (kBD x kBK) tile of B into
//    shared memory, and then every thread adds its kTM x kTN micro-tile of
//    stripe @ tile into float32 registers;
//  * the TPU kernel held an N-wide accumulator (its `(Np, bi, bj)` VMEM
//    scratch) and swept d sequentially.  At N = 30 that does not fit in
//    registers, and independent blocks are what fill 132 SMs, so here each
//    block owns one worker and loops over d itself;
//  * the grid puts the worker index fastest and the row tile slowest, so the
//    blocks resident at one time share one row tile of A (J * kBI * d
//    elements) and a few column tiles of B, which L2 holds;
//  * a thread's rows and columns are strided by 16, so shared-memory reads
//    are conflict-free; the stripe is stored transposed with one word of
//    padding per row, so its stores are conflict-free too;
//  * ordinary IEEE float32 FMAs, no TF32; ragged edges (rows, d, n_out) are
//    masked here, nothing is padded.
//
// Plain C interface (bound with ctypes): every launch returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBI = 64;        // rows of blk per block
constexpr int kBK = 128;       // columns of n_out per block
constexpr int kBD = 32;        // d-step
constexpr int kTM = kBI / 16;  // 4 rows per thread
constexpr int kTN = kBK / 16;  // 8 columns per thread
constexpr int kMaxJ = 1024;    // W row staged in shared memory
constexpr int kCodedPerThread = kBI * kBD / kThreads;  // 8
constexpr int kBPerThread = kBD * kBK / kThreads;      // 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
coded_matmul_kernel(const float* __restrict__ w, const TA* __restrict__ a,
                    const TB* __restrict__ b, TA* __restrict__ out,
                    int n_workers, int j, int blk, int d, int n_out) {
  __shared__ float w_s[kMaxJ];
  __shared__ float c_s[kBD][kBI + 1];  // coded stripe, transposed
  __shared__ float b_s[kBD][kBK];

  const int n = blockIdx.x % n_workers;
  const int k0 = (blockIdx.x / n_workers) * kBK;
  const int i0 = blockIdx.y * kBI;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // encode layout: a warp covers one row and kBD = 32 consecutive d
  const int e_d = tid % kBD;
  const int e_i = tid / kBD;  // 0..7, rows e_i + 8 * r

  for (int jj = tid; jj < j; jj += kThreads)
    w_s[jj] = w[static_cast<int64_t>(n) * j + jj];

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;

  const int64_t a_block = static_cast<int64_t>(blk) * d;
  for (int d0 = 0; d0 < d; d0 += kBD) {
    __syncthreads();  // w_s written / previous stripe and tile consumed

    // encode: the coded stripe of worker n for this d-step
    {
      const int dc = d0 + e_d;
      float cod[kCodedPerThread];
#pragma unroll
      for (int r = 0; r < kCodedPerThread; ++r) cod[r] = 0.f;
      if (dc < d) {
        for (int jj = 0; jj < j; ++jj) {
          const float wv = w_s[jj];
          const TA* src = a + jj * a_block + dc;
#pragma unroll
          for (int r = 0; r < kCodedPerThread; ++r) {
            const int i = i0 + e_i + 8 * r;
            if (i < blk)
              cod[r] = fmaf(wv, to_f32(src[static_cast<int64_t>(i) * d]),
                            cod[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kCodedPerThread; ++r) c_s[e_d][e_i + 8 * r] = cod[r];
    }

    // the B tile, coalesced along n_out
#pragma unroll
    for (int r = 0; r < kBPerThread; ++r) {
      const int e = tid + r * kThreads;
      const int kk = e % kBK;
      const int dr = e / kBK;
      const int dg = d0 + dr;
      const int kg = k0 + kk;
      b_s[dr][kk] = (dg < d && kg < n_out)
                        ? to_f32(b[static_cast<int64_t>(dg) * n_out + kg])
                        : 0.f;
    }
    __syncthreads();

    // the worker product: acc += stripe @ tile
#pragma unroll 8
    for (int kk = 0; kk < kBD; ++kk) {
      float av[kTM];
      float bv[kTN];
#pragma unroll
      for (int r = 0; r < kTM; ++r) av[r] = c_s[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < kTN; ++c) bv[c] = b_s[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= blk) continue;
    TA* row = out + (static_cast<int64_t>(n) * blk + i) * n_out;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int k = k0 + tx + 16 * c;
      if (k < n_out) store(row + k, acc[r][c]);
    }
  }
}

template <typename TA, typename TB>
void launch_typed(const float* w, const void* a, const void* b, void* out,
                  int n_workers, int j, int blk, int d, int n_out,
                  cudaStream_t stream) {
  const int k_tiles = (n_out + kBK - 1) / kBK;
  const dim3 grid(static_cast<unsigned>(n_workers) * k_tiles,
                  (blk + kBI - 1) / kBI);
  coded_matmul_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(
      w, static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TA*>(out), n_workers, j, blk, d, n_out);
}

}  // namespace

// a_dtype / b_dtype: 0 = float32, 1 = bfloat16.  out has A's dtype.
extern "C" int coded_matmul_launch(const float* w, const void* a, const void* b,
                                   void* out, int n_workers, int j, int blk,
                                   int d, int n_out, int a_dtype, int b_dtype,
                                   void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (n_workers <= 0 || j <= 0 || j > kMaxJ || blk <= 0 || d <= 0 ||
      n_out <= 0 || (blk + kBI - 1) / kBI > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int combo = a_dtype * 2 + b_dtype;
  switch (combo) {
    case 0:
      launch_typed<float, float>(w, a, b, out, n_workers, j, blk, d, n_out, s);
      break;
    case 1:
      launch_typed<float, __nv_bfloat16>(w, a, b, out, n_workers, j, blk, d,
                                         n_out, s);
      break;
    case 2:
      launch_typed<__nv_bfloat16, float>(w, a, b, out, n_workers, j, blk, d,
                                         n_out, s);
      break;
    case 3:
      launch_typed<__nv_bfloat16, __nv_bfloat16>(w, a, b, out, n_workers, j,
                                                 blk, d, n_out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
