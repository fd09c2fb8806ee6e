// berrut_combine: out[q, m] = sum_j W[q, j] * B[j, m]
//
// Replaces the Pallas TPU kernel `berrut_encode_kernel`
// (src/repro/kernels/berrut_encode.py, body `_kernel`).  It is the SPACDC
// encode / decode / prefix-decode contraction: a skinny coding matrix W
// (Q x J, float32, Q and J usually below 64) times a very wide payload
// B (J x M, float32 or bfloat16, M up to ~10^7).
//
// Bound on the H100: device-memory bytes.  Each payload element is read
// once and each output written once, 4 * (J + Q) * M bytes for float32,
// against only Q FMAs per payload element.
//
// Design:
//  * one thread block per tile of kThreads * kCols payload columns; the
//    payload is streamed with coalesced loads (neighbouring threads read
//    neighbouring columns), so every B element crosses the memory bus once
//    for Q <= 32;
//  * each thread keeps QT float32 sums for each of its kCols columns in
//    registers; the W slab lives in shared memory and is read as a
//    broadcast (every thread of a warp reads the same word);
//  * J is walked in slabs of kJSlab rows inside the block (the gradient
//    code can push J into the hundreds).  The TPU kernel carried its sum
//    across a sequential J grid axis; blocks on a GPU run in no order, and
//    a grid axis over J would need atomics, so the walk stays in the block;
//  * Q above 32 is walked in chunks of 32 rows inside the block, re-reading
//    the block's payload columns once per chunk (from L2 at these sizes);
//  * accumulation is ordinary IEEE float32 FMA; the output is written in the
//    payload's dtype (round to nearest even for bfloat16), ragged column
//    edges are masked here, and nothing is padded.
//
// Plain C interface (bound with ctypes): every launch returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 2;      // payload columns per thread
constexpr int kJSlab = 64;    // W columns staged in shared memory at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads)
berrut_combine_kernel(const float* __restrict__ w, const T* __restrict__ b,
                      T* __restrict__ out, int q, int j, int64_t m) {
  __shared__ float w_s[kJSlab][QT];
  const int64_t col0 =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kCols) + threadIdx.x;

  for (int q0 = 0; q0 < q; q0 += QT) {
    float acc[QT][kCols];
#pragma unroll
    for (int r = 0; r < QT; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

    for (int j0 = 0; j0 < j; j0 += kJSlab) {
      const int js = min(kJSlab, j - j0);
      __syncthreads();  // every thread is done with the previous slab
      for (int e = threadIdx.x; e < kJSlab * QT; e += kThreads) {
        const int jj = e / QT;
        const int r = e % QT;
        // rows past Q and columns past J are zero, so the FMAs below need
        // no guard
        w_s[jj][r] = (jj < js && q0 + r < q)
                         ? w[static_cast<int64_t>(q0 + r) * j + j0 + jj]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < js; ++jj) {
        const T* row = b + static_cast<int64_t>(j0 + jj) * m;
        float v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int64_t col = col0 + static_cast<int64_t>(c) * kThreads;
          v[c] = col < m ? to_f32(row[col]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < QT; ++r) {
          const float wv = w_s[jj][r];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(wv, v[c], acc[r][c]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < QT; ++r) {
      if (q0 + r < q) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int64_t col = col0 + static_cast<int64_t>(c) * kThreads;
          if (col < m) store(out + static_cast<int64_t>(q0 + r) * m + col,
                             acc[r][c]);
        }
      }
    }
  }
}

template <typename T>
void launch_typed(const float* w, const void* b, void* out, int q, int j,
                  int64_t m, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((m + per_block - 1) / per_block));
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  // the smallest row chunk that holds Q (or 32 rows, walked in chunks)
  if (q <= 4) {
    berrut_combine_kernel<T, 4><<<grid, kThreads, 0, stream>>>(w, bt, ot, q, j, m);
  } else if (q <= 8) {
    berrut_combine_kernel<T, 8><<<grid, kThreads, 0, stream>>>(w, bt, ot, q, j, m);
  } else if (q <= 16) {
    berrut_combine_kernel<T, 16><<<grid, kThreads, 0, stream>>>(w, bt, ot, q, j, m);
  } else if (q <= 24) {
    berrut_combine_kernel<T, 24><<<grid, kThreads, 0, stream>>>(w, bt, ot, q, j, m);
  } else {
    berrut_combine_kernel<T, 32><<<grid, kThreads, 0, stream>>>(w, bt, ot, q, j, m);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (payload and output).
extern "C" int berrut_combine_launch(const float* w, const void* b, void* out,
                                     int q, int j, int64_t m, int dtype,
                                     void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (q <= 0 || j <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_typed<float>(w, b, out, q, j, m, s);
  } else if (dtype == 1) {
    launch_typed<__nv_bfloat16>(w, b, out, q, j, m, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
