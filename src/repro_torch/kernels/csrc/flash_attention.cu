// flash_attention: causal or full GQA attention forward with an online
// softmax.
//
//   q   (B, Sq, H, hd)    float32 or bfloat16, unit stride along hd
//   k/v (B, Skv, KV, hd)  q's dtype, unit stride along hd; H = KV * G and
//                         query head h reads kv head h / G
//   out (B, Sq, H, hd)    contiguous, in q's dtype
//
//   s   = (q * scale) . k, scale = 1 / sqrt(hd), in float32
//   s   = softcap * tanh(s / softcap)            when softcap > 0
//   key j of query i is masked (score -1e30) when j >= Skv or, causal,
//   j > i; both positions start at 0, also when Sq != Skv
//   out = acc / max(l, 1e-30) from the running (m, l, acc) in float32
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`).  As there,
// the (Sq, Skv) scores never reach device memory: the row state and the
// output tile stay on chip across the sweep over kv tiles.
//
// Bound on the H100: operations.  At qwen2-7b prefill (B = 1, S = 4096,
// H = 28, KV = 4, hd = 128, causal) the two products are
// 4 * H * hd * S (S + 1) / 2 ~ 120 GFLOP against ~67 MB of q, k, v and out,
// so the bound is ~0.12 ms at the 989 TFLOP/s bf16 tensor-core rate.  This
// first kernel runs both products as float32 FMAs on the CUDA cores
// (67 TFLOP/s, a ~1.8 ms floor), in the reference's float32 arithmetic;
// tensor cores (mma.sync / wgmma) are a later kernel's work.
//
// What differs from the TPU layout:
//  * GQA: the TPU wrapper broadcast k and v G times and padded hd to 128 in
//    HBM.  Here a block of query head h reads kv head h / G in place, through
//    the tensors' own (batch, sequence, head) strides: no copy, transpose or
//    pad of q, k or v;
//  * hd is padded to HD (16, 32, 64 or 128, a template parameter) with
//    zeros in shared memory only;
//  * one thread block per (query tile of kBQ rows, batch * head).  The TPU
//    grid walked kv tiles in order on one core with the row state in VMEM
//    scratch; here each block walks its own kv tiles in a loop and keeps the
//    row state in registers.  Causal blocks stop at the diagonal tile, and
//    the grid hands out the longest (last) query tiles first;
//  * per kv tile: K into shared memory, S = Q K^T (each thread a 4 x 4
//    micro-tile), the online softmax on the thread's 4 rows (row max and sum
//    over the 16 threads of a row by half-warp shuffles), P into shared
//    memory, V into the buffer K used, acc += P V (each thread 4 rows x
//    HD / 16 columns).  K and V share one buffer, so a block needs ~81 KB of
//    shared memory at HD = 128 and two blocks fit on an SM;
//  * shared rows are padded by one word, so the strided reads of the
//    products are free of bank conflicts.
//
// Plain C interface (bound with ctypes): every launch returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per kv tile
constexpr int kTM = kBQ / 16;  // 4 rows per thread
constexpr int kTN = kBKV / 16; // 4 keys per thread
constexpr int kLdP = kBKV + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// max / sum over the 16 threads of one row: the lanes of a half-warp
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [r0, r0 + 64) of a (rows, hd) slab with row stride `stride` into
// dst[64][HD + 1] as float32 times `scale`; rows >= n_rows and columns
// >= hd become 0
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int64_t stride, int r0, int n_rows,
                                          int hd, float scale) {
  for (int e = threadIdx.x; e < 64 * HD; e += kThreads) {
    const int r = e / HD;
    const int c = e % HD;
    const int gr = r0 + r;
    float x = 0.f;
    if (gr < n_rows && c < hd)
      x = to_f32(src[static_cast<int64_t>(gr) * stride + c]) * scale;
    dst[r * (HD + 1) + c] = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int n_heads,
                 int group, int sq, int skv, int hd, int64_t q_sb,
                 int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                 int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 float scale, float softcap, int causal) {
  constexpr int kLd = HD + 1;
  constexpr int kTD = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kBQ][kLd], q * scale
  float* kv_s = q_s + kBQ * kLd;     // [kBKV][kLd], K then V
  float* p_s = kv_s + kBKV * kLd;    // [kBQ][kLdP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // last tiles first
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y % n_heads;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key / output column lane
  const int ty = tid / 16;  // row lane: rows ty + 16 r

  const T* q_base = q + b * q_sb + h * q_sh;
  const T* k_base = k + b * k_sb + kvh * k_sh;
  const T* v_base = v + b * v_sb + kvh * v_sh;

  load_tile<T, HD>(q_s, q_base, q_ss, q0, sq, hd, scale);

  float m[kTM], l[kTM], acc[kTM][kTD];
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kTD; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  for (int j0 = 0; j0 < kv_end; j0 += kBKV) {
    __syncthreads();  // q_s written / the previous V tile consumed
    load_tile<T, HD>(kv_s, k_base, k_ss, j0, skv, hd, 1.f);
    __syncthreads();

    float s[kTM][kTN];
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[kTM], bk[kTN];
#pragma unroll
      for (int r = 0; r < kTM; ++r) a[r] = q_s[(ty + 16 * r) * kLd + d];
#pragma unroll
      for (int c = 0; c < kTN; ++c) bk[c] = kv_s[(tx + 16 * c) * kLd + d];
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }

    // softcap, mask and the online softmax on this thread's rows
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        const int kj = j0 + tx + 16 * c;
        float x = s[r][c];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool valid = kj < skv && (!causal || kj <= qi);
        x = valid ? x : kNegInf;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        const float p = expf(s[r][c] - m_new);
        s[r][c] = p;
        rs += p;
      }
      l[r] = l[r] * corr + row_sum(rs);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kTD; ++c) acc[r][c] *= corr;
#pragma unroll
      for (int c = 0; c < kTN; ++c)
        p_s[(ty + 16 * r) * kLdP + tx + 16 * c] = s[r][c];
    }
    __syncthreads();  // K consumed, P written
    load_tile<T, HD>(kv_s, v_base, v_ss, j0, skv, hd, 1.f);
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kBKV; ++j) {
      float p[kTM], vv[kTD];
#pragma unroll
      for (int r = 0; r < kTM; ++r) p[r] = p_s[(ty + 16 * r) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kTD; ++c) vv[c] = kv_s[j * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTD; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* row = out + ((static_cast<int64_t>(b) * sq + qi) * n_heads + h) * hd;
#pragma unroll
    for (int c = 0; c < kTD; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) store(row + col, acc[r][c] / denom);
    }
  }
}

template <typename T, int HD>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int batch, int sq, int skv, int n_heads, int group, int hd,
                 const int64_t* strides, float scale, float softcap,
                 int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kBQ + kBKV) * (HD + 1) + kBQ * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * n_heads);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n_heads, group, sq,
      skv, hd, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], strides[6], strides[7], strides[8], scale, softcap, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int batch, int sq, int skv, int n_heads, int group, int hd,
              const int64_t* strides, float scale, float softcap, int causal,
              cudaStream_t stream) {
  if (hd <= 16)
    return launch_typed<T, 16>(q, k, v, out, batch, sq, skv, n_heads, group,
                               hd, strides, scale, softcap, causal, stream);
  if (hd <= 32)
    return launch_typed<T, 32>(q, k, v, out, batch, sq, skv, n_heads, group,
                               hd, strides, scale, softcap, causal, stream);
  if (hd <= 64)
    return launch_typed<T, 64>(q, k, v, out, batch, sq, skv, n_heads, group,
                               hd, strides, scale, softcap, causal, stream);
  return launch_typed<T, 128>(q, k, v, out, batch, sq, skv, n_heads, group,
                              hd, strides, scale, softcap, causal, stream);
}

}  // namespace

// strides: the (batch, sequence, head) strides of q, k and v in elements,
// in that order (9 values).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int sq, int skv, int n_heads,
                                      int n_kv_heads, int hd,
                                      const int64_t* strides, float scale,
                                      float softcap, int causal, int dtype,
                                      void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (batch <= 0 || sq <= 0 || skv < 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 || hd <= 0 || hd > 128 ||
      static_cast<int64_t>(batch) * n_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = n_heads / n_kv_heads;
  switch (dtype) {
    case 0:
      return launch_hd<float>(q, k, v, out, batch, sq, skv, n_heads, group,
                              hd, strides, scale, softcap, causal, s);
    case 1:
      return launch_hd<__nv_bfloat16>(q, k, v, out, batch, sq, skv, n_heads,
                                      group, hd, strides, scale, softcap,
                                      causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
