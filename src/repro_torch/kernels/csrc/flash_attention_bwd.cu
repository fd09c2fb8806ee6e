// flash_attention_bwd: dq, dk and dv of the flash attention forward
// (csrc/flash_attention.cu) from its output and its per-row log-sum-exp.
//
//   q, k (B, Sq, H, hd), (B, Skv, KV, hd)  float32 or bfloat16, unit
//                         stride along hd; H = KV * G and query head h
//                         reads kv head h / G
//   v    (B, Skv, KV, hd_v)  q's dtype, unit stride along hd_v
//   out, dout (B, Sq, H, hd_v) contiguous, q's dtype
//   lse  (B, Sq, H) float32: m + log(l) of the forward's row state, in
//        natural-log units of the scaled (and soft-capped) scores
//   dq   (B, Sq, H, hd) float32, zeroed by the caller: summed by atomics
//   dk, dv (B, Skv, KV, hd), (B, Skv, KV, hd_v) contiguous, q's dtype
//   hd <= 192, hd_v <= min(hd, 128); Skv >= 1
//
// The function is the reference's flash backward (`_flash_bwd`,
// src/repro/models/attention.py:107), which XLA runs on the TPU: there is
// no Pallas kernel to replace.  It is written by hand because the forward
// on the card is, and a training step at 4096 tokens spends its attention
// time here.  With s = scale * (q . k) (then softcap * tanh(s / softcap)),
//   p  = exp(s - lse)                        masked keys give p = 0
//   delta = rowsum(dout * out)               (a pre-pass)
//   dv = p^T dout,   dp = dout v^T,   ds = p (dp - delta) [(1 - tanh^2)]
//   dq = scale * ds k,   dk = scale * ds^T q.
// dk and dv sum over the G query heads of their kv head.
//
// Bound on the H100: operations.  The five products (s and dq, dk over
// hd; dp and dv over hd_v) take 2 (3 hd + 2 hd_v) operations per unmasked
// (query, key) pair, 2.5 times the forward's 2 (hd + hd_v): at phi3-mini's
// training shape (B 1, S 4096, 32 heads of 96, causal)
// 257.7 GFLOP, 3.85 ms at the float32 CUDA-core rate of 67 TFLOP/s (0.26
// ms at the bf16 tensor-core rate).  This first kernel is simple and
// float32 throughout, on the CUDA cores; tensor cores are later work.
//
// Design:
//  * `bwd_delta_kernel`: one warp per (b, query, head) row sums
//    dout * out in float32;
//  * `flash_bwd_kernel`: one block per (k tile of 64 keys, b * kv head)
//    holds its K and V tiles in shared memory and its dk and dv in
//    registers (a 16 x 16 thread grid, each thread 4 keys x hd / 16
//    columns), and walks the group's G query heads and their query tiles
//    of 64 rows (causal: only the tiles at or after the k tile).  Per
//    query tile it loads q (times scale), dout, lse and delta, recomputes
//    the 64 x 64 scores and dp as 4 x 4 register micro-tiles, writes p and
//    ds to shared memory, and adds p^T dout to dv, ds^T q to dk and
//    ds k to dq, the last by float32 atomicAdd (several k tiles add to one
//    query row).  hd and hd_v are padded with zeros in shared memory to a
//    template width HD in {16, 32, 64, 96, 128, 192} and min(HD, 128).
//    At HD 192 a block takes 198,656 bytes of shared memory, at HD 96
//    133,120: one block per SM.
//
// Plain C interface (bound with ctypes): the launch returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBKV = 64;       // keys per block
constexpr int kTM = kBQ / 16;  // 4 rows (or keys) per thread
constexpr int kTN = kBKV / 16; // 4 keys per thread
constexpr int kLdP = kBKV + 1;

__device__ __forceinline__ float load_elt(const void* p, int64_t i,
                                          int dtype) {
  return dtype == 0 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_elt(void* p, int64_t i, float x,
                                          int dtype) {
  if (dtype == 0)
    static_cast<float*>(p)[i] = x;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
}

// rows [r0, r0 + 64) of a (rows, n) slab at element `base` with row stride
// `stride` into dst[64][W + 1] as float32 times `scale`; rows >= n_rows and
// columns >= n become 0
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          int64_t base, int64_t stride,
                                          int r0, int n_rows, int n,
                                          float scale, int dtype) {
  for (int e = threadIdx.x; e < 64 * W; e += kThreads) {
    const int r = e / W;
    const int c = e % W;
    const int gr = r0 + r;
    float x = 0.f;
    if (gr < n_rows && c < n)
      x = load_elt(src, base + static_cast<int64_t>(gr) * stride + c,
                   dtype) * scale;
    dst[r * (W + 1) + c] = x;
  }
}

// delta[row] = sum_c dout[row, c] * out[row, c], one warp per row
__global__ void bwd_delta_kernel(const void* __restrict__ out,
                                 const void* __restrict__ dout,
                                 float* __restrict__ delta, int64_t rows,
                                 int hd_v, int dtype) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < hd_v; c += 32) {
    const int64_t i = row * hd_v + c;
    acc = fmaf(load_elt(dout, i, dtype), load_elt(out, i, dtype), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const void* __restrict__ q, const void* __restrict__ k,
                 const void* __restrict__ v, const void* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 void* __restrict__ dk, void* __restrict__ dv, int n_heads,
                 int group, int sq, int skv, int hd, int hd_v, int64_t q_sb,
                 int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                 int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 float scale, float softcap, int causal, int dtype) {
  constexpr int HDV = HD < 128 ? HD : 128;
  constexpr int kLd = HD + 1;
  constexpr int kLdV = HDV + 1;
  constexpr int kTD = HD / 16;    // dk / dq columns per thread
  constexpr int kTDV = HDV / 16;  // dv columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;                  // [kBKV][kLd]
  float* v_s = k_s + kBKV * kLd;      // [kBKV][kLdV]
  float* q_s = v_s + kBKV * kLdV;     // [kBQ][kLd], q * scale
  float* do_s = q_s + kBQ * kLd;      // [kBQ][kLdV]
  float* p_s = do_s + kBQ * kLdV;     // [kBQ][kLdP]
  float* ds_s = p_s + kBQ * kLdP;     // [kBQ][kLdP]
  float* lse_s = ds_s + kBQ * kLdP;   // [kBQ]
  float* dl_s = lse_s + kBQ;          // [kBQ], delta

  const int n_kv = n_heads / group;
  const int j0 = blockIdx.x * kBKV;
  const int b = blockIdx.y / n_kv;
  const int kvh = blockIdx.y % n_kv;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key lane of S, column lane of dk / dv / dq
  const int ty = tid / 16;  // row lane of S, key lane of dk / dv

  load_tile<HD>(k_s, k, b * k_sb + kvh * k_sh, k_ss, j0, skv, hd, 1.f,
                dtype);
  load_tile<HDV>(v_s, v, b * v_sb + kvh * v_sh, v_ss, j0, skv, hd_v, 1.f,
                 dtype);

  float dk_acc[kTM][kTD], dv_acc[kTM][kTDV];
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
#pragma unroll
    for (int c = 0; c < kTD; ++c) dk_acc[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < kTDV; ++c) dv_acc[r][c] = 0.f;
  }

  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int qt0 = causal ? j0 / kBQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // K, V loaded / the previous tile's readers done
      load_tile<HD>(q_s, q, b * q_sb + h * q_sh, q_ss, q0, sq, hd, scale,
                    dtype);
      load_tile<HDV>(do_s, dout,
                     (static_cast<int64_t>(b) * sq * n_heads + h) * hd_v,
                     static_cast<int64_t>(n_heads) * hd_v, q0, sq, hd_v, 1.f,
                     dtype);
      if (tid < kBQ) {
        const int qi = q0 + tid;
        const int64_t row = (static_cast<int64_t>(b) * sq + qi) * n_heads + h;
        lse_s[tid] = qi < sq ? lse[row] : 0.f;
        dl_s[tid] = qi < sq ? delta[row] : 0.f;
      }
      __syncthreads();

      // S = (q * scale) k^T and dP = dout v^T on 4 x 4 micro-tiles: rows
      // ty + 16 r, keys tx + 16 c
      float s[kTM][kTN], dp[kTM][kTN];
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float a[kTM], bk[kTN];
#pragma unroll
        for (int r = 0; r < kTM; ++r) a[r] = q_s[(ty + 16 * r) * kLd + d];
#pragma unroll
        for (int c = 0; c < kTN; ++c) bk[c] = k_s[(tx + 16 * c) * kLd + d];
#pragma unroll
        for (int r = 0; r < kTM; ++r)
#pragma unroll
          for (int c = 0; c < kTN; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
      }
#pragma unroll 8
      for (int d = 0; d < HDV; ++d) {
        float a[kTM], bv[kTN];
#pragma unroll
        for (int r = 0; r < kTM; ++r) a[r] = do_s[(ty + 16 * r) * kLdV + d];
#pragma unroll
        for (int c = 0; c < kTN; ++c) bv[c] = v_s[(tx + 16 * c) * kLdV + d];
#pragma unroll
        for (int r = 0; r < kTM; ++r)
#pragma unroll
          for (int c = 0; c < kTN; ++c)
            dp[r][c] = fmaf(a[r], bv[c], dp[r][c]);
      }

      // p = exp(s - lse) and ds = p (dp - delta), masked to 0
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        const int lr = ty + 16 * r;
        const int qi = q0 + lr;
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          const int kj = j0 + tx + 16 * c;
          const bool valid = qi < sq && kj < skv && (!causal || kj <= qi);
          float x = s[r][c];
          float t = 0.f;
          if (softcap > 0.f) {
            t = tanhf(x / softcap);
            x = softcap * t;
          }
          const float p = valid ? expf(x - lse_s[lr]) : 0.f;
          float ds = p * (dp[r][c] - dl_s[lr]);
          if (softcap > 0.f) ds *= 1.f - t * t;
          p_s[lr * kLdP + tx + 16 * c] = p;
          ds_s[lr * kLdP + tx + 16 * c] = valid ? ds : 0.f;
        }
      }
      __syncthreads();

      // dv += p^T dout and dk += ds^T (q * scale): keys ty + 16 r,
      // columns tx + 16 c
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float pr[kTM], dsr[kTM];
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          pr[r] = p_s[i * kLdP + ty + 16 * r];
          dsr[r] = ds_s[i * kLdP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < kTDV; ++c) {
          const float o = do_s[i * kLdV + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < kTM; ++r)
            dv_acc[r][c] = fmaf(pr[r], o, dv_acc[r][c]);
        }
#pragma unroll
        for (int c = 0; c < kTD; ++c) {
          const float qv = q_s[i * kLd + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < kTM; ++r)
            dk_acc[r][c] = fmaf(dsr[r], qv, dk_acc[r][c]);
        }
      }

      // dq += scale * ds k: rows ty + 16 r, columns tx + 16 c, by atomics
      float dq_acc[kTM][kTD];
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTD; ++c) dq_acc[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kBKV; ++j) {
        float dsr[kTM];
#pragma unroll
        for (int r = 0; r < kTM; ++r) dsr[r] = ds_s[(ty + 16 * r) * kLdP + j];
#pragma unroll
        for (int c = 0; c < kTD; ++c) {
          const float kv = k_s[j * kLd + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < kTM; ++r)
            dq_acc[r][c] = fmaf(dsr[r], kv, dq_acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        const int qi = q0 + ty + 16 * r;
        if (qi >= sq) continue;
        float* row = dq + ((static_cast<int64_t>(b) * sq + qi) * n_heads + h) *
                              hd;
#pragma unroll
        for (int c = 0; c < kTD; ++c) {
          const int col = tx + 16 * c;
          if (col < hd) atomicAdd(row + col, dq_acc[r][c] * scale);
        }
      }
    }
  }

  // dk (scale is in q_s) and dv of this block's keys
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int kj = j0 + ty + 16 * r;
    if (kj >= skv) continue;
    const int64_t row = (static_cast<int64_t>(b) * skv + kj) * n_kv + kvh;
#pragma unroll
    for (int c = 0; c < kTD; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) store_elt(dk, row * hd + col, dk_acc[r][c], dtype);
    }
#pragma unroll
    for (int c = 0; c < kTDV; ++c) {
      const int col = tx + 16 * c;
      if (col < hd_v) store_elt(dv, row * hd_v + col, dv_acc[r][c], dtype);
    }
  }
}

template <int HD>
int launch_main(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, float* dq, void* dk,
                void* dv, int batch, int sq, int skv, int n_heads, int group,
                int hd, int hd_v, const int64_t* st, float scale,
                float softcap, int causal, int dtype, cudaStream_t stream) {
  constexpr int HDV = HD < 128 ? HD : 128;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBKV + kBQ) * (HD + 1 + HDV + 1) +
       2 * kBQ * kLdP + 2 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((skv + kBKV - 1) / kBKV, batch * (n_heads / group));
  flash_bwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, n_heads, group, sq, skv, hd,
      hd_v, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, softcap, causal, dtype);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: the (batch, sequence, head) strides of q, k and v in elements,
// in that order (9 values).  dtype: 0 = float32, 1 = bfloat16.  `delta` is
// (B, Sq, H) float32 scratch; `dq` (B, Sq, H, hd) float32, zeroed.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, float* dq, void* dk,
    void* dv, int batch, int sq, int skv, int n_heads, int n_kv_heads,
    int hd, int hd_v, const int64_t* strides, float scale, float softcap,
    int causal, int dtype, void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (batch <= 0 || sq <= 0 || skv <= 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 || hd <= 0 || hd > 192 || hd_v <= 0 ||
      hd_v > hd || hd_v > 128 || (dtype != 0 && dtype != 1) ||
      static_cast<int64_t>(batch) * n_kv_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = n_heads / n_kv_heads;
  const int64_t rows = static_cast<int64_t>(batch) * sq * n_heads;
  const int64_t per_block = kThreads / 32;
  bwd_delta_kernel<<<static_cast<unsigned>((rows + per_block - 1) /
                                           per_block),
                     kThreads, 0, s>>>(out, dout, delta, rows, hd_v, dtype);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define FLASH_BWD(HD)                                                     \
  return launch_main<HD>(q, k, v, dout, lse, delta, dq, dk, dv, batch, sq, \
                         skv, n_heads, group, hd, hd_v, strides, scale,    \
                         softcap, causal, dtype, s)
  if (hd <= 16) FLASH_BWD(16);
  if (hd <= 32) FLASH_BWD(32);
  if (hd <= 64) FLASH_BWD(64);
  if (hd <= 96) FLASH_BWD(96);
  if (hd <= 128) FLASH_BWD(128);
  FLASH_BWD(192);
#undef FLASH_BWD
}
