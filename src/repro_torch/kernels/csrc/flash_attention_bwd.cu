// flash_attention_bwd: dq, dk and dv of the flash attention forward
// (csrc/flash_attention.cu) from its output and its per-row log-sum-exp.
//
//   q, k (B, Sq, H, hd), (B, Skv, KV, hd)  float32 or bfloat16, unit
//                         stride along hd; H = KV * G and query head h
//                         reads kv head h / G
//   v    (B, Skv, KV, hd_v)  q's dtype, unit stride along hd_v
//   out, dout (B, Sq, H, hd_v) q's dtype; out contiguous, dout with unit
//        stride along hd_v (contiguous on the CUDA-core route)
//   lse  (B, Sq, H) float32: m + log(l) of the forward's row state, in
//        natural-log units of the scaled (and soft-capped) scores
//   dq, dk, dv  q's, k's and v's shapes, contiguous
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
// Two routes, chosen by the wrapper from dtype and width
// (kernels/flash_attention_bwd.py `backward_route`); neither is a fallback
// of the other:
//
// bfloat16, hd <= 128 -> tensor cores: `bwd_delta_t_kernel`, then
//   `flash_bwd_dkdv_wgmma_kernel`, then `flash_bwd_dq_wgmma_kernel`.
//   Bound on the H100: operations.  Splitting dq off recomputes S and dP,
//   so the products take 2 (4 hd + 3 hd_v) operations per unmasked (query,
//   key) pair (the one-pass design's five products take 2 (3 hd + 2
//   hd_v)).  At phi3-mini's training shape (B 1, S 4096, 32 heads of 96,
//   causal) that is 360.8 GFLOP, 0.365 ms at the bf16 tensor-core rate of
//   989 TFLOP/s; q, k, v, out, dout and the outputs are ~200 MB, 0.06 ms.
//   Every product is a wgmma m64nNk16 bf16 -> f32 whose operands follow
//   the forward's (flash_fwd_wgmma_kernel): 128-byte-swizzled shared tiles
//   of 64-column chunks (128-byte rows), filled by TMA through 4-d maps
//   over (hd, head, seq, batch), or, where a base address or stride is not
//   16-byte aligned (hd 20 in bf16 is a 40-byte row), by the producer
//   warp's plain loads into the same layout (the forward's rule,
//   `load_width`).  One producer warp keeps the loads in flight through a
//   ring of kStages stages (`full` / `empty` mbarriers); two consumer
//   warpgroups run the products.  The tiles are templated on D, the
//   width hd rounds up to (16, 32, 64, 96 or 128): the q . k and dout . v
//   products take D / 16 (ceil(hd_v / 16)) K-steps, and the products whose
//   N is the head width (dv, dk, dq) take N = D, so at hd 96 nothing runs
//   over 128 zero-padded columns.  hd_v < hd is padded to D with zeros.
//    * `bwd_delta_t_kernel`: one warp per (b, query, head) row sums dout *
//      out in float32 and writes it, and lse * log2(e), transposed to (B *
//      H, Sq_pad) (Sq_pad: Sq rounded up to 128, the padding zeroed), so
//      that a tile's 64 values are one 256-byte bulk copy;
//    * `flash_bwd_dkdv_wgmma_kernel`: one block per (128 keys, batch * kv
//      head), a warpgroup per 64 keys.  K and V are loaded once; Q, dout,
//      lse and delta of each 64-query tile stream through the ring, over
//      the group's G heads and, causal, only the tiles at or after the key
//      tile.  S^T = K Q^T and dP^T = V dout^T (both operands in shared
//      memory, K-major); P^T and dS^T in float32 on the accumulator
//      fragment (lse and delta per column, from shared memory); both
//      rounded to bf16 in registers, where the accumulator fragment is the
//      A fragment of the next products: dV += P^T dout and dK += dS^T Q,
//      B MN-major through the transpose bit.  dK and dV stay in float32
//      registers across the sweep and are written once, in q's dtype.  No
//      P or dS tile passes through shared memory, and nothing is atomic;
//    * `flash_bwd_dq_wgmma_kernel`: one block per (128 queries, batch *
//      head), a warpgroup per 64 rows, Q and dout loaded once and K, V
//      tiles of 64 keys streamed: S = Q K^T and dP = dout V^T, P and dS
//      in float32, dQ += dS K with dS as the bf16 A fragment and K
//      MN-major.  It walks the key tiles in a fixed order and writes dq
//      once, in q's dtype.
//   dq is a pass of its own so that it is deterministic: summing it in
//   the dkdv blocks (which run in no order) would take atomics, whose
//   order, and so dq's bits, changes from run to run.  The pass costs the
//   two recomputed products and returns the float32 dq buffer, its memset
//   and its cast.  Two calls on the same inputs give the same bits.
//   Registers at hd 96 (D = 96): a dkdv consumer thread holds dK and dV
//   (48 + 48 floats), S^T and dP^T (32 + 32) and their bf16 fragments
//   (16 + 16); a dq thread dQ (48), S and dP (32 + 32).  A block is 384
//   threads, so ptxas holds a thread to 168 registers (65,536 / 384), at
//   which dkdv<96> spilled 400 bytes: the producer warpgroup (one warp of
//   it loads, the others exit) lowers its limit to 40 by setmaxnreg and
//   the consumers raise theirs to 232 (128 x 40 + 256 x 232 = 384 x 168),
//   and nothing spills.  Only wgmma writes an accumulator between two of
//   its products (the first product of each sum starts it with scale-d
//   0): ptxas serializes wgmma whose accumulator another instruction
//   writes in between (its C7515 warning).  Shared memory at D 96: dkdv K,
//   V 2 x 32 KB + 2 stages x (Q, dout 2 x 16 KB + 512 B), dq Q, dout 2 x
//   32 KB + 2 stages x (K, V 2 x 16 KB): ~130 KB each with the barriers,
//   one block per SM.  At phi3's shape the three kernels take ~1.64 ms on
//   the H100: ~157 TFLOP/s of the five products the function needs (~220
//   of the seven this design runs; PERF.md section 6).  Three stages and
//   128-key dq stages measured no faster or slower
//   (tools/flash_bwd_variants.py).
//   Numerics: s = scale * (q . k) with q . k a float32 sum of bf16
//   products, soft-capped, as the bf16 forward forms it (its lse is of
//   those scores); p = exp2(s log2 e - lse log2 e); P and dS rounded to
//   bf16 for their products, every sum float32.
//
// float32 (any width), and bfloat16 at hd > 128 (MLA's 192/128) -> CUDA
//   cores: `bwd_delta_kernel`, then `flash_bwd_kernel<HD>`.  float32 is
//   where float32 arithmetic is the point; MLA's 192/128 would not fit
//   the register budget of two warpgroups holding dK and dV (96 + 64
//   floats a thread), and no training path on one card reaches it.
//   Bound: operations, 2 (3 hd + 2 hd_v) per unmasked pair (257.7 GFLOP at
//   phi3's shape, 3.85 ms at the float32 CUDA-core rate of 67 TFLOP/s).
//   One block per (k tile of 64 keys, b * kv head) holds its K and V tiles
//   in shared memory and its dk and dv in registers (a 16 x 16 thread
//   grid, each thread 4 keys x hd / 16 columns), and walks the group's G
//   query heads and their query tiles of 64 rows (causal: only the tiles
//   at or after the k tile).  Per query tile it loads q (times scale),
//   dout, lse and delta, recomputes the 64 x 64 scores and dp as 4 x 4
//   register micro-tiles, writes p and ds to shared memory, and adds p^T
//   dout to dv, ds^T q to dk and ds k to dq, the last by float32
//   atomicAdd into a zeroed float32 dq (several k tiles add to one query
//   row): its dq is not bit-reproducible from run to run.  hd and hd_v are
//   padded with zeros in shared memory to a template width HD in {16, 32,
//   64, 96, 128, 192} and min(HD, 128).  At HD 192 a block takes 198,656
//   bytes of shared memory, at HD 96 133,120: one block per SM.
//
// Plain C interface (bound with ctypes): the launch returns
// cudaGetLastError() (or the tensor-map error) so the Python wrapper
// raises on a refused launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

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

// ---- the CUDA-core route ---------------------------------------------

namespace cc {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBKV = 64;       // keys per block
constexpr int kTM = kBQ / 16;  // 4 rows (or keys) per thread
constexpr int kTN = kBKV / 16; // 4 keys per thread
constexpr int kLdP = kBKV + 1;

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

// `delta` (B, Sq, H) float32; `dq` (B, Sq, H, hd) float32, zeroed
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, float* dq,
           void* dk, void* dv, int batch, int sq, int skv, int n_heads,
           int group, int hd, int hd_v, const int64_t* strides, float scale,
           float softcap, int causal, int dtype, cudaStream_t s) {
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

}  // namespace cc

// ---- the tensor-core route (bfloat16, hd <= 128) -----------------------

namespace tc {

using hopper::desc_sw128;

constexpr int kBKV = 128;      // dkdv: keys per block, 64 per warpgroup
constexpr int kBQ = 128;       // dq: query rows per block, 64 per warpgroup
constexpr int kStep = 64;      // rows a stage streams: queries (dkdv), keys (dq)
constexpr int kStages = 2;
constexpr int kConsumerWarps = 8;
// two consumer warpgroups and a producer warpgroup, of which one warp
// loads.  __launch_bounds__(384, 1) holds a thread to 168 registers;
// the producer warpgroup gives all but kProducerRegs back and the
// consumers take them: 128 x 40 + 256 x 232 = 384 x 168
constexpr int kThreads = 32 * kConsumerWarps + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kBig = 128 * 128;    // a 64-column chunk of 128 rows
constexpr uint32_t kSmall = 64 * 128;   // a 64-column chunk of 64 rows
constexpr int kPadRows = 128;           // Sq_pad: Sq rounded up to this
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse2;    // (B * H, sq_pad): lse * log2(e)
  const float* delta;   // (B * H, sq_pad)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int n_heads, group, sq, skv, sq_pad, hd, hd_v;
  int64_t st[12];       // (batch, seq, head) strides of q, k, v, dout
  float scale, softcap;
  int causal, load_bytes;
};

// shared-memory byte offsets from the 1024-aligned base, KC 64-column
// chunks per tile.  dkdv: K and V (128 rows) once, Q and dout (64 rows) and
// lse2 and delta (64 floats) per stage; dq: Q and dout (128 rows) once, K
// and V (64 rows) per stage.
template <int KC>
struct Layout {
  static constexpr uint32_t kOnce = 2 * KC * kBig;
  static constexpr uint32_t kStage = 2 * KC * kSmall;
  __host__ __device__ static constexpr uint32_t first(int s) {
    return kOnce + kStage * s;                         // Q (dkdv), K (dq)
  }
  __host__ __device__ static constexpr uint32_t second(int s) {
    return first(s) + KC * kSmall;                     // dout (dkdv), V (dq)
  }
  __host__ __device__ static constexpr uint32_t lse(int s) {
    return kOnce + kStage * kStages + 512 * s;         // dkdv only
  }
  __host__ __device__ static constexpr uint32_t delta(int s) {
    return lse(s) + 256;
  }
  static constexpr uint32_t kBars = kOnce + kStage * kStages + 512 * kStages;
  // barriers: full_once, full[kStages], empty[kStages]; 1024 of align slack
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (+)= A B over N columns, A from registers, B MN-major
template <int N>
__device__ __forceinline__ void rs_tb(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  if constexpr (N == 128)
    hopper::wgmma_m64n128k16_rs_tb(d, a, db, scale_d);
  else if constexpr (N == 96)
    hopper::wgmma_m64n96k16_rs_tb(d, a, db, scale_d);
  else if constexpr (N == 64)
    hopper::wgmma_m64n64k16_rs_tb(d, a, db, scale_d);
  else if constexpr (N == 32)
    hopper::wgmma_m64n32k16_rs_tb(d, a, db, scale_d);
  else
    hopper::wgmma_m64n16k16_rs_tb(d, a, db, scale_d);
}

// rows [r0, r0 + R) of a (rows, n) slab with row stride `stride`
// (elements) into `chunks` swizzled 64-column chunks at `dst` (R * 128
// bytes apart), by the 32 threads of a warp with loads of `width` bytes;
// rows >= n_rows and columns >= n become 0.  `width` divides the base
// address, the stride and n (in bytes).
template <int R>
__device__ __forceinline__ void load_plain(uint8_t* dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int r0,
                                           int n_rows, int n, int chunks,
                                           int width, int lane) {
  const int vec = width / 2;                 // elements per load
  const int per_row = chunks * 64 / vec;
  for (int e = lane; e < R * per_row; e += 32) {
    const int r = e / per_row;
    const int c = (e % per_row) * vec;
    const int gr = r0 + r;
    const bool ok = gr < n_rows && c < n;
    const __nv_bfloat16* p = src + static_cast<int64_t>(gr) * stride + c;
    uint8_t* d = dst + (c / 64) * (R * 128) +
                 hopper::swizzled(r, (c % 64) / 8) + (c % 8) * 2;
    if (width == 8)
      *reinterpret_cast<uint2*>(d) =
          ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
    else if (width == 4)
      *reinterpret_cast<uint32_t*>(d) =
          ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
    else
      *reinterpret_cast<uint16_t*>(d) =
          ok ? *reinterpret_cast<const uint16_t*>(p) : uint16_t(0);
  }
}

// delta = rowsum(dout * out) and lse * log2(e), written transposed to (B *
// H, sq_pad) with the padded rows zeroed; one warp per (b, query, head)
// over B * sq_pad * H rows.  out is contiguous, dout read through its
// (batch, sequence, head) strides `ds`
__global__ void bwd_delta_t_kernel(const __nv_bfloat16* __restrict__ out,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   float* __restrict__ lse2,
                                   float* __restrict__ delta, int64_t rows,
                                   int sq, int sq_pad, int n_heads, int hd_v,
                                   int64_t ds_b, int64_t ds_s,
                                   int64_t ds_h) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int h = static_cast<int>(row % n_heads);
  const int qi = static_cast<int>((row / n_heads) % sq_pad);
  const int64_t b = row / (static_cast<int64_t>(n_heads) * sq_pad);
  float acc = 0.f, l2 = 0.f;
  if (qi < sq) {
    const int64_t r = (b * sq + qi) * n_heads + h;
    const __nv_bfloat16* g = dout + b * ds_b + qi * ds_s + h * ds_h;
    for (int c = lane; c < hd_v; c += 32)
      acc = fmaf(__bfloat162float(g[c]), __bfloat162float(out[r * hd_v + c]),
                 acc);
    l2 = lse[r] * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t t = (b * n_heads + h) * sq_pad + qi;
    delta[t] = acc;
    lse2[t] = l2;
  }
}

// p = exp(s - lse) and ds = p (dp - delta) [(1 - t^2)] of one score s
// (the raw q . k) and its dp, or 0 and 0 where the pair is masked
__device__ __forceinline__ void p_ds(float s, float dp, float lse2,
                                     float delta, float scale, float softcap,
                                     bool keep, float& p, float& ds) {
  float x, t = 0.f;
  if (softcap > 0.f) {
    t = tanhf(s * scale / softcap);
    x = softcap * t * kLog2e;
  } else {
    x = s * (scale * kLog2e);
  }
  p = ex2(x - lse2);
  ds = p * (dp - delta);
  if (softcap > 0.f) ds *= 1.f - t * t;
  if (!keep) {
    p = 0.f;
    ds = 0.f;
  }
}

// acc (64 rows x N, rows r0 + 8 (e / 2) of this thread) times `scale`
// into rows [.., n_rows) and columns [0, n) of a (rows, n) bf16 matrix
// whose row r starts at dst + row_off(r)
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2],
                                           __nv_bfloat16* dst,
                                           int64_t row_stride, int r0,
                                           int n_rows, int n, float scale,
                                           int quad) {
  const bool pairs = (n % 2) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= n_rows) continue;
    __nv_bfloat16* row = dst + static_cast<int64_t>(r) * row_stride;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int col = 8 * i + 2 * quad;
      const float x0 = acc[4 * i + 2 * half] * scale;
      const float x1 = acc[4 * i + 2 * half + 1] * scale;
      if (pairs && col + 1 < n) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < n) row[col] = __float2bfloat16(x0);
        if (col + 1 < n) row[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __grid_constant__ Args a) {
  constexpr int KC = (D + 63) / 64;
  using L = Layout<KC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kStages;

  const int n_kv = a.n_heads / a.group;
  const int b = blockIdx.x / n_kv;
  const int kvh = blockIdx.x % n_kv;
  const int j0 = blockIdx.y * kBKV;  // causal: the longest sweeps first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool tma = a.load_bytes == 16;
  const int vc = (a.hd_v + 63) / 64;
  const int n_qt = (a.sq + kStep - 1) / kStep;
  const int qt0 = a.causal ? min(j0 / kStep, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_iter = a.group * per_head;

  if (tid == 0) {
    const uint32_t arrivals = tma ? 1 : 32;
    hopper::mbar_init(full_kv, arrivals);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], arrivals);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- the producer warp: K and V once, then Q, dout, lse2 and delta
    // of each query tile through the ring
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumerWarps) return;
    if (tma) {
      if (lane != 0) return;
      hopper::mbar_arrive_expect_tx(full_kv, (KC + vc) * kBig);
      for (int c = 0; c < KC; ++c)
        hopper::tma_load_4d(base + c * kBig, &k_map, full_kv, 64 * c, kvh,
                            j0, b);
      for (int c = 0; c < vc; ++c)
        hopper::tma_load_4d(base + (KC + c) * kBig, &v_map, full_kv, 64 * c,
                            kvh, j0, b);
      for (int t = 0; t < n_iter; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        const int h = kvh * a.group + t / per_head;
        const int q0 = (qt0 + t % per_head) * kStep;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], (KC + vc) * kSmall + 512);
        for (int c = 0; c < KC; ++c)
          hopper::tma_load_4d(base + L::first(s) + c * kSmall, &q_map,
                              &full[s], 64 * c, h, q0, b);
        for (int c = 0; c < vc; ++c)
          hopper::tma_load_4d(base + L::second(s) + c * kSmall, &do_map,
                              &full[s], 64 * c, h, q0, b);
        const int64_t row =
            (static_cast<int64_t>(b) * a.n_heads + h) * a.sq_pad + q0;
        hopper::bulk_load(base + L::lse(s), a.lse2 + row, 256, &full[s]);
        hopper::bulk_load(base + L::delta(s), a.delta + row, 256, &full[s]);
      }
    } else {
      const int lb = a.load_bytes;
      load_plain<kBKV>(base, a.k + b * a.st[3] + kvh * a.st[5], a.st[4], j0,
                       a.skv, a.hd, KC, lb, lane);
      load_plain<kBKV>(base + KC * kBig, a.v + b * a.st[6] + kvh * a.st[8],
                       a.st[7], j0, a.skv, a.hd_v, vc, lb, lane);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(full_kv);
      for (int t = 0; t < n_iter; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        const int h = kvh * a.group + t / per_head;
        const int q0 = (qt0 + t % per_head) * kStep;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        load_plain<kStep>(base + L::first(s), a.q + b * a.st[0] + h * a.st[2],
                          a.st[1], q0, a.sq, a.hd, KC, lb, lane);
        load_plain<kStep>(base + L::second(s),
                          a.dout + b * a.st[9] + h * a.st[11], a.st[10], q0,
                          a.sq, a.hd_v, vc, lb, lane);
        const int64_t row =
            (static_cast<int64_t>(b) * a.n_heads + h) * a.sq_pad + q0;
        float* lse_s = reinterpret_cast<float*>(base + L::lse(s));
        float* dl_s = reinterpret_cast<float*>(base + L::delta(s));
        for (int i = lane; i < kStep; i += 32) {
          lse_s[i] = a.lse2[row + i];
          dl_s[i] = a.delta[row + i];
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: keys kw + [0, 64)
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int kw = j0 + 64 * wg;
  const int kr0 = kw + 16 * (warp % 4) + lane / 4;  // and kr0 + 8
  const uint32_t sb = hopper::smem_u32(base);
  const int vsteps = (a.hd_v + 15) / 16;

  // Only wgmma writes the accumulators inside the loop: the first product
  // of each sum starts it (scale-d 0), and dk and dv are zeroed after the
  // loop if no tile reached them.  A register of an accumulator written by
  // another instruction between two of its wgmma would make ptxas
  // serialize the wgmma (its C7515 warning).
  float dk[D / 2], dv[D / 2];
  int started = 0;
  uint32_t pa[4][4], da[4][4];

  hopper::mbar_wait(full_kv, 0);
  for (int t = 0; t < n_iter; ++t) {
    const int s = t % kStages;
    const int q0 = (qt0 + t % per_head) * kStep;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    // every key of this warpgroup after every query of the tile, or past Skv
    if (kw >= a.skv || (a.causal && kw > q0 + kStep - 1)) {
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      continue;
    }

    // S^T = K Q^T over hd and dP^T = V dout^T over hd_v, in steps of 16
    float st[32], dpt[32];
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (64 * c + 16 * kk >= D) continue;
        hopper::wgmma_m64n64k16_ss(
            st, desc_sw128(sb + c * kBig + wg * 8192 + kk * 32, 16, 1024),
            desc_sw128(sb + L::first(s) + c * kSmall + kk * 32, 16, 1024),
            (c | kk) != 0);
      }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (64 * c + 16 * kk >= D || 4 * c + kk >= vsteps) continue;
        hopper::wgmma_m64n64k16_ss(
            dpt,
            desc_sw128(sb + (KC + c) * kBig + wg * 8192 + kk * 32, 16, 1024),
            desc_sw128(sb + L::second(s) + c * kSmall + kk * 32, 16, 1024),
            (c | kk) != 0);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    // P^T and dS^T, as the bf16 A fragments of k-steps i / 2: st[4i + e]
    // is key kr0 + 8 (e / 2), query q0 + 8 i + 2 quad + e % 2
    const float* lse_s = reinterpret_cast<const float*>(base + L::lse(s));
    const float* dl_s = reinterpret_cast<const float*>(base + L::delta(s));
    const bool masked = q0 + kStep > a.sq || kw + 64 > a.skv ||
                        (a.causal && kw + 63 > q0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * i +
                                                         2 * quad);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * i +
                                                         2 * quad);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + 8 * i + 2 * quad + (e & 1);
        const int kj = kr0 + 8 * (e >> 1);
        const bool keep = !masked || (qi < a.sq && kj < a.skv &&
                                      (!a.causal || kj <= qi));
        p_ds(st[4 * i + e], dpt[4 * i + e], (e & 1) ? l2.y : l2.x,
             (e & 1) ? d2.y : d2.x, a.scale, a.softcap, keep, p[e], ds[e]);
      }
      pa[i / 2][2 * (i % 2)] = pack_bf16(p[0], p[1]);
      pa[i / 2][2 * (i % 2) + 1] = pack_bf16(p[2], p[3]);
      da[i / 2][2 * (i % 2)] = pack_bf16(ds[0], ds[1]);
      da[i / 2][2 * (i % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dout and dK += dS^T Q over the tile's queries in steps of 16
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::fence_regs(pa[kk]);
      hopper::fence_regs(da[kk]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      rs_tb<D>(dv, pa[kk],
                desc_sw128(sb + L::second(s) + kk * 2048, kSmall, 1024),
                started | kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      rs_tb<D>(dk, da[kk],
                desc_sw128(sb + L::first(s) + kk * 2048, kSmall, 1024),
                started | kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::fence_regs(pa[kk]);
      hopper::fence_regs(da[kk]);
    }
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    started = 1;
  }
  if (!started) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  }

  const int64_t key_stride = static_cast<int64_t>(n_kv);
  __nv_bfloat16* dk_base = a.dk + (static_cast<int64_t>(b) * a.skv * n_kv +
                                   kvh) * a.hd;
  __nv_bfloat16* dv_base = a.dv + (static_cast<int64_t>(b) * a.skv * n_kv +
                                   kvh) * a.hd_v;
  store_rows<D>(dk, dk_base, key_stride * a.hd, kr0, a.skv, a.hd, a.scale,
                 quad);
  store_rows<D>(dv, dv_base, key_stride * a.hd_v, kr0, a.skv, a.hd_v, 1.f,
                 quad);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ Args a) {
  constexpr int KC = (D + 63) / 64;
  using L = Layout<KC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.x / a.n_heads;
  const int h = blockIdx.x % a.n_heads;
  const int kvh = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last tiles first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool tma = a.load_bytes == 16;
  const int vc = (a.hd_v + 63) / 64;
  const int kv_end = a.causal ? min(a.skv, q0 + kBQ) : a.skv;
  const int n_tiles = (kv_end + kStep - 1) / kStep;

  if (tid == 0) {
    const uint32_t arrivals = tma ? 1 : 32;
    hopper::mbar_init(full_q, arrivals);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], arrivals);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- the producer warp: Q and dout once, then K and V tiles
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumerWarps) return;
    if (tma) {
      if (lane != 0) return;
      hopper::mbar_arrive_expect_tx(full_q, (KC + vc) * kBig);
      for (int c = 0; c < KC; ++c)
        hopper::tma_load_4d(base + c * kBig, &q_map, full_q, 64 * c, h, q0,
                            b);
      for (int c = 0; c < vc; ++c)
        hopper::tma_load_4d(base + (KC + c) * kBig, &do_map, full_q, 64 * c,
                            h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], (KC + vc) * kSmall);
        for (int c = 0; c < KC; ++c)
          hopper::tma_load_4d(base + L::first(s) + c * kSmall, &k_map,
                              &full[s], 64 * c, kvh, t * kStep, b);
        for (int c = 0; c < vc; ++c)
          hopper::tma_load_4d(base + L::second(s) + c * kSmall, &v_map,
                              &full[s], 64 * c, kvh, t * kStep, b);
      }
    } else {
      const int lb = a.load_bytes;
      load_plain<kBQ>(base, a.q + b * a.st[0] + h * a.st[2], a.st[1], q0,
                      a.sq, a.hd, KC, lb, lane);
      load_plain<kBQ>(base + KC * kBig, a.dout + b * a.st[9] + h * a.st[11],
                      a.st[10], q0, a.sq, a.hd_v, vc, lb, lane);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(full_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        load_plain<kStep>(base + L::first(s),
                          a.k + b * a.st[3] + kvh * a.st[5], a.st[4],
                          t * kStep, a.skv, a.hd, KC, lb, lane);
        load_plain<kStep>(base + L::second(s),
                          a.v + b * a.st[6] + kvh * a.st[8], a.st[7],
                          t * kStep, a.skv, a.hd_v, vc, lb, lane);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: rows qw + [0, 64)
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * (warp % 4) + lane / 4;  // and r0 + 8
  const uint32_t sb = hopper::smem_u32(base);
  const int vsteps = (a.hd_v + 15) / 16;
  const int64_t trow = (static_cast<int64_t>(b) * a.n_heads + h) * a.sq_pad;
  const float lse0 = a.lse2[trow + r0], lse1 = a.lse2[trow + r0 + 8];
  const float dl0 = a.delta[trow + r0], dl1 = a.delta[trow + r0 + 8];

  // only wgmma writes the accumulators inside the loop (as in dkdv)
  float dq[D / 2];
  int started = 0;
  uint32_t da[4][4];

  hopper::mbar_wait(full_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int j0 = t * kStep;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    // every key of the tile after every row of this warpgroup
    if (a.causal && j0 > qw + 63) {
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      continue;
    }

    // S = Q K^T over hd and dP = dout V^T over hd_v, in steps of 16
    float sc[32], dp[32];
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (64 * c + 16 * kk >= D) continue;
        hopper::wgmma_m64n64k16_ss(
            sc, desc_sw128(sb + c * kBig + wg * 8192 + kk * 32, 16, 1024),
            desc_sw128(sb + L::first(s) + c * kSmall + kk * 32, 16, 1024),
            (c | kk) != 0);
      }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (64 * c + 16 * kk >= D || 4 * c + kk >= vsteps) continue;
        hopper::wgmma_m64n64k16_ss(
            dp,
            desc_sw128(sb + (KC + c) * kBig + wg * 8192 + kk * 32, 16, 1024),
            desc_sw128(sb + L::second(s) + c * kSmall + kk * 32, 16, 1024),
            (c | kk) != 0);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // dS as the bf16 A fragments of k-steps i / 2: sc[4i + e] is row r0 +
    // 8 (e / 2), key j0 + 8 i + 2 quad + e % 2
    const bool masked = j0 + kStep > a.skv || (a.causal && j0 + 63 > qw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = j0 + 8 * i + 2 * quad + (e & 1);
        const int qi = r0 + 8 * (e >> 1);
        const bool keep = !masked || (kj < a.skv && (!a.causal || kj <= qi));
        p_ds(sc[4 * i + e], dp[4 * i + e], (e >> 1) ? lse1 : lse0,
             (e >> 1) ? dl1 : dl0, a.scale, a.softcap, keep, p[e], ds[e]);
      }
      da[i / 2][2 * (i % 2)] = pack_bf16(ds[0], ds[1]);
      da[i / 2][2 * (i % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K over the tile's keys in steps of 16
    hopper::fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(da[kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      rs_tb<D>(dq, da[kk],
                desc_sw128(sb + L::first(s) + kk * 2048, kSmall, 1024),
                started | kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(da[kk]);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    started = 1;
  }
  if (!started) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  }

  __nv_bfloat16* dq_base = a.dq + (static_cast<int64_t>(b) * a.sq *
                                   a.n_heads + h) * a.hd;
  store_rows<D>(dq, dq_base, static_cast<int64_t>(a.n_heads) * a.hd, r0,
                 a.sq, a.hd, a.scale, quad);
}

// 4-d map (hd, heads, seq, batch) over a (B, S, heads, hd) bf16 tensor,
// boxes of 64 hd x `rows` rows of one head
inline int make_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                    int heads, int hd, const int64_t* st, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(hd),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(seq),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr,
                               dims, strides, box);
}

template <int D>
int launch_d(const Args& a, int batch, cudaStream_t stream) {
  constexpr int KC = (D + 63) / 64;
  const int n_kv = a.n_heads / a.group;
  // maps[0..3]: q, k, v, dout for the dkdv kernel (K, V boxes of 128
  // rows, Q, dout of 64); maps[4..7] for the dq kernel (the other way)
  CUtensorMap maps[8];
  memset(maps, 0, sizeof(maps));
  if (a.load_bytes == 16) {
    const void* ptr[4] = {a.q, a.k, a.v, a.dout};
    const int seq[4] = {a.sq, a.skv, a.skv, a.sq};
    const int heads[4] = {a.n_heads, n_kv, n_kv, a.n_heads};
    const int width[4] = {a.hd, a.hd, a.hd_v, a.hd_v};
    const int rows_dkdv[4] = {kStep, kBKV, kBKV, kStep};
    const int rows_dq[4] = {kBQ, kStep, kStep, kBQ};
    for (int i = 0; i < 4; ++i) {
      int err = make_map(&maps[i], ptr[i], batch, seq[i], heads[i],
                         width[i], a.st + 3 * i, rows_dkdv[i]);
      if (!err)
        err = make_map(&maps[4 + i], ptr[i], batch, seq[i], heads[i],
                       width[i], a.st + 3 * i, rows_dq[i]);
      if (err) return err;
    }
  }
  const size_t smem = Layout<KC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(batch * n_kv, (a.skv + kBKV - 1) / kBKV);
  flash_bwd_dkdv_wgmma_kernel<D><<<grid_kv, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(batch * a.n_heads, (a.sq + kBQ - 1) / kBQ);
  flash_bwd_dq_wgmma_kernel<D><<<grid_q, kThreads, smem, stream>>>(
      maps[4], maps[5], maps[6], maps[7], a);
  return static_cast<int>(cudaGetLastError());
}

// `scratch`: 2 x (B * H, sq_pad) float32 (lse2, then delta); dq, dk, dv
// bf16
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* scratch, void* dq,
           void* dk, void* dv, int batch, int sq, int skv, int n_heads,
           int group, int hd, int hd_v, const int64_t* strides, float scale,
           float softcap, int causal, int load_bytes, cudaStream_t s) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.n_heads = n_heads;
  a.group = group;
  a.sq = sq;
  a.skv = skv;
  a.sq_pad = (sq + kPadRows - 1) / kPadRows * kPadRows;
  const int64_t per_head = static_cast<int64_t>(batch) * n_heads * a.sq_pad;
  a.lse2 = scratch;
  a.delta = scratch + per_head;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.hd = hd;
  a.hd_v = hd_v;
  for (int i = 0; i < 12; ++i) a.st[i] = strides[i];
  a.scale = scale;
  a.softcap = softcap;
  a.causal = causal;
  a.load_bytes = load_bytes;
  bwd_delta_t_kernel<<<static_cast<unsigned>((per_head + 7) / 8), 256, 0,
                       s>>>(
      static_cast<const __nv_bfloat16*>(out), a.dout, lse, scratch,
      scratch + per_head, per_head, sq, a.sq_pad, n_heads, hd_v, a.st[9],
      a.st[10], a.st[11]);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd <= 16) return launch_d<16>(a, batch, s);
  if (hd <= 32) return launch_d<32>(a, batch, s);
  if (hd <= 64) return launch_d<64>(a, batch, s);
  if (hd <= 96) return launch_d<96>(a, batch, s);
  return launch_d<128>(a, batch, s);
}

}  // namespace tc

}  // namespace

// strides: the (batch, sequence, head) strides of q, k, v and dout in
// elements, in that order (12 values).  dtype: 0 = float32, 1 = bfloat16.
// load_bytes picks the route (the wrapper's `backward_route`):
//   0            the CUDA-core route (float32, or bfloat16 at hd > 128):
//                `scratch` is (B, Sq, H) float32 and `dq` (B, Sq, H, hd)
//                float32, zeroed (summed by atomics);
//   16, 8, 4, 2  the tensor-core route (bfloat16, hd <= 128): the tiles load
//                by TMA (16: every base address and stride 16-byte aligned)
//                or by plain loads of that many bytes (which must divide
//                every base address, stride, hd and hd_v); `scratch` is 2 x
//                (B * H, Sq_pad) float32, Sq_pad = Sq rounded up to 128,
//                and `dq` (B, Sq, H, hd) bfloat16.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, int batch, int sq, int skv, int n_heads, int n_kv_heads,
    int hd, int hd_v, const int64_t* strides, float scale, float softcap,
    int causal, int dtype, int load_bytes, void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (batch <= 0 || sq <= 0 || skv <= 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 || hd <= 0 || hd > 192 || hd_v <= 0 ||
      hd_v > hd || hd_v > 128 || (dtype != 0 && dtype != 1) ||
      static_cast<int64_t>(batch) * n_kv_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = n_heads / n_kv_heads;
  if (load_bytes == 0)
    return cc::launch(q, k, v, out, dout, lse, scratch,
                      static_cast<float*>(dq), dk, dv, batch, sq, skv,
                      n_heads, group, hd, hd_v, strides, scale, softcap,
                      causal, dtype, s);
  if (dtype != 1 || hd > 128 ||
      (load_bytes != 16 && load_bytes != 8 && load_bytes != 4 &&
       load_bytes != 2) ||
      (sq + tc::kBQ - 1) / tc::kBQ > 65535 ||
      (skv + tc::kBKV - 1) / tc::kBKV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch(q, k, v, out, dout, lse, scratch, dq, dk, dv, batch, sq,
                    skv, n_heads, group, hd, hd_v, strides, scale, softcap,
                    causal, load_bytes, s);
}
