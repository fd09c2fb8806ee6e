// flash_attention_bwd: dq, dk and dv of the flash attention forward
// (csrc/flash_attention.cu) from its output and its per-row log-sum-exp.
//
//   q, k (B, Sq, H, hd), (B, Skv, KV, hd)  float32 or bfloat16, unit
//                         stride along hd; H = KV * G and query head h
//                         reads kv head h / G
//   v    (B, Skv, KV, hd_v)  q's dtype, unit stride along hd_v
//   out, dout (B, Sq, H, hd_v) q's dtype; out contiguous, dout with unit
//        stride along hd_v
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
// Two routes, both on Hopper's tensor cores, chosen by dtype (the wrapper's
// `backward_route`; neither is a fallback of the other).  Both compute dq
// in a pass of its own that walks the key tiles in a fixed order: summing
// it in the blocks that own the keys (which run in no order) would take
// atomics, whose order, and so dq's bits, changes from run to run.  The
// pass recomputes s and dp, so the products take 2 (4 hd + 3 hd_v)
// operations per unmasked (query, key) pair where the one-pass design's
// five take 2 (3 hd + 2 hd_v).  Nothing is atomic: two calls on the same
// inputs give the same bits.  Bound on the H100: operations.
//
// bfloat16, every width -> bf16 wgmma: `bwd_delta_t_kernel`, then
//   `flash_bwd_dkdv_wgmma_kernel<D>`, then `flash_bwd_dq_wgmma_kernel<D>`.
//   At phi3-mini's training shape (B 1, S 4096, 32 heads of 96, causal)
//   the seven products are 360.8 GFLOP, 0.365 ms at the bf16 tensor-core
//   rate of 989 TFLOP/s; q, k, v, out, dout and the outputs are ~200 MB,
//   0.06 ms.  Every product is a wgmma m64nNk16 bf16 -> f32 whose operands
//   follow the forward's (flash_fwd_wgmma_kernel): 128-byte-swizzled shared
//   tiles of 64-column chunks (128-byte rows), filled by TMA through 4-d
//   maps over (hd, head, seq, batch), or, where a base address or stride
//   is not 16-byte aligned (hd 20 in bf16 is a 40-byte row), by the
//   producer warp's plain loads into the same layout (the forward's rule,
//   `load_width`).  One producer warp keeps the loads in flight through a
//   ring of kStages stages (`full` / `empty` mbarriers); two consumer
//   warpgroups run the products.  The tiles are templated on D, the width
//   hd rounds up to (16, 32, 64, 96, 128 or 192), and v on DV = D up to
//   128 and 128 at D 192 (MLA's 192/128, as the forward's QC and VC): the
//   q . k products take D / 16 K-steps and dout . v ceil(hd_v / 16), the
//   products whose N is a head width take N = D (dk, dq) or DV (dv), so
//   nothing runs over zero-padded columns past the template width.
//    * `bwd_delta_t_kernel`: one warp per (b, query, head) row sums dout *
//      out in float32 and writes it, and lse * log2(e), transposed to (B *
//      H, Sq_pad) (Sq_pad: Sq rounded up to 128, the padding zeroed), so
//      that a tile's values are one bulk copy;
//    * `flash_bwd_dkdv_wgmma_kernel`: one block per (128 keys, batch * kv
//      head), a warpgroup per 64 keys.  K and V are loaded once; Q, dout,
//      lse and delta of each tile of BQS queries (64; 32 at D 192) stream
//      through the ring, over the group's G heads and, causal, only the
//      tiles at or after the key tile.  S^T = K Q^T and dP^T = V dout^T
//      (both operands in shared memory, K-major); P^T and dS^T in float32
//      on the accumulator fragment (lse and delta per column, from shared
//      memory); both rounded to bf16 in registers, where the accumulator
//      fragment is the A fragment of the next products: dV += P^T dout and
//      dK += dS^T Q, B MN-major through the transpose bit.  dK and dV stay
//      in float32 registers across the sweep and are written once, in q's
//      dtype.  No P or dS tile passes through shared memory;
//    * `flash_bwd_dq_wgmma_kernel`: one block per (128 queries, batch *
//      head), a warpgroup per 64 rows, Q and dout loaded once and K, V
//      tiles of 64 keys streamed: S = Q K^T and dP = dout V^T, P and dS
//      in float32, dQ += dS K with dS as the bf16 A fragment and K
//      MN-major.  It walks the key tiles in a fixed order and writes dq
//      once, in q's dtype.
//   Registers: a block is 384 threads, so ptxas holds a thread to 168
//   registers (65,536 / 384), at which dkdv<96> spilled 400 bytes: the
//   producer warpgroup (one warp of it loads, the others exit) lowers its
//   limit to 40 by setmaxnreg and the consumers raise theirs to 232 (128 x
//   40 + 256 x 232 = 384 x 168).  A dkdv consumer thread holds dK and dV
//   (D / 2 + DV / 2 floats), S^T and dP^T (BQS / 2 each) and their bf16
//   fragments (BQS / 4 each): 208 at D 192 with 32-query stages (64 would
//   need 256); a dq thread dQ (D / 2), S and dP (32 + 32).  Only wgmma
//   writes an accumulator between two of its products (the first product
//   of each sum starts it with scale-d 0): ptxas serializes wgmma whose
//   accumulator another instruction writes in between (its C7515
//   warning).  Shared memory: dkdv K, V (128 rows) + 2 stages x (Q, dout
//   of BQS rows, lse, delta), dq Q, dout (128 rows) + 2 stages x (K, V of
//   64): ~130 KB each at D 96, 122 and 161 KB at 192/128; one block per
//   SM.  Three stages and 128-key dq stages measured no faster or slower
//   at hd 96 (tools/flash_bwd_variants.py).
//   Numerics: s = scale * (q . k) with q . k a float32 sum of bf16
//   products, soft-capped, as the bf16 forward forms it (its lse is of
//   those scores); p = exp2(s log2 e - lse log2 e); P and dS rounded to
//   bf16 for their products, every sum float32.
//
// float32, every width -> 3xTF32 wgmma: a pre-pass (`bwd_delta_t_kernel`,
//   `split_rows_kernel`, `split_t_kernel`), then `flash_bwd_3xtf32_kernel`
//   passes: up to HDP 96 (phi3-mini's 96 on the float32 training path) one
//   pass for dv and dk together and one for dq, above it a dv, a dk and a
//   dq pass.  The arithmetic is the float32 forward's
//   (flash_fwd_3xtf32_kernel): x = hi + lo with hi = tf32(x) and lo =
//   tf32(x - hi), a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b
//   dropped), every sum float32; the scores are (q * scale) . k with q
//   scaled in float32 before the split, as the forward whose lse the
//   backward consumes forms them, so p = exp(s - lse) sees the same
//   scores.  Bound: the five products at a third of the 495 TFLOP/s TF32
//   rate, 257.7 GFLOP at phi3's shape, 1.56 ms.
//   What shaped the design:
//    * TF32 wgmma has no transpose bit: every shared-memory operand is
//      K-major.  S^T = K (Q scale)^T and dP^T = V dout^T (dk, dv) and S, dP
//      (dq) read the rows as they lie; dV += P^T dout and dK += dS^T (Q
//      scale) reduce over queries, so they read dout^T and (Q scale)^T
//      planes, and dQ += dS K reduces over keys, so it reads a K^T plane.
//      P^T, dS^T (over queries) and dS (over keys) go from the score
//      accumulator to the A fragment of those products in registers: an
//      m64nN accumulator holds columns 2t and 2t + 1 of each 8 in thread t
//      of a quad, a tf32 m64k8 A fragment columns t and t + 4, so the
//      transposed planes hold the reduced index of every 8 in the order
//      (0, 2, 4, 6, 1, 3, 5, 7) (the forward's v^T).  The pre-pass writes
//      q * scale, dout, k and v as rows planes and (q * scale)^T, dout^T
//      and k^T as transposed planes, each hi then lo, zero-padded (Sq and
//      Skv to 64, hd to HDP in {32, 64, 96, 128, 192}, hd_v to min(HDP,
//      128)) into scratch the wrapper allocates
//      (flash_attention_bwd_scratch gives its size; ~0.7 GB at phi3's
//      shape, whose bytes count in the call), with lse * log2 e and delta.
//    * Accuracy: a wgmma adds its products into its accumulator less
//      accurately than a float32 add (PR 26's measurement: one accumulator
//      over S's 72 k8 steps at hd 192 gave 3.4x the plain version's rms
//      error), and dK and dV sum over every query tile of G heads (512 k8
//      steps x 3 products into one accumulator at phi3's shape).  So no
//      accumulator spans more than one tile: each tile's S and dP start
//      afresh (the small products in one accumulator, the hi.hi of hd's
//      32-wide chunks in NB more: 3 at HDP 192, 2 at 96, as the forward),
//      and each tile's output product goes, NC columns at a time, to a
//      fresh accumulator that is added into float32 registers.  Summed by
//      wgmma over the whole sweep instead, dq, dk and dv carried 28x the
//      rms error against float64 (tools/flash_bwd_variants.py).
//    * Shared memory: hi and lo double every tile; the once side of a
//      block is 64 rows (K and V at 192/128: 160 KB).  Each pass streams
//      the rows operands of S and dP through AS stages and the transposed
//      operands through BS (the deepest of (2, 2), (2, 1), (1, 1) that fit
//      227 KB), so the next tile's loads overlap this tile's products.
//      The streamed tile is T = 32 rows (16 for dk and dq at HDP 192,
//      whose transposed tiles are then 64-byte rows under the 64-byte
//      swizzle).
//    * Up to HDP 96 (`Cfg`): the dv and dk pass (kDKV) holds K and V once
//      and streams Q scale, dout, dout^T and (Q scale)^T for two consumer
//      warpgroups: the dv one computes S^T, P^T and dV += P^T dout and
//      hands g = p [(1 - tanh^2)] to the dk one through two slots of
//      shared memory (mbarriers `full_p` / `empty_p`), which computes
//      dP^T, dS^T = g (dP^T - delta) and dK += dS^T (Q scale): seven
//      products in all, balanced two a warpgroup.  The dq pass (ALT) runs
//      two consumer warpgroups on alternate key tiles, each its own
//      stage and its own barrier of the one transposed stage, and adds the
//      two partial dq in a fixed order at the end.  384 threads: the
//      producer warpgroup gives registers back by setmaxnreg (40) and the
//      consumers take 232, as the bf16 kernels.  At phi3's shape on the
//      H100 the call took 5.39-5.77 ms so, 6.84-6.93 with dv and dk in
//      passes of one warpgroup each and 5.84 with dq on one warpgroup
//      (tools/flash_bwd_variants.py; PERF.md).
//      Above HDP 96 shared memory holds one warpgroup's stages: dv, dk and
//      dq are passes of one consumer warpgroup, and the dv pass recomputes
//      S (eight products, 2 (5 hd + 3 hd_v) per pair).
//    * causal: tiles above the diagonal are never loaded; only the tiles
//      that cross the diagonal, Sq or Skv are masked element by element.
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

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// delta = rowsum(dout * out) and lse * log2(e), written transposed to (B *
// H, sq_pad) with the padded rows zeroed; one warp per (b, query, head)
// over B * sq_pad * H rows.  out is contiguous, dout read through its
// (batch, sequence, head) strides `ds`.  Both routes run it (E: float or
// __nv_bfloat16)
template <typename E>
__global__ void bwd_delta_t_kernel(const E* __restrict__ out,
                                   const E* __restrict__ dout,
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
    const E* g = dout + b * ds_b + qi * ds_s + h * ds_h;
    for (int c = lane; c < hd_v; c += 32)
      acc = fmaf(to_float(g[c]), to_float(out[r * hd_v + c]), acc);
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


// ---- bfloat16: bf16 wgmma ----------------------------------------------

namespace tc {

using hopper::desc_sw128;

constexpr int kBKV = 128;      // dkdv: keys per block, 64 per warpgroup
constexpr int kBQ = 128;       // dq: query rows per block, 64 per warpgroup
constexpr int kStep = 64;      // dq: keys a stage streams
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
constexpr int kPadRows = 128;           // Sq_pad: Sq rounded up to this

// the v width a q . k width D pads hd_v to, and the queries a dkdv stage
// streams: at D 192 32, which keeps a consumer thread's dK, dV, S^T, dP^T
// and their fragments (96 + 64 + 16 + 16 + 8 + 8) within its 232 registers
template <int D>
__host__ __device__ constexpr int v_width() { return D > 128 ? 128 : D; }
template <int D>
__host__ __device__ constexpr int dkdv_step() { return D > 128 ? 32 : 64; }

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

// shared-memory byte offsets from the 1024-aligned base: QC 64-column
// chunks of q . k, VC of v.  dkdv: K and V (128 rows) once, Q and dout (R
// rows) and lse2 and delta (R floats) per stage; dq: Q and dout (128 rows)
// once, K and V (R = 64 rows) per stage.
template <int QC, int VC, int R>
struct Layout {
  static constexpr uint32_t kChunk = R * 128;   // a 64-column chunk of R rows
  static constexpr uint32_t kOnce = (QC + VC) * kBig;
  static constexpr uint32_t kStage = (QC + VC) * kChunk;
  __host__ __device__ static constexpr uint32_t first(int s) {
    return kOnce + kStage * s;                         // Q (dkdv), K (dq)
  }
  __host__ __device__ static constexpr uint32_t second(int s) {
    return first(s) + QC * kChunk;                     // dout (dkdv), V (dq)
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (+)= A B over N = 64 or 32 columns, A and B K-major
template <int N>
__device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da,
                                   uint64_t db, int scale_d) {
  if constexpr (N == 64)
    hopper::wgmma_m64n64k16_ss(d, da, db, scale_d);
  else
    hopper::wgmma_m64n32k16_ss(d, da, db, scale_d);
}

// D (+)= A B over N columns, A from registers, B MN-major
template <int N>
__device__ __forceinline__ void rs_tb(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  if constexpr (N == 192)
    hopper::wgmma_m64n192k16_rs_tb(d, a, db, scale_d);
  else if constexpr (N == 128)
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
  constexpr int DV = v_width<D>();
  constexpr int QC = (D + 63) / 64;
  constexpr int VC = (DV + 63) / 64;
  constexpr int BQS = dkdv_step<D>();
  using L = Layout<QC, VC, BQS>;
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
  const int n_qt = (a.sq + BQS - 1) / BQS;
  const int qt0 = a.causal ? min(j0 / BQS, n_qt) : 0;
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
      hopper::mbar_arrive_expect_tx(full_kv, (QC + vc) * kBig);
      for (int c = 0; c < QC; ++c)
        hopper::tma_load_4d(base + c * kBig, &k_map, full_kv, 64 * c, kvh,
                            j0, b);
      for (int c = 0; c < vc; ++c)
        hopper::tma_load_4d(base + (QC + c) * kBig, &v_map, full_kv, 64 * c,
                            kvh, j0, b);
      for (int t = 0; t < n_iter; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        const int h = kvh * a.group + t / per_head;
        const int q0 = (qt0 + t % per_head) * BQS;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s],
                                      (QC + vc) * L::kChunk + 8 * BQS);
        for (int c = 0; c < QC; ++c)
          hopper::tma_load_4d(base + L::first(s) + c * L::kChunk, &q_map,
                              &full[s], 64 * c, h, q0, b);
        for (int c = 0; c < vc; ++c)
          hopper::tma_load_4d(base + L::second(s) + c * L::kChunk, &do_map,
                              &full[s], 64 * c, h, q0, b);
        const int64_t row =
            (static_cast<int64_t>(b) * a.n_heads + h) * a.sq_pad + q0;
        hopper::bulk_load(base + L::lse(s), a.lse2 + row, 4 * BQS, &full[s]);
        hopper::bulk_load(base + L::delta(s), a.delta + row, 4 * BQS,
                          &full[s]);
      }
    } else {
      const int lb = a.load_bytes;
      load_plain<kBKV>(base, a.k + b * a.st[3] + kvh * a.st[5], a.st[4], j0,
                       a.skv, a.hd, QC, lb, lane);
      load_plain<kBKV>(base + QC * kBig, a.v + b * a.st[6] + kvh * a.st[8],
                       a.st[7], j0, a.skv, a.hd_v, vc, lb, lane);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(full_kv);
      for (int t = 0; t < n_iter; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        const int h = kvh * a.group + t / per_head;
        const int q0 = (qt0 + t % per_head) * BQS;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        load_plain<BQS>(base + L::first(s), a.q + b * a.st[0] + h * a.st[2],
                        a.st[1], q0, a.sq, a.hd, QC, lb, lane);
        load_plain<BQS>(base + L::second(s),
                        a.dout + b * a.st[9] + h * a.st[11], a.st[10], q0,
                        a.sq, a.hd_v, vc, lb, lane);
        const int64_t row =
            (static_cast<int64_t>(b) * a.n_heads + h) * a.sq_pad + q0;
        float* lse_s = reinterpret_cast<float*>(base + L::lse(s));
        float* dl_s = reinterpret_cast<float*>(base + L::delta(s));
        for (int i = lane; i < BQS; i += 32) {
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
  float dk[D / 2], dv[DV / 2];
  int started = 0;
  uint32_t pa[BQS / 16][4], da[BQS / 16][4];

  hopper::mbar_wait(full_kv, 0);
  for (int t = 0; t < n_iter; ++t) {
    const int s = t % kStages;
    const int q0 = (qt0 + t % per_head) * BQS;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    // every key of this warpgroup after every query of the tile, or past Skv
    if (kw >= a.skv || (a.causal && kw > q0 + BQS - 1)) {
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      continue;
    }

    // S^T = K Q^T over hd and dP^T = V dout^T over hd_v, in steps of 16
    float st[BQS / 2], dpt[BQS / 2];
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < QC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (64 * c + 16 * kk >= D) continue;
        ss<BQS>(st, desc_sw128(sb + c * kBig + wg * 8192 + kk * 32, 16, 1024),
                desc_sw128(sb + L::first(s) + c * L::kChunk + kk * 32, 16,
                           1024),
                (c | kk) != 0);
      }
    }
#pragma unroll
    for (int c = 0; c < VC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (64 * c + 16 * kk >= DV || 4 * c + kk >= vsteps) continue;
        ss<BQS>(dpt,
                desc_sw128(sb + (QC + c) * kBig + wg * 8192 + kk * 32, 16,
                           1024),
                desc_sw128(sb + L::second(s) + c * L::kChunk + kk * 32, 16,
                           1024),
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
    const bool masked = q0 + BQS > a.sq || kw + 64 > a.skv ||
                        (a.causal && kw + 63 > q0);
#pragma unroll
    for (int i = 0; i < BQS / 8; ++i) {
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
    for (int kk = 0; kk < BQS / 16; ++kk) {
      hopper::fence_regs(pa[kk]);
      hopper::fence_regs(da[kk]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQS / 16; ++kk)
      rs_tb<DV>(dv, pa[kk],
                desc_sw128(sb + L::second(s) + kk * 2048, L::kChunk, 1024),
                started | kk);
#pragma unroll
    for (int kk = 0; kk < BQS / 16; ++kk)
      rs_tb<D>(dk, da[kk],
               desc_sw128(sb + L::first(s) + kk * 2048, L::kChunk, 1024),
               started | kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < BQS / 16; ++kk) {
      hopper::fence_regs(pa[kk]);
      hopper::fence_regs(da[kk]);
    }
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    started = 1;
  }
  if (!started) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
  }

  const int64_t key_stride = static_cast<int64_t>(n_kv);
  __nv_bfloat16* dk_base = a.dk + (static_cast<int64_t>(b) * a.skv * n_kv +
                                   kvh) * a.hd;
  __nv_bfloat16* dv_base = a.dv + (static_cast<int64_t>(b) * a.skv * n_kv +
                                   kvh) * a.hd_v;
  store_rows<D>(dk, dk_base, key_stride * a.hd, kr0, a.skv, a.hd, a.scale,
                 quad);
  store_rows<DV>(dv, dv_base, key_stride * a.hd_v, kr0, a.skv, a.hd_v, 1.f,
                 quad);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ Args a) {
  constexpr int DV = v_width<D>();
  constexpr int QC = (D + 63) / 64;
  constexpr int VC = (DV + 63) / 64;
  using L = Layout<QC, VC, kStep>;
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
      hopper::mbar_arrive_expect_tx(full_q, (QC + vc) * kBig);
      for (int c = 0; c < QC; ++c)
        hopper::tma_load_4d(base + c * kBig, &q_map, full_q, 64 * c, h, q0,
                            b);
      for (int c = 0; c < vc; ++c)
        hopper::tma_load_4d(base + (QC + c) * kBig, &do_map, full_q, 64 * c,
                            h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], (QC + vc) * L::kChunk);
        for (int c = 0; c < QC; ++c)
          hopper::tma_load_4d(base + L::first(s) + c * L::kChunk, &k_map,
                              &full[s], 64 * c, kvh, t * kStep, b);
        for (int c = 0; c < vc; ++c)
          hopper::tma_load_4d(base + L::second(s) + c * L::kChunk, &v_map,
                              &full[s], 64 * c, kvh, t * kStep, b);
      }
    } else {
      const int lb = a.load_bytes;
      load_plain<kBQ>(base, a.q + b * a.st[0] + h * a.st[2], a.st[1], q0,
                      a.sq, a.hd, QC, lb, lane);
      load_plain<kBQ>(base + QC * kBig, a.dout + b * a.st[9] + h * a.st[11],
                      a.st[10], q0, a.sq, a.hd_v, vc, lb, lane);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(full_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        load_plain<kStep>(base + L::first(s),
                          a.k + b * a.st[3] + kvh * a.st[5], a.st[4],
                          t * kStep, a.skv, a.hd, QC, lb, lane);
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
    for (int c = 0; c < QC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (64 * c + 16 * kk >= D) continue;
        hopper::wgmma_m64n64k16_ss(
            sc, desc_sw128(sb + c * kBig + wg * 8192 + kk * 32, 16, 1024),
            desc_sw128(sb + L::first(s) + c * L::kChunk + kk * 32, 16, 1024),
            (c | kk) != 0);
      }
    }
#pragma unroll
    for (int c = 0; c < VC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (64 * c + 16 * kk >= DV || 4 * c + kk >= vsteps) continue;
        hopper::wgmma_m64n64k16_ss(
            dp,
            desc_sw128(sb + (QC + c) * kBig + wg * 8192 + kk * 32, 16, 1024),
            desc_sw128(sb + L::second(s) + c * L::kChunk + kk * 32, 16,
                       1024),
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
               desc_sw128(sb + L::first(s) + kk * 2048, L::kChunk, 1024),
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
  constexpr int QC = (D + 63) / 64;
  constexpr int VC = (v_width<D>() + 63) / 64;
  constexpr int BQS = dkdv_step<D>();
  const int n_kv = a.n_heads / a.group;
  // maps[0..3]: q, k, v, dout for the dkdv kernel (K, V boxes of 128
  // rows, Q, dout of BQS); maps[4..7] for the dq kernel (Q, dout of 128,
  // K, V of 64)
  CUtensorMap maps[8];
  memset(maps, 0, sizeof(maps));
  if (a.load_bytes == 16) {
    const void* ptr[4] = {a.q, a.k, a.v, a.dout};
    const int seq[4] = {a.sq, a.skv, a.skv, a.sq};
    const int heads[4] = {a.n_heads, n_kv, n_kv, a.n_heads};
    const int width[4] = {a.hd, a.hd, a.hd_v, a.hd_v};
    const int rows_dkdv[4] = {BQS, kBKV, kBKV, BQS};
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
  const size_t smem_kv = Layout<QC, VC, BQS>::kBytes;
  const size_t smem_q = Layout<QC, VC, kStep>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(batch * n_kv, (a.skv + kBKV - 1) / kBKV);
  flash_bwd_dkdv_wgmma_kernel<D><<<grid_kv, kThreads, smem_kv, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(batch * a.n_heads, (a.sq + kBQ - 1) / kBQ);
  flash_bwd_dq_wgmma_kernel<D><<<grid_q, kThreads, smem_q, stream>>>(
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
  if (hd <= 128) return launch_d<128>(a, batch, s);
  return launch_d<192>(a, batch, s);
}

}  // namespace tc

// ---- float32: 3xTF32 wgmma ---------------------------------------------

namespace f32 {

using hopper::desc_sw128;

constexpr int kPad = 64;          // Sq and Skv round up to this in the planes
enum Kind { kDV = 0, kDK = 1, kDQ = 2, kDKV = 3 };

// wait until `count` threads (whole warps) have reached named barrier `id`
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// round to nearest (ties away) at TF32's 10 mantissa bits, as
// flash_attention.cu's tf32_round (one instruction here): the low 13 bits
// become 0
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// the pass of kind KIND at padded q . k width HDP (32, 64, 96, 128, 192):
// kDV writes dv, kDK dk, kDQ dq, kDKV dv and dk together (one consumer
// warpgroup each, sharing the once side and the rows operands: where it
// fits, HDP <= 96).  T rows of the streamed tile (queries for dv and dk,
// keys for dq; 16 where 32 would not fit shared memory), NB accumulators
// for the hi.hi products of the scores and of dP (the forward's rule), the
// transposed operands' widths W0 (and W1 for kDKV's dk), and the ring
// depths AS (the rows operands) and BS (the transposed ones), the deepest
// of (2, 2), (2, 1), (1, 1) that fits the 227 KB a block may use.  ALT:
// dq up to HDP 96 runs two consumer warpgroups on alternate tiles, each
// summing its own dq, added in a fixed order at the end
template <int HDP, int KIND>
struct Cfg {
  static constexpr int NV = HDP < 128 ? HDP : 128;     // hd_v padded
  static constexpr int QC = HDP / 32;
  static constexpr int VC = NV / 32;
  static constexpr int T = (HDP > 128 && KIND != kDV) ? 16 : 32;
  static constexpr int NB = HDP == 192 ? 3 : HDP == 96 ? 2 : 1;
  static constexpr bool ALT = KIND == kDQ && HDP <= 96;
  static constexpr int WGS = (KIND == kDKV || ALT) ? 2 : 1;  // consumers
  static constexpr int NR = KIND == kDKV ? 2 : 1;      // transposed rings
  static constexpr int W0 = (KIND == kDV || KIND == kDKV) ? NV : HDP;
  static constexpr int W1 = KIND == kDKV ? HDP : 0;
  static constexpr bool kDP = KIND != kDV;              // V / dout rows too
  // bytes: the once side (64 rows of the rows planes), a stage of the
  // rows operands (T rows) and of the transposed ones (W rows of T)
  static constexpr uint32_t kOnceChunk = 2 * 64 * 128;
  static constexpr uint32_t kOnce = (QC + (kDP ? VC : 0)) * kOnceChunk;
  static constexpr uint32_t kAChunk = 2 * T * 128;
  static constexpr uint32_t kA = (QC + (kDP ? VC : 0)) * kAChunk;
  static constexpr uint32_t kB0 = 2 * W0 * T * 4;
  static constexpr uint32_t kB = kB0 + 2 * W1 * T * 4;
  // kDKV: the dv warpgroup hands each tile's p (times 1 - tanh^2 under
  // softcap) to the dk warpgroup through two slots of T / 2 floats a
  // thread, so only the dv warpgroup computes S^T (seven products)
  static constexpr uint32_t kP = KIND == kDKV ? 2 * (T / 2) * 128 * 4 : 0;
  __host__ __device__ static constexpr uint32_t bytes(int as, int bs) {
    return kOnce + as * kA + bs * kB + 256 * as + kP +
           8 * (1 + 2 * as + 2 * NR * 2 * bs + 4) + 1024;
  }
  static constexpr int AS = bytes(2, 1) <= 232448 ? 2 : 1;
  static constexpr int BS = bytes(2, 2) <= 232448 ? 2 : 1;
  // barriers a transposed ring has: with ALT and one stage, each
  // warpgroup waits on a barrier of its own for the stage's every other
  // fill (a barrier whose phases one waiter skips would alias them)
  static constexpr int BB = ALT ? 2 * BS : BS;
  static_assert(bytes(AS, BS) <= 232448, "over the 227 KB a block may use");
  static_assert(!ALT || AS % 2 == 0, "each warpgroup a rows stage of its own");
  // one consumer warpgroup and a producer warp (160 threads) may use 255
  // registers a thread as they are; two consumer warpgroups take a
  // producer warpgroup, of which one warp loads: 384 threads hold ptxas to
  // 168 registers a thread, so the producers give all but kProducerRegs
  // back by setmaxnreg and the consumers take kConsumerRegs (128 x 40 +
  // 256 x 232 = 384 x 168; at 288 threads ptxas also held them to 168)
  static constexpr int kThreads = WGS == 2 ? 384 : 160;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
};

// shared-memory byte offsets from the 1024-aligned base: the once side (O1
// then O2, 32-column chunks of hi and lo planes of 64 rows), AS stages of
// the rows operands (S1 then S2, chunks of T rows), BS stages of the
// transposed operands (each its hi plane, W rows of T values, then its lo
// plane; kDKV's dk operand after its dv operand), AS lse2 / delta slots (T
// floats each), the barriers
template <int HDP, int KIND>
struct Layout {
  using C = Cfg<HDP, KIND>;
  static constexpr uint32_t kO2 = C::QC * C::kOnceChunk;
  static constexpr uint32_t kS2 = C::QC * C::kAChunk;
  __host__ __device__ static constexpr uint32_t a(int s) {
    return C::kOnce + C::kA * s;
  }
  __host__ __device__ static constexpr uint32_t b(int ring, int s) {
    return a(C::AS) + C::kB * s + (ring ? C::kB0 : 0);
  }
  __host__ __device__ static constexpr uint32_t lse(int s) {
    return a(C::AS) + C::kB * C::BS + 256 * s;
  }
  static constexpr uint32_t kPSlots = lse(C::AS);   // kDKV's p slots
  static constexpr uint32_t kBars = kPSlots + C::kP;
  static constexpr uint32_t kBytes = C::bytes(C::AS, C::BS);
};

struct Args {
  const float* lse2;    // (B * H, sq_pad): lse * log2(e)
  const float* delta;   // (B * H, sq_pad)
  float* dq;
  float* dk;
  float* dv;
  int n_heads, group, sq, skv, sq_pad, hd, hd_v;
  float scale, softcap;
  int causal;
};

// a block's place: batch b, kv head kvh, head h (dq), the once side's first
// row row0, and the sweep: n_iter tiles, from tile st0 of each of the
// group's heads (dv, dk) or from key 0 (dq)
struct Sweep {
  int b, kvh, h, row0, st0, per_head, n_iter;
  // the first row of tile t and its plane head (rows, lse2, delta)
  __device__ __forceinline__ void tile(int t, bool dq, int n_heads,
                                       int group, int n_kv, int T, int& t0,
                                       int& hs) const {
    if (dq) {
      t0 = t * T;
      hs = b * n_kv + kvh;
    } else {
      t0 = (st0 + t % per_head) * T;
      hs = b * n_heads + kvh * group + t / per_head;
    }
  }
};

// S (+)= A B over N = T columns, both from shared memory, K-major
template <int N>
__device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da,
                                   uint64_t db, int scale_d) {
  if constexpr (N == 32)
    hopper::wgmma_m64n32k8_tf32(d, da, db, scale_d);
  else
    hopper::wgmma_m64n16k8_tf32(d, da, db, scale_d);
}

// D (+)= A B over N columns, A (tf32 hi or lo) from registers, B K-major
template <int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t db, int scale_d) {
  if constexpr (N == 96)
    hopper::wgmma_m64n96k8_tf32_rs(d, a, db, scale_d);
  else if constexpr (N == 64)
    hopper::wgmma_m64n64k8_tf32_rs(d, a, db, scale_d);
  else
    hopper::wgmma_m64n32k8_tf32_rs(d, a, db, scale_d);
}

// the transposed operand's descriptor: rows of T values, 128-byte swizzle
// at T 32, 64-byte at T 16
template <int T>
__device__ __forceinline__ uint64_t desc_t(uint32_t addr) {
  if constexpr (T == 32)
    return desc_sw128(addr, 16, 1024);
  else
    return hopper::desc_sw64(addr, 512);
}

// X (=) A B^T over CH 32-wide chunks, 3xTF32: A the once side (64 rows at
// `oa`), B a stage's T rows (at `sb_`).  The lo.hi and hi.lo products go to
// `sm`, the hi.hi of chunk c to big[c NB / CH]; every accumulator starts
// at its first product (scale-d 0), so nothing spans more than this tile
template <int T, int NB, int CH>
__device__ __forceinline__ void scores(float (&sm)[T / 2],
                                       float (&big)[NB][T / 2], uint32_t oa,
                                       uint32_t sb_) {
  constexpr uint32_t kOP = 64 * 128, kOC = 2 * kOP;
  constexpr uint32_t kSP = T * 128, kSC = 2 * kSP;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t xa = oa + c * kOC + kk * 32;
      const uint32_t xb = sb_ + c * kSC + kk * 32;
      const bool starts =
          kk == 0 && (c == 0 || (c - 1) * NB / CH != c * NB / CH);
      ss<T>(sm, desc_sw128(xa + kOP, 16, 1024), desc_sw128(xb, 16, 1024),
            (c | kk) != 0);
      ss<T>(sm, desc_sw128(xa, 16, 1024), desc_sw128(xb + kSP, 16, 1024), 1);
      ss<T>(big[c * NB / CH], desc_sw128(xa, 16, 1024),
            desc_sw128(xb, 16, 1024), !starts);
    }
  }
}

// acc (64 rows x N, rows r0 + 8 (e / 2) of this thread) times `scale` into
// rows [.., n_rows) and columns [0, n) of a float32 matrix with row stride
// `row_stride`
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2],
                                           float* dst, int64_t row_stride,
                                           int r0, int n_rows, int n,
                                           float scale, int quad) {
  const bool pairs = (n % 2) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= n_rows) continue;
    float* row = dst + static_cast<int64_t>(r) * row_stride;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int col = 8 * i + 2 * quad;
      const float x0 = acc[4 * i + 2 * half] * scale;
      const float x1 = acc[4 * i + 2 * half + 1] * scale;
      if (pairs && col + 1 < n) {
        *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
      } else {
        if (col < n) row[col] = x0;
        if (col + 1 < n) row[col + 1] = x1;
      }
    }
  }
}

// The consumer warpgroup of role ROLE (kDV, kDK or kDQ) in a pass of kind
// KIND: for each tile of the sweep, the scores X = O1 S1^T over hd and,
// for dk and dq, Y = O2 S2^T over hd_v (S^T and dP^T for dv and dk, S and
// dP for dq; kDKV's dk warpgroup takes p from its dv warpgroup in place
// of S^T), then p or ds as the A fragment of the output product with the
// tile's transposed operand E (dout^T for dv, (Q scale)^T for dk, K^T for
// dq), added into float32 registers; written once at the end.  `warp` is
// the warp within the warpgroup.
template <int HDP, int KIND, int ROLE>
__device__ __forceinline__ void consume(const Args& a, const Sweep& w,
                                        uint8_t* base, uint64_t* full_once,
                                        uint64_t* full_a, uint64_t* empty_a,
                                        uint64_t* full_b, uint64_t* empty_b,
                                        uint64_t* full_p, uint64_t* empty_p,
                                        int wg, int warp, int lane) {
  using C = Cfg<HDP, KIND>;
  using L = Layout<HDP, KIND>;
  constexpr int T = C::T, NB = C::NB, QC = C::QC, VC = C::VC;
  constexpr int AS = C::AS, BS = C::BS;
  constexpr int RING = (KIND == kDKV && ROLE == kDK) ? 1 : 0;
  constexpr int W = RING ? C::W1 : C::W0;
  constexpr uint32_t kEPlane = W * T * 4;
  constexpr bool kDP = ROLE != kDV;
  constexpr bool kQ = ROLE == kDQ;
  // kDKV: the dv warpgroup computes S^T and hands p on; the dk warpgroup
  // takes it in place of S^T (kS false)
  constexpr bool kShare = KIND == kDKV;
  constexpr bool kS = !(kShare && ROLE == kDK);
  const int n_kv = a.n_heads / a.group;
  const int quad = lane % 4;
  const int r0 = w.row0 + 16 * warp + lane / 4;  // and r0 + 8
  const uint32_t sb = hopper::smem_u32(base);
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;  // dq: the rows' lse2, delta
  if constexpr (kQ) {
    const int64_t trow =
        static_cast<int64_t>(w.b * a.n_heads + w.h) * a.sq_pad;
    l0 = a.lse2[trow + r0];
    l1 = a.lse2[trow + r0 + 8];
    d0 = a.delta[trow + r0];
    d1 = a.delta[trow + r0 + 8];
  }

  // out is written by the CUDA cores only: each tile's product goes, NC
  // columns at a time (all W up to 96, else 64 with two accumulators
  // alternating), to a fresh accumulator part, then is added into out in
  // float32.  Only wgmma writes xs, xb, ys, yb and part between their
  // products (ptxas serializes wgmma otherwise, its C7515 warning)
  constexpr int NC = W <= 96 ? W : 64;
  constexpr int NCH = W / NC;
  constexpr int NP = NCH > 1 ? 2 : 1;
  float out[W / 2], part[NP][NC / 2];
  float xs[T / 2], xb[NB][T / 2], ys[T / 2], yb[NB][T / 2];
  uint32_t fh[T / 8][4], fl[T / 8][4];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) out[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i)
#pragma unroll
    for (int j = 0; j < NP; ++j) part[j][i] = 0.f;
#pragma unroll
  for (int i = 0; i < T / 2; ++i) {
    xs[i] = ys[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) xb[j][i] = yb[j][i] = 0.f;
  }

  hopper::mbar_wait(full_once, 0);
  for (int t = C::ALT ? wg : 0; t < w.n_iter; t += C::ALT ? 2 : 1) {
    const int as = t % AS;
    const int bs = t % BS;
    int t0, hs;
    w.tile(t, kQ, a.n_heads, a.group, n_kv, T, t0, hs);
    hopper::mbar_wait(&full_a[as], (t / AS) & 1);

    if constexpr (kS) {
      hopper::fence_regs(xs);
#pragma unroll
      for (int j = 0; j < NB; ++j) hopper::fence_regs(xb[j]);
    }
    if constexpr (kDP) {
      hopper::fence_regs(ys);
#pragma unroll
      for (int j = 0; j < NB; ++j) hopper::fence_regs(yb[j]);
    }
    hopper::wgmma_fence();
    if constexpr (kS) scores<T, NB, QC>(xs, xb, sb, sb + L::a(as));
    if constexpr (kDP)
      scores<T, NB, VC>(ys, yb, sb + L::kO2, sb + L::a(as) + L::kS2);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    if constexpr (kS) {
      hopper::fence_regs(xs);
#pragma unroll
      for (int j = 0; j < NB; ++j) hopper::fence_regs(xb[j]);
    }
    if constexpr (kDP) {
      hopper::fence_regs(ys);
#pragma unroll
      for (int j = 0; j < NB; ++j) hopper::fence_regs(yb[j]);
    }
    // this thread's columns' lse2 and delta (dv, dk), then the stage goes
    // back to the producer
    float2 lc[T / 8], dc[T / 8];
    if constexpr (!kQ) {
      const float* lse_s = reinterpret_cast<const float*>(base + L::lse(as));
#pragma unroll
      for (int i = 0; i < T / 8; ++i) {
        lc[i] = *reinterpret_cast<const float2*>(lse_s + 8 * i + 2 * quad);
        if constexpr (kDP)
          dc[i] = *reinterpret_cast<const float2*>(lse_s + 32 + 8 * i +
                                                   2 * quad);
      }
    }
    if (lane == 0) hopper::mbar_arrive(&empty_a[as]);

    // the hi.hi sums added to the small products' in float32
    float sx[T / 2], sy[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      float x = xb[0][i];
#pragma unroll
      for (int j = 1; j < NB; ++j) x += xb[j][i];
      sx[i] = kS ? xs[i] + x : 0.f;
      if constexpr (kDP) {
        float y = yb[0][i];
#pragma unroll
        for (int j = 1; j < NB; ++j) y += yb[j][i];
        sy[i] = ys[i] + y;
      } else {
        sy[i] = 0.f;
      }
    }

    // p = exp(s - lse) and, for dk and dq, ds = p (dp - delta) [(1 - t^2)]
    // (0 where masked), split into hi and lo as the A fragment of the
    // output product's k8 steps: sx[4i + e] is row r0 + 8 (e / 2), column
    // t0 + 8 i + 2 quad + e % 2, and the transposed operand holds that
    // column's 8 in the order (0, 2, 4, 6, 1, 3, 5, 7), so a thread's
    // columns 2 quad and 2 quad + 1 are the fragment's quad and quad + 4
    const bool masked =
        kQ ? (t0 + T > a.skv || (a.causal && t0 + T - 1 > w.row0))
           : (t0 + T > a.sq || w.row0 + 64 > a.skv ||
              (a.causal && w.row0 + 63 > t0));
    // kDKV's p slot of this tile: g = p [(1 - t^2)], this thread's T / 2
    // values 128 floats apart
    float* slot = reinterpret_cast<float*>(base + L::kPSlots) +
                  (t % 2) * (T / 2) * 128 + 32 * warp + lane;
    if constexpr (kShare) {
      if constexpr (kS) {
        if (t >= 2) hopper::mbar_wait(&empty_p[t % 2], ((t / 2) - 1) & 1);
      } else {
        hopper::mbar_wait(&full_p[t % 2], (t / 2) & 1);
      }
    }
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (!kS) {   // ds = g (dp - delta), g 0 where masked
          const float dl = (e & 1) ? dc[i].y : dc[i].x;
          f[e] = slot[(4 * i + e) * 128] * (sy[4 * i + e] - dl);
          continue;
        }
        const int row = r0 + 8 * (e >> 1);
        const int col = t0 + 8 * i + 2 * quad + (e & 1);
        const int qi = kQ ? row : col;
        const int kj = kQ ? col : row;
        const bool keep = !masked || (qi < a.sq && kj < a.skv &&
                                      (!a.causal || kj <= qi));
        float lse2, dl = 0.f;
        if constexpr (kQ) {
          lse2 = (e >> 1) ? l1 : l0;
          dl = (e >> 1) ? d1 : d0;
        } else {
          lse2 = (e & 1) ? lc[i].y : lc[i].x;
          if constexpr (kDP) dl = (e & 1) ? dc[i].y : dc[i].x;
        }
        const float s = sx[4 * i + e];
        float x, th = 0.f;
        if (a.softcap > 0.f) {
          th = tanhf(s / a.softcap);
          x = a.softcap * th * kLog2e;
        } else {
          x = s * kLog2e;
        }
        const float p = ex2(x - lse2);
        float v = p;
        if constexpr (kDP) {
          v = p * (sy[4 * i + e] - dl);
          if (a.softcap > 0.f) v *= 1.f - th * th;
        }
        if constexpr (kShare)
          slot[(4 * i + e) * 128] =
              keep ? (a.softcap > 0.f ? p * (1.f - th * th) : p) : 0.f;
        f[e] = keep ? v : 0.f;
      }
      const float fr[4] = {f[0], f[2], f[1], f[3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hi = tf32_round(fr[e]);
        fh[i][e] = __float_as_uint(hi);
        fl[i][e] = __float_as_uint(tf32_round(fr[e] - hi));
      }
    }
    if constexpr (kShare)
      hopper::mbar_arrive(kS ? &full_p[t % 2] : &empty_p[t % 2]);

    // out += F E over the tile's T rows, NC output columns a product:
    // lo.hi, hi.lo, hi.hi per k8 step into part[c % NP], the next chunk
    // issued before the last one is added
    constexpr int BB = C::BB;
    hopper::mbar_wait(&full_b[RING * BB + t % BB], (t / BB) & 1);
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      hopper::fence_regs(fh[i]);
      hopper::fence_regs(fl[i]);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      hopper::fence_regs(part[c % NP]);
      hopper::wgmma_fence();
#pragma unroll
      for (int i = 0; i < T / 8; ++i) {
        const uint32_t eb = sb + L::b(RING, bs) + c * NC * (T * 4) + i * 32;
        rs<NC>(part[c % NP], fl[i], desc_t<T>(eb), i != 0);
        rs<NC>(part[c % NP], fh[i], desc_t<T>(eb + kEPlane), 1);
        rs<NC>(part[c % NP], fh[i], desc_t<T>(eb), 1);
      }
      hopper::wgmma_commit();
      if (c > 0) {
        hopper::wgmma_wait<1>();
        hopper::fence_regs(part[(c - 1) % NP]);
#pragma unroll
        for (int j = 0; j < NC / 2; ++j)
          out[NC / 2 * (c - 1) + j] += part[(c - 1) % NP][j];
      }
    }
    hopper::wgmma_wait_all();
    hopper::fence_regs(part[(NCH - 1) % NP]);
#pragma unroll
    for (int j = 0; j < NC / 2; ++j)
      out[NC / 2 * (NCH - 1) + j] += part[(NCH - 1) % NP][j];
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      hopper::fence_regs(fh[i]);
      hopper::fence_regs(fl[i]);
    }
    if (lane == 0) hopper::mbar_arrive(&empty_b[RING * C::BB + t % C::BB]);
  }

  if constexpr (C::ALT) {
    // the second warpgroup's dq into the first's, through the rows stages
    // (every tile consumed once both warpgroups are here)
    float* xch = reinterpret_cast<float*>(base + L::a(0)) +
                 (32 * warp + lane) * (W / 2);
    named_barrier_sync(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) xch[i] = out[i];
    }
    named_barrier_sync(1, 256);
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < W / 2; ++i) out[i] += xch[i];
  }
  if constexpr (kQ) {
    float* dst = a.dq + (static_cast<int64_t>(w.b) * a.sq * a.n_heads +
                         w.h) * a.hd;
    store_rows<W>(out, dst, static_cast<int64_t>(a.n_heads) * a.hd, r0,
                  a.sq, a.hd, a.scale, quad);
  } else {
    const int n = ROLE == kDV ? a.hd_v : a.hd;
    float* dst = (ROLE == kDV ? a.dv : a.dk) +
                 (static_cast<int64_t>(w.b) * a.skv * n_kv + w.kvh) * n;
    store_rows<W>(out, dst, static_cast<int64_t>(n_kv) * n, r0, a.skv, n,
                  1.f, quad);
  }
}

// One pass of the float32 backward (the source note): kDV writes dv, kDK
// dk, kDKV both (one block per 64 keys of a kv head, sweeping the G query
// heads' tiles of T queries), kDQ dq (one block per 64 queries of a head,
// sweeping the kv head's tiles of T keys).  Maps: o1, o2 the once side's
// rows planes (K, V; dq: Q scale, dout), s1, s2 the stream's (Q scale,
// dout; dq: K, V), e0 its transposed plane (dout^T for dv and kDKV,
// (Q scale)^T for dk, K^T for dq), e1 kDKV's (Q scale)^T.  kDV reads no
// o2 and no s2, and only kDKV reads e1.
template <int HDP, int KIND>
__global__ void __launch_bounds__(Cfg<HDP, KIND>::kThreads, 1)
flash_bwd_3xtf32_kernel(const __grid_constant__ CUtensorMap o1_map,
                        const __grid_constant__ CUtensorMap o2_map,
                        const __grid_constant__ CUtensorMap s1_map,
                        const __grid_constant__ CUtensorMap s2_map,
                        const __grid_constant__ CUtensorMap e0_map,
                        const __grid_constant__ CUtensorMap e1_map,
                        const __grid_constant__ Args a) {
  using C = Cfg<HDP, KIND>;
  using L = Layout<HDP, KIND>;
  constexpr int T = C::T, QC = C::QC, VC = C::VC;
  constexpr int AS = C::AS, BS = C::BS, WGS = C::WGS;
  constexpr bool kQ = KIND == kDQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_once = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full_a = full_once + 1;
  uint64_t* empty_a = full_a + AS;
  uint64_t* full_b = empty_a + AS;           // [NR][BB]
  uint64_t* empty_b = full_b + C::NR * C::BB;
  uint64_t* full_p = empty_b + C::NR * C::BB;   // kDKV's p slots [2]
  uint64_t* empty_p = full_p + 2;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_kv = a.n_heads / a.group;
  Sweep w;
  w.h = 0;
  w.st0 = 0;
  w.per_head = 1;
  if constexpr (kQ) {
    w.b = blockIdx.x / a.n_heads;
    w.h = blockIdx.x % a.n_heads;
    w.kvh = w.h / a.group;
    w.row0 = (gridDim.y - 1 - blockIdx.y) * 64;  // last tiles first
    const int kv_end = a.causal ? min(a.skv, w.row0 + 64) : a.skv;
    w.n_iter = (kv_end + T - 1) / T;
  } else {
    w.b = blockIdx.x / n_kv;
    w.kvh = blockIdx.x % n_kv;
    w.row0 = blockIdx.y * 64;                     // causal: longest first
    const int n_st = (a.sq + T - 1) / T;
    w.st0 = a.causal ? min(w.row0 / T, n_st) : 0;
    w.per_head = n_st - w.st0;
    w.n_iter = a.group * w.per_head;
  }

  if (tid == 0) {
    hopper::mbar_init(full_once, 1);
    for (int s = 0; s < AS; ++s) {
      hopper::mbar_init(&full_a[s], 1);
      hopper::mbar_init(&empty_a[s], KIND == kDKV ? 8 : 4);
    }
    for (int s = 0; s < C::NR * C::BB; ++s) {
      hopper::mbar_init(&full_b[s], 1);
      hopper::mbar_init(&empty_b[s], 4);
    }
    for (int s = 0; s < 2; ++s) {         // every consumer thread arrives
      hopper::mbar_init(&full_p[s], 128);
      hopper::mbar_init(&empty_p[s], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * WGS) {
    // ---- the producer: the once side, then each tile's rows operands
    // (and lse2, delta) and its transposed operands, by TMA
    if constexpr (WGS == 2) hopper::setmaxnreg_dec<C::kProducerRegs>();
    if (warp != 4 * WGS || lane != 0) return;
    hopper::mbar_arrive_expect_tx(full_once, C::kOnce);
    for (int c = 0; c < QC; ++c)
      hopper::tma_load_4d(base + c * C::kOnceChunk, &o1_map, full_once,
                          32 * c, w.row0, 0, blockIdx.x);
    if constexpr (C::kDP)
      for (int c = 0; c < VC; ++c)
        hopper::tma_load_4d(base + L::kO2 + c * C::kOnceChunk, &o2_map,
                            full_once, 32 * c, w.row0, 0, blockIdx.x);
    for (int t = 0; t < w.n_iter; ++t) {
      int t0, hs;
      w.tile(t, kQ, a.n_heads, a.group, n_kv, T, t0, hs);
      const int as = t % AS;
      if (t >= AS) hopper::mbar_wait(&empty_a[as], ((t / AS) - 1) & 1);
      hopper::mbar_arrive_expect_tx(
          &full_a[as], C::kA + (kQ ? 0 : (C::kDP ? 8 : 4) * T));
      for (int c = 0; c < QC; ++c)
        hopper::tma_load_4d(base + L::a(as) + c * C::kAChunk, &s1_map,
                            &full_a[as], 32 * c, t0, 0, hs);
      if constexpr (C::kDP)
        for (int c = 0; c < VC; ++c)
          hopper::tma_load_4d(base + L::a(as) + L::kS2 + c * C::kAChunk,
                              &s2_map, &full_a[as], 32 * c, t0, 0, hs);
      if constexpr (!kQ) {
        const int64_t row = static_cast<int64_t>(hs) * a.sq_pad + t0;
        hopper::bulk_load(base + L::lse(as), a.lse2 + row, 4 * T,
                          &full_a[as]);
        if constexpr (C::kDP)
          hopper::bulk_load(base + L::lse(as) + 128, a.delta + row, 4 * T,
                            &full_a[as]);
      }
      const int bs = t % BS;
      constexpr int BB = C::BB;
      for (int ring = 0; ring < C::NR; ++ring) {
        uint64_t* full = &full_b[ring * BB + t % BB];
        if (t >= BS)   // the stage's last tile, t - BS, is consumed
          hopper::mbar_wait(&empty_b[ring * BB + (t - BS) % BB],
                            ((t - BS) / BB) & 1);
        hopper::mbar_arrive_expect_tx(full, ring ? C::kB - C::kB0 : C::kB0);
        hopper::tma_load_4d(base + L::b(ring, bs), ring ? &e1_map : &e0_map,
                            full, t0, 0, 0, hs);
      }
    }
    return;
  }

  if constexpr (WGS == 2) hopper::setmaxnreg_inc<C::kConsumerRegs>();
  if constexpr (KIND == kDKV) {
    if (warp < 4)
      consume<HDP, KIND, kDV>(a, w, base, full_once, full_a, empty_a, full_b,
                              empty_b, full_p, empty_p, 0, warp, lane);
    else
      consume<HDP, KIND, kDK>(a, w, base, full_once, full_a, empty_a, full_b,
                              empty_b, full_p, empty_p, 1, warp - 4, lane);
  } else {
    consume<HDP, KIND, KIND>(a, w, base, full_once, full_a, empty_a, full_b,
                             empty_b, full_p, empty_p, warp / 4, warp % 4,
                             lane);
  }
}

// ---- the pre-pass: TF32 hi and lo planes ------------------------------

// (B, S, heads, width) -> planes (B * heads, 2, s_pad, wp): hi = tf32(x *
// scale) and lo = tf32(x * scale - hi), zero past S and width; one thread
// per 4 elements of the padded hi plane (wp is a multiple of 32), written
// as one 16-byte store a plane
__global__ void __launch_bounds__(256)
split_rows_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  int s, int heads, int width, int s_pad, int wp, int64_t sb,
                  int64_t ss_, int64_t sh, float scale, int64_t total4) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total4) return;
  const int c = static_cast<int>(e % (wp / 4)) * 4;
  const int64_t rest = e / (wp / 4);
  const int r = static_cast<int>(rest % s_pad);
  const int64_t bh = rest / s_pad;
  const int64_t b = bh / heads;
  const int h = static_cast<int>(bh % heads);
  const float* row = src + b * sb + r * ss_ + h * sh;
  float x[4], hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = (r < s && c + i < width) ? row[c + i] * scale : 0.f;
    hi[i] = tf32_round(x[i]);
    lo[i] = tf32_round(x[i] - hi[i]);
  }
  const int64_t plane = static_cast<int64_t>(s_pad) * wp;
  float* d = dst + bh * 2 * plane + static_cast<int64_t>(r) * wp + c;
  *reinterpret_cast<float4*>(d) = make_float4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<float4*>(d + plane) =
      make_float4(lo[0], lo[1], lo[2], lo[3]);
}

// (B, S, heads, width) -> transposed planes (B * heads, 2, wp, s_pad) of x
// * scale: the sequence contiguous and, within every group of 8, in the
// order (0, 2, 4, 6, 1, 3, 5, 7), which makes an accumulator the A
// fragment of the product that reduces over the sequence (the kernel's
// note); zero past S and width.  One block per 32 positions x 32 columns,
// transposed through shared memory (flash_attention.cu's split_vt_kernel)
__global__ void __launch_bounds__(256)
split_t_kernel(const float* __restrict__ src, float* __restrict__ dst, int s,
               int heads, int width, int s_pad, int wp, int64_t sb,
               int64_t ss_, int64_t sh, float scale) {
  __shared__ float t[32][33];
  const int j0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  const int64_t bh = blockIdx.z;
  const int64_t b = bh / heads;
  const int h = static_cast<int>(bh % heads);
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int j = j0 + r;
    const int c = c0 + threadIdx.x;
    t[r][threadIdx.x] =
        (j < s && c < width) ? src[b * sb + j * ss_ + h * sh + c] * scale
                             : 0.f;
  }
  __syncthreads();
  const int x = threadIdx.x;
  const int pos = (x & ~7) + ((x & 7) < 4 ? 2 * (x & 7) : 2 * (x & 7) - 7);
  const int64_t plane = static_cast<int64_t>(wp) * s_pad;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const float val = t[pos][r];
    const float hi = tf32_round(val);
    float* d = dst + bh * 2 * plane + static_cast<int64_t>(c0 + r) * s_pad +
               j0 + x;
    d[0] = hi;
    d[plane] = tf32_round(val - hi);
  }
}

// the scratch's extents {sq_pad, skv_pad, hdp, nv} and its float offsets
// {lse2, delta, Q rows, dout rows, K rows, V rows, Q^T, dout^T, K^T, end}
struct Extents {
  int64_t sq_pad, skv_pad, hdp, nv;
  int64_t off[10];
};

inline Extents extents(int batch, int sq, int skv, int n_heads, int n_kv,
                       int hd) {
  auto up = [](int64_t x, int64_t t) { return (x + t - 1) / t * t; };
  Extents e;
  e.sq_pad = up(sq, kPad);
  e.skv_pad = up(skv, kPad);
  e.hdp = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 96 ? 96 : hd <= 128 ? 128
                                                                    : 192;
  e.nv = e.hdp < 128 ? e.hdp : 128;
  const int64_t bh = static_cast<int64_t>(batch) * n_heads;
  const int64_t bk = static_cast<int64_t>(batch) * n_kv;
  const int64_t size[9] = {bh * e.sq_pad,
                           bh * e.sq_pad,
                           2 * bh * e.sq_pad * e.hdp,
                           2 * bh * e.sq_pad * e.nv,
                           2 * bk * e.skv_pad * e.hdp,
                           2 * bk * e.skv_pad * e.nv,
                           2 * bh * e.hdp * e.sq_pad,
                           2 * bh * e.nv * e.sq_pad,
                           2 * bk * e.hdp * e.skv_pad};
  e.off[0] = 0;
  for (int i = 0; i < 9; ++i) e.off[i + 1] = e.off[i] + size[i];
  return e;
}

// the pre-pass: lse2 and delta, then the seven planes
int split(const float* q, const float* k, const float* v, const float* out,
          const float* dout, const float* lse, float* scratch, int batch,
          int sq, int skv, int n_heads, int n_kv, int hd, int hd_v,
          const int64_t* st, float scale, cudaStream_t s) {
  const Extents e = extents(batch, sq, skv, n_heads, n_kv, hd);
  float* p[9];
  for (int i = 0; i < 9; ++i) p[i] = scratch + e.off[i];
  const int64_t rows = static_cast<int64_t>(batch) * n_heads * e.sq_pad;
  bwd_delta_t_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      out, dout, lse, p[0], p[1], rows, sq, static_cast<int>(e.sq_pad),
      n_heads, hd_v, st[9], st[10], st[11]);
  // rows planes: Q * scale, dout, K, V
  struct Rows {
    const float* src; float* dst; int s, heads, width, s_pad, wp;
    const int64_t* st; float scale;
  };
  const int sqp = static_cast<int>(e.sq_pad), skp = static_cast<int>(e.skv_pad);
  const int hdp = static_cast<int>(e.hdp), nv = static_cast<int>(e.nv);
  const Rows rows_planes[4] = {{q, p[2], sq, n_heads, hd, sqp, hdp, st, scale},
                               {dout, p[3], sq, n_heads, hd_v, sqp, nv,
                                st + 9, 1.f},
                               {k, p[4], skv, n_kv, hd, skp, hdp, st + 3, 1.f},
                               {v, p[5], skv, n_kv, hd_v, skp, nv, st + 6,
                                1.f}};
  for (const Rows& r : rows_planes) {
    const int64_t total4 = static_cast<int64_t>(batch) * r.heads * r.s_pad *
                           r.wp / 4;
    split_rows_kernel<<<static_cast<unsigned>((total4 + 255) / 256), 256, 0,
                        s>>>(r.src, r.dst, r.s, r.heads, r.width, r.s_pad,
                             r.wp, r.st[0], r.st[1], r.st[2], r.scale,
                             total4);
  }
  // transposed planes: (Q * scale)^T, dout^T, K^T
  const Rows t_planes[3] = {{q, p[6], sq, n_heads, hd, sqp, hdp, st, scale},
                            {dout, p[7], sq, n_heads, hd_v, sqp, nv, st + 9,
                             1.f},
                            {k, p[8], skv, n_kv, hd, skp, hdp, st + 3, 1.f}};
  for (const Rows& r : t_planes)
    split_t_kernel<<<dim3(static_cast<unsigned>(r.s_pad / 32),
                          static_cast<unsigned>(r.wp / 32),
                          static_cast<unsigned>(batch * r.heads)),
                     dim3(32, 8), 0, s>>>(r.src, r.dst, r.s, r.heads,
                                          r.width, r.s_pad, r.wp, r.st[0],
                                          r.st[1], r.st[2], r.scale);
  return static_cast<int>(cudaGetLastError());
}

// 4-d map (inner, rows, 2 planes, heads) over float32 planes, boxes of
// box_inner x box_rows x both planes, 128-byte swizzle (64-byte where the
// box is 16 floats wide)
inline int make_plane_map(CUtensorMap* map, const float* planes,
                          int64_t inner, int64_t rows, int64_t heads,
                          int box_inner, int box_rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(inner),
                            static_cast<uint64_t>(rows), 2,
                            static_cast<uint64_t>(heads)};
  const uint64_t strides[3] = {static_cast<uint64_t>(inner) * 4,
                               static_cast<uint64_t>(inner * rows) * 4,
                               static_cast<uint64_t>(inner * rows) * 8};
  const uint32_t box[4] = {static_cast<uint32_t>(box_inner),
                           static_cast<uint32_t>(box_rows), 2, 1};
  return hopper_host::make_map(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, planes, dims, strides, box,
      box_inner == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HDP, int KIND>
int run_pass(const CUtensorMap* m, const Args& a, int grid_x, int grid_y,
             cudaStream_t stream) {
  const size_t smem = Layout<HDP, KIND>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_3xtf32_kernel<HDP, KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_3xtf32_kernel<HDP, KIND>
      <<<dim3(grid_x, grid_y), Cfg<HDP, KIND>::kThreads, smem, stream>>>(
          m[0], m[1], m[2], m[3], m[4], m[5], a);
  return static_cast<int>(cudaGetLastError());
}

// the passes over the planes of `scratch`: dv and dk in one (kDKV) up to
// HDP 96, where its shared memory fits, else apart; then dq
template <int HDP>
int launch_passes(const float* scratch, const Extents& e, const Args& a,
                  int batch, cudaStream_t stream) {
  constexpr bool kFused = HDP <= 96;
  const int64_t bh = static_cast<int64_t>(batch) * a.n_heads;
  const int64_t bk = static_cast<int64_t>(batch) * (a.n_heads / a.group);
  const float* qr = scratch + e.off[2];
  const float* dr = scratch + e.off[3];
  const float* kr = scratch + e.off[4];
  const float* vr = scratch + e.off[5];
  const float* qt = scratch + e.off[6];
  const float* dt = scratch + e.off[7];
  const float* kt = scratch + e.off[8];
  constexpr int NV = HDP < 128 ? HDP : 128;
  constexpr int TK = Cfg<HDP, kDK>::T, TQ = Cfg<HDP, kDQ>::T;
  constexpr int TV = Cfg<HDP, kDV>::T;
  // {o1, o2, s1, s2, e0, e1} of each kind's pass
  CUtensorMap m[4][6];
  memset(m, 0, sizeof(m));
  int err = 0;
  auto rows_map = [&](CUtensorMap* map, const float* p, int width,
                      int64_t s_pad, int64_t heads, int box_rows) {
    if (!err) err = make_plane_map(map, p, width, s_pad, heads, 32, box_rows);
  };
  auto t_map = [&](CUtensorMap* map, const float* p, int width,
                   int64_t s_pad, int64_t heads, int box_inner) {
    if (!err)
      err = make_plane_map(map, p, s_pad, width, heads, box_inner, width);
  };
  if constexpr (kFused) {
    rows_map(&m[kDKV][0], kr, HDP, e.skv_pad, bk, 64);
    rows_map(&m[kDKV][1], vr, NV, e.skv_pad, bk, 64);
    rows_map(&m[kDKV][2], qr, HDP, e.sq_pad, bh, TK);
    rows_map(&m[kDKV][3], dr, NV, e.sq_pad, bh, TK);
    t_map(&m[kDKV][4], dt, NV, e.sq_pad, bh, TK);
    t_map(&m[kDKV][5], qt, HDP, e.sq_pad, bh, TK);
  } else {
    rows_map(&m[kDV][0], kr, HDP, e.skv_pad, bk, 64);
    rows_map(&m[kDV][2], qr, HDP, e.sq_pad, bh, TV);
    t_map(&m[kDV][4], dt, NV, e.sq_pad, bh, TV);
    rows_map(&m[kDK][0], kr, HDP, e.skv_pad, bk, 64);
    rows_map(&m[kDK][1], vr, NV, e.skv_pad, bk, 64);
    rows_map(&m[kDK][2], qr, HDP, e.sq_pad, bh, TK);
    rows_map(&m[kDK][3], dr, NV, e.sq_pad, bh, TK);
    t_map(&m[kDK][4], qt, HDP, e.sq_pad, bh, TK);
  }
  rows_map(&m[kDQ][0], qr, HDP, e.sq_pad, bh, 64);
  rows_map(&m[kDQ][1], dr, NV, e.sq_pad, bh, 64);
  rows_map(&m[kDQ][2], kr, HDP, e.skv_pad, bk, TQ);
  rows_map(&m[kDQ][3], vr, NV, e.skv_pad, bk, TQ);
  t_map(&m[kDQ][4], kt, HDP, e.skv_pad, bk, TQ);
  if (err) return err;
  const int kv_tiles = static_cast<int>(e.skv_pad / 64);
  const int q_tiles = static_cast<int>(e.sq_pad / 64);
  if constexpr (kFused) {
    err = run_pass<HDP, kDKV>(m[kDKV], a, static_cast<int>(bk), kv_tiles,
                              stream);
  } else {
    err = run_pass<HDP, kDV>(m[kDV], a, static_cast<int>(bk), kv_tiles,
                             stream);
    if (!err)
      err = run_pass<HDP, kDK>(m[kDK], a, static_cast<int>(bk), kv_tiles,
                               stream);
  }
  if (!err)
    err = run_pass<HDP, kDQ>(m[kDQ], a, static_cast<int>(bh), q_tiles,
                             stream);
  return err;
}

int launch(const float* q, const float* k, const float* v, const float* out,
           const float* dout, const float* lse, float* scratch, float* dq,
           float* dk, float* dv, int batch, int sq, int skv, int n_heads,
           int group, int hd, int hd_v, const int64_t* strides, float scale,
           float softcap, int causal, cudaStream_t s) {
  const int n_kv = n_heads / group;
  int err = split(q, k, v, out, dout, lse, scratch, batch, sq, skv, n_heads,
                  n_kv, hd, hd_v, strides, scale, s);
  if (err) return err;
  const Extents e = extents(batch, sq, skv, n_heads, n_kv, hd);
  Args a;
  a.lse2 = scratch + e.off[0];
  a.delta = scratch + e.off[1];
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.n_heads = n_heads;
  a.group = group;
  a.sq = sq;
  a.skv = skv;
  a.sq_pad = static_cast<int>(e.sq_pad);
  a.hd = hd;
  a.hd_v = hd_v;
  a.scale = scale;
  a.softcap = softcap;
  a.causal = causal;
  switch (e.hdp) {
    case 32: return launch_passes<32>(scratch, e, a, batch, s);
    case 64: return launch_passes<64>(scratch, e, a, batch, s);
    case 96: return launch_passes<96>(scratch, e, a, batch, s);
    case 128: return launch_passes<128>(scratch, e, a, batch, s);
    default: return launch_passes<192>(scratch, e, a, batch, s);
  }
}

}  // namespace f32


bool valid_shape(int batch, int sq, int skv, int n_heads, int n_kv_heads,
                 int hd, int hd_v, int dtype) {
  return batch > 0 && sq > 0 && skv > 0 && n_kv_heads > 0 &&
         n_heads % n_kv_heads == 0 && hd > 0 && hd <= 192 && hd_v > 0 &&
         hd_v <= hd && hd_v <= 128 && (dtype == 0 || dtype == 1) &&
         static_cast<int64_t>(batch) * n_heads <= 65535 &&
         (sq + tc::kBQ - 1) / tc::kBQ <= 65535 &&
         (skv + tc::kBKV - 1) / tc::kBKV <= 65535;
}

}  // namespace

// The scratch a launch needs, in float32 values, into e[0]; for float32
// also the planes' extents e[1..4] = {Sq_pad, Skv_pad, hd_pad, hdv_pad}.
// bfloat16: lse * log2 e and delta, 2 x (B * H, Sq_pad 128).  float32:
// lse * log2 e and delta (B * H, Sq_pad) each, then the TF32 hi and lo
// planes (B * heads, 2, rows, width) of Q * scale, dout (Sq_pad x
// hd_pad, hdv_pad), K, V (Skv_pad x hd_pad, hdv_pad), and the transposed
// (Q * scale)^T, dout^T (hd_pad, hdv_pad x Sq_pad) and K^T (hd_pad x
// Skv_pad), in that order.  Returns cudaErrorInvalidValue for a shape the
// launch refuses.
extern "C" int flash_attention_bwd_scratch(int batch, int sq, int skv,
                                           int n_heads, int n_kv_heads,
                                           int hd, int hd_v, int dtype,
                                           int64_t* e) {
  if (!valid_shape(batch, sq, skv, n_heads, n_kv_heads, hd, hd_v, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    const int64_t sq_pad = (sq + tc::kPadRows - 1) / tc::kPadRows *
                           tc::kPadRows;
    e[0] = 2 * static_cast<int64_t>(batch) * n_heads * sq_pad;
    e[1] = sq_pad;
    e[2] = e[3] = e[4] = 0;
    return 0;
  }
  const f32::Extents x = f32::extents(batch, sq, skv, n_heads, n_kv_heads,
                                      hd);
  e[0] = x.off[9];
  e[1] = x.sq_pad;
  e[2] = x.skv_pad;
  e[3] = x.hdp;
  e[4] = x.nv;
  return 0;
}

// The float32 pre-pass alone into `scratch` (flash_attention_bwd_scratch's
// layout): the launch runs it first; this entry lets a caller hold the
// planes against their plain version.
extern "C" int flash_attention_bwd_split(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* scratch, int batch, int sq,
    int skv, int n_heads, int n_kv_heads, int hd, int hd_v,
    const int64_t* strides, float scale, void* stream) {
  cudaGetLastError();
  if (!valid_shape(batch, sq, skv, n_heads, n_kv_heads, hd, hd_v, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return f32::split(static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(out),
                    static_cast<const float*>(dout), lse, scratch, batch, sq,
                    skv, n_heads, n_kv_heads, hd, hd_v, strides, scale,
                    static_cast<cudaStream_t>(stream));
}

// strides: the (batch, sequence, head) strides of q, k, v and dout in
// elements, in that order (12 values).  dtype: 0 = float32 (the 3xTF32
// route; load_bytes must be 0), 1 = bfloat16 (the bf16 route; load_bytes
// 16 loads the tiles by TMA, every base address and stride 16-byte
// aligned, and 8, 4 or 2 by plain loads of that many bytes, which must
// divide every base address, stride, hd and hd_v).  scratch:
// flash_attention_bwd_scratch's size and layout.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, int batch, int sq, int skv, int n_heads, int n_kv_heads,
    int hd, int hd_v, const int64_t* strides, float scale, float softcap,
    int causal, int dtype, int load_bytes, void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (!valid_shape(batch, sq, skv, n_heads, n_kv_heads, hd, hd_v, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = n_heads / n_kv_heads;
  if (dtype == 0) {
    if (load_bytes != 0) return static_cast<int>(cudaErrorInvalidValue);
    return f32::launch(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(out),
        static_cast<const float*>(dout), lse, scratch,
        static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), batch, sq, skv, n_heads, group, hd, hd_v,
        strides, scale, softcap, causal, s);
  }
  if (load_bytes != 16 && load_bytes != 8 && load_bytes != 4 &&
      load_bytes != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch(q, k, v, out, dout, lse, scratch, dq, dk, dv, batch, sq,
                    skv, n_heads, group, hd, hd_v, strides, scale, softcap,
                    causal, load_bytes, s);
}
