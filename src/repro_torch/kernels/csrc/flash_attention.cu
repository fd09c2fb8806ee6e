// flash_attention: causal or full GQA attention forward with an online
// softmax.
//
//   q, k (B, Sq, H, hd), (B, Skv, KV, hd)  float32 or bfloat16, unit
//                         stride along hd; H = KV * G and query head h
//                         reads kv head h / G
//   v    (B, Skv, KV, hd_v)  q's dtype, unit stride along hd_v
//   out  (B, Sq, H, hd_v) contiguous, in q's dtype
//   hd <= 192 and hd_v <= min(hd, 128): hd_v < hd is DeepSeek-V2's MLA,
//   whose q . k spans nope + rope = 192 and whose values are 128 wide
//
//   key j of query i is masked when j >= Skv or, causal, j > i; both
//   positions start at 0, also when Sq != Skv
//   out = acc / max(l, 1e-30) from the running (m, l, acc) in float32;
//   optionally lse = m + log(max(l, 1e-30)) per row, natural log, for the
//   backward (the reference's `_flash_fwd_core` residual)
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`).  As there,
// the (Sq, Skv) scores never reach device memory: the row state and the
// output tile stay on chip across the sweep over kv tiles.  The TPU
// wrapper broadcast k and v G times and padded hd to 128 in HBM; here a
// block of query head h reads kv head h / G in place, through the
// tensors' own (batch, sequence, head) strides, and pads hd with zeros in
// shared memory only.  Blocks run in no order, so each walks its own kv
// tiles in a loop with the row state in registers; causal blocks stop at
// the diagonal tile, and the grid hands out the longest (last) query tiles
// first.
//
// Two kernels, chosen by dtype (not a fallback: each serves its dtype):
//
// bfloat16 -> `flash_fwd_wgmma_kernel`, on Hopper's tensor cores.
//   Bound on the H100: operations.  At qwen2-7b prefill (B = 1, S = 4096,
//   H = 28, KV = 4, hd = 128, causal) the two products are
//   4 * H * hd * S (S + 1) / 2 ~ 120 GFLOP against ~67 MB of q, k, v and
//   out, ~0.12 ms at the 989 TFLOP/s bf16 tensor-core rate.  K and V of one
//   layer (8 MB) sit in L2, so bytes are no limit.
//   Design, one block per (query tile of 128 rows, batch * head):
//    * two consumer warpgroups of 64 query rows each, and one producer
//      warp.  The producer loads Q once and streams K and V tiles of 128
//      keys through a ring of kStages stages in dynamic shared memory; each
//      stage completes on a `full` mbarrier and is handed back on an
//      `empty` mbarrier once both warpgroups' products have read it;
//    * loads: TMA (cp.async.bulk.tensor, 4-d maps over (hd, head, seq,
//      batch) with the tensors' strides, 64-wide boxes of 128-byte rows,
//      128-byte swizzle, zero fill past Sq, Skv and hd) when every base
//      address and stride is 16-byte aligned.  TMA cannot take other rows
//      (hd 20 in bf16 is a 40-byte row), so then the producer warp's 32
//      threads copy the tile with the widest plain loads the row allows
//      (8, 4 or 2 bytes, `load_bytes`) into the same swizzled layout and
//      arrive on the same barriers; the wrapper picks the route;
//    * S = Q K^T: wgmma m64n128k16 bf16 -> f32, Q and K both from shared
//      memory, both K-major as they lie (hd contiguous), hd / 16 steps;
//    * the online softmax runs on the accumulator fragment: a thread holds
//      two rows of S, and a row's max reduces over the 4 threads of its
//      quad (the row sum stays a per-thread partial until the end);
//    * O += P V: wgmma m64n{hd_v}k16 with P as bf16 in registers (the
//      score fragment of S is the A-operand fragment of P) and V from shared
//      memory, MN-major (hd_v contiguous) through the transpose bit;
//    * the tiles are templated on the 64-wide chunk counts of q . k (QC)
//      and of v (VC) apart.  At MLA's (3, 2) the dynamic shared memory is
//      Q 48 KB + 2 stages x (K 48 KB + V 32 KB) = 208 KB, under the 227 KB
//      a block may use (one 3-chunk tile size for K and V would need 240
//      KB); S = Q K^T takes 12 k16 steps, and O and its registers stay
//      those of hd_v 128.  At QC == VC the layout is the one of equal
//      widths;
//    * causal: tiles above the diagonal are never loaded, and only the
//      tiles that cross the diagonal or Skv are masked.
//   Numerics: s = scale * (q . k) in float32 (the scale applies to the
//   float32 product), s = softcap * tanh(s / softcap) when softcap > 0,
//   the softmax in base 2 (ex2 of s * log2 e), P rounded to bfloat16 for
//   the P V product while l sums the float32 P.  The rounding of P is the
//   one rounding point the float32 path does not have.
//
// float32 -> `flash_fwd_kernel`, on the CUDA cores, unchanged from the
//   first port: float32 FMAs in the reference's arithmetic,
//   s = (q * scale) . k.  Both products are float32 FMAs (a 4 x 4 score
//   micro-tile per thread), K and V share one shared-memory buffer, hd is
//   padded to 16, 32, 64, 128 or 192 and hd_v, with an extent of its own,
//   to 16, 32, 64 or 128 (template parameters; V's tile and the output
//   registers are hd_v wide, not padded to hd).  Up to hd 128 a block takes
//   at most 82 KB, two blocks per SM.  At hd 192 it takes 115,456 bytes
//   (Q and the K/V buffer 64 x 193 floats each, P 64 x 65): two such
//   blocks with their 1 KB reserve each come to 232,960 of the SM's
//   233,472 bytes, so whether two fit depends on the shared-memory
//   carveout chosen at launch (not measured).  It serves float32 compute, where float32
//   arithmetic is the point.
//
// Plain C interface (bound with ctypes): every launch returns
// cudaGetLastError() (or the tensor-map error) so the Python wrapper can
// raise on a refused launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

namespace f32 {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per kv tile
constexpr int kTM = kBQ / 16;  // 4 rows per thread
constexpr int kTN = kBKV / 16; // 4 keys per thread
constexpr int kLdP = kBKV + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int n_heads,
                 int group, int sq, int skv, int hd, int hd_v, int64_t q_sb,
                 int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                 int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 float scale, float softcap, int causal) {
  constexpr int kLd = HD + 1;
  constexpr int kLdV = HDV + 1;
  constexpr int kTD = HDV / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kBQ][kLd], q * scale
  float* kv_s = q_s + kBQ * kLd;     // [kBKV][kLd] K, then [kBKV][kLdV] V
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
    load_tile<T, HDV>(kv_s, v_base, v_ss, j0, skv, hd_v, 1.f);
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kBKV; ++j) {
      float p[kTM], vv[kTD];
#pragma unroll
      for (int r = 0; r < kTM; ++r) p[r] = p_s[(ty + 16 * r) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kTD; ++c) vv[c] = kv_s[j * kLdV + tx + 16 * c];
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
    const int64_t qrow = (static_cast<int64_t>(b) * sq + qi) * n_heads + h;
    if (lse != nullptr && tx == 0) lse[qrow] = m[r] + logf(denom);
    T* row = out + qrow * hd_v;
#pragma unroll
    for (int c = 0; c < kTD; ++c) {
      const int col = tx + 16 * c;
      if (col < hd_v) store(row + col, acc[r][c] / denom);
    }
  }
}

template <typename T, int HD, int HDV>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* lse, int batch, int sq, int skv, int n_heads,
                 int group, int hd, int hd_v, const int64_t* strides,
                 float scale, float softcap, int causal,
                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kBQ + kBKV) * (HD + 1) + kBQ * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * n_heads);
  flash_fwd_kernel<T, HD, HDV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, n_heads, group, sq,
      skv, hd, hd_v, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], strides[6], strides[7], strides[8], scale, softcap, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

namespace bf16 {

using hopper::desc_sw128;

constexpr int kBQ = 128;       // query rows per block: two warpgroups
constexpr int kBKV = 128;      // keys per kv tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr uint32_t kChunkBytes = 128 * 128;  // 128 rows of 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// shared-memory byte offsets from the 1024-aligned base: QC 64-wide chunks
// of hd in the Q and K tiles, VC of hd_v in the V tile
template <int QC, int VC>
struct Layout {
  static constexpr uint32_t kQKTile = QC * kChunkBytes;
  static constexpr uint32_t kVTile = VC * kChunkBytes;
  static constexpr uint32_t kStage = kQKTile + kVTile;
  static constexpr uint32_t kQ = 0;
  __host__ __device__ static constexpr uint32_t k(int s) {
    return kQKTile + kStage * s;
  }
  __host__ __device__ static constexpr uint32_t v(int s) {
    return k(s) + kQKTile;
  }
  static constexpr uint32_t kBars = kQKTile + kStage * kStages;
  // barriers: full_q, full[kStages], empty[kStages]; 1024 of align slack
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

// rows [r0, r0 + 128) of a (rows, hd) slab with row stride `stride`
// (elements) into a swizzled tile at `dst`, by the 32 threads of a warp
// with loads of `width` bytes; rows >= n_rows and columns >= hd become 0.
// `width` divides the base address, the stride and hd (in bytes).
template <int HDC>
__device__ __forceinline__ void load_plain(uint8_t* dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int r0,
                                           int n_rows, int hd, int width,
                                           int lane) {
  const int vec = width / 2;                 // elements per load
  const int per_row = HDC * 64 / vec;
  for (int e = lane; e < kBKV * per_row; e += 32) {
    const int r = e / per_row;
    const int c = (e % per_row) * vec;
    const int gr = r0 + r;
    const bool ok = gr < n_rows && c < hd;
    const __nv_bfloat16* p = src + static_cast<int64_t>(gr) * stride + c;
    uint8_t* d = dst + (c / 64) * kChunkBytes +
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

template <int VC>
__device__ __forceinline__ void pv_step(float (&o)[32 * VC],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (VC == 2)
    hopper::wgmma_m64n128k16_rs_tb(o, a, db, 1);
  else
    hopper::wgmma_m64n64k16_rs_tb(o, a, db, 1);
}

template <int QC, int VC, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int n_heads,
                       int group, int sq, int skv, int hd, int hd_v,
                       int64_t q_sb,
                       int64_t q_ss, int64_t q_sh, int64_t k_sb,
                       int64_t k_ss, int64_t k_sh, int64_t v_sb,
                       int64_t v_ss, int64_t v_sh, float scale,
                       float softcap, int causal, int load_bytes) {
  using L = Layout<QC, VC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // last tiles first
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y % n_heads;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool tma = load_bytes == 16;
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  const int n_tiles = (kv_end + kBKV - 1) / kBKV;

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

  if (warp == kConsumerWarps) {
    // ---- the producer warp: Q once, then K and V through the ring
    const __nv_bfloat16* k_base = k + b * k_sb + kvh * k_sh;
    const __nv_bfloat16* v_base = v + b * v_sb + kvh * v_sh;
    if (tma) {
      if (lane != 0) return;
      hopper::mbar_arrive_expect_tx(full_q, L::kQKTile);
      for (int c = 0; c < QC; ++c)
        hopper::tma_load_4d(base + L::kQ + c * kChunkBytes, &q_map, full_q,
                            64 * c, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], L::kStage);
        for (int c = 0; c < QC; ++c)
          hopper::tma_load_4d(base + L::k(s) + c * kChunkBytes, &k_map,
                              &full[s], 64 * c, kvh, t * kBKV, b);
        for (int c = 0; c < VC; ++c)
          hopper::tma_load_4d(base + L::v(s) + c * kChunkBytes, &v_map,
                              &full[s], 64 * c, kvh, t * kBKV, b);
      }
    } else {
      load_plain<QC>(base + L::kQ, q + b * q_sb + h * q_sh, q_ss, q0, sq,
                     hd, load_bytes, lane);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(full_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int f = t / kStages;
        if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
        load_plain<QC>(base + L::k(s), k_base, k_ss, t * kBKV, skv, hd,
                       load_bytes, lane);
        load_plain<VC>(base + L::v(s), v_base, v_ss, t * kBKV, skv, hd_v,
                       load_bytes, lane);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: rows q0 + 64 wg + [0, 64)
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int r0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // and r0 + 8
  const uint32_t smem_base = hopper::smem_u32(base);
  const float scale_log2 = scale * kLog2e;

  float o[32 * VC];
  float sc[64];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 32 * VC; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  hopper::mbar_wait(full_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);

    // S = Q K^T over hd in steps of 16
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < QC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_sw128(
            smem_base + L::kQ + c * kChunkBytes + wg * 8192 + kk * 32, 16,
            1024);
        const uint64_t db = desc_sw128(
            smem_base + L::k(s) + c * kChunkBytes + kk * 32, 16, 1024);
        hopper::wgmma_m64n128k16_ss(sc, da, db, (c | kk) != 0);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);

    // scale (base 2), softcap and mask; sc[4i + e] is row r0 + 8 (e / 2),
    // key j0 + 8 i + 2 quad + e % 2
    const int j0 = t * kBKV;
    const bool masked = j0 + kBKV > skv ||
                        (causal && j0 + kBKV - 1 > q0 + 64 * wg);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e];
        if (softcap > 0.f)
          x = softcap * tanhf(x * scale / softcap) * kLog2e;
        else
          x *= scale_log2;
        if (masked) {
          const int kj = j0 + 8 * i + 2 * quad + (e & 1);
          const int qi = r0 + 8 * (e >> 1);
          if (kj >= skv || (causal && kj > qi)) x = kNegInf;
        }
        sc[4 * i + e] = x;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = ex2(m0 - mn0);
    const float corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sc[4 * i] = ex2(sc[4 * i] - mn0);
      sc[4 * i + 1] = ex2(sc[4 * i + 1] - mn0);
      sc[4 * i + 2] = ex2(sc[4 * i + 2] - mn1);
      sc[4 * i + 3] = ex2(sc[4 * i + 3] - mn1);
      rs0 += sc[4 * i] + sc[4 * i + 1];
      rs1 += sc[4 * i + 2] + sc[4 * i + 3];
    }
    l0 = l0 * corr0 + rs0;  // per-thread partial of the row sum
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int i = 0; i < 8 * VC; ++i) {
      o[4 * i] *= corr0;
      o[4 * i + 1] *= corr0;
      o[4 * i + 2] *= corr1;
      o[4 * i + 3] *= corr1;
    }
    // P as the A fragment of k-step kk: keys 16 kk + [0, 16)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V over the tile's keys in steps of 16
    hopper::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) hopper::fence_regs(p[kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      pv_step<VC>(o, p[kk],
                   desc_sw128(smem_base + L::v(s) + kk * 2048, kChunkBytes,
                              1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) hopper::fence_regs(p[kk]);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if constexpr (kLse) {
    // the natural-log row state: m is in base 2 (scores times log2 e)
    constexpr float kLn2 = 0.6931471805599453f;
    if (quad == 0 && r0 < sq)
      lse[(static_cast<int64_t>(b) * sq + r0) * n_heads + h] =
          (m0 + log2f(fmaxf(l0, 1e-30f))) * kLn2;
    if (quad == 0 && r0 + 8 < sq)
      lse[(static_cast<int64_t>(b) * sq + r0 + 8) * n_heads + h] =
          (m1 + log2f(fmaxf(l1, 1e-30f))) * kLn2;
  }
  const bool pairs = (hd_v % 2) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = r0 + 8 * half;
    if (qi >= sq) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* row =
        out + ((static_cast<int64_t>(b) * sq + qi) * n_heads + h) * hd_v;
#pragma unroll
    for (int i = 0; i < 8 * VC; ++i) {
      const int col = 8 * i + 2 * quad;
      const float x0 = o[4 * i + 2 * half] * inv;
      const float x1 = o[4 * i + 2 * half + 1] * inv;
      if (pairs && col + 1 < hd_v) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < hd_v) row[col] = __float2bfloat16(x0);
        if (col + 1 < hd_v) row[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// 4-d map (hd, heads, seq, batch) over a (B, S, heads, hd) bf16 tensor,
// boxes of 64 hd x 128 rows of one head
inline int make_qkv_map(CUtensorMap* map, const void* ptr, int batch,
                        int seq, int heads, int hd, const int64_t* st) {
  const uint64_t dims[4] = {static_cast<uint64_t>(hd),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(seq),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {64, 1, kBQ, 1};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr,
                               dims, strides, box);
}

template <int QC, int VC>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int batch, int sq, int skv, int n_heads, int group,
           int hd, int hd_v,
           const int64_t* strides, float scale, float softcap, int causal,
           int load_bytes, cudaStream_t stream) {
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (load_bytes == 16) {
    const int n_kv = n_heads / group;
    int err = make_qkv_map(&maps[0], q, batch, sq, n_heads, hd, strides);
    if (!err) err = make_qkv_map(&maps[1], k, batch, skv, n_kv, hd,
                                 strides + 3);
    if (!err) err = make_qkv_map(&maps[2], v, batch, skv, n_kv, hd_v,
                                 strides + 6);
    if (err) return err;
  }
  // the lse epilogue is a template switch: with it the kernel takes ~10%
  // longer (0.331 -> 0.364 ms at qwen2-7b's prefill shape on the H100),
  // also behind a run-time branch, so the inference forward is compiled
  // without it
  auto* kernel = lse != nullptr ? flash_fwd_wgmma_kernel<QC, VC, true>
                                : flash_fwd_wgmma_kernel<QC, VC, false>;
  const size_t smem = Layout<QC, VC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, n_heads, group, sq, skv, hd,
      hd_v, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], strides[6], strides[7], strides[8], scale, softcap, causal,
      load_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

// the float32 kernel's padded widths: hd to 16, 32, 64, 128 or 192, hd_v
// to 16, 32, 64 or 128 (never above hd's)
template <int HD>
int launch_f32_hd(const void* q, const void* k, const void* v, void* out,
                  float* lse, int batch, int sq, int skv, int n_heads,
                  int group, int hd, int hd_v, const int64_t* strides,
                  float scale, float softcap, int causal,
                  cudaStream_t stream) {
#define FLASH_F32(HDV)                                                     \
  return f32::launch_typed<float, HD, HDV>(q, k, v, out, lse, batch, sq,   \
                                           skv, n_heads, group, hd, hd_v,  \
                                           strides, scale, softcap,        \
                                           causal, stream)
  if (hd_v <= 16) FLASH_F32(16);
  if constexpr (HD >= 32) {
    if (hd_v <= 32) FLASH_F32(32);
  }
  if constexpr (HD >= 64) {
    if (hd_v <= 64) FLASH_F32(64);
  }
  if constexpr (HD >= 128) {
    if (hd_v <= 128) FLASH_F32(128);
  }
#undef FLASH_F32
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int sq, int skv, int n_heads,
               int group, int hd, int hd_v, const int64_t* strides,
               float scale, float softcap, int causal, cudaStream_t stream) {
#define FLASH_F32_HD(HD)                                                  \
  return launch_f32_hd<HD>(q, k, v, out, lse, batch, sq, skv, n_heads,     \
                           group, hd, hd_v, strides, scale, softcap,      \
                           causal, stream)
  if (hd <= 16) FLASH_F32_HD(16);
  if (hd <= 32) FLASH_F32_HD(32);
  if (hd <= 64) FLASH_F32_HD(64);
  if (hd <= 128) FLASH_F32_HD(128);
  FLASH_F32_HD(192);
#undef FLASH_F32_HD
}

// the bfloat16 kernel's 64-wide chunk counts: QC of hd (1 to 3), VC of
// hd_v (1 or 2, never above QC)
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int batch, int sq, int skv, int n_heads,
                int group, int hd, int hd_v, const int64_t* strides,
                float scale, float softcap, int causal, int load_bytes,
                cudaStream_t stream) {
  const int qc = (hd + 63) / 64;
  const int vc = (hd_v + 63) / 64;
#define FLASH_BF16(QC, VC)                                                 \
  if (qc == QC && vc == VC)                                                \
  return bf16::launch<QC, VC>(q, k, v, out, lse, batch, sq, skv, n_heads,  \
                              group, hd, hd_v, strides, scale, softcap,    \
                              causal, load_bytes, stream)
  FLASH_BF16(1, 1);
  FLASH_BF16(2, 1);
  FLASH_BF16(2, 2);
  FLASH_BF16(3, 1);
  FLASH_BF16(3, 2);
#undef FLASH_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides: the (batch, sequence, head) strides of q, k and v in elements,
// in that order (9 values).  dtype: 0 = float32, 1 = bfloat16.  lse (may
// be null): (B, Sq, H) float32, each row's log-sum-exp m + log(l) of the
// scaled scores in natural-log units, for the backward
// (csrc/flash_attention_bwd.cu); with Skv = 0 (bfloat16) it is not written.
// load_bytes (bfloat16 only): 16 loads the tiles by TMA (every base address
// and stride 16-byte aligned); 8, 4 or 2 loads them with plain loads of
// that many bytes, which must divide every base address, stride, hd and
// hd_v.  hd <= 192 and hd_v <= min(hd, 128).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int batch, int sq, int skv, int n_heads,
                                      int n_kv_heads, int hd, int hd_v,
                                      const int64_t* strides, float scale,
                                      float softcap, int causal, int dtype,
                                      int load_bytes, void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (batch <= 0 || sq <= 0 || skv < 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 || hd <= 0 || hd > 192 || hd_v <= 0 ||
      hd_v > hd || hd_v > 128 ||
      static_cast<int64_t>(batch) * n_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = n_heads / n_kv_heads;
  if (dtype == 0)
    return launch_f32(q, k, v, out, lse, batch, sq, skv, n_heads, group, hd,
                      hd_v, strides, scale, softcap, causal, s);
  if (dtype != 1 || (load_bytes != 16 && load_bytes != 8 &&
                     load_bytes != 4 && load_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (skv == 0) {  // nothing to attend to: the output is 0, as in float32
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(batch) * sq * n_heads * hd_v * 2, s);
    return static_cast<int>(err);
  }
  return launch_bf16(q, k, v, out, lse, batch, sq, skv, n_heads, group, hd,
                     hd_v, strides, scale, softcap, causal, load_bytes, s);
}
