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
// shared memory only (bfloat16; float32 reads them through a pre-pass,
// below, whose planes hold one copy per kv head).  Blocks run in no order, so each walks its own kv
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
// float32 -> a pre-pass (`split_rows_kernel` for q and k,
//   `split_vt_kernel` for v), then `flash_fwd_3xtf32_kernel`, on the tensor
//   cores as an error-compensated 3xTF32 product (the arithmetic of
//   coded_matmul.cu): x = hi + lo with hi = tf32(x) and lo = tf32(x - hi),
//   and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b dropped), every
//   sum float32.  Scores are (q * scale) . k: the pre-pass scales q in
//   float32 and then splits it (the model path's rounding: the Pallas
//   wrapper rounded q * scale to q's dtype).  The online softmax, its row
//   sums and lse stay float32 (base 2 inside, as the bfloat16 kernel).
//   Bound on the H100: operations.  At MLA's 192/128 prefill (B = 1, S =
//   4096, H = 16, causal) the two products are 85.9 GFLOP: ~0.52 ms at a
//   third of the 495 TFLOP/s TF32 rate (1.28 ms at the 67 TFLOP/s float32
//   CUDA-core rate).
//   What shaped the design:
//    * TF32 wgmma has no transpose bit: both shared-memory operands must be
//      K-major.  S = Q K^T is, as the tensors lie; O += P V reduces over
//      keys, so V is needed as V^T, keys contiguous.  The pre-pass writes
//      q * scale, k and v^T as hi and lo planes into scratch that the
//      wrapper allocates (flash_attention_scratch gives the extents),
//      zero-padded to the tiles, which also reads strided heads in place,
//      takes any hd (80-byte rows at hd 20) and leaves every TMA stride
//      aligned.  Its bytes (~440 MB at MLA's shape) count in the call.
//    * The score accumulator is not the TF32 A fragment: an m64nN
//      accumulator holds columns 2t and 2t + 1 of each group of 8 in thread
//      t of a quad, a tf32 m64k8 A fragment columns t and t + 4.  The
//      pre-pass stores v^T's keys in every group of 8 in the order (0, 2,
//      4, 6, 1, 3, 5, 7), so the fragment's column t is key 2t and column
//      t + 4 key 2t + 1: P goes from the accumulator to the A fragment of
//      P V in registers, split into hi and lo there (wgmma m64nNk8 tf32
//      with A from registers, hopper.cuh).
//    * Shared memory: hi and lo double every tile.  Planes come in 32-wide
//      chunks (one 128-byte swizzled row per tile row, TMA boxes of 32 x
//      rows x both planes) and K and V^T have rings of their own (KS and
//      VS stages, `Cfg`), so the layout fits 227 KB at every width: hd <=
//      64 two consumer warpgroups (128 query rows), 64-key tiles, two
//      stages each (96 and 192 KB); hd 96 two warpgroups, 32-key tiles,
//      two stages (192 KB); hd 128 two warpgroups, 32-key tiles, two K
//      stages and one V^T stage (224 KB); 192/128 one warpgroup (Q alone
//      is 96 KB), 32-key tiles, two K stages (48 KB each), one V^T stage
//      (32 KB): 224 KB.  One block per SM.
//    * Accuracy: each wgmma adds its products into the accumulator less
//      accurately than a float32 add rounds (on the H100, one accumulator
//      over all of S's 3 x 24 k8 steps at hd 192 left the kernel 3.4x the
//      plain float32 version's rms error against float64, and a 27-layer
//      float32 deepseek forward 1.09e-4 of max |logits| from the plain
//      one).  So the small lo.hi and hi.lo products of S go to one
//      accumulator, the hi.hi products of the 32-wide chunks of hd to NB
//      more (NB = 3 at hd 192, 2 at 96, 1 elsewhere: what the registers
//      hold without a spill), summed in float32 registers; at hd 192 the
//      rms error is then 0.8x the plain version's.  Each tile's P V goes
//      to a fresh accumulator, added into the rescaled output in float32
//      registers, so no wgmma sum spans more than one tile's keys.  Only
//      wgmma writes an accumulator between its products (ptxas serializes
//      them otherwise, its C7515 warning).
//    * causal: tiles above the diagonal are never loaded; a warpgroup
//      whose rows all lie before a tile skips its products.  Nothing is
//      atomic and every sum runs in a fixed order: two calls give the same
//      bits.
//   hd is padded to 32, 64, 96, 128 or 192 and hd_v to min(that, 128)
//   (template parameter HDP); the padding is zeros in the planes.
//
// Plain C interface (bound with ctypes): every launch returns
// cudaGetLastError() (or the tensor-map error) so the Python wrapper can
// raise on a refused launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

namespace f32 {

using hopper::desc_sw128;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// round to nearest (ties away) at TF32's 10 mantissa bits, as
// coded_matmul.cu's tf32_round: the low 13 bits become 0, which is all the
// tensor cores read of a tf32 operand
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return __uint_as_float(u);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the tiles of a padded q . k width HDP (32, 64, 96, 128 or 192): WG
// consumer warpgroups of 64 query rows, BKV keys a tile, KS stages of K
// and VS of V^T in shared memory, NB accumulators for the hi.hi products
// of S (the kernel's note: as many as the registers hold without a spill)
template <int HDP> struct Cfg;
template <> struct Cfg<32> { static constexpr int WG = 2, BKV = 64, KS = 2, VS = 2, NB = 1; };
template <> struct Cfg<64> { static constexpr int WG = 2, BKV = 64, KS = 2, VS = 2, NB = 1; };
template <> struct Cfg<96> { static constexpr int WG = 2, BKV = 32, KS = 2, VS = 2, NB = 2; };
template <> struct Cfg<128> { static constexpr int WG = 2, BKV = 32, KS = 2, VS = 1, NB = 1; };
template <> struct Cfg<192> { static constexpr int WG = 1, BKV = 32, KS = 2, VS = 1, NB = 3; };

// shared-memory byte offsets from the 1024-aligned base.  Every operand is
// a run of 32-column chunks (one 128-byte swizzled row per tile row), each
// chunk its hi plane then its lo plane: Q (QC chunks of BQ rows), a K
// stage (QC chunks of BKV keys), a V^T stage (BKV / 32 chunks of NV rows
// of 32 keys)
template <int HDP>
struct Layout {
  using C = Cfg<HDP>;
  static constexpr int QC = HDP / 32;
  static constexpr int NV = HDP < 128 ? HDP : 128;  // hd_v padded
  static constexpr int BQ = 64 * C::WG;
  // two consumer warpgroups take a producer warpgroup, of which one warp
  // loads: 384 threads hold ptxas to 168 registers a thread (a
  // sub-partition's 16,384 over three warps), so the producers give all
  // but kProducerRegs back by setmaxnreg and the consumers take
  // kConsumerRegs (128 x 40 + 256 x 232 = 384 x 168).  One consumer
  // warpgroup and one producer warp (160 threads) may use 255 as they are
  static constexpr int kThreads = C::WG == 2 ? 384 : 160;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr uint32_t kQPlane = BQ * 128;
  static constexpr uint32_t kQChunk = 2 * kQPlane;
  static constexpr uint32_t kKPlane = C::BKV * 128;
  static constexpr uint32_t kKChunk = 2 * kKPlane;
  static constexpr uint32_t kKStage = QC * kKChunk;
  static constexpr uint32_t kVPlane = NV * 128;
  static constexpr uint32_t kVChunk = 2 * kVPlane;
  static constexpr uint32_t kVStage = (C::BKV / 32) * kVChunk;
  static constexpr uint32_t kQ = 0;
  __host__ __device__ static constexpr uint32_t k(int s) {
    return QC * kQChunk + kKStage * s;
  }
  __host__ __device__ static constexpr uint32_t v(int s) {
    return k(C::KS) + kVStage * s;
  }
  static constexpr uint32_t kBars =
      QC * kQChunk + kKStage * C::KS + kVStage * C::VS;
  // barriers: full_q, full_k[KS], empty_k[KS], full_v[VS], empty_v[VS];
  // 1024 of align slack
  static constexpr uint32_t kBytes =
      kBars + 8 * (1 + 2 * C::KS + 2 * C::VS) + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

// S (+)= A B over N = BKV keys, A and B from shared memory
template <int N>
__device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da,
                                   uint64_t db, int scale_d) {
  if constexpr (N == 64)
    hopper::wgmma_m64n64k8_tf32(d, da, db, scale_d);
  else
    hopper::wgmma_m64n32k8_tf32(d, da, db, scale_d);
}

// D (+)= A B over N = NV columns, A from registers
template <int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t db, int scale_d) {
  if constexpr (N == 128)
    hopper::wgmma_m64n128k8_tf32_rs(d, a, db, scale_d);
  else if constexpr (N == 96)
    hopper::wgmma_m64n96k8_tf32_rs(d, a, db, scale_d);
  else if constexpr (N == 64)
    hopper::wgmma_m64n64k8_tf32_rs(d, a, db, scale_d);
  else
    hopper::wgmma_m64n32k8_tf32_rs(d, a, db, scale_d);
}

// ---- the pre-pass: TF32 hi and lo planes ------------------------------

// (B, S, heads, width) -> planes (B * heads, 2, s_pad, hdp): hi = tf32(x *
// scale) and lo = tf32(x * scale - hi), zero past S and width; one thread
// per element of the padded hi plane
__global__ void __launch_bounds__(256)
split_rows_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  int s, int heads, int width, int s_pad, int hdp,
                  int64_t sb, int64_t ss_, int64_t sh, float scale,
                  int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total) return;
  const int c = static_cast<int>(e % hdp);
  const int64_t rest = e / hdp;
  const int r = static_cast<int>(rest % s_pad);
  const int64_t bh = rest / s_pad;
  const int64_t b = bh / heads;
  const int h = static_cast<int>(bh % heads);
  float x = 0.f;
  if (r < s && c < width) x = src[b * sb + r * ss_ + h * sh + c] * scale;
  const float hi = tf32_round(x);
  const int64_t plane = static_cast<int64_t>(s_pad) * hdp;
  float* d = dst + bh * 2 * plane + static_cast<int64_t>(r) * hdp + c;
  d[0] = hi;
  d[plane] = tf32_round(x - hi);
}

// v (B, S, heads, hd_v) -> V^T planes (B * heads, 2, nv, s_pad): keys
// contiguous and, within every group of 8, in the order (0, 2, 4, 6, 1, 3,
// 5, 7), which makes the score accumulator the A fragment of P V (the
// kernel's note); zero past S and hd_v.  One block per 32 keys x 32
// columns, transposed through shared memory
__global__ void __launch_bounds__(256)
split_vt_kernel(const float* __restrict__ v, float* __restrict__ dst, int s,
                int heads, int hd_v, int s_pad, int nv, int64_t sb,
                int64_t ss_, int64_t sh) {
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
        (j < s && c < hd_v) ? v[b * sb + j * ss_ + h * sh + c] : 0.f;
  }
  __syncthreads();
  const int x = threadIdx.x;
  const int key = (x & ~7) + ((x & 7) < 4 ? 2 * (x & 7) : 2 * (x & 7) - 7);
  const int64_t plane = static_cast<int64_t>(nv) * s_pad;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const float val = t[key][r];
    const float hi = tf32_round(val);
    float* d = dst + bh * 2 * plane + static_cast<int64_t>(c0 + r) * s_pad +
               j0 + x;
    d[0] = hi;
    d[plane] = tf32_round(val - hi);
  }
}

// ---- the 3xTF32 kernel ------------------------------------------------

template <int HDP>
__global__ void __launch_bounds__(Layout<HDP>::kThreads, 1)
flash_fwd_3xtf32_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        float* __restrict__ out, float* __restrict__ lse,
                        int n_heads, int group, int sq, int skv, int hd_v,
                        float softcap, int causal) {
  using C = Cfg<HDP>;
  using L = Layout<HDP>;
  constexpr int QC = L::QC;
  constexpr int NV = L::NV;
  constexpr int BKV = C::BKV;
  constexpr int KS = C::KS;
  constexpr int VS = C::VS;
  constexpr int NB = C::NB;
  constexpr int kConsumerWarps = 4 * C::WG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full_k = full_q + 1;
  uint64_t* empty_k = full_k + KS;
  uint64_t* full_v = empty_k + KS;
  uint64_t* empty_v = full_v + VS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * L::BQ;  // last tiles first
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int bkv = b * (n_heads / group) + h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kv_end = causal ? min(skv, q0 + L::BQ) : skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  if (tid == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < KS; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&empty_k[s], kConsumerWarps);
    }
    for (int s = 0; s < VS; ++s) {
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty_v[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- the producer: Q once, then each tile's K and V^T, by TMA
    if constexpr (C::WG == 2) hopper::setmaxnreg_dec<L::kProducerRegs>();
    if (warp != kConsumerWarps || lane != 0) return;
    hopper::mbar_arrive_expect_tx(full_q, QC * L::kQChunk);
    for (int c = 0; c < QC; ++c)
      hopper::tma_load_4d(base + c * L::kQChunk, &q_map, full_q, 32 * c, q0,
                          0, bh);
    for (int t = 0; t < n_tiles; ++t) {
      const int ks = t % KS;
      if (t >= KS) hopper::mbar_wait(&empty_k[ks], ((t / KS) - 1) & 1);
      hopper::mbar_arrive_expect_tx(&full_k[ks], L::kKStage);
      for (int c = 0; c < QC; ++c)
        hopper::tma_load_4d(base + L::k(ks) + c * L::kKChunk, &k_map,
                            &full_k[ks], 32 * c, t * BKV, 0, bkv);
      const int vs = t % VS;
      if (t >= VS) hopper::mbar_wait(&empty_v[vs], ((t / VS) - 1) & 1);
      hopper::mbar_arrive_expect_tx(&full_v[vs], L::kVStage);
      for (int c = 0; c < BKV / 32; ++c)
        hopper::tma_load_4d(base + L::v(vs) + c * L::kVChunk, &v_map,
                            &full_v[vs], t * BKV + 32 * c, 0, 0, bkv);
    }
    return;
  }

  // ---- the consumer warpgroups: rows qw + [0, 64)
  if constexpr (C::WG == 2) hopper::setmaxnreg_inc<L::kConsumerRegs>();
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * (warp % 4) + lane / 4;  // and r0 + 8
  const uint32_t sb = hopper::smem_u32(base);

  // o is written by the CUDA cores only: each tile's P V goes to a fresh
  // accumulator pv (only wgmma writes it: ptxas's C7515), which is then
  // added into the rescaled o in float32
  float o[NV / 2];
  float sc[BKV / 2], big[NB][BKV / 2];
  float pv[NV / 2];
  uint32_t ph[BKV / 8][4], pl[BKV / 8][4];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) o[i] = pv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    sc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) big[j][i] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  hopper::mbar_wait(full_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int ks = t % KS;
    const int vs = t % VS;
    const int j0 = t * BKV;
    hopper::mbar_wait(&full_k[ks], (t / KS) & 1);
    // every key of the tile after every row of this warpgroup
    if (causal && j0 > qw + 63) {
      if (lane == 0) hopper::mbar_arrive(&empty_k[ks]);
      hopper::mbar_wait(&full_v[vs], (t / VS) & 1);
      if (lane == 0) hopper::mbar_arrive(&empty_v[vs]);
      continue;
    }

    // S = (Q scale) K^T over hd: the hi.hi products of chunk c of hd go to
    // accumulator c NB / QC, every lo.hi and hi.lo to one more
#pragma unroll
    for (int j = 0; j < NB; ++j) hopper::fence_regs(big[j]);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < QC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t qa = sb + L::kQ + c * L::kQChunk + wg * 8192 + kk * 32;
        const uint32_t kb = sb + L::k(ks) + c * L::kKChunk + kk * 32;
        const bool starts = kk == 0 &&
                            (c == 0 || (c - 1) * NB / QC != c * NB / QC);
        ss<BKV>(sc, desc_sw128(qa + L::kQPlane, 16, 1024),
                desc_sw128(kb, 16, 1024), (c | kk) != 0);
        ss<BKV>(sc, desc_sw128(qa, 16, 1024),
                desc_sw128(kb + L::kKPlane, 16, 1024), 1);
        ss<BKV>(big[c * NB / QC], desc_sw128(qa, 16, 1024),
                desc_sw128(kb, 16, 1024), !starts);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) hopper::fence_regs(big[j]);
    hopper::fence_regs(sc);
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      float x = big[0][i];
#pragma unroll
      for (int j = 1; j < NB; ++j) x += big[j][i];
      sc[i] += x;
    }
    if (lane == 0) hopper::mbar_arrive(&empty_k[ks]);

    // softcap, base 2 and mask; sc[4i + e] is row r0 + 8 (e / 2), key j0 +
    // 8 i + 2 quad + e % 2
    const bool masked = j0 + BKV > skv || (causal && j0 + BKV - 1 > qw);
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e];
        if (softcap > 0.f)
          x = softcap * tanhf(x / softcap) * kLog2e;
        else
          x *= kLog2e;
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
    for (int i = 0; i < BKV / 8; ++i) {
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
    for (int i = 0; i < BKV / 8; ++i) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = ex2(sc[4 * i + e] - (e < 2 ? mn0 : mn1));
      rs0 += p[0] + p[1];
      rs1 += p[2] + p[3];
      // P's hi and lo as the A fragment of k8 step i, (row g, column
      // quad), (g + 8, quad), (g, quad + 4), (g + 8, quad + 4): a thread's
      // keys 2 quad and 2 quad + 1 are the fragment's columns quad and
      // quad + 4 (V^T's keys are stored in that order)
      const float a[4] = {p[0], p[2], p[1], p[3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hi = tf32_round(a[e]);
        ph[i][e] = __float_as_uint(hi);
        pl[i][e] = __float_as_uint(tf32_round(a[e] - hi));
      }
    }
    l0 = l0 * corr0 + rs0;  // per-thread partial of the row sum
    l1 = l1 * corr1 + rs1;

    // pv = P V over the tile's keys: lo.hi, hi.lo, hi.hi per k8 step
    hopper::mbar_wait(&full_v[vs], (t / VS) & 1);
    hopper::fence_regs(pv);
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      hopper::fence_regs(ph[i]);
      hopper::fence_regs(pl[i]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      const uint32_t vb = sb + L::v(vs) + (i / 4) * L::kVChunk + (i % 4) * 32;
      rs<NV>(pv, pl[i], desc_sw128(vb, 16, 1024), i != 0);
      rs<NV>(pv, ph[i], desc_sw128(vb + L::kVPlane, 16, 1024), 1);
      rs<NV>(pv, ph[i], desc_sw128(vb, 16, 1024), 1);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      o[4 * i] *= corr0;
      o[4 * i + 1] *= corr0;
      o[4 * i + 2] *= corr1;
      o[4 * i + 3] *= corr1;
    }
    hopper::wgmma_wait_all();
    hopper::fence_regs(pv);
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      hopper::fence_regs(ph[i]);
      hopper::fence_regs(pl[i]);
    }
    if (lane == 0) hopper::mbar_arrive(&empty_v[vs]);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] += pv[i];
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && quad == 0) {
    // the natural-log row state: m is in base 2 (scores times log2 e)
    constexpr float kLn2 = 0.6931471805599453f;
    if (r0 < sq)
      lse[(static_cast<int64_t>(b) * sq + r0) * n_heads + h] =
          (m0 + log2f(fmaxf(l0, 1e-30f))) * kLn2;
    if (r0 + 8 < sq)
      lse[(static_cast<int64_t>(b) * sq + r0 + 8) * n_heads + h] =
          (m1 + log2f(fmaxf(l1, 1e-30f))) * kLn2;
  }
  const bool pairs = (hd_v % 2) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = r0 + 8 * half;
    if (qi >= sq) continue;
    const float inv = half ? inv1 : inv0;
    float* row = out + ((static_cast<int64_t>(b) * sq + qi) * n_heads + h) *
                           hd_v;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int col = 8 * i + 2 * quad;
      const float x0 = o[4 * i + 2 * half] * inv;
      const float x1 = o[4 * i + 2 * half + 1] * inv;
      if (pairs && col + 1 < hd_v) {
        *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
      } else {
        if (col < hd_v) row[col] = x0;
        if (col + 1 < hd_v) row[col + 1] = x1;
      }
    }
  }
}

// the planes' extents {sq_pad, skv_pad, hd_pad, hdv_pad} of width HDP
template <int HDP>
void extents(int sq, int skv, int64_t* e) {
  auto up = [](int64_t x, int64_t t) { return (x + t - 1) / t * t; };
  e[0] = up(sq, Layout<HDP>::BQ);
  e[1] = up(skv, Cfg<HDP>::BKV);
  e[2] = HDP;
  e[3] = Layout<HDP>::NV;
}

// f(std::integral_constant<int, HDP>) for the padded width of hd
template <typename F>
int with_width(int hd, F&& f) {
  if (hd <= 32) return f(std::integral_constant<int, 32>{});
  if (hd <= 64) return f(std::integral_constant<int, 64>{});
  if (hd <= 96) return f(std::integral_constant<int, 96>{});
  if (hd <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 192>{});
}

// the pre-pass into `planes`: Q (B * H, 2, sq_pad, hdp) times `scale`, K
// (B * KV, 2, skv_pad, hdp), V^T (B * KV, 2, nv, skv_pad), one after the
// other
int split(const float* q, const float* k, const float* v, float* planes,
          int batch, int sq, int skv, int n_heads, int n_kv, int hd,
          int hd_v, const int64_t* st, const int64_t* e, float scale,
          cudaStream_t stream) {
  const int64_t sq_pad = e[0], skv_pad = e[1], hdp = e[2], nv = e[3];
  const int64_t nq = static_cast<int64_t>(batch) * n_heads * sq_pad * hdp;
  const int64_t nk = static_cast<int64_t>(batch) * n_kv * skv_pad * hdp;
  float* q_planes = planes;
  float* k_planes = q_planes + 2 * nq;
  float* vt_planes = k_planes + 2 * nk;
  split_rows_kernel<<<static_cast<unsigned>((nq + 255) / 256), 256, 0,
                      stream>>>(q, q_planes, sq, n_heads, hd,
                                static_cast<int>(sq_pad),
                                static_cast<int>(hdp), st[0], st[1], st[2],
                                scale, nq);
  split_rows_kernel<<<static_cast<unsigned>((nk + 255) / 256), 256, 0,
                      stream>>>(k, k_planes, skv, n_kv, hd,
                                static_cast<int>(skv_pad),
                                static_cast<int>(hdp), st[3], st[4], st[5],
                                1.f, nk);
  split_vt_kernel<<<dim3(static_cast<unsigned>(skv_pad / 32),
                         static_cast<unsigned>(nv / 32), batch * n_kv),
                    dim3(32, 8), 0, stream>>>(
      v, vt_planes, skv, n_kv, hd_v, static_cast<int>(skv_pad),
      static_cast<int>(nv), st[6], st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

// 4-d map (inner, rows, 2 planes, heads) over float32 planes, boxes of 32
// inner x `box_rows` rows x both planes
inline int make_plane_map(CUtensorMap* map, const float* planes,
                          int64_t inner, int64_t rows, int64_t heads,
                          int box_rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(inner),
                            static_cast<uint64_t>(rows), 2,
                            static_cast<uint64_t>(heads)};
  const uint64_t strides[3] = {static_cast<uint64_t>(inner) * 4,
                               static_cast<uint64_t>(inner * rows) * 4,
                               static_cast<uint64_t>(inner * rows) * 8};
  const uint32_t box[4] = {32, static_cast<uint32_t>(box_rows), 2, 1};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                               planes, dims, strides, box);
}

template <int HDP>
int launch(const float* planes, float* out, float* lse, int batch, int sq,
           int skv, int n_heads, int n_kv, int hd_v, const int64_t* e,
           float softcap, int causal, cudaStream_t stream) {
  using L = Layout<HDP>;
  const int64_t sq_pad = e[0], skv_pad = e[1];
  const int64_t nq = static_cast<int64_t>(batch) * n_heads * sq_pad * HDP;
  const int64_t nk = static_cast<int64_t>(batch) * n_kv * skv_pad * HDP;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  int err = make_plane_map(&maps[0], planes, HDP, sq_pad,
                           static_cast<int64_t>(batch) * n_heads, L::BQ);
  if (!err)
    err = make_plane_map(&maps[1], planes + 2 * nq, HDP, skv_pad,
                         static_cast<int64_t>(batch) * n_kv, Cfg<HDP>::BKV);
  if (!err)
    err = make_plane_map(&maps[2], planes + 2 * nq + 2 * nk, skv_pad, L::NV,
                         static_cast<int64_t>(batch) * n_kv, L::NV);
  if (err) return err;
  const size_t smem = L::kBytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_3xtf32_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(static_cast<unsigned>(sq_pad / L::BQ), batch * n_heads);
  flash_fwd_3xtf32_kernel<HDP><<<grid, L::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], out, lse, n_heads, n_heads / n_kv, sq, skv,
      hd_v, softcap, causal);
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

namespace {

bool valid_shape(int batch, int sq, int skv, int n_heads, int n_kv_heads,
                 int hd, int hd_v) {
  return batch > 0 && sq > 0 && skv >= 0 && n_kv_heads > 0 &&
         n_heads % n_kv_heads == 0 && hd > 0 && hd <= 192 && hd_v > 0 &&
         hd_v <= hd && hd_v <= 128 &&
         static_cast<int64_t>(batch) * n_heads <= 65535;
}

}  // namespace

// The float32 pre-pass's plane extents {sq_pad, skv_pad, hd_pad, hdv_pad}
// into `e`: the launch's `scratch` holds Q (B * H, 2, sq_pad, hd_pad), K
// (B * KV, 2, skv_pad, hd_pad) and V^T (B * KV, 2, hdv_pad, skv_pad)
// float32 planes, in that order.  Returns cudaErrorInvalidValue for a
// shape the launch refuses.
extern "C" int flash_attention_scratch(int batch, int sq, int skv,
                                       int n_heads, int n_kv_heads, int hd,
                                       int hd_v, int64_t* e) {
  if (!valid_shape(batch, sq, skv, n_heads, n_kv_heads, hd, hd_v))
    return static_cast<int>(cudaErrorInvalidValue);
  return f32::with_width(hd, [&](auto w) {
    f32::extents<decltype(w)::value>(sq, skv, e);
    return 0;
  });
}

// The float32 pre-pass alone: q * scale, k and v^T (keys in the kernel's
// order) as TF32 hi and lo planes into `scratch` (flash_attention_scratch's
// layout).  The launch below runs it first; this entry lets a caller hold
// the planes against their plain version.
extern "C" int flash_attention_split(const float* q, const float* k,
                                     const float* v, float* scratch,
                                     int batch, int sq, int skv, int n_heads,
                                     int n_kv_heads, int hd, int hd_v,
                                     const int64_t* strides, float scale,
                                     void* stream) {
  cudaGetLastError();
  int64_t e[4];
  if (flash_attention_scratch(batch, sq, skv, n_heads, n_kv_heads, hd, hd_v,
                              e) != 0 || skv == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return f32::split(q, k, v, scratch, batch, sq, skv, n_heads, n_kv_heads,
                    hd, hd_v, strides, e, scale,
                    static_cast<cudaStream_t>(stream));
}

// strides: the (batch, sequence, head) strides of q, k and v in elements,
// in that order (9 values).  dtype: 0 = float32, 1 = bfloat16.  lse (may
// be null): (B, Sq, H) float32, each row's log-sum-exp m + log(l) of the
// scaled scores in natural-log units, for the backward
// (csrc/flash_attention_bwd.cu); with Skv = 0 it is not written.
// scratch (float32 only): the pre-pass's planes, of the extents
// flash_attention_scratch returns.  load_bytes (bfloat16 only): 16 loads
// the tiles by TMA (every base address and stride 16-byte aligned); 8, 4 or
// 2 loads them with plain loads of that many bytes, which must divide every
// base address, stride, hd and hd_v.  hd <= 192 and hd_v <= min(hd, 128).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      float* scratch, int batch, int sq,
                                      int skv, int n_heads, int n_kv_heads,
                                      int hd, int hd_v,
                                      const int64_t* strides, float scale,
                                      float softcap, int causal, int dtype,
                                      int load_bytes, void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (!valid_shape(batch, sq, skv, n_heads, n_kv_heads, hd, hd_v) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (skv == 0) {  // nothing to attend to: the output is 0
    const cudaError_t err = cudaMemsetAsync(
        out, 0,
        static_cast<size_t>(batch) * sq * n_heads * hd_v * (dtype ? 2 : 4),
        s);
    return static_cast<int>(err);
  }
  const int group = n_heads / n_kv_heads;
  if (dtype == 0) {
    int64_t e[4];
    flash_attention_scratch(batch, sq, skv, n_heads, n_kv_heads, hd, hd_v,
                            e);
    const int err = f32::split(static_cast<const float*>(q),
                               static_cast<const float*>(k),
                               static_cast<const float*>(v), scratch, batch,
                               sq, skv, n_heads, n_kv_heads, hd, hd_v,
                               strides, e, scale, s);
    if (err) return err;
    return f32::with_width(hd, [&](auto w) {
      return f32::launch<decltype(w)::value>(
          scratch, static_cast<float*>(out), lse, batch, sq, skv, n_heads,
          n_kv_heads, hd_v, e, softcap, causal, s);
    });
  }
  if (load_bytes != 16 && load_bytes != 8 && load_bytes != 4 &&
      load_bytes != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(q, k, v, out, lse, batch, sq, skv, n_heads, group, hd,
                     hd_v, strides, scale, softcap, causal, load_bytes, s);
}
