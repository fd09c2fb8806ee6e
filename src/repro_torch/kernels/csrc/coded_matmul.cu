// coded_matmul: out[n] = (W @ A)[n] @ B, the SPACDC encode and all N
// worker products, from one C entry point.
//
//   W   (N, J)          coding matrix, float32
//   A   (J, blk, d)     the round's J stacked blocks, float32 or bfloat16
//   B   (d, n_out)      the shared right factor, float32 or bfloat16
//   out (N, blk, n_out) per-worker results, in A's dtype
//
// Replaces the Pallas TPU kernel `coded_matmul_kernel`
// (src/repro/kernels/coded_matmul.py, body `_kernel`).  The TPU kernel
// builds each coded stripe in VMEM and multiplies it at once: there the
// coded shards never reach HBM.  Here they do, once.  A GPU block holds
// one output tile, so building the stripe per block re-reads all J blocks
// of A for every one of the n_out / 128 column tiles: ~880 GB of L2 reads
// per full-width round (J = 27, N = 30, 148 column tiles of 198 MB).
// Writing the coded shards once costs ~0.44 GB of device memory traffic
// instead (the two split planes below), and lets the product run on the
// tensor cores.
//
// Bound on the H100: operations.  The worker products are
// 2 * N * blk * d * n_out FLOP (2.09 TFLOP at the full qwen2-7b FFN width,
// 31 ms at the 67 TFLOP/s float32 CUDA-core rate).  The reference computes
// them at float32 accuracy (Precision.HIGHEST), so a plain TF32 product is
// not a port of it.  They run here as an error-compensated 3xTF32 product
// on the tensor cores: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi),
// and a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b (the dropped lo_a lo_b and
// the rounding of lo are ~2^-22 of |a b|, below float32's own
// accumulation error over d = 3584).  Three TF32 products at 495 TFLOP/s
// put the floor at ~12.6 ms.
//
// Three passes, one launch of the wrapper:
//  1. encode + split A: one thread per (row i, column d) of the shards
//     computes every worker's coded value sum_j W[n, j] A[j, i, d] as the
//     j-ordered fmaf chain from zero of berrut_combine.cu (so a round that
//     encodes with berrut_combine and then calls this with identity
//     weights, the encrypted round, is bit-identical to this one), and
//     writes its hi and lo planes, (2, M_pad, d_pad) float32 with
//     M = N * blk.  A bfloat16 A is widened: the shards are float32.
//  2. split B: B^T in hi and lo planes, (2, n_pad, d_pad) float32.  TF32
//     wgmma takes both operands K-major only, and B (d, n_out) row-major is
//     MN-major, so the split writes it transposed.  Both splits pad with
//     zeros to the GEMM's tiles, which also keeps every TMA stride 16-byte
//     aligned for ragged shapes (d = 10, n_out = 17).
//  3. the GEMM (M_pad, d_pad) @ (d_pad, n_pad): one block per 128 x 128
//     output tile (grouped so that the blocks in flight share A and B
//     panels in L2), two consumer warpgroups of 64 rows and one producer
//     warp.  The producer streams 32-wide k-slices of both planes of A and
//     B by TMA (3-d maps, 128-byte swizzle) through a ring of kStages
//     stages completing on mbarriers; per slice each warpgroup issues 12
//     wgmma m64n128k8 tf32 -> f32 (lo.hi, hi.lo, hi.hi for each k8 step)
//     into a fresh accumulator and adds it into a second float32
//     accumulator in registers: the tensor cores' internal accumulation
//     never spans more than 32 terms of d.  The store is masked to
//     (N * blk, n_out), in A's dtype.
//
// The wrapper allocates the planes (torch.empty) at the extents that
// coded_matmul_scratch returns; this file allocates nothing.  Plain C interface (bound with ctypes): the launch returns the
// first CUDA error (or the tensor-map error) so the Python wrapper can
// raise on a refused launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::desc_sw128;

constexpr int kBM = 128;       // GEMM rows per block: two warpgroups
constexpr int kBN = 128;       // GEMM columns per block
constexpr int kBK = 32;        // k-slice: 32 float32 = one 128-byte row
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kGroupM = 16;    // row tiles per raster group
constexpr uint32_t kPlaneTile = 128 * 128;          // 128 rows x 32 f32
constexpr uint32_t kStageBytes = 4 * kPlaneTile;    // A hi, A lo, B hi, B lo
constexpr uint32_t kBarsOffset = kStages * kStageBytes;
constexpr uint32_t kSmemBytes = kBarsOffset + 16 * kStages + 1024;
constexpr int kEncodeThreads = 256;
constexpr int kWorkerChunk = 32;  // coded rows one encode thread carries

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round to nearest (ties away) at TF32's 10 mantissa bits; the low 13 bits
// become 0, which is all the tensor cores read of a tf32 operand
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return __uint_as_float(u);
}

// ---- pass 1: encode + split A ----------------------------------------
template <typename TA>
__global__ void __launch_bounds__(kEncodeThreads)
encode_split_kernel(const float* __restrict__ w, const TA* __restrict__ a,
                    float* __restrict__ hi, int n_workers, int j, int blk,
                    int d, int d_pad, int64_t plane) {
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * kEncodeThreads + threadIdx.x;
  if (e >= static_cast<int64_t>(blk) * d_pad) return;
  const int i = static_cast<int>(e / d_pad);
  const int dc = static_cast<int>(e % d_pad);
  const bool in = dc < d;
  float* lo = hi + plane;
  for (int n0 = 0; n0 < n_workers; n0 += kWorkerChunk) {
    float acc[kWorkerChunk];
#pragma unroll
    for (int r = 0; r < kWorkerChunk; ++r) acc[r] = 0.f;
    for (int jj = 0; jj < j; ++jj) {
      const float x =
          in ? to_f32(a[(static_cast<int64_t>(jj) * blk + i) * d + dc]) : 0.f;
#pragma unroll
      for (int r = 0; r < kWorkerChunk; ++r) {
        const int n = n0 + r;
        const float wv =
            n < n_workers ? __ldg(w + static_cast<int64_t>(n) * j + jj) : 0.f;
        acc[r] = fmaf(wv, x, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kWorkerChunk; ++r) {
      const int n = n0 + r;
      if (n >= n_workers) break;
      const int64_t at = (static_cast<int64_t>(n) * blk + i) * d_pad + dc;
      const float h = tf32_round(acc[r]);
      hi[at] = h;
      lo[at] = tf32_round(acc[r] - h);
    }
  }
}

// ---- pass 2: split B, transposed -------------------------------------
template <typename TB>
__global__ void __launch_bounds__(256)
split_b_kernel(const TB* __restrict__ b, float* __restrict__ hi, int d,
               int n_out, int d_pad, int64_t plane) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int dd = d0 + r;
    const int kk = k0 + threadIdx.x;
    t[r][threadIdx.x] =
        (dd < d && kk < n_out)
            ? to_f32(b[static_cast<int64_t>(dd) * n_out + kk])
            : 0.f;
  }
  __syncthreads();
  float* lo = hi + plane;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int64_t at = static_cast<int64_t>(k0 + r) * d_pad + d0 +
                       threadIdx.x;
    const float x = t[threadIdx.x][r];
    const float h = tf32_round(x);
    hi[at] = h;
    lo[at] = tf32_round(x - h);
  }
}

// ---- pass 3: the 3xTF32 GEMM -------------------------------------------
__device__ __forceinline__ void store2(float* p, float x0, float x1,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (second) p[1] = x1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[0] = __float2bfloat16(x0);
    if (second) p[1] = __float2bfloat16(x1);
  }
}

template <typename TO>
__global__ void __launch_bounds__(kThreads, 1)
gemm_3xtf32_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map,
                   TO* __restrict__ out, int m, int n_out, int m_tiles,
                   int n_tiles, int k_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kBarsOffset);
  uint64_t* empty = full + kStages;

  // grouped raster: kGroupM row tiles share each column tile in turn
  const int pid = blockIdx.x;
  const int per_group = kGroupM * n_tiles;
  const int first_m = (pid / per_group) * kGroupM;
  const int group_m = min(m_tiles - first_m, kGroupM);
  const int tm = first_m + (pid % per_group) % group_m;
  const int tn = (pid % per_group) / group_m;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- the producer: both planes of A's and B's k-slices, by TMA
    if (lane != 0) return;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      const int f = kt / kStages;
      if (f > 0) hopper::mbar_wait(&empty[s], (f - 1) & 1);
      uint8_t* stage = base + s * kStageBytes;
      hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
      hopper::tma_load_3d(stage, &a_map, &full[s], kt * kBK, tm * kBM, 0);
      hopper::tma_load_3d(stage + 2 * kPlaneTile, &b_map, &full[s], kt * kBK,
                          tn * kBN, 0);
    }
    return;
  }

  // ---- the consumer warpgroups: rows tm * 128 + 64 wg + [0, 64)
  const int wg = warp / 4;
  const uint32_t smem_base = hopper::smem_u32(base);
  float acc[64];
  float sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t a_hi = smem_base + s * kStageBytes + wg * 8192;
    const uint32_t a_lo = a_hi + kPlaneTile;
    const uint32_t b_hi = smem_base + s * kStageBytes + 2 * kPlaneTile;
    const uint32_t b_lo = b_hi + kPlaneTile;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint32_t off = kk * 32;
      hopper::wgmma_m64n128k8_tf32(acc, desc_sw128(a_lo + off, 16, 1024),
                                   desc_sw128(b_hi + off, 16, 1024), kk != 0);
      hopper::wgmma_m64n128k8_tf32(acc, desc_sw128(a_hi + off, 16, 1024),
                                   desc_sw128(b_lo + off, 16, 1024), 1);
      hopper::wgmma_m64n128k8_tf32(acc, desc_sw128(a_hi + off, 16, 1024),
                                   desc_sw128(b_hi + off, 16, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }

  // acc[4 i + e] is row 16 (warp % 4) + lane / 4 + 8 (e / 2) of the
  // warpgroup's 64, column 8 i + 2 (lane % 4) + e % 2
  const int row0 = tm * kBM + 64 * wg + 16 * (warp % 4) + lane / 4;
  const bool even = (n_out % 2) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= m) continue;
    TO* dst = out + static_cast<int64_t>(row) * n_out;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = tn * kBN + 8 * i + 2 * (lane % 4);
      if (col >= n_out) continue;
      const bool second = col + 1 < n_out;
      store2(dst + col, sum[4 * i + 2 * half], sum[4 * i + 2 * half + 1],
             even && second, second);
    }
  }
}

// the split planes' extents {m_pad, d_pad, n_pad}: N * blk, d and n_out
// rounded up to the GEMM's tiles.  False for an empty shape or one past the
// grids' limits.
bool scratch_extents(int n_workers, int blk, int d, int n_out, int64_t* pad) {
  if (n_workers <= 0 || blk <= 0 || d <= 0 || n_out <= 0) return false;
  auto up = [](int64_t x, int64_t t) { return (x + t - 1) / t * t; };
  pad[0] = up(static_cast<int64_t>(n_workers) * blk, kBM);
  pad[1] = up(d, kBK);
  pad[2] = up(n_out, kBN);
  return pad[0] <= 0x7fffffff && pad[2] <= 0x7fffffff &&
         (pad[0] / kBM) * (pad[2] / kBN) <= 0x7fffffff &&
         pad[1] / kBK <= 65535;
}

// 3-d map (d_pad, rows, 2 planes) over float32 planes, boxes of 32 x 128 x 2
int make_plane_map(CUtensorMap* map, const float* planes, int rows,
                   int d_pad) {
  const uint64_t dims[3] = {static_cast<uint64_t>(d_pad),
                            static_cast<uint64_t>(rows), 2};
  const uint64_t strides[2] = {static_cast<uint64_t>(d_pad) * 4,
                               static_cast<uint64_t>(rows) * d_pad * 4};
  const uint32_t box[3] = {kBK, 128, 2};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                               planes, dims, strides, box);
}

template <typename TA, typename TB>
int launch_typed(const float* w, const void* a, const void* b, void* out,
                 float* a_planes, float* b_planes, int n_workers, int j,
                 int blk, int d, int n_out, int m_pad, int d_pad, int n_pad,
                 cudaStream_t stream) {
  const int m = n_workers * blk;
  const int64_t a_plane = static_cast<int64_t>(m_pad) * d_pad;
  const int64_t b_plane = static_cast<int64_t>(n_pad) * d_pad;

  // 1. encode + split A; the padding rows [m, m_pad) are zero
  const int64_t cols = static_cast<int64_t>(blk) * d_pad;
  encode_split_kernel<TA>
      <<<static_cast<unsigned>((cols + kEncodeThreads - 1) / kEncodeThreads),
         kEncodeThreads, 0, stream>>>(w, static_cast<const TA*>(a),
                                      a_planes, n_workers, j, blk, d, d_pad,
                                      a_plane);
  if (m_pad > m) {
    const size_t tail = static_cast<size_t>(m_pad - m) * d_pad * 4;
    cudaError_t err = cudaMemsetAsync(
        a_planes + static_cast<int64_t>(m) * d_pad, 0, tail, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(a_planes + a_plane + static_cast<int64_t>(m) *
                                                      d_pad,
                            0, tail, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 2. split B^T
  split_b_kernel<TB><<<dim3(n_pad / 32, d_pad / 32), dim3(32, 8), 0,
                       stream>>>(static_cast<const TB*>(b), b_planes, d,
                                 n_out, d_pad, b_plane);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 3. the GEMM
  CUtensorMap a_map, b_map;
  int merr = make_plane_map(&a_map, a_planes, m_pad, d_pad);
  if (!merr) merr = make_plane_map(&b_map, b_planes, n_pad, d_pad);
  if (merr) return merr;
  err = cudaFuncSetAttribute(gemm_3xtf32_kernel<TA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = m_pad / kBM;
  const int n_tiles = n_pad / kBN;
  gemm_3xtf32_kernel<TA><<<m_tiles * n_tiles, kThreads, kSmemBytes,
                           stream>>>(a_map, b_map, static_cast<TA*>(out), m,
                                     n_out, m_tiles, n_tiles, d_pad / kBK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// {m_pad, d_pad, n_pad} into pad: the launch's scratch planes are
// a_planes (2, m_pad, d_pad) and b_planes (2, n_pad, d_pad), float32.
// Returns cudaErrorInvalidValue for a shape the launch refuses.
extern "C" int coded_matmul_scratch(int n_workers, int blk, int d, int n_out,
                                    int64_t* pad) {
  return scratch_extents(n_workers, blk, d, n_out, pad)
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

// a_dtype / b_dtype: 0 = float32, 1 = bfloat16.  out has A's dtype.
// a_planes and b_planes: scratch of coded_matmul_scratch's extents.
extern "C" int coded_matmul_launch(const float* w, const void* a,
                                   const void* b, void* out, float* a_planes,
                                   float* b_planes, int n_workers, int j,
                                   int blk, int d, int n_out, int a_dtype,
                                   int b_dtype, void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  int64_t pad[3];
  if (j <= 0 || !scratch_extents(n_workers, blk, d, n_out, pad))
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_pad = static_cast<int>(pad[0]);
  const int d_pad = static_cast<int>(pad[1]);
  const int n_pad = static_cast<int>(pad[2]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a_dtype * 2 + b_dtype) {
    case 0:
      return launch_typed<float, float>(w, a, b, out, a_planes, b_planes,
                                        n_workers, j, blk, d, n_out, m_pad,
                                        d_pad, n_pad, s);
    case 1:
      return launch_typed<float, __nv_bfloat16>(w, a, b, out, a_planes,
                                                b_planes, n_workers, j, blk,
                                                d, n_out, m_pad, d_pad,
                                                n_pad, s);
    case 2:
      return launch_typed<__nv_bfloat16, float>(w, a, b, out, a_planes,
                                                b_planes, n_workers, j, blk,
                                                d, n_out, m_pad, d_pad,
                                                n_pad, s);
    case 3:
      return launch_typed<__nv_bfloat16, __nv_bfloat16>(
          w, a, b, out, a_planes, b_planes, n_workers, j, blk, d, n_out,
          m_pad, d_pad, n_pad, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
