// berrut_combine: out[q, m] = sum_j W[q, j] * B[j, m]
//
// Replaces the Pallas TPU kernel `berrut_encode_kernel`
// (src/repro/kernels/berrut_encode.py, body `_kernel`).  It is the SPACDC
// encode / decode / prefix-decode contraction: a skinny coding matrix W
// (Q x J, float32; Q and J usually below 64, Q = E * K up to ~720 for the
// prefix decode, J up to a few hundred for the gradient code) times a very
// wide payload B (J x M, float32 or bfloat16, M up to ~10^7).
//
// Bound on the H100: device-memory bytes.  Each payload element is read
// once and each output written once, elt * (J + Q) * M bytes, against Q
// FMAs per payload element (the full-width decode: 2.1 GB, 0.63 ms at
// 3.35 TB/s, against 14 GFLOP, 0.21 ms at the f32 CUDA-core rate).  The
// FMAs still need about a third of the SMs' float32 rate at full
// bandwidth, so the loads must stream while enough warps issue FMAs.
//
// The sum is the j-ordered fmaf chain from 0.0f: for every output,
// acc = fmaf(W[q, j], B[j, m], acc) for j = 0 .. J-1 in order, in float32,
// a bfloat16 payload widened exactly and the output rounded once (round to
// nearest even).  coded_matmul.cu's encode pass computes each coded value
// by the same chain, so an encrypted round (encode here, then coded_matmul
// with identity weights) is bit-identical to the plain kernel round.  That
// forbids the tensor cores (TF32 / bf16 wgmma round the operands and
// reorder the sum), any split of J over blocks or warps, and any tree
// reduction: the design keeps each output's whole chain in one thread.
//
// Design (one launch, nothing allocated):
//  * a persistent grid, one block per SM, each block walking 512-column
//    tiles of the payload (tile = blockIdx.x, + gridDim.x, ...);
//  * a producer warp streams each tile's J rows, in slabs of at most 32
//    rows, into a ring of 2-4 shared-memory stages that complete on
//    mbarriers (transaction bytes).  A stage is two 256-column halves of
//    the slab.  When the payload's address and row stride are 16-byte
//    aligned (M = 0 mod 4 for float32, 0 mod 8 for bfloat16), one lane
//    loads each half as a box of a 2-d TMA tensor map over (J, M), no
//    swizzle, zero fill past M and J.  Otherwise (an odd M, a view at an
//    offset: TMA refuses such a map) each lane issues bulk copies
//    (cp.async.bulk) of the 16-byte aligned bytes around a half-row
//    segment; the staged half-row then starts at its row's byte shift
//    inside 16 bytes of room, and the consumers read it at that shift.
//    The host chooses from the pointer and M alone (load_path below;
//    berrut_encode.load_path mirrors it);
//  * eight consumer warps in two row groups: a thread owns 4 adjacent
//    columns of the tile and RT rows of a chunk of 2 RT output rows (RT in
//    4, 8, 12, 16: 4 RT float32 sums in registers), reads the staged tile
//    as 16-byte (8 for bfloat16) vectors (two, and a funnel shift, for a
//    shifted row) and W as broadcast 16-byte reads of a transposed copy
//    in shared memory, and runs the chain;
//  * W is staged once per block when all of it fits beside the ring (every
//    shape the port's paths use, the 720 x 30 prefix decode included);
//    otherwise the chunk in use is restaged as the walk moves on;
//  * Q above 2 RT = 32 rows walks its row chunks over the staged tile, so
//    the payload crosses the memory bus once.  J above one slab continues
//    the chain in registers across the tile's slabs, in order; Q above 32
//    together with J above 32 walks the slabs once per row chunk;
//  * the stage is released as soon as its last row chunk has read it, and
//    the sums are stored with streaming 16-byte (8 for bfloat16) stores
//    while the next stages load; ragged columns are masked here, rows past
//    J are never chained, and nothing is padded in device memory.
// Its times on the H100, beside its bound and torch.matmul's, are in
// PERF.md.
//
// Plain C interface (bound with ctypes): the launch returns the first CUDA
// error (or the tensor-map error) so the Python wrapper can raise on a
// refused launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kTileCols = 512;             // payload columns per tile
constexpr int kBoxCols = 256;              // a TMA box's most columns
constexpr int kMaxSlab = 32;               // payload rows per stage
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;         // 227 KB, one block's most
constexpr int kLoadTma = 0;                // load_path's answers
constexpr int kLoadBulk = 1;

struct Params {
  const float* w;
  const void* b;
  void* out;
  int64_t m;
  int q, j;
  int js;          // payload rows per stage: min(J, kMaxSlab)
  int nslab;       // stages per tile and row chunk: ceil(J / js)
  int nqc;         // row chunks: ceil(Q / (2 RT))
  int n_tiles;     // ceil(M / kTileCols)
  int stages;      // ring depth
  int w_resident;  // every W chunk stays in shared memory
  int rs;          // a staged half-row's stride in elements
  int shift0;      // byte offset of row 0 within its 16 bytes: b % 16
  int step;        // and how far each further row moves it: M elt % 16
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// this thread's 4 columns of a staged row: p is their 16- (8-) byte
// aligned place in an unshifted row
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16);  // bfloat16 -> float32 is exact
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// the same of a row staged sh bytes in (a bulk copy from a misaligned
// address)
__device__ __forceinline__ void load4(const float* p, int sh, float (&x)[4]) {
  if (sh == 0) {
    load4(p, x);
    return;
  }
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int rw = sh >> 2;  // 1, 2 or 3 words in
#pragma unroll
  for (int c = 0; c < 4; ++c)
    x[c] = rw == 1 ? w[c + 1] : rw == 2 ? w[c + 2] : w[c + 3];
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int sh,
                                      float (&x)[4]) {
  const __nv_bfloat16* q = p + 4 * (sh >> 3);  // whole 8-byte steps
  if ((sh & 7) == 0) {
    load4(q, x);
    return;
  }
  const uint2 a = reinterpret_cast<const uint2*>(q)[0];
  const uint2 b = reinterpret_cast<const uint2*>(q)[1];
  const bool odd = sh & 4;        // one 32-bit word further in
  const int bits = (sh & 2) * 8;  // and half a word
  const uint32_t u0 = odd ? a.y : a.x;
  const uint32_t u1 = odd ? b.x : a.y;
  const uint32_t u2 = odd ? b.y : b.x;
  const uint32_t lo = __funnelshift_r(u0, u1, bits);
  const uint32_t hi = __funnelshift_r(u1, u2, bits);
  x[0] = __uint_as_float(lo << 16);
  x[1] = __uint_as_float(lo & 0xffff0000u);
  x[2] = __uint_as_float(hi << 16);
  x[3] = __uint_as_float(hi & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float (&a)[4], int n,
                                       bool vec) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)  // static indices keep `a` in registers
      if (c < n) p[c] = a[c];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&a)[4],
                                       int n, bool vec) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
    uint2 u;
    memcpy(&u.x, &lo, 4);
    memcpy(&u.y, &hi, 4);
    __stcs(reinterpret_cast<uint2*>(p), u);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) p[c] = __float2bfloat16(a[c]);
  }
}

// the producer warp's bulk fill of one stage: each half-row segment of
// rows [row0, row0 + js) as one copy of the 16-byte aligned bytes around
// it, landing at the start of its staged row (the row's data then begins
// at its byte shift); one lane announces the stage's bytes, then every
// lane issues its copies
template <typename T>
__device__ __forceinline__ void fill_bulk(const Params& p, T* dst,
                                          int64_t col0, int row0,
                                          uint64_t* bar, int lane) {
  constexpr int kElt = static_cast<int>(sizeof(T));
  const int rows = min(p.js, p.j - row0);
  const char* src = static_cast<const char*>(p.b);
  uint32_t bytes[2] = {0, 0};
  const char* from[2] = {nullptr, nullptr};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = lane + 32 * k;  // copy e: half e % 2 of row e / 2
    const int row = e / 2;
    const int64_t c0 = col0 + (e % 2) * kBoxCols;
    if (row < rows && c0 < p.m) {
      const int64_t n = p.m - c0 < kBoxCols ? p.m - c0 : kBoxCols;
      const uintptr_t a = reinterpret_cast<uintptr_t>(
          src + ((row0 + row) * p.m + c0) * kElt);
      const uintptr_t a0 = a & ~uintptr_t(15);
      from[k] = reinterpret_cast<const char*>(a0);
      bytes[k] = static_cast<uint32_t>(
          ((a + n * kElt + 15) & ~uintptr_t(15)) - a0);
    }
  }
  const uint32_t total = __reduce_add_sync(0xffffffffu, bytes[0] + bytes[1]);
  if (lane == 0) hopper::mbar_arrive_expect_tx(bar, total);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = lane + 32 * k;
    if (bytes[k] != 0)
      hopper::bulk_load(dst + ((e % 2) * p.js + e / 2) * p.rs, from[k],
                        bytes[k], bar);
  }
}

// W chunk (row chunk qc, slab sl) into `slot`, transposed: slot[jj][r] =
// W[qc * QC + r, sl * js + jj], zero past Q and J
template <int QC>
__device__ __forceinline__ void stage_w(const Params& p, float* slot, int qc,
                                        int sl) {
  const int n = p.js * QC;
  for (int e = threadIdx.x; e < n; e += kConsumers) {
    const int jj = e / QC;
    const int r = e % QC;
    const int q = qc * QC + r;
    const int j = sl * p.js + jj;
    slot[e] = (q < p.q && j < p.j) ? p.w[static_cast<int64_t>(q) * p.j + j]
                                   : 0.f;
  }
}

// kShifted: the payload comes by bulk copies (load_path's kLoadBulk), so
// a staged row may start at a byte shift
template <typename T, int RT, bool kShifted>
__global__ void __launch_bounds__(kThreads, 1)
berrut_stream_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  constexpr int QC = 2 * RT;  // output rows per chunk: two row groups
  // j steps unrolled: 4 keeps more loads ahead of the FMAs; 2 where 4
  // would spill under the 168 registers that 9 warps leave a thread
  constexpr int kUnroll = RT == 16 || kShifted ? 2 : 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int stage_elems = 2 * p.js * p.rs;  // [half][row][rs]
  T* ring = reinterpret_cast<T*>(base);
  float* w_s = reinterpret_cast<float*>(ring + p.stages * stage_elems);
  const int chunk = p.js * QC;
  const int w_slots = p.w_resident ? p.nqc * p.nslab : 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(w_s + w_slots * chunk);
  uint64_t* empty = full + p.stages;
  // one pass over the slabs holds every row chunk, unless there are
  // several slabs: then each row chunk walks them in its own pass
  const int npass = p.nslab == 1 ? 1 : p.nqc;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- the producer warp (one lane of it for TMA)
    if (!kShifted && lane != 0) return;
    int s = 0, lap = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const int64_t col0 = static_cast<int64_t>(tile) * kTileCols;
      const int boxes = col0 + kBoxCols < p.m ? 2 : 1;
      for (int pass = 0; pass < npass; ++pass) {
        for (int sl = 0; sl < p.nslab; ++sl) {
          if (lap > 0) hopper::mbar_wait(&empty[s], (lap - 1) & 1);
          T* dst = ring + s * stage_elems;
          if (!kShifted) {
            // a box wholly past M is not loaded; one partly past J or M
            // is zero-filled and counts in full
            hopper::mbar_arrive_expect_tx(
                &full[s], boxes * p.js * kBoxCols * sizeof(T));
            for (int h = 0; h < boxes; ++h)
              hopper::tma_load_2d(dst + h * p.js * p.rs, &map, &full[s],
                                  static_cast<int>(col0) + h * kBoxCols,
                                  sl * p.js);
          } else {
            fill_bulk(p, dst, col0, sl * p.js, &full[s], lane);
          }
          if (++s == p.stages) {
            s = 0;
            ++lap;
          }
        }
      }
    }
    return;
  }

  // ---- the consumers: row group g, columns half * 256 + hc .. + 3
  const int g = warp / 4;
  const int ct = tid % 128;
  const int half = ct / 64;
  const int hc = (ct % 64) * 4;
  const bool vec_out = p.m % 4 == 0;  // 16- (8-) byte aligned output rows

  if (p.w_resident) {
    for (int c = 0; c < p.nqc * p.nslab; ++c)
      stage_w<QC>(p, w_s + c * chunk, c / p.nslab, c % p.nslab);
    consumer_sync();
  }
  int w_key = -1;  // the chunk in the single slot, when not resident
  int s = 0;
  uint32_t parity = 0;
  float acc[RT][4];
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int64_t col = static_cast<int64_t>(tile) * kTileCols +
                        half * kBoxCols + hc;
    const int ncols = col >= p.m       ? 0
                      : p.m - col < 4 ? static_cast<int>(p.m - col)
                                      : 4;
    for (int pass = 0; pass < npass; ++pass) {
      for (int sl = 0; sl < p.nslab; ++sl) {
        hopper::mbar_wait(&full[s], parity);
        const T* x_s = ring + s * stage_elems + half * p.js * p.rs + hc;
        const int rows = min(p.js, p.j - sl * p.js);
        const int qc0 = p.nslab == 1 ? 0 : pass;
        const int qc_end = p.nslab == 1 ? p.nqc : pass + 1;
        for (int qc = qc0; qc < qc_end; ++qc) {
          const float* wc = w_s;
          if (p.w_resident) {
            wc += (qc * p.nslab + sl) * chunk;
          } else if (qc * p.nslab + sl != w_key) {
            consumer_sync();  // every consumer is done with the old chunk
            stage_w<QC>(p, w_s, qc, sl);
            consumer_sync();
            w_key = qc * p.nslab + sl;
          }
          wc += g * RT;
          if (sl == 0) {
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
          }
          // the chain: j ascending, one fmaf per term, nothing reordered
          int sh = (p.shift0 + p.step * (sl * p.js)) & 15;
#pragma unroll(kUnroll)
          for (int jj = 0; jj < rows; ++jj) {
            float x[4];
            if (kShifted) {
              load4(x_s + jj * p.rs, sh, x);
              sh = (sh + p.step) & 15;
            } else {
              load4(x_s + jj * p.rs, x);
            }
#pragma unroll
            for (int r4 = 0; r4 < RT / 4; ++r4) {
              const float4 wv =
                  *reinterpret_cast<const float4*>(wc + jj * QC + 4 * r4);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[4 * r4 + 0][c] = fmaf(wv.x, x[c], acc[4 * r4 + 0][c]);
                acc[4 * r4 + 1][c] = fmaf(wv.y, x[c], acc[4 * r4 + 1][c]);
                acc[4 * r4 + 2][c] = fmaf(wv.z, x[c], acc[4 * r4 + 2][c]);
                acc[4 * r4 + 3][c] = fmaf(wv.w, x[c], acc[4 * r4 + 3][c]);
              }
            }
          }
          if (qc + 1 == qc_end) {
            // the stage's last reader: hand it back before the stores
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&empty[s]);
          }
          if (sl + 1 == p.nslab && ncols > 0) {
            T* out = static_cast<T*>(p.out) + col;
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const int q = qc * QC + g * RT + r;
              if (q < p.q) store4(out + static_cast<int64_t>(q) * p.m, acc[r],
                                  ncols, vec_out);
            }
          }
        }
        if (++s == p.stages) {
          s = 0;
          parity ^= 1;
        }
      }
    }
  }
}

// The payload's load path: kLoadTma when the address and the row stride
// are 16-byte aligned (and the columns fit TMA's int32 coordinates), else
// kLoadBulk.
int load_path(const void* b, int64_t m, int elt) {
  const bool aligned = reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       (m * elt) % 16 == 0;
  return aligned && m <= 0x7fffffff - kTileCols ? kLoadTma : kLoadBulk;
}

// the row chunk's rows per thread for Q output rows
int rows_per_thread(int q) {
  return q <= 8 ? 4 : q <= 16 ? 8 : q <= 24 ? 12 : 16;
}

template <typename T, int RT, bool kShifted>
int launch_kernel(const float* w, const void* b, void* out, int q, int j,
              int64_t m, cudaStream_t stream) {
  constexpr int kElt = static_cast<int>(sizeof(T));
  Params p;
  p.w = w;
  p.b = b;
  p.out = out;
  p.m = m;
  p.q = q;
  p.j = j;
  p.js = j < kMaxSlab ? j : kMaxSlab;
  p.nslab = (j + p.js - 1) / p.js;
  p.nqc = (q + 2 * RT - 1) / (2 * RT);
  const int64_t n_tiles = (m + kTileCols - 1) / kTileCols;
  if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = static_cast<int>(n_tiles);
  // a bulk-copied row keeps its misalignment, so its staged half-rows get
  // 16 bytes of room
  p.rs = kBoxCols + (kShifted ? 16 / kElt : 0);
  p.shift0 = static_cast<int>(reinterpret_cast<uintptr_t>(b) % 16);
  p.step = static_cast<int>((m * kElt) % 16);

  // the ring's depth and W's residence: the deepest ring beside all of W,
  // else the deepest beside one chunk of it
  const int64_t stage_bytes = 2LL * p.js * p.rs * kElt;
  const int64_t chunk_bytes = 4LL * p.js * 2 * RT;
  const int64_t all_chunks = static_cast<int64_t>(p.nqc) * p.nslab;
  auto smem = [&](int stages, int64_t chunks) {
    return 128 + stages * stage_bytes + chunks * chunk_bytes + 16 * stages;
  };
  p.stages = 0;
  for (int resident = 1; resident >= 0 && p.stages == 0; --resident)
    for (int st = kMaxStages; st >= 2; --st)
      if (smem(st, resident ? all_chunks : 1) <= kSmemLimit) {
        p.stages = st;
        p.w_resident = resident;
        break;
      }
  if (p.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem_bytes =
      static_cast<int>(smem(p.stages, p.w_resident ? all_chunks : 1));

  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (!kShifted) {
    const uint64_t dims[2] = {static_cast<uint64_t>(m),
                              static_cast<uint64_t>(j)};
    const uint64_t strides[1] = {static_cast<uint64_t>(m) * kElt};
    const uint32_t box[2] = {kBoxCols, static_cast<uint32_t>(p.js)};
    const int merr = hopper_host::make_map(
        &map,
        kElt == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        2, b, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (merr) return merr;
  }

  // per device: the SM count, and the raised shared-memory limit of this
  // instantiation (set once, before its first launch there)
  static int sm_count[64];
  static bool smem_raised[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!smem_raised[dev]) {
    err = cudaFuncSetAttribute(berrut_stream_kernel<T, RT, kShifted>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_raised[dev] = true;
  }
  const int grid = p.n_tiles < sm_count[dev] ? p.n_tiles : sm_count[dev];
  berrut_stream_kernel<T, RT, kShifted>
      <<<grid, kThreads, smem_bytes, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kShifted>
int launch_rows(const float* w, const void* b, void* out, int q, int j,
                int64_t m, cudaStream_t stream) {
  switch (rows_per_thread(q)) {
    case 4:
      return launch_kernel<T, 4, kShifted>(w, b, out, q, j, m, stream);
    case 8:
      return launch_kernel<T, 8, kShifted>(w, b, out, q, j, m, stream);
    case 12:
      return launch_kernel<T, 12, kShifted>(w, b, out, q, j, m, stream);
    default:
      return launch_kernel<T, 16, kShifted>(w, b, out, q, j, m, stream);
  }
}

template <typename T>
int launch_typed(const float* w, const void* b, void* out, int q, int j,
                 int64_t m, cudaStream_t stream) {
  if (load_path(b, m, sizeof(T)) == kLoadTma)
    return launch_rows<T, false>(w, b, out, q, j, m, stream);
  return launch_rows<T, true>(w, b, out, q, j, m, stream);
}

}  // namespace

// The load path a launch takes for payload b with M columns: 0 for TMA,
// 1 for bulk copies.  dtype as below.
extern "C" int berrut_combine_load_path(const void* b, int64_t m, int dtype) {
  return load_path(b, m, dtype == 0 ? 4 : 2);
}

// dtype: 0 = float32, 1 = bfloat16 (payload and output).
extern "C" int berrut_combine_launch(const float* w, const void* b, void* out,
                                     int q, int j, int64_t m, int dtype,
                                     void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (q <= 0 || j <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(w, b, out, q, j, m, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(w, b, out, q, j, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
