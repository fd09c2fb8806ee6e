// mask_add: out = (payload +/- mask) mod q over little-endian uint32 limbs,
// the MEA-ECC encrypt (add) / decrypt (subtract) of every wire.
//
//   payload (M, L)  field elements < q, row-major, L limbs each
//   mask    (G, L)  G mask rows spread evenly over the payload rows: payload
//                   row m uses mask row m / (M / G).  G = M is a full mask
//                   (stream mode), G = the channel count one mask per
//                   channel (paper mode's Psi), G = 1 one scalar for all.
//   out     (M, L)
//   q               the modulus limbs, a kernel argument (L <= 16)
//
// Replaces the Pallas TPU kernel `mask_add_kernel`
// (src/repro/kernels/mask_add.py, body `_kernel`).  The arithmetic is the
// same: a carry (borrow) chain over the L limbs; then `fix` = carry out or
// sum >= q (the borrow out); then a second chain that subtracts q (adds q
// back) where `fix` holds.  Both operands are < q, so one correction
// suffices.
//
// Bound on the H100: device-memory bytes.  Each element reads 2 * 4L bytes
// (less where mask rows are shared) and writes 4L, against ~6L integer
// operations: 3 * 32 bytes per secp256k1 element, so the full-width wire-back
// (M = 290,979,840) moves 27.9 GB, ~8.3 ms at 3.35 TB/s.
//
// Design:
//  * the (M, L) row-major layout as it is.  The TPU kernel transposed to
//    limb planes so that limbs fill its sublanes; on a GPU that transpose is
//    one more pass over device memory and buys nothing;
//  * one thread per field element, its L limbs loaded as L / 4 16-byte
//    vector loads (when L % 4 == 0 and the pointers are 16-byte aligned,
//    else word by word) and kept in registers through both chains.
//    Neighbouring threads read neighbouring 32-byte rows, so a warp's loads
//    cover whole cache lines between its two vector loads;
//  * the chains run in 64-bit adds: the carry is bit 32 of the sum, the
//    borrow bit 63 of the difference, so no wraparound compares are needed;
//  * ragged M needs no padding: threads past the last row return.
//
// Plain C interface (bound with ctypes): every launch returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLimbs = 16;

struct QLimbs {
  uint32_t v[kMaxLimbs];
};

template <int L, bool kVec>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p,
                                         uint32_t (&r)[L]) {
  if constexpr (kVec) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < L / 4; ++k) {
      const uint4 x = __ldg(v + k);
      r[4 * k] = x.x;
      r[4 * k + 1] = x.y;
      r[4 * k + 2] = x.z;
      r[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < L; ++k) r[k] = __ldg(p + k);
  }
}

template <int L, bool kVec>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ p,
                                          const uint32_t (&r)[L]) {
  if constexpr (kVec) {
    uint4* v = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int k = 0; k < L / 4; ++k)
      v[k] = make_uint4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < L; ++k) p[k] = r[k];
  }
}

template <int L, bool kVec>
__global__ void __launch_bounds__(kThreads)
mask_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, int64_t m, int64_t rows_per_mask,
                QLimbs q, int subtract) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= m) return;
  const int64_t mrow = rows_per_mask == 1 ? row : row / rows_per_mask;
  uint32_t x[L], y[L];
  load_row<L, kVec>(a + row * L, x);
  load_row<L, kVec>(b + mrow * L, y);

  if (!subtract) {
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t s = static_cast<uint64_t>(x[j]) + y[j] + carry;
      x[j] = static_cast<uint32_t>(s);
      carry = static_cast<uint32_t>(s >> 32);
    }
    // sum >= q (or it overflowed 2^(32L)): subtract q once
    bool gt = false, eq = true;
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
      gt = gt || (eq && x[j] > q.v[j]);
      eq = eq && x[j] == q.v[j];
    }
    const bool fix = carry != 0 || gt || eq;
    uint32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t d = static_cast<uint64_t>(x[j]) - q.v[j] - borrow;
      borrow = static_cast<uint32_t>(d >> 63);
      if (fix) x[j] = static_cast<uint32_t>(d);
    }
  } else {
    uint32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t d = static_cast<uint64_t>(x[j]) - y[j] - borrow;
      x[j] = static_cast<uint32_t>(d);
      borrow = static_cast<uint32_t>(d >> 63);
    }
    // the difference went negative: add q back
    const bool fix = borrow != 0;
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t s = static_cast<uint64_t>(x[j]) + q.v[j] + carry;
      carry = static_cast<uint32_t>(s >> 32);
      if (fix) x[j] = static_cast<uint32_t>(s);
    }
  }
  store_row<L, kVec>(out + row * L, x);
}

template <int L>
void launch_limbs(const uint32_t* a, const uint32_t* b, uint32_t* out,
                  int64_t m, int64_t rows_per_mask, const QLimbs& q,
                  int subtract, bool vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kThreads - 1) / kThreads));
  if constexpr (L % 4 == 0) {
    if (vec) {
      mask_add_kernel<L, true><<<grid, kThreads, 0, stream>>>(
          a, b, out, m, rows_per_mask, q, subtract);
      return;
    }
  }
  mask_add_kernel<L, false><<<grid, kThreads, 0, stream>>>(
      a, b, out, m, rows_per_mask, q, subtract);
}

}  // namespace

// q: n_limbs host words of the modulus.  vec: 1 when n_limbs % 4 == 0 and
// all three pointers are 16-byte aligned.
extern "C" int mask_add_launch(const void* a, const void* b, void* out,
                               int64_t m, int n_limbs, int64_t rows_per_mask,
                               const uint32_t* q, int subtract, int vec,
                               void* stream) {
  cudaGetLastError();  // clear any stale error so the return value is ours
  if (m <= 0 || n_limbs <= 0 || n_limbs > kMaxLimbs || rows_per_mask <= 0 ||
      (m + kThreads - 1) / kThreads > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  QLimbs ql{};
  for (int j = 0; j < n_limbs; ++j) ql.v[j] = q[j];
  const uint32_t* at = static_cast<const uint32_t*>(a);
  const uint32_t* bt = static_cast<const uint32_t*>(b);
  uint32_t* ot = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  switch (n_limbs) {
#define MASK_ADD_CASE(L)                                                  \
  case L:                                                                 \
    launch_limbs<L>(at, bt, ot, m, rows_per_mask, ql, subtract, v, s);    \
    break;
    MASK_ADD_CASE(1) MASK_ADD_CASE(2) MASK_ADD_CASE(3) MASK_ADD_CASE(4)
    MASK_ADD_CASE(5) MASK_ADD_CASE(6) MASK_ADD_CASE(7) MASK_ADD_CASE(8)
    MASK_ADD_CASE(9) MASK_ADD_CASE(10) MASK_ADD_CASE(11) MASK_ADD_CASE(12)
    MASK_ADD_CASE(13) MASK_ADD_CASE(14) MASK_ADD_CASE(15) MASK_ADD_CASE(16)
#undef MASK_ADD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
