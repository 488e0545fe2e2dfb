// The order of summation shared by the batch-invariant tensor-core products
// (bi_gemm_tc.cu, bi_gemm_mix.cu), and the pieces both kernels build it from.
//
//   C[z, m, n] = sum_k A[z, m, k] * W[z, n, k]     (A, W bf16; f32 sums)
//
// The order is a function of K alone, never of M, N, the batch count, the
// tile or a row's place in it:
//
// - The product is taken by mma.sync.m16n8k16 (bf16 in, f32 accumulators),
//   one instruction family in every tile configuration.  A tensor core
//   computes each output element from its own row of A, its own column of
//   B and its own accumulator, so the other rows of a tile change no bit.
// - K is read in groups of 64 (K_GROUP), in increasing order; the last is
//   padded with exact zeros.  Inside a group the 64 values feed four mma
//   steps j = 0..3 through a fixed permutation of the k slots: the thread
//   with lane % 4 == t owns k = 16 t .. 16 t + 15 of the group, so a thread
//   reads its A row and its W row as two 16-byte runs, and
//     slots 2t, 2t+1     of step j hold k = 16 t + 4 j + 0, 1
//     slots 2t+8, 2t+9   of step j hold k = 16 t + 4 j + 2, 3.
//   Every kernel feeds the same k to the same slot of the same step.
// - The groups fall into segments of SEG_K = 256 values (four groups).  A
//   segment's partial is one chain of mma steps from zeros; the output is
//   total = 0, then total += partial, segment by segment in increasing
//   order.  A kernel that splits K across warps (the skinny tiles) keeps
//   each segment's chain whole and adds the partials in the same order as a
//   kernel that walks the whole of K in one warp (the wide tiles): the same
//   additions, in the same order, on the same values.
//
// The bf16 output is the f32 total rounded to nearest even, once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bimma {

constexpr int K_GROUP = 64;   // k values of one load group (four mma steps)
constexpr int SEG_K = 256;    // k values of one segment: a chain from zeros
constexpr int SEG_GROUPS = SEG_K / K_GROUP;
constexpr int PITCH = K_GROUP + 8;  // bf16 a shared-memory row: 144 bytes, no bank conflicts

enum Dtype { kF32 = 0, kBF16 = 2 };

// Sizes and element strides, as csrc/bi_gemm.cu: (z1, z2, z3, row, k) for
// A and W, (z1, z2, z3, m, n) for C.
struct Geometry {
  int64_t z2, z3, m, n, k;
  int64_t sa[5];
  int64_t sw[5];
  int64_t sc[5];
};

inline Geometry geometry(const int64_t* sizes, const int64_t* strides) {
  Geometry g;
  g.z2 = sizes[1];
  g.z3 = sizes[2];
  g.m = sizes[3];
  g.n = sizes[4];
  g.k = sizes[5];
  for (int i = 0; i < 5; ++i) {
    g.sa[i] = strides[i];
    g.sw[i] = strides[5 + i];
    g.sc[i] = strides[10 + i];
  }
  return g;
}

__host__ __device__ inline int64_t segments(int64_t k) { return (k + SEG_K - 1) / SEG_K; }
__host__ __device__ inline int64_t groups(int64_t k) { return (k + K_GROUP - 1) / K_GROUP; }

// The batch (z1, z2, z3) of blockIdx.z applied to a base pointer.
template <typename T>
__device__ __forceinline__ T* at_batch(T* base, const int64_t* s, const Geometry& g) {
  const int64_t z = blockIdx.z;
  const int64_t z1 = z / (g.z2 * g.z3), z2 = (z / g.z3) % g.z2, z3 = z % g.z3;
  return base + z1 * s[0] + z2 * s[1] + z3 * s[2];
}

// D += A B for one m16n8k16 step, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The two mma steps 2h and 2h + 1 of a group from one 16-byte run per row:
// `lo` holds k = 16 t + 8 h .. + 7 of A's row lane / 4, `hi` the same of
// row lane / 4 + 8, `w` the same of W's row (the output column) lane / 4.
// Words x, y feed step 2h (slots 2t..2t+1 and 2t+8..2t+9); z, w step 2h+1.
__device__ __forceinline__ void mma_pair(float (&d)[4], const uint4& lo, const uint4& hi,
                                         const uint4& w) {
  mma(d, lo.x, hi.x, lo.y, hi.y, w.x, w.y);
  mma(d, lo.z, hi.z, lo.w, hi.w, w.z, w.w);
}

// A 16-byte run of 8 bf16 from global memory, or zeros.
__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p, bool ok) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (ok) v = __ldg(reinterpret_cast<const uint4*>(p));
  return v;
}

__device__ __forceinline__ uint4 lds16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Writes C[m, n] and C[m, n + 1] (the two columns an accumulator pair
// holds), as one vector store where they are adjacent and aligned.
template <typename TC>
__device__ __forceinline__ void store2(TC* c, const Geometry& g, int64_t m, int64_t n, float v0,
                                       float v1) {
  if (m >= g.m || n >= g.n) return;
  TC* p = c + m * g.sc[3] + n * g.sc[4];
  if (n + 1 < g.n && g.sc[4] == 1 &&
      reinterpret_cast<uintptr_t>(p) % (2 * sizeof(TC)) == 0) {
    if constexpr (sizeof(TC) == 4) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    }
    return;
  }
  p[0] = from_f<TC>(v0);
  if (n + 1 < g.n) p[g.sc[4]] = from_f<TC>(v1);
}

}  // namespace bimma
