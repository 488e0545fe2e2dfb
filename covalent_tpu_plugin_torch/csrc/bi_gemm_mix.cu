// Batch-invariant decode-attention mix on the tensor cores: the
// probabilities times the KV cache's values, the values read transposed.
//
//   C[z, m, n] = sum_k A[z, m, k] * V[z, n, k]      (A, V bf16; C f32 or bf16)
//
// A is the probabilities (batch (b, kv head, group), rows the queries, k
// the cache positions, k contiguous); V is the cache's v seen as [n = head
// dim, k = position]: n contiguous and k strided by kv heads x head dim, so
// a thread cannot read its k values as a 16-byte run the way
// bi_gemm_tc.cu does.  Here each warp reads 64 cache rows of its 16 columns
// with 16-byte loads along n, transposes them through its own patch of
// shared memory (four positions of a column to one 8-byte store), and takes
// its fragments from there.
//
// No Pallas kernel of the reference computes this: the JAX package leaves
// the decode attention's products to XLA
// (covalent_tpu_plugin/models/transformer.py:496).  The kernel exists for
// the serving contract: a row computes exactly what it computes at batch 1.
// Its order of summation is bi_mma.cuh's, a function of K alone (the same
// mma, the same 64-value groups and slot permutation, the same 256-value
// segments added in order), whatever M, N, the batch or the tile.
//
// Reading the cache bounds it at the decode step (one query a row: the
// cache is read once, 6.3 MB for 8 rows x 12 heads x 512 positions x 64,
// 1.9 us at 3.35 TB/s).  So a block owns one 16-row tile and up to 64
// columns of one (b, kv head, group), and its warps split the columns into
// 16-wide slices and K into segments: each warp puts its whole segment's
// loads in flight at once, chains its segment, and parks the partial in
// shared memory; warp `slice` then adds its slice's partials in segment
// order.  A prefill (Q = 128) runs eight 16-row tiles, each reading the
// same cache rows, mostly from L2.

#include "bi_mma.cuh"

namespace bimix {

using bimma::Geometry;
using bimma::K_GROUP;
using bimma::PITCH;
using bimma::SEG_GROUPS;
using bimma::SEG_K;
using bf16 = __nv_bfloat16;

constexpr int MAX_WARPS = 8;
constexpr int SLICE = 16;  // columns of one warp: two n8 mma tiles
constexpr int BLOCK_N = 64;

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// grid (ceil(M / 16), ceil(N / 64), Z), 32 * sb * rs threads: warp w takes
// slice w % sb and, in each round of rs segments, segment round + w / sb.
template <typename TC>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    bi_gemm_mix_kernel(const bf16* __restrict__ A, const bf16* __restrict__ V, TC* __restrict__ C,
                       Geometry g, int sb, int rs) {
  __shared__ __align__(16) uint16_t patch[MAX_WARPS][SLICE][PITCH];  // bf16 bits, [n][k] a warp
  __shared__ __align__(16) float part[MAX_WARPS][32][8];
  const bf16* a = bimma::at_batch(A, g.sa, g);
  const bf16* v = bimma::at_batch(V, g.sw, g);
  TC* c = bimma::at_batch(C, g.sc, g);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / 4, t = lane % 4;
  const int slice = warp % sb, sub = warp / sb;
  const int64_t m0 = (int64_t)blockIdx.x * 16;
  const int64_t col0 = (int64_t)blockIdx.y * BLOCK_N + slice * SLICE;
  const bool ok0 = m0 + gi < g.m, ok1 = m0 + gi + 8 < g.m;
  const bool two_halves = m0 + 8 < g.m;
  const bf16* a_row0 = a + (m0 + gi) * g.sa[3];
  const bf16* a_row1 = a + (m0 + gi + 8) * g.sa[3];
  const int64_t ldv = g.sw[4];  // elements between cache positions
  uint16_t(*mine)[PITCH] = patch[warp];
  const int64_t nseg = bimma::segments(g.k);

  float total[2][4] = {};
  for (int64_t round = 0; round < nseg; round += rs) {
    const int64_t seg = round + sub;
    if (seg < nseg) {
      const int64_t kseg = seg * SEG_K;
      // Lane (quad, run) reads cache rows 4 quad .. 4 quad + 3 of each group,
      // columns col0 + 8 run .. + 7: a row's 32 bytes come from lanes quad
      // and quad + 16.
      const int quad = lane % 16, run = lane / 16;
      const int64_t n = col0 + 8 * run;
      uint4 vv[SEG_GROUPS][4], lo[SEG_GROUPS][2], hi[SEG_GROUPS][2];
#pragma unroll
      for (int gr = 0; gr < SEG_GROUPS; ++gr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t k = kseg + gr * K_GROUP + 4 * quad + i;
          vv[gr][i] = bimma::ldg16(v + n * g.sw[3] + k * ldv, k < g.k && n < g.n);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t k = kseg + gr * K_GROUP + 16 * t + 8 * h;
          const bool ok_k = k < g.k;  // K % 8 == 0: a run is wholly in or out
          lo[gr][h] = bimma::ldg16(a_row0 + k, ok0 && ok_k);
          hi[gr][h] = two_halves ? bimma::ldg16(a_row1 + k, ok1 && ok_k)
                                 : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      float acc[2][4] = {};
#pragma unroll
      for (int gr = 0; gr < SEG_GROUPS; ++gr) {
        if (kseg + gr * K_GROUP >= g.k) break;
        // transpose: patch[n][k] for the group's 64 positions, four k of
        // one column to an 8-byte store
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t w0 = word(vv[gr][0], e / 2), w1 = word(vv[gr][1], e / 2);
          const uint32_t w2 = word(vv[gr][2], e / 2), w3 = word(vv[gr][3], e / 2);
          const uint32_t sel = e % 2 ? 0x7632u : 0x5410u;  // high or low halves
          *reinterpret_cast<uint2*>(&mine[8 * run + e][4 * quad]) =
              make_uint2(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel));
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 wv = *reinterpret_cast<const uint4*>(&mine[8 * j + gi][16 * t + 8 * h]);
            bimma::mma_pair(acc[j], lo[gr][h], hi[gr][h], wv);
          }
        __syncwarp();  // every lane has read the patch before the next group overwrites it
      }
      float4* dst = reinterpret_cast<float4*>(part[warp][lane]);
      dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      dst[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }
    __syncthreads();
    if (warp < sb) {  // sub == 0: this warp folds its slice's partials in segment order
      for (int s = 0; s < rs && round + s < nseg; ++s) {
        const float* p = part[s * sb + warp][lane];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) total[j][e] += p[4 * j + e];
      }
    }
    __syncthreads();
  }
  if (warp < sb) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t n = col0 + 8 * j + 2 * t;
      bimma::store2(c, g, m0 + gi, n, total[j][0], total[j][1]);
      bimma::store2(c, g, m0 + gi + 8, n, total[j][2], total[j][3]);
    }
  }
}

template <typename TC>
cudaError_t run(int sb, int rs, const void* A, const void* V, void* C, int64_t Z,
                const Geometry& g, cudaStream_t s) {
  if (sb < 1 || sb > BLOCK_N / SLICE || rs < 1 || sb * rs > MAX_WARPS)
    return cudaErrorInvalidValue;
  const int64_t ny = (g.n + BLOCK_N - 1) / BLOCK_N;
  if (ny > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((g.m + 15) / 16), (unsigned)ny, (unsigned)Z);
  bi_gemm_mix_kernel<TC><<<grid, 32 * sb * rs, 0, s>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(V), static_cast<TC*>(C), g, sb, rs);
  return cudaGetLastError();
}

}  // namespace bimix

// sizes: {z1, z2, z3, M, N, K}; strides: A (z1, z2, z3, m, k), V (z1, z2,
// z3, n, k), C (z1, z2, z3, m, n), 15 values in elements; A bf16 with k
// stride 1, V bf16 with n stride 1, N and K multiples of 8, 16-byte aligned
// runs (the wrapper copies V off them into W's k-contiguous layout, for
// bi_gemm_tc.cu).  sb slices of 16 columns a block, rs segments
// a round; seg_k must equal the kernel's segment (256).  c_dtype: 0 f32,
// 2 bf16.  Returns the launch's CUDA error, 0 if none.
extern "C" int bi_gemm_mix(const void* A, const void* V, void* C, int c_dtype,
                           const int64_t* sizes, const int64_t* strides, int sb, int rs,
                           int seg_k, void* stream) {
  const bimma::Geometry g = bimma::geometry(sizes, strides);
  const int64_t Z = sizes[0] * sizes[1] * sizes[2];
  if (seg_k != bimma::SEG_K || Z < 1 || Z > 65535 || g.m < 1 || g.n < 1 || g.k < 1 ||
      g.k % 8 != 0 || g.n % 8 != 0 || g.sa[4] != 1 || g.sw[3] != 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (c_dtype) {
    case bimma::kF32: return (int)bimix::run<float>(sb, rs, A, V, C, Z, g, s);
    case bimma::kBF16: return (int)bimix::run<__nv_bfloat16>(sb, rs, A, V, C, Z, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
