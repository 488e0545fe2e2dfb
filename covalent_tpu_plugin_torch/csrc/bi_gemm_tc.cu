// Batch-invariant matrix product on the tensor cores, for the serving paths'
// 16-bit operands.
//
//   C[z, m, n] = sum_k A[z, m, k] * W[z, n, k]      (A, W bf16; C f32 or bf16)
//
// with z up to three batch levels and every operand addressed through
// element strides, k contiguous in A and in W: the dense products (q, k, v,
// o, the MLP's wi and wo; Z = 1, W the [N, K] weight), the lm_head (bf16
// features, f32 logits) and the decode attention's scores (q . k over the
// head dim, the keys read in place in the KV cache, batch (b, kv head,
// group)).  The mix, whose cache operand is k-major, has its own kernel
// (bi_gemm_mix.cu); f32 operands take the CUDA-core kernel (bi_gemm.cu).
//
// No Pallas kernel of the reference computes this: the JAX package leaves
// these products to XLA (covalent_tpu_plugin/models/transformer.py:467, 496
// and its dense layers).  What the kernel is for is the serving contract of
// the reference engine: a row computes exactly what it computes at batch 1,
// whatever shares its batch.  The order of summation is bi_mma.cuh's, a
// function of K alone: mma.sync.m16n8k16 in every tile, 64-value k groups
// in order through one fixed slot permutation, 256-value segments each
// summed from zeros and added in order.
//
// Two tile configurations, picked by the wrapper from M, N and the batch
// (ops/_kernels.py: plan_bi_gemm), one order:
//
// - skinny (the decode step, M of 1 to 16 a tile): reading W bounds it (the
//   MLP's wi is 4.7 MB, 1.4 us at 3.35 TB/s), so the work is cut fine
//   enough to keep the whole weight in flight: a block owns 8 x NT columns
//   of one 16-row tile, and its warps split K by segment.  Each warp loads
//   its segment's A and W runs straight from global memory into mma
//   fragments with 16-byte loads (the slot permutation makes a thread's k
//   values contiguous), chains its segment, and parks the partial in shared
//   memory; warp `tile` then adds the partials of its columns in segment
//   order.  No workspace, no second pass, no atomics.
// - wide (the admission wave and the prefill tier: more than 16 rows and
//   at least 48 tiles of 64 x 128): operations bound it.  A block owns a
//   64 x 128 tile, four warps of 64 x 32, a three-stage cp.async ring of
//   64-deep k groups in padded shared memory (144-byte rows: the 16-byte
//   fragment reads hit 32 distinct banks), and keeps a segment accumulator
//   beside the running total in registers (224-242 of them a thread: the
//   price of the fixed order, which caps the warp tile).

#include "bi_mma.cuh"

namespace bitc {

using bimma::Geometry;
using bimma::K_GROUP;
using bimma::PITCH;
using bimma::SEG_GROUPS;
using bimma::SEG_K;
using bf16 = __nv_bfloat16;

constexpr int SKINNY_MAX_WARPS = 16;

// grid (ceil(M / 16), ceil(N / (8 nt)), Z), 32 * nt * rs threads.  Warp w
// takes column tile w % nt and, in each round of rs segments, segment
// round + w / nt.
template <typename TC>
__global__ void __launch_bounds__(32 * SKINNY_MAX_WARPS)
    bi_gemm_tc_skinny(const bf16* __restrict__ A, const bf16* __restrict__ W, TC* __restrict__ C,
                      Geometry g, int nt, int rs) {
  __shared__ __align__(16) float part[SKINNY_MAX_WARPS][32][4];
  const bf16* a = bimma::at_batch(A, g.sa, g);
  const bf16* w = bimma::at_batch(W, g.sw, g);
  TC* c = bimma::at_batch(C, g.sc, g);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / 4, t = lane % 4;
  const int tile = warp % nt, sub = warp / nt;
  const int64_t m0 = (int64_t)blockIdx.x * 16;
  const int64_t col0 = (int64_t)blockIdx.y * 8 * nt + tile * 8;
  const int64_t row_n = col0 + gi;  // the W row (output column) this thread loads
  const bool ok_n = row_n < g.n, ok0 = m0 + gi < g.m, ok1 = m0 + gi + 8 < g.m;
  const bool two_halves = m0 + 8 < g.m;  // warp-uniform: rows 8..15 of the tile exist
  const bf16* w_row = w + row_n * g.sw[3];
  const bf16* a_row0 = a + (m0 + gi) * g.sa[3];
  const bf16* a_row1 = a + (m0 + gi + 8) * g.sa[3];
  const int64_t nseg = bimma::segments(g.k);

  float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t round = 0; round < nseg; round += rs) {
    const int64_t seg = round + sub;
    if (seg < nseg) {
      const int64_t kseg = seg * SEG_K;
      // The whole segment's runs in flight at once: 8 of W, 8 or 16 of A.
      uint4 wv[SEG_GROUPS][2], lo[SEG_GROUPS][2], hi[SEG_GROUPS][2];
#pragma unroll
      for (int gr = 0; gr < SEG_GROUPS; ++gr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t k = kseg + gr * K_GROUP + 16 * t + 8 * h;
          const bool ok_k = k < g.k;  // K % 8 == 0: a run is wholly in or out
          wv[gr][h] = bimma::ldg16(w_row + k, ok_n && ok_k);
          lo[gr][h] = bimma::ldg16(a_row0 + k, ok0 && ok_k);
          hi[gr][h] = two_halves ? bimma::ldg16(a_row1 + k, ok1 && ok_k)
                                 : make_uint4(0u, 0u, 0u, 0u);
        }
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int gr = 0; gr < SEG_GROUPS; ++gr) {
        if (kseg + gr * K_GROUP >= g.k) break;  // the wide tiles' loop ends at K too
#pragma unroll
        for (int h = 0; h < 2; ++h) bimma::mma_pair(acc, lo[gr][h], hi[gr][h], wv[gr][h]);
      }
      *reinterpret_cast<float4*>(part[warp][lane]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    if (warp < nt) {  // sub == 0: this warp folds its tile's partials in segment order
      for (int s = 0; s < rs && round + s < nseg; ++s) {
        const float4 p = *reinterpret_cast<const float4*>(part[s * nt + warp][lane]);
        total[0] += p.x;
        total[1] += p.y;
        total[2] += p.z;
        total[3] += p.w;
      }
    }
    __syncthreads();
  }
  if (warp < nt) {
    bimma::store2(c, g, m0 + gi, col0 + 2 * t, total[0], total[1]);
    bimma::store2(c, g, m0 + gi + 8, col0 + 2 * t, total[2], total[3]);
  }
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? 16 : 0;  // 0: the 16 bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The wide tile: a 64 x 128 block of four warps, each 64 x 32 outputs (TM x
// TN = 4 x 4 mma tiles of 16 x 8), and a ring of STAGES k groups.  Tried on
// the H100 beside it, all bit-equal: 128 x 128 blocks of eight such warps,
// 32 x 32 warp tiles in 128 x 64, 64 x 128 and 128 x 128 blocks, four
// stages; none faster by more than a few per cent, most slower.
constexpr int TM = 4, TN = 4, WARPS_N = 4, STAGES = 3;
constexpr int BM = TM * 16, BN = WARPS_N * TN * 8, WIDE_THREADS = 32 * WARPS_N;
constexpr int WIDE_SMEM = STAGES * (BM + BN) * PITCH * 2;  // 82944 bytes

// grid (ceil(M / 64), ceil(N / 128), Z), 128 threads, two blocks an SM.
template <typename TC>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
    bi_gemm_tc_wide(const bf16* __restrict__ A, const bf16* __restrict__ W, TC* __restrict__ C,
                    Geometry g) {
  constexpr int THREADS = WIDE_THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [stage][BM][PITCH]
  bf16* Ws = As + STAGES * BM * PITCH;       // [stage][BN][PITCH]
  const bf16* a = bimma::at_batch(A, g.sa, g);
  const bf16* w = bimma::at_batch(W, g.sw, g);
  TC* c = bimma::at_batch(C, g.sc, g);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / 4, t = lane % 4;
  const int64_t m0 = (int64_t)blockIdx.x * BM, n0 = (int64_t)blockIdx.y * BN;
  const int64_t ngroups = bimma::groups(g.k);

  auto load_group = [&](int stage, int64_t grp) {
    const int64_t k0 = grp * K_GROUP;
    bf16* as = As + stage * BM * PITCH;
    bf16* ws = Ws + stage * BN * PITCH;
#pragma unroll
    for (int it = 0; it < BM * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i / 8, run = i % 8;
      const int64_t row = m0 + r, k = k0 + 8 * run;
      const bool ok = row < g.m && k < g.k;
      cp_async16(as + r * PITCH + 8 * run, ok ? a + row * g.sa[3] + k : a, ok);
    }
#pragma unroll
    for (int it = 0; it < BN * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i / 8, run = i % 8;
      const int64_t row = n0 + r, k = k0 + 8 * run;
      const bool ok = row < g.n && k < g.k;
      cp_async16(ws + r * PITCH + 8 * run, ok ? w + row * g.sw[3] + k : w, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ngroups) load_group(s, s);
    cp_async_commit();
  }

  float acc[TM][TN][4], total[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = total[i][j][e] = 0.0f;

  for (int64_t grp = 0; grp < ngroups; ++grp) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the group has landed; every warp is done with the stage refilled next
    const int64_t next = grp + STAGES - 1;
    if (next < ngroups) load_group((int)(next % STAGES), next);
    cp_async_commit();

    const int stage = (int)(grp % STAGES);
    const bf16* as = As + stage * BM * PITCH + gi * PITCH + 16 * t;
    const bf16* ws = Ws + stage * BN * PITCH + (warp * TN * 8 + gi) * PITCH + 16 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 wv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = bimma::lds16(ws + j * 8 * PITCH + 8 * h);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const uint4 lo = bimma::lds16(as + i * 16 * PITCH + 8 * h);
        const uint4 hi = bimma::lds16(as + (i * 16 + 8) * PITCH + 8 * h);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bimma::mma(acc[i][j], lo.x, hi.x, lo.y, hi.y, wv[j].x, wv[j].y);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bimma::mma(acc[i][j], lo.z, hi.z, lo.w, hi.w, wv[j].z, wv[j].w);
      }
    }
    if ((grp + 1) % SEG_GROUPS == 0 || grp + 1 == ngroups) {  // a segment ends
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[i][j][e] += acc[i][j][e];
            acc[i][j][e] = 0.0f;
          }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + i * 16 + gi;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t n = n0 + warp * TN * 8 + j * 8 + 2 * t;
      bimma::store2(c, g, m, n, total[i][j][0], total[i][j][1]);
      bimma::store2(c, g, m + 8, n, total[i][j][2], total[i][j][3]);
    }
  }
}

template <typename TC>
cudaError_t run_wide(const bf16* A, const bf16* W, TC* C, int64_t Z, const Geometry& g,
                     cudaStream_t s) {
  // once per instantiation: above 48 KB, dynamic shared memory needs the opt-in
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      bi_gemm_tc_wide<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((unsigned)((g.m + BM - 1) / BM), (unsigned)((g.n + BN - 1) / BN), (unsigned)Z);
  bi_gemm_tc_wide<TC><<<grid, WIDE_THREADS, WIDE_SMEM, s>>>(A, W, C, g);
  return cudaGetLastError();
}

enum Config { kSkinny = 0, kWide = 1 };

template <typename TC>
cudaError_t run(int config, int nt, int rs, const void* Ap, const void* Wp, void* Cp, int64_t Z,
                const Geometry& g, cudaStream_t s) {
  const bf16* A = static_cast<const bf16*>(Ap);
  const bf16* W = static_cast<const bf16*>(Wp);
  TC* C = static_cast<TC*>(Cp);
  switch (config) {
    case kSkinny: {
      if (nt < 1 || rs < 1 || nt * rs > SKINNY_MAX_WARPS) return cudaErrorInvalidValue;
      const int64_t ny = (g.n + 8 * nt - 1) / (8 * nt);
      if (ny > 65535) return cudaErrorInvalidValue;
      const dim3 grid((unsigned)((g.m + 15) / 16), (unsigned)ny, (unsigned)Z);
      bi_gemm_tc_skinny<TC><<<grid, 32 * nt * rs, 0, s>>>(A, W, C, g, nt, rs);
      return cudaGetLastError();
    }
    case kWide: return run_wide<TC>(A, W, C, Z, g, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace bitc

// sizes: {z1, z2, z3, M, N, K}; strides: A (z1, z2, z3, m, k), W (z1, z2,
// z3, n, k), C (z1, z2, z3, m, n), 15 values in elements; A and W bf16
// with k stride 1, 16-byte aligned rows, K % 8 == 0 (the wrapper copies
// operands off them onto them).
// config: 0 skinny (nt column tiles of 8, rs segments a round), 1 wide.  seg_k must equal the kernel's segment (256): the
// wrapper's plan and the kernel agree on the order or nothing launches.
// c_dtype: 0 f32, 2 bf16.  Returns the launch's CUDA error, 0 if none.
extern "C" int bi_gemm_tc(const void* A, const void* W, void* C, int c_dtype,
                          const int64_t* sizes, const int64_t* strides, int config, int nt,
                          int rs, int seg_k, void* stream) {
  const bimma::Geometry g = bimma::geometry(sizes, strides);
  const int64_t Z = sizes[0] * sizes[1] * sizes[2];
  if (seg_k != bimma::SEG_K || Z < 1 || Z > 65535 || g.m < 1 || g.n < 1 || g.k < 1 ||
      g.k % 8 != 0 || g.sa[4] != 1 || g.sw[4] != 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (c_dtype) {
    case bimma::kF32: return (int)bitc::run<float>(config, nt, rs, A, W, C, Z, g, s);
    case bimma::kBF16: return (int)bitc::run<__nv_bfloat16>(config, nt, rs, A, W, C, Z, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
