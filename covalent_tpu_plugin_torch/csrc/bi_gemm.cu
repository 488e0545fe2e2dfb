// Batch-invariant matrix product for the serving paths, on the CUDA cores:
// the route of every pair with an f32 operand (bf16 pairs take the tensor
// cores, bi_gemm_tc.cu and bi_gemm_mix.cu; ops/_kernels.py: plan_bi_gemm).
//
//   C[z, m, n] = sum_k A[z, m, k] * W[z, n, k]      (f32 accumulation)
//
// with z a batch index of up to three levels (z1, z2, z3) and every operand
// addressed through element strides: the dense layers (Z = 1, W the [N, K]
// weight), the lm_head on f32 features, the MoE's router (f32 features, the
// bf16 router weight), and the decode attention's two products over the KV
// cache of an f32 model (scores = q . k over the head dim, batch (b, kv
// head, group); out = P . v over the cache, v read transposed).
//
// No Pallas kernel of the reference computes this: the JAX package leaves
// these products to XLA.  What the kernel is for is the serving contract of
// the reference engine, a row computes exactly what it computes at batch 1
// (the batch-invariant matmul of Thinking Machines' "Defeating
// Nondeterminism in LLM Inference", 2025).  A library GEMM picks its
// algorithm, tiling and split-K by the problem's shape, so a row's sum is
// taken in an order that depends on how many rows share the call.
//
// The order of summation, a function of K alone (never of M, N, the batch
// count, the tile or a row's place in it):
//
// - Every product is an exact f32 fused multiply-add on the CUDA cores
//   (__fmaf_rn).  bf16 operands are widened to f32 first, which is exact.
//   No TF32, no 3xTF32: both change the function.
// - K falls into segments of SEG_K = 64 values (the plan carries seg_k and
//   the segment count; the last segment is shorter).  A segment's partial
//   is one FMA chain from +0 over its k in increasing order.
// - The output is total = +0, then total += partial, segment by segment in
//   increasing order.  A tile that splits the segments of a column across
//   threads (the skinny tiles) adds the partials in that same order.
// - Zero padding past K (the wide tiles' last k tile) adds exact zeros: a
//   chain that starts at +0 never holds -0, so fma(0, 0, acc) == acc.
// The bf16 output is the f32 total rounded to nearest even, once.
//
// Two tile configurations, picked by the wrapper (plan_bi_gemm), one order:
//
// - skinny (the decode shapes, M <= 16 a tile, and any shape whose wide
//   tiles would leave most of the card idle, such as the router's N of 8):
//   bound by reading W.  A block of 256 threads takes a strip of cw
//   columns of one tile of up to 16 rows and stages those rows of A once,
//   widened to f32, in shared memory; its threads are cw columns x S =
//   256 / cw segment slots.  A thread loads its column's segment of W
//   straight into registers (16-byte runs along k where W is k-contiguous,
//   one element a load otherwise: neighbouring threads read neighbouring
//   columns, so a W read transposed is coalesced), chains it against every
//   row (A read as broadcast float4 from shared memory), and parks the
//   partial in shared memory; slot 0 then adds the S partials of a round in
//   segment order.  Enough strips and slots are taken to cover the card.
// - wide (the admission waves: M 128 and 1024 at the lm_head): bound by the
//   CUDA cores' 67 TFLOP/s.  A 128 x 128 block of 256 threads, 8 x 8
//   outputs a thread, a three-stage ring of 16-deep k tiles in shared
//   memory filled by cp.async (4 elements a copy; any other layout is
//   staged by plain loads), operands kept in their own type and widened
//   when a thread reads its fragment.  A thread keeps a segment
//   accumulator beside each total and restarts it every SEG_K, so its bits
//   are the skinny tiles'.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bi {

constexpr int SEG_K = 64;     // k values of one segment: a chain from +0
constexpr int THREADS = 256;  // threads of a block, both tile kinds

enum Dtype { kF32 = 0, kBF16 = 2 };
enum Config { kSkinny = 0, kWide = 1 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// The two bf16 of a 32-bit word, widened (exact).
__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Sizes and element strides.  Operand strides are ordered (z1, z2, z3,
// row, k) for A and W and (z1, z2, z3, m, n) for C.
struct Geometry {
  int64_t z2, z3, m, n, k;
  int64_t sa[5];
  int64_t sw[5];
  int64_t sc[5];
};

template <typename T>
__device__ __forceinline__ T* at_batch(T* base, const int64_t* s, const Geometry& g) {
  const int64_t z = blockIdx.z;
  const int64_t z1 = z / (g.z2 * g.z3), z2 = (z / g.z3) % g.z2, z3 = z % g.z3;
  return base + z1 * s[0] + z2 * s[1] + z3 * s[2];
}

// How many of `most` elements from here lie before the end, `left` away.
__device__ __forceinline__ int elems_left(int64_t left, int most) {
  return left <= 0 ? 0 : left < most ? (int)left : most;
}

__host__ __device__ inline int64_t segments(int64_t k) { return (k + SEG_K - 1) / SEG_K; }

// Copies 4 elements (16 bytes of f32 or 8 of bf16); `elems` of them are
// read, the rest filled with zeros.
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, int elems) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = elems * (int)sizeof(T);
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// skinny tiles

// One segment of a W row as f32: 64 values from k0, zeros past K.  `vec`:
// the row is k-contiguous with 16-byte aligned runs (checked by the host).
template <typename T>
__device__ __forceinline__ void load_segment(float (&wr)[SEG_K], const T* row, int64_t k0,
                                             int64_t kdim, int64_t k_stride, bool vec) {
  if (vec && k0 + SEG_K <= kdim) {
    if constexpr (sizeof(T) == 4) {
      const float4* p = reinterpret_cast<const float4*>(row + k0);
#pragma unroll
      for (int i = 0; i < SEG_K / 4; ++i) {
        const float4 v = __ldg(p + i);
        wr[4 * i] = v.x;
        wr[4 * i + 1] = v.y;
        wr[4 * i + 2] = v.z;
        wr[4 * i + 3] = v.w;
      }
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(row + k0);
#pragma unroll
      for (int i = 0; i < SEG_K / 8; ++i) {
        const uint4 v = __ldg(p + i);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wr[8 * i + 2 * j] = lo_f(u[j]);
          wr[8 * i + 2 * j + 1] = hi_f(u[j]);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < SEG_K; ++i) {
    const int64_t k = k0 + i;
    wr[i] = k < kdim ? to_f(row[k * k_stride]) : 0.0f;
  }
}

// A's rows [m0, m0 + rows) as f32 into As, [MR][segment][SEG_PITCH]: a
// segment's row starts 4 banks past the one before, so the slots of one
// warp (cw < 32) read A without conflicts.  Zeros past K and past M.
// `vec`: f32, k stride 1, 16-byte runs (cp.async); otherwise plain loads.
constexpr int SEG_PITCH = SEG_K + 4;

template <int MR, typename TA>
__device__ __forceinline__ void stage_a(float* As, const TA* a, const Geometry& g, int64_t m0,
                                        int rows, int nseg, bool vec) {
  constexpr int SEG_RUNS = SEG_K / 4;
  const int runs = nseg * SEG_RUNS;
  for (int i = threadIdx.x; i < MR * runs; i += THREADS) {
    const int r = i / runs, run = i - r * runs, k = 4 * run;
    float* d = As + (r * nseg + run / SEG_RUNS) * SEG_PITCH + 4 * (run % SEG_RUNS);
    const int elems = r < rows ? elems_left(g.k - k, 4) : 0;
    const TA* src = a + (m0 + r) * g.sa[3];
    if constexpr (sizeof(TA) == 4) {
      if (vec) {
        cp_async4(d, elems ? src + k : a, elems);
        continue;
      }
    }
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < elems ? to_f(src[(k + e) * g.sa[4]]) : 0.0f;
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// grid (ceil(M / MR), ceil(N / cw), Z), THREADS threads.  Dynamic shared
// memory: A's MR rows (stage_a), then (S > 1) the partials of a round
// [S][MR][cw].  Thread (slot, col) takes column n0 + col and, in round r,
// segment r * S + slot.
template <int MR, typename TA, typename TW, typename TC>
__global__ void __launch_bounds__(THREADS)
    bi_gemm_fma_skinny(const TA* __restrict__ A, const TW* __restrict__ W, TC* __restrict__ C,
                       Geometry g, int cw, bool a_vec, bool w_vec) {
  extern __shared__ __align__(16) float smem[];
  const int nseg = (int)segments(g.k), row_pitch = nseg * SEG_PITCH;
  float* As = smem;
  float* part = smem + MR * row_pitch;
  const TA* a = at_batch(A, g.sa, g);
  const TW* w = at_batch(W, g.sw, g);
  TC* c = at_batch(C, g.sc, g);

  const int slots = THREADS / cw;
  const int col = threadIdx.x % cw, slot = threadIdx.x / cw;
  const int64_t m0 = (int64_t)blockIdx.x * MR, n = (int64_t)blockIdx.y * cw + col;
  const int rows = elems_left(g.m - m0, MR);
  stage_a<MR>(As, a, g, m0, rows, nseg, a_vec);
  __syncthreads();

  const bool ok_n = n < g.n;
  const TW* w_row = w + n * g.sw[3];
  float total[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) total[r] = 0.0f;

  for (int round = 0; round < nseg; round += slots) {
    const int seg = round + slot;
    float acc[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[r] = 0.0f;
    if (ok_n && seg < nseg) {
      float wr[SEG_K];
      load_segment(wr, w_row, (int64_t)seg * SEG_K, g.k, g.sw[4], w_vec);
      const float* as = As + seg * SEG_PITCH;
#pragma unroll
      for (int kk = 0; kk < SEG_K; kk += 4) {
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(as + r * row_pitch + kk);
          acc[r] = __fmaf_rn(av.x, wr[kk], acc[r]);
          acc[r] = __fmaf_rn(av.y, wr[kk + 1], acc[r]);
          acc[r] = __fmaf_rn(av.z, wr[kk + 2], acc[r]);
          acc[r] = __fmaf_rn(av.w, wr[kk + 3], acc[r]);
        }
      }
    }
    if (slots == 1) {  // block-uniform: one segment a round, this thread's own
#pragma unroll
      for (int r = 0; r < MR; ++r) total[r] = __fadd_rn(total[r], acc[r]);
      continue;
    }
#pragma unroll
    for (int r = 0; r < MR; ++r) part[(slot * MR + r) * cw + col] = acc[r];
    __syncthreads();
    if (slot == 0) {
      for (int s = 0; s < slots && round + s < nseg; ++s)
#pragma unroll
        for (int r = 0; r < MR; ++r) total[r] = __fadd_rn(total[r], part[(s * MR + r) * cw + col]);
    }
    __syncthreads();
  }
  if (slot == 0 && ok_n) {
#pragma unroll
    for (int r = 0; r < MR; ++r)
      if (r < rows) c[(m0 + r) * g.sc[3] + n * g.sc[4]] = from_f<TC>(total[r]);
  }
}

// ---------------------------------------------------------------------------
// wide tiles

constexpr int BM = 128, BN = 128, BK = 16, STAGES = 3;
constexpr int TPITCH = BK + 4;  // elements a row of a stage: f32 80 B, bf16 40 B (no conflicts)
constexpr int RUNS = BK / 4;    // copies of 4 elements a row of a k tile

template <typename TA, typename TW>
constexpr int wide_smem() {
  return STAGES * TPITCH * (BM * (int)sizeof(TA) + BN * (int)sizeof(TW));
}

// Rows [row0, row0 + 128) x k [k0, k0 + BK) of an operand into one stage
// ([row][TPITCH], in the operand's own type), zeros outside it.  `vec`: k
// stride 1 and 16-byte aligned rows (checked by the host): cp.async,
// asynchronous; otherwise plain loads and stores.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* base, int64_t row0, int64_t rows,
                                          int64_t row_stride, int64_t k0, int64_t kdim,
                                          int64_t k_stride, bool vec) {
#pragma unroll
  for (int it = 0; it < BM * RUNS / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS, r = i / RUNS, run = i % RUNS;
    const int64_t row = row0 + r, k = k0 + 4 * run;
    const int elems = row < rows ? elems_left(kdim - k, 4) : 0;
    T* d = dst + r * TPITCH + 4 * run;
    if (vec) {
      cp_async4(d, elems ? base + row * row_stride + k : base, elems);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = e < elems ? base[row * row_stride + (k + e) * k_stride] : from_f<T>(0.0f);
    }
  }
}

// 4 consecutive k of a staged row, widened.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(lo_f(v.x), hi_f(v.x), lo_f(v.y), hi_f(v.y));
}

// grid (ceil(M / BM), ceil(N / BN), Z), THREADS threads.  Thread (ty, tx)
// of the 16 x 16 owns rows ty + 16 i and columns tx + 16 j, i, j < 8.
template <typename TA, typename TW, typename TC>
__global__ void __launch_bounds__(THREADS, 1)
    bi_gemm_fma_wide(const TA* __restrict__ A, const TW* __restrict__ W, TC* __restrict__ C,
                     Geometry g, bool a_vec, bool w_vec) {
  extern __shared__ __align__(16) unsigned char smem_wide[];
  TA* As = reinterpret_cast<TA*>(smem_wide);  // [STAGES][BM][TPITCH]
  TW* Ws = reinterpret_cast<TW*>(smem_wide + STAGES * BM * TPITCH * sizeof(TA));
  const TA* a = at_batch(A, g.sa, g);
  const TW* w = at_batch(W, g.sw, g);
  TC* c = at_batch(C, g.sc, g);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t m0 = (int64_t)blockIdx.x * BM, n0 = (int64_t)blockIdx.y * BN;
  const int64_t ntiles = (g.k + BK - 1) / BK;
  auto load = [&](int stage, int64_t t) {
    load_tile(As + stage * BM * TPITCH, a, m0, g.m, g.sa[3], t * BK, g.k, g.sa[4], a_vec);
    load_tile(Ws + stage * BN * TPITCH, w, n0, g.n, g.sw[3], t * BK, g.k, g.sw[4], w_vec);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }

  float acc[8][8], total[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = total[i][j] = 0.0f;

  for (int64_t t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int64_t next = t + STAGES - 1;
    if (next < ntiles) load((int)(next % STAGES), next);
    cp_async_commit();

    const int stage = (int)(t % STAGES);
    const TA* as = As + stage * BM * TPITCH + ty * TPITCH;
    const TW* ws = Ws + stage * BN * TPITCH + tx * TPITCH;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = lds4(ws + j * 16 * TPITCH + kq);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 av = lds4(as + i * 16 * TPITCH + kq);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = __fmaf_rn(av.x, wv[j].x, acc[i][j]);
          acc[i][j] = __fmaf_rn(av.y, wv[j].y, acc[i][j]);
          acc[i][j] = __fmaf_rn(av.z, wv[j].z, acc[i][j]);
          acc[i][j] = __fmaf_rn(av.w, wv[j].w, acc[i][j]);
        }
      }
    }
    if (((t + 1) * BK) % SEG_K == 0 || t + 1 == ntiles) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          total[i][j] = __fadd_rn(total[i][j], acc[i][j]);
          acc[i][j] = 0.0f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + ty + 16 * i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + tx + 16 * j;
      if (n < g.n) c[m * g.sc[3] + n * g.sc[4]] = from_f<TC>(total[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch

// Skinny tiles' shared memory: A's rows, then the partials where a column's
// segments are split across slots.  The wrapper's planner mirrors it.
inline size_t skinny_smem(int mr, int64_t k, int cw) {
  return (size_t)mr * segments(k) * SEG_PITCH * 4 +
         (THREADS / cw > 1 ? (size_t)mr * THREADS * 4 : 0);
}
constexpr size_t SKINNY_SMEM_MAX = 232448;  // the most dynamic shared memory a block may have

// The operand is read by cp.async / 16-byte loads: k stride 1, the base and
// every other stride on 16-byte boundaries.
inline bool runs_aligned(const void* base, const int64_t* s, int esize) {
  if (s[4] != 1 || reinterpret_cast<uintptr_t>(base) % 16) return false;
  for (int i = 0; i < 4; ++i)
    if ((s[i] * esize) % 16) return false;
  return true;
}

template <int MR, typename TA, typename TW, typename TC>
cudaError_t run_skinny(const TA* A, const TW* W, TC* C, int64_t Z, const Geometry& g, int cw,
                       cudaStream_t s) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      bi_gemm_fma_skinny<MR, TA, TW, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SKINNY_SMEM_MAX);
  if (opt_in != cudaSuccess) return opt_in;
  const size_t smem = skinny_smem(MR, g.k, cw);
  const int64_t ny = (g.n + cw - 1) / cw;
  if (smem > SKINNY_SMEM_MAX || ny > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((g.m + MR - 1) / MR), (unsigned)ny, (unsigned)Z);
  bi_gemm_fma_skinny<MR, TA, TW, TC><<<grid, THREADS, smem, s>>>(
      A, W, C, g, cw, runs_aligned(A, g.sa, sizeof(TA)), runs_aligned(W, g.sw, sizeof(TW)));
  return cudaGetLastError();
}

template <typename TA, typename TW, typename TC>
cudaError_t run(int config, int cw, const void* Ap, const void* Wp, void* Cp, int64_t Z,
                const Geometry& g, cudaStream_t s) {
  const TA* A = static_cast<const TA*>(Ap);
  const TW* W = static_cast<const TW*>(Wp);
  TC* C = static_cast<TC*>(Cp);
  switch (config) {
    case kSkinny: {
      if (cw < 8 || cw > THREADS || THREADS % cw) return cudaErrorInvalidValue;
      if (g.m <= 1) return run_skinny<1>(A, W, C, Z, g, cw, s);
      if (g.m <= 8) return run_skinny<8>(A, W, C, Z, g, cw, s);
      return run_skinny<16>(A, W, C, Z, g, cw, s);
    }
    case kWide: {
      constexpr int smem = wide_smem<TA, TW>();
      static const cudaError_t opt_in = cudaFuncSetAttribute(
          bi_gemm_fma_wide<TA, TW, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (opt_in != cudaSuccess) return opt_in;
      const int64_t ny = (g.n + BN - 1) / BN;
      if (ny > 65535) return cudaErrorInvalidValue;
      const dim3 grid((unsigned)((g.m + BM - 1) / BM), (unsigned)ny, (unsigned)Z);
      bi_gemm_fma_wide<TA, TW, TC><<<grid, THREADS, smem, s>>>(
          A, W, C, g, runs_aligned(A, g.sa, sizeof(TA)), runs_aligned(W, g.sw, sizeof(TW)));
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

template <typename TA, typename TW>
cudaError_t run_out(int c_dtype, int config, int cw, const void* A, const void* W, void* C,
                    int64_t Z, const Geometry& g, cudaStream_t s) {
  switch (c_dtype) {
    case kF32: return run<TA, TW, float>(config, cw, A, W, C, Z, g, s);
    case kBF16: return run<TA, TW, bf16>(config, cw, A, W, C, Z, g, s);
  }
  return cudaErrorInvalidValue;
}

template <typename TA>
cudaError_t run_w(int w_dtype, int c_dtype, int config, int cw, const void* A, const void* W,
                  void* C, int64_t Z, const Geometry& g, cudaStream_t s) {
  switch (w_dtype) {
    case kF32: return run_out<TA, float>(c_dtype, config, cw, A, W, C, Z, g, s);
    case kBF16: return run_out<TA, bf16>(c_dtype, config, cw, A, W, C, Z, g, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace bi

// sizes: {z1, z2, z3, M, N, K}; strides: A (z1, z2, z3, m, k), then W
// (z1, z2, z3, n, k), then C (z1, z2, z3, m, n), 15 values in elements.
// Dtype codes: 0 f32, 2 bf16 (every pair; the serving route sends bf16 x
// bf16 to the tensor cores).  config: 0 skinny (cw columns a block, a
// divisor of 256 from 8), 1 wide.  seg_k must equal the kernel's segment
// (64).  Returns the launch's CUDA error, 0 if none.
extern "C" int bi_gemm(const void* A, const void* W, void* C, int a_dtype, int w_dtype,
                       int c_dtype, const int64_t* sizes, const int64_t* strides, int config,
                       int cw, int seg_k, void* stream) {
  bi::Geometry g;
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
  const int64_t Z = sizes[0] * sizes[1] * sizes[2];
  if (seg_k != bi::SEG_K || Z < 1 || Z > 65535 || g.m < 1 || g.n < 1 || g.k < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a_dtype) {
    case bi::kF32: return (int)bi::run_w<float>(w_dtype, c_dtype, config, cw, A, W, C, Z, g, s);
    case bi::kBF16:
      return (int)bi::run_w<bi::bf16>(w_dtype, c_dtype, config, cw, A, W, C, Z, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
