// Batch-invariant product with an int8 weight on the tensor cores: the
// quantized denses of the serving paths.
//
//   C[z, m, n] = epilogue(sum_k A[z, m, k] * W[z, n, k], scale[n])
//
// A bf16, W int8 (|W| <= 127), scale f32, C bf16 or f32.  The reference
// leaves this product to XLA (covalent_tpu_plugin/models/quant.py:84-89:
// `dot(x.astype(dtype), kernel.astype(dtype)) * scale.astype(dtype)`); no
// Pallas kernel computes it.  What the kernel is for is the bytes: the int8
// weight is what crosses HBM, half of a bf16 copy's, widened to bf16 in
// registers on its way to mma.sync.  The widening is exact (every integer
// of at most 8 bits is a bf16), so the sums are bi_gemm_tc.cu's on the
// widened weight, in bi_mma.cuh's order, bit for bit, whatever the batch.
//
// The epilogue is the reference's scale step on the rounded sum:
//   C bf16: bf16(float(bf16(total)) * scale[n])   (the wrapper passes scale
//           already rounded to bf16, as `scale.astype(bf16)`)
//   C f32:  total * scale[n]                       (the lm_head's f32 logits)
//
// The two tile configurations are bi_gemm_tc.cu's, picked by the wrapper
// from M, N and the batch (ops/_kernels.py: plan_bi_gemm): skinny for the
// decode steps (each warp loads its segment's 8-byte int8 runs of W and its
// 16-byte bf16 runs of A straight from global memory into registers), wide
// for the admission waves (a three-stage cp.async ring; W's stage holds the
// int8 bytes, widened when a warp reads its fragment).

#include "bi_mma.cuh"

namespace biw8 {

using bimma::Geometry;
using bimma::K_GROUP;
using bimma::PITCH;
using bimma::SEG_GROUPS;
using bimma::SEG_K;
using bf16 = __nv_bfloat16;

constexpr int SKINNY_MAX_WARPS = 16;

__device__ __forceinline__ uint32_t pack2(uint32_t word, int shift) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      (float)(int)(signed char)(word >> shift), (float)(int)(signed char)(word >> (shift + 8)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 int8 (k ascending) -> 8 bf16 in the layout of a 16-byte bf16 run.
__device__ __forceinline__ uint4 widen8(const uint2& v) {
  return make_uint4(pack2(v.x, 0), pack2(v.x, 16), pack2(v.y, 0), pack2(v.y, 16));
}

__device__ __forceinline__ uint2 ldg8(const int8_t* p, bool ok) {
  uint2 v = make_uint2(0u, 0u);
  if (ok) v = __ldg(reinterpret_cast<const uint2*>(p));
  return v;
}

// The scale step on the f32 totals of C[m, n] and C[m, n + 1].
template <typename TC> __device__ __forceinline__ float scaled(float total, float s);
template <> __device__ __forceinline__ float scaled<float>(float total, float s) {
  return total * s;
}
template <> __device__ __forceinline__ float scaled<bf16>(float total, float s) {
  return __bfloat162float(__float2bfloat16_rn(total)) * s;  // rounded once more by store2
}

template <typename TC>
__device__ __forceinline__ void store2_scaled(TC* c, const float* __restrict__ scale,
                                              const Geometry& g, int64_t m, int64_t n, float v0,
                                              float v1) {
  if (m >= g.m || n >= g.n) return;
  const float s0 = __ldg(scale + n), s1 = n + 1 < g.n ? __ldg(scale + n + 1) : 0.0f;
  bimma::store2(c, g, m, n, scaled<TC>(v0, s0), scaled<TC>(v1, s1));
}

// grid (ceil(M / 16), ceil(N / (8 nt)), Z), 32 * nt * rs threads: the
// skinny tiles of bi_gemm_tc.cu, W read as int8.
template <typename TC>
__global__ void __launch_bounds__(32 * SKINNY_MAX_WARPS)
    w8_skinny(const bf16* __restrict__ A, const int8_t* __restrict__ W,
              const float* __restrict__ scale, TC* __restrict__ C, Geometry g, int nt, int rs) {
  __shared__ __align__(16) float part[SKINNY_MAX_WARPS][32][4];
  const bf16* a = bimma::at_batch(A, g.sa, g);
  const int8_t* w = bimma::at_batch(W, g.sw, g);
  TC* c = bimma::at_batch(C, g.sc, g);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / 4, t = lane % 4;
  const int tile = warp % nt, sub = warp / nt;
  const int64_t m0 = (int64_t)blockIdx.x * 16;
  const int64_t col0 = (int64_t)blockIdx.y * 8 * nt + tile * 8;
  const int64_t row_n = col0 + gi;
  const bool ok_n = row_n < g.n, ok0 = m0 + gi < g.m, ok1 = m0 + gi + 8 < g.m;
  const bool two_halves = m0 + 8 < g.m;
  const int8_t* w_row = w + row_n * g.sw[3];
  const bf16* a_row0 = a + (m0 + gi) * g.sa[3];
  const bf16* a_row1 = a + (m0 + gi + 8) * g.sa[3];
  const int64_t nseg = bimma::segments(g.k);

  float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t round = 0; round < nseg; round += rs) {
    const int64_t seg = round + sub;
    if (seg < nseg) {
      const int64_t kseg = seg * SEG_K;
      uint2 wv[SEG_GROUPS][2];
      uint4 lo[SEG_GROUPS][2], hi[SEG_GROUPS][2];
#pragma unroll
      for (int gr = 0; gr < SEG_GROUPS; ++gr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t k = kseg + gr * K_GROUP + 16 * t + 8 * h;
          const bool ok_k = k < g.k;  // K % 8 == 0: a run is wholly in or out
          wv[gr][h] = ldg8(w_row + k, ok_n && ok_k);
          lo[gr][h] = bimma::ldg16(a_row0 + k, ok0 && ok_k);
          hi[gr][h] = two_halves ? bimma::ldg16(a_row1 + k, ok1 && ok_k)
                                 : make_uint4(0u, 0u, 0u, 0u);
        }
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int gr = 0; gr < SEG_GROUPS; ++gr) {
        if (kseg + gr * K_GROUP >= g.k) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) bimma::mma_pair(acc, lo[gr][h], hi[gr][h], widen8(wv[gr][h]));
      }
      *reinterpret_cast<float4*>(part[warp][lane]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    if (warp < nt) {
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
    store2_scaled(c, scale, g, m0 + gi, col0 + 2 * t, total[0], total[1]);
    store2_scaled(c, scale, g, m0 + gi + 8, col0 + 2 * t, total[2], total[3]);
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? BYTES : 0;  // 0: the bytes are filled with zeros
  if constexpr (BYTES == 16) {
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

// bi_gemm_tc.cu's wide tile: 64 x 128, four warps of 64 x 32, three stages.
constexpr int TM = 4, TN = 4, WARPS_N = 4, STAGES = 3;
constexpr int BM = TM * 16, BN = WARPS_N * TN * 8, WIDE_THREADS = 32 * WARPS_N;
constexpr int PITCH8 = K_GROUP + 16;  // bytes of one int8 W row of a stage
constexpr int WIDE_SMEM = STAGES * (BM * PITCH * 2 + BN * PITCH8);  // 58368 bytes

template <typename TC>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
    w8_wide(const bf16* __restrict__ A, const int8_t* __restrict__ W,
            const float* __restrict__ scale, TC* __restrict__ C, Geometry g) {
  constexpr int THREADS = WIDE_THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                                  // [stage][BM][PITCH]
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + STAGES * BM * PITCH * 2);  // [stage][BN][PITCH8]
  const bf16* a = bimma::at_batch(A, g.sa, g);
  const int8_t* w = bimma::at_batch(W, g.sw, g);
  TC* c = bimma::at_batch(C, g.sc, g);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / 4, t = lane % 4;
  const int64_t m0 = (int64_t)blockIdx.x * BM, n0 = (int64_t)blockIdx.y * BN;
  const int64_t ngroups = bimma::groups(g.k);

  auto load_group = [&](int stage, int64_t grp) {
    const int64_t k0 = grp * K_GROUP;
    bf16* as = As + stage * BM * PITCH;
    int8_t* ws = Ws + stage * BN * PITCH8;
#pragma unroll
    for (int it = 0; it < BM * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i / 8, run = i % 8;
      const int64_t row = m0 + r, k = k0 + 8 * run;
      const bool ok = row < g.m && k < g.k;
      cp_async<16>(as + r * PITCH + 8 * run, ok ? a + row * g.sa[3] + k : a, ok);
    }
#pragma unroll
    for (int it = 0; it < BN * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i / 8, run = i % 8;
      const int64_t row = n0 + r, k = k0 + 8 * run;
      const bool ok = row < g.n && k < g.k;
      cp_async<8>(ws + r * PITCH8 + 8 * run, ok ? w + row * g.sw[3] + k : w, ok);
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
    __syncthreads();
    const int64_t next = grp + STAGES - 1;
    if (next < ngroups) load_group((int)(next % STAGES), next);
    cp_async_commit();

    const int stage = (int)(grp % STAGES);
    const bf16* as = As + stage * BM * PITCH + gi * PITCH + 16 * t;
    const int8_t* ws = Ws + stage * BN * PITCH8 + (warp * TN * 8 + gi) * PITCH8 + 16 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 wv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        wv[j] = widen8(*reinterpret_cast<const uint2*>(ws + j * 8 * PITCH8 + 8 * h));
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
    if ((grp + 1) % SEG_GROUPS == 0 || grp + 1 == ngroups) {
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
      store2_scaled(c, scale, g, m, n, total[i][j][0], total[i][j][1]);
      store2_scaled(c, scale, g, m + 8, n, total[i][j][2], total[i][j][3]);
    }
  }
}

enum Config { kSkinny = 0, kWide = 1 };

template <typename TC>
cudaError_t run(int config, int nt, int rs, const void* Ap, const void* Wp, const float* scale,
                void* Cp, int64_t Z, const Geometry& g, cudaStream_t s) {
  const bf16* A = static_cast<const bf16*>(Ap);
  const int8_t* W = static_cast<const int8_t*>(Wp);
  TC* C = static_cast<TC*>(Cp);
  switch (config) {
    case kSkinny: {
      if (nt < 1 || rs < 1 || nt * rs > SKINNY_MAX_WARPS) return cudaErrorInvalidValue;
      const int64_t ny = (g.n + 8 * nt - 1) / (8 * nt);
      if (ny > 65535) return cudaErrorInvalidValue;
      const dim3 grid((unsigned)((g.m + 15) / 16), (unsigned)ny, (unsigned)Z);
      w8_skinny<TC><<<grid, 32 * nt * rs, 0, s>>>(A, W, scale, C, g, nt, rs);
      return cudaGetLastError();
    }
    case kWide: {
      static const cudaError_t opt_in = cudaFuncSetAttribute(
          w8_wide<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
      if (opt_in != cudaSuccess) return opt_in;
      const dim3 grid((unsigned)((g.m + BM - 1) / BM), (unsigned)((g.n + BN - 1) / BN),
                      (unsigned)Z);
      w8_wide<TC><<<grid, WIDE_THREADS, WIDE_SMEM, s>>>(A, W, scale, C, g);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace biw8

// sizes: {z1, z2, z3, M, N, K}; strides: A (z1, z2, z3, m, k), W (z1, z2,
// z3, n, k), C (z1, z2, z3, m, n), 15 values in elements.  A bf16 with k
// stride 1 and 16-byte aligned rows; W int8 with k stride 1 and 8-byte
// aligned rows; K % 8 == 0 (the wrapper copies operands off them onto them).
// scale: N f32 values, one a column, shared by every batch.  config: 0
// skinny (nt column tiles of 8, rs segments a round), 1 wide.  seg_k must
// equal the kernel's segment (256).  c_dtype: 0 f32, 2 bf16.  Returns the
// launch's CUDA error, 0 if none.
extern "C" int bi_gemm_w8(const void* A, const void* W, const float* scale, void* C, int c_dtype,
                          const int64_t* sizes, const int64_t* strides, int config, int nt,
                          int rs, int seg_k, void* stream) {
  const bimma::Geometry g = bimma::geometry(sizes, strides);
  const int64_t Z = sizes[0] * sizes[1] * sizes[2];
  if (seg_k != bimma::SEG_K || Z < 1 || Z > 65535 || g.m < 1 || g.n < 1 || g.k < 1 ||
      g.k % 8 != 0 || g.sa[4] != 1 || g.sw[4] != 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (c_dtype) {
    case bimma::kF32: return (int)biw8::run<float>(config, nt, rs, A, W, scale, C, Z, g, s);
    case bimma::kBF16:
      return (int)biw8::run<__nv_bfloat16>(config, nt, rs, A, W, scale, C, Z, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
