// Batch-invariant matrix product for the serving paths, on the CUDA cores:
// the route of every pair with an f32 operand (bf16 pairs take the tensor
// cores, bi_gemm_tc.cu and bi_gemm_mix.cu; ops/_kernels.py: plan_bi_gemm).
//
//   C[z, m, n] = sum_k A[z, m, k] * W[z, n, k]      (f32 accumulation)
//
// with z a batch index of up to three levels (z1, z2, z3) and every operand
// addressed through element strides: the dense layers (Z = 1, W the [N, K]
// weight), the lm_head, and the decode attention's two products over the
// KV cache (scores = q . k over the head dim, batch (b, kv head, group);
// out = P . v over the cache, v read transposed) of an f32 model.
//
// No Pallas kernel of the reference computes this: the JAX package leaves
// these products to XLA.  What the kernel is for is the serving contract of
// the reference engine, a row computes exactly what it computes at batch 1.
// A library GEMM picks its algorithm, tiling and split-K by the problem's
// shape, so a row's sum is taken in an order that depends on how many rows
// share the call.  Here every output element is one thread's running f32
// sum over k = 0 .. K-1 in order (a fused multiply-add a step; zero-padded
// edge tiles add exact zeros), whatever M, N, the batch count or the row's
// place in its tile: one tile configuration, no split-K.  This is the
// batch-invariant matmul of Thinking Machines' "Defeating Nondeterminism in
// LLM Inference" (2025), in its simplest form.
//
// Bound on this card: the decode shapes (M = 1 .. 8) are bound by reading
// the weight, the admission prefill (M = prompts x bucket) by operations.
// The design is CUDA cores only (A and W are widened to f32 in shared
// memory, products exact for bf16 inputs), 64 x 64 output tiles, 256
// threads of 4 x 4 outputs, a 16-deep k tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bi {

constexpr int BM = 64;        // rows of C a block owns
constexpr int BN = 64;        // columns of C a block owns
constexpr int BK = 16;        // k depth of a shared-memory tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

enum Dtype { kF32 = 0, kBF16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Sizes and element strides.  Operand strides are ordered (z1, z2, z3,
// row, k) for A and W and (z1, z2, z3, m, n) for C.
struct Geometry {
  int64_t z2, z3, m, n, k;
  int64_t sa[5];
  int64_t sw[5];
  int64_t sc[5];
};

// One BK x 64 tile of an operand into shared memory as f32, [kk][row].
// Neighbouring threads take neighbouring addresses: along k when the
// operand's k stride is 1, along its rows otherwise (v read transposed).
template <typename T>
__device__ __forceinline__ void load_tile(float (*dst)[BM], const T* base, int64_t row0,
                                          int64_t rows, int64_t row_stride, int64_t k0,
                                          int64_t kdim, int64_t k_stride) {
#pragma unroll
  for (int i = 0; i < BK * BM / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    int r, kk;
    if (k_stride == 1) {
      r = e / BK;
      kk = e % BK;
    } else {
      r = e % BM;
      kk = e / BM;
    }
    const int64_t row = row0 + r, col = k0 + kk;
    dst[kk][r] = (row < rows && col < kdim) ? to_f(base[row * row_stride + col * k_stride])
                                            : 0.0f;
  }
}

template <typename TA, typename TW, typename TC>
__global__ void __launch_bounds__(THREADS)
    bi_gemm_kernel(const TA* __restrict__ A, const TW* __restrict__ W, TC* __restrict__ C,
                   Geometry g) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Ws[BK][BN];

  const int64_t z = blockIdx.z;
  const int64_t z1 = z / (g.z2 * g.z3), z2 = (z / g.z3) % g.z2, z3 = z % g.z3;
  const TA* a = A + z1 * g.sa[0] + z2 * g.sa[1] + z3 * g.sa[2];
  const TW* w = W + z1 * g.sw[0] + z2 * g.sw[1] + z3 * g.sw[2];
  TC* c = C + z1 * g.sc[0] + z2 * g.sc[1] + z3 * g.sc[2];

  const int64_t m0 = (int64_t)blockIdx.y * BM, n0 = (int64_t)blockIdx.x * BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < g.k; k0 += BK) {
    load_tile(As, a, m0, g.m, g.sa[3], k0, g.k, g.sa[4]);
    load_tile(Ws, w, n0, g.n, g.sw[3], k0, g.k, g.sw[4]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(ar[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + tx * 4 + j;
      if (n < g.n) c[m * g.sc[3] + n * g.sc[4]] = from_f<TC>(acc[i][j]);
    }
  }
}

template <typename TA, typename TW, typename TC>
cudaError_t run(const void* A, const void* W, void* C, int64_t Z, const Geometry& g,
                cudaStream_t stream) {
  const dim3 grid((unsigned)((g.n + BN - 1) / BN), (unsigned)((g.m + BM - 1) / BM),
                  (unsigned)Z);
  bi_gemm_kernel<TA, TW, TC><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(A), static_cast<const TW*>(W), static_cast<TC*>(C), g);
  return cudaGetLastError();
}

template <typename TA, typename TW>
cudaError_t run_out(int c_dtype, const void* A, const void* W, void* C, int64_t Z,
                    const Geometry& g, cudaStream_t stream) {
  switch (c_dtype) {
    case kF32: return run<TA, TW, float>(A, W, C, Z, g, stream);
    case kBF16: return run<TA, TW, __nv_bfloat16>(A, W, C, Z, g, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename TA>
cudaError_t run_w(int w_dtype, int c_dtype, const void* A, const void* W, void* C, int64_t Z,
                  const Geometry& g, cudaStream_t stream) {
  switch (w_dtype) {
    case kF32: return run_out<TA, float>(c_dtype, A, W, C, Z, g, stream);
    case kBF16: return run_out<TA, __nv_bfloat16>(c_dtype, A, W, C, Z, g, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace bi

// sizes: {z1, z2, z3, M, N, K}; strides: A (z1, z2, z3, m, k), then W
// (z1, z2, z3, n, k), then C (z1, z2, z3, m, n), 15 values in elements.
// Dtype codes: 0 f32, 2 bf16.  Returns the launch's CUDA error, 0 if none.
extern "C" int bi_gemm(const void* A, const void* W, void* C, int a_dtype, int w_dtype,
                       int c_dtype, const int64_t* sizes, const int64_t* strides,
                       void* stream) {
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
  if (Z < 1 || Z > 65535 || g.m < 1 || g.n < 1 || g.k < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a_dtype) {
    case bi::kF32: return (int)bi::run_w<float>(w_dtype, c_dtype, A, W, C, Z, g, s);
    case bi::kBF16: return (int)bi::run_w<__nv_bfloat16>(w_dtype, c_dtype, A, W, C, Z, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
