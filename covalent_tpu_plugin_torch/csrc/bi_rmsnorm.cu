// Batch-invariant RMSNorm for the serving paths.
//
//   y[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps)) * scale      (in f32)
//
// cast to the output type.  One block per row, whatever the number of rows:
// thread t sums the squares of columns t, t + 256, t + 512, ... in order,
// the 256 partial sums are joined by one fixed tree (xor shuffles inside
// each warp, then warp 0 over the eight warp sums), so a row's mean is the
// same bits at batch 1 and at batch 8.  A library reduction sizes its
// blocks by the number of rows, and with them the order of the sum.  The
// method is the batch-invariant RMSNorm of Thinking Machines' "Defeating
// Nondeterminism in LLM Inference" (2025).
//
// No Pallas kernel of the reference computes this: the JAX package leaves
// the norm to XLA.  Bound on this card: bytes (one read of the row, one
// write), at most a few microseconds at the serving shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace birms {

constexpr int THREADS = 256;
enum Dtype { kF32 = 0, kBF16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TX, typename TS, typename TY>
__global__ void __launch_bounds__(THREADS)
    bi_rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale, TY* __restrict__ y,
                   int64_t cols, float eps) {
  __shared__ float warp_sums[THREADS / 32];
  const TX* row = x + (int64_t)blockIdx.x * cols;
  TY* out = y + (int64_t)blockIdx.x * cols;

  float sum = 0.0f;
  for (int64_t c = threadIdx.x; c < cols; c += THREADS) {
    const float v = to_f(row[c]);
    sum = __fmaf_rn(v, v, sum);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, offset);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x < 32) {
    float total = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0.0f;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, offset);
    if (threadIdx.x == 0) warp_sums[0] = total;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sums[0] / (float)cols + eps);
  for (int64_t c = threadIdx.x; c < cols; c += THREADS)
    out[c] = from_f<TY>((to_f(row[c]) * inv) * to_f(scale[c]));
}

template <typename TX, typename TS, typename TY>
cudaError_t run(const void* x, const void* scale, void* y, int64_t rows, int64_t cols,
                float eps, cudaStream_t stream) {
  bi_rmsnorm_kernel<TX, TS, TY><<<(unsigned)rows, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TS*>(scale), static_cast<TY*>(y), cols, eps);
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t run_y(int y_dtype, const void* x, const void* scale, void* y, int64_t rows,
                  int64_t cols, float eps, cudaStream_t stream) {
  switch (y_dtype) {
    case kF32: return run<TX, TS, float>(x, scale, y, rows, cols, eps, stream);
    case kBF16: return run<TX, TS, __nv_bfloat16>(x, scale, y, rows, cols, eps, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t run_s(int s_dtype, int y_dtype, const void* x, const void* scale, void* y,
                  int64_t rows, int64_t cols, float eps, cudaStream_t stream) {
  switch (s_dtype) {
    case kF32: return run_y<TX, float>(y_dtype, x, scale, y, rows, cols, eps, stream);
    case kBF16: return run_y<TX, __nv_bfloat16>(y_dtype, x, scale, y, rows, cols, eps, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace birms

// x and y are [rows, cols] contiguous, scale [cols].  Dtype codes: 0 f32,
// 2 bf16.  Returns the launch's CUDA error, 0 if none.
extern "C" int bi_rmsnorm(const void* x, const void* scale, void* y, int x_dtype,
                          int s_dtype, int y_dtype, int64_t rows, int64_t cols, float eps,
                          void* stream) {
  if (rows < 1 || rows > 0x7fffffff || cols < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case birms::kF32:
      return (int)birms::run_s<float>(s_dtype, y_dtype, x, scale, y, rows, cols, eps, s);
    case birms::kBF16:
      return (int)birms::run_s<__nv_bfloat16>(s_dtype, y_dtype, x, scale, y, rows, cols, eps,
                                              s);
  }
  return (int)cudaErrorInvalidValue;
}
