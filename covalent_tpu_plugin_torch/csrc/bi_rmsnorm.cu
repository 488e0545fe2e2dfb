// Batch-invariant RMSNorm for the serving paths, with the residual add before
// it folded in.
//
//   y[r, :] = (v * rsqrt(mean(v^2) + eps)) * scale,   v = x[r, :]      (in f32)
//
// cast to the output type.  The fused form (delta and s given) first takes
// the layer's residual add, s[r, :] = x[r, :] + delta[r, :] in f32 rounded
// once to x's type (torch's add, bit for bit), writes s, and normalises the
// rounded s: the reference adds the residual in its activation type and
// normalises the sum.  One launch does what an add and a norm did, and the
// norm reads the sum from registers instead of from device memory.
//
// Order of summation, a function of cols alone (never of the number of rows,
// of the rows a block holds, of the dtypes or of where the row lies):
//
// - The row is cut into runs of RUN = 8 columns: run j holds columns
//   8j .. 8j + 7.  The last run of a width off a multiple of 8 is padded with
//   zeros, which add nothing: a sum of squares is never -0.
// - Lane l of the row's warp owns runs l, l + 32, l + 64, ... and keeps eight
//   sums a[0..7], each from +0: a[i] = fma(v, v, a[i]) over column 8j + i of
//   each of its runs, in increasing j.
// - The lane's total is ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7)).
// - The 32 lane totals are joined by xor shuffles at distances 16, 8, 4, 2
//   and 1.  Each step adds the same two values on both lanes of a pair, in
//   either order, which is the same bits, so every lane ends with the total.
// - mean = total / cols; inv = rsqrtf(mean + eps); y = (v * inv) * scale,
//   each product rounded, then y rounded once to the output type.
//
// One warp takes one row and a block ROWS rows, so no shared memory and no
// __syncthreads: a decode step's 8 rows take 2 blocks, a 1024-row admission
// wave 256.  A lane reads its runs with 16-byte loads (8 bf16, or two float4
// of f32; scale too) where cols is a multiple of 8 and every pointer is
// 16-byte aligned, else one element at a time: the loads differ, the values
// each lane sums and their order do not.  A lane's first HELD runs stay in
// registers from the sum to the output, so a row up to 32 * 8 * HELD = 1024
// columns is read once; runs past them are read again for the output (the
// fused form adds x and delta again, the same bits).
//
// No Pallas kernel of the reference computes this: the JAX package leaves the
// norm and the residual adds to XLA (covalent_tpu_plugin/models/
// transformer.py:183-184, 542-549).  Bound on this card: bytes (x, delta,
// scale read once, s and y written once); at the serving shapes a launch is
// a few microseconds at most.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace birms {

constexpr int RUN = 8;   // columns of one run: 16 bytes of bf16
constexpr int ROWS = 4;  // rows of one block, one warp each
constexpr int HELD = 4;  // runs a lane keeps in registers
enum Dtype { kF32 = 0, kBF16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[RUN]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < RUN / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float (&v)[RUN]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[RUN]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < RUN / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store16(float* p, const float (&v)[RUN]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Run j of a row as floats: zeros past cols.
template <bool VEC, typename T>
__device__ __forceinline__ void load_run(const T* row, int j, int cols, float (&v)[RUN]) {
  const int c = j * RUN;
  if constexpr (VEC) {
    load16(row + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < RUN; ++e) v[e] = c + e < cols ? to_f(row[c + e]) : 0.0f;
  }
}

// Run j of a row from floats, each rounded once to T; nothing past cols.
template <bool VEC, typename T>
__device__ __forceinline__ void store_run(T* row, int j, int cols, const float (&v)[RUN]) {
  const int c = j * RUN;
  if constexpr (VEC) {
    store16(row + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < RUN; ++e)
      if (c + e < cols) row[c + e] = from_f<T>(v[e]);
  }
}

// v = round_T(v + d): torch's add of two T tensors (f32 sum, one rounding).
template <typename T>
__device__ __forceinline__ void add_round(float (&v)[RUN], const float (&d)[RUN]) {
#pragma unroll
  for (int e = 0; e < RUN; ++e) v[e] = to_f(from_f<T>(__fadd_rn(v[e], d[e])));
}

template <bool VEC, bool ADD, typename TX>
__device__ __forceinline__ void source_run(const TX* x, const TX* delta, int j, int cols,
                                           float (&v)[RUN]) {
  load_run<VEC>(x, j, cols, v);
  if constexpr (ADD) {
    float d[RUN];
    load_run<VEC>(delta, j, cols, d);
    add_round<TX>(v, d);
  }
}

__device__ __forceinline__ void scaled(const float (&v)[RUN], float inv, const float (&g)[RUN],
                                       float (&o)[RUN]) {
#pragma unroll
  for (int e = 0; e < RUN; ++e) o[e] = __fmul_rn(__fmul_rn(v[e], inv), g[e]);
}

template <typename TX, typename TS, typename TY, bool VEC, bool ADD>
__device__ __forceinline__ void norm_row(const TX* __restrict__ x, const TX* __restrict__ delta,
                                         const TS* __restrict__ scale, TX* __restrict__ s,
                                         TY* __restrict__ y, int64_t rows, int cols, float eps) {
  const int64_t row = (int64_t)blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: the shuffles below see 32 lanes
  const int lane = threadIdx.x % 32;
  const int runs = (cols + RUN - 1) / RUN;
  const int64_t base = row * cols;
  x += base;
  y += base;
  if constexpr (ADD) {
    delta += base;
    s += base;
  }

  // Every load of the held runs first, all in flight together.
  float v[HELD][RUN], g[HELD][RUN];
  [[maybe_unused]] float d[HELD][RUN];
#pragma unroll
  for (int i = 0; i < HELD; ++i) {
    const int j = lane + 32 * i;
    if (j < runs) {
      load_run<VEC>(x, j, cols, v[i]);
      if constexpr (ADD) load_run<VEC>(delta, j, cols, d[i]);
      load_run<VEC>(scale, j, cols, g[i]);
    }
  }
  float a[RUN];
#pragma unroll
  for (int e = 0; e < RUN; ++e) a[e] = 0.0f;
#pragma unroll
  for (int i = 0; i < HELD; ++i) {
    const int j = lane + 32 * i;
    if (j < runs) {
      if constexpr (ADD) {
        add_round<TX>(v[i], d[i]);
        store_run<VEC>(s, j, cols, v[i]);
      }
#pragma unroll
      for (int e = 0; e < RUN; ++e) a[e] = __fmaf_rn(v[i][e], v[i][e], a[e]);
    }
  }
  for (int j = lane + 32 * HELD; j < runs; j += 32) {
    float w[RUN];
    source_run<VEC, ADD>(x, delta, j, cols, w);
    if constexpr (ADD) store_run<VEC>(s, j, cols, w);
#pragma unroll
    for (int e = 0; e < RUN; ++e) a[e] = __fmaf_rn(w[e], w[e], a[e]);
  }
  float total = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                          __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    total = __fadd_rn(total, __shfl_xor_sync(0xffffffffu, total, offset));
  const float inv = rsqrtf(__fdiv_rn(total, (float)cols) + eps);

#pragma unroll
  for (int i = 0; i < HELD; ++i) {
    const int j = lane + 32 * i;
    if (j < runs) {
      float o[RUN];
      scaled(v[i], inv, g[i], o);
      store_run<VEC>(y, j, cols, o);
    }
  }
  for (int j = lane + 32 * HELD; j < runs; j += 32) {
    float w[RUN], gs[RUN], o[RUN];
    source_run<VEC, ADD>(x, delta, j, cols, w);
    load_run<VEC>(scale, j, cols, gs);
    scaled(w, inv, gs, o);
    store_run<VEC>(y, j, cols, o);
  }
}

// Two kernels, so a profile tells the norm alone from the fused add and norm.
template <typename TX, typename TS, typename TY, bool VEC>
__global__ void __launch_bounds__(32 * ROWS)
    bi_rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                      TY* __restrict__ y, int64_t rows, int cols, float eps) {
  norm_row<TX, TS, TY, VEC, false>(x, nullptr, scale, nullptr, y, rows, cols, eps);
}

template <typename TX, typename TS, typename TY, bool VEC>
__global__ void __launch_bounds__(32 * ROWS)
    bi_rmsnorm_add_kernel(const TX* __restrict__ x, const TX* __restrict__ delta,
                          const TS* __restrict__ scale, TX* __restrict__ s,
                          TY* __restrict__ y, int64_t rows, int cols, float eps) {
  norm_row<TX, TS, TY, VEC, true>(x, delta, scale, s, y, rows, cols, eps);
}

template <typename TX, typename TS, typename TY, bool VEC>
void launch(const void* x, const void* delta, const void* scale, void* s, void* y,
            int64_t rows, int cols, float eps, cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + ROWS - 1) / ROWS)), block(32 * ROWS);
  if (delta == nullptr) {
    bi_rmsnorm_kernel<TX, TS, TY, VEC><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TS*>(scale), static_cast<TY*>(y), rows,
        cols, eps);
  } else {
    bi_rmsnorm_add_kernel<TX, TS, TY, VEC><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(delta),
        static_cast<const TS*>(scale), static_cast<TX*>(s), static_cast<TY*>(y), rows, cols,
        eps);
  }
}

template <typename TX, typename TS, typename TY>
cudaError_t run(const void* x, const void* delta, const void* scale, void* s, void* y,
                int64_t rows, int cols, float eps, bool vec, cudaStream_t stream) {
  if (vec) {
    launch<TX, TS, TY, true>(x, delta, scale, s, y, rows, cols, eps, stream);
  } else {
    launch<TX, TS, TY, false>(x, delta, scale, s, y, rows, cols, eps, stream);
  }
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t run_y(int y_dtype, const void* x, const void* delta, const void* scale, void* s,
                  void* y, int64_t rows, int cols, float eps, bool vec, cudaStream_t stream) {
  switch (y_dtype) {
    case kF32: return run<TX, TS, float>(x, delta, scale, s, y, rows, cols, eps, vec, stream);
    case kBF16:
      return run<TX, TS, __nv_bfloat16>(x, delta, scale, s, y, rows, cols, eps, vec, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t run_scale(int scale_dtype, int y_dtype, const void* x, const void* delta,
                      const void* scale, void* s, void* y, int64_t rows, int cols, float eps,
                      bool vec, cudaStream_t stream) {
  switch (scale_dtype) {
    case kF32:
      return run_y<TX, float>(y_dtype, x, delta, scale, s, y, rows, cols, eps, vec, stream);
    case kBF16:
      return run_y<TX, __nv_bfloat16>(y_dtype, x, delta, scale, s, y, rows, cols, eps, vec,
                                      stream);
  }
  return cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace birms

// x and y are [rows, cols] contiguous, scale [cols].  delta and s, both given
// or both null, are [rows, cols] contiguous in x's type: given, s = x + delta
// is written and y is the norm of s.  Dtype codes: 0 f32, 2 bf16.  Returns the
// launch's CUDA error, 0 if none.
extern "C" int bi_rmsnorm(const void* x, const void* delta, const void* scale, void* s,
                          void* y, int x_dtype, int scale_dtype, int y_dtype, int64_t rows,
                          int64_t cols, float eps, void* stream) {
  using namespace birms;
  if (rows < 1 || cols < 1 || cols > (1 << 30) || (rows + ROWS - 1) / ROWS > 0x7fffffff ||
      (delta == nullptr) != (s == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = cols % RUN == 0 && aligned16(x) && aligned16(scale) && aligned16(y) &&
                   (delta == nullptr || (aligned16(delta) && aligned16(s)));
  const cudaStream_t st = (cudaStream_t)stream;
  const int c = (int)cols;
  switch (x_dtype) {
    case kF32:
      return (int)run_scale<float>(scale_dtype, y_dtype, x, delta, scale, s, y, rows, c, eps,
                                   vec, st);
    case kBF16:
      return (int)run_scale<__nv_bfloat16>(scale_dtype, y_dtype, x, delta, scale, s, y, rows, c,
                                           eps, vec, st);
  }
  return (int)cudaErrorInvalidValue;
}
