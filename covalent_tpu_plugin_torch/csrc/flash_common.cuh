// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkdv.cu, flash_bwd_dq.cu): element conversion, the band mask and
// the tile-skip test, the route by (dtype, head dim), and the row-team
// layout of the scalar kernels.
//
// Scalar layout.  Each block owns ROWS rows of its fixed operand (query rows for the
// forward and dq sweeps, key rows for dk/dv).  A team of TEAM neighbouring
// threads shares one row; lane `c` of the team holds the row's columns in
// 4-wide chunks `(chunk * TEAM + c) * 4 .. +3`, so one team reads 64
// contiguous bytes of a shared-memory row with 16-byte loads and no bank
// conflict.  A dot product is TEAM partial sums joined by two xor shuffles,
// which leaves the same sum, bit for bit, in every lane of the team.
//
// Numerics follow the Pallas kernels of covalent_tpu_plugin/ops/attention.py:
// every product accumulates in f32, masked scores are the finite -1e30, a
// masked probability is exactly 0, and the casts the Pallas kernels make
// before their matmuls (P to V's type, dS to Q's or K's type) are made here
// by rounding through the input type.
//
// Output types.  Each sweep writes its results (out; dk and dv; dq) in the
// input type, or in f32 where the caller asks for it (the reference's
// out_dtype / grad_dtype: ring attention sums one partial per hop and must
// not round each one to 16 bits).  Only the final store differs: the
// accumulators are f32 either way.  The route is chosen by the input type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace flash {

constexpr float kNegInf = -1e30f;  // NEG_INF of the reference
constexpr int TEAM = 4;            // threads sharing one row
constexpr int ROWS = 64;           // rows of the fixed operand per block
constexpr int THREADS = ROWS * TEAM;
constexpr int TILE = 64;           // rows of the swept operand per tile

enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the reference's `.astype(T)` before a matmul.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Causal band of the reference's _band_visible.  window < 0 means none.
struct Band {
  int causal;
  int window;
  int sinks;
};

__device__ __forceinline__ bool visible(const Band& band, int qp, int kp) {
  if (!band.causal) return true;
  if (qp < kp) return false;
  if (band.window < 0) return true;
  return (qp - kp < band.window) || (band.sinks > 0 && kp < band.sinks);
}

// The reference's _band_tile_needed on tile position ranges.
__device__ __forceinline__ bool tile_needed(const Band& band, int qmin, int qmax,
                                            int kmin, int kmax) {
  bool needed = !band.causal || kmin <= qmax;
  if (band.window >= 0) {
    bool behind_ok = kmax > qmin - band.window;
    if (band.sinks > 0) behind_ok = behind_ok || kmin < band.sinks;
    needed = needed && behind_ok;
  }
  return needed;
}

__device__ __forceinline__ int position(const int* pos, int i) {
  return pos ? pos[i] : i;
}

// Loads the positions of rows [start, start + n) into pos_s and leaves their
// min and max in mm[0], mm[1].  Every thread of the block calls it; it ends
// with the block synchronised.
__device__ __forceinline__ void load_positions(const int* pos, int start, int n,
                                               int* pos_s, int* mm) {
  if (threadIdx.x < TILE) {
    pos_s[threadIdx.x] = threadIdx.x < n ? position(pos, start + threadIdx.x) : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = pos_s[0], hi = pos_s[0];
    for (int i = 1; i < n; ++i) {
      lo = min(lo, pos_s[i]);
      hi = max(hi, pos_s[i]);
    }
    mm[0] = lo;
    mm[1] = hi;
  }
  __syncthreads();
}

// Copies rows [start, start + n) of a (rows, D) matrix into a (TILE, D) f32
// tile, zero-filling the rows past n.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int start, int n,
                                          float* dst) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D;
    dst[idx] = r < n ? to_f(src[(size_t)(start + r) * D + idx % D]) : 0.f;
  }
}

// Column of element e of chunk `chunk` for team lane `lane`.
__device__ __forceinline__ int column(int chunk, int lane, int e) {
  return (chunk * TEAM + lane) * 4 + e;
}

// Sum over the team: every lane ends with the same value.
__device__ __forceinline__ float team_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Dot product of a team's register slice with one f32 row in shared memory.
template <int D>
__device__ __forceinline__ float team_dot(const float* reg, const float* row, int lane) {
  const float4* row4 = reinterpret_cast<const float4*>(row);
  float part = 0.f;
#pragma unroll
  for (int ch = 0; ch < D / (4 * TEAM); ++ch) {
    const float4 x = row4[ch * TEAM + lane];
    part = fmaf(reg[4 * ch + 0], x.x, part);
    part = fmaf(reg[4 * ch + 1], x.y, part);
    part = fmaf(reg[4 * ch + 2], x.z, part);
    part = fmaf(reg[4 * ch + 3], x.w, part);
  }
  return team_sum(part);
}

// acc += a * row over the team's slice of one f32 row in shared memory.
template <int D>
__device__ __forceinline__ void team_axpy(float* acc, float a, const float* row, int lane) {
  const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int ch = 0; ch < D / (4 * TEAM); ++ch) {
    const float4 x = row4[ch * TEAM + lane];
    acc[4 * ch + 0] = fmaf(a, x.x, acc[4 * ch + 0]);
    acc[4 * ch + 1] = fmaf(a, x.y, acc[4 * ch + 1]);
    acc[4 * ch + 2] = fmaf(a, x.z, acc[4 * ch + 2]);
    acc[4 * ch + 3] = fmaf(a, x.w, acc[4 * ch + 3]);
  }
}

// Loads the team's slice of global row `row` (zeros when !ok).
template <typename T, int D>
__device__ __forceinline__ void load_slice(const T* __restrict__ src, bool ok, int lane,
                                           float* reg) {
#pragma unroll
  for (int ch = 0; ch < D / (4 * TEAM); ++ch) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      reg[4 * ch + e] = ok ? to_f(src[column(ch, lane, e)]) : 0.f;
    }
  }
}

// Stores the team's slice, divided by `div`, in the output type O.
template <typename O, int D>
__device__ __forceinline__ void store_slice(O* __restrict__ dst, int lane, const float* reg,
                                            float div) {
#pragma unroll
  for (int ch = 0; ch < D / (4 * TEAM); ++ch) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[column(ch, lane, e)] = from_f<O>(reg[4 * ch + e] / div);
    }
  }
}

// Sets the dynamic shared-memory ceiling, then launches.  Returns the first
// CUDA error.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The kernel each of the three sweeps takes for a (dtype, head dim).  16-bit
// inputs at head dim 64 or 128 go to the tensor-core kernels (wgmma + TMA,
// flash_tc.cuh).  f32 stays on the scalar kernels: the tensor cores would
// compute it in TF32, which is not the reference's arithmetic.  16-bit head
// dims 16, 32 and 256 stay on the scalar kernels too, for now.
// Each library exports it as <entry point>_route, which ops/_kernels.py reads.
enum Route { kScalar = 0, kTensorCore = 1 };

constexpr Route route(int dtype, int head_dim) {
  return (dtype == kF16 || dtype == kBF16) && (head_dim == 64 || head_dim == 128) ? kTensorCore
                                                                                 : kScalar;
}

template <typename T> constexpr int dtype_code() {
  return std::is_same<T, float>::value ? kF32 : std::is_same<T, __half>::value ? kF16 : kBF16;
}

// Instantiates `fn<T, D, O>(args...)` for the head widths and types the
// scalar kernels take, O the input type T or f32 (out_dtype); anything else
// is cudaErrorInvalidValue.
#define FLASH_DISPATCH(dtype, out_dtype, head_dim, fn, ...)                        \
  [&]() -> cudaError_t {                                                          \
    switch (dtype) {                                                              \
      case flash::kF32:                                                           \
        return FLASH_DISPATCH_O(float, out_dtype, head_dim, fn, __VA_ARGS__);     \
      case flash::kF16:                                                           \
        return FLASH_DISPATCH_O(__half, out_dtype, head_dim, fn, __VA_ARGS__);    \
      case flash::kBF16:                                                          \
        return FLASH_DISPATCH_O(__nv_bfloat16, out_dtype, head_dim, fn, __VA_ARGS__); \
      default: return cudaErrorInvalidValue;                                      \
    }                                                                             \
  }()

// O is T when out_dtype names the input type, f32 when it names f32.
#define FLASH_DISPATCH_O(T, out_dtype, head_dim, fn, ...)                     \
  [&]() -> cudaError_t {                                                     \
    if ((out_dtype) == flash::dtype_code<T>())                               \
      return FLASH_DISPATCH_D(T, T, head_dim, fn, __VA_ARGS__);              \
    if ((out_dtype) == flash::kF32)                                          \
      return FLASH_DISPATCH_D(T, float, head_dim, fn, __VA_ARGS__);          \
    return cudaErrorInvalidValue;                                            \
  }()

#define FLASH_DISPATCH_D(T, O, head_dim, fn, ...)               \
  [&]() -> cudaError_t {                                        \
    switch (head_dim) {                                         \
      case 16: return fn<T, 16, O>(__VA_ARGS__);                \
      case 32: return fn<T, 32, O>(__VA_ARGS__);                \
      case 64: return fn<T, 64, O>(__VA_ARGS__);                \
      case 128: return fn<T, 128, O>(__VA_ARGS__);              \
      case 256: return fn<T, 256, O>(__VA_ARGS__);              \
      default: return cudaErrorInvalidValue;                    \
    }                                                           \
  }()

}  // namespace flash
