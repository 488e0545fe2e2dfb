// Flash-attention forward for Hopper.
//
// Replaces: _flash_kernel, launched by _flash_forward
// (covalent_tpu_plugin/ops/attention.py), the Pallas TPU kernel.
//
// What bounds it on this card: at the training shape (B=8, H=12, S=1024,
// D=64, bf16, causal) the function does ~12.9 GFLOP against ~25 MB of
// inputs and outputs, ~500 operations per byte, so its floor is the tensor
// cores' rate, not memory.  This first version does its products with
// scalar f32 FMAs on the CUDA cores, so what bounds it in practice is the
// FMA issue rate and the shared-memory reads that feed it.
//
// What the design does about that: one block per (query tile of 64 rows,
// head, batch); the TPU kernel's sequential key-tile grid axis becomes a
// loop inside the block, with the running max, sum and output accumulator
// held in registers.  Each key tile is staged once in shared memory as f32
// and read with 16-byte broadcast loads by every row of the block, and
// tiles wholly outside the causal band (by position, as
// _band_tile_needed decides) are skipped before they are loaded.  The
// scores of a tile go through shared memory once so that the running max is
// rescaled once per tile, as in the reference, not once per key.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, float scale,
                     Band band) {
  constexpr int SL = D / TEAM;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;              // (TILE, D)
  float* v_s = k_s + TILE * D;    // (TILE, D)
  float* s_s = v_s + TILE * D;    // (ROWS, TILE + 1) scores of the tile
  __shared__ int qpos_s[ROWS];
  __shared__ int kpos_s[TILE];
  __shared__ int qmm[2];
  __shared__ int kmm[2];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int hk = h / (H / Hkv);
  const int row = threadIdx.x / TEAM, lane = threadIdx.x % TEAM;
  const int qi = q0 + row;
  const bool row_ok = qi < Sq;
  const int n_q = min(ROWS, Sq - q0);

  const T* q_bh = q + (size_t)(b * H + h) * Sq * D;
  const T* k_bh = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* v_bh = v + (size_t)(b * Hkv + hk) * Sk * D;

  float qr[SL], acc[SL];
  load_slice<T, D>(q_bh + (size_t)qi * D, row_ok, lane, qr);
#pragma unroll
  for (int c = 0; c < SL; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;

  load_positions(qpos, q0, n_q, qpos_s, qmm);
  const int qp = qpos_s[row];

  for (int k0 = 0; k0 < Sk; k0 += TILE) {
    const int n_k = min(TILE, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_positions(kpos, k0, n_k, kpos_s, kmm);
    if (!tile_needed(band, qmm[0], qmm[1], kmm[0], kmm[1])) continue;
    load_tile<T, D>(k_bh, k0, n_k, k_s);
    load_tile<T, D>(v_bh, k0, n_k, v_s);
    __syncthreads();

    float tile_max = kNegInf;
    for (int j = 0; j < n_k; ++j) {
      float s = team_dot<D>(qr, k_s + j * D, lane) * scale;
      if (!(row_ok && visible(band, qp, kpos_s[j]))) s = kNegInf;
      if (lane == 0) s_s[row * (TILE + 1) + j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    __syncwarp();

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < SL; ++c) acc[c] *= alpha;
    for (int j = 0; j < n_k; ++j) {
      const float s = s_s[row * (TILE + 1) + j];
      const bool vis = row_ok && visible(band, qp, kpos_s[j]);
      const float p = vis ? expf(s - m_new) : 0.f;
      l += p;
      team_axpy<D>(acc, round_to<T>(p), v_s + j * D, lane);
    }
    m = m_new;
  }

  if (row_ok) {
    const float l_safe = fmaxf(l, 1e-37f);
    store_slice<T, D>(o + ((size_t)(b * H + h) * Sq + qi) * D, lane, acc, l_safe);
    if (lane == 0) lse[(size_t)(b * H + h) * Sq + qi] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, void* o, float* lse, int B, int H, int Hkv, int Sq, int Sk,
                float scale, Band band, cudaStream_t stream) {
  const dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
  const size_t smem = (2 * TILE * D + ROWS * (TILE + 1)) * sizeof(float);
  return launch(flash_fwd_kernel<T, D>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, qpos, kpos, (T*)o, lse, H, Hkv, Sq, Sk, scale, band);
}

}  // namespace

// q (B, H, Sq, D); k, v (B, Hkv, Sk, D); qpos (Sq) and kpos (Sk) int32 or
// null for 0..S-1; o (B, H, Sq, D) in q's type; lse (B, H, Sq) f32.
// window < 0 means no window.  Returns the first CUDA error, 0 on success.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* qpos,
                         const void* kpos, void* o, void* lse, int dtype, int B, int H,
                         int Hkv, int Sq, int Sk, int D, float scale, int causal, int window,
                         int sinks, void* stream) {
  const Band band{causal, window, sinks};
  return (int)FLASH_DISPATCH(dtype, D, run, q, k, v, (const int*)qpos, (const int*)kpos, o,
                             (float*)lse, B, H, Hkv, Sq, Sk, scale, band,
                             (cudaStream_t)stream);
}
