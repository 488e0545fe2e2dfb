// Flash-attention backward, dQ sweep, for Hopper.
//
// Replaces: _flash_bwd_dq_kernel, launched by _flash_backward
// (covalent_tpu_plugin/ops/attention.py), the Pallas TPU kernel.
//
// What bounds it on this card: it recomputes every visible score and does
// the dP and dQ products: at the training shape (B=8, H=12, S=1024, D=64,
// bf16, causal) ~12.9 GFLOP against ~26 MB moved, far above the card's ~295
// operations per byte, so its floor is the tensor cores' rate.  This first
// version uses scalar f32 FMAs, so the FMA issue rate and the shared-memory
// reads that feed it bound it in practice.
//
// What the design does about that: one block per (query tile of 64 rows,
// head, batch), the mirror of the forward: Q, dO, the row's LSE and delta
// and the dQ accumulator stay in registers while the block loops over key
// tiles, each staged once in shared memory as f32.  Key tiles outside the
// band (by position, as _band_tile_needed decides) are skipped before they
// are loaded.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ qpos, const int* __restrict__ kpos,
                        T* __restrict__ dq, int H, int Hkv, int Sq, int Sk, float scale,
                        Band band) {
  constexpr int SL = D / TEAM;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;            // (TILE, D)
  float* v_s = k_s + TILE * D;  // (TILE, D)
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

  const size_t q_off = ((size_t)(b * H + h) * Sq + qi) * D;
  const T* k_bh = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* v_bh = v + (size_t)(b * Hkv + hk) * Sk * D;

  float qr[SL], dor[SL], dq_acc[SL];
  load_slice<T, D>(q + q_off, row_ok, lane, qr);
  load_slice<T, D>(dout + q_off, row_ok, lane, dor);
#pragma unroll
  for (int c = 0; c < SL; ++c) dq_acc[c] = 0.f;
  const float row_lse = row_ok ? lse[(size_t)(b * H + h) * Sq + qi] : 0.f;
  const float row_delta = row_ok ? delta[(size_t)(b * H + h) * Sq + qi] : 0.f;

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

    for (int j = 0; j < n_k; ++j) {
      const float s = team_dot<D>(qr, k_s + j * D, lane) * scale;
      const bool vis = row_ok && visible(band, qp, kpos_s[j]);
      const float p = vis ? expf(s - row_lse) : 0.f;
      const float dp = team_dot<D>(dor, v_s + j * D, lane);
      const float ds = p * (dp - row_delta) * scale;
      // dQ += dS K with dS in K's type.
      team_axpy<D>(dq_acc, round_to<T>(ds), k_s + j * D, lane);
    }
  }

  if (row_ok) store_slice<T, D>(dq + q_off, lane, dq_acc, 1.f);
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* qpos, const int* kpos,
                void* dq, int B, int H, int Hkv, int Sq, int Sk, float scale, Band band,
                cudaStream_t stream) {
  const dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
  const size_t smem = 2 * TILE * D * sizeof(float);
  return launch(flash_bwd_dq_kernel<T, D>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, lse, delta, qpos, kpos, (T*)dq, H, Hkv, Sq, Sk,
                scale, band);
}

}  // namespace

// q, dout, dq (B, H, Sq, D); k, v (B, Hkv, Sk, D); lse, delta (B, H, Sq) f32;
// qpos (Sq) and kpos (Sk) int32 or null for 0..S-1.  window < 0 means no
// window.  Returns the first CUDA error, 0 on success.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* qpos,
                            const void* kpos, void* dq, int dtype, int B, int H, int Hkv,
                            int Sq, int Sk, int D, float scale, int causal, int window,
                            int sinks, void* stream) {
  const Band band{causal, window, sinks};
  return (int)FLASH_DISPATCH(dtype, D, run, q, k, v, dout, (const float*)lse,
                             (const float*)delta, (const int*)qpos, (const int*)kpos, dq, B, H,
                             Hkv, Sq, Sk, scale, band, (cudaStream_t)stream);
}
