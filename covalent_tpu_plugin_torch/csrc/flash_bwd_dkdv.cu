// Flash-attention backward, dK and dV sweep, for Hopper.
//
// Replaces: _flash_bwd_dkdv_kernel, launched by _flash_backward.run_dkdv
// (covalent_tpu_plugin/ops/attention.py), the Pallas TPU kernel.
//
// What bounds it on this card: it recomputes every visible score, then does
// the dV, dP and dK products: at the training shape (B=8, H=12, S=1024,
// D=64, bf16, causal) ~17 GFLOP against ~38 MB moved, far above the card's
// ~295 operations per byte, so its floor is the tensor cores' rate.  This
// first version uses scalar f32 FMAs, so the FMA issue rate and the
// shared-memory reads that feed it bound it in practice.
//
// What the design does about that: one block per (key tile of 64 rows, kv
// head, batch).  K, V and the dK, dV accumulators of the block's rows stay
// in registers for the whole sweep; the block loops over the G query heads
// of its GQA group and over their query tiles, staging each Q and dO tile
// once in shared memory as f32.  Because one block owns a key tile for
// every query head of the group, the sums over heads need no atomics and no
// second pass.  Query tiles that cannot see the key tile (by position, as
// _band_tile_needed decides) are skipped before they are loaded.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ qpos, const int* __restrict__ kpos,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Sq,
                          int Sk, float scale, Band band) {
  constexpr int SL = D / TEAM;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // (TILE, D)
  float* do_s = q_s + TILE * D;    // (TILE, D)
  float* lse_s = do_s + TILE * D;  // (TILE)
  float* delta_s = lse_s + TILE;   // (TILE)
  __shared__ int qpos_s[TILE];
  __shared__ int kpos_s[ROWS];
  __shared__ int qmm[2];
  __shared__ int kmm[2];

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int group = H / Hkv;
  const int row = threadIdx.x / TEAM, lane = threadIdx.x % TEAM;
  const int kj = k0 + row;
  const bool row_ok = kj < Sk;
  const int n_k = min(ROWS, Sk - k0);

  const size_t kv_off = ((size_t)(b * Hkv + hk) * Sk + kj) * D;
  float kr[SL], vr[SL], dk_acc[SL], dv_acc[SL];
  load_slice<T, D>(k + kv_off, row_ok, lane, kr);
  load_slice<T, D>(v + kv_off, row_ok, lane, vr);
#pragma unroll
  for (int c = 0; c < SL; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  load_positions(kpos, k0, n_k, kpos_s, kmm);
  const int kp = kpos_s[row];

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* q_bh = q + (size_t)(b * H + h) * Sq * D;
    const T* do_bh = dout + (size_t)(b * H + h) * Sq * D;
    const float* lse_bh = lse + (size_t)(b * H + h) * Sq;
    const float* delta_bh = delta + (size_t)(b * H + h) * Sq;
    for (int q0 = 0; q0 < Sq; q0 += TILE) {
      const int n_q = min(TILE, Sq - q0);
      __syncthreads();  // the previous tile's readers are done
      load_positions(qpos, q0, n_q, qpos_s, qmm);
      if (!tile_needed(band, qmm[0], qmm[1], kmm[0], kmm[1])) continue;
      load_tile<T, D>(q_bh, q0, n_q, q_s);
      load_tile<T, D>(do_bh, q0, n_q, do_s);
      if (threadIdx.x < n_q) {
        lse_s[threadIdx.x] = lse_bh[q0 + threadIdx.x];
        delta_s[threadIdx.x] = delta_bh[q0 + threadIdx.x];
      }
      __syncthreads();

      for (int i = 0; i < n_q; ++i) {
        const float s = team_dot<D>(kr, q_s + i * D, lane) * scale;
        const bool vis = row_ok && visible(band, qpos_s[i], kp);
        const float p = vis ? expf(s - lse_s[i]) : 0.f;
        const float dp = team_dot<D>(vr, do_s + i * D, lane);
        // dV += P^T dO with P in dO's type; dK += dS^T Q with dS in Q's type.
        team_axpy<D>(dv_acc, round_to<T>(p), do_s + i * D, lane);
        const float ds = p * (dp - delta_s[i]) * scale;
        team_axpy<D>(dk_acc, round_to<T>(ds), q_s + i * D, lane);
      }
    }
  }

  if (row_ok) {
    store_slice<T, D>(dk + kv_off, lane, dk_acc, 1.f);
    store_slice<T, D>(dv + kv_off, lane, dv_acc, 1.f);
  }
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* qpos, const int* kpos,
                void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                Band band, cudaStream_t stream) {
  const dim3 grid((Sk + ROWS - 1) / ROWS, Hkv, B);
  const size_t smem = (2 * TILE * D + 2 * TILE) * sizeof(float);
  return launch(flash_bwd_dkdv_kernel<T, D>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, lse, delta, qpos, kpos, (T*)dk, (T*)dv, H, Hkv,
                Sq, Sk, scale, band);
}

}  // namespace

// q, dout (B, H, Sq, D); k, v (B, Hkv, Sk, D); lse, delta (B, H, Sq) f32;
// qpos (Sq) and kpos (Sk) int32 or null for 0..S-1; dk, dv (B, Hkv, Sk, D)
// in k's type.  window < 0 means no window.  Returns the first CUDA error.
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* qpos,
                              const void* kpos, void* dk, void* dv, int dtype, int B, int H,
                              int Hkv, int Sq, int Sk, int D, float scale, int causal,
                              int window, int sinks, void* stream) {
  const Band band{causal, window, sinks};
  return (int)FLASH_DISPATCH(dtype, D, run, q, k, v, dout, (const float*)lse,
                             (const float*)delta, (const int*)qpos, (const int*)kpos, dk, dv,
                             B, H, Hkv, Sq, Sk, scale, band, (cudaStream_t)stream);
}

// The route flash_bwd_dkdv takes: the scalar kernel for every input.
extern "C" int flash_bwd_dkdv_route(int, int) { return flash::kScalar; }
