// Flash-attention backward, dQ sweep, for Hopper.
//
// Replaces: _flash_bwd_dq_kernel, launched by _flash_backward
// (covalent_tpu_plugin/ops/attention.py), the Pallas TPU kernel.
//
// What bounds it on this card: it recomputes every visible score and does
// the dP and dQ products: at the training shape (B=8, H=12, S=1024, D=64,
// bf16, causal) ~19.3 GFLOP against ~26 MB moved, far above the card's ~295
// operations per byte, so its floor is the tensor cores' rate.
//
// Two routes, chosen by route() in flash_common.cuh on (dtype, head dim):
//
// - Tensor cores (bf16/f16, head dim 64 or 128): flash_bwd_dq_tc_kernel,
//   the same shape as the forward's (flash_tc.cuh).  The producer warp loads
//   Q and dO once and streams K/V tiles of 64 keys through the TMA ring; each
//   consumer warpgroup keeps its 64 rows' lse and delta in registers, runs
//   S = Q K^T and dP = dO V^T as wgmma from shared memory, forms
//   dS = P (dP - delta) scale in registers, rounds it to K's type (the
//   reference's cast) as the A operand of dQ += dS K, and reads K for that
//   product transposed from the same swizzled slot it read for S.  Interior
//   tiles take no mask.  No atomics: one block owns its query rows.
// - Scalar (f32, and 16-bit head dims 16, 32 and 256):
//   flash_bwd_dq_kernel, the first version: scalar f32 FMAs, one block per
//   (64 query rows, head, batch), the mirror of the scalar forward: Q, dO,
//   the row's LSE and delta and the dQ accumulator stay in registers while
//   the block loops over key tiles staged in shared memory as f32, skipping
//   tiles outside the band by position.
#include "flash_tc.cuh"

namespace {

using namespace flash;

template <typename T, int D, typename O>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ qpos, const int* __restrict__ kpos,
                        O* __restrict__ dq, int H, int Hkv, int Sq, int Sk, float scale,
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

  if (row_ok) store_slice<O, D>(dq + q_off, lane, dq_acc, 1.f);
}

template <typename T, int D, typename O>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* qpos, const int* kpos,
                void* dq, int B, int H, int Hkv, int Sq, int Sk, float scale, Band band,
                cudaStream_t stream) {
  if constexpr (route(dtype_code<T>(), D) == kTensorCore) {
    return cudaErrorInvalidValue;  // run_tc's inputs: no scalar instantiation
  } else {
    const dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
    const size_t smem = 2 * TILE * D * sizeof(float);
    return launch(flash_bwd_dq_kernel<T, D, O>, grid, smem, stream, (const T*)q, (const T*)k,
                  (const T*)v, (const T*)dout, lse, delta, qpos, kpos, (O*)dq, H, Hkv, Sq, Sk,
                  scale, band);
  }
}

// --- tensor-core route -------------------------------------------------------

// Tiles of 64 keys through a ring of four slots (three at head dim 128,
// for shared memory), two consumer warpgroups (128 query rows) per block:
// a third would not fit the registers of S, dP, dS and the dQ
// accumulator.  Chosen by measurement on the H100 (PERF.md).
constexpr int DQ_BN = 64;

template <int D> using DqLayout = TcLayout<D, DQ_BN, D == 64 ? 4 : 3, 2, 2>;

template <typename T, int D, typename O>
__global__ void __launch_bounds__(DqLayout<D>::THREADS, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ qpos, const int* __restrict__ kpos,
                           O* __restrict__ dq, int H, int Hkv, int Sq, int Sk, float scale,
                           Band band) {
  using L = DqLayout<D>;
  constexpr int BN = DQ_BN;
  extern __shared__ uint8_t smem_raw[];
  const int bh = blockIdx.x;
  const int kv_plane = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BM;  // longest causal rows first
  const int live = live_consumers<L>(q0, Sq);
  TcBlock<L> blk;
  blk.init(smem_raw, live);

  if (threadIdx.x >= L::CONSUMERS * WG_THREADS) {
    const Sweep sweep{qpos, q0, Sq, kpos, Sk, kv_plane, 1, /*fixed_are_queries=*/true};
    NoSlotExtra no_extra;
    tc_produce<L, BN>(blk, &k_map, &v_map, sweep, band,
                      [&](uint32_t bar) {
                        hopper::mbar_arrive_expect_tx(bar, 2 * live * L::WG_TILE);
                        tma_load_rows<L>(blk.base_s, &q_map, bar, q0, bh, live);
                        tma_load_rows<L>(blk.base_s + L::FIXED_TILE, &do_map, bar, q0, bh, live);
                      },
                      no_extra);
    return;
  }
  if (threadIdx.x >= live * WG_THREADS) return;  // no row below S_q

  const TcRows rows(q0);
  const int qp_a = rows.a < Sq ? position(qpos, rows.a) : 0;
  const int qp_b = rows.b < Sq ? position(qpos, rows.b) : 0;
  const float scale2 = scale * kLog2e;
  // P = exp(S scale - lse) = exp2(S scale2 - lse2)
  const float lse2_a = rows.a < Sq ? lse[(size_t)bh * Sq + rows.a] * kLog2e : 0.f;
  const float lse2_b = rows.b < Sq ? lse[(size_t)bh * Sq + rows.b] * kLog2e : 0.f;
  // dS = P (dP - delta) scale = P (dP scale - delta scale)
  const float delta_a = rows.a < Sq ? delta[(size_t)bh * Sq + rows.a] * scale : 0.f;
  const float delta_b = rows.b < Sq ? delta[(size_t)bh * Sq + rows.b] * scale : 0.f;
  const uint32_t q_tile = blk.base_s + rows.c * L::WG_TILE;
  const uint32_t do_tile = q_tile + L::FIXED_TILE;

  TcStream<L> stream(blk, rows.c, rows.lane);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2], dp[BN / 2];  // S then dS, and dP, of the current tile
  uint32_t ds[BN / 16][4];       // dS of the previous tile in K's type: the A operand of dS K

  auto issue_s_dp = [&](int s) {  // S = Q K^T into sc, dP = dO V^T into dp
    const uint32_t k_tile = blk.stage(s), v_tile = k_tile + L::KV_TILE;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      hopper::Wgmma<T, BN>::ss(sc, kmajor(q_tile, ROW_TILE_BYTES, j),
                               kmajor(k_tile, L::KV_HALF, j), j > 0);
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      hopper::Wgmma<T, BN>::ss(dp, kmajor(do_tile, ROW_TILE_BYTES, j),
                               kmajor(v_tile, L::KV_HALF, j), j > 0);
    }
    hopper::wgmma_commit();
  };
  auto issue_dq = [&](int s) {  // acc += dS K, K read transposed from its slot
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      hopper::Wgmma<T, D>::rs_t(acc, ds[j], mnmajor(blk.stage(s), L::KV_HALF, j), 1);
    }
    hopper::wgmma_commit();
  };
  // dS of the tile into sc.  MASKED is a compile-time copy, so interior
  // tiles carry no mask.
  auto grad_scores = [&](auto masked, int k0) {
    constexpr bool MASKED = decltype(masked)::value;
    uint64_t vis = ~0ull;
    if constexpr (MASKED) vis = tile_visibility<BN>(rows, band, kpos, k0, Sk, qp_a, qp_b);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const bool row_a = i % 4 < 2;
      float p = hopper::exp2_approx(fmaf(sc[i], scale2, -(row_a ? lse2_a : lse2_b)));
      if constexpr (MASKED) p = (vis >> i) & 1 ? p : 0.f;
      sc[i] = p * fmaf(dp[i], scale, -(row_a ? delta_a : delta_b));
    }
  };
  auto run_grad = [&](int kind, int k0) {
    if (kind == kInterior) {
      grad_scores(std::false_type{}, k0);
    } else if (kind == kMasked) {
      grad_scores(std::true_type{}, k0);
    } else {  // kNone: nothing visible, dS = 0
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    }
  };

  // Software pipeline over the tiles, as in the forward: S and dP of tile t
  // are issued first, then dS K of the tile before it, whose dS waits in
  // ds, and dS of t is formed while the tensor cores run both.
  hopper::mbar_wait(blk.fixed_bar(), 0);
  int s, k0, kind;
  if (stream.next(s, k0, kind)) {
    hopper::wgmma_fence();
    issue_s_dp(s);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    run_grad(kind, k0);
    pack_a<T, BN>(sc, ds);
    int prev = s;
    while (stream.next(s, k0, kind)) {
      hopper::wgmma_fence();
      issue_s_dp(s);
      issue_dq(prev);
      hopper::wgmma_wait<1>();  // S and dP of this tile; dS K of the last may run on
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      run_grad(kind, k0);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      stream.release(prev);
      pack_a<T, BN>(sc, ds);
      prev = s;
    }
    hopper::wgmma_fence();
    issue_dq(prev);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    stream.release(prev);
  }

  store_rows<O, D>(dq + (size_t)bh * Sq * D, rows, Sq, acc, 1.f, 1.f);
}

template <typename T, int D, typename O>
cudaError_t run_tc(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* qpos, const int* kpos,
                   void* dq, int B, int H, int Hkv, int Sq, int Sk, float scale, Band band,
                   cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (hopper::encode_rows_map(&q_map, q, bf16, D, Sq, B * H, 64) != CUDA_SUCCESS ||
      hopper::encode_rows_map(&k_map, k, bf16, D, Sk, B * Hkv, DQ_BN) != CUDA_SUCCESS ||
      hopper::encode_rows_map(&v_map, v, bf16, D, Sk, B * Hkv, DQ_BN) != CUDA_SUCCESS ||
      hopper::encode_rows_map(&do_map, dout, bf16, D, Sq, B * H, 64) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  return launch_tc<DqLayout<D>>(flash_bwd_dq_tc_kernel<T, D, O>, B * H, Sq, stream, q_map, k_map,
                                v_map, do_map, lse, delta, qpos, kpos, (O*)dq, H, Hkv, Sq, Sk,
                                scale, band);
}

}  // namespace

// q, dout (B, H, Sq, D); k, v (B, Hkv, Sk, D); lse, delta (B, H, Sq) f32;
// qpos (Sq) and kpos (Sk) int32 or null for 0..S-1; dq (B, H, Sq, D) in
// out_dtype (q's type or f32).  window < 0 means no window.  Returns the
// first CUDA error, 0 on success.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* qpos,
                            const void* kpos, void* dq, int dtype, int out_dtype, int B, int H,
                            int Hkv, int Sq, int Sk, int D, float scale, int causal, int window,
                            int sinks, void* stream) {
  const Band band{causal, window, sinks};
  switch (route(dtype, D)) {
    case kTensorCore:
      return (int)FLASH_TC_DISPATCH(dtype, out_dtype, D, run_tc, q, k, v, dout, (const float*)lse,
                                    (const float*)delta, (const int*)qpos, (const int*)kpos, dq,
                                    B, H, Hkv, Sq, Sk, scale, band, (cudaStream_t)stream);
    case kScalar:
      return (int)FLASH_DISPATCH(dtype, out_dtype, D, run, q, k, v, dout, (const float*)lse,
                                 (const float*)delta, (const int*)qpos, (const int*)kpos, dq, B,
                                 H, Hkv, Sq, Sk, scale, band, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The route flash_bwd_dq takes for (dtype, D): 1 tensor cores, 0 scalar.
extern "C" int flash_bwd_dq_route(int dtype, int D) { return route(dtype, D); }
