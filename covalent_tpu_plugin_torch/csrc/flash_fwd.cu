// Flash-attention forward for Hopper.
//
// Replaces: _flash_kernel, launched by _flash_forward
// (covalent_tpu_plugin/ops/attention.py), the Pallas TPU kernel.
//
// What bounds it on this card: at the training shape (B=8, H=12, S=1024,
// D=64, bf16, causal) the function does ~12.9 GFLOP against ~25 MB of
// inputs and outputs, ~500 operations per byte, so its floor is the tensor
// cores' rate, not memory.
//
// Two routes, chosen by route() in flash_common.cuh on (dtype, head dim):
//
// - Tensor cores (bf16/f16, head dim 64 or 128): flash_fwd_tc_kernel.  One
//   block per (128 query rows, head, batch), query tiles in reverse order so
//   the longest causal rows start first.  A producer warp loads Q once and
//   streams K/V tiles of 64 keys through a ring of shared-memory slots with
//   TMA (see flash_tc.cuh); two consumer warpgroups of 64 rows each run
//   S = Q K^T as wgmma from shared memory, keep S, the row max and sum and
//   the output accumulator in registers, turn P (rounded to V's type, as the
//   reference casts it) into the A operand of O += P V in registers, and
//   read V transposed from the same swizzled slot.  Interior tiles take no
//   mask.  The softmax runs in base 2 with log2(e) folded into the scale;
//   lse is stored in natural log.
// - Scalar (f32, where the tensor cores would compute in TF32, and 16-bit
//   head dims 16, 32 and 256): flash_fwd_kernel, the first version.  Its
//   products are scalar f32 FMAs on the CUDA cores; one block per (64 query
//   rows, head, batch) loops over key tiles staged in shared memory as f32,
//   with the running max, sum and accumulator in registers, and skips tiles
//   outside the band by position (_band_tile_needed).  The scores of a tile
//   go through shared memory once so that the running max is rescaled once
//   per tile, as in the reference.
#include "flash_tc.cuh"

namespace {

using namespace flash;

template <typename T, int D, typename O>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, O* __restrict__ o,
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
    store_slice<O, D>(o + ((size_t)(b * H + h) * Sq + qi) * D, lane, acc, l_safe);
    if (lane == 0) lse[(size_t)(b * H + h) * Sq + qi] = m + logf(l_safe);
  }
}

template <typename T, int D, typename O>
cudaError_t run(const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, void* o, float* lse, int B, int H, int Hkv, int Sq, int Sk,
                float scale, Band band, cudaStream_t stream) {
  if constexpr (route(dtype_code<T>(), D) == kTensorCore) {
    return cudaErrorInvalidValue;  // run_tc's inputs: no scalar instantiation
  } else {
    const dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
    const size_t smem = (2 * TILE * D + ROWS * (TILE + 1)) * sizeof(float);
    return launch(flash_fwd_kernel<T, D, O>, grid, smem, stream, (const T*)q, (const T*)k,
                  (const T*)v, qpos, kpos, (O*)o, lse, H, Hkv, Sq, Sk, scale, band);
  }
}

// --- tensor-core route -------------------------------------------------------

// Tiles of 64 keys through a ring of four slots.  At head dim 64 three
// consumer warpgroups (192 query rows) take a block; at 128 the registers
// allow two.  Chosen by measurement on the H100 (PERF.md).
constexpr int FWD_BN = 64;

template <int D> using FwdLayout = TcLayout<D, FWD_BN, 4, 1, D == 64 ? 3 : 2>;

template <typename T, int D, typename O>
__global__ void __launch_bounds__(FwdLayout<D>::THREADS, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map, const int* __restrict__ qpos,
                        const int* __restrict__ kpos, O* __restrict__ o,
                        float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, float scale,
                        Band band) {
  using L = FwdLayout<D>;
  constexpr int BN = FWD_BN;
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
                        hopper::mbar_arrive_expect_tx(bar, live * L::WG_TILE);
                        tma_load_rows<L>(blk.base_s, &q_map, bar, q0, bh, live);
                      },
                      no_extra);
    return;
  }
  if (threadIdx.x >= live * WG_THREADS) return;  // no row below S_q

  const TcRows rows(q0);
  const int qp_a = rows.a < Sq ? position(qpos, rows.a) : 0;
  const int qp_b = rows.b < Sq ? position(qpos, rows.b) : 0;
  const float scale2 = scale * kLog2e;  // scores in base-2 units
  const uint32_t q_tile = blk.base_s + rows.c * L::WG_TILE;
  TcStream<L> stream(blk, rows.c, rows.lane);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's share
  float sc[BN / 2];         // scores, then probabilities, of the current tile
  uint32_t pa[BN / 16][4];  // P of the previous tile in V's type: the A operand of P V

  auto issue_s = [&](int s) {  // S = Q K^T into sc
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      hopper::Wgmma<T, BN>::ss(sc, kmajor(q_tile, ROW_TILE_BYTES, j),
                               kmajor(blk.stage(s), L::KV_HALF, j), j > 0);
    }
    hopper::wgmma_commit();
  };
  auto issue_pv = [&](int s) {  // acc += P V
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t v_tile = blk.stage(s) + L::KV_TILE;
      hopper::Wgmma<T, D>::rs_t(acc, pa[j], mnmajor(v_tile, L::KV_HALF, j), 1);
    }
    hopper::wgmma_commit();
  };
  // Online softmax of the tile in sc: updates m and l, leaves P (f32) in sc
  // and returns the factors the accumulator is to be rescaled by.  MASKED
  // is a compile-time copy, so interior tiles carry no mask.
  auto softmax = [&](auto masked, int k0, float& alpha_a, float& alpha_b) {
    constexpr bool MASKED = decltype(masked)::value;
    uint64_t vis = ~0ull;
    if constexpr (MASKED) {
      vis = tile_visibility<BN>(rows, band, kpos, k0, Sk, qp_a, qp_b);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = (vis >> i) & 1 ? sc[i] : kNegInf;
    }
    // Row max of the raw scores: scale > 0, so it scales to the max of
    // the scaled scores.  In base-2 units; a row with no visible key keeps
    // the reference's -1e30.
    float max_a, max_b;
    row_max(sc, max_a, max_b);
    max_a = quad_max(max_a);
    max_b = quad_max(max_b);
    const float new_a = fmaxf(m_a, max_a == kNegInf ? kNegInf : max_a * scale2);
    const float new_b = fmaxf(m_b, max_b == kNegInf ? kNegInf : max_b * scale2);
    alpha_a = hopper::exp2_approx(m_a - new_a);
    alpha_b = hopper::exp2_approx(m_b - new_b);
    m_a = new_a;
    m_b = new_b;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float p = hopper::exp2_approx(fmaf(sc[i], scale2, -(i % 4 < 2 ? new_a : new_b)));
      // a masked probability is exactly 0, even in a row with no visible key yet
      if constexpr (MASKED) p = (vis >> i) & 1 ? p : 0.f;
      sc[i] = p;
    }
    float sum_a, sum_b;
    row_sum(sc, sum_a, sum_b);
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
  };
  auto rescale = [&](float alpha_a, float alpha_b) {
    if (!__all_sync(0xffffffffu, alpha_a == 1.f && alpha_b == 1.f)) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= i % 4 < 2 ? alpha_a : alpha_b;
    }
  };
  auto run_softmax = [&](int kind, int k0, float& alpha_a, float& alpha_b) {
    if (kind == kInterior) {
      softmax(std::false_type{}, k0, alpha_a, alpha_b);
    } else if (kind == kMasked) {
      softmax(std::true_type{}, k0, alpha_a, alpha_b);
    } else {  // kNone: nothing visible, P = 0
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      alpha_a = alpha_b = 1.f;
    }
  };

  // Software pipeline over the tiles: while the softmax of tile t runs, the
  // tensor cores compute S of tile t (issued first) and then P V of the
  // tile before it, whose P waits in pa; the accumulator is rescaled once
  // that P V has landed.
  hopper::mbar_wait(blk.fixed_bar(), 0);
  int s, k0, kind;
  if (stream.next(s, k0, kind)) {
    float alpha_a, alpha_b;
    hopper::wgmma_fence();
    issue_s(s);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    run_softmax(kind, k0, alpha_a, alpha_b);
    pack_a<T, BN>(sc, pa);
    int prev = s;
    while (stream.next(s, k0, kind)) {
      hopper::wgmma_fence();
      issue_s(s);
      issue_pv(prev);
      hopper::wgmma_wait<1>();  // S of this tile; P V of the last may run on
      hopper::fence_regs(sc);
      run_softmax(kind, k0, alpha_a, alpha_b);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      stream.release(prev);
      rescale(alpha_a, alpha_b);
      pack_a<T, BN>(sc, pa);
      prev = s;
    }
    hopper::wgmma_fence();
    issue_pv(prev);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    stream.release(prev);
  }

  const float ls_a = fmaxf(quad_sum(l_a), 1e-37f), ls_b = fmaxf(quad_sum(l_b), 1e-37f);
  store_rows<O, D>(o + (size_t)bh * Sq * D, rows, Sq, acc, 1.f / ls_a, 1.f / ls_b);
  if (rows.lane % 4 == 0) {
    // m is in base-2 units; a row that saw no key keeps the reference's -1e30
    float* row_lse = lse + (size_t)bh * Sq;
    if (rows.a < Sq) row_lse[rows.a] = (m_a == kNegInf ? kNegInf : m_a * kLn2) + logf(ls_a);
    if (rows.b < Sq) row_lse[rows.b] = (m_b == kNegInf ? kNegInf : m_b * kLn2) + logf(ls_b);
  }
}

template <typename T, int D, typename O>
cudaError_t run_tc(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                   void* o, float* lse, int B, int H, int Hkv, int Sq, int Sk, float scale,
                   Band band, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap q_map, k_map, v_map;
  if (hopper::encode_rows_map(&q_map, q, bf16, D, Sq, B * H, 64) != CUDA_SUCCESS ||
      hopper::encode_rows_map(&k_map, k, bf16, D, Sk, B * Hkv, FWD_BN) != CUDA_SUCCESS ||
      hopper::encode_rows_map(&v_map, v, bf16, D, Sk, B * Hkv, FWD_BN) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  return launch_tc<FwdLayout<D>>(flash_fwd_tc_kernel<T, D, O>, B * H, Sq, stream, q_map, k_map,
                                 v_map, qpos, kpos, (O*)o, lse, H, Hkv, Sq, Sk, scale, band);
}

}  // namespace

// q (B, H, Sq, D); k, v (B, Hkv, Sk, D); qpos (Sq) and kpos (Sk) int32 or
// null for 0..S-1; o (B, H, Sq, D) in out_dtype (q's type or f32); lse
// (B, H, Sq) f32.  window < 0 means no window.  Returns the first CUDA
// error, 0 on success.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* qpos,
                         const void* kpos, void* o, void* lse, int dtype, int out_dtype,
                         int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
                         int window, int sinks, void* stream) {
  const Band band{causal, window, sinks};
  switch (route(dtype, D)) {
    case kTensorCore:
      return (int)FLASH_TC_DISPATCH(dtype, out_dtype, D, run_tc, q, k, v, (const int*)qpos,
                                    (const int*)kpos, o, (float*)lse, B, H, Hkv, Sq, Sk, scale,
                                    band, (cudaStream_t)stream);
    case kScalar:
      return (int)FLASH_DISPATCH(dtype, out_dtype, D, run, q, k, v, (const int*)qpos, (const int*)kpos, o,
                                 (float*)lse, B, H, Hkv, Sq, Sk, scale, band,
                                 (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The route flash_fwd takes for (dtype, D): 1 tensor cores, 0 scalar.
extern "C" int flash_fwd_route(int dtype, int D) { return route(dtype, D); }
