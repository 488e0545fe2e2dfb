// Flash-attention backward, dK and dV sweep, for Hopper.
//
// Replaces: _flash_bwd_dkdv_kernel, launched by _flash_backward.run_dkdv
// (covalent_tpu_plugin/ops/attention.py), the Pallas TPU kernel.
//
// What bounds it on this card: it recomputes every visible score, then does
// the dP, dV and dK products, four products of 2 d FLOPs each per visible
// pair: at the training shape (B=8, H=12, S=1024, D=64, bf16, causal, 50.38 M
// visible pairs) 25.8 GFLOP against ~76 MB moved (Q, K, V, dO, dK, dV, lse
// and delta once each), above the card's ~295 operations per byte, so its
// floor is the tensor cores' rate.
//
// Two routes, chosen by route() in flash_common.cuh on (dtype, head dim):
//
// - Tensor cores (bf16/f16, head dim 64 or 128): flash_bwd_dkdv_tc_kernel,
//   the dQ kernel's shape with the roles of queries and keys exchanged
//   (flash_tc.cuh).  A block owns 64 key rows per consumer warpgroup; the
//   producer (one warp of a warpgroup that lends the consumers its
//   registers) loads their K and V once and streams (query tile, query
//   head) pairs of the GQA group through the TMA ring: a slot holds the
//   tile's Q and dO and, written by the producer's lanes, its 64 lse and
//   delta values.  Each consumer runs S^T = K Q^T and dP^T = V dO^T as
//   wgmma from shared memory, forms P^T and dS^T = P^T (dP^T - delta) scale
//   in registers, rounds them to dO's and Q's type (the reference's casts)
//   as the A operands of dV += P^T dO and dK += dS^T Q, and reads dO and Q
//   for those products transposed from the same swizzled slot it read for
//   S^T and dP^T.  Interior tiles take no mask.  No atomics and no second
//   pass: one block owns its key rows for every query head of the group.
// - Scalar (f32, and 16-bit head dims 16, 32 and 256):
//   flash_bwd_dkdv_kernel, the first version: scalar f32 FMAs, one block per
//   (key tile of 64 rows, kv head, batch).  K, V and the dK, dV accumulators
//   of the block's rows stay in registers for the whole sweep; the block
//   loops over the G query heads of its GQA group and over their query
//   tiles, staging each Q and dO tile once in shared memory as f32 and
//   skipping query tiles that cannot see the key tile (by position, as
//   _band_tile_needed decides) before they are loaded.
#include "flash_tc.cuh"

namespace {

using namespace flash;

template <typename T, int D, typename O>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ qpos, const int* __restrict__ kpos,
                          O* __restrict__ dk, O* __restrict__ dv, int H, int Hkv, int Sq,
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
    store_slice<O, D>(dk + kv_off, lane, dk_acc, 1.f);
    store_slice<O, D>(dv + kv_off, lane, dv_acc, 1.f);
  }
}

template <typename T, int D, typename O>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* qpos, const int* kpos,
                void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                Band band, cudaStream_t stream) {
  if constexpr (route(dtype_code<T>(), D) == kTensorCore) {
    return cudaErrorInvalidValue;  // run_tc's inputs: no scalar instantiation
  } else {
    const dim3 grid((Sk + ROWS - 1) / ROWS, Hkv, B);
    const size_t smem = (2 * TILE * D + 2 * TILE) * sizeof(float);
    return launch(flash_bwd_dkdv_kernel<T, D, O>, grid, smem, stream, (const T*)q, (const T*)k,
                  (const T*)v, (const T*)dout, lse, delta, qpos, kpos, (O*)dk, (O*)dv, H, Hkv,
                  Sq, Sk, scale, band);
  }
}

// --- tensor-core route -------------------------------------------------------

// Tiles of 64 queries through a ring of slots; a slot carries the tile's Q
// and dO and its lse (in base-2 units) and delta * scale.  Two consumer
// warpgroups (128 key rows) and a producer warpgroup, one warp of which
// produces.  Chosen by measurement on the H100 (PERF.md):
//
// - A block of 288 threads (a producer warp) gets at most 168 registers a
//   thread: ptxas rounds the block up to whole warpgroups.  At head dim 64
//   a consumer holds the dK and dV accumulators, S^T and dP^T of one tile
//   and P^T and dS^T of the one before (160 registers) and more for
//   addresses and masks, so with a producer warp the loop spilled.  A
//   producer warpgroup that gives up registers (setmaxnreg: 40 for it, 232
//   for each consumer) all but removes the spills and was faster.
// - At head dim 128 the two accumulators alone take 128 registers, so the
//   software pipeline (which keeps a second tile's P^T and dS^T live) does
//   not fit: the consumer runs each slot's four products in turn, and the
//   other consumer's products fill the tensor cores meanwhile.  It still
//   spills some.  One consumer with a producer warp, pipelined or not, was
//   slower.
// - Four slots at head dim 64, three at 128 (three and four timed the same
//   at 64; six do not fit the shared memory at 128).
constexpr int DKDV_BN = 64;
constexpr int DKDV_PRODUCER_REGS = 40, DKDV_CONSUMER_REGS = 232;
static_assert(WG_THREADS * (DKDV_PRODUCER_REGS + 2 * DKDV_CONSUMER_REGS) <= 65536,
              "the block's registers exceed the SM's");

template <int D>
using DkdvLayout = TcLayout<D, DKDV_BN, D == 64 ? 4 : 3, 2, 2, 2 * DKDV_BN * (int)sizeof(float),
                            WG_THREADS>;

// The slot's lse (in base-2 units) and delta * scale for its query tile,
// which the producer's lanes read ahead and write into the slot; 0 past
// S_q.
template <typename L> struct LseDelta {
  const TcBlock<L>& blk;
  const float* lse;
  const float* delta;
  int Sq;
  float scale;
  float l[DKDV_BN / 32], d[DKDV_BN / 32];
  __device__ __forceinline__ void fetch(int t0, int plane) {
#pragma unroll
    for (int r = 0; r < DKDV_BN / 32; ++r) {
      const int qi = t0 + r * 32 + threadIdx.x % 32;
      const bool ok = qi < Sq;
      l[r] = ok ? lse[(size_t)plane * Sq + qi] * kLog2e : 0.f;
      d[r] = ok ? delta[(size_t)plane * Sq + qi] * scale : 0.f;
    }
  }
  __device__ __forceinline__ void store(int s) {
    float* x = blk.extra(s);
#pragma unroll
    for (int r = 0; r < DKDV_BN / 32; ++r) {
      x[r * 32 + threadIdx.x % 32] = l[r];
      x[DKDV_BN + r * 32 + threadIdx.x % 32] = d[r];
    }
  }
};

template <typename T, int D, typename O>
__global__ void __launch_bounds__(DkdvLayout<D>::THREADS, 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const int* __restrict__ qpos, const int* __restrict__ kpos,
                             O* __restrict__ dk, O* __restrict__ dv, int H, int Hkv, int Sq,
                             int Sk, float scale, Band band) {
  using L = DkdvLayout<D>;
  constexpr int BN = DKDV_BN;
  extern __shared__ uint8_t smem_raw[];
  const int kv_plane = blockIdx.x;  // b * Hkv + kv head
  const int group = H / Hkv;
  const int q_plane0 = (kv_plane / Hkv) * H + (kv_plane % Hkv) * group;
  const int k0 = blockIdx.y * L::BM;  // lowest keys, the most causal work, first
  const int live = live_consumers<L>(k0, Sk);
  TcBlock<L> blk;
  blk.init(smem_raw, live);

  if (threadIdx.x >= L::CONSUMERS * WG_THREADS) {
    hopper::setmaxnreg_dec<DKDV_PRODUCER_REGS>();
    if (threadIdx.x >= L::CONSUMERS * WG_THREADS + 32) return;  // one warp produces
    const Sweep sweep{kpos, k0, Sk, qpos, Sq, q_plane0, group, /*fixed_are_queries=*/false};
    LseDelta<L> extra{blk, lse, delta, Sq, scale};
    tc_produce<L, BN>(
        blk, &q_map, &do_map, sweep, band,
        [&](uint32_t bar) {
          hopper::mbar_arrive_expect_tx(bar, 2 * live * L::WG_TILE);
          tma_load_rows<L>(blk.base_s, &k_map, bar, k0, kv_plane, live);
          tma_load_rows<L>(blk.base_s + L::FIXED_TILE, &v_map, bar, k0, kv_plane, live);
        },
        extra);
    return;
  }
  hopper::setmaxnreg_inc<DKDV_CONSUMER_REGS>();
  if (threadIdx.x >= live * WG_THREADS) return;  // no key row below S_k

  const TcRows rows(k0);
  const int kp_a = rows.a < Sk ? position(kpos, rows.a) : 0;
  const int kp_b = rows.b < Sk ? position(kpos, rows.b) : 0;
  const float scale2 = scale * kLog2e;
  const uint32_t k_tile = blk.base_s + rows.c * L::WG_TILE;
  const uint32_t v_tile = k_tile + L::FIXED_TILE;

  TcStream<L> stream(blk, rows.c, rows.lane);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st[BN / 2], dpt[BN / 2];  // S^T then P^T, and dP^T then dS^T, of the current tile
  uint32_t pt[BN / 16][4];   // P^T in dO's type: the A operand of dV += P^T dO
  uint32_t dst[BN / 16][4];  // dS^T in Q's type: the A operand of dK += dS^T Q

  auto issue_s_dp = [&](int s) {  // S^T = K Q^T into st, dP^T = V dO^T into dpt
    const uint32_t q_slot = blk.stage(s), do_slot = q_slot + L::KV_TILE;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      hopper::Wgmma<T, BN>::ss(st, kmajor(k_tile, ROW_TILE_BYTES, j),
                               kmajor(q_slot, L::KV_HALF, j), j > 0);
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      hopper::Wgmma<T, BN>::ss(dpt, kmajor(v_tile, ROW_TILE_BYTES, j),
                               kmajor(do_slot, L::KV_HALF, j), j > 0);
    }
    hopper::wgmma_commit();
  };
  // dV += P^T dO and dK += dS^T Q, dO and Q read transposed from their slot
  auto issue_dkdv = [&](int s) {
    const uint32_t q_slot = blk.stage(s), do_slot = q_slot + L::KV_TILE;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      hopper::Wgmma<T, D>::rs_t(dv_acc, pt[j], mnmajor(do_slot, L::KV_HALF, j), 1);
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      hopper::Wgmma<T, D>::rs_t(dk_acc, dst[j], mnmajor(q_slot, L::KV_HALF, j), 1);
    }
    hopper::wgmma_commit();
  };
  // P^T into st and dS^T into dpt.  A column's lse and delta come from the
  // slot.  MASKED is a compile-time copy, so interior tiles carry no mask;
  // the mask is a select, never a product: a query that sees no key has lse
  // -1e30, so its P before the mask is +inf.
  auto grad_scores = [&](auto masked, int s, int t0) {
    constexpr bool MASKED = decltype(masked)::value;
    uint64_t vis = ~0ull;
    if constexpr (MASKED) vis = tile_visibility<BN, true>(rows, band, qpos, t0, Sq, kp_a, kp_b);
    const float2* lse2 = reinterpret_cast<const float2*>(blk.extra(s));
    const float2* dsc = lse2 + BN / 2;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 l = lse2[4 * i + rows.col / 2];  // columns 8 i + col and + 1
      const float2 d = dsc[4 * i + rows.col / 2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * i + e;
        float p = hopper::exp2_approx(fmaf(st[r], scale2, -(e % 2 ? l.y : l.x)));
        if constexpr (MASKED) p = (vis >> r) & 1 ? p : 0.f;
        st[r] = p;
        dpt[r] = p * fmaf(dpt[r], scale, -(e % 2 ? d.y : d.x));
      }
    }
  };
  auto run_grad = [&](int kind, int s, int t0) {
    if (kind == kInterior) {
      grad_scores(std::false_type{}, s, t0);
    } else if (kind == kMasked) {
      grad_scores(std::true_type{}, s, t0);
    } else {  // kNone: nothing visible, P = dS = 0
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) st[i] = dpt[i] = 0.f;
    }
  };
  auto pack = [&]() {
    pack_a<T, BN>(st, pt);
    pack_a<T, BN>(dpt, dst);
  };

  // Head dim 64: a software pipeline over the slots, as in the dQ kernel:
  // S^T and dP^T of tile t are issued first, then dV and dK of the tile
  // before it, whose P^T and dS^T wait in pt and dst, and P^T and dS^T of t
  // are formed while the tensor cores run both.  Head dim 128: one slot at
  // a time, for registers (see DkdvLayout).
  hopper::mbar_wait(blk.fixed_bar(), 0);
  int s, t0, kind;
  if constexpr (D == 128) {
    while (stream.next(s, t0, kind)) {
      hopper::wgmma_fence();
      issue_s_dp(s);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      run_grad(kind, s, t0);
      pack();
      hopper::wgmma_fence();
      issue_dkdv(s);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      stream.release(s);
    }
  } else if (stream.next(s, t0, kind)) {
    hopper::wgmma_fence();
    issue_s_dp(s);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    run_grad(kind, s, t0);
    pack();
    int prev = s;
    while (stream.next(s, t0, kind)) {
      hopper::wgmma_fence();
      issue_s_dp(s);
      issue_dkdv(prev);
      hopper::wgmma_wait<1>();  // S^T and dP^T of this tile; dV and dK of the last may run on
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      run_grad(kind, s, t0);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      stream.release(prev);
      pack();
      prev = s;
    }
    hopper::wgmma_fence();
    issue_dkdv(prev);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(dv_acc);
    stream.release(prev);
  }

  store_rows<O, D>(dk + (size_t)kv_plane * Sk * D, rows, Sk, dk_acc, 1.f, 1.f);
  store_rows<O, D>(dv + (size_t)kv_plane * Sk * D, rows, Sk, dv_acc, 1.f, 1.f);
}

template <typename T, int D, typename O>
cudaError_t run_tc(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* qpos, const int* kpos,
                   void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                   Band band, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (hopper::encode_rows_map(&q_map, q, bf16, D, Sq, B * H, DKDV_BN) != CUDA_SUCCESS ||
      hopper::encode_rows_map(&k_map, k, bf16, D, Sk, B * Hkv, 64) != CUDA_SUCCESS ||
      hopper::encode_rows_map(&v_map, v, bf16, D, Sk, B * Hkv, 64) != CUDA_SUCCESS ||
      hopper::encode_rows_map(&do_map, dout, bf16, D, Sq, B * H, DKDV_BN) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  return launch_tc<DkdvLayout<D>>(flash_bwd_dkdv_tc_kernel<T, D, O>, B * Hkv, Sk, stream, q_map,
                                  k_map, v_map, do_map, lse, delta, qpos, kpos, (O*)dk, (O*)dv,
                                  H, Hkv, Sq, Sk, scale, band);
}

}  // namespace

// q, dout (B, H, Sq, D); k, v (B, Hkv, Sk, D); lse, delta (B, H, Sq) f32;
// qpos (Sq) and kpos (Sk) int32 or null for 0..S-1; dk, dv (B, Hkv, Sk, D)
// in out_dtype (k's type or f32).  window < 0 means no window.  Returns the
// first CUDA error.
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* qpos,
                              const void* kpos, void* dk, void* dv, int dtype, int out_dtype,
                              int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
                              int causal, int window, int sinks, void* stream) {
  const Band band{causal, window, sinks};
  switch (route(dtype, D)) {
    case kTensorCore:
      return (int)FLASH_TC_DISPATCH(dtype, out_dtype, D, run_tc, q, k, v, dout, (const float*)lse,
                                    (const float*)delta, (const int*)qpos, (const int*)kpos, dk,
                                    dv, B, H, Hkv, Sq, Sk, scale, band, (cudaStream_t)stream);
    case kScalar:
      return (int)FLASH_DISPATCH(dtype, out_dtype, D, run, q, k, v, dout, (const float*)lse,
                                 (const float*)delta, (const int*)qpos, (const int*)kpos, dk, dv,
                                 B, H, Hkv, Sq, Sk, scale, band, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The route flash_bwd_dkdv takes for (dtype, D): 1 tensor cores, 0 scalar.
extern "C" int flash_bwd_dkdv_route(int dtype, int D) { return route(dtype, D); }
