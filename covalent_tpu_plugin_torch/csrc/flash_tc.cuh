// What the tensor-core flash kernels (the 16-bit, head dim 64 and 128 route
// of flash_fwd.cu and flash_bwd_dq.cu) share: the block shape, the
// shared-memory layout, the producer warp that feeds key/value tiles, and
// the row helpers of the wgmma accumulator layout.
//
// Block shape.  CONSUMERS warpgroups of 128 threads each own 64 query rows
// (BM = 64 * CONSUMERS rows per block); one more warp is the producer.  The
// producer loads the block's fixed operands (Q, and dO for the dQ sweep)
// once, then walks the key tiles in order and, for every tile that some
// consumer needs, waits for a free slot of the STAGES-deep ring, writes the
// tile's description (its first key and, per consumer, whether it sees
// none of the tile, some of it or all of it) and has TMA load its K and V
// into the slot.  A slot whose first key is negative ends the sweep.
// Consumers wait on the slot's "full" barrier, run their products, and
// release it on its "empty" barrier (one arrival per consumer warp).  A
// tile no consumer needs is never loaded; a tile only one consumer needs
// goes through both, and the other takes it as kNone (P = 0, no softmax):
// the loop that issues the products stays free of branches, which ptxas
// would answer by serialising every wgmma.
//
// Tile kinds come from the positions' min and max over the tile, as
// _band_tile_needed decides in the reference: a tile outside the band is
// kNone; a whole tile every pair of which is visible is an interior tile
// and takes no mask (the reference's interior path); every other tile is
// masked pair by pair, including key rows past S_k, which TMA fills with
// zeros but the reference masks to -1e30.
#pragma once

#include <climits>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash {

constexpr int WG_THREADS = 128;
constexpr int MAX_CONSUMERS = 4;
constexpr int ROW_TILE_BYTES = 64 * 128;  // 64 rows of one 64-column half
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Per warpgroup: no pair of the tile is visible (its P is 0), some are, or all are.
enum TileKind : int { kNone = 0, kMasked = 1, kInterior = 2 };

struct TileMeta {
  int k0;  // first key of the tile; < 0 ends the sweep
  int kind[MAX_CONSUMERS];
};

// Block shape and shared memory of one block: CONSUMERS warpgroups of 64
// query rows each (BM rows) plus the producer warp; from a 1024-byte
// aligned base, FIXED operand tiles of (BM, D) (Q; Q and dO), then STAGES
// slots of a (BN, D) K tile and a (BN, D) V tile, then the barriers and the
// slots' descriptions.  An operand of head dim 128 is stored as two
// 64-column halves.
template <int D, int BN, int STAGES, int FIXED, int NCONSUMERS> struct TcLayout {
  static_assert(NCONSUMERS <= MAX_CONSUMERS, "too many consumer warpgroups");
  static constexpr int CONSUMERS = NCONSUMERS;
  static constexpr int BM = 64 * CONSUMERS;
  static constexpr int THREADS = WG_THREADS * CONSUMERS + 32;
  static constexpr int NSTAGES = STAGES;
  static constexpr int HALVES = D / 64;
  static constexpr int WG_TILE = HALVES * ROW_TILE_BYTES;  // one consumer's (64, D)
  static constexpr int FIXED_TILE = CONSUMERS * WG_TILE;   // one (BM, D) operand
  static constexpr int KV_HALF = BN * 128;                 // one half of a (BN, D) tile
  static constexpr int KV_TILE = HALVES * KV_HALF;
  static constexpr int STAGE = 2 * KV_TILE;
  static constexpr int STAGES_AT = FIXED * FIXED_TILE;
  static constexpr int BARS_AT = STAGES_AT + STAGES * STAGE;
  static constexpr int META_AT = BARS_AT + 8 * (1 + 2 * STAGES);
  static constexpr int BYTES = META_AT + (int)sizeof(TileMeta) * STAGES + 1024;  // + alignment
};

// Every pair of the position ranges is visible (the tile needs no mask).
__device__ __forceinline__ bool all_visible(const Band& band, int qmin, int qmax, int kmin,
                                            int kmax) {
  if (!band.causal) return true;
  if (kmax > qmin) return false;
  return band.window < 0 || qmax - kmin < band.window ||
         (band.sinks > 0 && kmax < band.sinks);
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Max / sum over the four threads that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Descriptor of k-step j (16 columns of the contraction dim) of a K-major
// tile whose 64-column halves are `half` bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int half, int j) {
  return hopper::desc_sw128(tile + (j / 4) * half + (j % 4) * 32, 16, 1024);
}
// Descriptor of k-step j (16 rows of the contraction dim) of an MN-major
// tile whose 64-column halves are `half` bytes apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int half, int j) {
  return hopper::desc_sw128(tile + j * 16 * 128, half, 1024);
}

// The block's shared memory: aligned base (generic and shared-window
// address) and the barriers, initialised by thread 0.  Ends synchronised.
// A slot is released by every warp of the `live` consumers (those with a
// row below S); the others return at once.
template <typename L> struct TcBlock {
  uint8_t* base;
  uint32_t base_s;
  __device__ __forceinline__ uint32_t fixed_bar() const { return base_s + L::BARS_AT; }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base_s + L::BARS_AT + 8 + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base_s + L::BARS_AT + 8 + 8 * (L::NSTAGES + s);
  }
  __device__ __forceinline__ uint32_t stage(int s) const {
    return base_s + L::STAGES_AT + s * L::STAGE;
  }
  __device__ __forceinline__ TileMeta* meta() const {
    return reinterpret_cast<TileMeta*>(base + L::META_AT);
  }
  __device__ __forceinline__ void init(uint8_t* raw, int live) {
    const uint32_t raw_s = hopper::smem_addr(raw);
    const uint32_t pad = ((raw_s + 1023u) & ~1023u) - raw_s;
    base = raw + pad;
    base_s = raw_s + pad;
    if (threadIdx.x == 0) {
      hopper::mbar_init(fixed_bar(), 1);
      for (int s = 0; s < L::NSTAGES; ++s) {
        hopper::mbar_init(full(s), 1);
        hopper::mbar_init(empty(s), live * 4);
      }
      hopper::mbar_fence_init();
    }
    __syncthreads();
  }
};

// The producer warp.  `load_fixed(bar)` issues, from lane 0, the TMA loads
// of the block's fixed operands on `bar` (and its expect_tx).
template <typename L, int BN, typename LoadFixed>
__device__ __forceinline__ void tc_produce(const TcBlock<L>& blk, const CUtensorMap* k_map,
                                           const CUtensorMap* v_map, const int* qpos,
                                           const int* kpos, int q0, int Sq, int Sk,
                                           int kv_plane, const Band& band,
                                           LoadFixed load_fixed) {
  constexpr int STAGES = L::NSTAGES;
  const int lane = threadIdx.x % 32;
  int qlo[L::CONSUMERS], qhi[L::CONSUMERS];
#pragma unroll
  for (int c = 0; c < L::CONSUMERS; ++c) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < 64; r += 32) {
      const int row = q0 + c * 64 + r;
      if (row < Sq) {
        const int p = position(qpos, row);
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
    qlo[c] = warp_min(lo);
    qhi[c] = warp_max(hi);
  }
  if (lane == 0) load_fixed(blk.fixed_bar());

  int it = 0;
  for (int k0 = 0; k0 < Sk; k0 += BN) {
    const int n_k = min(BN, Sk - k0);
    int kmin = k0, kmax = k0 + n_k - 1;
    if (kpos) {
      int lo = INT_MAX, hi = INT_MIN;
      for (int j = lane; j < n_k; j += 32) {
        lo = min(lo, kpos[k0 + j]);
        hi = max(hi, kpos[k0 + j]);
      }
      kmin = warp_min(lo);
      kmax = warp_max(hi);
    }
    TileMeta meta;
    meta.k0 = k0;
    bool any = false;
#pragma unroll
    for (int c = 0; c < L::CONSUMERS; ++c) {
      int kind = kNone;
      if (q0 + c * 64 < Sq && tile_needed(band, qlo[c], qhi[c], kmin, kmax)) {
        kind = n_k == BN && all_visible(band, qlo[c], qhi[c], kmin, kmax) ? kInterior : kMasked;
      }
      meta.kind[c] = kind;
      any = any || kind != kNone;
    }
    if (!any) continue;
    const int s = it % STAGES;
    hopper::mbar_wait(blk.empty(s), ((it / STAGES) & 1) ^ 1);
    if (lane == 0) {
      blk.meta()[s] = meta;
      hopper::mbar_arrive_expect_tx(blk.full(s), L::STAGE);
      const uint32_t k_dst = blk.stage(s), v_dst = k_dst + L::KV_TILE;
#pragma unroll
      for (int h = 0; h < L::HALVES; ++h) {
        hopper::tma_load_3d(k_dst + h * L::KV_HALF, k_map, blk.full(s), h * 64, k0, kv_plane);
        hopper::tma_load_3d(v_dst + h * L::KV_HALF, v_map, blk.full(s), h * 64, k0, kv_plane);
      }
    }
    __syncwarp();
    ++it;
  }
  const int s = it % STAGES;
  hopper::mbar_wait(blk.empty(s), ((it / STAGES) & 1) ^ 1);
  if (lane == 0) {
    blk.meta()[s].k0 = -1;
    hopper::mbar_arrive(blk.full(s));
  }
}

// Consumers of the block that own at least one row below S.
template <typename L> __device__ __forceinline__ int live_consumers(int q0, int S) {
  return min(L::CONSUMERS, (S - q0 + 63) / 64);
}

// A consumer warpgroup's walk over the slots the producer fills.  next()
// waits for the next slot and returns false at the end of the sweep;
// release() frees a slot once the last product that reads it has completed
// (one arrival per warp).  Every warpgroup takes every slot (a tile it does
// not need is kNone to it), so a warpgroup holds at most the slot before
// the one it waits for, and the ring cannot deadlock with two or more
// slots.
template <typename L> struct TcStream {
  const TcBlock<L>& blk;
  int c, lane;
  int it = 0;
  __device__ __forceinline__ TcStream(const TcBlock<L>& b, int consumer, int lane_)
      : blk(b), c(consumer), lane(lane_) {}
  __device__ __forceinline__ bool next(int& s, int& k0, int& kind) {
    s = it % L::NSTAGES;
    hopper::mbar_wait(blk.full(s), (it / L::NSTAGES) & 1);
    ++it;
    k0 = blk.meta()[s].k0;
    kind = blk.meta()[s].kind[c];
    return k0 >= 0;
  }
  __device__ __forceinline__ void release(int s) const {
    if (lane == 0) hopper::mbar_arrive(blk.empty(s));
  }
};

// Row max / row sum of the thread's two rows of an accumulator tile
// (entries 4 i + {0, 1} are row a, 4 i + {2, 3} row b), as four
// independent chains per row joined at the end.
template <int N> __device__ __forceinline__ void row_max(const float (&x)[N], float& a, float& b) {
  float pa[4] = {x[0], x[1], x[4], x[5]}, pb[4] = {x[2], x[3], x[6], x[7]};
#pragma unroll
  for (int i = 8; i < N; i += 8) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pa[e] = fmaxf(pa[e], x[i + e]);
      pa[2 + e] = fmaxf(pa[2 + e], x[i + 4 + e]);
      pb[e] = fmaxf(pb[e], x[i + 2 + e]);
      pb[2 + e] = fmaxf(pb[2 + e], x[i + 6 + e]);
    }
  }
  a = fmaxf(fmaxf(pa[0], pa[1]), fmaxf(pa[2], pa[3]));
  b = fmaxf(fmaxf(pb[0], pb[1]), fmaxf(pb[2], pb[3]));
}
template <int N> __device__ __forceinline__ void row_sum(const float (&x)[N], float& a, float& b) {
  float pa[4] = {x[0], x[1], x[4], x[5]}, pb[4] = {x[2], x[3], x[6], x[7]};
#pragma unroll
  for (int i = 8; i < N; i += 8) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pa[e] += x[i + e];
      pa[2 + e] += x[i + 4 + e];
      pb[e] += x[i + 2 + e];
      pb[2 + e] += x[i + 6 + e];
    }
  }
  a = (pa[0] + pa[1]) + (pa[2] + pa[3]);
  b = (pb[0] + pb[1]) + (pb[2] + pb[3]);
}

// Packs a (64, N) f32 tile into N / 16 A-operand fragments of type T.
template <typename T, int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[j][r] = hopper::pack2<T>(x[8 * j + 2 * r], x[8 * j + 2 * r + 1]);
  }
}

// Loads rows [q0, q0 + 64 * n) of a (planes, S, D) tensor into `dst` as n
// (64, D) tiles of 64-column halves, one per live consumer (no box lies
// wholly past S).  Lane 0 only.
template <typename L>
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int q0, int plane, int n) {
  for (int c = 0; c < n; ++c) {
#pragma unroll
    for (int h = 0; h < L::HALVES; ++h) {
      hopper::tma_load_3d(dst + c * L::WG_TILE + h * ROW_TILE_BYTES, map, bar, h * 64,
                          q0 + c * 64, plane);
    }
  }
}

// Per-thread view of a consumer's accumulator rows.
struct TcRows {
  int c;      // consumer warpgroup
  int lane;
  int a, b;   // global query rows of the thread: a and a + 8
  int col;    // first of the thread's two columns in every 8-column chunk
  __device__ __forceinline__ TcRows(int q0) {
    c = threadIdx.x / WG_THREADS;
    const int t = threadIdx.x % WG_THREADS;
    lane = t % 32;
    a = q0 + c * 64 + (t / 32) * 16 + lane / 4;
    b = a + 8;
    col = 2 * (lane % 4);
  }
};

// The visibility of the thread's score-tile entries as a bit mask: bit
// 4 i + e for entry 4 i + e of the accumulator (see hopper::Wgmma).
template <int BN>
__device__ __forceinline__ uint64_t tile_visibility(const TcRows& rows, const Band& band,
                                                    const int* kpos, int k0, int Sk, int qp_a,
                                                    int qp_b) {
  uint64_t bits = 0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * i + rows.col + e;
      if (key < Sk) {
        const int kp = position(kpos, key);
        if (visible(band, qp_a, kp)) bits |= 1ull << (4 * i + e);
        if (visible(band, qp_b, kp)) bits |= 1ull << (4 * i + 2 + e);
      }
    }
  }
  return bits;
}

// Stores the thread's two rows of a (64, D) f32 accumulator, times `mul_a`
// and `mul_b`, to rows `rows.a`, `rows.b` of `dst` (row-major, D columns) in
// T, skipping rows at or past S.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const TcRows& rows, int S,
                                           const float (&acc)[D / 2], float mul_a, float mul_b) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + rows.col;
    if (rows.a < S) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)rows.a * D + col) =
          hopper::pack2<T>(acc[4 * i] * mul_a, acc[4 * i + 1] * mul_a);
    }
    if (rows.b < S) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)rows.b * D + col) =
          hopper::pack2<T>(acc[4 * i + 2] * mul_b, acc[4 * i + 3] * mul_b);
    }
  }
}

// Sets the dynamic shared-memory ceiling and launches one block of
// L::THREADS per BM query rows, head and batch.
template <typename L, typename Kernel, typename... Args>
inline cudaError_t launch_tc(Kernel kernel, int BH, int Sq, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + L::BM - 1) / L::BM);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(args...);
  return cudaGetLastError();
}

// Instantiates `fn<T, D>(args...)` for the types and head dims of the
// tensor-core route (route() == kTensorCore).
#define FLASH_TC_DISPATCH(dtype, head_dim, fn, ...)                                   \
  [&]() -> cudaError_t {                                                              \
    const bool bf16 = (dtype) == flash::kBF16;                                        \
    switch (head_dim) {                                                               \
      case 64:                                                                        \
        return bf16 ? fn<__nv_bfloat16, 64>(__VA_ARGS__) : fn<__half, 64>(__VA_ARGS__); \
      case 128:                                                                       \
        return bf16 ? fn<__nv_bfloat16, 128>(__VA_ARGS__) : fn<__half, 128>(__VA_ARGS__); \
      default: return cudaErrorInvalidValue;                                          \
    }                                                                                 \
  }()

}  // namespace flash
