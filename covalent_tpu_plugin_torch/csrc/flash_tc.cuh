// What the tensor-core flash kernels (the 16-bit, head dim 64 and 128 route
// of flash_fwd.cu, flash_bwd_dq.cu and flash_bwd_dkdv.cu) share: the block
// shape, the shared-memory layout, the producer warp that streams tiles of
// the swept operand, and the row helpers of the wgmma accumulator layout.
//
// Block shape.  CONSUMERS warpgroups of 128 threads each own 64 rows of the
// block's fixed operand (BM = 64 * CONSUMERS rows per block): query rows for
// the forward and dQ, key rows for dK/dV.  One more warp (alone, or in a
// warpgroup of its own for dK/dV) is the producer.  It loads the block's
// fixed operands (Q; Q and dO; K and V) once, then
// walks the tiles of the swept rows (keys; keys; queries) in order, each
// through one or more planes (the kv head's; the G query heads of the GQA
// group), and, for every tile that some consumer needs, waits for a free
// slot of the STAGES-deep ring, writes the tile's description (its first
// row and, per consumer, whether it sees none of the tile, some of it or
// all of it), stages whatever else the slot carries, and has TMA load the
// tile's two operands (K and V, or Q and dO) into the slot.  A slot whose
// first row is negative ends the sweep.  Consumers wait on the
// slot's "full" barrier, run their products, and release it on its "empty"
// barrier (one arrival per consumer warp).  A tile no consumer needs is
// never loaded; a tile only one consumer needs goes through both, and the
// other takes it as kNone (P = 0, no softmax): the loop that issues the
// products stays free of branches, which ptxas would answer by serialising
// every wgmma.
//
// Tile kinds come from the positions' min and max over the tile, as
// _band_tile_needed decides in the reference: a tile outside the band is
// kNone; a whole tile every pair of which is visible is an interior tile
// and takes no mask (the reference's interior path); every other tile is
// masked pair by pair, including swept rows past their length, which TMA
// fills with zeros but the reference masks.
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
  int t0;  // first swept row of the tile; < 0 ends the sweep
  int kind[MAX_CONSUMERS];
};

// Block shape and shared memory of one block: CONSUMERS warpgroups of 64
// fixed rows each (BM rows) plus the producer, a warp or a warpgroup (of
// which one warp produces and the others lend their registers to the
// consumers through setmaxnreg); from a 1024-byte
// aligned base, FIXED operand tiles of (BM, D) (Q; Q and dO; K and V), then
// STAGES slots of two (BN, D) tiles (K and V; Q and dO), then the barriers,
// the slots' descriptions and SLOT_EXTRA more bytes per slot that the
// producer's lanes write (dK/dV: the tile's lse and delta).  An operand of
// head dim 128 is stored as two 64-column halves.
template <int D, int BN, int STAGES, int FIXED, int NCONSUMERS, int SLOT_EXTRA = 0,
          int PRODUCER_THREADS = 32>
struct TcLayout {
  static_assert(NCONSUMERS <= MAX_CONSUMERS, "too many consumer warpgroups");
  static_assert(PRODUCER_THREADS == 32 || PRODUCER_THREADS == WG_THREADS,
                "a producer warp or warpgroup");
  static constexpr int CONSUMERS = NCONSUMERS;
  static constexpr int BM = 64 * CONSUMERS;
  static constexpr int THREADS = WG_THREADS * CONSUMERS + PRODUCER_THREADS;
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
  static constexpr int EXTRA_AT = (META_AT + (int)sizeof(TileMeta) * STAGES + 15) & ~15;
  static constexpr int EXTRA = SLOT_EXTRA;
  static constexpr int BYTES = EXTRA_AT + STAGES * SLOT_EXTRA + 1024;  // + alignment
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
  __device__ __forceinline__ float* extra(int s) const {
    return reinterpret_cast<float*>(base + L::EXTRA_AT + s * L::EXTRA);
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

// What the producer warp walks.  The block's fixed rows are [f0, f0 + BM)
// of `S_fixed`, at positions `fixed_pos`; the swept rows, `S_swept` of them
// at positions `swept_pos`, go in tiles of BN, and each tile through
// `n_planes` planes of the swept operands' maps from `plane0`.  The fixed
// rows are the queries of the band test (forward, dQ) or its keys (dK/dV).
// A null position vector means 0..S-1.
struct Sweep {
  const int* fixed_pos;
  int f0, S_fixed;
  const int* swept_pos;
  int S_swept;
  int plane0, n_planes;
  bool fixed_are_queries;
};

// Min and max of positions [r0, r0 + n) over the warp (r0 + n <= S).
__device__ __forceinline__ void warp_range(const int* pos, int r0, int n, int lane, int& lo,
                                           int& hi) {
  if (!pos) {
    lo = r0;
    hi = r0 + n - 1;
    return;
  }
  int a = INT_MAX, b = INT_MIN;
  for (int j = lane; j < n; j += 32) {
    a = min(a, pos[r0 + j]);
    b = max(b, pos[r0 + j]);
  }
  lo = warp_min(a);
  hi = warp_max(b);
}

// The producer warp.  `load_fixed(bar)` issues, from lane 0, the TMA loads
// of the block's fixed operands on `bar` (and its expect_tx).  Every lane
// calls `extra.fetch(t0, plane)` before it waits for a free slot, so the
// reads overlap the wait, and `extra.store(s)` once slot s is free and
// before it is marked full: together they write the slot's SLOT_EXTRA
// bytes.
template <typename L, int BN, typename LoadFixed, typename SlotExtra>
__device__ __forceinline__ void tc_produce(const TcBlock<L>& blk, const CUtensorMap* a_map,
                                           const CUtensorMap* b_map, const Sweep& sw,
                                           const Band& band, LoadFixed load_fixed,
                                           SlotExtra& extra) {
  constexpr int STAGES = L::NSTAGES;
  const int lane = threadIdx.x % 32;
  int flo[L::CONSUMERS], fhi[L::CONSUMERS];
#pragma unroll
  for (int c = 0; c < L::CONSUMERS; ++c) {
    const int r0 = sw.f0 + c * 64;
    flo[c] = fhi[c] = 0;
    if (r0 < sw.S_fixed) {
      warp_range(sw.fixed_pos, r0, min(64, sw.S_fixed - r0), lane, flo[c], fhi[c]);
    }
  }
  if (lane == 0) load_fixed(blk.fixed_bar());

  int it = 0;
  for (int t0 = 0; t0 < sw.S_swept; t0 += BN) {
    const int n = min(BN, sw.S_swept - t0);
    int tlo, thi;
    warp_range(sw.swept_pos, t0, n, lane, tlo, thi);
    TileMeta meta;
    meta.t0 = t0;
    bool any = false;
#pragma unroll
    for (int c = 0; c < L::CONSUMERS; ++c) {
      int kind = kNone;
      const bool fq = sw.fixed_are_queries;
      const int qlo = fq ? flo[c] : tlo, qhi = fq ? fhi[c] : thi;
      const int klo = fq ? tlo : flo[c], khi = fq ? thi : fhi[c];
      if (sw.f0 + c * 64 < sw.S_fixed && tile_needed(band, qlo, qhi, klo, khi)) {
        kind = n == BN && all_visible(band, qlo, qhi, klo, khi) ? kInterior : kMasked;
      }
      meta.kind[c] = kind;
      any = any || kind != kNone;
    }
    if (!any) continue;
    for (int p = 0; p < sw.n_planes; ++p) {
      const int plane = sw.plane0 + p;
      const int s = it % STAGES;
      extra.fetch(t0, plane);
      hopper::mbar_wait(blk.empty(s), ((it / STAGES) & 1) ^ 1);
      extra.store(s);
      __syncwarp();
      if (lane == 0) {
        blk.meta()[s] = meta;
        hopper::mbar_arrive_expect_tx(blk.full(s), L::STAGE);
        const uint32_t a_dst = blk.stage(s), b_dst = a_dst + L::KV_TILE;
#pragma unroll
        for (int h = 0; h < L::HALVES; ++h) {
          hopper::tma_load_3d(a_dst + h * L::KV_HALF, a_map, blk.full(s), h * 64, t0, plane);
          hopper::tma_load_3d(b_dst + h * L::KV_HALF, b_map, blk.full(s), h * 64, t0, plane);
        }
      }
      __syncwarp();
      ++it;
    }
  }
  const int s = it % STAGES;
  hopper::mbar_wait(blk.empty(s), ((it / STAGES) & 1) ^ 1);
  if (lane == 0) {
    blk.meta()[s].t0 = -1;
    hopper::mbar_arrive(blk.full(s));
  }
}

// A slot that carries nothing besides its two tiles.
struct NoSlotExtra {
  __device__ __forceinline__ void fetch(int, int) {}
  __device__ __forceinline__ void store(int) {}
};

// Consumers of the block that own at least one row below S.
template <typename L> __device__ __forceinline__ int live_consumers(int f0, int S) {
  return min(L::CONSUMERS, (S - f0 + 63) / 64);
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
  __device__ __forceinline__ bool next(int& s, int& t0, int& kind) {
    s = it % L::NSTAGES;
    hopper::mbar_wait(blk.full(s), (it / L::NSTAGES) & 1);
    ++it;
    t0 = blk.meta()[s].t0;
    kind = blk.meta()[s].kind[c];
    return t0 >= 0;
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

// Loads rows [r0, r0 + 64 * n) of a (planes, S, D) tensor into `dst` as n
// (64, D) tiles of 64-column halves, one per live consumer (no box lies
// wholly past S).  Lane 0 only.
template <typename L>
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int r0, int plane, int n) {
  for (int c = 0; c < n; ++c) {
#pragma unroll
    for (int h = 0; h < L::HALVES; ++h) {
      hopper::tma_load_3d(dst + c * L::WG_TILE + h * ROW_TILE_BYTES, map, bar, h * 64,
                          r0 + c * 64, plane);
    }
  }
}

// Per-thread view of a consumer's accumulator rows.
struct TcRows {
  int c;      // consumer warpgroup
  int lane;
  int a, b;   // global fixed rows of the thread: a and a + 8
  int col;    // first of the thread's two columns in every 8-column chunk
  __device__ __forceinline__ TcRows(int f0) {
    c = threadIdx.x / WG_THREADS;
    const int t = threadIdx.x % WG_THREADS;
    lane = t % 32;
    a = f0 + c * 64 + (t / 32) * 16 + lane / 4;
    b = a + 8;
    col = 2 * (lane % 4);
  }
};

// The visibility of the thread's score-tile entries as a bit mask: bit
// 4 i + e for entry 4 i + e of the accumulator (see hopper::Wgmma).  The
// tile's columns are swept rows t0.. of S at positions `pos`; the thread's
// rows are at positions p_a and p_b.  Rows are queries (S = Q K^T), or keys
// when ROWS_ARE_KEYS (S^T = K Q^T).  Columns at or past S are not visible.
template <int BN, bool ROWS_ARE_KEYS = false>
__device__ __forceinline__ uint64_t tile_visibility(const TcRows& rows, const Band& band,
                                                    const int* pos, int t0, int S, int p_a,
                                                    int p_b) {
  uint64_t bits = 0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + 8 * i + rows.col + e;
      if (t < S) {
        const int p = position(pos, t);
        const bool va = ROWS_ARE_KEYS ? visible(band, p, p_a) : visible(band, p_a, p);
        const bool vb = ROWS_ARE_KEYS ? visible(band, p, p_b) : visible(band, p_b, p);
        if (va) bits |= 1ull << (4 * i + e);
        if (vb) bits |= 1ull << (4 * i + 2 + e);
      }
    }
  }
  return bits;
}

// Two neighbouring values of a row in the output type O: a packed pair of
// 16-bit values, or an f32 pair (the f32 outputs, out_dtype).
template <typename O>
__device__ __forceinline__ void store_pair(O* dst, float lo, float hi) {
  if constexpr (std::is_same<O, float>::value) {
    *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = hopper::pack2<O>(lo, hi);
  }
}

// Stores the thread's two rows of a (64, D) f32 accumulator, times `mul_a`
// and `mul_b`, to rows `rows.a`, `rows.b` of `dst` (row-major, D columns) in
// O, skipping rows at or past S.
template <typename O, int D>
__device__ __forceinline__ void store_rows(O* dst, const TcRows& rows, int S,
                                           const float (&acc)[D / 2], float mul_a, float mul_b) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + rows.col;
    if (rows.a < S) {
      store_pair<O>(dst + (size_t)rows.a * D + col, acc[4 * i] * mul_a, acc[4 * i + 1] * mul_a);
    }
    if (rows.b < S) {
      store_pair<O>(dst + (size_t)rows.b * D + col, acc[4 * i + 2] * mul_b,
                    acc[4 * i + 3] * mul_b);
    }
  }
}

// Sets the dynamic shared-memory ceiling and launches one block of
// L::THREADS per BM fixed rows (of S) and plane (BH of them).
template <typename L, typename Kernel, typename... Args>
inline cudaError_t launch_tc(Kernel kernel, int BH, int Sq, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + L::BM - 1) / L::BM);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(args...);
  return cudaGetLastError();
}

// Instantiates `fn<T, D, O>(args...)` for the types and head dims of the
// tensor-core route (route() == kTensorCore), O the input type or f32.
#define FLASH_TC_DISPATCH(dtype, out_dtype, head_dim, fn, ...)                       \
  [&]() -> cudaError_t {                                                             \
    if ((dtype) == flash::kBF16)                                                     \
      return FLASH_TC_DISPATCH_O(__nv_bfloat16, out_dtype, head_dim, fn, __VA_ARGS__); \
    return FLASH_TC_DISPATCH_O(__half, out_dtype, head_dim, fn, __VA_ARGS__);        \
  }()

#define FLASH_TC_DISPATCH_O(T, out_dtype, head_dim, fn, ...)                   \
  [&]() -> cudaError_t {                                                      \
    if ((out_dtype) == flash::dtype_code<T>())                                \
      return FLASH_TC_DISPATCH_D(T, T, head_dim, fn, __VA_ARGS__);            \
    if ((out_dtype) == flash::kF32)                                           \
      return FLASH_TC_DISPATCH_D(T, float, head_dim, fn, __VA_ARGS__);        \
    return cudaErrorInvalidValue;                                             \
  }()

#define FLASH_TC_DISPATCH_D(T, O, head_dim, fn, ...)      \
  [&]() -> cudaError_t {                                  \
    switch (head_dim) {                                   \
      case 64: return fn<T, 64, O>(__VA_ARGS__);          \
      case 128: return fn<T, 128, O>(__VA_ARGS__);        \
      default: return cudaErrorInvalidValue;              \
    }                                                     \
  }()

}  // namespace flash
