// Batch-invariant product with an int8 weight on the tensor cores: the
// quantized denses of the serving paths.
//
//   C[z, m, n] = epilogue(sum_k A[z, m, k] * W[z, n, k], scale[n])
//
// A bf16, W int8 (|W| <= 127), scale f32, C bf16 or f32.  The reference
// leaves this product to XLA (covalent_tpu_plugin/models/quant.py:84-89:
// `dot(x.astype(dtype), kernel.astype(dtype)) * scale.astype(dtype)`); no
// Pallas kernel computes it.  What the kernel is for is the bytes: the int8
// weight is what crosses HBM, half of a bf16 copy's, widened to bf16 in
// registers on its way to mma.sync.  The widening is exact (every integer
// of at most 8 bits is a bf16), so the sums are bi_gemm_tc.cu's on the
// widened weight, in bi_mma.cuh's order, bit for bit, whatever the batch.
//
// The epilogue is the reference's scale step on the rounded sum:
//   C bf16: bf16(float(bf16(total)) * scale[n])   (the wrapper passes scale
//           already rounded to bf16, as `scale.astype(bf16)`)
//   C f32:  total * scale[n]                       (the lm_head's f32 logits)
//
// Two tile configurations, picked by the wrapper from M, N, K and the batch
// (ops/_kernels.py: plan_bi_gemm), one order:
//
// - skinny (the decode steps, and M 128 where the wide tiles are too few):
//   bound by streaming the int8 weight, so the design is about bytes in
//   flight.  Blocks are persistent (at most two an SM, as many as the card
//   holds) and walk column groups across N; each warp streams its own
//   8-column, 256-deep pieces of W through a four-stage cp.async ring,
//   three pieces ahead of its mma chain (6 KB of W in flight a warp).
//   Where N is narrow, a warp splits K with its neighbours by segment, as
//   bi_gemm_tc.cu's skinny tiles do, and the partials meet in shared
//   memory in segment order, each warp's A fragments loaded into its
//   registers; where N alone fills the card (the lm_head), a warp walks
//   whole columns against A's rows staged once a block.
// - wide (the admission waves): bi_gemm_tc.cu's wide tile with an int8
//   stage (a three-stage cp.async ring; W's stage holds the int8 bytes,
//   widened when a warp reads its fragment).
//
// The widening is a byte permute into the mantissa of 2^23 and one f32
// subtraction a value (exact), then a bf16 pair pack.

#include "bi_mma.cuh"

#include <algorithm>

namespace biw8 {

using bimma::Geometry;
using bimma::K_GROUP;
using bimma::PITCH;
using bimma::SEG_GROUPS;
using bimma::SEG_K;
using bf16 = __nv_bfloat16;

// How many of `most` elements from here lie before the end, `left` away.
__device__ __forceinline__ int elems_left(int64_t left, int most) {
  return left <= 0 ? 0 : left < most ? (int)left : most;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 4 int8 of a word (k ascending) -> 4 f32, exactly: each byte, offset to
// unsigned, becomes the low mantissa byte of 2^23 (one byte permute), and
// 2^23 + 128 is subtracted.
__device__ __forceinline__ void int8x4_to_f32(uint32_t word, float (&f)[4]) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440u | (uint32_t)i)) - 8388736.0f;
}

// 8 int8 (k ascending) -> 8 bf16 in the layout of a 16-byte bf16 run.
__device__ __forceinline__ uint4 widen8(const uint2& v) {
  float lo[4], hi[4];
  int8x4_to_f32(v.x, lo);
  int8x4_to_f32(v.y, hi);
  return make_uint4(pack2(lo[0], lo[1]), pack2(lo[2], lo[3]), pack2(hi[0], hi[1]),
                    pack2(hi[2], hi[3]));
}

// The scale step on the f32 totals of C[m, n] and C[m, n + 1].
template <typename TC> __device__ __forceinline__ float scaled(float total, float s);
template <> __device__ __forceinline__ float scaled<float>(float total, float s) {
  return total * s;
}
template <> __device__ __forceinline__ float scaled<bf16>(float total, float s) {
  return __bfloat162float(__float2bfloat16_rn(total)) * s;  // rounded once more by store2
}

template <typename TC>
__device__ __forceinline__ void store2_scaled(TC* c, const float* __restrict__ scale,
                                              const Geometry& g, int64_t m, int64_t n, float v0,
                                              float v1) {
  if (m >= g.m || n >= g.n) return;
  const float s0 = __ldg(scale + n), s1 = n + 1 < g.n ? __ldg(scale + n + 1) : 0.0f;
  bimma::store2(c, g, m, n, scaled<TC>(v0, s0), scaled<TC>(v1, s1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The skinny tiles.  A block of nt x rs warps (at most SKINNY_MAX_WARPS)
// owns one 16-row tile of A and walks the column groups blockIdx.y,
// blockIdx.y + gridDim.y, ... (8 nt columns each): warp w takes column
// tile w % nt of a group and, in each round of rs segments, segment round
// + w / nt.  Each warp streams its own tasks' W (8 rows x one 256-byte
// segment of int8) through a private ring of SKINNY_STAGES stages by
// cp.async, SKINNY_STAGES - 1 tasks ahead, so the warp's next segments are
// in flight while it runs this one's mma chain; the partials of a round
// meet in shared memory and warp `tile` adds them in segment order,
// bi_gemm_tc.cu's skinny tiles' order exactly.  Where N alone gives every
// warp of the card column tiles (the lm_head), rs is 1: a warp walks a
// tile's segments itself and the block never meets, and A's rows are
// staged once a block for every column group it walks.  Where K is split
// (SPLIT: a warp takes a task or two), a warp loads its segment's A
// fragments from global memory into registers, in flight with its stage's
// wait, and never waits for the block before its chain: staging A there
// cost up to 0.67 us a launch, and the block-wide prologue 0.45 us more
// (H100, q/k/v/o at M 8, timed by tools/bi_gemm_ab.py --quick).
constexpr int SKINNY_MAX_WARPS = 12;
constexpr int SKINNY_STAGES = 4;
// A stage: 8 W rows of SEG_K bytes; an odd row's 16-byte chunks are stored
// with bit 2 of their index flipped, so a fragment read (rows gi, gi + 1,
// chunks t = 0..3 in one phase) hits 32 distinct banks.
constexpr int W_STAGE = 8 * SEG_K;
__device__ __forceinline__ int w_chunk(int row, int chunk) { return chunk ^ ((row & 1) << 2); }
constexpr int A_PAD = 8;  // bf16 past a staged A row (with K rounded to 64: 4 banks a row)
constexpr size_t SMEM_MAX = 232448;  // the most dynamic shared memory a block may have

__host__ __device__ inline int64_t a_pitch(int64_t k) { return bimma::groups(k) * K_GROUP + A_PAD; }
// A's rows a block stages: 8 where M <= 8 (rows 8..15 of a fragment are
// then zeros, never read), else 16.
__host__ __device__ inline int a_rows(int64_t m) { return m <= 8 ? 8 : 16; }
inline size_t skinny_smem(int64_t m, int64_t k, int warps, bool split) {
  return (split ? 0 : (size_t)a_rows(m) * a_pitch(k) * 2) +
         (size_t)warps * (32 * 16 + SKINNY_STAGES * W_STAGE);
}

// grid (ceil(M / 16), column groups walked in parallel, Z), 32 nt rs
// threads.  SPLIT: rs > 1, A's fragments from global memory (see above).
template <typename TC, bool SPLIT>
__global__ void __launch_bounds__(32 * SKINNY_MAX_WARPS)
    w8_skinny(const bf16* __restrict__ A, const int8_t* __restrict__ W,
              const float* __restrict__ scale, TC* __restrict__ C, Geometry g, int nt, int rs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = nt * rs;
  const int64_t pitch = a_pitch(g.k);
  const int64_t a_bytes = SPLIT ? 0 : a_rows(g.m) * pitch * 2;
  bf16* As = reinterpret_cast<bf16*>(smem);                          // [a_rows][pitch]
  float4* part = reinterpret_cast<float4*>(smem + a_bytes);          // [warps][32]
  unsigned char* ring = smem + a_bytes + warps * 32 * 16;            // [warps][STAGES][8][SEG_K]
  const bf16* a = bimma::at_batch(A, g.sa, g);
  const int8_t* w = bimma::at_batch(W, g.sw, g);
  TC* c = bimma::at_batch(C, g.sc, g);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / 4, t = lane % 4;
  const int tile = warp % nt, sub = warp / nt;
  const int64_t m0 = (int64_t)blockIdx.x * 16;
  const int rows = elems_left(g.m - m0, 16);
  const bool ok0 = gi < rows, ok1 = gi + 8 < rows, two_halves = rows > 8;

  // A's rows of this tile, k-padded with zeros to whole groups, row by row
  // (rows past M are never read: their fragments are zeros).
  const int runs = SPLIT ? 0 : (int)(pitch - A_PAD) / 8;
  for (int r = 0; r < rows; ++r) {
    const bf16* src = a + (m0 + r) * g.sa[3];
    for (int run = threadIdx.x; run < runs; run += blockDim.x) {
      const int64_t k = 8 * (int64_t)run;
      const bool ok = k < g.k;  // K % 8 == 0: a run is wholly in or out
      cp_async16(As + r * pitch + k, ok ? src + k : a, ok ? 16 : 0);
    }
  }
  cp_async_commit();

  // A step is a column group (from blockIdx.y, gridDim.y apart) and a
  // round of rs segments, this warp's segment round rs + sub.  Every warp
  // takes the same steps (the block meets at each), some without a
  // segment.  Two cursors walk them: the step being loaded, SKINNY_STAGES
  // - 1 ahead, and the step being computed.
  const int nseg = (int)bimma::segments(g.k), rounds = (nseg + rs - 1) / rs;
  const int64_t ngroups = (g.n + 8 * nt - 1) / (8 * nt);
  unsigned char* my_ring = ring + warp * SKINNY_STAGES * W_STAGE;
  struct Step {
    int64_t group;
    int round, stage;
  };
  auto advance = [&](Step& st) {
    if (++st.round == rounds) {
      st.round = 0;
      st.group += gridDim.y;
    }
    st.stage = st.stage + 1 == SKINNY_STAGES ? 0 : st.stage + 1;
  };
  // The W rows of a step's 8 columns, k of its segment: 8 x 16 runs of 16
  // bytes, four a lane, zeros past N and K.
  Step ahead{blockIdx.y, 0, 0};
  auto load = [&]() {
    const int seg = ahead.round * rs + sub;
    if (ahead.group < ngroups && seg < nseg) {
      unsigned char* st = my_ring + ahead.stage * W_STAGE;
      const int64_t col0 = ahead.group * 8 * nt + tile * 8, k0 = (int64_t)seg * SEG_K;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lane / 16 + 2 * i, run = lane % 16;
        const int64_t n = col0 + r, k = k0 + 16 * run;
        const int bytes = n < g.n ? elems_left(g.k - k, 16) : 0;
        cp_async16(st + r * SEG_K + 16 * w_chunk(r, run), bytes ? w + n * g.sw[3] + k : w,
                   bytes);
      }
    }
    advance(ahead);
  };
#pragma unroll
  for (int s = 0; s < SKINNY_STAGES - 1; ++s) {
    load();
    cp_async_commit();
  }
  float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  bool first = true;
  for (Step cur{blockIdx.y, 0, 0}; cur.group < ngroups; advance(cur)) {
    const int64_t col0 = cur.group * 8 * nt + tile * 8;
    const int seg = cur.round * rs + sub;
    const int64_t kseg = (int64_t)seg * SEG_K;
    uint4 lo[SEG_GROUPS][2], hi[SEG_GROUPS][2];
    if (SPLIT && seg < nseg) {  // A's fragments, in flight with the stage's wait
      const bf16* a0 = a + (m0 + gi) * g.sa[3] + kseg + 16 * t;
      const bf16* a1 = a0 + 8 * g.sa[3];
#pragma unroll
      for (int gr = 0; gr < SEG_GROUPS; ++gr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = gr * K_GROUP + 8 * h;
          const bool ok_k = kseg + 16 * t + off < g.k;  // K % 8 == 0: a run is in or out
          lo[gr][h] = bimma::ldg16(a0 + off, ok0 && ok_k);
          hi[gr][h] = two_halves ? bimma::ldg16(a1 + off, ok1 && ok_k) : zero;
        }
    }
    cp_async_wait<SKINNY_STAGES - 2>();  // this warp's stage (and, first, A)
    if (!SPLIT && first)
      __syncthreads();
    else
      __syncwarp();
    first = false;
    // the stage read in the step before is free: the warp (or the block)
    // met after it
    load();
    cp_async_commit();

    if (seg < nseg) {
      const unsigned char* ws = my_ring + cur.stage * W_STAGE + gi * SEG_K;
      const bf16* s0 = As + gi * pitch + kseg + 16 * t;
      // the groups of the segment inside K, and their W fragments, read
      // before the chain starts
      const int ngr = elems_left((g.k - kseg + K_GROUP - 1) / K_GROUP, SEG_GROUPS);
      uint4 wf[SEG_GROUPS];
#pragma unroll
      for (int gr = 0; gr < SEG_GROUPS; ++gr)
        wf[gr] = gr < ngr ? *reinterpret_cast<const uint4*>(ws + 16 * w_chunk(gi, gr * 4 + t))
                          : zero;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int gr = 0; gr < SEG_GROUPS; ++gr) {
        if (gr >= ngr) break;  // the wide tiles' loop ends at K too
        const uint4 wv = wf[gr];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!SPLIT) {
            const int off = gr * K_GROUP + 8 * h;
            lo[gr][h] = ok0 ? bimma::lds16(s0 + off) : zero;
            hi[gr][h] = two_halves && ok1 ? bimma::lds16(s0 + 8 * pitch + off) : zero;
          }
          bimma::mma_pair(acc, lo[gr][h], hi[gr][h],
                          widen8(h ? make_uint2(wv.z, wv.w) : make_uint2(wv.x, wv.y)));
        }
      }
      if (rs == 1) {  // block-uniform: this warp walks its column tile's segments in order
        total[0] += acc[0];
        total[1] += acc[1];
        total[2] += acc[2];
        total[3] += acc[3];
        if (seg == nseg - 1) {
          store2_scaled(c, scale, g, m0 + gi, col0 + 2 * t, total[0], total[1]);
          store2_scaled(c, scale, g, m0 + gi + 8, col0 + 2 * t, total[2], total[3]);
          total[0] = total[1] = total[2] = total[3] = 0.0f;
        }
      } else {
        part[warp * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    if (rs == 1) {  // no partials to meet: the warp's own lanes free the stage
      __syncwarp();
      continue;
    }
    __syncthreads();
    if (warp < nt) {  // sub == 0: this warp folds its tile's partials in segment order
      for (int j = 0; j < rs && cur.round * rs + j < nseg; ++j) {
        const float4 p = part[(j * nt + warp) * 32 + lane];
        total[0] += p.x;
        total[1] += p.y;
        total[2] += p.z;
        total[3] += p.w;
      }
      if (cur.round == rounds - 1) {
        store2_scaled(c, scale, g, m0 + gi, col0 + 2 * t, total[0], total[1]);
        store2_scaled(c, scale, g, m0 + gi + 8, col0 + 2 * t, total[2], total[3]);
        total[0] = total[1] = total[2] = total[3] = 0.0f;
      }
    }
    __syncthreads();
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? BYTES : 0;  // 0: the bytes are filled with zeros
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  }
}

// bi_gemm_tc.cu's wide tile: 64 x 128, four warps of 64 x 32, three stages.
constexpr int TM = 4, TN = 4, WARPS_N = 4, STAGES = 3;
constexpr int BM = TM * 16, BN = WARPS_N * TN * 8, WIDE_THREADS = 32 * WARPS_N;
constexpr int PITCH8 = K_GROUP + 16;  // bytes of one int8 W row of a stage
constexpr int WIDE_SMEM = STAGES * (BM * PITCH * 2 + BN * PITCH8);  // 58368 bytes

template <typename TC>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
    w8_wide(const bf16* __restrict__ A, const int8_t* __restrict__ W,
            const float* __restrict__ scale, TC* __restrict__ C, Geometry g) {
  constexpr int THREADS = WIDE_THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                                  // [stage][BM][PITCH]
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + STAGES * BM * PITCH * 2);  // [stage][BN][PITCH8]
  const bf16* a = bimma::at_batch(A, g.sa, g);
  const int8_t* w = bimma::at_batch(W, g.sw, g);
  TC* c = bimma::at_batch(C, g.sc, g);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / 4, t = lane % 4;
  const int64_t m0 = (int64_t)blockIdx.x * BM, n0 = (int64_t)blockIdx.y * BN;
  const int64_t ngroups = bimma::groups(g.k);

  auto load_group = [&](int stage, int64_t grp) {
    const int64_t k0 = grp * K_GROUP;
    bf16* as = As + stage * BM * PITCH;
    int8_t* ws = Ws + stage * BN * PITCH8;
#pragma unroll
    for (int it = 0; it < BM * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i / 8, run = i % 8;
      const int64_t row = m0 + r, k = k0 + 8 * run;
      const bool ok = row < g.m && k < g.k;
      cp_async<16>(as + r * PITCH + 8 * run, ok ? a + row * g.sa[3] + k : a, ok);
    }
#pragma unroll
    for (int it = 0; it < BN * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i / 8, run = i % 8;
      const int64_t row = n0 + r, k = k0 + 8 * run;
      const bool ok = row < g.n && k < g.k;
      cp_async<8>(ws + r * PITCH8 + 8 * run, ok ? w + row * g.sw[3] + k : w, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ngroups) load_group(s, s);
    cp_async_commit();
  }

  float acc[TM][TN][4], total[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = total[i][j][e] = 0.0f;

  for (int64_t grp = 0; grp < ngroups; ++grp) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int64_t next = grp + STAGES - 1;
    if (next < ngroups) load_group((int)(next % STAGES), next);
    cp_async_commit();

    const int stage = (int)(grp % STAGES);
    const bf16* as = As + stage * BM * PITCH + gi * PITCH + 16 * t;
    const int8_t* ws = Ws + stage * BN * PITCH8 + (warp * TN * 8 + gi) * PITCH8 + 16 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 wv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        wv[j] = widen8(*reinterpret_cast<const uint2*>(ws + j * 8 * PITCH8 + 8 * h));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const uint4 lo = bimma::lds16(as + i * 16 * PITCH + 8 * h);
        const uint4 hi = bimma::lds16(as + (i * 16 + 8) * PITCH + 8 * h);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bimma::mma(acc[i][j], lo.x, hi.x, lo.y, hi.y, wv[j].x, wv[j].y);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bimma::mma(acc[i][j], lo.z, hi.z, lo.w, hi.w, wv[j].z, wv[j].w);
      }
    }
    if ((grp + 1) % SEG_GROUPS == 0 || grp + 1 == ngroups) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[i][j][e] += acc[i][j][e];
            acc[i][j][e] = 0.0f;
          }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + i * 16 + gi;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t n = n0 + warp * TN * 8 + j * 8 + 2 * t;
      store2_scaled(c, scale, g, m, n, total[i][j][0], total[i][j][1]);
      store2_scaled(c, scale, g, m + 8, n, total[i][j][2], total[i][j][3]);
    }
  }
}

enum Config { kSkinny = 0, kWide = 1 };

template <typename TC>
cudaError_t run(int config, int nt, int rs, const void* Ap, const void* Wp, const float* scale,
                void* Cp, int64_t Z, const Geometry& g, cudaStream_t s) {
  const bf16* A = static_cast<const bf16*>(Ap);
  const int8_t* W = static_cast<const int8_t*>(Wp);
  TC* C = static_cast<TC*>(Cp);
  switch (config) {
    case kSkinny: {
      const int warps = nt * rs;
      const bool split = rs > 1;
      const size_t smem = skinny_smem(g.m, g.k, warps, split);
      if (nt < 1 || rs < 1 || warps > SKINNY_MAX_WARPS || smem > SMEM_MAX)
        return cudaErrorInvalidValue;
      static const cudaError_t opt_in[2] = {
          cudaFuncSetAttribute(w8_skinny<TC, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_MAX),
          cudaFuncSetAttribute(w8_skinny<TC, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_MAX)};
      if (opt_in[split] != cudaSuccess) return opt_in[split];
      // As many blocks as the card holds at once (at most two an SM), each
      // walking its share of the column groups.
      static int sms = 0, sm_smem = 0;
      if (!sms) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
      }
      const int64_t per_sm = std::max<int64_t>(1, std::min<int64_t>(2, sm_smem / (smem + 1024)));
      const int64_t mtiles = (g.m + 15) / 16, ngroups = (g.n + 8 * nt - 1) / (8 * nt);
      const int64_t ny = std::min(ngroups, std::max<int64_t>(1, sms * per_sm / (mtiles * Z)));
      if (ny > 65535 || mtiles > INT32_MAX) return cudaErrorInvalidValue;
      const dim3 grid((unsigned)mtiles, (unsigned)ny, (unsigned)Z);
      if (split)
        w8_skinny<TC, true><<<grid, 32 * warps, smem, s>>>(A, W, scale, C, g, nt, rs);
      else
        w8_skinny<TC, false><<<grid, 32 * warps, smem, s>>>(A, W, scale, C, g, nt, rs);
      return cudaGetLastError();
    }
    case kWide: {
      static const cudaError_t opt_in = cudaFuncSetAttribute(
          w8_wide<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
      if (opt_in != cudaSuccess) return opt_in;
      const dim3 grid((unsigned)((g.m + BM - 1) / BM), (unsigned)((g.n + BN - 1) / BN),
                      (unsigned)Z);
      w8_wide<TC><<<grid, WIDE_THREADS, WIDE_SMEM, s>>>(A, W, scale, C, g);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace biw8

// sizes: {z1, z2, z3, M, N, K}; strides: A (z1, z2, z3, m, k), W (z1, z2,
// z3, n, k), C (z1, z2, z3, m, n), 15 values in elements.  A bf16 and W
// int8, each with k stride 1 and 16-byte aligned rows; K % 8 == 0 (the
// wrapper copies operands off them onto them).
// scale: N f32 values, one a column, shared by every batch.  config: 0
// skinny (nt column tiles of 8, rs segments a round), 1 wide.  seg_k must
// equal the kernel's segment (256).  c_dtype: 0 f32, 2 bf16.  Returns the
// launch's CUDA error, 0 if none.
extern "C" int bi_gemm_w8(const void* A, const void* W, const float* scale, void* C, int c_dtype,
                          const int64_t* sizes, const int64_t* strides, int config, int nt,
                          int rs, int seg_k, void* stream) {
  const bimma::Geometry g = bimma::geometry(sizes, strides);
  const int64_t Z = sizes[0] * sizes[1] * sizes[2];
  if (seg_k != bimma::SEG_K || Z < 1 || Z > 65535 || g.m < 1 || g.n < 1 || g.k < 1 ||
      g.k % 8 != 0 || g.sa[4] != 1 || g.sw[4] != 1 ||
      reinterpret_cast<uintptr_t>(W) % 16 || reinterpret_cast<uintptr_t>(A) % 16)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (g.sw[i] % 16 || g.sa[i] % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (c_dtype) {
    case bimma::kF32: return (int)biw8::run<float>(config, nt, rs, A, W, scale, C, Z, g, s);
    case bimma::kBF16:
      return (int)biw8::run<__nv_bfloat16>(config, nt, rs, A, W, scale, C, Z, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
