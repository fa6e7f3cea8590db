// K1: the union group-min screen of the blocked serving scan, for Hopper.
//
// Replaces the TPU kernel lira_tpu/engine/block_scan.py::_union_groupmin_kernel
// (launched by _screen_rescore.screen_chunk).  For every (query block i,
// union slot u) it scores the 1024 corpus rows of supertile supers[i, u]
// (8 tiles of 128 rows) against the block's qb queries and keeps the min
// over each sel_rows-row group:
//
//   L2:  score = ||x||^2 - 2 x.q
//   IP:  score = -x.q
//   int8: the int32 dot d8 = x8.q8 is exact; score = -t * d8 (t already
//        doubled by the caller for L2), plus ||x||^2 = sum_d s2_d * x8_d^2.
//
// ||x||^2 comes in as a per-row vector `xsq` (built once with the index,
// from the rows as stored), so no mode spends CUDA-core time on norms.
// Slots with u >= ulen[i] are padding: they load nothing and write 3e38.
// Output layout is lira_tpu's: out[i][u*SG + g][q], SG = 1024 / sel_rows.
//
// What bounds it on an H100.  One live slot at the serving shape (qb =
// 1024, d = 128) does 2*1024*1024*128 = 268 M operations and moves
// 128-512 KB of corpus rows (int8..f32) plus 128 KB of group mins: ~500-2000
// operations per byte, so every mode is bound by operations.  On the
// trained 1M x 128 index a 65536-query batch has 46,914 live slots,
// 12.6 T operations: 12.7 ms at the 989 TFLOP/s of bf16 tensor cores,
// 6.4 ms at the 1,979 TOP/s of int8, 188 ms at the 67 TFLOP/s of f32
// FMAs (the f32 screen may not use TF32: the reference is "highest").
//
// The design.
// * bf16 and int8 run on the tensor cores (wgmma, sm_90a).  The queries
//   are wgmma's A (M) and the corpus rows its B (N), both K-major as they
//   lie in memory (d contiguous; the 8-bit wgmma requires it).  A CTA of
//   two warpgroups computes a 128-query x 256-row tile: each warpgroup one
//   m64n256 product (k16 bf16, k32 int8), accumulated over d in steps of
//   128 bytes a row, the width of the 128-byte swizzle.
// * A 4-stage ring in shared memory (49 KB a stage) runs two steps ahead
//   of the tensor cores, across tile and slot boundaries.  Thread 0 fills
//   a stage with two TMA boxes (cp.async.bulk.tensor, 2D byte maps over
//   the queries and the corpus, encoded on the host through the driver
//   entry point; zero past d and past the last query row) and one bulk
//   copy of the 256 rows' norms, all completing on the stage's mbarrier.
//   Rows that TMA cannot address (not a multiple of 16 bytes, or narrower
//   than 128) are copied byte by byte by every thread into the same layout.
// * CTAs are persistent (one per SM), walking the (block, slot, query
//   tile) items with the query tile fastest, so the CTAs in flight share a
//   few supertiles in L2.  Dead slots only write 3e38.
// * The epilogue stays in registers: a sel_rows group is a run of
//   accumulator columns, so its min is the thread's own columns plus a
//   quad shuffle (__shfl_xor 1, 2) for sel_rows >= 8, one shuffle for 4,
//   none for 1 and 2 (a lane holds two neighbouring columns); only (SG, qb)
//   f32 leaves the SM.  The 1024 x qb score block never exists.  sel_rows
//   is any divisor of 128 (the engine's block_sel_rows); at 1..16 the
//   output is 32..2x that of 32 (at 1, 4 bytes per 256 bf16/int8
//   operations: bound by the bytes it writes).
// * What it leaves on the table: the two warpgroups run in lock step, so
//   each tile's MMAs drain (wgmma.wait_group 0) before its epilogue and
//   the tensor cores idle through it; ptxas also waits out each d step's
//   MMAs before the next (C7517), which costs bf16's second step.
// * f32 stays on CUDA-core FMAs (no TF32), on the mainloop it shares with
//   K2 (fma_groupmin.cuh): persistent CTAs walk the live (block, slot,
//   128-query tile) items, query tile fastest, each item the supertile's 8
//   row tiles (or one, when there are few slots) through a 3-stage cp.async
//   ring (any d); a group's min is the thread's own rows plus a shuffle
//   reduce-scatter, 8 lanes storing 8 consecutive queries (32 bytes), or,
//   for sel_rows < 16, xor shuffles among the group's sel_rows lanes; dead
//   items write 3e38 and load nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fma_groupmin.cuh"
#include "wgmma_groupmin.cuh"

namespace {

using namespace wg_gm;  // the wgmma/TMA pieces shared with K2

constexpr int S_ROWS = 1024;  // rows per supertile
constexpr float BIG = 3e38f;

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, the shared mainloop of fma_groupmin.cuh
// ---------------------------------------------------------------------------

// Items (block i, slot u, tile chunk, 128-query tile), the query tile
// fastest: a live item is T row tiles of the supertile against the query
// tile (T = 8, the whole supertile, or 1 when there are too few slots to
// fill the SMs); a dead one writes 3e38.
template <int SEL>
struct K1Job {
  static constexpr int SG = S_ROWS / SEL;       // groups per supertile
  static constexpr int NGT = fma_gm::TR / SEL;  // groups per 128-row tile
  static constexpr int IPG = SEL / 16;          // a thread's rows (i) per group (SEL >= 16)
  const float* q;
  const float* corpus;
  const float* xsq;
  const int* supers;
  const int* ulen;
  float* out;
  int U, qb, d, QT, l2;
  int T, NTC;  // row tiles per item (1 or 8), items per (slot, query tile)
  long long n_items;

  __device__ bool live(long long it) const {
    const long long slot = it / (QT * NTC);
    return (int)(slot % U) < ulen[slot / U];
  }
  __device__ fma_gm::Item item(long long it) const {
    const long long slot = it / (QT * NTC);
    const int tc = (int)(it % (QT * NTC)) / QT, qt = (int)(it % QT);
    const size_t row0 = (size_t)supers[slot] * S_ROWS + (size_t)tc * T * fma_gm::TR;
    return {corpus + row0 * d, q + ((size_t)(slot / U) * qb + (size_t)qt * fma_gm::TQ) * d,
            l2 ? xsq + row0 : nullptr, min(fma_gm::TQ, qb - qt * fma_gm::TQ), T};
  }
  // the item's first group row, at its query tile
  __device__ float* block_out(long long it) const {
    const long long slot = it / (QT * NTC);
    const int tc = (int)(it % (QT * NTC)) / QT;
    return out + ((size_t)slot * SG + (size_t)tc * T * NGT) * qb + (size_t)(it % QT) * fma_gm::TQ;
  }
  __device__ void dead(long long it) const {
    float* o = block_out(it);
    const int q_valid = min(fma_gm::TQ, qb - (int)(it % QT) * fma_gm::TQ);
    for (int e = threadIdx.x; e < T * NGT * fma_gm::TQ; e += fma_gm::THREADS) {
      const int g = e / fma_gm::TQ, c = e % fma_gm::TQ;
      if (c < q_valid) o[(size_t)g * qb + c] = BIG;
    }
  }
  // the tile's NGT group minima.  SEL >= 16: a group is IPG of this
  // thread's rows in all 16 a-lanes, reduced by a shuffle reduce-scatter;
  // lane a gets query 8b + a/2's, and the even lanes of a half-warp store 8
  // consecutive queries (32 bytes).  SEL < 16: rows a + 16i of a group sit
  // in SEL neighbouring a-lanes, reduced by log2(SEL) xor shuffles; the
  // group's first lane stores its 8 queries.
  __device__ void tile(long long it, const fma_gm::Item& item, int t, float (&acc)[8][8],
                       const float* xn, int a, int b) const {
    if constexpr (SEL >= 16) {
      const int c = 8 * b + (a >> 1);  // this lane's query in the tile
      float* o = block_out(it) + (size_t)t * NGT * qb + c;
#pragma unroll
      for (int g = 0; g < NGT; ++g) {
        float m[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) m[j] = INFINITY;
#pragma unroll
        for (int ii = 0; ii < IPG; ++ii) {
          const int i = g * IPG + ii;
          const float x2 = l2 ? xn[a + 16 * i] : 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j)  // 2*acc is exact: one rounding
            m[j] = fminf(m[j], l2 ? __fmaf_rn(-2.0f, acc[i][j], x2) : -acc[i][j]);
        }
        const float v = fma_gm::min16_scatter(m, a);
        if (!(a & 1) && c < item.q_valid) o[(size_t)g * qb] = v;
      }
    } else {
      float* o = block_out(it) + (size_t)t * NGT * qb + 8 * b;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x2 = l2 ? xn[a + 16 * i] : 0.0f;
        const int g = (a + 16 * i) / SEL;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = l2 ? __fmaf_rn(-2.0f, acc[i][j], x2) : -acc[i][j];
#pragma unroll
          for (int w = 1; w < SEL; w <<= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, w));
          if (a % SEL == 0 && 8 * b + j < item.q_valid) o[(size_t)g * qb + j] = v;
        }
      }
    }
  }
  __device__ void item_end(long long, const fma_gm::Item&, int, int) const {}
};

template <int SEL, int VEC>
__global__ void __launch_bounds__(fma_gm::THREADS, 1) k1_groupmin_fma(K1Job<SEL> job) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fma_gm::run<VEC>(job, smem_raw);
}

template <int SEL>
cudaError_t launch_fma(const float* q, const float* corpus, const int* supers, const int* ulen,
                       const float* xsq, float* out, int rows, int U, int qb, int d, int l2,
                       int device, cudaStream_t st) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int QT = (qb + fma_gm::TQ - 1) / fma_gm::TQ;
  // items of the whole supertile (8 row tiles) decode a slot once per 8
  // tiles; items of one tile keep every SM busy when there are few slots
  const long long slot_tiles = (long long)rows * U * QT;
  const int T = slot_tiles >= 16LL * sms ? S_ROWS / fma_gm::TR : 1, NTC = S_ROWS / fma_gm::TR / T;
  const K1Job<SEL> job{q, corpus, xsq, supers, ulen, out, U, qb, d, QT, l2, T, NTC,
                       slot_tiles * NTC};
  // 16-byte copies need 16-byte aligned rows
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  return fma_gm::launch(vec4 ? k1_groupmin_fma<SEL, 4> : k1_groupmin_fma<SEL, 1>, job, sms, st);
}

// ---------------------------------------------------------------------------
// bf16 and int8: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int N_CHUNKS = S_ROWS / WN;

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * KB + ((c ^ (r & 7)) << 4); }

// one 16-byte chunk, byte by byte, zero past `nbytes` (rows that are not
// 16-byte aligned, which TMA cannot address)
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src, int nbytes) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < nbytes) w[b >> 2] |= (uint32_t)__ldg(src + b) << (8 * (b & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float score(float acc, float xn, float, int l2) {
  return l2 ? __fmaf_rn(-2.0f, acc, xn) : -acc;  // 2*acc is exact: one rounding
}
__device__ __forceinline__ float score(int acc, float xn, float t, int l2) {
  const float v = __fmul_rn(-t, (float)acc);  // |acc| <= 127^2 d < 2^24: exact
  return l2 ? __fadd_rn(xn, v) : v;
}

template <int SEL, bool INT8, bool ALIGNED>
__global__ void __launch_bounds__(WT, 1)
groupmin_wgmma(const uint8_t* __restrict__ q, const uint8_t* __restrict__ corpus,
               const int* __restrict__ supers, const int* __restrict__ ulen,
               const float* __restrict__ xsq, const float* __restrict__ t_eff,
               float* __restrict__ out, int U, int qb, int row_bytes, int QT,
               long long n_items, int l2, const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_x) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  constexpr int SG = S_ROWS / SEL;  // groups per supertile
  constexpr int NG = WN / SEL;      // groups per 256-row chunk
  constexpr int CPG = SEL / 8;      // 8-column accumulator blocks per group (SEL >= 8)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Stage* ring = reinterpret_cast<Stage*>(smem_raw + ((1024 - (base & 1023)) & 1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES);  // TMA completion

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int nk = (row_bytes + KB - 1) / KB;
  const long long stride = gridDim.x;
  auto live = [&](long long it) {
    const long long slot = it / QT;
    return (int)(slot % U) < ulen[slot / U];
  };

  // producer cursor: the next (item, 256-row chunk, d stage) to load, with
  // the item's row bases decoded once per item
  long long p_item = blockIdx.x;
  int p_n = 0, p_kc = 0, p_qvalid = 0;
  size_t p_row0 = 0, p_qrow0 = 0;
  auto p_seek = [&]() {
    while (p_item < n_items && !live(p_item)) p_item += stride;
    if (p_item < n_items) {
      const long long slot = p_item / QT;
      const int qt = (int)(p_item % QT);
      p_qvalid = min(WM, qb - qt * WM);
      p_row0 = (size_t)supers[slot] * S_ROWS;
      p_qrow0 = (size_t)(slot / U) * qb + (size_t)qt * WM;
    }
  };
  p_seek();
  // ALIGNED: thread 0 loads a stage with two TMA boxes (zero past d and past
  // the last query row) and one bulk copy of the norms.  Otherwise every
  // thread copies 16-byte chunks byte by byte (rows not 16-byte aligned).
  if constexpr (ALIGNED) {
    if (tid == 0) {
      for (int st = 0; st < STAGES; ++st)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[st])));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // byte path: this thread's 16-byte column, rows tid/8 + 32j, chunk tid%8
  const int c_r = tid >> 3, c_c = tid & 7, c_off = swz(c_r, c_c);
  auto issue = [&](int st) {
    if (p_item >= n_items) return;
    Stage& s = ring[st];
    const size_t row0 = p_row0 + (size_t)p_n * WN;
    const bool norms = l2 && p_kc == nk - 1;
    if constexpr (ALIGNED) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&full[st]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(STAGE_TX + (norms ? WN * 4 : 0))
                     : "memory");
        tma_2d(s.a, &tm_q, p_kc * KB, (int)p_qrow0, bar);
        tma_2d(s.b, &tm_x, p_kc * KB, (int)row0, bar);
        if (norms)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
              "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(s.xn)),
              "l"(xsq + row0), "r"(WN * 4), "r"(bar)
              : "memory");
      }
    } else {
      const int kb = p_kc * KB + c_c * 16;
      const int nb = kb < row_bytes ? min(16, row_bytes - kb) : 0;
#pragma unroll
      for (int j = 0; j < WM / 32; ++j) {
        const int r = c_r + 32 * j;
        const bool ok = nb > 0 && r < p_qvalid;
        copy16(s.a + c_off + j * 32 * KB, ok ? q + (p_qrow0 + r) * row_bytes + kb : q,
               ok ? nb : 0);
      }
#pragma unroll
      for (int j = 0; j < WN / 32; ++j) {
        const int r = c_r + 32 * j;
        copy16(s.b + c_off + j * 32 * KB,
               nb > 0 ? corpus + (row0 + r) * row_bytes + kb : corpus, nb);
      }
      if (norms && tid < WN / 4)
        *reinterpret_cast<float4*>(s.xn + 4 * tid) =
            *reinterpret_cast<const float4*>(xsq + row0 + 4 * tid);
    }
    if (++p_kc == nk) {
      p_kc = 0;
      if (++p_n == N_CHUNKS) {
        p_n = 0;
        p_item += stride;
        p_seek();
      }
    }
  };

  const float t = INT8 ? *t_eff : 0.0f;
  Acc d[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) d[j] = 0;
  for (int st = 0; st < DIST; ++st) issue(st);

  // this thread's two query rows of the tile and its column pair
  const int r0 = wg * 64 + warp * 16 + (lane >> 2), t0 = lane & 3;
  int step = 0;
  for (long long it = blockIdx.x; it < n_items; it += stride) {
    const long long slot = it / QT;
    const int qt = (int)(it % QT), u = (int)(slot % U), i = (int)(slot / U);
    float* out_blk = out + (size_t)slot * SG * qb + (size_t)qt * WM;
    const int q_valid = min(WM, qb - qt * WM);
    if (u >= ulen[i]) {
      for (int e = tid; e < SG * WM; e += WT) {
        const int g = e / WM, c = e % WM;
        if (c < q_valid) out_blk[(size_t)g * qb + c] = BIG;
      }
      continue;
    }
    for (int n = 0; n < N_CHUNKS; ++n) {
      for (int kc = 0; kc < nk; ++kc, ++step) {
        const int st = step % STAGES;
        Stage& s = ring[st];
        if constexpr (ALIGNED)
          wait_full(smem_u32(&full[st]), (step / STAGES) & 1);
        else  // the byte copies are generic-proxy writes; wgmma reads via the async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();  // step's data landed; step-2's MMAs are done everywhere
        const uint64_t da = sw128_desc(s.a + wg * 64 * KB), db = sw128_desc(s.b);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) wgmma_k(d, da + 2 * kk, db + 2 * kk, kc | kk);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        issue((step + DIST) % STAGES);  // the stage of step-2: free; overlaps the MMAs
        if (kc < nk - 1) {
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          continue;
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(d);
        // epilogue: the group minima of this 256-row chunk, in registers.
        // Accumulator block c holds columns 8c + 2*t0 + {0, 1} for rows r0
        // and r0 + 8: a group of SEL >= 8 columns is CPG blocks of all 4
        // lanes of a quad (own columns, then two xor shuffles); a group of
        // SEL <= 4 lies in one lane's pair (SEL 1, 2) or two lanes (4: one
        // shuffle), and its first lane stores it.
        if constexpr (SEL >= 8) {
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            float m0 = INFINITY, m1 = INFINITY;
#pragma unroll
            for (int cc = 0; cc < CPG; ++cc) {
              const int c = g * CPG + cc;
              const float2 xn = l2 ? *reinterpret_cast<const float2*>(&s.xn[8 * c + 2 * t0])
                                   : make_float2(0.0f, 0.0f);
              m0 = fminf(m0, fminf(score(d[4 * c], xn.x, t, l2), score(d[4 * c + 1], xn.y, t, l2)));
              m1 = fminf(m1, fminf(score(d[4 * c + 2], xn.x, t, l2),
                                   score(d[4 * c + 3], xn.y, t, l2)));
            }
            m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
            m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
            m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
            m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
            if ((g & 3) == t0) {
              float* o = out_blk + (size_t)(n * NG + g) * qb;
              if (r0 < q_valid) o[r0] = m0;
              if (r0 + 8 < q_valid) o[r0 + 8] = m1;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < WN / 8; ++c) {
            const int col = 8 * c + 2 * t0;  // this lane's first column
            const float2 xn = l2 ? *reinterpret_cast<const float2*>(&s.xn[col])
                                 : make_float2(0.0f, 0.0f);
            float v[2][2] = {{score(d[4 * c], xn.x, t, l2), score(d[4 * c + 1], xn.y, t, l2)},
                             {score(d[4 * c + 2], xn.x, t, l2),
                              score(d[4 * c + 3], xn.y, t, l2)}};
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // h: rows r0 and r0 + 8
              const int r = r0 + 8 * h;
              float* o = out_blk + (size_t)(n * NG + col / SEL) * qb + r;
              if constexpr (SEL == 1) {
                if (r < q_valid) {
                  o[0] = v[h][0];
                  o[qb] = v[h][1];
                }
              } else {
                float m = fminf(v[h][0], v[h][1]);
                if (SEL == 4) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
                if ((col % SEL) == 0 && r < q_valid) o[0] = m;
              }
            }
          }
        }
        fence_acc(d);
      }
    }
  }
}

template <bool INT8, bool ALIGNED>
cudaError_t launch_wgmma(int sel_rows, const void* q, const void* corpus, const int* supers,
                         const int* ulen, const float* xsq, const float* t_eff, float* out,
                         int rows, int U, int qb, int row_bytes, int n_rows, int l2,
                         int device, cudaStream_t st) {
  auto kernel = sel_rows == 1    ? groupmin_wgmma<1, INT8, ALIGNED>
                : sel_rows == 2  ? groupmin_wgmma<2, INT8, ALIGNED>
                : sel_rows == 4  ? groupmin_wgmma<4, INT8, ALIGNED>
                : sel_rows == 8  ? groupmin_wgmma<8, INT8, ALIGNED>
                : sel_rows == 16 ? groupmin_wgmma<16, INT8, ALIGNED>
                : sel_rows == 32 ? groupmin_wgmma<32, INT8, ALIGNED>
                : sel_rows == 64 ? groupmin_wgmma<64, INT8, ALIGNED>
                                 : groupmin_wgmma<128, INT8, ALIGNED>;
  CUtensorMap tm_q = {}, tm_x = {};
  if (ALIGNED && (!byte_map(&tm_q, q, row_bytes, (long long)rows * qb, WM) ||
                  !byte_map(&tm_x, corpus, row_bytes, n_rows, WN)))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WG_SMEM);
  if (err != cudaSuccess) return err;
  const int QT = (qb + WM - 1) / WM;
  const long long n_items = (long long)rows * U * QT;
  const int grid = (int)(n_items < sms ? n_items : sms);
  kernel<<<grid, WT, WG_SMEM, st>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(corpus), supers, ulen, xsq,
      t_eff, out, U, qb, row_bytes, QT, n_items, l2, tm_q, tm_x);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8.  All pointers are device
// pointers on `device`; the corpus has n_rows rows; xsq (one float per
// corpus row, 16-byte aligned) is read for L2 only, t_eff (1 float) by int8
// only.  Launches on `stream` and returns the cudaError_t of the launch
// (0 = launched).
extern "C" int lira_union_groupmin(int dtype, int l2, const void* q, const void* corpus,
                                   const int* supers, const int* ulen, const float* t_eff,
                                   const float* xsq, float* out, int rows, int U, int qb,
                                   int d, int n_rows, int sel_rows, int device, void* stream) {
  if (rows <= 0 || rows > 65535 || U <= 0 || U > 65535 || qb <= 0 || d <= 0 ||
      n_rows <= 0 || n_rows % S_ROWS || sel_rows <= 0 || sel_rows > 128 ||
      128 % sel_rows || dtype < 0 || dtype > 2 ||
      (l2 && (xsq == nullptr || reinterpret_cast<uintptr_t>(xsq) % 16)) ||
      (dtype == 2 && (d % 4 || t_eff == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *xf = static_cast<const float*>(corpus);
    auto launch = sel_rows == 1    ? launch_fma<1>
                  : sel_rows == 2  ? launch_fma<2>
                  : sel_rows == 4  ? launch_fma<4>
                  : sel_rows == 8  ? launch_fma<8>
                  : sel_rows == 16 ? launch_fma<16>
                  : sel_rows == 32 ? launch_fma<32>
                  : sel_rows == 64 ? launch_fma<64>
                                   : launch_fma<128>;
    err = launch(qf, xf, supers, ulen, xsq, out, rows, U, qb, d, l2, device, st);
    return (int)err;
  }
  // TMA needs 16-byte aligned rows; narrower rows than one 128-byte stage
  // take the byte path too
  const int row_bytes = dtype == 1 ? 2 * d : d;
  const bool aligned = row_bytes % 16 == 0 && row_bytes >= KB &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  if (dtype == 1)
    err = aligned ? launch_wgmma<false, true>(sel_rows, q, corpus, supers, ulen, xsq, t_eff, out,
                                              rows, U, qb, row_bytes, n_rows, l2, device, st)
                  : launch_wgmma<false, false>(sel_rows, q, corpus, supers, ulen, xsq, t_eff,
                                               out, rows, U, qb, row_bytes, n_rows, l2, device,
                                               st);
  else
    err = aligned ? launch_wgmma<true, true>(sel_rows, q, corpus, supers, ulen, xsq, t_eff, out,
                                             rows, U, qb, row_bytes, n_rows, l2, device, st)
                  : launch_wgmma<true, false>(sel_rows, q, corpus, supers, ulen, xsq, t_eff, out,
                                              rows, U, qb, row_bytes, n_rows, l2, device, st);
  return (int)err;
}
