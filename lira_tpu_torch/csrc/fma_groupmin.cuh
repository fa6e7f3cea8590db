// The f32 mainloop shared by K1 (union_groupmin.cu, f32 mode) and K2
// (groupmin.cu, "highest" mode): a product of queries and
// corpus rows, both d-contiguous ("NT"), on CUDA-core FMAs (no TF32: the
// reference's f32 is "highest"), reduced to group minima in registers.
//
// What bounds it on an H100.  The f32 FMA rate: 67 TFLOP/s at 700 W, with
// 2*128*128*d operations per 128 x 128 tile against 2*128*d*4 bytes read
// from L2 (~64 operations a byte).  The design:
//
// * Work.  A job (K1 or K2) cuts its work into items: 128 queries x up to
//   8 tiles of 128 corpus rows (K1: a 1024-row supertile, or one of its
//   tiles; K2: 8 groups).  CTAs are persistent, one per SM, each walking
//   items blockIdx.x, +gridDim.x, ...; the job orders the query tile
//   fastest, so the CTAs in flight read the same corpus rows from L2.  A
//   job may mark items dead (K1's padding slots): the loop never loads
//   them.
// * Tile.  256 threads, 16 (a) x 16 (b): thread (a, b) accumulates corpus
//   rows a + 16i (i < 8) against queries 8b + j (j < 8), 64 f32 sums in
//   registers.  Rows spread across the 16 a-lanes of a half-warp, so a
//   group of rows reduces in registers and a shuffle reduce-scatter that
//   leaves lane a with query 8b + a/2: 8 lanes hold 8 consecutive queries,
//   one 32-byte sector.  One CTA an SM gives each thread up to 255
//   registers: at 128 (two CTAs an SM) ptxas spills the sums.
// * Ring.  STAGES = 3 stages of 32 floats of d for the 128 rows and the
//   128 queries (and, on a tile's last slice, the rows' 128 norms), filled
//   by cp.async (16 bytes when rows are 16-byte aligned, else 4), zero past
//   d and past the last query.  The producer cursor runs two slices ahead
//   across tile and item boundaries; one barrier per slice.  110 KB.
//   (Slices of 64 floats halve the barriers but make ptxas spill.)
// * Shared-memory layout: row-major, d contiguous, rows padded to 36
//   floats (144 bytes, 9 16-byte units), read as float4 along d.  The 8
//   lanes of a quarter-warp read rows a..a+7: units 9a mod 8, all
//   distinct, so the row reads are free of bank conflicts; the query reads
//   are broadcasts (one b per quarter-warp); cp.async writes 128
//   contiguous bytes per quarter-warp.  No transpose is needed, so the
//   global->shared copy stays asynchronous.
// * Arithmetic: fmaf only, each sum taking its k in ascending order.
// * Epilogue: the job's `tile` gets the 64 sums and the stage's norms
//   while the stage is still intact (it is refilled only after the next
//   barrier), and `item_end` runs after an item's last tile.
// * What it leaves on the table: the loop of FFMAs and float4 loads alone
//   (no barrier, no copies, even no shared loads) stays well below the FMA
//   rate, so the register operand reads of the FFMAs, not shared memory,
//   set the pace; and with one CTA an SM nothing overlaps the epilogues
//   and barriers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fma_gm {

constexpr int TR = 128;         // corpus rows per tile
constexpr int TQ = 128;         // queries per tile
constexpr int BK = 32;          // floats of d per stage
constexpr int LD = BK + 4;      // padded row stride of a stage, floats
constexpr int STAGES = 3;       // ring depth
constexpr int THREADS = 256;    // 16 (rows) x 16 (queries)
constexpr int MAX_TILES = 8;    // row tiles per item

struct Stage {
  float x[TR * LD];  // corpus rows
  float q[TQ * LD];  // queries
  float xn[TR];      // the rows' norms, loaded with a tile's last slice
};
constexpr size_t SMEM = STAGES * sizeof(Stage);

// one item: up to 8 tiles of 128 consecutive corpus rows against one
// query tile
struct Item {
  const float* x;   // first corpus row
  const float* q;   // first query row
  const float* xn;  // norms of the rows (nullptr: none)
  int q_valid;      // queries that exist; the rest load as zero
  int tiles;        // 128-row tiles, 1..8
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `bytes` of 16 (0: zero-fill, src unread)
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// `bytes` of 4
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Fill one stage: slice k0 of 128 rows starting at x (row stride d) and of
// the item's queries.  Thread e's copies: units of VEC floats e + 256r,
// each row BK/VEC units long (neighbouring threads, neighbouring addresses).
template <int VEC>
__device__ __forceinline__ void load_stage(Stage& s, const float* x, const float* q,
                                           int q_valid, int d, int k0) {
  const int tid = threadIdx.x;
  constexpr int PER_ROW = BK / VEC;
#pragma unroll
  for (int r = 0; r < TR * PER_ROW / THREADS; ++r) {
    const int e = tid + r * THREADS, row = e / PER_ROW, col = (e % PER_ROW) * VEC;
    const int k = k0 + col;
    const bool in_d = k < d;  // VEC = 4 only with d % 4 == 0: whole chunks
    const float* xs = in_d ? x + (size_t)row * d + k : x;
    if constexpr (VEC == 4) cp16(&s.x[row * LD + col], xs, in_d ? 16 : 0);
    else cp4(&s.x[row * LD + col], xs, in_d ? 4 : 0);
  }
#pragma unroll
  for (int r = 0; r < TQ * PER_ROW / THREADS; ++r) {
    const int e = tid + r * THREADS, row = e / PER_ROW, col = (e % PER_ROW) * VEC;
    const int k = k0 + col;
    const bool in_q = k < d && row < q_valid;
    const float* qs = in_q ? q + (size_t)row * d + k : q;
    if constexpr (VEC == 4) cp16(&s.q[row * LD + col], qs, in_q ? 16 : 0);
    else cp4(&s.q[row * LD + col], qs, in_q ? 4 : 0);
  }
}

// acc[i][j] += sum over the stage's k (ascending) of x[a+16i][k] * q[8b+j][k]
__device__ __forceinline__ void mma_stage(const Stage& s, float (&acc)[8][8], int a, int b) {
#pragma unroll
  for (int k4 = 0; k4 < BK / 4; ++k4) {
    float4 qv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      qv[j] = *reinterpret_cast<const float4*>(&s.q[(8 * b + j) * LD + 4 * k4]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(&s.x[(a + 16 * i) * LD + 4 * k4]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float t = fmaf(xv.x, qv[j].x, acc[i][j]);
        t = fmaf(xv.y, qv[j].y, t);
        t = fmaf(xv.z, qv[j].z, t);
        acc[i][j] = fmaf(xv.w, qv[j].w, t);
      }
    }
  }
}

// The minimum of each m[j] over the 16 a-lanes of this half-warp,
// scattered: lane a returns query j = a/2's (a reduce-scatter: 8 shuffles,
// where a full reduction of each of the 8 values would take 32).
__device__ __forceinline__ float min16_scatter(const float (&m)[8], int a) {
  constexpr unsigned ALL = 0xffffffffu;
  float m4[4], m2[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // lanes with a & 8 keep j 4..7, the others 0..3
    const bool hi = a & 8;
    m4[j] = fminf(hi ? m[4 + j] : m[j], __shfl_xor_sync(ALL, hi ? m[j] : m[4 + j], 8));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool hi = a & 4;
    m2[j] = fminf(hi ? m4[2 + j] : m4[j], __shfl_xor_sync(ALL, hi ? m4[j] : m4[2 + j], 4));
  }
  const bool hi = a & 2;
  const float v = fminf(hi ? m2[1] : m2[0], __shfl_xor_sync(ALL, hi ? m2[0] : m2[1], 2));
  return fminf(v, __shfl_xor_sync(ALL, v, 1));
}

// The persistent mainloop.  Job provides
//   int d;  long long n_items;
//   bool live(long long it);             dead items are never loaded
//   Item item(long long it);
//   void dead(long long it);             called for each dead item
//   void tile(long long it, const Item&, int t, float (&acc)[8][8], const float* xn, a, b);
//   void item_end(long long it, const Item&, a, b);
template <int VEC, class Job>
__device__ __forceinline__ void run(Job& job, unsigned char* smem) {
  Stage* ring = reinterpret_cast<Stage*>(smem);
  const int tid = threadIdx.x, a = tid % 16, b = tid / 16, d = job.d;
  const int nk = (d + BK - 1) / BK;
  const long long stride = gridDim.x, n = job.n_items;

  // producer cursor: the next (item, tile, slice) to load
  long long p_it = blockIdx.x;
  int p_t = 0, p_k = 0;
  Item p{};
  auto p_seek = [&]() {
    while (p_it < n && !job.live(p_it)) p_it += stride;
    if (p_it < n) p = job.item(p_it);
  };
  p_seek();
  auto issue = [&](int st) {
    if (p_it < n) {
      Stage& s = ring[st];
      load_stage<VEC>(s, p.x + (size_t)p_t * TR * d, p.q, p.q_valid, d, p_k * BK);
      if (p_k == nk - 1 && p.xn != nullptr && tid < TR)
        cp4(&s.xn[tid], p.xn + p_t * TR + tid, 4);
      if (++p_k == nk) {
        p_k = 0;
        if (++p_t == p.tiles) {
          p_t = 0;
          p_it += stride;
          p_seek();
        }
      }
    }
    cp_commit();  // empty groups too: the wait count stays uniform
  };
  for (int st = 0; st < STAGES - 1; ++st) issue(st);

  int step = 0;
  for (long long it = blockIdx.x; it < n; it += stride) {
    if (!job.live(it)) {
      job.dead(it);
      continue;
    }
    const Item item = job.item(it);
    for (int t = 0; t < item.tiles; ++t) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      const Stage* s = nullptr;
      for (int kc = 0; kc < nk; ++kc, ++step) {
        Stage& cur = ring[step % STAGES];
        cp_wait<STAGES - 2>();  // this step's copies (this thread's) landed
        __syncthreads();        // everyone's landed; step-1's stage is free
        issue((step + STAGES - 1) % STAGES);
        mma_stage(cur, acc, a, b);
        s = &cur;
      }
      job.tile(it, item, t, acc, s->xn, a, b);
    }
    job.item_end(it, item, a, b);
  }
  cp_wait<0>();
}

// Launch `kernel(job)` (a kernel that runs `run` on `job`): one persistent
// CTA an SM, or one an item when there are fewer items.
template <class Job>
cudaError_t launch(void (*kernel)(Job), const Job& job, int sms, cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<(int)(job.n_items < sms ? job.n_items : sms), THREADS, SMEM, st>>>(job);
  return cudaGetLastError();
}

}  // namespace fma_gm
