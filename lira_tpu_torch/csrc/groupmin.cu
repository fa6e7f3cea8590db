// K2: the dense group-min sweep of the fused two-round kNN, for Hopper.
//
// Replaces the TPU kernel lira_tpu/ops/knn_pallas.py::_groupmin_kernel
// (launched by _round1_select).  For every query q and every 128-row group
// g of the padded corpus it writes the minimum over the group's rows of
//
//   L2:   bsq[r] - 2 q.x_r
//   IP:   bsq[r] - q.x_r
//   int8: bsq[r] - t * (q8.x8_r)   (t = t_eff, already doubled for L2)
//
// bsq is given: the exact f32 norm (0 for IP) plus the 1e30 pad penalty, so
// pad rows never win.  mode 0 multiplies true f32 values (no TF32), mode 1
// bf16 values with f32 sums (the TPU's default-precision pass), mode 2 takes
// an exact int32 dot.  Output layout: out[q * n_groups + g], i.e. (Q,
// n_groups), so the top-kg that follows reads one contiguous row per query.
//
// What bounds it on an H100.  At the main path's shape (Q = 8192 queries,
// n_pad ~ 1M rows, d = 128) one launch does 2*Q*n_pad*d ~ 2.1 T operations
// against at most 512 MB of corpus, 4 MB of queries and 32 MB of output:
// hundreds of operations per byte in every mode, so each is bound by its
// arithmetic: the 67 TFLOP/s of plain FP32 FMAs in mode 0 (TF32 is not
// allowed: the self-kNN cache is labelled exact), the tensor cores' 989
// (bf16) and 1979 (int8) T/s in modes 1 and 2.
//
// The design.  All modes walk items of 128 queries x 8 groups (1024 corpus
// rows) on persistent CTAs, one an SM, the query tile fastest, so the CTAs
// in flight share one 1024-row stretch of the corpus in L2 and each group
// is read from device memory about once per launch.  A query's 8 minima of
// an item are written together: one 32-byte sector.
// * Mode 0 runs on the f32 mainloop shared with K1 (fma_groupmin.cuh): a
//   3-stage cp.async ring over slices of 32 floats of d (any d); 8x8 sums a
//   thread; a group's min is the thread's 8 rows plus a shuffle
//   reduce-scatter.  The epilogue rounds the product before the subtraction
//   (no FMA contraction), as the plain version and the TPU kernel do.
// * Modes 1 and 2 run on the tensor cores (wgmma_groupmin.cuh, as K1's
//   bf16/int8 screen): a 128-query x 256-row tile is two m64n256 products
//   (k16 bf16, k32 int8), one for each consumer warpgroup, out of a 4-stage
//   ring.  A producer warpgroup (its registers given up to the consumers
//   with setmaxnreg) has one thread fill the ring with TMA boxes (queries,
//   rows; zero past Q and past the corpus) and a bulk copy of the rows'
//   bsq, each stage as soon as every consumer warp has released it (an
//   "empty" mbarrier a stage).  Rows are padded by the caller to whole
//   128-byte steps of d (64 bf16, 128 int8 columns; zero columns change no
//   dot).  The two consumer warpgroups take turns issuing each d step's
//   MMAs (a "turn" mbarrier each), so that one reduces its last tile while
//   the other's MMAs run: the tensor cores do not idle through an epilogue.
// * The epilogue stays in registers.  A group is 128 accumulator columns:
//   the thread's own 32 columns of each of its two query rows, then a quad
//   shuffle (xor 1, 2); each lane keeps the item's 8 minima of its two rows
//   and a quad writes them as two 32-byte sectors at the item's end.  The
//   128 x 1024 score block never exists.  The score rounds as the plain
//   version's: bf16 bsq - s*acc with s*acc exact (s = 1 or 2: one FFMA, one
//   rounding); int8 bsq - t*(float)acc, the product rounded first, the
//   int32 sum rounded to f32 by one I2FP (to nearest, as the plain
//   version's f64 -> f32).
// * What it leaves on the table: the query box is loaded again for every
//   256-row tile (from L2), and the epilogue's CUDA-core work (int8: a
//   conversion, a multiply, a subtraction and a min per score) outlasts
//   the int8 MMAs it overlaps.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fma_groupmin.cuh"
#include "wgmma_groupmin.cuh"

namespace {

constexpr int GROUP = 128;     // corpus rows per group
constexpr int ITEM_GROUPS = 8;  // groups per item (1024 rows)

// ---------------------------------------------------------------------------
// mode 0 (f32): CUDA-core FMAs, the shared mainloop of fma_groupmin.cuh
// ---------------------------------------------------------------------------

// items (8-group tile gt, 128-query tile qt), qt fastest
struct K2Job {
  const float* q;
  const float* base;
  const float* bsq;
  float* out;
  int Q, n_groups, d, QT;
  float scale;
  long long n_items;
  float keep[4];  // lane a: groups 4(a%2)..+3 of the item for query 8b + a/2

  __device__ bool live(long long) const { return true; }
  __device__ fma_gm::Item item(long long it) const {
    const int gt = (int)(it / QT), qt = (int)(it % QT);
    return {base + (size_t)gt * fma_gm::MAX_TILES * GROUP * d,
            q + (size_t)qt * fma_gm::TQ * d, bsq + (size_t)gt * fma_gm::MAX_TILES * GROUP,
            min(fma_gm::TQ, Q - qt * fma_gm::TQ), min(fma_gm::MAX_TILES, n_groups - gt * fma_gm::MAX_TILES)};
  }
  __device__ void dead(long long) const {}
  __device__ void tile(long long, const fma_gm::Item&, int t, float (&acc)[8][8],
                       const float* xn, int a, int) {
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x2 = xn[a + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = fminf(m[j], x2 - __fmul_rn(scale, acc[i][j]));
    }
    const float v = fma_gm::min16_scatter(m, a);  // query 8b + a/2's minimum of group t
    if ((t >> 2) == (a & 1)) {
#pragma unroll
      for (int s = 0; s < 4; ++s) keep[s] = s == (t & 3) ? v : keep[s];
    }
  }
  __device__ void item_end(long long it, const fma_gm::Item& item, int a, int b) const {
    const int qq = (int)(it % QT) * fma_gm::TQ + 8 * b + (a >> 1);
    const int n = item.tiles - 4 * (a & 1);  // of this lane's 4 groups
    if (qq >= Q || n <= 0) return;
    float* o = out + (size_t)qq * n_groups + (it / QT) * fma_gm::MAX_TILES + 4 * (a & 1);
    if (n >= 4 && n_groups % 4 == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(keep[0], keep[1], keep[2], keep[3]);
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (s < n) o[s] = keep[s];
    }
  }
};

template <int VEC>
__global__ void __launch_bounds__(fma_gm::THREADS, 1) k2_groupmin_fma(K2Job job) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fma_gm::run<VEC>(job, smem_raw);
}

// ---------------------------------------------------------------------------
// modes 1 (bf16) and 2 (int8): wgmma on the tensor cores
// ---------------------------------------------------------------------------

using namespace wg_gm;

struct WgArgs {
  const float* bsq;
  float* out;
  int Q, n_groups, row_bytes, QT;
  long long n_items;
  float scale;  // bf16: 2 (L2) or 1 (IP); int8: t_eff, read from the device
};

constexpr int PT = WT + 128;  // two consumer warpgroups, one producer warpgroup
// the ring, its full and empty mbarriers, the two turn mbarriers, two
// copies of a tile's norms for each consumer warpgroup, alignment slack
constexpr size_t K2_SMEM = STAGES * sizeof(Stage) + (2 * STAGES + 2) * sizeof(uint64_t) +
                           4 * WN * sizeof(float) + 1024;

__device__ __forceinline__ float score(float acc, float xn, float s) {
  return __fmaf_rn(-s, acc, xn);  // s*acc is exact (s = 1 or 2): one rounding
}
__device__ __forceinline__ float score(int acc, float xn, float t) {
  return __fsub_rn(xn, __fmul_rn(t, (float)acc));
}

template <bool INT8>
__device__ __forceinline__ void k2_wgmma_run(const WgArgs& p, const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_x) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sbase = smem_u32(smem_raw);
  Stage* ring = reinterpret_cast<Stage*>(smem_raw + ((1024 - (sbase & 1023)) & 1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES);  // the stage's TMA landed
  uint64_t* empty = full + STAGES;  // every consumer warp is done with the stage
  uint64_t* turn = empty + STAGES;  // turn[w]: warpgroup w may issue its next d step
  float* xn_copy = reinterpret_cast<float*>(turn + 2);  // [warpgroup][2][WN]

  const int tid = threadIdx.x;
  const int nk = p.row_bytes / KB;
  const long long stride = gridDim.x;
  const int n_rows = p.n_groups * GROUP;
  // an item's groups: 8, fewer in the last group tile
  auto item_groups = [&](long long it) {
    return min(ITEM_GROUPS, p.n_groups - (int)(it / p.QT) * ITEM_GROUPS);
  };
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(smem_u32(&full[st]), 1);
      mbar_init(smem_u32(&empty[st]), 8);  // one arrival per consumer warp
    }
    mbar_init(smem_u32(&turn[0]), 1);
    mbar_init(smem_u32(&turn[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WT) {
    // the producer warpgroup: one thread fills the ring as stages free up,
    // walking the same (item, 256-row tile, d step) sequence as the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != WT) return;
    int step = 0;
    for (long long it = blockIdx.x; it < p.n_items; it += stride) {
      const int groups = item_groups(it);
      for (int n = 0; n < (groups + 1) / 2; ++n) {
        const int row0 = (int)(it / p.QT) * ITEM_GROUPS * GROUP + n * WN;
        const int rows = min(WN, n_rows - row0);  // 128 in an odd last group pair
        for (int kc = 0; kc < nk; ++kc, ++step) {
          const int st = step % STAGES;
          Stage& s = ring[st];
          wait_full(smem_u32(&empty[st]), ((step / STAGES) & 1) ^ 1);
          const bool norms = kc == nk - 1;
          const uint32_t bar = smem_u32(&full[st]);
          arrive_expect_tx(bar, STAGE_TX + (norms ? rows * 4 : 0));
          tma_2d(s.a, tm_q, kc * KB, (int)(it % p.QT) * WM, bar);
          tma_2d(s.b, tm_x, kc * KB, row0, bar);
          if (norms) bulk_g2s(s.xn, p.bsq + row0, rows * 4, bar);
        }
      }
    }
    return;
  }

  // The consumers.  Warpgroups 0 and 1 take turns issuing a step's MMAs,
  // so that one reduces its last tile while the other's last MMAs run.  (A
  // turn is a step, not a tile: a tile of more steps than the ring holds
  // needs the other warpgroup to release its first stages.)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2), t0 = lane & 3;  // rows r0, r0 + 8
  float keep0[ITEM_GROUPS], keep1[ITEM_GROUPS];  // the item's minima of rows r0, r0 + 8
#pragma unroll
  for (int g = 0; g < ITEM_GROUPS; ++g) keep0[g] = keep1[g] = INFINITY;
  const float sc = p.scale;
  Acc d[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) d[j] = 0;
  auto release = [&](int stp) {  // this warp is done with step stp's stage
    if (lane == 0) mbar_arrive(smem_u32(&empty[stp % STAGES]));
  };
  if (tid == 0) mbar_arrive(smem_u32(&turn[0]));  // warpgroup 0 goes first
  uint32_t turn_parity = 0;
  int step = 0, tiles = 0;
  for (long long it = blockIdx.x; it < p.n_items; it += stride) {
    const int groups = item_groups(it);
    for (int n = 0; n < (groups + 1) / 2; ++n, ++tiles) {
      for (int kc = 0; kc < nk; ++kc, ++step) {
        const int st = step % STAGES;
        Stage& s = ring[st];
        wait_full(smem_u32(&turn[wg]), turn_parity);
        turn_parity ^= 1;
        wait_full(smem_u32(&full[st]), (step / STAGES) & 1);
        const uint64_t da = sw128_desc(s.a + wg * 64 * KB), db = sw128_desc(s.b);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) wgmma_k(d, da + 2 * kk, db + 2 * kk, kc | kk);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (wtid == 0) mbar_arrive(smem_u32(&turn[wg ^ 1]));  // the other's turn
        if (kc > 0) {  // the previous step's MMAs are done: free its stage
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          release(step - 1);
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      // the tile's norms, copied out so that its last stage is freed now
      float* xn = xn_copy + (wg * 2 + (tiles & 1)) * WN;
      *reinterpret_cast<float2*>(&xn[2 * wtid]) =
          *reinterpret_cast<const float2*>(&ring[(step - 1) % STAGES].xn[2 * wtid]);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's
      release(step - 1);
      // the tile's two groups: accumulator block c (columns 8c + 2*t0 +
      // {0, 1}) holds d[4c], d[4c+1] of row r0 and d[4c+2], d[4c+3] of
      // row r0 + 8; group h is blocks 16h..16h+15 of all 4 quad lanes.
      // Both are reduced even where the second lies past the corpus (no
      // branch around accumulator reads: ptxas would serialize the MMAs);
      // its minima land in a keep slot that is never written out.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = 2 * n + h;  // the group within the item
        float m[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
#pragma unroll
        for (int cc = 0; cc < 16; ++cc) {
          const int c = 16 * h + cc;
          const float2 x2 = *reinterpret_cast<const float2*>(&xn[8 * c + 2 * t0]);
          m[0] = fminf(m[0], score(d[4 * c], x2.x, sc));
          m[1] = fminf(m[1], score(d[4 * c + 1], x2.y, sc));
          m[2] = fminf(m[2], score(d[4 * c + 2], x2.x, sc));
          m[3] = fminf(m[3], score(d[4 * c + 3], x2.y, sc));
        }
        float m0 = fminf(m[0], m[1]), m1 = fminf(m[2], m[3]);
        m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fminf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fminf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
#pragma unroll
        for (int k = 0; k < ITEM_GROUPS; ++k) {
          keep0[k] = k == g ? m0 : keep0[k];
          keep1[k] = k == g ? m1 : keep1[k];
        }
      }
      fence_acc(d);
    }
    // the item's minima: lanes t0 = 0, 1 write row r0's groups 0-3, 4-7,
    // lanes 2, 3 row r0 + 8's: 32 bytes a query
    const int row = (int)(it % p.QT) * WM + r0 + (t0 & 2) * 4;
    const int g0 = (t0 & 1) * 4, n_w = groups - g0;
    if (row < p.Q && n_w > 0) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = (t0 & 2) ? ((t0 & 1) ? keep1[4 + k] : keep1[k])
                        : ((t0 & 1) ? keep0[4 + k] : keep0[k]);
      float* o = p.out + (size_t)row * p.n_groups + (it / p.QT) * ITEM_GROUPS + g0;
      if (n_w >= 4 && p.n_groups % 4 == 0) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < n_w) o[k] = v[k];
      }
    }
  }
}

__global__ void __launch_bounds__(PT, 1)
k2_groupmin_bf16(const WgArgs p, const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_x) {
  k2_wgmma_run<false>(p, &tm_q, &tm_x);
}

__global__ void __launch_bounds__(PT, 1)
k2_groupmin_int8(WgArgs p, const float* __restrict__ t_eff,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_x) {
  p.scale = *t_eff;
  k2_wgmma_run<true>(p, &tm_q, &tm_x);
}

}  // namespace

// mode: 0 = f32 (any d), 1 = bf16 (d a multiple of 64), 2 = int8 (d a
// multiple of 128; t_eff one float on the device).  Modes 1 and 2 need q,
// base and bsq 16-byte aligned.  l2 selects the factor 2 on the float dot
// (int8 carries it in t_eff).  q is (Q, d), base (n_groups*128, d), bsq
// (n_groups*128,), out (Q, n_groups), all device pointers on `device`.
// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
extern "C" int lira_groupmin(int mode, int l2, const void* q, const void* base,
                             const float* bsq, const float* t_eff, float* out, int Q,
                             int n_groups, int d, int device, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (Q <= 0 || n_groups <= 0 || d <= 0 || (long long)n_groups * GROUP > 0x7fffffffLL ||
      mode < 0 || mode > 2 || (mode == 1 && d % 64) ||
      (mode == 2 && (d % 128 || !t_eff)) ||
      (mode > 0 && (misaligned(q) || misaligned(base) || misaligned(bsq))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int n_gt = (n_groups + ITEM_GROUPS - 1) / ITEM_GROUPS;
  if (mode == 0) {
    const int QT = (Q + fma_gm::TQ - 1) / fma_gm::TQ;
    const K2Job job{static_cast<const float*>(q), static_cast<const float*>(base), bsq, out, Q,
                    n_groups, d, QT, l2 ? 2.0f : 1.0f, (long long)n_gt * QT, {}};
    // 16-byte copies need 16-byte aligned rows
    const bool vec4 = d % 4 == 0 && !misaligned(q) && !misaligned(base);
    return (int)fma_gm::launch(vec4 ? k2_groupmin_fma<4> : k2_groupmin_fma<1>, job, sms, st);
  }
  const int row_bytes = mode == 1 ? 2 * d : d;
  CUtensorMap tm_q = {}, tm_x = {};
  if (!byte_map(&tm_q, q, row_bytes, Q, WM) ||
      !byte_map(&tm_x, base, row_bytes, (long long)n_groups * GROUP, WN))
    return (int)cudaErrorInvalidValue;
  const int QT = (Q + WM - 1) / WM;
  const WgArgs args{bsq, out, Q, n_groups, row_bytes, QT, (long long)n_gt * QT,
                    l2 ? 2.0f : 1.0f};
  const int grid = (int)(args.n_items < sms ? args.n_items : sms);
  if (mode == 1) {
    err = cudaFuncSetAttribute(k2_groupmin_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)K2_SMEM);
    if (err == cudaSuccess) k2_groupmin_bf16<<<grid, PT, K2_SMEM, st>>>(args, tm_q, tm_x);
  } else {
    err = cudaFuncSetAttribute(k2_groupmin_int8, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)K2_SMEM);
    if (err == cudaSuccess) k2_groupmin_int8<<<grid, PT, K2_SMEM, st>>>(args, t_eff, tm_q, tm_x);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
