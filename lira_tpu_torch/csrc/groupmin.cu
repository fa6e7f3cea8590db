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
// rounds q and x to bf16 first (the TPU's default-precision pass: bf16
// inputs, f32 accumulation), mode 2 takes an exact int32 dot with __dp4a.
// Output layout: out[q * n_groups + g], i.e. (Q, n_groups), so the top-kg
// that follows reads one contiguous row per query.
//
// What bounds it on an H100.  At the main path's shape (Q = 8192 queries,
// n_pad ~ 1M rows, d = 128, f32) one launch does 2*Q*n_pad*d ~ 2.1 T
// operations and must move the corpus (512 MB), the queries (4 MB) and the
// output (256 MB): ~2,800 operations per byte, so it is bound by the
// 67 TFLOP/s of plain FP32 FMAs (TF32 is not allowed: the self-kNN cache
// is labelled exact).  bf16 and int8 would be bound by the tensor cores'
// 989 / 1979 T/s, which this first version does not use.
//
// The design.  Modes 0 and 1 run on the f32 mainloop shared with K1
// (fma_groupmin.cuh): persistent CTAs walk (8-group tile, 128-query tile)
// items, query tile fastest, so the CTAs in flight share one 1024-row
// stretch of the corpus in L2 and each group is read from device memory
// once per launch; a 3-stage cp.async ring over slices of 32 floats of d
// (any d); 8x8 sums a thread.  A group's min is the thread's 8 rows plus
// a shuffle reduce-scatter; each lane keeps 4 of the item's minima for one
// query and writes them with its neighbour as 8 consecutive groups: one
// 32-byte sector a query.  Mode 1 rounds the staged values to bf16.  The
// epilogue rounds the product before the subtraction (no FMA contraction),
// as the plain version and the TPU kernel do.  Mode 2 (int8) keeps the first
// version's body: one block per (group, 128 queries), 8x8 __dp4a sums, the
// group min through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fma_groupmin.cuh"

namespace {

constexpr int GROUP = 128;  // corpus rows per group (= per block)
constexpr int BQ = 128;     // queries per block
constexpr int KW = 16;      // int8 words (4 values each) of d per stage
constexpr int PAD = 4;      // keeps float4 alignment, spreads banks
constexpr int NT = 256;     // 16 row-threads x 16 query-threads

// min over each query column of the thread's 8 rows, then across the 16
// row-threads; thread c < BQ writes query c's min for this group
__device__ __forceinline__ void write_group_min(float (&sc)[8][8], float (*red)[BQ],
                                                float* __restrict__ out, int Q,
                                                int n_groups, int g, int q0, int tx,
                                                int ty) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float mn = sc[0][n];
#pragma unroll
    for (int m = 1; m < 8; ++m) mn = fminf(mn, sc[m][n]);
    red[ty][(n < 4 ? 0 : 64) + tx * 4 + (n & 3)] = mn;
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < BQ && q0 + c < Q) {
    float mn = red[0][c];
#pragma unroll
    for (int t = 1; t < 16; ++t) mn = fminf(mn, red[t][c]);
    out[(size_t)(q0 + c) * n_groups + g] = mn;
  }
}

// modes 0 (f32) and 1 (bf16-rounded inputs): items (8-group tile gt,
// 128-query tile qt), qt fastest
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

template <int VEC, bool ROUND>
__global__ void __launch_bounds__(fma_gm::THREADS, 1) k2_groupmin_fma(K2Job job) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fma_gm::run<VEC, ROUND>(job, smem_raw);
}

// mode 2 (int8): exact int32 dots through __dp4a on words of four values
__global__ void __launch_bounds__(NT, 2)
knn_groupmin_int8(const int* __restrict__ q, const int* __restrict__ base,
                  const float* __restrict__ bsq, const float* __restrict__ t_eff,
                  float* __restrict__ out, int Q, int n_groups, int d4) {
  __shared__ __align__(16) int Xw[KW][GROUP + PAD];
  __shared__ __align__(16) int Qw[KW][BQ + PAD];
  __shared__ float red[16][BQ];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_qt = (Q + BQ - 1) / BQ;
  const int q0 = (int)(blockIdx.x % n_qt) * BQ, g = (int)(blockIdx.x / n_qt);
  const int* xg = base + (size_t)g * GROUP * d4;

  int acc[8][8] = {};
  for (int k0 = 0; k0 < d4; k0 += KW) {
    for (int e = tid; e < GROUP * KW; e += NT) {
      const int r = e / KW, k = e % KW;
      const bool in_d = k0 + k < d4;
      Xw[k][r] = in_d ? xg[(size_t)r * d4 + k0 + k] : 0;
      Qw[k][r] = (in_d && q0 + r < Q) ? q[(size_t)(q0 + r) * d4 + k0 + k] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int4 a0 = *reinterpret_cast<const int4*>(&Xw[k][ty * 4]);
      const int4 a1 = *reinterpret_cast<const int4*>(&Xw[k][64 + ty * 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&Qw[k][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&Qw[k][64 + tx * 4]);
      const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = __dp4a(av[m], bv[n], acc[m][n]);
    }
    __syncthreads();
  }
  const float t = *t_eff;
  float sc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float b = bsq[(size_t)g * GROUP + (m < 4 ? 0 : 64) + ty * 4 + (m & 3)];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[m][n] = b - __fmul_rn(t, (float)acc[m][n]);
  }
  write_group_min(sc, red, out, Q, n_groups, g, q0, tx, ty);
}

}  // namespace

// mode: 0 = f32, 1 = bf16-rounded f32 inputs, 2 = int8 (d a multiple of 4;
// t_eff one float on the device).  l2 selects the factor 2 on the f32
// dot (int8 carries it in t_eff).  q is (Q, d), base (n_groups*128, d),
// bsq (n_groups*128,), out (Q, n_groups), all device pointers on `device`.
// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
extern "C" int lira_groupmin(int mode, int l2, const void* q, const void* base,
                             const float* bsq, const float* t_eff, float* out, int Q,
                             int n_groups, int d, int device, void* stream) {
  const long long blocks = (long long)((Q + BQ - 1) / BQ) * n_groups;
  if (Q <= 0 || n_groups <= 0 || d <= 0 || blocks > 0x7fffffffLL || mode < 0 ||
      mode > 2 || (mode == 2 && (d % 4 || !t_eff)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mode == 2) {
    knn_groupmin_int8<<<dim3((unsigned)blocks), dim3(NT), 0, st>>>(
        static_cast<const int*>(q), static_cast<const int*>(base), bsq, t_eff, out, Q,
        n_groups, d / 4);
    return (int)cudaGetLastError();
  }
  const int QT = (Q + fma_gm::TQ - 1) / fma_gm::TQ;
  const int n_gt = (n_groups + fma_gm::MAX_TILES - 1) / fma_gm::MAX_TILES;
  const K2Job job{static_cast<const float*>(q), static_cast<const float*>(base), bsq, out, Q,
                  n_groups, d, QT, l2 ? 2.0f : 1.0f, (long long)n_gt * QT, {}};
  // 16-byte copies need 16-byte aligned rows
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(base) % 16 == 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = mode == 1 ? (vec4 ? k2_groupmin_fma<4, true> : k2_groupmin_fma<1, true>)
                                : (vec4 ? k2_groupmin_fma<4, false> : k2_groupmin_fma<1, false>);
  return (int)fma_gm::launch(kernel, job, sms, st);
}
