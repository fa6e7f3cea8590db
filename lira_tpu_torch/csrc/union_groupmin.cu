// K1: the union group-min screen of the blocked serving scan, for Hopper.
//
// Replaces the TPU kernel lira_tpu/engine/block_scan.py::_union_groupmin_kernel
// (launched by _screen_rescore.screen_chunk).  For every (query block i,
// union slot u) it scores the 1024 corpus rows of supertile supers[i, u]
// (8 tiles of 128 rows) against the block's qb queries and keeps the min
// over each sel_rows-row group:
//
//   L2:  score = ||x||^2 - 2 x.q    (||x||^2 from the rows as loaded)
//   IP:  score = -x.q
//   int8: the int32 dot d8 = x8.q8 is exact; score = -t * d8 (t already
//        doubled by the caller for L2), plus ||x||^2 = sum_d s2_d * x8_d^2.
//
// Slots with u >= ulen[i] are padding: they load nothing and write 3e38.
// Output layout is lira_tpu's: out[i][u*SG + g][q], SG = 1024 / sel_rows.
//
// What bounds it on an H100.  One live slot at the bench shape (qb = 1024,
// d = 128) does 2*1024*1024*128 = 268 M operations and moves 128-512 KB of
// corpus rows (int8..f32) plus 32*1024*4 = 128 KB of group mins: ~500-2000
// operations per byte, so it is compute-bound in every dtype.  The f32
// screen may not use TF32 (the reference is precision="highest"), so its
// ceiling is the 67 TFLOP/s of plain FP32 FMAs; bf16's would be 989 and
// int8's 1979 TOP/s on the tensor cores.
//
// The design is the simple, correct first version: a shared-memory tiled
// product with no tensor cores.  A block owns (i, u, 64 queries) and
// walks the supertile in 16 row tiles of 64 rows; each tile and the query
// tile are staged in shared memory (bf16 widened to f32 exactly on the
// way in, int8 kept packed four to a word), each thread accumulates a 4x4
// patch (FP32 FMAs; __dp4a into int32 for int8), and a per-column running
// min per group lives in shared memory across tiles.  Every sel_rows that
// is a multiple of 32 (32, 64, 128) keeps each thread's 4 rows inside one
// group.  wgmma/TMA pipelining for the bf16/int8 tensor-core rates is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S_ROWS = 1024;           // rows per supertile
constexpr int BM = 64;                 // corpus rows per row tile
constexpr int BN = 64;                 // queries per block
constexpr int PAD = 4;                 // keeps float4 alignment, spreads banks
constexpr int NT = 256;                // 16 row-threads x 16 query-threads
constexpr int MAX_SG = S_ROWS / 32;    // groups per supertile at sel_rows = 32
constexpr float BIG = 3e38f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool dead_slot(const int* ulen, float* out_blk, int i,
                                          int u, int qb, int c0, int SG) {
  if (u < ulen[i]) return false;
  for (int e = threadIdx.x; e < SG * BN; e += NT) {
    const int g = e / BN, c = e % BN;
    if (c0 + c < qb) out_blk[(size_t)g * qb + c0 + c] = BIG;
  }
  return true;
}

// fold the 16 row-threads' 4-row minima of one tile into the group mins
__device__ __forceinline__ void fold_tile(float (*red)[BN], float (*gm)[BN], int rt,
                                          int sel_rows) {
  const int c = threadIdx.x;
  if (c < BN) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int g = (rt * BM + t * 4) / sel_rows;
      gm[g][c] = fminf(gm[g][c], red[t][c]);
    }
  }
}

__device__ __forceinline__ void write_mins(float (*gm)[BN], float* out_blk, int qb,
                                           int c0, int SG) {
  for (int e = threadIdx.x; e < SG * BN; e += NT) {
    const int g = e / BN, c = e % BN;
    if (c0 + c < qb) out_blk[(size_t)g * qb + c0 + c] = gm[g][c];
  }
}

// f32 and bf16: scores in f32 from f32 FMAs (bf16 values widen exactly)
template <typename T>
__global__ void __launch_bounds__(NT)
groupmin_float(const T* __restrict__ q, const T* __restrict__ corpus,
               const int* __restrict__ supers, const int* __restrict__ ulen,
               float* __restrict__ out, int U, int qb, int d, int sel_rows, int l2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);           // [d][BM + PAD]
  float* Qs = Xs + (size_t)d * (BM + PAD);              // [d][BN + PAD]
  float(*red)[BN] = reinterpret_cast<float(*)[BN]>(Qs + (size_t)d * (BN + PAD));
  float(*gm)[BN] = red + 16;                            // [MAX_SG][BN]
  float* xn = reinterpret_cast<float*>(gm + MAX_SG);    // [BM]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * BN, u = blockIdx.y, i = blockIdx.z;
  const int SG = S_ROWS / sel_rows;
  float* out_blk = out + ((size_t)i * U + u) * SG * qb;
  if (dead_slot(ulen, out_blk, i, u, qb, c0, SG)) return;

  for (int e = tid; e < BN * d; e += NT) {
    const int c = e / d, k = e % d;
    Qs[k * (BN + PAD) + c] =
        (c0 + c < qb) ? widen(q[((size_t)i * qb + c0 + c) * d + k]) : 0.0f;
  }
  for (int e = tid; e < MAX_SG * BN; e += NT) gm[e / BN][e % BN] = INFINITY;

  const size_t row0 = (size_t)supers[(size_t)i * U + u] * S_ROWS;
  for (int rt = 0; rt < S_ROWS / BM; ++rt) {
    __syncthreads();  // previous tile's Xs/red reads are done
    const T* src = corpus + (row0 + (size_t)rt * BM) * d;
    for (int e = tid; e < BM * d; e += NT) {
      const int r = e / d, k = e % d;
      Xs[k * (BM + PAD) + r] = widen(src[e]);
    }
    __syncthreads();
    if (l2) {  // ||x||^2 of the loaded rows: 4 threads per row
      const int r = tid / 4, part = tid % 4;
      float s = 0.0f;
      for (int k = part; k < d; k += 4) {
        const float v = Xs[k * (BM + PAD) + r];
        s = fmaf(v, v, s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) xn[r] = s;
    }
    float acc[4][4] = {};
    for (int k = 0; k < d; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[k * (BM + PAD) + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Qs[k * (BN + PAD) + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
    }
    __syncthreads();  // xn written
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float mn = INFINITY;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float v = l2 ? xn[ty * 4 + m] - 2.0f * acc[m][n] : -acc[m][n];
        mn = fminf(mn, v);
      }
      red[ty][tx * 4 + n] = mn;
    }
    __syncthreads();
    fold_tile(red, gm, rt, sel_rows);
  }
  __syncthreads();
  write_mins(gm, out_blk, qb, c0, SG);
}

// int8: exact int32 dot through __dp4a on words of four int8 values
__global__ void __launch_bounds__(NT)
groupmin_int8(const int8_t* __restrict__ q, const int8_t* __restrict__ corpus,
              const int* __restrict__ supers, const int* __restrict__ ulen,
              const float* __restrict__ t_eff, const float* __restrict__ s2,
              float* __restrict__ out, int U, int qb, int d, int sel_rows, int l2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d4 = d / 4;
  int* Xw = reinterpret_cast<int*>(smem);                  // [d4][BM + PAD]
  int* Qw = Xw + (size_t)d4 * (BM + PAD);                  // [d4][BN + PAD]
  float(*red)[BN] = reinterpret_cast<float(*)[BN]>(Qw + (size_t)d4 * (BN + PAD));
  float(*gm)[BN] = red + 16;
  float* xn = reinterpret_cast<float*>(gm + MAX_SG);       // [BM]
  float* s2s = xn + BM;                                    // [d]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * BN, u = blockIdx.y, i = blockIdx.z;
  const int SG = S_ROWS / sel_rows;
  float* out_blk = out + ((size_t)i * U + u) * SG * qb;
  if (dead_slot(ulen, out_blk, i, u, qb, c0, SG)) return;

  const int* qw = reinterpret_cast<const int*>(q);
  for (int e = tid; e < BN * d4; e += NT) {
    const int c = e / d4, k = e % d4;
    Qw[k * (BN + PAD) + c] = (c0 + c < qb) ? qw[((size_t)i * qb + c0 + c) * d4 + k] : 0;
  }
  for (int e = tid; e < MAX_SG * BN; e += NT) gm[e / BN][e % BN] = INFINITY;
  if (l2)
    for (int k = tid; k < d; k += NT) s2s[k] = s2[k];
  const float t = *t_eff;

  const size_t row0 = (size_t)supers[(size_t)i * U + u] * S_ROWS;
  for (int rt = 0; rt < S_ROWS / BM; ++rt) {
    __syncthreads();
    const int* src = reinterpret_cast<const int*>(corpus + (row0 + (size_t)rt * BM) * d);
    for (int e = tid; e < BM * d4; e += NT) {
      const int r = e / d4, k = e % d4;
      Xw[k * (BM + PAD) + r] = src[e];
    }
    __syncthreads();
    if (l2) {  // sum_d s2_d * x8_d^2 in f32: 4 threads per row
      const int r = tid / 4, part = tid % 4;
      float s = 0.0f;
      for (int k = part; k < d4; k += 4) {
        const int w = Xw[k * (BM + PAD) + r];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float v = (float)(int8_t)((w >> (8 * b)) & 0xff);
          s = fmaf(s2s[4 * k + b], v * v, s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) xn[r] = s;
    }
    int acc[4][4] = {};
    for (int k = 0; k < d4; ++k) {
      const int4 a = *reinterpret_cast<const int4*>(&Xw[k * (BM + PAD) + ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&Qw[k * (BN + PAD) + tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = __dp4a(av[m], bv[n], acc[m][n]);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float mn = INFINITY;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float v = -t * (float)acc[m][n];  // |acc| <= 127^2 d < 2^24: exact in f32
        if (l2) v = xn[ty * 4 + m] + v;
        mn = fminf(mn, v);
      }
      red[ty][tx * 4 + n] = mn;
    }
    __syncthreads();
    fold_tile(red, gm, rt, sel_rows);
  }
  __syncthreads();
  write_mins(gm, out_blk, qb, c0, SG);
}

size_t common_smem() { return (16 + MAX_SG) * BN * sizeof(float) + BM * sizeof(float); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8.  All pointers are device
// pointers on `device`; t_eff (1 float) and s2 (d floats) are read by int8
// only.  Launches on `stream` and returns the cudaError_t of the launch
// (0 = launched).
extern "C" int lira_union_groupmin(int dtype, int l2, const void* q, const void* corpus,
                                   const int* supers, const int* ulen, const float* t_eff,
                                   const float* s2, float* out, int rows, int U, int qb,
                                   int d, int sel_rows, int device, void* stream) {
  if (rows <= 0 || rows > 65535 || U <= 0 || U > 65535 || qb <= 0 || d <= 0 ||
      (sel_rows != 32 && sel_rows != 64 && sel_rows != 128))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((qb + BN - 1) / BN, U, rows), block(NT);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    if (d % 4) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(d / 4) * (BM + PAD + BN + PAD) * sizeof(int) +
                        common_smem() + (size_t)d * sizeof(float);
    err = cudaFuncSetAttribute(groupmin_int8, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    groupmin_int8<<<grid, block, smem, st>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus), supers, ulen,
        t_eff, s2, out, U, qb, d, sel_rows, l2);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)d * (BM + PAD + BN + PAD) * sizeof(float) + common_smem();
  if (dtype == 0) {
    err = cudaFuncSetAttribute(groupmin_float<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    groupmin_float<float><<<grid, block, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(corpus), supers, ulen, out,
        U, qb, d, sel_rows, l2);
  } else if (dtype == 1) {
    err = cudaFuncSetAttribute(groupmin_float<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    groupmin_float<__nv_bfloat16><<<grid, block, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(corpus),
        supers, ulen, out, U, qb, d, sel_rows, l2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
