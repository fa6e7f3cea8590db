// K3: the per-query probed-tile scan, for Hopper.
//
// Replaces the TPU kernel lira_tpu/engine/pallas_scan.py::_scan_kernel
// (launched by _pallas_probed_scan).  For every query b it walks the
// query's own list of 128-row corpus tiles and keeps, for each row position
// ("lane") 0..127 of a tile, the R best scores seen in that lane across the
// list, sorted ascending:
//
//   L2: sq[r] - 2 q.x_r        IP: sq[r] - q.x_r
//
// sq is given by the caller: the f32 row norm for L2, 0 for IP, and 3e38 on
// padding rows; rows whose id is < 0 score exactly 3e38.  A new candidate is
// bubble-inserted into its lane's stack with a strict "<", so of two equal
// scores the earlier one stays first, as in the TPU kernel.  Because a lane
// sees one candidate per tile, a lane stack R >= k deep holds every
// candidate of the query's top-k.  Output: vals (B, R, 128) f32 and ids
// (B, R, 128) int32; the wrapper takes the final top-k over the R*128
// candidates (lira_tpu does the same outside its kernel, in XLA).
//
// A -1 anywhere in a list is skipped, so lists with holes need no packing;
// the tiles are taken in list order.
//
// What bounds it on an H100.  Each query reads its own probed tiles: at the
// main path's operating point ~65 tiles of 128 x 128 f32 (64 KB) a query,
// ~4.3 MB a query, for ~256 FLOP per 512-byte row, i.e. 0.5 FLOP per byte.
// Streamed per query, that is far under the card's ~20 FLOP/byte f32
// balance point, so the kernel is bound by the bytes it streams from L2 and
// device memory (queries of one block share many tiles, so L2 serves part
// of them).  The design keeps enough bytes in flight and does little else:
//
//   * one block of 128 threads per query; thread t owns row t of every tile
//     (the TPU's lane) and keeps that lane's stack: in registers for R <= 64
//     (the loops are unrolled so the stack never leaves registers), in
//     shared memory [R][128] for R = 128;
//   * tiles are staged in shared memory in chunks of 32 floats of d by a
//     4-deep cp.async ring with 16-byte copies (4-byte copies when d is not
//     a multiple of 4), coalesced along each row; any d works (d = 960 is
//     30 chunks a tile) and a block needs ~74 KB of staging, so several
//     blocks share an SM and keep its loads in flight;
//   * the staged row stride is 36 floats, so the 128 threads reading their
//     own rows with 16-byte loads touch distinct banks in each phase;
//   * the products are true fp32 FMAs in d order; the epilogue rounds as the
//     plain version does (2*dot exactly, then one rounded subtraction, no
//     contraction into an FMA).
//
// Left out of the TPU kernel's design, on purpose: the 8-sublane query
// replication and the r_pad rounding to 8 (TPU block alignment), the SMEM
// sub-batching of the tile list (a CUDA block reads its own list from
// device memory), and the per-slot DMA semaphores (cp.async groups).  TMA,
// cluster multicast of tiles shared by a block's queries, and several
// queries per block are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;      // rows per tile = threads per block
constexpr int DC = 32;         // floats of d per staged chunk
constexpr int LD = DC + 4;     // staged row stride in floats (bank spread)
constexpr int NSTAGE = 4;      // cp.async ring depth
constexpr float BIG = 3e38f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// stage chunk c (floats [c*DC, c*DC + DC) of d) of every row of `tile`;
// floats past d are zero-filled (a zero adds nothing to the FMA chain)
template <bool VEC16>
__device__ __forceinline__ void stage_chunk(float* dst, const float* __restrict__ corpus,
                                            int tile, int c, int d) {
  const float* src = corpus + (size_t)tile * ROWS * d;
  const int k0 = c * DC;
  if (VEC16) {
#pragma unroll
    for (int e = threadIdx.x; e < ROWS * (DC / 4); e += ROWS) {
      const int r = e / (DC / 4), p = e % (DC / 4), k = k0 + 4 * p;
      const bool in = k < d;  // d % 4 == 0: a piece is all in or all out
      cp_async16(dst + r * LD + 4 * p, in ? src + (size_t)r * d + k : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DC; e += ROWS) {
      const int r = e / DC, p = e % DC, k = k0 + p;
      const bool in = k < d;
      cp_async4(dst + r * LD + p, in ? src + (size_t)r * d + k : src, in ? 4 : 0);
    }
  }
}

// one bubble pass of (v, id) through a lane's ascending stack, as the TPU
// kernel does it: at each depth the smaller value stays (ties keep the
// resident), the larger moves on; what leaves the last depth is dropped.
// A candidate not below the deepest value changes nothing, so it is skipped.
template <int R>
__device__ __forceinline__ void insert_reg(float (&sv)[R], int (&si)[R], float v, int id) {
  if (!(v < sv[R - 1])) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool take = v < sv[r];
    const float ov = sv[r];
    const int oi = si[r];
    sv[r] = take ? v : ov;
    si[r] = take ? id : oi;
    v = take ? ov : v;
    id = take ? oi : id;
  }
}

template <int R>
__device__ __forceinline__ void insert_smem(float* sv, int* si, float v, int id) {
  const int t = threadIdx.x;
  if (!(v < sv[(R - 1) * ROWS + t])) return;
  for (int r = 0; r < R; ++r) {
    const float ov = sv[r * ROWS + t];
    if (v < ov) {
      const int oi = si[r * ROWS + t];
      sv[r * ROWS + t] = v;
      si[r * ROWS + t] = id;
      v = ov;
      id = oi;
    }
  }
}

template <int R, bool VEC16>
__global__ void __launch_bounds__(ROWS)
probed_scan_kernel(const float* __restrict__ q, const int* __restrict__ tile_idx,
                   const float* __restrict__ corpus, const int* __restrict__ ids,
                   const float* __restrict__ sq, float* __restrict__ out_vals,
                   int* __restrict__ out_ids, int T, int d, int l2) {
  constexpr bool SMEM_STACK = R > 64;
  extern __shared__ __align__(16) float smem[];
  const int nc = (d + DC - 1) / DC;
  float* stage = smem;                      // NSTAGE x ROWS x LD
  float* q_s = stage + NSTAGE * ROWS * LD;  // nc * DC, zero past d
  float* sv_s = q_s + nc * DC;              // R x ROWS (SMEM_STACK only)
  int* si_s = reinterpret_cast<int*>(sv_s + R * ROWS);

  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int* list = tile_idx + (size_t)b * T;
  for (int i = t; i < nc * DC; i += ROWS) q_s[i] = i < d ? q[(size_t)b * d + i] : 0.0f;

  float sv[SMEM_STACK ? 1 : R];
  int si[SMEM_STACK ? 1 : R];
  if constexpr (SMEM_STACK) {
    for (int r = 0; r < R; ++r) {
      sv_s[r * ROWS + t] = BIG;
      si_s[r * ROWS + t] = -1;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sv[r] = BIG;
      si[r] = -1;
    }
  }

  // producer and consumer walk the same (tile j, chunk c) sequence over the
  // list's live entries; every thread keeps both cursors, so they agree
  // without shared state.  A cursor at T (tile -1) has nothing left.
  auto next_live = [&](int j) {
    while (j < T && list[j] < 0) ++j;
    return j;
  };
  const int j0 = next_live(0);
  const int first = j0 < T ? list[j0] : -1;
  int pj = j0, pc = 0, ptile = first;
  auto advance = [&]() {
    if (++pc == nc) {
      pc = 0;
      pj = next_live(pj + 1);
      ptile = pj < T ? list[pj] : -1;
    }
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (ptile >= 0) {
      stage_chunk<VEC16>(stage + s * ROWS * LD, corpus, ptile, pc, d);
      advance();
    }
    cp_async_commit();
  }

  int cj = j0, cc = 0, slot = 0, ctile = first;
  int my_id = -1;
  float my_sq = BIG, acc = 0.0f;
  while (ctile >= 0) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // this slot has landed for all threads; the slot
                      // refilled below was consumed by everyone last step
    if (ptile >= 0) {
      stage_chunk<VEC16>(stage + ((slot + NSTAGE - 1) % NSTAGE) * ROWS * LD, corpus, ptile,
                         pc, d);
      advance();
    }
    cp_async_commit();

    if (cc == 0) {
      my_id = ids[(size_t)ctile * ROWS + t];
      my_sq = sq[(size_t)ctile * ROWS + t];
      acc = 0.0f;
    }
    const float* xr = stage + slot * ROWS * LD + t * LD;
    const float* qc = q_s + cc * DC;
#pragma unroll
    for (int k = 0; k < DC; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(xr + k);
      const float4 w = *reinterpret_cast<const float4*>(qc + k);
      acc = fmaf(x.x, w.x, acc);
      acc = fmaf(x.y, w.y, acc);
      acc = fmaf(x.z, w.z, acc);
      acc = fmaf(x.w, w.w, acc);
    }
    if (++cc == nc) {
      cc = 0;
      float score = __fsub_rn(my_sq, l2 ? __fmul_rn(2.0f, acc) : acc);
      if (my_id < 0) score = BIG;
      if constexpr (SMEM_STACK) {
        insert_smem<R>(sv_s, si_s, score, my_id);
      } else {
        insert_reg<R>(sv, si, score, my_id);
      }
      cj = next_live(cj + 1);
      ctile = cj < T ? list[cj] : -1;
    }
    slot = (slot + 1) % NSTAGE;
  }
  cp_async_wait<0>();

  float* ov = out_vals + (size_t)b * R * ROWS;
  int* oi = out_ids + (size_t)b * R * ROWS;
  if constexpr (SMEM_STACK) {
    for (int r = 0; r < R; ++r) {
      ov[r * ROWS + t] = sv_s[r * ROWS + t];
      oi[r * ROWS + t] = si_s[r * ROWS + t];
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ov[r * ROWS + t] = sv[r];
      oi[r * ROWS + t] = si[r];
    }
  }
}

template <int R, bool VEC16>
cudaError_t launch(const float* q, const int* tile_idx, const float* corpus, const int* ids,
                   const float* sq, float* out_vals, int* out_ids, int B, int T, int d,
                   int l2, cudaStream_t st) {
  const int nc = (d + DC - 1) / DC;
  const size_t bytes = sizeof(float) * ((size_t)NSTAGE * ROWS * LD + (size_t)nc * DC) +
                       (R > 64 ? (size_t)R * ROWS * (sizeof(float) + sizeof(int)) : 0);
  cudaError_t err = cudaFuncSetAttribute(probed_scan_kernel<R, VEC16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  probed_scan_kernel<R, VEC16><<<B, ROWS, bytes, st>>>(q, tile_idx, corpus, ids, sq,
                                                      out_vals, out_ids, T, d, l2);
  return cudaGetLastError();
}

template <bool VEC16>
cudaError_t dispatch(int R, const float* q, const int* tile_idx, const float* corpus,
                     const int* ids, const float* sq, float* out_vals, int* out_ids, int B,
                     int T, int d, int l2, cudaStream_t st) {
  switch (R) {
    case 8:
      return launch<8, VEC16>(q, tile_idx, corpus, ids, sq, out_vals, out_ids, B, T, d, l2, st);
    case 16:
      return launch<16, VEC16>(q, tile_idx, corpus, ids, sq, out_vals, out_ids, B, T, d, l2, st);
    case 32:
      return launch<32, VEC16>(q, tile_idx, corpus, ids, sq, out_vals, out_ids, B, T, d, l2, st);
    case 64:
      return launch<64, VEC16>(q, tile_idx, corpus, ids, sq, out_vals, out_ids, B, T, d, l2, st);
    case 128:
      return launch<128, VEC16>(q, tile_idx, corpus, ids, sq, out_vals, out_ids, B, T, d, l2,
                                st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, d) f32; tile_idx (B, T) int32, -1 = no tile (skipped); corpus
// (n_tiles, 128, d) f32; ids, sq (n_tiles, 128) int32 / f32; out_vals,
// out_ids (B, R, 128).  R is one of 8, 16, 32, 64, 128.  l2 selects the
// factor 2 on the dot.  All pointers on `device`; launches on `stream` and
// returns the cudaError_t of the launch (0 = ok).
extern "C" int lira_probed_scan(int R, int l2, const float* q, const int* tile_idx,
                                const float* corpus, const int* ids, const float* sq,
                                float* out_vals, int* out_ids, int B, int T, int d,
                                int device, void* stream) {
  if (B <= 0 || T <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  err = vec16 ? dispatch<true>(R, q, tile_idx, corpus, ids, sq, out_vals, out_ids, B, T, d,
                               l2, st)
              : dispatch<false>(R, q, tile_idx, corpus, ids, sq, out_vals, out_ids, B, T, d,
                                l2, st);
  return (int)err;
}
