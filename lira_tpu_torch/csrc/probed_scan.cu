// K3: the probed-tile scan, tile-major, for Hopper.
//
// Replaces the TPU kernel lira_tpu/engine/pallas_scan.py::_scan_kernel
// (launched by _pallas_probed_scan) and the final top-k that lira_tpu takes
// after it in XLA.  The function is the TPU kernel's: for every query b, an
// exact top-k over the rows of the 128-row corpus tiles in its own list,
// scored
//
//   L2: sq[r] - 2 q.x_r        IP: sq[r] - q.x_r
//
// with sq given by the caller (the f32 row norm for L2, 0 for IP, 3e38 on
// padding rows); rows whose id is < 0 score exactly 3e38.
//
// What bounds it on an H100.  A 2048-query block of the main path lists
// ~133k (query, tile) pairs over ~8k distinct tiles: ~17 queries probe each
// tile.  The work is 2*d operations a pair row (0.065 ms at 67 TFLOP/s),
// and the bytes that must move are the distinct tiles once each (~0.53 GB,
// 0.166 ms at 3.35 TB/s): bytes bound it.  A kernel that streams each
// query's own tiles moves ~17 times that (the "streamed floor", 2.66 ms a
// block), however well it streams.  So the lists are turned around and each
// tile is read once for a group of the queries that probe it.  Three
// launches, each wrapped in engine/pallas_scan.py:
//
// 1. lira_invert_tile_lists (count, scan, scatter): the live (query, slot)
//    entries grouped by tile, each tile's entries cut into work items of at
//    most QC = 16: item w is (item_tile[w], item_pair[w][16]), a pair being
//    the flat list index b*T + slot (-1 = unused).  The items of a tile are
//    consecutive, tiles ascending; which of a tile's entries share an item
//    follows the order of the atomics and changes nothing in the result.
//
// 2. lira_probed_scan (tile_scan_kernel), per item:
//    * CTAs are persistent (four an SM, as many as fit) and walk items
//      blockIdx.x, +gridDim.x, ...; the CTAs in flight read a popular tile
//      together and L2 serves the repeats; a tile probed by every query is
//      128 items, not one long CTA;
//    * a double-buffered cp.async ring stages 32 floats of d of the tile's
//      128 rows and of the item's 16 queries (rows padded to 36 floats; zero
//      past d and for unused entries); it runs across items, so the next
//      item loads while this one's epilogue sorts; any d works (d = 960 is
//      30 chunks an item), 16-byte copies when d % 4 == 0, 4-byte ones
//      otherwise.  Two stages and four CTAs an SM beat four stages and two
//      (the epilogue's sorts are chains of dependent shuffles: more warps
//      hide them better than a deeper ring hides the loads);
//    * 128 threads, 4 warps of 32 rows each; a lane holds 4 rows x 4
//      queries, 16 f32 sums in registers: per 4 floats of d it loads 4 row
//      and 4 query float4s (eight lanes of distinct rows, four of distinct
//      queries: one conflict-free shared-memory wavefront each) for 64 FMAs;
//    * the sums are true fp32 fmaf in d order (never TF32, no tensor cores);
//      the epilogue rounds as the plain version does (2*dot exactly, then one
//      rounded subtraction, no contraction into an FMA);
//    * per (query, slot), a warp sorts the tile's 128 (score, row) keys with
//      a bitonic network (4 keys a lane, 64-bit keys: score bits, then row)
//      and writes the first kp = min(k, 128) to the slot's row of the
//      (B*T, kp) candidate buffer; slots in no item (holes) are not written.
//
// 3. lira_merge_topk (merge_kernel): one warp a query merges its live slots'
//    sorted lists, the smallest (score, slot) head first, k times.
//
// The union of each slot's top-kp holds the query's top-k, whatever the
// slots are, so the result is exact.  A tile listed twice in one list is two
// slots and yields its rows twice, as the TPU kernel and the plain version
// do.  Of two equal scores a slot keeps the lower row and the merge the
// earlier slot: the order of the plain version.
//
// Left out of the TPU kernel's design, on purpose: the per-lane sorted
// stacks (a lane per row position, R deep, bubble-inserted per tile), the
// 8-sublane query replication and the r_pad rounding (TPU block alignment),
// the SMEM sub-batching of the tile list, and the per-slot DMA semaphores
// (cp.async groups).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;                   // rows per tile = threads per CTA
constexpr int QC = 16;                      // queries per work item
constexpr int DC = 32;                      // floats of d per staged chunk
constexpr int LD = DC + 4;                  // staged row stride in floats
constexpr int QLD = DC + 4;                 // staged query stride in floats
constexpr int NSTAGE = 2;                   // cp.async ring depth
constexpr int STAGE = ROWS * LD + QC * QLD;  // floats per stage: rows, queries
constexpr int SCLD = ROWS + 8;              // score row stride in floats
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

// floats a copy moves, and the query copies each thread issues a stage
template <bool VEC16>
struct Copy {
  static constexpr int W = VEC16 ? 4 : 1;
  static constexpr int PER_ROW = DC / W;           // copies per staged row
  static constexpr int Q_PER_THREAD = QC * PER_ROW / ROWS;
};

// the query rows (b, or -1) whose copies thread t issues for item w
template <bool VEC16>
__device__ __forceinline__ void item_queries(const int* __restrict__ item_pair, int w, int W,
                                             int T, int (&qrow)[Copy<VEC16>::Q_PER_THREAD]) {
#pragma unroll
  for (int i = 0; i < Copy<VEC16>::Q_PER_THREAD; ++i) {
    const int j = (threadIdx.x + ROWS * i) / Copy<VEC16>::PER_ROW;
    const int p = w < W ? item_pair[(size_t)w * QC + j] : -1;
    qrow[i] = p >= 0 ? p / T : -1;
  }
}

// stage chunk c (floats [c*DC, c*DC + DC) of d) of the tile's rows and of
// the item's queries; floats past d and unused queries are zero-filled (a
// zero adds nothing to an FMA chain)
template <bool VEC16>
__device__ __forceinline__ void stage_chunk(float* dst, const float* __restrict__ corpus,
                                            const float* __restrict__ q, int tile,
                                            const int (&qrow)[Copy<VEC16>::Q_PER_THREAD],
                                            int c, int d) {
  using C = Copy<VEC16>;
  const float* src = corpus + (size_t)tile * ROWS * d;
  const int k0 = c * DC;
  float* qs = dst + ROWS * LD;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * C::PER_ROW; e += ROWS) {
    const int r = e / C::PER_ROW, k = k0 + C::W * (e % C::PER_ROW);
    const bool in = k < d;  // d % 4 == 0 when VEC16: a piece is all in or all out
    float* to = dst + r * LD + (k - k0);
    const float* from = in ? src + (size_t)r * d + k : src;
    if constexpr (VEC16) {
      cp_async16(to, from, in ? 16 : 0);
    } else {
      cp_async4(to, from, in ? 4 : 0);
    }
  }
#pragma unroll
  for (int i = 0; i < C::Q_PER_THREAD; ++i) {
    const int e = threadIdx.x + ROWS * i;
    const int j = e / C::PER_ROW, k = k0 + C::W * (e % C::PER_ROW);
    const bool in = qrow[i] >= 0 && k < d;
    float* to = qs + j * QLD + (k - k0);
    const float* from = in ? q + (size_t)qrow[i] * d + k : q;
    if constexpr (VEC16) {
      cp_async16(to, from, in ? 16 : 0);
    } else {
      cp_async4(to, from, in ? 4 : 0);
    }
  }
}

// a score's bits mapped so that unsigned order is float order
__device__ __forceinline__ unsigned score_bits(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a 64-bit key that orders (score, row) pairs: score bits, then the row
__device__ __forceinline__ unsigned long long sort_key(float v, int row) {
  return (static_cast<unsigned long long>(score_bits(v)) << 32) | static_cast<unsigned>(row);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

// ascending bitonic sort of 128 distinct keys across a warp, lane l holding
// positions 4l .. 4l + 3.  Keys are distinct (the row is part of each), so
// one comparison decides each exchange.
__device__ __forceinline__ void warp_sort128(unsigned long long (&key)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= ROWS; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 4) {  // the partner is in lane l ^ (stride / 4)
        const bool up = ((4 * lane) & size) == 0;         // this run ascends
        const bool lower = (lane & (stride >> 2)) == 0;   // the partner is above
        const bool keep_min = up == lower;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, key[e], stride >> 2);
          key[e] = (o < key[e]) == keep_min ? o : key[e];
        }
      } else {  // the partner is in this lane
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((e & stride) == 0) {
            const bool up = ((4 * lane + e) & size) == 0;
            const unsigned long long a = key[e], b = key[e | stride];
            const bool swap = (a > b) == up;
            key[e] = swap ? b : a;
            key[e | stride] = swap ? a : b;
          }
        }
      }
    }
  }
}

static_assert(QC == 16 && ROWS == 128, "the lane map: 4 warps of 32 rows, 4 x 4 sums a lane");

template <bool VEC16>
__global__ void __launch_bounds__(ROWS, 4)
tile_scan_kernel(const float* __restrict__ q, const int* __restrict__ item_tile,
                 const int* __restrict__ item_pair, const float* __restrict__ corpus,
                 const int* __restrict__ ids, const float* __restrict__ sq,
                 float* __restrict__ out_vals, int* __restrict__ out_ids, int W, int T,
                 int d, int kp, int l2) {
  using C = Copy<VEC16>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                     // NSTAGE x STAGE
  float* sc = ring + NSTAGE * STAGE;      // QC x SCLD scores of an item
  int* idr = reinterpret_cast<int*>(sc + QC * SCLD);  // the tile's ROWS ids

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int rg = lane & 7, qg = lane >> 3;  // rows warp*32 + rg + 8i, queries qg + 4j
  const int nc = (d + DC - 1) / DC;
  const int G = gridDim.x;
  auto tile_of = [&](int w) { return w < W ? item_tile[w] : -1; };

  // producer cursor: item pw, chunk pc; the next item's metadata is loaded
  // one item ahead, so a switch waits on no global load
  int pw = blockIdx.x, pc = 0;
  int ptile = tile_of(pw);
  int pq[C::Q_PER_THREAD], nq[C::Q_PER_THREAD];
  item_queries<VEC16>(item_pair, pw, W, T, pq);
  int ntile = tile_of(pw + G);
  item_queries<VEC16>(item_pair, pw + G, W, T, nq);
  auto advance = [&]() {
    if (++pc == nc) {
      pc = 0;
      pw += G;
      ptile = ntile;
#pragma unroll
      for (int i = 0; i < C::Q_PER_THREAD; ++i) pq[i] = nq[i];
      if (ptile >= 0) {
        ntile = tile_of(pw + G);
        item_queries<VEC16>(item_pair, pw + G, W, T, nq);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (ptile >= 0) {
      stage_chunk<VEC16>(ring + s * STAGE, corpus, q, ptile, pq, pc, d);
      advance();
    }
    cp_async_commit();
  }

  // consumer cursor: item cw, chunk cc
  int cw = blockIdx.x, cc = 0, slot = 0;
  int ctile = tile_of(cw);
  int my_id[4];
  float my_sq[4];
  float acc[4][4];    // [row i][query j]
  int cpair[QC / 4];  // the pairs whose slots this warp sorts: queries warp + 4i
  while (ctile >= 0) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // this slot has landed for all threads; the slot
                      // refilled below was consumed by everyone last step
    if (ptile >= 0) {
      stage_chunk<VEC16>(ring + ((slot + NSTAGE - 1) % NSTAGE) * STAGE, corpus, q, ptile, pq,
                         pc, d);
      advance();
    }
    cp_async_commit();

    if (cc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t r = (size_t)ctile * ROWS + warp * 32 + rg + 8 * i;
        my_id[i] = ids[r];
        my_sq[i] = sq[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < QC / 4; ++i) cpair[i] = item_pair[(size_t)cw * QC + warp + 4 * i];
    }
    const float* xs = ring + slot * STAGE + (warp * 32 + rg) * LD;
    const float* qs = ring + slot * STAGE + ROWS * LD + qg * QLD;
#pragma unroll
    for (int k = 0; k < DC; k += 4) {
      float4 x[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(xs + 8 * i * LD + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const float4*>(qs + 4 * j * QLD + k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(x[i].x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(x[i].y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(x[i].z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(x[i].w, w[j].w, acc[i][j]);
        }
      }
    }

    if (++cc == nc) {  // the item's sums are complete: score, sort, write
      cc = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = warp * 32 + rg + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float score =
              __fsub_rn(my_sq[i], l2 ? __fmul_rn(2.0f, acc[i][j]) : acc[i][j]);
          sc[(qg + 4 * j) * SCLD + row] = my_id[i] < 0 ? BIG : score;
        }
        if (qg == 0) idr[row] = my_id[i];
      }
      __syncthreads();  // sc and idr are rewritten only after the next
                        // chunk's barrier, which every warp reaches after
                        // its sorts below
#pragma unroll
      for (int i = 0; i < QC / 4; ++i) {  // this warp's slots: queries warp + 4i
        const int p = cpair[i];
        if (p < 0) continue;  // warp-uniform
        const float4 v =
            *reinterpret_cast<const float4*>(sc + (warp + 4 * i) * SCLD + 4 * lane);
        unsigned long long key[4] = {sort_key(v.x, 4 * lane), sort_key(v.y, 4 * lane + 1),
                                     sort_key(v.z, 4 * lane + 2), sort_key(v.w, 4 * lane + 3)};
        warp_sort128(key);
        float* ov = out_vals + (size_t)p * kp;
        int* oi = out_ids + (size_t)p * kp;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = 4 * lane + e;
          if (pos < kp) {
            ov[pos] = key_score(key[e]);
            oi[pos] = idr[static_cast<int>(key[e] & (ROWS - 1))];
          }
        }
      }
      cw += G;
      ctile = tile_of(cw);
    }
    slot = (slot + 1) % NSTAGE;
  }
  cp_async_wait<0>();
}

// the inversion, 1/3: each live entry's rank among the entries of its tile
// (in the order of the atomics); entries naming no tile get -1
__global__ void invert_count_kernel(const int* __restrict__ tile_idx, int n, int n_tiles,
                                    int* __restrict__ count, int* __restrict__ rank) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int t = tile_idx[i];
    rank[i] = t >= 0 && t < n_tiles ? atomicAdd(count + t, 1) : -1;
  }
}

// 2/3: base[t] = the first item of tile t, the items of the tiles before it
// summed (one CTA; each thread sums a contiguous run of tiles)
__global__ void __launch_bounds__(1024)
invert_scan_kernel(const int* __restrict__ count, int n_tiles, int* __restrict__ base) {
  __shared__ int warp_sum[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int run = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int lo = min(t * run, n_tiles), hi = min(lo + run, n_tiles);
  int mine = 0;
  for (int u = lo; u < hi; ++u) mine += (count[u] + QC - 1) / QC;
  int incl = mine;  // inclusive scan over the warp, then over the warps
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int at = incl - mine + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int u = lo; u < hi; ++u) {
    base[u] = at;
    at += (count[u] + QC - 1) / QC;
  }
}

// 3/3: every live entry into its item; the entry of rank 0 mod QC names the
// item's tile
__global__ void invert_scatter_kernel(const int* __restrict__ tile_idx,
                                      const int* __restrict__ rank,
                                      const int* __restrict__ base, int n,
                                      int* __restrict__ item_tile,
                                      int* __restrict__ item_pair) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int r = rank[i];
    if (r < 0) continue;
    const int t = tile_idx[i];
    const int w = base[t] + r / QC;
    item_pair[(size_t)w * QC + r % QC] = i;
    if (r % QC == 0) item_tile[w] = t;
  }
}

// one warp a query: the k smallest candidates of its live slots, each slot's
// kp candidates sorted ascending; the smallest head wins, the lower slot
// among equal heads.  Holes are never read.  Fewer than k candidates: 3e38
// and -1 after them; a score >= 1e37 comes out with id -1.
__global__ void __launch_bounds__(32)
merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
             const int* __restrict__ tile_idx, int T, int kp, int k,
             float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float head[];                      // T head scores
  int* at = reinterpret_cast<int*>(head + T);          // T head positions
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x, row0 = b * T;
  const float done = __int_as_float(0x7f800000);       // +inf: nothing left
  for (int s = lane; s < T; s += 32) {
    at[s] = 0;
    head[s] = tile_idx[row0 + s] >= 0 ? cand_v[(row0 + s) * kp] : done;
  }
  __syncwarp();
  // this lane's best head: the smallest score, the lowest slot among equals
  float bv = done;
  int bs = T;
  auto rescan = [&]() {
    bv = done;
    bs = T;
    for (int s = lane; s < T; s += 32) {
      if (head[s] < bv) {
        bv = head[s];
        bs = s;
      }
    }
  };
  rescan();
  for (int r = 0; r < k; ++r) {
    float v = bv;
    int s = bs;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int os = __shfl_xor_sync(0xffffffffu, s, off);
      if (ov < v || (ov == v && os < s)) {
        v = ov;
        s = os;
      }
    }
    if (s == T) {  // every list is spent
      if (lane == 0) {
        out_v[b * k + r] = BIG;
        out_i[b * k + r] = -1;
      }
    } else if ((s & 31) == lane) {  // the owner writes and advances
      const int p = at[s];
      out_v[b * k + r] = v;
      out_i[b * k + r] = v < 1e37f ? cand_i[(row0 + s) * kp + p] : -1;
      at[s] = p + 1;
      head[s] = p + 1 < kp ? cand_v[(row0 + s) * kp + p + 1] : done;
      rescan();
    }
    __syncwarp();
  }
}

int sm_count(int device, cudaError_t* err) {
  int sms = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

template <bool VEC16>
cudaError_t launch_scan(const float* q, const int* item_tile, const int* item_pair,
                        const float* corpus, const int* ids, const float* sq, float* out_vals,
                        int* out_ids, int W, int T, int d, int kp, int l2, int device,
                        cudaStream_t st) {
  const size_t bytes = sizeof(float) * ((size_t)NSTAGE * STAGE + QC * SCLD) +
                       sizeof(int) * ROWS;
  cudaError_t err = cudaFuncSetAttribute(tile_scan_kernel<VEC16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(device, &err);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_scan_kernel<VEC16>, ROWS,
                                                      bytes);
  if (err != cudaSuccess) return err;
  const long long fit = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = (int)(W < fit ? W : fit);
  tile_scan_kernel<VEC16><<<grid, ROWS, bytes, st>>>(q, item_tile, item_pair, corpus, ids, sq,
                                                     out_vals, out_ids, W, T, d, kp, l2);
  return cudaGetLastError();
}

}  // namespace

// The inversion.  tile_idx (n,) int32, the (B, T) lists flat, -1 = no tile;
// scratch (n + 2 * n_tiles,) int32; item_tile (W,) and item_pair (W, qc)
// int32, W at least the item count (sum over tiles of ceil(entries / qc)),
// qc = 16.  Items past the last get tile -1 and unused entries -1.  All
// pointers on `device`; launches on `stream` and returns the cudaError_t of
// the launches (0 = ok).
extern "C" int lira_invert_tile_lists(int qc, const int* tile_idx, int n, int n_tiles,
                                      int* scratch, int* item_tile, int* item_pair, int W,
                                      int device, void* stream) {
  if (qc != QC || n <= 0 || n_tiles <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int* count = scratch;
  int* base = scratch + n_tiles;
  int* rank = scratch + 2 * n_tiles;
  if ((err = cudaMemsetAsync(count, 0, sizeof(int) * n_tiles, st)) != cudaSuccess ||
      (err = cudaMemsetAsync(item_tile, 0xff, sizeof(int) * W, st)) != cudaSuccess ||
      (err = cudaMemsetAsync(item_pair, 0xff, sizeof(int) * (size_t)W * QC, st)) !=
          cudaSuccess) {
    return (int)err;
  }
  const int sms = sm_count(device, &err);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int need = (n + threads - 1) / threads;
  const int blocks = need < 8 * sms ? need : 8 * sms;
  invert_count_kernel<<<blocks, threads, 0, st>>>(tile_idx, n, n_tiles, count, rank);
  invert_scan_kernel<<<1, 1024, 0, st>>>(count, n_tiles, base);
  invert_scatter_kernel<<<blocks, threads, 0, st>>>(tile_idx, rank, base, n, item_tile,
                                                    item_pair);
  return (int)cudaGetLastError();
}

// The scan.  q (B, d) f32; item_tile (W,), item_pair (W, qc) int32 from the
// inversion, qc = 16; corpus (n_tiles, 128, d) f32; ids, sq (n_tiles, 128)
// int32 / f32; out_vals, out_ids (B*T, kp), kp in [1, 128]: the row of each
// listed slot gets the slot's kp best (score, id) pairs, ascending; the rows
// of holes are left as they are.  l2 selects the factor 2 on the dot.  All
// pointers on `device`; launches on `stream` and returns the cudaError_t of
// the launch (0 = ok).
extern "C" int lira_probed_scan(int qc, int kp, int l2, const float* q, const int* item_tile,
                                const int* item_pair, const float* corpus, const int* ids,
                                const float* sq, float* out_vals, int* out_ids, int W, int T,
                                int d, int device, void* stream) {
  if (qc != QC || kp < 1 || kp > ROWS || W <= 0 || T <= 0 || d <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(corpus) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
  err = vec16 ? launch_scan<true>(q, item_tile, item_pair, corpus, ids, sq, out_vals, out_ids,
                                  W, T, d, kp, l2, device, st)
              : launch_scan<false>(q, item_tile, item_pair, corpus, ids, sq, out_vals,
                                   out_ids, W, T, d, kp, l2, device, st);
  return (int)err;
}

// The merge.  cand_v, cand_i (B*T, kp) f32 / int32 from the scan; tile_idx
// (B, T) int32 (a slot is read only where it is >= 0); out_v, out_i (B, k),
// k <= T * kp.  All pointers on `device`; launches on `stream` and returns
// the cudaError_t of the launch (0 = ok).
extern "C" int lira_merge_topk(const float* cand_v, const int* cand_i, const int* tile_idx,
                               int B, int T, int kp, int k, float* out_v, int* out_i,
                               int device, void* stream) {
  if (B <= 0 || T <= 0 || kp < 1 || k < 1 || k > T * kp) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)T * (sizeof(float) + sizeof(int));
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  merge_kernel<<<B, 32, bytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      cand_v, cand_i, tile_idx, T, kp, k, out_v, out_i);
  return (int)cudaGetLastError();
}
