// The blocked engine's masked group selection, for Hopper.
//
// Replaces no Pallas kernel: the JAX package selects in XLA
// (lira_tpu/engine/block_scan.py::_screen_rescore's select_slice, a masked
// add and jax.lax.top_k).  The port ran the same as a chain of PyTorch
// operations (a penalty gather, the masked add, a negated transposed copy,
// 64-bit keys, a radix top-k, gathers), which wrote and read every
// (query, group) pair several times.  This kernel is that chain in one
// pass, bit for bit.
//
// The function.  One block's K1 output gmin (n_g, qb) f32, group-major and
// query-minor; tb (n_g,) int32, the bucket of each group (-1: a padding
// group); probed (qb, n_bkt) bool.  For query q and group g
//
//   s = -(gmin[g, q] + pen),  pen = 0.0f if tb[g] >= 0 and probed[q, tb[g]],
//                             else 3e38f,
//
// the same f32 expression as the plain version, so +0/-0, the 3e38
// rounding and -inf come out identical.  Output: each query's kk largest s
// in descending order, the lower g first among equal s, as (value, g):
// lira_tpu_torch/ops/topk.py's order.  Each candidate is the 64-bit key
// (order-preserving bits of s) << 32 | (n_g - 1 - g), so no two tie.
//
// Groups g >= n_live = min(live * unit, n_g) are the union's padding slots
// (K1 writes them as 3e38, and their tb is -1): their s is -inf by
// construction, they rank after every live group, lower g first, and are
// never read.  Where fewer than kk groups are live, the output's tail is
// (-inf, position), which is what the plain version gives there.
//
// What bounds it on an H100.  The live minima read once: 4 bytes a
// (query, live group).  A 1,024-query block of the 10M cell holds ~494K
// live groups (2.0 GB, 0.60 ms at 3.35 TB/s); the 1M cell's ~24K (0.10 GB,
// 0.03 ms).  The operations are a few a pair.  The design:
//
// 1. select_lists_kernel: a CTA takes QT consecutive queries (32; 16 or 8
//    where a warp's lists would not fit) and one of `chunks` contiguous
//    ranges of the live groups, split further among its W warps.  A lane
//    owns a query: each warp-wide load of a group row is QT consecutive
//    floats (128 bytes at QT 32), and a lane has 64 rows in flight, the
//    next 64 loading while it ranks these.  The probed rows are one 32-bit
//    word a bucket in shared memory (bit l: query l, made by ballots), so a
//    batch costs a lane two word loads and a shuffle a row.
//    A lane keeps its query's running top-kk in shared memory: a sorted
//    list, and a pending buffer of 64 that takes, without a branch, every
//    key above the larger of its list's kk-th and the best kk-th of the
//    CTA's other lists of that query (shared in shared memory: below
//    either, kk keys beat it).  A query probes ~1% of the union, so almost
//    every key fails the compare once the lists are full.  A lane whose
//    buffer may overflow sorts it into its list: alone when its keys are
//    few or nearly in order (the first rows' masked keys come in order), an
//    insertion sort and a merge, all such lanes at once; else the whole
//    warp sorts list and buffer together (a bitonic network, in registers
//    for 128 slots).  Each (query, warp range) writes its sorted top-kk to
//    scratch (n_lists, kk, qb).
// 2. select_merge_kernel: a warp a query merges its n_lists <= 64 sorted
//    lists (two heads a lane, a warp-wide max of the heads kk times) and
//    writes (value, g) and the dead tail.
//
// kk above what shared memory holds in one pass (the margin calibration's
// exhaustive reference selects every group of the union) runs in passes:
// each takes the best kk_pass keys below the last key of the pass before.
//
// Measured on an H100 (chip_smoke.py's phase_group_select, synthetic
// blocks): 1.37 ms a 10M-shaped block (2.3x its 0.60 ms bytes bound), 0.17
// ms a 1M-shaped one, where filling the lists and the final sorts take most
// of the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;  // group rows a lane ranks a batch (and has in flight)
constexpr int PEND = 64;  // pending entries a lane's list keeps
constexpr int MAX_LISTS = 64;  // sorted lists a query's merge takes (two a lane)
constexpr unsigned FULL = 0xffffffffu;
constexpr long long NONE = (long long)0x8000000000000000ull;  // below every key
constexpr long long ABOVE = 0x7fffffffffffffffll;  // above every key

__device__ __forceinline__ float key_value(long long key) {
  int b = (int)(key >> 32);
  b = b < 0 ? b ^ 0x7fffffff : b;
  return __int_as_float(b);
}

__device__ __forceinline__ int live_groups(const int* live, int unit, int n_g) {
  const long long n = (long long)max(live[0], 0) * unit;
  return n < n_g ? (int)n : n_g;
}

__device__ __forceinline__ long long make_key(float s, unsigned tie) {
  int b = __float_as_int(s);
  b = b < 0 ? b ^ 0x7fffffff : b;
  return (long long)(((unsigned long long)(unsigned)b << 32) | tie);
}

// A lane's list: lst[0, cnt) sorted descending and pend = lst + kk, pend[0,
// pc) unsorted.  Sorts the pending keys (insertion: a few, or already in
// order) and merges them in: lst[0, min(kk, cnt + pc)) = the top of both,
// sorted.
__device__ __forceinline__ void lane_flush(long long* lst, int& cnt, int& pc, long long& last,
                                           int kk) {
  long long* pend = lst + kk;
  const int n = pc;
  pc = 0;
  if (n == 0) return;
  for (int i = 1; i < n; ++i) {
    const long long x = pend[i];
    int j = i - 1;
    while (j >= 0 && pend[j] < x) {
      pend[j + 1] = pend[j];
      --j;
    }
    pend[j + 1] = x;
  }
  const int n_new = min(kk, cnt + n);
  int a = 0, b = 0;  // how many of the list and of the pending make the new list
  for (int t = 0; t < n_new; ++t) {
    if (b < n && (a >= cnt || pend[b] > lst[a])) {
      ++b;
    } else {
      ++a;
    }
  }
  int o = n_new - 1;
  --a;
  --b;
  while (b >= 0) {  // from the back: o >= a always, so nothing unread is overwritten
    if (a >= 0 && lst[a] < pend[b]) {
      lst[o--] = lst[a--];
    } else {
      lst[o--] = pend[b--];
    }
  }
  cnt = n_new;
  last = lst[cnt - 1];
}

// The same for one lane's list, by the whole warp: its n_sort (a power of
// two >= kk + PEND) slots, gaps set to NONE, in one bitonic sort.
__device__ __forceinline__ void warp_flush(long long* lst, int cnt, int pc, int kk, int n_sort,
                                           int lane) {
  for (int i = lane; i < n_sort; i += 32) {
    if ((i >= cnt && i < kk) || i >= kk + pc) lst[i] = NONE;
  }
  __syncwarp();
  for (int k = 2; k <= n_sort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < n_sort / 2; i += 32) {
        const int a = 2 * i - (i & (j - 1)), b = a + j;
        const long long x = lst[a], y = lst[b];
        if ((x < y) == ((a & k) == 0)) {  // descending where bit k of a is clear
          lst[a] = y;
          lst[b] = x;
        }
      }
      __syncwarp();
    }
  }
}

// warp_flush for n_sort = 32 * E, in registers: a lane holds E consecutive
// slots; partners within a lane swap in place, the others by shuffles.
template <int E>
__device__ __forceinline__ void warp_flush_reg(long long* lst, int cnt, int pc, int kk,
                                               int lane) {
  long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    v[e] = (i >= cnt && i < kk) || i >= kk + pc ? NONE : lst[i];
  }
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = lane * E + e;
          const long long y = __shfl_xor_sync(FULL, v[e], j / E);
          const bool keep_max = ((i & j) == 0) == ((i & k) == 0);
          v[e] = keep_max ? (v[e] > y ? v[e] : y) : (v[e] < y ? v[e] : y);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & j) continue;
          const long long a = v[e], b = v[e ^ j];
          if ((a < b) == (((lane * E + e) & k) == 0)) {
            v[e] = b;
            v[e ^ j] = a;
          }
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) lst[lane * E + e] = v[e];
  __syncwarp();
}

// Makes room in the lists of the lanes that `need` it: a lane whose pending
// keys are few, or came nearly in descending order (as the first rows'
// masked ones do: few keys above the one before), merges them itself, all
// such lanes at once; the warp sorts the others' one by one.  A full list
// then raises its query's threshold in thr_s.
__device__ __forceinline__ void flush_lanes(bool need, long long* lst, int& cnt, int& pc,
                                            long long& last, int kk, int n_sort,
                                            unsigned long long* thr_s, int lane) {
  int rises = 0;
  if (need) {
    const long long* pend = lst + kk;
    for (int i = 1; i < pc; ++i) rises += pend[i] > pend[i - 1];
  }
  const bool solo = need && (rises <= 4 || pc <= 16);
  if (solo) lane_flush(lst, cnt, pc, last, kk);
  unsigned rest = __ballot_sync(FULL, need && !solo);
  while (rest != 0) {
    const int l = __ffs(rest) - 1;
    rest &= rest - 1;
    const int c = __shfl_sync(FULL, cnt, l), p = __shfl_sync(FULL, pc, l);
    const unsigned long long a = __shfl_sync(FULL, (unsigned long long)lst, l);
    if (n_sort == 128) {
      warp_flush_reg<4>(reinterpret_cast<long long*>(a), c, p, kk, lane);
    } else {
      warp_flush(reinterpret_cast<long long*>(a), c, p, kk, n_sort, lane);
    }
    if (lane == l) {
      cnt = min(kk, c + p);
      pc = 0;
      last = lst[cnt - 1];
    }
  }
  if (need && cnt == kk) atomicMax(thr_s, (unsigned long long)last ^ (1ull << 63));
  __syncwarp();
}

// Rows [H, H + 32) of a batch: the keys that beat the threshold go to the
// pending buffer (room for 32 made first).  A key passes above the larger
// of this list's kk-th and the best kk-th of the CTA's other lists of the
// query: below either, kk keys beat it.  word: the rows' probed bits, row
// H + i's from lane i.
template <int H, bool BOUND>
__device__ __forceinline__ void rank_half(const float (&cur)[ROWS], unsigned word_l, int n_rows,
                                          unsigned tbase, long long ub, int lane, bool act,
                                          long long* lst, long long* pend, int& cnt, int& pc,
                                          long long& last, int kk, int n_sort,
                                          unsigned long long* thr_q) {
  if (__any_sync(FULL, act && pc > PEND - 32)) {
    flush_lanes(act && pc > PEND - 32, lst, cnt, pc, last, kk, n_sort, thr_q, lane);
  }
  long long thr = (long long)(*(volatile unsigned long long*)thr_q ^ (1ull << 63));
  if (cnt == kk && last > thr) thr = last;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const unsigned word = __shfl_sync(FULL, word_l, i);
    const long long key = make_key(-(cur[H + i] + ((word >> lane) & 1u ? 0.0f : 3e38f)),
                                   tbase - (unsigned)(H + i));
    if (H + i < n_rows && key > thr && (!BOUND || key < ub)) pend[pc++] = key;
  }
}

template <bool BOUND>
__global__ void __launch_bounds__(256, 1) select_lists_kernel(
    const float* __restrict__ gmin, const int* __restrict__ tb,
    const unsigned char* __restrict__ probed, const int* __restrict__ live, int unit, int n_g,
    int qb, int n_bkt, int qt, int kk, int stride, int n_sort,
    const long long* __restrict__ bound, long long* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  // bucket b's probed bits: bit l for query q0 + l
  unsigned* mask = reinterpret_cast<unsigned*>(smem);
  // each query's best kk-th key over the CTA's lists, as unsigned order
  unsigned long long* thr_s =
      reinterpret_cast<unsigned long long*>(smem + (((size_t)n_bkt * 4 + 15) / 16) * 16);
  long long* lists = reinterpret_cast<long long*>(thr_s + qt);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int q0 = blockIdx.x * qt;
  const int q = q0 + lane;
  const bool act = lane < qt && q < qb;

  // the bits: a lane reads 16 buckets of its query's row, a ballot a bucket
  const bool vec16 = (n_bkt & 15) == 0 && (reinterpret_cast<uintptr_t>(probed) & 15) == 0;
  const unsigned char* row = probed + (size_t)(act ? q : 0) * n_bkt;
  for (int c = w; c < (n_bkt + 15) / 16; c += W) {
    unsigned by[4] = {0, 0, 0, 0};
    if (act && vec16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * c);
      by[0] = v.x;
      by[1] = v.y;
      by[2] = v.z;
      by[3] = v.w;
    } else if (act) {
      for (int t = 0; t < 16 && 16 * c + t < n_bkt; ++t) {
        by[t >> 2] |= (unsigned)(row[16 * c + t] != 0) << (8 * (t & 3));
      }
    }
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const unsigned bits = __ballot_sync(FULL, (by[t >> 2] >> (8 * (t & 3))) & 0xffu);
      if (lane == 0 && 16 * c + t < n_bkt) mask[16 * c + t] = bits;
    }
  }
  for (int i = threadIdx.x; i < qt; i += blockDim.x) thr_s[i] = 0;  // NONE
  __syncthreads();

  const int n_live = live_groups(live, unit, n_g);
  const int sub = blockIdx.y * W + w, n_sub = gridDim.y * W;
  const int r_beg = (int)((long long)n_live * sub / n_sub);
  const int r_end = (int)((long long)n_live * (sub + 1) / n_sub);
  const int ql = lane < qt ? lane : 0;  // the lanes past qt rank nothing
  long long* lst = lists + (size_t)(w * qt + ql) * stride;
  long long* pend = lst + kk;
  const long long ub = BOUND && act ? bound[q] : ABOVE;
  const unsigned tie0 = (unsigned)(n_g - 1);
  int cnt = 0, pc = 0;
  long long last = NONE;  // lst[cnt - 1] once cnt > 0

  float cur[ROWS], nxt[ROWS];
  int t0 = -1, t1 = -1, n0 = -1, n1 = -1;  // tb of rows base + lane, base + 32 + lane
  {
    const float* src = gmin + (size_t)r_beg * qb + q;
#pragma unroll
    for (int i = 0; i < ROWS; ++i, src += qb) {
      cur[i] = act && r_beg + i < r_end ? __ldcs(src) : 0.0f;
    }
  }
  if (r_beg + lane < r_end) t0 = __ldg(tb + r_beg + lane);
  if (r_beg + 32 + lane < r_end) t1 = __ldg(tb + r_beg + 32 + lane);

  for (int base = r_beg; base < r_end; base += ROWS) {
    const int nb = base + ROWS;
    if (nb < r_end) {  // the next rows load while these are ranked
      const float* src = gmin + (size_t)nb * qb + q;
      if (act && nb + ROWS <= r_end) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i, src += qb) nxt[i] = __ldcs(src);
      } else {
#pragma unroll
        for (int i = 0; i < ROWS; ++i, src += qb) {
          nxt[i] = act && nb + i < r_end ? __ldcs(src) : 0.0f;
        }
      }
      n0 = nb + lane < r_end ? __ldg(tb + nb + lane) : -1;
      n1 = nb + 32 + lane < r_end ? __ldg(tb + nb + 32 + lane) : -1;
    }
    const unsigned w0 = t0 >= 0 ? mask[t0] : 0u, w1 = t1 >= 0 ? mask[t1] : 0u;
    const int n_rows = act ? min(ROWS, r_end - base) : 0;
    const unsigned tbase = tie0 - (unsigned)base;
    rank_half<0, BOUND>(cur, w0, n_rows, tbase, ub, lane, act, lst, pend, cnt, pc, last, kk,
                        n_sort, &thr_s[ql]);
    rank_half<32, BOUND>(cur, w1, n_rows, tbase, ub, lane, act, lst, pend, cnt, pc, last, kk,
                         n_sort, &thr_s[ql]);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) cur[i] = nxt[i];
    t0 = n0;
    t1 = n1;
  }
  flush_lanes(act && pc > 0, lst, cnt, pc, last, kk, n_sort, &thr_s[ql], lane);
  if (act) {
    for (int j = 0; j < kk; ++j) part[((size_t)sub * kk + j) * qb + q] = j < cnt ? lst[j] : NONE;
  }
}

__global__ void select_merge_kernel(const long long* __restrict__ part, int n_lists, int kk,
                                    int qb, int n_g, const int* __restrict__ live, int unit,
                                    int col0, int ld, float* __restrict__ out_v,
                                    long long* __restrict__ out_i, long long* bound_out) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= qb) return;
  const int n_live = live_groups(live, unit, n_g);
  const int n_real = max(0, min(kk, n_live - col0));
  const int l0 = lane, l1 = lane + 32;
  int p0 = 0, p1 = 0;
  long long h0 = l0 < n_lists ? part[(size_t)l0 * kk * qb + q] : NONE;
  long long h1 = l1 < n_lists ? part[(size_t)l1 * kk * qb + q] : NONE;
  float* ov = out_v + (size_t)q * ld + col0;
  long long* oi = out_i + (size_t)q * ld + col0;
  long long best = NONE;
  for (int j = 0; j < n_real; ++j) {
    const long long mine = h0 > h1 ? h0 : h1;
    const int hi = __reduce_max_sync(FULL, (int)(mine >> 32));
    const unsigned lo =
        __reduce_max_sync(FULL, (int)(mine >> 32) == hi ? (unsigned)mine : 0u);
    best = (long long)(((unsigned long long)(unsigned)hi << 32) | lo);
    if (lane == __ffs(__ballot_sync(FULL, mine == best)) - 1) {
      if (h0 == best) {
        ++p0;
        h0 = p0 < kk ? part[((size_t)l0 * kk + p0) * qb + q] : NONE;
      } else {
        ++p1;
        h1 = p1 < kk ? part[((size_t)l1 * kk + p1) * qb + q] : NONE;
      }
    }
    if (lane == 0) {
      ov[j] = key_value(best);
      oi[j] = (long long)(n_g - 1) - (long long)(unsigned)best;
    }
  }
  for (int j = n_real + lane; j < kk; j += 32) {  // past the live groups
    ov[j] = -__int_as_float(0x7f800000);
    oi[j] = col0 + j;
  }
  if (bound_out != nullptr && lane == 0) bound_out[q] = best;
}

__host__ __device__ inline int pow2ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// One block's masked top-kg.  gmin (n_g, qb) f32; tb (n_g,) int32; probed
// (qb, n_bkt) bool; live (1,) int32, live groups = min(live * unit, n_g);
// 1 <= kg <= n_g.  The plan (from the wrapper): qt queries a CTA (32, 16 or
// 8), warps a CTA, chunks of the live groups, kk_pass keys a pass and the
// list stride (> the power of two >= kk_pass + 64); part (chunks * warps,
// kk_pass, qb) int64 scratch, bound (qb,) int64 scratch when kg > kk_pass
// (else ignored).  out_v (qb, kg) f32, out_i (qb, kg) int64.  All pointers
// on `device`; launches on `stream` and returns the cudaError_t (0 = ok).
extern "C" int lira_group_select(const float* gmin, const int* tb, const unsigned char* probed,
                                 const int* live, int unit, int n_g, int qb, int n_bkt, int kg,
                                 int qt, int warps, int chunks, int kk_pass, int stride,
                                 long long* part, long long* bound, float* out_v,
                                 long long* out_i, int device, void* stream) {
  const int n_lists = chunks * warps;
  if (n_g <= 0 || qb <= 0 || n_bkt <= 0 || unit <= 0 || kg < 1 || kg > n_g ||
      (qt != 32 && qt != 16 && qt != 8) || warps < 1 || warps > 8 || chunks < 1 ||
      n_lists > MAX_LISTS || kk_pass < 1 || stride < pow2ceil(kk_pass + PEND) ||
      (kg > kk_pass && bound == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t bytes = ((size_t)n_bkt * 4 + 15) / 16 * 16 +
                       (size_t)qt * sizeof(long long) * (1 + (size_t)warps * stride);
  // set at every call: the attribute is the current device's, and cheap
  // beside the launch
  if (bytes > 48 * 1024 &&
      ((err = cudaFuncSetAttribute(select_lists_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) !=
           cudaSuccess ||
       (err = cudaFuncSetAttribute(select_lists_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) !=
           cudaSuccess)) {
    return (int)err;
  }
  const dim3 grid((qb + qt - 1) / qt, chunks);
  const int merge_warps = 8;
  for (int col0 = 0; col0 < kg; col0 += kk_pass) {
    const int kk = kg - col0 < kk_pass ? kg - col0 : kk_pass;
    const int n_sort = pow2ceil(kk + PEND);
    if (col0 > 0) {
      select_lists_kernel<true><<<grid, 32 * warps, bytes, st>>>(
          gmin, tb, probed, live, unit, n_g, qb, n_bkt, qt, kk, stride, n_sort, bound, part);
    } else {
      select_lists_kernel<false><<<grid, 32 * warps, bytes, st>>>(
          gmin, tb, probed, live, unit, n_g, qb, n_bkt, qt, kk, stride, n_sort, nullptr, part);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    select_merge_kernel<<<(qb + merge_warps - 1) / merge_warps, 32 * merge_warps, 0, st>>>(
        part, n_lists, kk, qb, n_g, live, unit, col0, kg, out_v, out_i,
        col0 + kk < kg ? bound : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
