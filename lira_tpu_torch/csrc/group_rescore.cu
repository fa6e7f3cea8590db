// The blocked engine's exact round-2 rescore of one query block, for Hopper.
//
// Replaces no Pallas kernel: the JAX package rescores in XLA
// (lira_tpu/engine/block_scan.py::_screen_rescore's round 2, a gather, an
// f32 matrix-vector product and jax.lax.top_k).  The port ran the same as a
// chain of PyTorch operations a step of queries: a gather that copied each
// query's selected groups into a staging tensor (kg x sel_rows rows, 6.4 MB
// a query at d 960), a cuBLAS GEMV that read it back, gathers of the norms
// and ids, 64-bit keys and a radix top-k, ~15 launches a step, several
// steps a block.  This kernel is the whole step in one launch a block.
//
// The function.  Query i of the block (q (qb, d) f32) selected kg groups
// ggrp[i, :] (int64, rows of the table (n_groups, sel_rows, d) in f32,
// bf16 or int8, widened exactly to f32), valid where vals[i, j] > -1.5e38.
// Candidate (j, r), flat position p = j * sel_rows + r, row = ggrp[i, j] *
// sel_rows + r, scores
//
//   s = bsq[row] - 2 * dot(q_i, row)   (L2),   bsq[row] - dot(q_i, row)   (IP),
//
// the dot accumulated in f32 (fused multiply-adds, another order than
// cuBLAS's).  Where slot j is invalid or ids[row] is -1 the plain version
// scores exactly 3e38 (its 3e38 added to |s| < 2^103 rounds to 3e38): such a
// candidate is dead, and this kernel neither reads its row nor ranks it.
// Output: the k_loc largest -s, descending, the lower p first among equal
// values (lira_tpu_torch/ops/topk.py's order), as (neg, ids[row]), the id
// -1 where neg <= -1.5e38; where fewer than k_loc candidates live, the tail
// is (-3e38, -1), which is what the plain version's dead candidates give
// whatever their positions.
//
// What bounds it on an H100: bytes.  The selected rows read once: 52 x 32
// rows of 3,840 B = 6.4 MB a query at d 960 (1.91 ms for 1,000 queries at
// 3.35 TB/s), 42 x 32 x 512 B = 0.69 MB at d 128; 2 flops a byte of f32, far
// below the FMA ridge.  The design:
//
// 1. A CTA a query, the block's queries in order (blockIdx.x), so the CTAs
//    on the card at once are neighbouring queries of a tour-grouped block,
//    which share groups: their second reads come from the 50 MB L2.
// 2. A warp scores 32 rows at a time: each lane computes one row's address
//    (its slot's group, the id, the norm); all 32 rows are then read with
//    16-byte loads, eight rows' loads in flight a lane (4 KB a warp), a lane
//    summing its part of each row against the query in shared memory; a
//    transposing butterfly (62 shuffles for 32 rows) leaves row l's dot in
//    lane l.  Batches with no live row are skipped, so the margin
//    calibration's exhaustive kg reads only the groups a query probed.
// 3. The top-k_loc stays on chip: live candidates' 64-bit keys
//    ((order-preserving bits of -s) << 32 | ~p, no two equal) go to a buffer
//    of `cap` keys in shared memory (four times k_loc rounded up to a
//    power of two, at least 4,096: 32 KB, 128 KB at k_loc 4,096), those
//    below the last selection's bound dropped; when the buffer is half
//    full, and at the end, a radix select (8 bits a pass, stopping as soon
//    as the bucket at the cut is taken whole) keeps the best k_loc; a
//    bitonic sort orders the last k_loc.
//    Only (qb, k_loc) leaves the chip: no staging tensor, no int64 keys in
//    device memory.
// Rows whose bytes are no multiple of 16 (or a table not 16-byte aligned)
// are read an element at a time: correct, slow, and off every cell's path.
// (Padding the rows instead would change the width of the f32 table that
// K1 also scans and that the bf16 and int8 screen tables derive from.)
//
// Measured on an H100 (chip_smoke.py's phase_group_rescore, seeded blocks):
// 2.11 ms a GIST-shaped block (kg 52, d 960) against 1.90 ms of each query's
// rows read once, 0.36 ms a 10M-shaped one (d 128) against 0.26 (the plain
// chain 7.71 and 2.00); in the cells 1.72 ms for 1,000 GIST queries, below
// the per-query bound through L2 hits among neighbouring queries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int RADIX = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 3e38f;
constexpr float LIVE_ABOVE = -1.5e38f;  // the plain version's -(3e38 / 2)

// order-preserving bits of an f32 (larger value, larger key; -0 below +0)
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A row read 16 bytes at a time (WIDE) or an element at a time, and its
// dot with the query, widened exactly.
template <typename T, bool WIDE>
struct Vec;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }

template <typename T>
struct Vec<T, false> {
  static constexpr int N = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ Raw zero() { return Raw(); }
  static __device__ __forceinline__ float dot(Raw r, const float* q, float acc) {
    return fmaf(widen(r), q[0], acc);
  }
};

template <>
struct Vec<float, true> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float dot(const Raw& r, const float* q, float acc) {
    const float4 qv = *reinterpret_cast<const float4*>(q);
    acc = fmaf(r.x, qv.x, acc);
    acc = fmaf(r.y, qv.y, acc);
    acc = fmaf(r.z, qv.z, acc);
    return fmaf(r.w, qv.w, acc);
  }
};

template <>
struct Vec<__nv_bfloat16, true> {
  static constexpr int N = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ float pair(unsigned w, const float* q, float acc) {
    acc = fmaf(__uint_as_float(w << 16), q[0], acc);  // the lower element first
    return fmaf(__uint_as_float(w & 0xffff0000u), q[1], acc);
  }
  static __device__ __forceinline__ float dot(const Raw& r, const float* q, float acc) {
    const float4 a = *reinterpret_cast<const float4*>(q);
    const float4 b = *reinterpret_cast<const float4*>(q + 4);
    const float qa[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    acc = pair(r.x, qa, acc);
    acc = pair(r.y, qa + 2, acc);
    acc = pair(r.z, qa + 4, acc);
    return pair(r.w, qa + 6, acc);
  }
};

template <>
struct Vec<int8_t, true> {
  static constexpr int N = 16;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ float word(unsigned w, const float* q, float acc) {
    const float4 qv = *reinterpret_cast<const float4*>(q);
    acc = fmaf((float)((int)(w << 24) >> 24), qv.x, acc);
    acc = fmaf((float)((int)(w << 16) >> 24), qv.y, acc);
    acc = fmaf((float)((int)(w << 8) >> 24), qv.z, acc);
    return fmaf((float)((int)w >> 24), qv.w, acc);
  }
  static __device__ __forceinline__ float dot(const Raw& r, const float* q, float acc) {
    acc = word(r.x, q, acc);
    acc = word(r.y, q + 4, acc);
    acc = word(r.z, q + 8, acc);
    return word(r.w, q + 12, acc);
  }
};

// Block-wide: keeps the k largest of the n unique keys buf[0, n) (k <= n)
// in buf[0, k), in no order, and sets ctl[0] (the keys held) to k; returns
// a bound below which no kept key lies.  ctl[1..3]: a pass's digit, the
// keys above it and its bucket's.  Every thread calls it, each having read
// n from ctl[0] before.
__device__ unsigned long long select_top(unsigned long long* buf, int n, int k,
                                         unsigned* hist, unsigned* wsum, int* ctl) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  unsigned long long prefix = 0, pmask = 0;
  int rem = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < RADIX; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += THREADS) {
      const int i = base + tid;
      int bin = -1;
      if (i < n) {
        const unsigned long long key = buf[i];
        if ((key & pmask) == prefix) bin = (int)((key >> shift) & 0xff);
      }
      const unsigned peers = __match_any_sync(FULL, bin);  // one atomic a bin a warp
      if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], (unsigned)__popc(peers));
    }
    __syncthreads();
    // bins from the top: thread t holds 255 - 2t and 254 - 2t
    const unsigned h1 = hist[RADIX - 1 - 2 * tid], h0 = hist[RADIX - 2 - 2 * tid];
    unsigned incl = h1 + h0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[w] = incl;
    __syncthreads();
    for (int v = 0; v < w; ++v) incl += wsum[v];
    const unsigned above = incl - h1 - h0;  // keys in the bins above 255 - 2t
    if (above < (unsigned)rem && (unsigned)rem <= above + h1) {
      ctl[1] = RADIX - 1 - 2 * tid;
      ctl[2] = (int)above;
      ctl[3] = (int)h1;
    } else if (above + h1 < (unsigned)rem && (unsigned)rem <= incl) {
      ctl[1] = RADIX - 2 - 2 * tid;
      ctl[2] = (int)(above + h1);
      ctl[3] = (int)h0;
    }
    __syncthreads();
    const int digit = ctl[1];
    rem -= ctl[2];
    const bool whole = ctl[3] == rem;
    prefix |= (unsigned long long)digit << shift;
    pmask |= 0xffull << shift;
    __syncthreads();  // ctl is rewritten by the next pass
    if (whole) break;  // the bucket at the cut is taken whole
  }
  // the kept keys, (key & pmask) >= prefix, to the front: each tile is read
  // before any of its slots is written, and a write lands below the keys
  // read so far
  if (tid == 0) ctl[0] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + tid;
    unsigned long long key = 0;
    bool keep = false;
    if (i < n) {
      key = buf[i];
      keep = (key & pmask) >= prefix;
    }
    __syncthreads();
    if (keep) buf[atomicAdd(&ctl[0], 1)] = key;
  }
  __syncthreads();
  return prefix;
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS, 4) rescore_kernel(
    const float* __restrict__ q, int d, const float* __restrict__ vals,
    const long long* __restrict__ ggrp, int kg, const T* __restrict__ table,
    const float* __restrict__ bsq, const int* __restrict__ ids, int sel_rows, int ip,
    int k_loc, int cap, float* __restrict__ out_neg, int* __restrict__ out_ids) {
  using V = Vec<T, WIDE>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);  // cap keys
  long long* roff = reinterpret_cast<long long*>(buf + cap);  // a warp's 32 row offsets
  unsigned* hist = reinterpret_cast<unsigned*>(roff + 32 * WARPS);
  unsigned* wsum = hist + RADIX;
  int* ctl = reinterpret_cast<int*>(wsum + WARPS);  // [0]: keys in buf
  float* qs = reinterpret_cast<float*>(ctl + 8);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long qi = blockIdx.x;
  for (int i = tid; i < d; i += THREADS) qs[i] = q[qi * d + i];
  if (tid == 0) ctl[0] = 0;
  __syncthreads();

  const float* vals_q = vals + qi * kg;
  const long long* ggrp_q = ggrp + qi * kg;
  const int n_vec = d / V::N;
  const int n_rows = kg * sel_rows;  // flat positions p = j * sel_rows + r
  long long* my_off = roff + 32 * w;
  unsigned long long bound = 0;  // keys below it cannot make the top k_loc
  int r0 = 0;
  while (r0 < n_rows) {
    int held = ctl[0];
    if (held > cap / 2 && held > k_loc) {
      bound = select_top(buf, held, k_loc, hist, wsum, ctl);
      held = k_loc;
    }
    // each row adds at most one key: the rows that fit
    const int r1 = min(n_rows, r0 + ((cap - held) & ~31));
    for (int b0 = r0 + 32 * w; b0 < r1; b0 += 32 * WARPS) {
      const int p = b0 + lane;
      long long off = -1;
      float sq = 0.f;
      if (p < r1) {
        const int j = p / sel_rows;
        if (vals_q[j] > LIVE_ABOVE) {
          const long long row = ggrp_q[j] * sel_rows + (p - j * sel_rows);
          if (ids[row] >= 0) {
            off = row * d;
            sq = bsq[row];
          }
        }
      }
      if (__ballot_sync(FULL, off >= 0) == 0) continue;  // no live row here
      __syncwarp();
      my_off[lane] = off;
      __syncwarp();
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
#pragma unroll
      for (int s8 = 0; s8 < 32; s8 += 8) {
        long long o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = my_off[s8 + e];
        for (int c = lane; c < n_vec; c += 32) {
          typename V::Raw raw[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            raw[e] = o[e] >= 0 ? V::load(table + o[e] + (long long)c * V::N) : V::zero();
          }
          const float* qc = qs + c * V::N;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[s8 + e] = V::dot(raw[e], qc, acc[s8 + e]);
        }
      }
      // transposing butterfly: row l's dot ends in lane l's acc[0].  At
      // step s a lane keeps the half of its rows that bit s of its lane
      // picks and adds its partner's partial sums of them; both halves are
      // sent, so acc is only ever indexed by constants
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) {
        const bool up = (lane & s) != 0;
#pragma unroll
        for (int i = 0; i < s; ++i) {
          const float lo = acc[i], hi = acc[i + s];
          const float lo_p = __shfl_xor_sync(FULL, lo, s), hi_p = __shfl_xor_sync(FULL, hi, s);
          acc[i] = up ? hi + hi_p : lo + lo_p;
        }
      }
      unsigned long long key = 0;
      bool take = false;
      if (off >= 0) {
        // the plain version's expression; its + 0.0 for a valid slot kept
        const float s = (ip ? sq - acc[0] : sq - 2.0f * acc[0]) + 0.0f;
        key = ((unsigned long long)ordered(-s) << 32) | (unsigned)~(unsigned)p;
        take = key >= bound;
      }
      const unsigned m = __ballot_sync(FULL, take);
      if (m != 0) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&ctl[0], __popc(m));
        at = __shfl_sync(FULL, at, 0);
        if (take) buf[at + __popc(m & ((1u << lane) - 1u))] = key;
      }
    }
    __syncthreads();
    r0 = r1;
  }

  int held = ctl[0];
  if (held > k_loc) {
    select_top(buf, held, k_loc, hist, wsum, ctl);
    held = k_loc;
  }
  int kp = 1;
  while (kp < k_loc) kp <<= 1;
  for (int i = held + tid; i < kp; i += THREADS) buf[i] = 0;  // below every key
  __syncthreads();
  for (int size = 2; size <= kp; size <<= 1) {  // bitonic, descending
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < kp / 2; i += THREADS) {
        const int a = 2 * i - (i & (stride - 1)), b = a + stride;
        const unsigned long long x = buf[a], y = buf[b];
        if ((x < y) == ((a & size) == 0)) {
          buf[a] = y;
          buf[b] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k_loc; i += THREADS) {
    float neg = -BIG;
    int id = -1;
    if (i < held) {
      const unsigned long long key = buf[i];
      neg = unordered((unsigned)(key >> 32));
      const unsigned p = ~(unsigned)key;
      const unsigned j = p / (unsigned)sel_rows;
      if (neg > LIVE_ABOVE) id = ids[ggrp_q[j] * sel_rows + (p - j * sel_rows)];
    }
    out_neg[qi * k_loc + i] = neg;
    out_ids[qi * k_loc + i] = id;
  }
}

template <typename T, bool WIDE>
int launch(const float* q, int d, const float* vals, const long long* ggrp, int qb, int kg,
           const void* table, const float* bsq, const int* ids, int sel_rows, int ip,
           int k_loc, int cap, float* out_neg, int* out_ids, size_t bytes, cudaStream_t st) {
  cudaError_t err;
  // set at every call: the attribute is the current device's, and cheap
  // beside the launch
  if (bytes > 48 * 1024 &&
      (err = cudaFuncSetAttribute(rescore_kernel<T, WIDE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) !=
          cudaSuccess) {
    return (int)err;
  }
  rescore_kernel<T, WIDE><<<qb, THREADS, bytes, st>>>(
      q, d, vals, ggrp, kg, static_cast<const T*>(table), bsq, ids, sel_rows, ip, k_loc,
      cap, out_neg, out_ids);
  return (int)cudaGetLastError();
}

}  // namespace

// The shared memory a launch takes at width d and buffer `cap` (the wrapper
// plans with it).
extern "C" long long lira_group_rescore_smem(int d, int cap) {
  return (long long)cap * 8 + 32 * WARPS * 8 + (RADIX + WARPS) * 4 + 8 * 4 +
         (((long long)d + 3) / 4) * 16;
}

// One block's rescore.  q (qb, d) f32; vals (qb, kg) f32; ggrp (qb, kg)
// int64; table (n_groups, sel_rows, d) of `dtype` (0 f32, 1 bf16, 2 int8);
// bsq and ids (n_groups, sel_rows) f32 and int32; ip: 1 for the inner
// product, 0 for L2; 1 <= k_loc <= kg * sel_rows and 4 * pow2ceil(k_loc) <=
// cap; vec: 1 where the table and its rows are 16-byte aligned (16-byte
// loads), else 0.  out_neg (qb, k_loc) f32, out_ids (qb, k_loc) int32.  All
// pointers on `device`; launches on `stream` and returns the cudaError_t
// (0 = ok).
extern "C" int lira_group_rescore(const float* q, int d, const float* vals,
                                  const long long* ggrp, int qb, int kg, const void* table,
                                  int dtype, int vec, const float* bsq, const int* ids,
                                  int sel_rows, int ip, int k_loc, int cap, float* out_neg,
                                  int* out_ids, int device, void* stream) {
  int kp = 1;
  while (kp < k_loc) kp <<= 1;
  const long long rows = (long long)kg * sel_rows;
  if (d <= 0 || qb <= 0 || kg <= 0 || sel_rows <= 0 || k_loc < 1 || rows > 0x7fffffffll ||
      k_loc > rows || cap % 32 != 0 || 4 * kp > cap || dtype < 0 || dtype > 2 ||
      (vec && d % (16 / (dtype == 0 ? 4 : dtype == 1 ? 2 : 1)) != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)lira_group_rescore_smem(d, cap);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, true>(q, d, vals, ggrp, qb, kg, table, bsq, ids, sel_rows, ip,
                                   k_loc, cap, out_neg, out_ids, bytes, st)
               : launch<float, false>(q, d, vals, ggrp, qb, kg, table, bsq, ids, sel_rows, ip,
                                  k_loc, cap, out_neg, out_ids, bytes, st);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, true>(q, d, vals, ggrp, qb, kg, table, bsq, ids, sel_rows,
                                           ip, k_loc, cap, out_neg, out_ids, bytes, st)
               : launch<__nv_bfloat16, false>(q, d, vals, ggrp, qb, kg, table, bsq, ids, sel_rows,
                                          ip, k_loc, cap, out_neg, out_ids, bytes, st);
  }
  return vec ? launch<int8_t, true>(q, d, vals, ggrp, qb, kg, table, bsq, ids, sel_rows, ip,
                                  k_loc, cap, out_neg, out_ids, bytes, st)
             : launch<int8_t, false>(q, d, vals, ggrp, qb, kg, table, bsq, ids, sel_rows, ip,
                                 k_loc, cap, out_neg, out_ids, bytes, st);
}
