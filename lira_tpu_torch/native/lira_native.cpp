// Host-side native runtime of lira_tpu_torch (a copy of
// lira_tpu/native/lira_native.cpp, the same functions and C ABI).
//
// The card owns the compute path (distances, top-k, training); these are the
// host-side data-structure hot spots that sit between disk and device
// memory, the moral equivalent of the reference's C++ runtime glue
// (inverted-list construction in its serving engine, xvecs parsing in its
// tools):
//
//   * CSR inverted-list build from a (n, n_mul) assignment matrix —
//     O(n) counting sort with (bucket, id) dedup, replacing the numpy
//     argsort path for 100M-scale corpora.
//   * probed-tile list expansion for the serving engine — per-query
//     bucket→tile-range flattening, OpenMP over the query batch.
//   * fvecs/bvecs record parsing into contiguous float32.
//
// Exposed as a C ABI for ctypes; built by lira_tpu_torch/native/__init__.py
// with g++ at first use.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CSR inverted lists.
//
// Pass 1 (csr_count): per-bucket deduplicated member counts.
// Pass 2 (csr_fill):  scatter member ids (sorted ascending per bucket by
//                     construction: rows are scanned in increasing id order).
// Dedup invariant: duplicates of one (id, bucket) pair can only come from
// multiple slots of the same row, so comparing against the bucket's most
// recently written id suffices.
// ---------------------------------------------------------------------------

void csr_count(const int32_t* d2b, int64_t n, int32_t n_mul, int32_t n_bkt,
               int64_t* counts /* (n_bkt) zeroed by caller */) {
  std::vector<int64_t> last(n_bkt, -1);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = d2b + i * n_mul;
    for (int32_t j = 0; j < n_mul; ++j) {
      int32_t b = row[j];
      if (b < 0 || b >= n_bkt) continue;
      if (last[b] == i) continue;  // same (id, bucket) pair again
      last[b] = i;
      counts[b]++;
    }
  }
}

void csr_fill(const int32_t* d2b, int64_t n, int32_t n_mul, int32_t n_bkt,
              const int64_t* offsets /* (n_bkt+1) prefix sums of counts */,
              int32_t* ids /* (total) output */) {
  std::vector<int64_t> cursor(n_bkt);
  std::memcpy(cursor.data(), offsets, n_bkt * sizeof(int64_t));
  std::vector<int64_t> last(n_bkt, -1);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = d2b + i * n_mul;
    for (int32_t j = 0; j < n_mul; ++j) {
      int32_t b = row[j];
      if (b < 0 || b >= n_bkt) continue;
      if (last[b] == i) continue;
      last[b] = i;
      ids[cursor[b]++] = (int32_t)i;
    }
  }
}

// ---------------------------------------------------------------------------
// Probed-tile expansion for the serving engine.
//
// probed: (B, n_bkt) uint8 mask. tile_start/tiles_per_bucket: (n_bkt) int64.
// Pass 1 returns each query's tile count; pass 2 fills the (B, T) int32
// tile-index matrix (-1 padded).
// ---------------------------------------------------------------------------

void probe_tile_counts(const uint8_t* probed, int64_t B, int32_t n_bkt,
                       const int64_t* tiles_per_bucket,
                       int64_t* out_counts /* (B) */) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t q = 0; q < B; ++q) {
    const uint8_t* row = probed + q * n_bkt;
    int64_t c = 0;
    for (int32_t b = 0; b < n_bkt; ++b) {
      if (row[b]) c += tiles_per_bucket[b];
    }
    out_counts[q] = c;
  }
}

void probe_tile_fill(const uint8_t* probed, int64_t B, int32_t n_bkt,
                     const int64_t* tile_start, const int64_t* tiles_per_bucket,
                     int64_t T, int32_t* out /* (B, T) filled with -1 */) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t q = 0; q < B; ++q) {
    const uint8_t* row = probed + q * n_bkt;
    int32_t* dst = out + q * T;
    int64_t pos = 0;
    for (int32_t b = 0; b < n_bkt; ++b) {
      if (!row[b]) continue;
      int64_t s = tile_start[b], cnt = tiles_per_bucket[b];
      for (int64_t t = 0; t < cnt && pos < T; ++t) dst[pos++] = (int32_t)(s + t);
    }
  }
}

// ---------------------------------------------------------------------------
// xvecs parsing: strided (dim-header + payload) records → contiguous rows.
// ---------------------------------------------------------------------------

// fvecs/ivecs: 4-byte header + dim 4-byte elements per record.
void xvecs_strip_headers_f32(const float* raw, int64_t n, int32_t dim,
                             float* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * dim, raw + i * (dim + 1) + 1, dim * sizeof(float));
  }
}

// bvecs: 4-byte header + dim bytes; widen to float32.
void bvecs_to_f32(const uint8_t* raw, int64_t n, int32_t dim, float* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = raw + i * (dim + 4) + 4;
    float* dst = out + i * dim;
    for (int32_t j = 0; j < dim; ++j) dst[j] = (float)src[j];
  }
}

int lira_native_version() { return 1; }

}  // extern "C"
