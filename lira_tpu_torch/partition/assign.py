"""Ragged bucket layout: CSR inverted lists + padded 128-row tiles (port of
lira_tpu/partition/assign.py).

  * CSR (`offsets`, `ids`): sorted + deduplicated per bucket.
  * Padded tile layout (`padded_offsets`, `padded_ids`): every bucket padded
    to a multiple of `tile` rows so scan kernels index whole tiles; padding
    slots hold id -1.  True (unpadded) sizes keep ndis accounting exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BucketLayout:
    n_bkt: int
    offsets: np.ndarray  # (n_bkt+1,) int64 CSR offsets into ids
    ids: np.ndarray  # (total,) int32 global ids, sorted+unique per bucket
    padded_offsets: np.ndarray  # (n_bkt+1,) int64 offsets into padded_ids
    padded_ids: np.ndarray  # (padded_total,) int32, -1 = padding
    tile: int

    @property
    def sizes(self) -> np.ndarray:
        """True bucket sizes — the ndis contribution of probing each bucket."""
        return np.diff(self.offsets).astype(np.int64)

    @property
    def padded_sizes(self) -> np.ndarray:
        return np.diff(self.padded_offsets).astype(np.int64)

    @property
    def total(self) -> int:
        return int(self.offsets[-1])

    def bucket_members(self, b: int) -> np.ndarray:
        return self.ids[self.offsets[b] : self.offsets[b + 1]]

    def gather_vectors(self, x: np.ndarray, pad_value: float = 0.0) -> np.ndarray:
        """Materialize the padded, bucket-contiguous vector table (padded_total, dim)."""
        out = np.full((len(self.padded_ids), x.shape[1]), pad_value, dtype=np.float32)
        valid = self.padded_ids >= 0
        out[valid] = x[self.padded_ids[valid]]
        return out


def build_bucket_layout(data_2_bkt: np.ndarray, n_bkt: int, tile: int = 128,
                        use_native: bool = True) -> BucketLayout:
    """Build CSR + padded inverted lists from a (n, n_mul) assignment matrix.

    Slots holding -1 are empty.  Per bucket, member ids are sorted ascending
    and deduplicated (a point replicated into its own native bucket counts
    once).  Uses the native O(n) counting-sort builder (lira_tpu_torch/
    native) when it is available, else a numpy argsort formulation; both
    give the same layout."""
    data_2_bkt = np.asarray(data_2_bkt)
    if data_2_bkt.ndim == 1:
        data_2_bkt = data_2_bkt[:, None]
    n, n_mul = data_2_bkt.shape

    from .. import native

    if use_native and native.available():
        offsets, flat_id = native.build_csr(data_2_bkt, n_bkt)
        flat_id = flat_id.astype(np.int64)
        flat_bkt = np.repeat(np.arange(n_bkt, dtype=np.int64), np.diff(offsets))
    else:
        flat_bkt = data_2_bkt.reshape(-1).astype(np.int64)
        flat_id = np.repeat(np.arange(n, dtype=np.int64), n_mul)
        valid = flat_bkt >= 0
        flat_bkt, flat_id = flat_bkt[valid], flat_id[valid]

        # sort by (bucket, id) then drop duplicate (bucket, id) pairs
        key = flat_bkt * (n + 1) + flat_id
        order = np.argsort(key, kind="stable")
        flat_bkt, flat_id = flat_bkt[order], flat_id[order]
        keep = np.ones(len(flat_bkt), dtype=bool)
        if len(flat_bkt) > 1:
            keep[1:] = np.diff(key[order]) != 0
        flat_bkt, flat_id = flat_bkt[keep], flat_id[keep]

        counts = np.bincount(flat_bkt, minlength=n_bkt).astype(np.int64)
        offsets = np.zeros(n_bkt + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
    counts = np.diff(offsets)

    padded_counts = ((counts + tile - 1) // tile) * tile
    padded_offsets = np.zeros(n_bkt + 1, dtype=np.int64)
    np.cumsum(padded_counts, out=padded_offsets[1:])
    padded_ids = np.full(int(padded_offsets[-1]), -1, dtype=np.int32)
    within = np.arange(len(flat_id), dtype=np.int64) - offsets[flat_bkt]
    padded_ids[padded_offsets[flat_bkt] + within] = flat_id

    return BucketLayout(
        n_bkt=n_bkt,
        offsets=offsets,
        ids=flat_id.astype(np.int32),
        padded_offsets=padded_offsets,
        padded_ids=padded_ids,
        tile=tile,
    )
