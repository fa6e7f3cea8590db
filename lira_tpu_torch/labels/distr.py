"""kNN→bucket multi-label construction, fully vectorized.
(own copy of lira_tpu/labels/distr.py: numpy only, byte-identical output)

The probing model's targets: labels[i, b] = 1 iff at least one of point i's
k nearest neighbors lives in bucket b (under the current, possibly
redundant, assignment).  Capability parity with the reference's per-row
Python loops (reference: utils.py:332-405 — get_knn_distr,
get_knn_distr_redundancy, get_knn_labels_data_only) as scatter-adds.

Redundant assignments use −1 for empty slots; those are masked out.  A
neighbor replicated into several buckets lights up every one of them —
identical semantics to the reference's flattened data_2_bkt lookup.
"""

from __future__ import annotations

import numpy as np


def _flatten_valid(knn: np.ndarray, data_2_bkt: np.ndarray):
    """rows, buckets for every (query, neighbor, replica-slot) with a real bucket."""
    knn = np.asarray(knn)
    data_2_bkt = np.asarray(data_2_bkt)
    if data_2_bkt.ndim == 1:
        data_2_bkt = data_2_bkt[:, None]
    n, k = knn.shape
    n_mul = data_2_bkt.shape[1]
    # mask -1 neighbor ids (knn_fused pads with -1 when k exceeds the real
    # candidates) BEFORE the lookup — fancy-indexing with -1 would silently
    # read the LAST corpus point's buckets
    flat_knn = knn.reshape(-1).astype(np.int64)
    ok = flat_knn >= 0
    bkts = data_2_bkt[np.where(ok, flat_knn, 0)]  # (n*k, n_mul)
    bkts = np.where(ok[:, None], bkts, -1).reshape(n, k * n_mul)
    rows = np.repeat(np.arange(n, dtype=np.int64), k * n_mul)
    flat = bkts.reshape(-1).astype(np.int64)
    valid = flat >= 0
    return rows[valid], flat[valid]


def knn_bucket_labels(knn: np.ndarray, data_2_bkt: np.ndarray, n_bkt: int) -> np.ndarray:
    """(n, n_bkt) uint8 0/1 — bucket holds ≥1 of the row's kNN."""
    n = knn.shape[0]
    rows, bkts = _flatten_valid(knn, data_2_bkt)
    labels = np.zeros((n, n_bkt), dtype=np.uint8)
    labels[rows, bkts] = 1
    return labels


def knn_bucket_counts(knn: np.ndarray, data_2_bkt: np.ndarray, n_bkt: int) -> np.ndarray:
    """(n, n_bkt) int32 — how many of the row's kNN (replica-slot occurrences
    counted once per distinct bucket membership) fall in each bucket.

    Matches the reference's count semantics: each (neighbor, valid slot)
    contributes 1 to that slot's bucket.
    """
    n = knn.shape[0]
    rows, bkts = _flatten_valid(knn, data_2_bkt)
    counts = np.zeros((n, n_bkt), dtype=np.int32)
    np.add.at(counts, (rows, bkts), 1)
    return counts


def gt_bucket_map(knn: np.ndarray, data_2_bkt: np.ndarray) -> np.ndarray:
    """(n_q, k, n_mul) int32 — the buckets each ground-truth neighbor lives in
    (−1 for empty replica slots).

    This replaces the reference's per-(query, bucket) object-array id lists
    (utils.py:339-379): every downstream consumer (label recall, threshold
    sweep) is a reduction over this dense tensor.
    """
    data_2_bkt = np.asarray(data_2_bkt)
    if data_2_bkt.ndim == 1:
        data_2_bkt = data_2_bkt[:, None]
    knn = np.asarray(knn)
    ok = knn >= 0  # -1 neighbor padding must not wrap to the last point
    out = data_2_bkt[np.where(ok, knn, 0)].astype(np.int32)
    return np.where(ok[..., None], out, -1)


def label_recall(predicts: np.ndarray, gt_buckets: np.ndarray, k: int) -> np.ndarray:
    """Per-query label recall: fraction of the k gt neighbors that live in at
    least one predicted bucket.  (reference: cal_metrics,
    LIRA_smallscale.py:110-122.)

    predicts: (n_q, n_bkt) bool — probed buckets.
    gt_buckets: (n_q, k, n_mul) from gt_bucket_map.
    """
    n_q = predicts.shape[0]
    valid = gt_buckets >= 0
    safe = np.where(valid, gt_buckets, 0)
    probed = np.take_along_axis(
        predicts.astype(bool), safe.reshape(n_q, -1), axis=1
    ).reshape(gt_buckets.shape)
    covered = (probed & valid).any(axis=2)  # (n_q, k)
    return covered.sum(axis=1) / float(k)
