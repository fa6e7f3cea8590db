"""Diagnostics: long-tail kNN analysis and per-query nprobe study (own
copy of lira_tpu/diagnostics.py: numpy only, so the port carries it as it
is).

Capability parity with the reference's observe_knn_tail (utils.py:438-500)
and per_query (utils.py:502-519), vectorized.
"""

from __future__ import annotations

import os

import numpy as np


def observe_knn_tail(
    knn_distr_cnt: np.ndarray,  # (n_q, n_bkt) per-bucket gt-kNN counts
    outputs_data: np.ndarray,  # (n_d, n_bkt) model scores for base vectors
    dist_data_scaled: np.ndarray,  # (n_d, n_bkt) standardized centroid distances
    knn: np.ndarray,  # (n_q, k) gt neighbor ids
    data_2_bkt: np.ndarray,  # (n_d,) or (n_d, n_mul) assignment
    max_points: int | None = None,
) -> dict:
    """Long-tail study: for points that are a query's *only* kNN in some
    bucket, compare where the model ranks their replica buckets vs where
    plain centroid distance ranks them.

    Returns cumulative validity curves: fraction of tail points whose
    replica bucket appears within the first r ranks, for probing rank and
    distance rank.  The reference prints these as `output_rank_valid` /
    `dist_rank_valid`.
    """
    data_2_bkt = np.asarray(data_2_bkt)
    if data_2_bkt.ndim == 1:
        data_2_bkt = data_2_bkt[:, None]
    n_d, n_bkt = outputs_data.shape

    # tail points: gt neighbors sitting alone in a bucket for some query,
    # where that query also has buckets holding >1 neighbors (replica
    # targets).  Fully vectorized: one fancy-index pass over all (query,
    # neighbor) pairs instead of a Python double loop.
    n_q = len(knn_distr_cnt)
    lone = knn_distr_cnt == 1  # (n_q, n_bkt)
    rich = knn_distr_cnt > 1
    knn = np.asarray(knn)
    valid_knn = knn >= 0  # -1 padding must not wrap to the last corpus point
    nb = data_2_bkt[np.where(valid_knn, knn, 0)]  # (n_q, k, n_mul)
    safe = np.where(nb >= 0, nb, 0)
    lone_nb = lone[np.arange(n_q)[:, None, None], safe] & (nb >= 0)
    is_tail = lone_nb.any(axis=2) & rich.any(axis=1)[:, None] & valid_knn
    tail_replicas = np.zeros((n_d, n_bkt), dtype=bool)
    qs, js = np.nonzero(is_tail)
    np.logical_or.at(tail_replicas, knn[qs, js], rich[qs])

    tail_ids = np.where(tail_replicas.any(axis=1))[0]
    if max_points is not None:  # 0 means 'no tail points', not 'unbounded'
        tail_ids = tail_ids[:max_points]
    n_tail = len(tail_ids)
    if n_tail == 0:
        return {"tail_ids": tail_ids, "output_rank_valid": np.zeros(n_bkt), "dist_rank_valid": np.zeros(n_bkt)}

    # rank of each replica bucket under model score (desc) and distance (asc)
    out_rank = np.argsort(np.argsort(-outputs_data[tail_ids], axis=1, kind="stable"), axis=1)
    dist_rank = np.argsort(np.argsort(dist_data_scaled[tail_ids], axis=1, kind="stable"), axis=1)
    rep = tail_replicas[tail_ids]

    def cum_valid(rank):
        # hit[r] = point has a replica bucket at rank r; cumulative any
        hit = np.zeros((n_tail, n_bkt), dtype=bool)
        rows, cols = np.nonzero(rep)
        hit[rows, rank[rows, cols]] = True
        return np.maximum.accumulate(hit, axis=1).sum(axis=0) / n_tail

    return {
        "tail_ids": tail_ids,
        "output_rank_valid": cum_valid(out_rank),
        "dist_rank_valid": cum_valid(dist_rank),
    }


def per_query_nprobe(
    outputs: np.ndarray,  # (n_q, n_bkt) model scores for queries
    knn_distr_cnt: np.ndarray,  # (n_q, n_bkt) gt-kNN counts per bucket
    cluster_cnts: np.ndarray,  # (n_bkt,) bucket sizes
    k: int,
    recall_target: float = 0.98,
    n_queries: int = 100,
    max_probe: int = 20,
    csv_path: str | None = None,
) -> np.ndarray:
    """Smallest top-M probe count reaching the recall target per query,
    with the matching ndis cost.  Returns (n_queries, 3): [q_id, nprobe, cmp].

    Deviations from the reference (utils.py:502-519), both deliberate: its
    `range(1, 20)` never tests M == max_probe, and a query that misses the
    target reports nprobe=0/cmp=0 — deflating the mean with zeros for
    exactly the hardest queries.  Here M == max_probe is tested, and a
    query that still misses reports the full (max_probe, cmp-at-max)."""
    n_q = min(n_queries, len(outputs))
    order = np.argsort(-outputs[:n_q], axis=1, kind="stable")  # score-desc bucket ranking
    rows = []
    for q in range(n_q):
        nprobe = max_probe
        cmp = int(cluster_cnts[order[q, :max_probe]].sum())
        for m in range(1, max_probe + 1):
            buckets = order[q, :m]
            got = knn_distr_cnt[q, buckets].sum() / k
            if got >= recall_target:
                nprobe = m
                cmp = int(cluster_cnts[buckets].sum())
                break
        rows.append((q, nprobe, cmp))
    result = np.array(rows, dtype=np.int64)
    if csv_path:
        os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
        with open(csv_path, "w") as f:
            f.write("q_id,nprobe,cmp\n")
            for q, np_, c in rows:
                f.write(f"{q},{np_},{c}\n")
    return result
