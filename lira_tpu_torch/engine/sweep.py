"""One-pass threshold sweep: recall / nprobe / ndis curves.
(own copy of lira_tpu/engine/sweep.py: numpy only, the same CSV schema)

The reference rescans result sets per threshold (reference:
LIRA_smallscale.py:176-241, query_tuning).  Here the corpus is scanned once
(scan.py), ground-truth hits are compressed into a dense (n_q, k, n_mul)
bit tensor, and every threshold's metrics are masked reductions — same
numbers, one pass.

Threshold semantics match the reference Python path: a bucket is probed
when score > threshold (strict), no fallback.  The serving engine uses the
C++ engine's `score ≥ threshold` with argmax fallback (serve.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class SweepRow:
    threshold: float
    nprobe: float
    recall: float
    computations: float
    qps: float = 0.0


def gt_hit_tensor(
    found: np.ndarray,  # (n_q, n_bkt, k) from bucket_topk
    gt_ids: np.ndarray,  # (n_q, k) ground-truth neighbor ids
    gt_buckets: np.ndarray,  # (n_q, k, n_mul) from gt_bucket_map
) -> np.ndarray:
    """(n_q, k, n_mul) bool — gt neighbor j is inside the per-bucket top-k
    of its m-th home bucket for query q."""
    n_q, k = gt_ids.shape
    valid = gt_buckets >= 0
    safe = np.where(valid, gt_buckets, 0)
    rows = np.arange(n_q)[:, None, None]
    per_bucket = found[rows, safe]  # (n_q, k, n_mul, k_found)
    hit = (per_bucket == gt_ids[:, :, None, None]).any(axis=-1)
    return hit & valid


def threshold_sweep(
    outputs: np.ndarray,  # (n_q, n_bkt) probing probabilities
    gt_buckets: np.ndarray,  # (n_q, k, n_mul)
    hit: np.ndarray,  # (n_q, k, n_mul) from gt_hit_tensor
    sizes: np.ndarray,  # (n_bkt,) true bucket sizes
    k: int,
    thresholds: np.ndarray | None = None,
    qps_fn=None,  # optional: threshold -> measured QPS
) -> list[SweepRow]:
    if thresholds is None:
        thresholds = np.arange(0.02, 0.82, 0.02)
    outputs = np.asarray(outputs)
    sizes = np.asarray(sizes, dtype=np.float64)
    n_q = outputs.shape[0]
    valid = gt_buckets >= 0
    safe = np.where(valid, gt_buckets, 0)
    rows_idx = np.arange(n_q)[:, None, None]

    rows = []
    for thr in thresholds:
        probed = outputs > thr  # (n_q, n_bkt)
        nprobe = probed.sum(axis=1)
        cmp = probed @ sizes
        probed_at_gt = probed[rows_idx, safe] & valid  # (n_q, k, n_mul)
        covered = (probed_at_gt & hit).any(axis=2)  # (n_q, k)
        recall = covered.sum(axis=1) / float(k)
        rows.append(
            SweepRow(
                threshold=float(thr),
                nprobe=float(nprobe.mean()),
                recall=float(recall.mean()),
                computations=float(cmp.mean()),
                qps=float(qps_fn(thr)) if qps_fn else 0.0,
            )
        )
    return rows


def sweep_to_csv(rows: list[SweepRow], path: str) -> None:
    """Write the reference CSV schema: threshold,nprobe,Recall,Computations,QPS."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("threshold,nprobe,Recall,Computations,QPS\n")
        for r in rows:
            f.write(f"{r.threshold},{r.nprobe},{r.recall},{r.computations},{r.qps}\n")
