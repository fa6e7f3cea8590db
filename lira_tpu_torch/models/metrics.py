"""Probing-quality metrics for the per-epoch evaluation table.
(own copy of lira_tpu/models/metrics.py: numpy only)

Capability parity with the reference's cal_metrics (LIRA_smallscale.py:99-142):
accuracy, hit rate (TP/(TP+FN) nan-mean), predicted/target mean nprobe,
label recall, and mean probed computations (ndis).  Note: the reference
initializes knn_computations to zeros and never fills it — we compute the
intended value (Σ cluster sizes over predicted buckets).
"""

from __future__ import annotations

import numpy as np

from ..labels.distr import label_recall


def probing_metrics(
    predicts: np.ndarray,  # (n_q, n_bkt) bool
    targets: np.ndarray,  # (n_q, n_bkt) 0/1
    gt_buckets: np.ndarray,  # (n_q, k, n_mul) from gt_bucket_map
    cluster_cnts: np.ndarray | None,  # (n_bkt,) true bucket sizes, or None
    k: int,
    epoch: int | None = None,
    loss: float | None = None,
) -> dict:
    predicts = np.asarray(predicts, dtype=bool)
    targets = np.asarray(targets, dtype=bool)

    nprobe_predict = float(predicts.sum(axis=1).mean())
    nprobe_target = float(targets.sum(axis=1).mean())
    accuracy = float((predicts == targets).mean())

    tgt_per_row = targets.sum(axis=1).astype(np.float64)
    tp = (predicts & targets).sum(axis=1).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        hit = np.where(tgt_per_row > 0, tp / tgt_per_row, np.nan)
    hit_rate = float(np.nanmean(hit)) if np.isfinite(np.nanmean(hit)) else 0.0

    recall = float(label_recall(predicts, gt_buckets, k).mean())

    cmp_mean = 0.0
    if cluster_cnts is not None:
        cmp_mean = float((predicts @ np.asarray(cluster_cnts, dtype=np.float64)).mean())

    return {
        "Epoch": epoch,
        "Loss": loss,
        "Accuracy": round(accuracy, 4),
        "Hit Rate": round(hit_rate, 4),
        "nprobe predict": round(nprobe_predict, 4),
        "nprobe target": round(nprobe_target, 4),
        "KNN Recall": round(recall, 4),
        "KNN Computations": round(cmp_mean, 4),
    }
