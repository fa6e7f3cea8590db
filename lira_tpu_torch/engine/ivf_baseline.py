"""Classic IVF baseline: probe the nprobe nearest centroids (port of
lira_tpu/engine/ivf_baseline.py).

The comparison target of the LIRA paper (probe by centroid distance
instead of by the learned model).  It reuses the same partition layout and
scan machinery, so recall-vs-nprobe/ndis curves compare like with like:
`QueryEngine(prober=lambda q: ivf_probe_matrix(q, centroids))` serves it
through any scan path.  Both functions take the distances on `device`
(cuda unless the caller passes device="cpu"); the ranks are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.distance import pairwise_scores


def ivf_probe_matrix(x_q: np.ndarray, centroids: np.ndarray, device=None) -> np.ndarray:
    """(n_q, n_bkt) pseudo-scores: higher = closer centroid, so the same
    top-M / threshold machinery as the learned prober applies.

    Scores are centroid-distance ranks mapped to (0, 1]: probing at
    threshold 1 − (m − 0.5)/n_bkt probes exactly the m nearest centroids."""
    device = resolve_device(device)
    s = pairwise_scores(
        torch.tensor(np.asarray(x_q, np.float32), device=device),
        torch.tensor(np.asarray(centroids, np.float32), device=device),
    ).cpu().numpy()
    rank = np.argsort(np.argsort(s, axis=1, kind="stable"), axis=1)
    n_bkt = s.shape[1]
    return 1.0 - rank.astype(np.float32) / n_bkt  # nearest centroid -> 1.0


def ivf_sweep(
    x_q: np.ndarray,
    centroids: np.ndarray,
    gt_buckets: np.ndarray,  # (n_q, k, n_mul)
    hit: np.ndarray,  # (n_q, k, n_mul) gt_hit_tensor on the same layout
    sizes: np.ndarray,
    k: int,
    nprobes: list[int] | None = None,
    device=None,
) -> list[dict]:
    """Recall / ndis at fixed nprobe values — the IVF recall-vs-nprobe curve."""
    nprobes = nprobes or [1, 2, 4, 8, 16, 32, 64]
    n_bkt = centroids.shape[0]
    scores = ivf_probe_matrix(x_q, centroids, device)
    order = np.argsort(-scores, axis=1, kind="stable")
    n_q = len(x_q)
    valid = gt_buckets >= 0
    safe = np.where(valid, gt_buckets, 0)
    rows_idx = np.arange(n_q)[:, None, None]
    out = []
    for m in nprobes:
        m = min(m, n_bkt)
        probed = np.zeros((n_q, n_bkt), dtype=bool)
        probed[np.arange(n_q)[:, None], order[:, :m]] = True
        probed_at_gt = probed[rows_idx, safe] & valid
        covered = (probed_at_gt & hit).any(axis=2)
        out.append(
            {
                "nprobe": m,
                "recall": float(covered.sum(axis=1).mean() / k),
                "computations": float((probed @ sizes.astype(np.float64)).mean()),
            }
        )
    return out
