"""Pairwise distances as one matmul plus rank-1 norm corrections (port of
lira_tpu/ops/distance.py):

    ‖q − b‖² = ‖q‖² − 2 q·b + ‖b‖²

All scores are "smaller is better": squared L2 for the L2 metric, −⟨q,b⟩
for inner product.  f32 throughout, TF32 off (`lira_tpu_torch.true_fp32`:
the reference is precision="highest").
"""

from __future__ import annotations

import numpy as np
import torch

from .. import true_fp32


@true_fp32()
def pairwise_scores(q: torch.Tensor, b: torch.Tensor, metric: str = "L2") -> torch.Tensor:
    """(n_q, d) × (n_b, d) → (n_q, n_b) ranking scores (smaller = closer).

    L2 scores omit the per-query ‖q‖² term (constant per row); use
    `scores_to_distances` to recover true squared distances."""
    dot = q.float() @ b.float().T
    if metric == "inner_product":
        return -dot
    bf = b.float()
    b_sq = (bf * bf).sum(dim=1)
    return b_sq[None, :] - 2.0 * dot


def scores_to_distances(scores: torch.Tensor, q: torch.Tensor, metric: str = "L2") -> torch.Tensor:
    """Convert ranking scores back to true squared L2 (or −IP) values."""
    if metric == "inner_product":
        return scores
    qf = q.float()
    return scores + (qf * qf).sum(dim=1)[:, None]


def l2_to_centroids(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Euclidean (sqrt) distance from each row of x to every centroid — the
    probing model's distance features."""
    s = pairwise_scores(x, centroids, metric="L2")
    d2 = scores_to_distances(s, x, metric="L2")
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def row_sqnorms(x: np.ndarray, chunk: int = 1 << 20) -> np.ndarray:
    """Host-side f32 row squared norms, accumulated in f64 per chunk."""
    n = x.shape[0]
    out = np.empty(n, np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        blk = x[s:e]
        out[s:e] = np.einsum("ij,ij->i", blk, blk, dtype=np.float64).astype(np.float32)
    return out
