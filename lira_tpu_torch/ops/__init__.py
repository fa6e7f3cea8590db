from .distance import l2_to_centroids, pairwise_scores, row_sqnorms, scores_to_distances
from .topk import top_k

__all__ = [
    "pairwise_scores",
    "l2_to_centroids",
    "scores_to_distances",
    "row_sqnorms",
    "top_k",
]
