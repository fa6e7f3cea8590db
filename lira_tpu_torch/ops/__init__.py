from .distance import l2_to_centroids, pairwise_scores, row_sqnorms, scores_to_distances
from .knn import drop_self, exact_knn, exact_knn_stream, self_knn
from .knn_pallas import knn_fused, self_knn_fused
from .topk import top_k

__all__ = [
    "pairwise_scores",
    "l2_to_centroids",
    "scores_to_distances",
    "row_sqnorms",
    "top_k",
    "exact_knn",
    "exact_knn_stream",
    "self_knn",
    "drop_self",
    "knn_fused",
    "self_knn_fused",
]
