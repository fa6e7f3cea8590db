from .distr import gt_bucket_map, knn_bucket_counts, knn_bucket_labels, label_recall
from .scaler import StandardScaler, scaled_centroid_distances

__all__ = [
    "StandardScaler",
    "scaled_centroid_distances",
    "knn_bucket_labels",
    "knn_bucket_counts",
    "gt_bucket_map",
    "label_recall",
]
