from .assign import BucketLayout, build_bucket_layout
from .kmeans import KMeans, kmeans_assign, kmeans_fit
from .order import centroid_tour_rank

__all__ = [
    "KMeans", "kmeans_fit", "kmeans_assign", "BucketLayout", "build_bucket_layout",
    "centroid_tour_rank",
]
