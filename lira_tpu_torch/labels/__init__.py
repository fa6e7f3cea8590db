from .scaler import StandardScaler, scaled_centroid_distances

__all__ = ["StandardScaler", "scaled_centroid_distances"]
