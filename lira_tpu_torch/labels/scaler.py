"""Per-feature standardizer for the centroid-distance features (port of
lira_tpu/labels/scaler.py).

Biased (ddof=0) variance, zero-variance features get scale 1, streaming
partial_fit, and the mean/scale vectors persist as `.npy` artifacts.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..ops.distance import l2_to_centroids


class StandardScaler:
    """(x - mean) / scale with scale = sqrt(biased var); zero-var → scale 1."""

    def __init__(self):
        self.mean_: np.ndarray | None = None
        self.scale_: np.ndarray | None = None
        self._count = 0
        self._sum: np.ndarray | None = None
        self._sumsq: np.ndarray | None = None

    def partial_fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, dtype=np.float64)
        if self._sum is None:
            self._sum = x.sum(axis=0)
            self._sumsq = (x * x).sum(axis=0)
        else:
            self._sum += x.sum(axis=0)
            self._sumsq += (x * x).sum(axis=0)
        self._count += len(x)
        mean = self._sum / self._count
        var = np.maximum(self._sumsq / self._count - mean * mean, 0.0)
        scale = np.sqrt(var)
        scale[scale < 10 * np.finfo(np.float64).eps] = 1.0
        self.mean_ = mean.astype(np.float32)
        self.scale_ = scale.astype(np.float32)
        return self

    def fit(self, x: np.ndarray) -> "StandardScaler":
        self._count = 0
        self._sum = None
        self._sumsq = None
        return self.partial_fit(x)

    def transform(self, x: np.ndarray) -> np.ndarray:
        if self.mean_ is None:
            raise RuntimeError("Scaler not fitted")
        return ((np.asarray(x, dtype=np.float32) - self.mean_) / self.scale_).astype(np.float32)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def save(self, out_dir: str, prefix: str) -> tuple[str, str]:
        """Persist {prefix}_scaler_mean.npy / _scaler_scale.npy."""
        os.makedirs(out_dir, exist_ok=True)
        mean_path = os.path.join(out_dir, f"{prefix}_scaler_mean.npy")
        scale_path = os.path.join(out_dir, f"{prefix}_scaler_scale.npy")
        np.save(mean_path, self.mean_.astype(np.float32))
        np.save(scale_path, self.scale_.astype(np.float32))
        return mean_path, scale_path

    @classmethod
    def load(cls, out_dir: str, prefix: str) -> "StandardScaler":
        sc = cls()
        sc.mean_ = np.load(os.path.join(out_dir, f"{prefix}_scaler_mean.npy"))
        sc.scale_ = np.load(os.path.join(out_dir, f"{prefix}_scaler_scale.npy"))
        return sc


def scaled_centroid_distances(
    x_d: np.ndarray,
    x_q: np.ndarray | None,
    centroids: np.ndarray,
    chunk_rows: int = 65536,
    scaler: StandardScaler | None = None,
    device=None,
) -> tuple[torch.Tensor, np.ndarray | None, StandardScaler]:
    """Sqrt-L2 distances to all centroids, standardized on the data
    distribution.  The (n, n_bkt) feature matrix stays on the device: the
    corpus streams through in chunks, and when no `scaler` is given the
    moments accumulate on the device with a shifted-sum formulation (the
    first chunk's mean as the shift, so f32 sums lose no variance
    precision); only two (n_bkt,) vectors leave it.  This is lira_tpu's
    device-resident branch: the same moments and the same zero-variance
    rule (scale < 1e-12 → 1).

    Returns (standardized features on the device, standardized query
    features as a host array or None, the scaler)."""
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    n = len(x_d)
    dist = torch.empty((n, c.shape[0]), dtype=torch.float32, device=dev)
    fit_scaler = scaler is None
    shift = s1 = s2 = None
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        d_chunk = l2_to_centroids(
            torch.as_tensor(np.ascontiguousarray(x_d[s:e], np.float32), device=dev), c
        )
        if fit_scaler:
            if shift is None:
                shift = d_chunk.mean(dim=0)
                s1 = torch.zeros_like(shift)
                s2 = torch.zeros_like(shift)
            dc = d_chunk - shift
            s1 += dc.sum(dim=0)
            s2 += (dc * dc).sum(dim=0)
        dist[s:e] = d_chunk
    if fit_scaler:
        sh = shift.double().cpu().numpy()
        m1 = s1.double().cpu().numpy() / n
        var = np.maximum(s2.double().cpu().numpy() / n - m1 * m1, 0.0)
        scaler = StandardScaler()
        scaler.mean_ = (sh + m1).astype(np.float32)
        scale = np.sqrt(var)
        scale[scale < 1e-12] = 1.0
        scaler.scale_ = scale.astype(np.float32)
        scaler._count = n
    mean = torch.as_tensor(scaler.mean_, device=dev)
    sc = torch.as_tensor(scaler.scale_, device=dev)
    dist.sub_(mean).div_(sc)  # in place: no second (n, n_bkt) buffer
    dist_q = None
    if x_q is not None:
        dq = l2_to_centroids(torch.as_tensor(np.asarray(x_q, np.float32), device=dev), c)
        dist_q = scaler.transform(dq.cpu().numpy())
    return dist, dist_q, scaler
