"""Self-kNN cache contract: raw int32 `.bin` + human-readable `.meta` sidecar.
(own copy of lira_tpu/io/cache.py: a cache written by either package is read by the other)

Byte-compatible with the reference cache layout (reference:
compute_knn.cpp:262-290 writes, utils.py:238-272 reads) so indexes built by
either stack interoperate:

    {data_path}/{dataset}/knn_cache/
        {dataset}-data_self_knn{k}-n{n}.bin                 exact
        {dataset}-data_self_knn{k}-n{n}_ivf_nprobe{p}.bin   approximate
        *.bin.meta                                          provenance
"""

from __future__ import annotations

import glob
import os

import numpy as np


def knn_cache_dir(data_path: str, dataset: str) -> str:
    d = os.path.join(data_path, dataset, "knn_cache")
    os.makedirs(d, exist_ok=True)
    return d


def _metric_tag(metric: str | None) -> str:
    """Cache-name infix per metric: L2 keeps the reference's metric-less
    names (existing caches stay valid); other metrics are tagged so an
    inner_product pipeline can never silently train on L2 neighbors."""
    return "" if metric in (None, "L2") else "_ip" if metric == "inner_product" else f"_{metric}"


def cache_basename(
    dataset: str, k: int, n: int, nprobe: int | None = None, tag: str = "",
    metric: str | None = None,
) -> str:
    suffix = f"_ivf_nprobe{nprobe}" if nprobe else ""
    tag = f"-{tag}" if tag else ""
    return f"{dataset}-data_self_knn{k}-n{n}{tag}{_metric_tag(metric)}{suffix}.bin"


def find_knn_cache(
    data_path: str, dataset: str, k: int, n: int, tag: str = "",
    metric: str | None = None,
) -> str | None:
    """Locate an existing cache file, preferring approximate (any nprobe) then
    exact, newest first.  `tag` disambiguates caches over row *subsets*: the
    same (dataset, k, n) key can describe different subsets (different seed),
    so subset callers must pass a membership-identifying tag."""
    cache_dir = knn_cache_dir(data_path, dataset)
    t = f"-{tag}" if tag else ""
    m = _metric_tag(metric)
    patterns = [
        f"{dataset}-data_self_knn{k}-n{n}{t}{m}_ivf_nprobe*.bin",
        f"{dataset}-data_self_knn{k}-n{n}{t}{m}.bin",
    ]
    for pattern in patterns:
        matches = glob.glob(os.path.join(cache_dir, pattern))
        if matches:
            return max(matches, key=os.path.getctime)
    return None


def load_knn_cache(
    data_path: str, dataset: str, k: int, n: int, tag: str = "",
    metric: str | None = None,
) -> np.ndarray | None:
    """Load a cached (n, k) int32 self-kNN matrix, or None if absent."""
    path = find_knn_cache(data_path, dataset, k, n, tag=tag, metric=metric)
    if path is None:
        if tag:
            return None
        # legacy .npy cache
        npy = os.path.join(knn_cache_dir(data_path, dataset), f"{dataset}-data_self_knn{k}-n{n}.npy")
        if os.path.exists(npy):
            return np.load(npy).astype(np.int32)
        return None
    return np.fromfile(path, dtype=np.int32).reshape(n, k)


def save_knn_cache(
    data_path: str,
    dataset: str,
    knn: np.ndarray,
    *,
    dim: int,
    method: str,
    nprobe: int | None = None,
    n_clusters: int | None = None,
    timings: dict[str, float] | None = None,
    tag: str = "",
    metric: str | None = None,
) -> str:
    """Write the (n, k) int32 matrix plus a `.meta` provenance sidecar."""
    n, k = knn.shape
    cache_dir = knn_cache_dir(data_path, dataset)
    path = os.path.join(
        cache_dir, cache_basename(dataset, k, n, nprobe, tag=tag, metric=metric)
    )
    np.ascontiguousarray(knn, dtype=np.int32).tofile(path)

    lines = [
        f"dataset: {dataset}",
        f"n: {n}",
        f"dim: {dim}",
        f"k: {k}",
        f"method: {method}",
        f"metric: {metric or 'L2'}",
    ]
    if nprobe and n_clusters:
        lines += [
            f"n_clusters: {n_clusters}",
            f"nprobe: {nprobe}",
            f"probe_ratio: {100.0 * nprobe / n_clusters}%",
        ]
    for key, val in (timings or {}).items():
        lines.append(f"{key}: {val}s")
    with open(path + ".meta", "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def read_knn_meta(bin_path: str) -> dict[str, str]:
    """Parse a `.meta` sidecar into a dict."""
    meta: dict[str, str] = {}
    meta_path = bin_path + ".meta"
    if not os.path.exists(meta_path):
        return meta
    with open(meta_path) as f:
        for line in f:
            if ":" in line:
                key, val = line.split(":", 1)
                meta[key.strip()] = val.strip()
    return meta
