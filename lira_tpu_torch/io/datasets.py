"""Dataset loading and synthetic dataset generation (port of
lira_tpu/io/datasets.py).

Directory contract:
    {data_path}/{name}/{name}_base.fvecs      (or {name}_learn.fvecs)
    {data_path}/{name}/{name}_query.fvecs
    {data_path}/{name}/{name}_groundtruth.ivecs   (optional)

`synthetic_dataset` draws from `np.random.default_rng` in exactly the order
lira_tpu does, so one seed gives byte-identical corpora in both packages.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .xvecs import read_xvecs, write_xvecs

# rows of ambient noise drawn at a time: numpy's normal draws element by
# element from the generator's stream, so chunked draws give the same bytes
# as one (n, dim) draw, without its float64 temporary (51 GB at 50M x 128)
_NOISE_CHUNK = 1 << 20

# The calibrated hard-regime generator settings (at 1M x 128 / 1024
# partitions, IVF needs nprobe ~ 12/24/32 for recall 0.90/0.95/0.98).
# Must stay equal to lira_tpu's HARD_REGIME: the corpus signature of every
# measurement is derived from it.
HARD_REGIME = dict(
    n_clusters=64, seed=43, intrinsic_dim=16, center_scale=1.0,
    noise_scale=1.0, query_noise=0.35, ambient_noise=0.02,
)


def hard_regime_sig() -> str:
    """Deterministic signature of HARD_REGIME for cache keys/sidecars."""
    return "_".join(f"{k}={HARD_REGIME[k]}" for k in sorted(HARD_REGIME))


def check_sig_sidecar(path: str, sig: str) -> bool:
    """True iff `path`'s generator-signature sidecar (`<path>.sig`) holds
    `sig`, or there is no sidecar (caches written before sidecars existed
    were made with the current parameters).  The same file and rule as
    lira_tpu's, so either package reads the other's caches."""
    side = path + ".sig"
    if not os.path.exists(side):
        return True
    with open(side) as f:
        return f.read().strip() == sig


def write_sig_sidecar(path: str, sig: str) -> None:
    """Write `<path>.sig` atomically (a temp file, then `os.replace`)."""
    tmp = path + ".sig.tmp"
    with open(tmp, "w") as f:
        f.write(sig + "\n")
    os.replace(tmp, path + ".sig")


@dataclass
class DatasetBundle:
    name: str
    base: np.ndarray  # (n_d, dim) float32
    query: np.ndarray  # (n_q, dim) float32
    groundtruth: np.ndarray | None  # (n_q, k_gt) int32 or None


def _read_vectors(dataset_dir: str, name: str, kinds: tuple[str, ...]) -> np.ndarray | None:
    """Load the first existing {name}_{kind}.{fvecs,bvecs} as float32 (bvecs
    widen through the native parser when it is built — BIGANN-style
    datasets ship uint8)."""
    from .. import native

    for kind in kinds:
        for ext in ("fvecs", "bvecs"):
            path = os.path.join(dataset_dir, f"{name}_{kind}.{ext}")
            if not os.path.exists(path):
                continue
            if ext == "bvecs" and native.available():
                raw = np.fromfile(path, dtype=np.uint8)
                dim = int(raw[:4].view(np.int32)[0])
                return native.bvecs_rows(raw, raw.size // (dim + 4), dim)
            return np.ascontiguousarray(read_xvecs(path), dtype=np.float32)
    return None


def load_data(dataset_name: str, data_path: str = "/data/vector_datasets") -> DatasetBundle:
    """Load a dataset in the standard xvecs directory layout."""
    dataset_dir = os.path.join(data_path, dataset_name)
    x_d = _read_vectors(dataset_dir, dataset_name, ("base", "learn"))
    if x_d is None:
        raise FileNotFoundError(f"no base/learn vectors for {dataset_name} in {dataset_dir}")
    x_q = _read_vectors(dataset_dir, dataset_name, ("query",))
    if x_q is None:
        raise FileNotFoundError(f"no query vectors for {dataset_name} in {dataset_dir}")
    gt_file = os.path.join(dataset_dir, f"{dataset_name}_groundtruth.ivecs")
    gt_ids = None
    if os.path.exists(gt_file):
        gt_ids = np.ascontiguousarray(read_xvecs(gt_file), dtype=np.int32)
    return DatasetBundle(name=dataset_name, base=x_d, query=x_q, groundtruth=gt_ids)


def _exact_knn_numpy(base: np.ndarray, query: np.ndarray, k: int, metric: str = "L2") -> np.ndarray:
    """Small exact kNN oracle (numpy, chunked, f64) for synthetic ground truth."""
    n_q = query.shape[0]
    out = np.empty((n_q, k), dtype=np.int32)
    b_sq = (base.astype(np.float64) ** 2).sum(axis=1)
    chunk = 1024
    for s in range(0, n_q, chunk):
        q = query[s : s + chunk].astype(np.float64)
        if metric == "inner_product":
            score = -(q @ base.T.astype(np.float64))
        else:
            score = b_sq[None, :] - 2.0 * (q @ base.T.astype(np.float64))
        idx = np.argpartition(score, k - 1, axis=1)[:, :k]
        ord_ = np.argsort(np.take_along_axis(score, idx, axis=1), axis=1, kind="stable")
        out[s : s + chunk] = np.take_along_axis(idx, ord_, axis=1)
    return out


def synthetic_dataset(
    n_base: int = 20000,
    n_query: int = 200,
    dim: int = 32,
    n_clusters: int = 32,
    k_gt: int = 100,
    seed: int = 43,
    metric: str = "L2",
    name: str = "synthetic",
    compute_gt: bool = True,
    center_scale: float = 4.0,
    noise_scale: float = 1.0,
    query_noise: float = 0.5,
    intrinsic_dim: int | None = None,
    ambient_noise: float = 0.0,
) -> DatasetBundle:
    """Gaussian-mixture corpus with queries perturbed from base points.

    `intrinsic_dim` generates the mixture in a low-dimensional latent space
    and embeds it in `dim` through a fixed random orthonormal map, plus
    optional isotropic `ambient_noise` (the hard regime: kNN straddle many
    K-Means cells, so recall needs nprobe >> 1)."""
    rng = np.random.default_rng(seed)
    d_gen = dim if intrinsic_dim is None else int(intrinsic_dim)
    centers = rng.normal(scale=center_scale, size=(n_clusters, d_gen)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n_base)
    base = centers[assign] + rng.normal(scale=noise_scale, size=(n_base, d_gen)).astype(
        np.float32
    )
    q_src = rng.integers(0, n_base, size=n_query)
    query = base[q_src] + rng.normal(scale=query_noise, size=(n_query, d_gen)).astype(
        np.float32
    )
    if intrinsic_dim is not None:
        if d_gen != dim:
            proj, _ = np.linalg.qr(rng.normal(size=(dim, d_gen)))
            proj = proj.astype(np.float32)
            base = base @ proj.T
            query = query @ proj.T
        if ambient_noise > 0.0:
            for s in range(0, n_base, _NOISE_CHUNK):
                e = min(s + _NOISE_CHUNK, n_base)
                base[s:e] += rng.normal(scale=ambient_noise, size=(e - s, dim)).astype(
                    np.float32)
            query += rng.normal(scale=ambient_noise, size=(n_query, dim)).astype(np.float32)
    base = np.ascontiguousarray(base, dtype=np.float32)
    query = np.ascontiguousarray(query, dtype=np.float32)
    gt = _exact_knn_numpy(base, query, k_gt, metric=metric) if compute_gt else None
    return DatasetBundle(name=name, base=base, query=query, groundtruth=gt)


def write_dataset(bundle: DatasetBundle, data_path: str) -> str:
    """Materialize a DatasetBundle in the on-disk xvecs layout. Returns its dir."""
    dataset_dir = os.path.join(data_path, bundle.name)
    os.makedirs(dataset_dir, exist_ok=True)
    write_xvecs(os.path.join(dataset_dir, f"{bundle.name}_base.fvecs"), bundle.base)
    write_xvecs(os.path.join(dataset_dir, f"{bundle.name}_query.fvecs"), bundle.query)
    if bundle.groundtruth is not None:
        write_xvecs(
            os.path.join(dataset_dir, f"{bundle.name}_groundtruth.ivecs"), bundle.groundtruth
        )
    return dataset_dir
