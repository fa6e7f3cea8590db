"""Extract k=1 label caches from existing k=10 caches (port of
lira_tpu/pipelines/extract_k1.py: numpy only, byte-identical files).

Capability parity with the reference's extract_knn_k1.py (slice column 0 of
a cached k=10 self-kNN `.bin`, write a k=1 `.bin` + `.meta`), generalized
to any source/target k.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..io.cache import knn_cache_dir, read_knn_meta


def find_cache_file(data_path: str, dataset: str, k: int) -> str | None:
    """Newest cache file for (dataset, k), preferring approximate."""
    cache_dir = knn_cache_dir(data_path, dataset)
    for pattern in (
        f"{dataset}-data_self_knn{k}-n*_ivf_nprobe*.bin",
        f"{dataset}-data_self_knn{k}-n*.bin",
    ):
        matches = glob.glob(os.path.join(cache_dir, pattern))
        if matches:
            return max(matches, key=os.path.getctime)
    return None


def extract_k_subset(src_path: str, k_src: int, k_dst: int) -> str:
    """Write a new cache keeping the first k_dst columns of a k_src cache."""
    if k_dst >= k_src:
        raise ValueError(f"k_dst ({k_dst}) must be < k_src ({k_src})")
    meta = read_knn_meta(src_path)
    raw = np.fromfile(src_path, dtype=np.int32)
    if raw.size % k_src != 0:
        raise ValueError(f"{src_path}: size {raw.size} not divisible by k={k_src}")
    n = raw.size // k_src
    sliced = raw.reshape(n, k_src)[:, :k_dst]

    dst_path = src_path.replace(f"_self_knn{k_src}-", f"_self_knn{k_dst}-")
    if dst_path == src_path:
        raise ValueError(f"cannot derive target name from {src_path}")
    np.ascontiguousarray(sliced).tofile(dst_path)

    lines = [f"{key}: {val}" for key, val in meta.items() if key != "k"]
    lines.insert(3 if len(lines) >= 3 else len(lines), f"k: {k_dst}")
    lines.append(f"derived_from: {os.path.basename(src_path)}")
    with open(dst_path + ".meta", "w") as f:
        f.write("\n".join(lines) + "\n")
    return dst_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset")
    p.add_argument("data_path", nargs="?", default="/data/vector_datasets")
    p.add_argument("--k_src", type=int, default=10)
    p.add_argument("--k_dst", type=int, default=1)
    a = p.parse_args(argv)
    src = find_cache_file(a.data_path, a.dataset, a.k_src)
    if src is None:
        raise SystemExit(f"no k={a.k_src} cache found for {a.dataset}")
    dst = extract_k_subset(src, a.k_src, a.k_dst)
    print(f"wrote {dst}")


if __name__ == "__main__":
    main()
