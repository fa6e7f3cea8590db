"""Offline self-kNN precompute CLI (port of
lira_tpu/pipelines/compute_knn_cli.py).

The replacement for the reference's `compute_knn` C++/Faiss binary
(reference: compute_knn.cpp — CLI `compute_knn <dataset> <data_path> <k>
[nprobe] [n_threads]`).  Exact search on the card is the fused two-round
kNN at f32 selection precision (K2, as `get_self_knn` runs it), on the CPU
the chunked exact `self_knn`; `nprobe != 0` runs the two-stage approximate
search (cluster-assign, then scan the nprobe nearest partitions with the
plain-torch per-query scan) mirroring the reference's IVF mode, with its
automatic n_list by corpus scale.  Results go to the same `.bin` + `.meta`
cache contract, tagged `{device}_flat_exact` or `ivf_approximate`.

    python -m lira_tpu_torch knn --device cpu toyv /path/to/data 5
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from .. import resolve_device
from ..io.cache import save_knn_cache
from ..io.datasets import load_data
from ..ops.knn import self_knn
from ..ops.knn_pallas import self_knn_fused
from ..partition.kmeans import kmeans_assign, kmeans_fit


def auto_n_list(n: int) -> int:
    """Scale-dependent cluster-count heuristic (reference: compute_knn.cpp:155-171)."""
    root = int(math.isqrt(n))
    if n < 50_000:
        return min(root, 256)
    if n < 1_000_000:
        return min(root, 1024)
    return min(root, 4096)


def auto_nprobe(n: int, n_list: int) -> int:
    """Speed/accuracy balance heuristic (reference: compute_knn.cpp:186-196)."""
    if n < 100_000:
        return min(max(n_list // 4, 16), 64)
    return min(max(n_list // 8, 32), 128)


def ivf_self_knn(
    base: np.ndarray, k: int, n_list: int, nprobe: int, seed: int = 43,
    metric: str = "L2", device=None, chunk: int = 4096,
) -> np.ndarray:
    """Two-stage approximate self-kNN: coarse quantize, then scan each
    row's nprobe nearest partitions (the candidate set is the union of
    their members) with the serving engine's per-query scan."""
    from ..engine.serve import _scan_probed_tiles
    from ..ops.distance import pairwise_scores, row_sqnorms
    from ..ops.knn import drop_self
    from ..partition.assign import build_bucket_layout

    dev = resolve_device(device)
    base = np.asarray(base, np.float32)
    km = kmeans_fit(base, n_list, niter=10, seed=seed, device=dev)
    assign = kmeans_assign(base, km.centroids, device=dev)
    layout = build_bucket_layout(assign, n_list)

    n = len(base)
    out = np.empty((n, k), dtype=np.int32)
    tile = layout.tile
    padded = layout.gather_vectors(base)
    n_tiles = padded.shape[0] // tile
    ids = layout.padded_ids.reshape(n_tiles, tile)
    corpus = torch.as_tensor(padded.reshape(n_tiles, tile, base.shape[1]), device=dev)
    corpus_ids = torch.as_tensor(ids, device=dev)
    if metric == "inner_product":
        sq = np.zeros((n_tiles, tile), np.float32)
    else:
        sq = row_sqnorms(padded).reshape(n_tiles, tile)
    corpus_sq = torch.as_tensor(np.where(ids >= 0, sq, np.inf).astype(np.float32), device=dev)
    del padded
    tile_start = (layout.padded_offsets[:-1] // tile).astype(np.int64)
    tiles_per_bucket = (layout.padded_sizes // tile).astype(np.int64)
    cents = torch.as_tensor(np.asarray(km.centroids, np.float32), device=dev)

    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        q = torch.as_tensor(base[s:e], device=dev)
        if metric == "inner_product":
            cs = -np.asarray(base[s:e] @ km.centroids.T)  # rank centroids by IP
        else:
            cs = pairwise_scores(q, cents).cpu().numpy()
        probe = np.argsort(cs, axis=1, kind="stable")[:, :nprobe]
        B = e - s
        probed = np.zeros((B, n_list), dtype=bool)
        probed[np.arange(B)[:, None], probe] = True
        # per-query tile lists
        rows, bs = np.nonzero(probed)
        reps = tiles_per_bucket[bs]
        keep = reps > 0
        rows, bs, reps = rows[keep], bs[keep], reps[keep]
        total = int(reps.sum())
        starts = np.repeat(tile_start[bs], reps)
        cum = np.cumsum(reps) - reps
        within = np.arange(total, dtype=np.int64) - np.repeat(cum, reps)
        tiles_flat = (starts + within).astype(np.int32)
        rows_flat = np.repeat(rows, reps)
        cnt = np.bincount(rows_flat, minlength=B)
        T = 1 << int(np.ceil(np.log2(max(int(cnt.max()), 1))))
        tl = np.full((B, T), -1, np.int32)
        rs = np.cumsum(cnt) - cnt
        pos = np.arange(total, dtype=np.int64) - rs[rows_flat]
        tl[rows_flat, pos] = tiles_flat

        _, nn = _scan_probed_tiles(q, torch.as_tensor(tl, device=dev), corpus, corpus_ids,
                                   corpus_sq, k + 1, metric)
        out[s:e] = drop_self(nn.cpu().numpy(), k, row_ids=np.arange(s, e))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset")
    p.add_argument("data_path", nargs="?", default="/data/vector_datasets")
    p.add_argument("k", nargs="?", type=int, default=10)
    p.add_argument("nprobe", nargs="?", type=int, default=0)
    p.add_argument("n_threads", nargs="?", type=int, default=0)  # CLI parity; unused
    p.add_argument(
        "--metric", default="L2", choices=["L2", "inner_product"],
        help="distance metric; non-L2 caches carry a metric tag so an "
        "inner_product pipeline can never consume L2 neighbors",
    )
    p.add_argument(
        "--streaming", action="store_true",
        help="chunked disk→device ingestion: the corpus is never widened to "
        "f32 on the host (BIGANN-scale bvecs; reference: compute_knn.cpp:113-140)",
    )
    p.add_argument("--chunk_rows", type=int, default=1 << 20)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)

    t0 = time.time()
    if a.streaming:
        if a.nprobe != 0:
            raise SystemExit("--streaming currently supports exact mode (nprobe=0) only")
        from ..io.streaming import base_file_path, stream_to_device

        base_file = base_file_path(a.data_path, a.dataset)
        if base_file is None:
            raise FileNotFoundError(f"no base vectors for {a.dataset} under {a.data_path}")
        base = stream_to_device(base_file, chunk_rows=a.chunk_rows, device=dev)
    else:
        base = load_data(a.dataset, data_path=a.data_path).base
    read_time = time.time() - t0
    n, dim = base.shape

    t0 = time.time()
    if a.nprobe != 0:
        n_list = auto_n_list(n)
        nprobe = a.nprobe if a.nprobe > 0 else auto_nprobe(n, n_list)
        knn = ivf_self_knn(base, a.k, n_list, nprobe, metric=a.metric, device=dev)
        method = "ivf_approximate"
    else:
        n_list = nprobe = None
        if dev.type == "cuda":
            knn = self_knn_fused(base, a.k, metric=a.metric, precision="highest", device=dev)
        else:
            knn = self_knn(base, a.k, metric=a.metric, device=dev)
        method = f"{dev.type}_flat_exact"
    search_time = time.time() - t0

    path = save_knn_cache(
        a.data_path, a.dataset, knn, dim=dim, method=method,
        nprobe=nprobe, n_clusters=n_list, metric=a.metric,
        timings={"read_time": round(read_time, 3), "search_time": round(search_time, 3),
                 "total_time": round(read_time + search_time, 3)},
    )
    print(f"kNN written to {path} ({search_time:.2f}s search)")
    return path


if __name__ == "__main__":
    main()
