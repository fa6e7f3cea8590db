"""Sharded K-Means: Lloyd with the corpus rows sharded over the ranks (port
of lira_tpu/parallel/sharded_kmeans.py).

The single-chip partitioner (partition/kmeans.py) bounds training memory by
subsampling to max_points_per_centroid rows.  Here the corpus ROWS are
sharded (rank s holds rows [s·rows, (s+1)·rows), zero rows with weight 0
past n), the centroids are replicated, and every Lloyd step is

  local assignment  : chunked matmul-argmin over the rank's rows (at most a
                      (chunk, n_bkt) score block at a time)
  local accumulation: one-hot matmul of the weighted rows into (n_bkt, d)
                      sums and (n_bkt,) counts, the objective's two terms
  global reduction  : one all-reduce of the sums, counts and objective —
                      every rank then computes the SAME new centroids

Device memory per rank is one shard + O(n_bkt·d); the traffic per
iteration is n_bkt·d + n_bkt + 1 floats, independent of n.

Numerics: the all-reduce adds the ranks' partial sums in another order than
lira_tpu's psum tree and the single-chip matmul over all rows, so the
centroids agree to float accumulation error (allclose), not bitwise; the
assignment of given centroids is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import true_fp32
from ..ops.distance import pairwise_scores
from ..partition.kmeans import KMeans
from .mesh import Mesh


def _shard_rows(x: np.ndarray, mesh: Mesh, multiple: int):
    """This rank's rows on its device: (xs (rows, d), ws (rows,), rows),
    zero rows and zero weights past n; `rows` is a multiple of `multiple`
    so the in-shard chunks divide it evenly."""
    n, d = x.shape
    rows = -(-n // mesh.size)
    rows = -(-rows // multiple) * multiple
    s, e = min(mesh.rank * rows, n), min((mesh.rank + 1) * rows, n)
    xs = np.zeros((rows, d), np.float32)
    ws = np.zeros(rows, np.float32)
    xs[: e - s] = x[s:e]
    ws[: e - s] = 1.0
    return (torch.as_tensor(xs, device=mesh.device), torch.as_tensor(ws, device=mesh.device),
            rows)


def _chunk_rows(n: int, size: int, chunk_rows: int) -> int:
    return -(-max(8, min(chunk_rows, -(-n // size))) // 8) * 8


@torch.no_grad()
@true_fp32()
def _local_step(xs, ws, c, reseed_c, *, n_bkt: int, chunk: int, mesh: Mesh):
    """One Lloyd step on this rank's shard; all-reduced update.
    Returns (new centroids (n_bkt, d), identical on every rank, objective)."""
    d = xs.shape[1]
    acc = torch.zeros(n_bkt * d + n_bkt + 1, dtype=torch.float32, device=xs.device)
    sums, counts, tot = acc[: n_bkt * d].view(n_bkt, d), acc[n_bkt * d : -1], acc[-1:]
    for s in range(0, xs.shape[0], chunk):
        xc, wc = xs[s : s + chunk], ws[s : s + chunk]
        sc = pairwise_scores(xc, c)
        best, a = torch.min(sc, dim=1)  # first index among equal minima
        oh = torch.nn.functional.one_hot(a, n_bkt).float() * wc[:, None]  # (chunk, n_bkt)
        sums += oh.T @ xc
        counts += oh.sum(dim=0)
        tot += (best * wc).sum() + ((xc * xc).sum(dim=1) * wc).sum()
    acc = mesh.all_reduce(acc)  # one collective: sums, counts and objective
    sums, counts, tot = acc[: n_bkt * d].view(n_bkt, d), acc[n_bkt * d : -1], acc[-1]
    n_real = torch.clamp_min(counts.sum(), 1.0)
    new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
    new_c = torch.where((counts > 0)[:, None], new_c, reseed_c)
    return new_c, tot / n_real


def sharded_kmeans_fit(
    x: np.ndarray,
    n_bkt: int,
    mesh: Mesh,
    niter: int = 20,
    seed: int = 43,
    chunk_rows: int = 16384,
    verbose: bool = False,
    init_centroids: np.ndarray | None = None,  # (n_bkt, d) override
    reseed_vectors: np.ndarray | None = None,  # (n_bkt, d) empty-cluster seeds
) -> KMeans:
    """Full-corpus Lloyd over the ranks (no subsampling — sharding is the
    memory bound).  Init and reseed rows as lira_tpu draws them: random
    distinct rows of x from one numpy generator seeded with `seed`, the
    init first; `init_centroids`/`reseed_vectors` pin them.  Every rank
    passes the same x and returns the same KMeans."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    if init_centroids is None:
        init_centroids = x[rng.choice(n, size=n_bkt, replace=n < n_bkt)]
    if reseed_vectors is None:
        reseed_vectors = x[rng.choice(n, size=n_bkt, replace=n < n_bkt)]
    dev = mesh.device
    c = torch.as_tensor(np.asarray(init_centroids, np.float32), device=dev)
    rc = torch.as_tensor(np.asarray(reseed_vectors, np.float32), device=dev)

    chunk = _chunk_rows(n, mesh.size, chunk_rows)
    xs, ws, _ = _shard_rows(x, mesh, chunk)
    objs = []
    for i in range(niter):
        c, obj = _local_step(xs, ws, c, rc, n_bkt=n_bkt, chunk=chunk, mesh=mesh)
        objs.append(float(obj))
        if verbose and mesh.rank == 0:
            print(f"sharded kmeans iter {i}: objective {objs[-1]:.6g}", flush=True)
    return KMeans(centroids=c.cpu().numpy(), objective=np.asarray(objs, np.float32))


@torch.no_grad()
def sharded_kmeans_assign(x: np.ndarray, centroids: np.ndarray, mesh: Mesh,
                          chunk_rows: int = 65536) -> np.ndarray:
    """Nearest-centroid assignment with the rows sharded over the ranks.
    (n,) int32 on every rank, equal to partition.kmeans_assign (the same
    per-row argmin on the same scores; the ranks only split the rows)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    chunk = _chunk_rows(n, mesh.size, chunk_rows)
    xs, _, rows = _shard_rows(x, mesh, chunk)
    c = torch.as_tensor(np.asarray(centroids, np.float32), device=mesh.device)
    local = torch.cat([torch.argmin(pairwise_scores(xs[s : s + chunk], c), dim=1)
                       for s in range(0, rows, chunk)]).to(torch.int32)
    out = torch.cat(mesh.all_gather(local)).cpu().numpy()
    return out[:n]  # shard s holds rows [s·rows, (s+1)·rows): padding is the tail
