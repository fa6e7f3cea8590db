"""K-Means partitioner, Lloyd on the card (port of lira_tpu/partition/kmeans.py).

Training subsamples the corpus to `max_points_per_centroid` points per
centroid, pads the sample to a whole number of `chunk_rows` chunks by
repeating head rows, draws the init and the empty-cluster reseed rows —
all from numpy in the same order as lira_tpu, so one seed gives one
training set and one init in both packages.  Lloyd's assignment is a
matmul-argmin over centroid scores; the update is a one-hot matmul
(deterministic, unlike a scatter-add with atomics).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, true_fp32
from ..ops.distance import pairwise_scores


@dataclass
class KMeans:
    centroids: np.ndarray  # (n_bkt, dim) float32
    objective: np.ndarray  # (niter,) mean squared distance per iteration

    @property
    def n_bkt(self) -> int:
        return self.centroids.shape[0]


def _assign_chunked(x: torch.Tensor, centroids: torch.Tensor, n_chunks: int):
    """argmin-distance assignment + per-point min score, chunk by chunk."""
    rows = x.shape[0] // n_chunks
    assign, best = [], []
    for c in range(n_chunks):
        s = pairwise_scores(x[c * rows : (c + 1) * rows], centroids)
        b, a = torch.min(s, dim=1)  # first index among equal minima
        assign.append(a)
        best.append(b)
    return torch.cat(assign), torch.cat(best)


@true_fp32()
def _lloyd(x: torch.Tensor, init: torch.Tensor, reseed: torch.Tensor,
           n_bkt: int, niter: int, n_chunks: int):
    """niter Lloyd iterations; empty clusters re-seeded from preselected rows."""
    rows = x.shape[0] // n_chunks
    msq = torch.mean(torch.sum(x * x, dim=1))
    centroids = init
    objs = []
    for _ in range(niter):
        assign, best = _assign_chunked(x, centroids, n_chunks)
        sums = torch.zeros((n_bkt, x.shape[1]), dtype=torch.float32, device=x.device)
        counts = torch.zeros(n_bkt, dtype=torch.float32, device=x.device)
        for c in range(n_chunks):
            a = assign[c * rows : (c + 1) * rows]
            one_hot = torch.nn.functional.one_hot(a, n_bkt).float()  # (rows, n_bkt)
            sums += one_hot.T @ x[c * rows : (c + 1) * rows]
            counts += one_hot.sum(dim=0)
        new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
        # empty cluster -> re-seed at a distinct random training point
        centroids = torch.where((counts > 0)[:, None], new_c, x[reseed])
        objs.append(torch.mean(best) + msq)
    return centroids, torch.stack(objs)


def _kmeanspp_init(xt: np.ndarray, n_bkt: int, rng: np.random.Generator,
                   device: torch.device, rounds: int = 5) -> np.ndarray:
    """kmeans|| (scalable k-means++, Bahmani et al. 2012): ~2·n_bkt/rounds
    candidates per round drawn ∝ squared distance, then a short weighted
    Lloyd reduces the candidates to n_bkt.  Same numpy draws as lira_tpu."""
    n = len(xt)
    x_dev = torch.as_tensor(xt, device=device)
    cand = [int(rng.integers(0, n))]
    per_round = max(2, (2 * n_bkt) // rounds)
    d2 = None
    msq = (xt.astype(np.float64) ** 2).sum(axis=1)
    new = np.array(cand)
    for _ in range(rounds):
        scores = pairwise_scores(x_dev, torch.as_tensor(xt[new], device=device)).cpu().numpy()
        d2_new = (scores.min(axis=1) + msq).clip(min=0.0)
        d2 = d2_new if d2 is None else np.minimum(d2, d2_new)
        total = d2.sum()
        if total <= 0:
            break
        take = np.nonzero(rng.random(n) < per_round * d2 / total)[0]
        if len(take) == 0:
            take = np.array([int(np.argmax(d2))])
        cand.extend(int(i) for i in take)
        new = take
    cand = np.unique(np.array(cand))
    if len(cand) <= n_bkt:  # degenerate (tiny data): fall back to random fill
        extra = rng.choice(n, size=n_bkt - len(cand) + 1, replace=False)
        cand = np.unique(np.concatenate([cand, extra]))[:n_bkt]
        return xt[cand] if len(cand) == n_bkt else xt[
            rng.choice(n, size=n_bkt, replace=False)
        ]
    scores = pairwise_scores(x_dev, torch.as_tensor(xt[cand], device=device)).cpu().numpy()
    owner = scores.argmin(axis=1)
    w = np.bincount(owner, minlength=len(cand)).astype(np.float64)
    pts = xt[cand].astype(np.float64)
    p = w + 1e-9  # keep weightless duplicates drawable
    seeds = rng.choice(len(cand), size=n_bkt, replace=False, p=p / p.sum())
    centers = pts[seeds].copy()
    psq = (pts**2).sum(axis=1)
    wp = pts * w[:, None]
    for _ in range(10):
        d = psq[:, None] - 2.0 * (pts @ centers.T) + (centers**2).sum(axis=1)[None, :]
        a = d.argmin(axis=1)
        wsum = np.bincount(a, weights=w, minlength=n_bkt)
        sums = np.zeros_like(centers)
        np.add.at(sums, a, wp)
        live = wsum > 0
        centers[live] = sums[live] / wsum[live, None]
    return centers.astype(np.float32)


def kmeans_fit(
    x: np.ndarray,
    n_bkt: int,
    niter: int = 20,
    seed: int = 43,
    max_points_per_centroid: int = 256,
    chunk_rows: int = 16384,
    verbose: bool = False,
    init: str = "random",  # 'random' (faiss parity) | 'kmeans++'
    device=None,
) -> KMeans:
    """Train K-Means with Lloyd iterations on (a subsample of) x."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    n, dim = x.shape
    rng = np.random.default_rng(seed)

    n_train = min(n, max_points_per_centroid * n_bkt)
    if n_train < n:
        sel = rng.choice(n, size=n_train, replace=False)
        xt = x[sel]
    else:
        xt = x
    n_chunks = max(1, int(np.ceil(len(xt) / chunk_rows)))
    rows = int(np.ceil(len(xt) / n_chunks))
    total = rows * n_chunks
    if total > len(xt):
        xt = np.concatenate([xt, xt[: total - len(xt)]], axis=0)

    if init == "kmeans++":
        init_c = _kmeanspp_init(xt, n_bkt, rng, dev)
    elif init == "random":
        init_c = xt[rng.choice(len(xt), size=n_bkt, replace=False)]
    else:
        raise ValueError(f"init={init!r}: expected 'random' or 'kmeans++'")
    reseed_idx = rng.choice(len(xt), size=n_bkt, replace=len(xt) < n_bkt)

    centroids, objs = _lloyd(
        torch.as_tensor(np.ascontiguousarray(xt), device=dev),
        torch.as_tensor(np.ascontiguousarray(init_c, np.float32), device=dev),
        torch.as_tensor(reseed_idx, device=dev),
        n_bkt, niter, n_chunks,
    )
    objs = objs.cpu().numpy()
    if verbose:
        print(f"kmeans: n_train={len(xt)} objective {objs[0]:.4g} -> {objs[-1]:.4g}")
    return KMeans(centroids=centroids.cpu().numpy(), objective=objs)


def kmeans_assign(x: np.ndarray, centroids: np.ndarray, chunk_rows: int = 65536,
                  device=None) -> np.ndarray:
    """Assign every row of x to its nearest centroid (streaming). (n,) int32."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    c = torch.tensor(np.asarray(centroids, np.float32), device=dev)
    out = np.empty(len(x), dtype=np.int32)
    for s in range(0, len(x), chunk_rows):
        e = min(s + chunk_rows, len(x))
        sc = pairwise_scores(torch.as_tensor(x[s:e], device=dev), c)
        out[s:e] = torch.argmin(sc, dim=1).cpu().numpy().astype(np.int32)
    return out
