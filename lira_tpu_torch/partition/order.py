"""Bucket orderings for probe-locality query grouping.

The blocked engine groups queries into qb-sized blocks after sorting by
top-probed bucket; every query in a block pays the MXU screen over the
block's bucket UNION (block_scan.py module docstring).  Raw bucket IDs
are an arbitrary key: consecutive top-1 groups land in the same block
with spatially unrelated probe sets, so the union is far wider than any
one query's probes — the round-4 "probe skew" QPS gap (VERDICT r4
item 2; measured attribution in scripts/skew_profile.py).

`centroid_tour_rank` produces a locality-preserving relabeling: buckets
adjacent in the ordering have nearby centroids, so a block's queries —
whose secondary probes are spatial neighbors of their top-1 centroid —
share most of their probed buckets.  The ordering only changes WHICH
queries share a block (an execution strategy); per-query probed sets,
results, and ndis accounting are untouched.

No reference analogue: the reference scans per query serially on one
CPU core (search.cpp hot loop) and never amortizes fetches across
queries, so it has no grouping problem to solve.
"""

from __future__ import annotations

import numpy as np

__all__ = ["centroid_tour_rank"]


def centroid_tour_rank(centroids: np.ndarray, max_exact: int = 8192) -> np.ndarray:
    """(n_bkt,) int32: rank[b] = position of bucket b in a locality tour.

    Greedy nearest-neighbor tour over the centroids, O(n_bkt²·d) once at
    engine build (~80 ms at n_bkt=1024, d=128).  Beyond `max_exact`
    buckets, falls back to ordering along the top principal component —
    O(n_bkt·d²) — which preserves coarse locality at any scale.
    """
    c = np.asarray(centroids, np.float32)
    n = c.shape[0]
    if n <= 2:
        return np.arange(n, dtype=np.int32)
    if n > max_exact:
        mu = c.mean(axis=0)
        x = c - mu
        # top PC via a few power iterations (no full SVD at large n_bkt)
        rng = np.random.default_rng(0)
        v = rng.standard_normal(c.shape[1]).astype(np.float32)
        for _ in range(16):
            v = x.T @ (x @ v)
            v /= np.linalg.norm(v) + 1e-30
        order = np.argsort(x @ v, kind="stable")
    else:
        sq = (c * c).sum(axis=1)
        visited = np.zeros(n, bool)
        order = np.empty(n, np.int64)
        # start from the centroid farthest from the mean (a tour endpoint,
        # not a middle — keeps the greedy path from stranding outliers)
        cur = int(((c - c.mean(axis=0)) ** 2).sum(axis=1).argmax())
        for i in range(n):
            order[i] = cur
            visited[cur] = True
            d = sq - 2.0 * (c @ c[cur])  # + sq[cur], constant per step
            d[visited] = np.inf
            if i + 1 < n:
                cur = int(d.argmin())
    rank = np.empty(n, np.int32)
    rank[order] = np.arange(n, dtype=np.int32)
    return rank
