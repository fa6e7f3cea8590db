"""Sharded brute-force kNN: the corpus row-sharded over the ranks (port of
lira_tpu/parallel/sharded_knn.py).

Rank s owns the contiguous rows [s·per, (s+1)·per) (zero rows with a 1e30
penalty past n) and streams them in `c_block`-row chunks.  Per chunk, as
lira_tpu's `_local_knn`: the minimum of each 128-row group of the chunk's
scores (K2, `ops/groupmin.py::groupmin` at "highest" — exactly the
csq − 2·dot (L2) / csq − dot (IP) group minimum; its plain version on the
CPU), the k + 2 groups with the smallest minima (they hold the chunk's
top-k), an exact f32 rescore of those groups, and a fold into the running
(Q, k).  The (Q, per) score matrix never exists.  Each rank's top-k is
then gathered (`Mesh.all_gather`, the list form) and re-merged — the same
result as the single-device search.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import true_fp32
from ..ops.groupmin import GROUP, groupmin
from ..ops.knn_pallas import _R2_BUDGET, _round2_rescan
from ..ops.topk import top_k
from .mesh import Mesh


@torch.no_grad()
@true_fp32()
def _local_knn(q, shard, shard_sq, k: int, metric: str, c_block: int, mesh: Mesh):
    """This rank's exact kNN against its shard, merged over the ranks.
    q (Q, d), shard (per, d) and shard_sq (per,) on the rank's device.
    Returns (scores (Q, k), ids (Q, k) int64 global, −1 past the corpus)."""
    per, d = shard.shape
    Q = q.shape[0]
    g = c_block // GROUP
    kg = min(k + 2, g)  # groups guaranteed to hold the chunk top-k (ops/topk.py)
    k_loc = min(k, per)
    sub = max(1, min(Q, _R2_BUDGET // max(kg * GROUP * d * 4, 1)))
    best_neg = torch.full((Q, k_loc), -torch.inf, device=q.device)
    best_idx = torch.full((Q, k_loc), -1, dtype=torch.int64, device=q.device)
    for c0 in range(0, per, c_block):
        chunk, csq = shard[c0 : c0 + c_block], shard_sq[c0 : c0 + c_block]
        gmin = groupmin(q, chunk, csq, metric=metric, precision="highest")  # (Q, g)
        _, gsel = top_k(-gmin, kg)
        sc, idx = _round2_rescan(q, gsel, chunk, csq, metric, min(k_loc, kg * GROUP),
                                 sub=sub)
        merged_neg = torch.cat([best_neg, -sc], dim=1)
        merged_idx = torch.cat([best_idx, idx + c0], dim=1)
        best_neg, sel = top_k(merged_neg, k_loc)
        best_idx = torch.gather(merged_idx, 1, sel)
    if k_loc < k:  # shard smaller than k: pad so the cross-shard merge is k-wide
        pad = k - k_loc
        best_neg = torch.cat([best_neg, best_neg.new_full((Q, pad), -torch.inf)], dim=1)
        best_idx = torch.cat([best_idx, best_idx.new_full((Q, pad), -1)], dim=1)
    ids_global = torch.where(best_idx >= 0, best_idx + mesh.rank * per, -1)
    # merge over the ranks: rank order, then lax.top_k's tie rule
    flat_neg = torch.cat(mesh.all_gather(best_neg), dim=1)  # (Q, size·k)
    flat_ids = torch.cat(mesh.all_gather(ids_global), dim=1)
    neg, sel = top_k(flat_neg, k)
    return -neg, torch.gather(flat_ids, 1, sel)


def sharded_exact_knn(
    base: np.ndarray,
    query: np.ndarray,
    k: int,
    mesh: Mesh,
    metric: str = "L2",
    q_tile: int = 4096,
    score_budget: int = 1 << 28,  # bytes of one (q_tile, c_block) f32 score block
) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN with the corpus row-sharded over the ranks; every rank
    passes the same `base` and `query` and gets the same (scores, ids), as
    ops.knn.exact_knn returns them.  Rows are padded per shard to a
    multiple of the streaming chunk; padding carries a 1e30 penalty and
    comes back as id −1.  The chunk is cut by lira_tpu's rule: q_tile ×
    c_block × 4 B ≤ score_budget."""
    base = np.asarray(base, dtype=np.float32)
    n, d = base.shape
    q_tile = min(q_tile, max(8, len(query)))
    c_block = max(GROUP, min(1 << 17, (score_budget // (q_tile * 4)) // GROUP * GROUP))
    per_raw = (n + mesh.size - 1) // mesh.size
    per = ((per_raw + c_block - 1) // c_block) * c_block
    c_block = min(c_block, per)

    # this rank's rows only: host staging is one shard
    lo, hi = min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)
    shard = np.zeros((per, d), np.float32)
    shard[: hi - lo] = base[lo:hi]
    penalty = np.where(np.arange(per) < hi - lo, 0.0, 1e30).astype(np.float32)
    if metric == "inner_product":
        sq = penalty
    else:
        sq = (shard * shard).sum(axis=1).astype(np.float32) + penalty
    dev = mesh.device
    shard_dev = torch.as_tensor(shard, device=dev)
    sq_dev = torch.as_tensor(sq, device=dev)
    del shard

    query = np.asarray(query, dtype=np.float32)
    nq = len(query)
    out_s = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int32)
    for s in range(0, nq, q_tile):
        e = min(s + q_tile, nq)
        sc, ids = _local_knn(torch.as_tensor(query[s:e], device=dev), shard_dev, sq_dev,
                             k, metric, c_block, mesh)
        out_s[s:e] = sc.cpu().numpy()
        out_i[s:e] = ids.cpu().numpy()
    # padded global rows (per-shard padding) → mark missing
    out_i = np.where(out_s < 1e29, out_i, -1)
    return out_s, out_i


def sharded_self_knn(base: np.ndarray, k: int, mesh: Mesh, metric: str = "L2",
                     **kw) -> np.ndarray:
    """Self-kNN with the corpus sharded over the ranks; self-hit removed."""
    from ..ops.knn import drop_self

    _, ids = sharded_exact_knn(base, base, k + 1, mesh, metric=metric, **kw)
    return drop_self(ids, k)
