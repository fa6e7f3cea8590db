"""Brute-force exact kNN (port of lira_tpu/ops/knn.py).

A query tile's scores against one corpus chunk are one matmul in true
fp32; the chunk's top-k is taken with `lax.top_k`'s tie rule (ops/topk.py)
and folded into the tile's running top-k.  lira_tpu's transposed (d, n)
corpus and one-hot-matmul group extraction are TPU layout choices and do
not carry over; the results do:

  * scores are ranking scores — L2² minus the per-query norm, or −IP;
  * ids are int32 into `base`, ascending by score, the lower id first
    among equal scores;
  * k is clamped to the corpus size.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device, true_fp32
from .topk import top_k


def _device(base, device) -> torch.device:
    """The caller's device; by default a tensor corpus's own, else cuda."""
    if device is None and isinstance(base, torch.Tensor):
        return base.device
    return resolve_device(device)


def _as_f32(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=dev)


def _merge_topk(best, new, k: int):
    """Smallest-k of two (values, ids) pairs, earlier pair first among
    equal values (values are negated scores: larger is closer)."""
    if best is None:
        return new
    vals = torch.cat([best[0], new[0]], dim=1)
    ids = torch.cat([best[1], new[1]], dim=1)
    v, sel = top_k(vals, min(k, vals.shape[1]))
    return v, torch.gather(ids, 1, sel)


def exact_knn(
    base,
    query,
    k: int,
    metric: str = "L2",
    q_tile: int = 4096,
    b_tile: int = 131072,
    precision: str = "highest",
    verbose: bool = False,
    score_budget: int = 1 << 29,  # max Q×C score elements in flight (2 GiB f32)
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN of `query` against `base` (numpy arrays or tensors).

    Returns (scores, ids) as host arrays: ranking scores (L2² minus the
    per-query norm, or −IP) and int32 ids into `base`.  Products are true
    f32 (`precision="highest"`, the only value the port's callers use)."""
    if precision != "highest":
        raise ValueError(f"precision={precision!r}: exact_knn multiplies true f32 values")
    dev = _device(base, device)
    n_b = base.shape[0]
    n_q = query.shape[0]
    k = min(k, n_b)
    while q_tile * b_tile > score_budget and q_tile > 256:
        q_tile //= 2

    x = _as_f32(base, dev)
    q = _as_f32(query, dev)
    l2 = metric != "inner_product"
    out_s, out_i = [], []
    with true_fp32():
        bsq = (x * x).sum(dim=1) if l2 else None
        for s in range(0, n_q, q_tile):
            qt = q[s : s + q_tile]
            best = None
            for c in range(0, n_b, b_tile):
                dot = qt @ x[c : c + b_tile].T
                sc = bsq[c : c + b_tile][None, :] - 2.0 * dot if l2 else -dot
                v, i = top_k(-sc, min(k, sc.shape[1]))
                best = _merge_topk(best, (v, i + c), k)
            out_s.append(-best[0])
            out_i.append(best[1].to(torch.int32))
            if verbose and ((s // q_tile) % 10 == 0 or s + q_tile >= n_q):
                print(f"  kNN: {min(s + q_tile, n_q)}/{n_q} queries")
    if not out_s:
        return np.empty((0, k), np.float32), np.empty((0, k), np.int32)
    return torch.cat(out_s).cpu().numpy(), torch.cat(out_i).cpu().numpy()


def merge_topk_host(best_s, best_i, sc: np.ndarray, ids: np.ndarray, k: int):
    """The k smallest of two host (scores, global ids) pairs per row, the
    earlier pair first among equal scores (a stable sort); `best_s` None
    takes the new pair as it is.  Ranking scores do not depend on the chunk
    a row came from, so chunk partials merge to the whole set's top-k."""
    if best_s is None:
        return sc, ids
    cs = np.concatenate([best_s, sc], axis=1)
    ci = np.concatenate([best_i, ids], axis=1)
    sel = np.argsort(cs, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(cs, sel, axis=1), np.take_along_axis(ci, sel, axis=1)


def exact_knn_stream(
    base: np.ndarray,
    query,
    k: int,
    metric: str = "L2",
    base_chunk: int = 2_097_152,
    verbose: bool = False,
    device=None,
    **kw,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN over a corpus too large for device memory.

    Streams `base` through `exact_knn` in host chunks (the device holds one
    chunk at a time) and merges the per-chunk top-k on the host.  The
    ranking scores do not depend on the chunk, so the merge is a plain
    stable top-k over concatenated (score, global id) pairs.  Same contract
    as exact_knn, with int64 ids (−1 pads when the corpus has fewer than k
    rows)."""
    base = np.asarray(base)
    n_b = base.shape[0]
    dev = resolve_device(device)
    q_dev = _as_f32(query, dev)  # upload queries once
    best_s = best_i = None
    for s in range(0, n_b, base_chunk):
        e = min(s + base_chunk, n_b)
        sc, ids = exact_knn(base[s:e], q_dev, min(k, e - s), metric=metric, device=dev, **kw)
        best_s, best_i = merge_topk_host(best_s, best_i, sc, ids.astype(np.int64) + s, k)
        if verbose:
            print(f"  kNN-stream: {e:,}/{n_b:,} rows", flush=True)
    if best_s.shape[1] < k:  # n_b < k: pad to the exact_knn k-clamp contract
        pad = k - best_s.shape[1]
        best_s = np.pad(best_s, ((0, 0), (0, pad)), constant_values=np.inf)
        best_i = np.pad(best_i, ((0, 0), (0, pad)), constant_values=-1)
    return best_s.astype(np.float32), best_i.astype(np.int64)


def self_knn(
    base,
    k: int,
    metric: str = "L2",
    q_tile: int = 4096,
    b_tile: int = 131072,
    precision: str = "highest",
    verbose: bool = False,
    device=None,
) -> np.ndarray:
    """Self-kNN of the corpus: (n, k) int32, self-match removed (searches
    k+1 and drops each row's own id, or the last hit when exact duplicates
    push it out)."""
    _, ids = exact_knn(
        base, base, k + 1, metric=metric, q_tile=q_tile, b_tile=b_tile,
        precision=precision, verbose=verbose, device=device,
    )
    return drop_self(ids, k)


def drop_self(ids: np.ndarray, k: int, row_ids: np.ndarray | None = None) -> np.ndarray:
    """Drop each row's own id from a (n, kk) self-search result → (n, k).

    Drops exactly one entry per row: the self hit if present, else the last
    (exact-duplicate ties).  kk may be < k+1 when the search clamped k to
    the corpus size (k >= n): the missing tail is -1-padded.  `row_ids`
    overrides the default arange(n) when the query rows are a slice of the
    corpus (chunked self-search: global ids s..e)."""
    n, kk = ids.shape
    if row_ids is None:
        rows = np.arange(n)[:, None]
    else:
        rows = np.asarray(row_ids).reshape(n, 1)
    is_self = ids == rows  # (n, kk)
    has_self = is_self.any(axis=1)
    drop_col = np.where(has_self, is_self.argmax(axis=1), kk - 1)
    keep = np.ones_like(ids, dtype=bool)
    keep[np.arange(n), drop_col] = False
    out = ids[keep].reshape(n, kk - 1).astype(np.int32)
    if kk - 1 < k:  # k >= n: fewer than k real neighbors exist
        out = np.concatenate(
            [out, np.full((n, k - (kk - 1)), -1, np.int32)], axis=1
        )
    return out
