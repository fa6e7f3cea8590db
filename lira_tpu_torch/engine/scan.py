"""Exact in-partition scan: per-(query, bucket) top-k for every bucket
(port of lira_tpu/engine/scan.py).

The evaluation harness behind the recall/ndis curves.  Buckets are grouped
into size classes (equal padded row counts); each class is one batched
product in true f32 — (Q, d) × (C, S, d) → (Q, C, S) — followed by a
per-bucket top-k.  The corpus is scanned once for all queries; every
threshold's metrics are then pure masking (sweep.py).

Ties break toward the lower member id (bucket member lists are sorted
ascending).  Buckets smaller than k yield −1 padding ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, true_fp32
from ..ops.topk import top_k
from ..partition.assign import BucketLayout


@dataclass
class BucketCorpus:
    """Bucket vectors grouped by padded-size class, on the device."""

    classes: list[dict]  # per class: {size, buckets (C,), vecs (C,S,d), ids (C,S)}
    n_bkt: int
    dim: int
    device: torch.device

    @classmethod
    def build(cls, x_d: np.ndarray, layout: BucketLayout, device=None) -> "BucketCorpus":
        dev = resolve_device(device)
        x_d = np.asarray(x_d, dtype=np.float32)
        psizes = layout.padded_sizes
        classes = []
        for size in np.unique(psizes):
            if size == 0:
                continue
            buckets = np.where(psizes == size)[0]
            ids = np.empty((len(buckets), size), dtype=np.int32)
            for i, b in enumerate(buckets):
                ids[i] = layout.padded_ids[layout.padded_offsets[b] : layout.padded_offsets[b + 1]]
            vecs = np.zeros((len(buckets), size, x_d.shape[1]), dtype=np.float32)
            valid = ids >= 0
            vecs[valid] = x_d[ids[valid]]
            classes.append({
                "size": int(size),
                "buckets": buckets,
                "vecs": torch.as_tensor(vecs, device=dev),
                "ids": torch.as_tensor(ids, device=dev),
            })
        return cls(classes=classes, n_bkt=layout.n_bkt, dim=x_d.shape[1], device=dev)


@true_fp32()
def _class_topk(q: torch.Tensor, vecs: torch.Tensor, ids: torch.Tensor, k: int, metric: str):
    """(Q, d) × (C, S, d) → per-bucket top-k scores and global ids."""
    dot = torch.einsum("qd,csd->qcs", q, vecs)
    if metric == "inner_product":
        score = -dot
    else:
        v_sq = (vecs * vecs).sum(dim=-1)  # (C, S)
        score = v_sq[None] - 2.0 * dot
    score = torch.where((ids < 0)[None], torch.inf, score)
    kk = min(k, score.shape[-1])
    neg, local = top_k(-score, kk)  # (Q, C, kk)
    gid = torch.gather(ids[None].expand(score.shape), -1, local)
    gid = torch.where(torch.isfinite(neg), gid, -1)
    if kk < k:
        pad = (0, k - kk)
        neg = torch.nn.functional.pad(neg, pad, value=-torch.inf)
        gid = torch.nn.functional.pad(gid, pad, value=-1)
    return -neg, gid


def bucket_topk(
    x_q: np.ndarray,
    corpus: BucketCorpus,
    k: int,
    metric: str = "L2",
    q_chunk: int = 512,
    score_budget: int = 1 << 27,
) -> np.ndarray:
    """(n_q, n_bkt, k) int32 — top-k member ids of every bucket for every query.

    −1 marks missing results (bucket smaller than k / empty bucket)."""
    x_q = np.asarray(x_q, dtype=np.float32)
    n_q = len(x_q)
    q_dev = torch.as_tensor(x_q, device=corpus.device)
    found = np.full((n_q, corpus.n_bkt, k), -1, dtype=np.int32)
    for cl in corpus.classes:
        c, s = cl["vecs"].shape[0], cl["size"]
        # keep the (Q, C, S) score tensor under the budget
        qc = max(8, min(q_chunk, score_budget // max(c * s, 1)))
        for start in range(0, n_q, qc):
            end = min(start + qc, n_q)
            _, gid = _class_topk(q_dev[start:end], cl["vecs"], cl["ids"], k, metric)
            found[start:end, cl["buckets"]] = gid.cpu().numpy()
    return found
