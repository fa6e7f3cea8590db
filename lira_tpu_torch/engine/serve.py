"""Batched serving engine: probe → select → scan → top-k (port of
lira_tpu/engine/serve.py, blocked path).

  1. distance features: sqrt-L2 to centroids, standardized
  2. probing MLP forward
  3. bucket selection: score ≥ threshold, argmax fallback when empty
  4. exact scan of the probed buckets only — here the query-blocked scan
     (engine/block_scan.py) with the K1 screen
  5. ndis accounting uses true (unpadded) bucket sizes
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..labels.scaler import StandardScaler
from ..models.probing_mlp import ProbingMLP, params_from_jax
from ..ops.distance import l2_to_centroids
from ..ops.topk import top_k
from ..partition.assign import BucketLayout

_SCAN_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8,
}


@dataclass
class SearchResult:
    ids: np.ndarray  # (B, k) int32 global ids (-1 = missing)
    scores: np.ndarray  # (B, k) ranking scores
    nprobe: np.ndarray  # (B,) buckets probed
    ndis: np.ndarray  # (B,) true distance computations
    elapsed: float  # wall seconds for the whole batch (device time included)


class QueryEngine:
    """End-to-end query engine over a built LIRA index (blocked scan)."""

    def __init__(
        self,
        x_d: np.ndarray,
        layout: BucketLayout,
        centroids: np.ndarray,
        scaler: StandardScaler,
        params,  # ProbingMLP, or a lira_tpu parameter tree (converted)
        metric: str = "L2",
        n_mul: int = 2,
        scan_impl: str = "auto",  # 'auto' = 'blocked'
        scan_dtype: str = "float32",  # 'float32' | 'bfloat16' | 'int8'
        probe_cap: int | None = None,  # top-M bucket selection on the device
        block_q: int = 1024,  # queries per union block
        block_margin: int | None = None,  # extra selection groups
        prober=None,
        block_sel_rows: int | None = None,  # selection granularity in rows
        wire: str = "pack32",  # 'pack32' | 'f32' (identical bits) | 'bf16'
        store_f32: bool = True,
        device=None,
    ):
        if scan_impl == "auto":
            scan_impl = "blocked"
        if scan_impl in ("xla", "pallas"):
            item = ("queue A item 6 (the per-query xla scan)" if scan_impl == "xla"
                    else "queue B K3 (the per-query pallas scan)")
            raise NotImplementedError(
                f"scan_impl={scan_impl!r} is not ported yet: ROADMAP.md {item}"
            )
        if scan_impl != "blocked":
            raise ValueError(f"scan_impl={scan_impl!r}: expected 'auto' or 'blocked'")
        if not store_f32:
            raise NotImplementedError(
                "store_f32=False (capacity mode) is not ported yet: ROADMAP.md "
                "queue A item 6, capacity tables"
            )
        if prober is not None:
            raise NotImplementedError(
                "prober= (custom probers, the IVF baseline) is not ported yet: "
                "ROADMAP.md queue A item 7"
            )
        if str(scan_dtype) not in _SCAN_DTYPES:
            raise ValueError(f"scan_dtype={scan_dtype!r}: expected float32, bfloat16 or int8")
        if wire not in ("pack32", "f32", "bf16"):
            raise ValueError(f"wire={wire!r}: expected 'pack32', 'f32' or 'bf16'")
        self.device = dev = resolve_device(device)
        self.metric = metric
        self.n_mul = max(1, n_mul)
        self.scan_impl = scan_impl
        self.probe_cap = probe_cap
        self.scan_dtype = _SCAN_DTYPES[str(scan_dtype)]
        self.wire = wire
        self.block_q = block_q
        self.block_margin = block_margin
        if block_sel_rows is None:
            block_sel_rows = 64 if self.scan_dtype == torch.float32 else 32
        if not (0 < block_sel_rows <= 128 and 128 % block_sel_rows == 0):
            raise ValueError(f"block_sel_rows={block_sel_rows}: must be a divisor of 128")
        self.block_sel_rows = block_sel_rows
        if layout.tile != 128:
            raise ValueError(
                f"scan_impl='blocked' requires a 128-row tile layout (got tile={layout.tile})"
            )
        self.tile = layout.tile
        self.layout = layout

        self.tile_start = (layout.padded_offsets[:-1] // self.tile).astype(np.int64)
        self.tiles_per_bucket = (layout.padded_sizes // self.tile).astype(np.int64)
        self.sizes = layout.sizes  # true ndis per bucket
        self.sizes_dev = torch.as_tensor(self.sizes, dtype=torch.int64, device=dev)

        from ..partition.order import centroid_tour_rank
        from .block_scan import BlockScanState

        # locality relabeling for the query-grouping sort (grouping strategy
        # only — per-query results and ndis are rank-invariant)
        self.bucket_rank_dev = torch.as_tensor(
            centroid_tour_rank(np.asarray(centroids, np.float32)), dtype=torch.int64, device=dev
        )
        tile_bucket = np.repeat(
            np.arange(layout.n_bkt, dtype=np.int32), self.tiles_per_bucket
        )
        self._block_state = BlockScanState.from_corpus(
            np.asarray(x_d, dtype=np.float32), layout.padded_ids, tile_bucket, metric,
            self.scan_dtype, tile=self.tile, device=dev,
        )
        self.centroids = torch.tensor(np.asarray(centroids, np.float32), device=dev)
        self.scaler_mean = torch.tensor(np.asarray(scaler.mean_, np.float32), device=dev)
        self.scaler_scale = torch.tensor(np.asarray(scaler.scale_, np.float32), device=dev)
        # a copy: Module.to moves in place, and the caller's model may serve
        # another engine on another device
        mlp = copy.deepcopy(params) if isinstance(params, ProbingMLP) else params_from_jax(params)
        self.mlp = mlp.to(dev).eval()

    # ---------- probing ----------

    @torch.no_grad()
    def _probe_dev(self, q: torch.Tensor) -> torch.Tensor:
        d = l2_to_centroids(q, self.centroids)
        return self.mlp((d - self.scaler_mean) / self.scaler_scale, q)

    def probe(self, queries: np.ndarray) -> np.ndarray:
        """Per-partition probing probabilities (B, n_bkt)."""
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        return self._probe_dev(q).cpu().numpy()

    def select_buckets(self, outputs: np.ndarray, threshold: float) -> np.ndarray:
        """score ≥ threshold with argmax fallback (C++ engine semantics)."""
        probed = outputs >= threshold
        empty = ~probed.any(axis=1)
        if empty.any():
            probed[empty, outputs[empty].argmax(axis=1)] = True
        return probed

    @torch.no_grad()
    def _select_probed(self, queries, threshold: float) -> np.ndarray:
        """(B, n_bkt) bool probed mask — dense, or capped to the top
        probe_cap buckets (the blocked scan's own selection rule)."""
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        if self.probe_cap is None:
            return self.select_buckets(self._probe_dev(q).cpu().numpy(), threshold)
        m = min(self.probe_cap, self.layout.n_bkt)
        vals, idx = top_k(self._probe_dev(q), m)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        valid = vals >= threshold
        valid[:, 0] = True  # argmax fallback: the top-1 bucket is always probed
        B = len(vals)
        probed = np.zeros((B, self.layout.n_bkt), dtype=bool)
        rows = np.repeat(np.arange(B), valid.sum(axis=1))
        probed[rows, idx[valid]] = True
        return probed

    # ---------- end-to-end search ----------

    def search(self, queries: np.ndarray, threshold: float, k: int) -> SearchResult:
        """Probe + selective exact scan + top-k for one query batch."""
        from .block_scan import blocked_search

        t0 = time.perf_counter()
        queries = np.asarray(queries, np.float32)
        if len(queries) == 0:
            return self._empty_result(k, t0)
        scores, ids, nprobe, ndis = blocked_search(
            self._block_state, self, queries, threshold, k * self.n_mul, k,
            block_q=self.block_q, margin=self.block_margin,
            sel_rows=self.block_sel_rows, wire=self.wire,
        )
        return SearchResult(ids=ids, scores=scores, nprobe=nprobe, ndis=ndis,
                            elapsed=time.perf_counter() - t0)

    def search_stream(self, queries: np.ndarray, threshold: float, k: int,
                      batch_size: int = 65536) -> SearchResult:
        """Sustained-throughput search over a large query set in `batch_size`
        batches, pipelined (block_scan.blocked_search_stream); results equal
        per-batch `search` calls concatenated."""
        from .block_scan import blocked_search_stream

        t0 = time.perf_counter()
        queries = np.asarray(queries, np.float32)
        if len(queries) == 0:
            return self._empty_result(k, t0)
        scores, ids, nprobe, ndis = blocked_search_stream(
            self._block_state, self, queries, threshold, k * self.n_mul, k,
            batch_size=batch_size, block_q=self.block_q, margin=self.block_margin,
            sel_rows=self.block_sel_rows, wire=self.wire,
        )
        return SearchResult(ids=ids, scores=scores, nprobe=nprobe, ndis=ndis,
                            elapsed=time.perf_counter() - t0)

    def _empty_result(self, k: int, t0: float) -> SearchResult:
        return SearchResult(
            ids=np.empty((0, k), np.int32), scores=np.empty((0, k), np.float32),
            nprobe=np.empty(0, np.int64), ndis=np.empty(0, np.int64),
            elapsed=time.perf_counter() - t0,
        )

    def recall_against(self, result_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> np.ndarray:
        """Per-query recall@k vs ground truth; -1 padding in gt never counts."""
        gt = gt_ids[:, :k]
        hits = ((result_ids[:, :, None] == gt[:, None, :]) & (gt[:, None, :] >= 0)).any(axis=1)
        return hits.sum(axis=1) / float(k)

    def sweep(self, queries: np.ndarray, gt_ids: np.ndarray, k: int,
              thresholds: np.ndarray, warmup: bool = True) -> list[dict]:
        """Measured sweep: recall / nprobe / ndis / QPS per threshold.  Each
        threshold runs once untimed first when `warmup` (first-touch
        allocations and kernel builds stay out of the timed pass)."""
        n_q = len(queries)
        rows = []
        for thr in thresholds:
            if warmup:
                self.search(queries, float(thr), k)
            res = self.search(queries, float(thr), k)
            recall = self.recall_against(res.ids, gt_ids, k)
            rows.append({
                "threshold": float(thr),
                "avg_recall": float(recall.mean()),
                "avg_nprobe": float(res.nprobe.mean()),
                "avg_cmp": float(res.ndis.mean()),
                "avg_time": res.elapsed / n_q,
                "qps": n_q / res.elapsed,
            })
        return rows
