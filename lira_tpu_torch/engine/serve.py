"""Batched serving engine: probe → select → scan → top-k (port of
lira_tpu/engine/serve.py).

  1. distance features: sqrt-L2 to centroids, standardized
  2. probing MLP forward — or a caller's `prober` (queries → (B, n_bkt)
     scores), e.g. the IVF baseline's `ivf_probe_matrix`
  3. bucket selection: score ≥ threshold, argmax fallback when empty
  4. exact scan of the probed buckets only, by one of three paths:
       'blocked' — the throughput path: query blocks share one pass of
         their union (engine/block_scan.py, the K1 screen); f32, bf16 and
         int8 screens, and CAPACITY mode (store_f32=False: one bf16/int8
         table serves both rounds, re-ranked exactly on the host)
       'xla'     — per query: each query streams only its own probed
         tiles, a plain-torch gather + product + running top-k
         (`_scan_probed_tiles`)
       'pallas'  — per query through K3 (engine/pallas_scan.py, CUDA on
         the card); fetches wider than 128 go to the 'xla' scan
     The per-query paths over-fetch in bf16 and re-rank on the host in f32.
  5. ndis accounting uses true (unpadded) bucket sizes

`search` and `search_stream` are the root spans of `profiling.span`, one a
call; the blocked path's phases are spans of engine/block_scan.py, the
per-query path's `probe`, `tiles`, `scan`, `collect`, `rerank` and `dedup`.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, true_fp32
from ..labels.scaler import StandardScaler
from ..models.probing_mlp import ProbingMLP, params_from_jax
from ..ops.distance import l2_to_centroids, row_sqnorms
from ..ops.topk import top_k
from ..partition.assign import BucketLayout
from ..profiling import span
from .screen import SEL_ROWS

_SCAN_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8,
}
# (B, tiles, tile, d) f32 elements the xla scan gathers per step
_XLA_STEP_BUDGET = 1 << 26


def default_block_sel_rows(scan_dtype) -> int:
    """The blocked engine's selection granularity when none is given: 64
    rows a group for the f32 screen, 32 for bf16 and int8."""
    dt = _SCAN_DTYPES[scan_dtype] if isinstance(scan_dtype, str) else scan_dtype
    return 64 if dt == torch.float32 else 32


@torch.no_grad()
@true_fp32()
def _scan_probed_tiles(
    q: torch.Tensor,  # (B, d) f32
    tile_idx: torch.Tensor,  # (B, T) int32, -1 = no tile
    corpus: torch.Tensor,  # (n_tiles, tile, d) bucket-contiguous padded corpus
    corpus_ids: torch.Tensor,  # (n_tiles, tile) global ids, -1 = padding
    corpus_sq: torch.Tensor,  # (n_tiles, tile) row norms (inf at padding)
    k: int,
    metric: str,
):
    """Running top-k over each query's probed tiles.  lira_tpu merges one
    tile per step; this merges a few at a time (bounded by
    _XLA_STEP_BUDGET).  With lax.top_k's tie rule (lower index first) the
    result is the same: the running best always precedes the new rows, and
    a stable top-k of a stable top-k's output and the next rows is the
    stable top-k of everything so far.  bf16 rows are widened exactly."""
    B, T = tile_idx.shape
    tile, d = corpus.shape[1], corpus.shape[2]
    step = max(1, _XLA_STEP_BUDGET // max(B * tile * d, 1))
    best_neg = torch.full((B, k), -torch.inf, device=q.device)
    best_id = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    qf = q.float()[:, :, None]
    for t0 in range(0, T, step):
        idx = tile_idx[:, t0 : t0 + step].long()
        c = idx.shape[1]
        safe = idx.clamp_min(0)
        vec = corpus[safe].float().view(B, c * tile, d)
        ids = corpus_ids[safe]  # (B, c, tile)
        dot = torch.bmm(vec, qf).view(B, c, tile)
        score = -dot if metric == "inner_product" else corpus_sq[safe] - 2.0 * dot
        dead = (idx[:, :, None] < 0) | (ids < 0)
        neg = torch.where(dead, -torch.inf, -score).view(B, c * tile)
        merged_neg = torch.cat([best_neg, neg], dim=1)
        merged_id = torch.cat([best_id, ids.view(B, c * tile)], dim=1)
        best_neg, sel = top_k(merged_neg, k)
        best_id = torch.gather(merged_id, 1, sel)
    return -best_neg, best_id


def _dedup_topk(ids: np.ndarray, scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Keep the first occurrence of each id per row, compress, truncate to k
    (own copy of lira_tpu's).  A point replicated into several probed
    buckets is scanned once per bucket; the scan keeps extra slots and this
    returns k *distinct* neighbours, -1 / inf past the last one."""
    B, m = ids.shape
    order = np.argsort(ids, axis=1, kind="stable")
    sorted_ids = np.take_along_axis(ids, order, axis=1)
    dup_sorted = np.zeros_like(sorted_ids, dtype=bool)
    dup_sorted[:, 1:] = (sorted_ids[:, 1:] == sorted_ids[:, :-1]) & (sorted_ids[:, 1:] >= 0)
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    keep = ~dup & (ids >= 0)
    # stable-compress kept entries to the front (rows already score-sorted)
    comp = np.argsort(~keep, axis=1, kind="stable")
    out_ids = np.take_along_axis(ids, comp, axis=1)[:, :k]
    out_scores = np.take_along_axis(scores, comp, axis=1)[:, :k]
    n_keep = keep.sum(axis=1)
    slot = np.arange(k)[None, :]
    out_ids = np.where(slot < n_keep[:, None], out_ids, -1)
    out_scores = np.where(slot < n_keep[:, None], out_scores, np.inf)
    return out_ids.astype(np.int32), out_scores.astype(np.float32)


def rerank_exact_host(x_d: np.ndarray, metric: str, queries: np.ndarray,
                      ids: np.ndarray, x_sq: np.ndarray | None = None,
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Exact f32 ranking of fetched candidates from the raw host corpus
    (own copy of lira_tpu's): the bf16 per-query paths' and capacity mode's
    final correction pass.  -1 slots carry +inf and sort last.  f32 batched
    GEMV, as the device scores it corrects are f32.  `x_sq`: optional
    precomputed row squared norms."""
    safe = np.maximum(ids, 0)
    vec = x_d[safe]  # (B, m, d) f32
    q = queries.astype(np.float32, copy=False)
    dot = np.matmul(vec, q[:, :, None])[..., 0]  # (B, m) batched GEMV
    if metric == "inner_product":
        exact = -dot
    else:
        sq = x_sq[safe] if x_sq is not None else np.einsum(
            "bmd,bmd->bm", vec, vec, optimize=True
        )
        exact = sq - 2.0 * dot
    exact = np.where(ids >= 0, exact.astype(np.float32), np.float32(np.inf))
    order = np.argsort(exact, axis=1, kind="stable")
    return (
        np.take_along_axis(ids, order, axis=1),
        np.take_along_axis(exact, order, axis=1),
    )


@dataclass
class SearchResult:
    ids: np.ndarray  # (B, k) int32 global ids (-1 = missing)
    scores: np.ndarray  # (B, k) ranking scores
    nprobe: np.ndarray  # (B,) buckets probed
    ndis: np.ndarray  # (B,) true distance computations
    elapsed: float  # wall seconds for the whole batch (device time included)


class QueryEngine:
    """End-to-end query engine over a built LIRA index."""

    def __init__(
        self,
        x_d: np.ndarray,
        layout: BucketLayout,
        centroids: np.ndarray,
        scaler: StandardScaler,
        params,  # ProbingMLP, or a lira_tpu parameter tree (converted)
        metric: str = "L2",
        n_mul: int = 2,
        scan_impl: str = "auto",  # 'auto' (= 'blocked') | 'blocked' | 'xla' | 'pallas'
        scan_dtype: str = "float32",  # 'float32' | 'bfloat16' | 'int8'
        probe_cap: int | None = None,  # top-M bucket selection on the device
        block_q: int = 1024,  # blocked scan: queries per union block
        block_margin: int | None = None,  # blocked scan: extra selection groups
        prober=None,  # optional queries -> (B, n_bkt) host scores, replacing the MLP
        block_sel_rows: int | None = None,  # blocked scan: selection granularity
        wire: str = "pack32",  # 'pack32' | 'f32' (identical bits) | 'bf16'
        store_f32: bool = True,  # False (blocked bf16/int8) = capacity mode
        device=None,
    ):
        """scan_impl:
          'blocked' — throughput path: query blocks share one pass of their
            union's tiles (engine/block_scan.py).  'auto' is 'blocked' on
            every device (lira_tpu picks 'xla' off the TPU because its
            Pallas kernels run interpreted there; the port's K1 runs on the
            card and its plain version on the CPU).
          'xla'/'pallas' — per-query paths: bytes = each query's own padded
            ndis; bf16 over-fetches 16 slots and re-ranks on the host.
        store_f32=False (capacity mode, blocked bf16/int8 only): one
        bf16/int8 table serves both rounds, 0.5×/0.25× the padded corpus on
        the device; the host re-ranks the over-fetched candidates in f32."""
        if scan_impl == "auto":
            scan_impl = "blocked"
        if scan_impl not in ("blocked", "xla", "pallas"):
            raise ValueError(
                f"scan_impl={scan_impl!r}: expected 'auto', 'blocked', 'xla' or 'pallas'"
            )
        if str(scan_dtype) not in _SCAN_DTYPES:
            raise ValueError(f"scan_dtype={scan_dtype!r}: expected float32, bfloat16 or int8")
        self.scan_dtype = _SCAN_DTYPES[str(scan_dtype)]
        if self.scan_dtype == torch.int8 and scan_impl != "blocked":
            raise ValueError(
                "scan_dtype='int8' is a blocked-scan screen mode (the "
                "per-query xla/pallas paths have no quantized round 1); "
                "use scan_impl='blocked'"
            )
        if not store_f32 and not (
            self.scan_dtype in (torch.bfloat16, torch.int8) and scan_impl == "blocked"
        ):
            raise ValueError(
                "store_f32=False (capacity mode) requires scan_impl='blocked' "
                "with scan_dtype='bfloat16' or 'int8' — the approximate table "
                "is the only corpus copy, so both rounds must be able to read it"
            )
        if wire not in ("pack32", "f32", "bf16"):
            raise ValueError(f"wire={wire!r}: expected 'pack32', 'f32' or 'bf16'")
        self.device = dev = resolve_device(device)
        self.metric = metric
        self.n_mul = max(1, n_mul)
        self.scan_impl = scan_impl
        self.probe_cap = probe_cap
        self.store_f32 = store_f32
        # capacity over-fetch slack for the host f32 re-rank: +16 distinct
        # slots absorbs bf16 rank jitter (the per-query bf16 rule); int8
        # quantization error is coarser, so double it
        self.capacity_slack = 32 if self.scan_dtype == torch.int8 else 16
        self.wire = wire
        self.block_q = block_q
        self.block_margin = block_margin
        if block_sel_rows is None:
            block_sel_rows = default_block_sel_rows(self.scan_dtype)
        if block_sel_rows not in SEL_ROWS:
            raise ValueError(f"block_sel_rows={block_sel_rows}: must be a divisor of 128")
        self.block_sel_rows = block_sel_rows
        self.prober = prober  # e.g. engine.ivf_baseline.ivf_probe_matrix for
        # the LIRA-vs-IVF comparison on an identical layout
        self.tile = layout.tile  # 128 for blocked/pallas; any for xla
        self.layout = layout
        x_d = np.asarray(x_d, dtype=np.float32)
        self._x_d = x_d  # the host re-rank's exact rows
        self._x_sq = None

        self.tile_start = (layout.padded_offsets[:-1] // self.tile).astype(np.int64)
        self.tiles_per_bucket = (layout.padded_sizes // self.tile).astype(np.int64)
        self.sizes = layout.sizes  # true ndis per bucket
        self.sizes_dev = torch.as_tensor(self.sizes, dtype=torch.int64, device=dev)

        if scan_impl == "blocked":
            from ..partition.order import centroid_tour_rank
            from .block_scan import BlockScanState

            if self.tile != 128:
                # K1's supertiles, group minima and norm/id reshapes are all
                # built on 128-row tiles
                raise ValueError(
                    f"scan_impl='blocked' requires a 128-row tile layout "
                    f"(got tile={self.tile}); use scan_impl='xla' for other tiles"
                )
            # locality relabeling for the query-grouping sort (grouping
            # strategy only — per-query results and ndis are rank-invariant)
            self.bucket_rank_dev = torch.as_tensor(
                centroid_tour_rank(np.asarray(centroids, np.float32)), dtype=torch.int64,
                device=dev,
            )
            tile_bucket = np.repeat(
                np.arange(layout.n_bkt, dtype=np.int32), self.tiles_per_bucket
            )
            self._block_state = BlockScanState.from_corpus(
                x_d, layout.padded_ids, tile_bucket, metric, self.scan_dtype,
                tile=self.tile, store_f32=store_f32, device=dev,
            )
            self.corpus = self.corpus_ids = self.corpus_sq = None
        else:
            if scan_impl == "pallas" and self.tile != 128:
                raise ValueError(
                    f"scan_impl='pallas' requires a 128-row tile layout (K3 scores "
                    f"128-row tiles, a thread a row; got tile={self.tile}); "
                    f"use scan_impl='xla' for other tiles"
                )
            padded = layout.gather_vectors(x_d)  # (padded_total, dim)
            n_tiles = padded.shape[0] // self.tile
            ids = layout.padded_ids.reshape(n_tiles, self.tile)
            # norms of the f32 rows, before any bf16 cast; inf at padding
            sq = row_sqnorms(padded).reshape(n_tiles, self.tile)
            sq = np.where(ids >= 0, sq, np.inf).astype(np.float32)
            self.corpus = torch.as_tensor(
                padded.reshape(n_tiles, self.tile, x_d.shape[1]), device=dev
            ).to(self.scan_dtype)
            self.corpus_ids = torch.as_tensor(ids, device=dev)
            self.corpus_sq = torch.as_tensor(sq, device=dev)
            del padded
        self._pallas_corpus = self._pallas_sq = None

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
        """(B, n_bkt) bool probed mask — a custom prober's, dense, or capped
        to the top probe_cap buckets (the blocked scan's own selection
        rule).  Feeds the per-query paths and the oracle checks."""
        queries = np.asarray(queries, np.float32)
        if self.prober is not None:
            outputs = np.asarray(self.prober(queries))
            return self.select_buckets(outputs, threshold)
        q = torch.as_tensor(queries, device=self.device)
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

    # ---------- probed-tile list construction ----------

    def _probe_tiles(self, probed: np.ndarray) -> np.ndarray:
        """(B, T) tile-index lists of each query's probed buckets, valid
        tiles first in bucket order, -1 after; T is the pow2 ceiling of the
        longest list.  The native OpenMP expander (lira_tpu_torch/native)
        when it is available, else lira_tpu's numpy branch (the same lists)."""
        from .. import native

        if native.available():
            return native.probe_tiles(probed, self.tile_start, self.tiles_per_bucket)
        B = probed.shape[0]
        rows, bs = np.nonzero(probed)
        reps = self.tiles_per_bucket[bs]
        total = int(reps.sum())
        if total == 0:
            return np.full((B, 1), -1, dtype=np.int32)
        starts_rep = np.repeat(self.tile_start[bs], reps)
        cum = np.cumsum(reps) - reps
        within = np.arange(total, dtype=np.int64) - np.repeat(cum, reps)
        tiles_flat = (starts_rep + within).astype(np.int32)
        rows_flat = np.repeat(rows, reps)

        per_row = np.bincount(rows_flat, minlength=B)
        T = int(per_row.max())
        T = 1 << int(np.ceil(np.log2(max(T, 1))))  # pow2: few distinct shapes
        out = np.full((B, T), -1, dtype=np.int32)
        row_start = np.cumsum(per_row) - per_row
        pos = np.arange(total, dtype=np.int64) - row_start[rows_flat]
        out[rows_flat, pos] = tiles_flat
        return out

    # ---------- end-to-end search ----------

    def _scan(self, q: torch.Tensor, tiles: np.ndarray, fetch_k: int):
        tiles = torch.as_tensor(tiles, device=self.device)
        # fetch_k > 128 goes to the xla scan: lira_tpu's routing contract
        # (serve.py:404, pallas_scan.py:164-169) — a K3 slot yields at most
        # its tile's 128 rows.  It is not a fallback: no failure takes this road.
        if self.scan_impl == "pallas" and fetch_k <= 128:
            from .pallas_scan import pallas_probed_scan

            if self._pallas_corpus is None:
                # K3 reads f32 rows (the bf16-rounded values in bf16 mode)
                # and scores sq − dot (IP) / sq − 2·dot (L2): valid rows
                # carry sq = 0 under IP and the row norm under L2, padding
                # 3e38 under both
                self._pallas_corpus = self.corpus.float().contiguous()
                live = torch.isfinite(self.corpus_sq)  # inf exactly at padding
                self._pallas_sq = torch.where(
                    live, 0.0 if self.metric == "inner_product" else self.corpus_sq, 3e38)
            return pallas_probed_scan(q, tiles, self._pallas_corpus, self.corpus_ids,
                                      self._pallas_sq, fetch_k, self.metric)
        return _scan_probed_tiles(q, tiles, self.corpus, self.corpus_ids, self.corpus_sq,
                                  fetch_k, self.metric)

    def _blocked(self, queries: np.ndarray, threshold: float, k: int, stream: bool,
                 batch_size: int):
        from .block_scan import blocked_search, blocked_search_stream

        fetch_k = k * self.n_mul  # dedup slots; round 2 is f32-exact
        # capacity mode: round 2 ranked from approximate inputs — keep extra
        # distinct candidates and restore exact order on the host (+16 slots
        # absorb bf16 rank jitter, +32 int8 quantization)
        kk = k if self.store_f32 else fetch_k + self.capacity_slack
        kw = dict(block_q=self.block_q, margin=self.block_margin,
                  sel_rows=self.block_sel_rows, wire=self.wire)
        if stream:
            out = blocked_search_stream(self._block_state, self, queries, threshold,
                                        max(fetch_k, kk), kk, batch_size=batch_size, **kw)
        else:
            out = blocked_search(self._block_state, self, queries, threshold,
                                 max(fetch_k, kk), kk, **kw)
        scores, ids, nprobe, ndis = out
        if not self.store_f32:
            # exact f32 ordering from the raw host corpus; -1 slots carry
            # +inf and sort last (the per-query bf16 convention)
            ids, scores = self._rerank_f32(queries, ids, scores)
            ids, scores = ids[:, :k], scores[:, :k]
        return ids, scores, nprobe, ndis

    def search(self, queries: np.ndarray, threshold: float, k: int) -> SearchResult:
        """Probe + selective exact scan + top-k for one query batch."""
        t0 = time.perf_counter()
        with span("search"):
            queries = np.asarray(queries, np.float32)
            if len(queries) == 0:
                return self._empty_result(k, t0)
            if self.scan_impl == "blocked":
                ids, scores, nprobe, ndis = self._blocked(queries, threshold, k, False, 0)
                return SearchResult(ids=ids, scores=scores, nprobe=nprobe, ndis=ndis,
                                    elapsed=time.perf_counter() - t0)
            return self._search_unblocked(queries, threshold, k, t0)

    def search_stream(self, queries: np.ndarray, threshold: float, k: int,
                      batch_size: int = 65536) -> SearchResult:
        """Sustained-throughput search over a large query set in `batch_size`
        batches.  Blocked: pipelined (block_scan.blocked_search_stream).
        Per-query paths: sequential per-batch `search`.  Results equal
        per-batch `search` calls concatenated."""
        t0 = time.perf_counter()
        with span("search_stream"):
            queries = np.asarray(queries, np.float32)
            if len(queries) == 0:
                return self._empty_result(k, t0)
            if self.scan_impl == "blocked":
                ids, scores, nprobe, ndis = self._blocked(queries, threshold, k, True,
                                                          batch_size)
                return SearchResult(ids=ids, scores=scores, nprobe=nprobe, ndis=ndis,
                                    elapsed=time.perf_counter() - t0)
            parts = [
                self.search(queries[s : s + batch_size], threshold, k)
                for s in range(0, len(queries), batch_size)
            ]
            return SearchResult(
                ids=np.concatenate([p.ids for p in parts]),
                scores=np.concatenate([p.scores for p in parts]),
                nprobe=np.concatenate([p.nprobe for p in parts]),
                ndis=np.concatenate([p.ndis for p in parts]),
                elapsed=time.perf_counter() - t0,
            )

    def _empty_result(self, k: int, t0: float) -> SearchResult:
        return SearchResult(
            ids=np.empty((0, k), np.int32), scores=np.empty((0, k), np.float32),
            nprobe=np.empty(0, np.int64), ndis=np.empty(0, np.int64),
            elapsed=time.perf_counter() - t0,
        )

    def _search_unblocked(self, queries: np.ndarray, threshold: float, k: int, t0: float):
        with span("probe"):
            probed = self._select_probed(queries, threshold)
        with span("tiles"):
            tiles = self._probe_tiles(probed)
        bf16 = self.scan_dtype == torch.bfloat16
        # scan with n_mul × k slots so replicas can be deduplicated to k
        # distinct; bf16 mode over-fetches extra slots for the f32 re-rank
        fetch_k = k * self.n_mul + (16 if bf16 else 0)

        # fixed-size blocks over count-sorted queries: each block scans at
        # the pow2 ceiling of its own max tile count.  lira_tpu fetches each
        # block's result to the host; here the blocks write into one device
        # buffer, fetched once — the same values, one transfer per batch.
        B = len(queries)
        with span("scan"):
            counts = (tiles >= 0).sum(axis=1)
            block = min(2048, max(8, 1 << int(np.ceil(np.log2(max(B, 1))))))
            order = np.argsort(counts, kind="stable")
            dev = self.device
            q_dev = torch.as_tensor(queries, device=dev)
            ids_dev = torch.empty((B, fetch_k), dtype=torch.int32, device=dev)
            scores_dev = torch.empty((B, fetch_k), dtype=torch.float32, device=dev)
            for s in range(0, B, block):
                sel = order[s : s + block]
                n = len(sel)
                t_val = max(1, 1 << int(np.ceil(np.log2(max(int(counts[sel].max()), 1)))))
                full = sel
                if n < block:  # pad the tail block to the fixed size
                    full = np.concatenate([sel, np.zeros(block - n, dtype=sel.dtype)])
                tiles_blk = tiles[full, :t_val]  # fancy indexing: a copy
                tiles_blk[n:] = -1
                sc, gid = self._scan(q_dev[torch.as_tensor(full, device=dev)], tiles_blk,
                                     fetch_k)
                sel_dev = torch.as_tensor(sel, device=dev)
                ids_dev[sel_dev] = gid[:n].to(torch.int32)
                scores_dev[sel_dev] = sc[:n]
        with span("collect"):
            ids, scores = ids_dev.cpu().numpy(), scores_dev.cpu().numpy()

        if bf16:
            ids, scores = self._rerank_f32(queries, ids, scores)
        with span("dedup"):
            ids, scores = _dedup_topk(ids, scores, k)
        return SearchResult(
            ids=ids,
            scores=scores,
            nprobe=probed.sum(axis=1),
            ndis=(probed @ self.sizes.astype(np.int64)),
            elapsed=time.perf_counter() - t0,
        )

    def _rerank_f32(self, queries: np.ndarray, ids: np.ndarray, scores: np.ndarray):
        with span("rerank"):
            if self.metric != "inner_product" and self._x_sq is None:
                # one O(n·d) pass, reused by every later re-rank call
                self._x_sq = np.einsum("nd,nd->n", self._x_d, self._x_d,
                                       optimize=True).astype(np.float32)
            return rerank_exact_host(self._x_d, self.metric, queries, ids, x_sq=self._x_sq)

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
