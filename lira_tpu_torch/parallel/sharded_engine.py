"""Sharded query serving: the bucket corpus split over the ranks, each
rank's top-k merged by one all-gather (port of
lira_tpu/parallel/sharded_engine.py).

Every rank builds the engine from the same arguments (the whole corpus,
layout, centroids, scaler and model) and keeps only its own tiles.
Placement is lira_tpu's tile-granular one: the global concatenated tile
sequence (buckets in id order) is cut into `size` near-equal contiguous
segments, so rank s holds exactly lira_tpu's device shard s, and a skewed
bucket distribution is spread over the ranks instead of pinning one
rank's table to the skew.  Queries are replicated: every rank runs the
probe (or the caller's prober) and gets the same probed mask, block
grouping and nprobe/ndis, then scans its own tiles of each block's union:

  'pallas' — the single-chip blocked scan (engine/block_scan.py
             `_screen_rescore`): the K1 screen over the rank's local
             supertiles, masked group selection, exact f32 rescore
             (needs 128-row tiles);
  'gather' — plain torch, any tile: a streamed tile-granular group-min
             screen (f32, or bf16 values in f32) and an exact rescore of
             the selected tiles.

`_ici_merge` then pads each rank's candidates to fetch_k, all-gathers
them, takes the top fetch_k, dedups replicated points to k distinct
neighbours and un-permutes: every rank returns the same SearchResult.
bf16 and int8 screens take round 1 only; int8 uses ONE per-dim scale of
the whole corpus so every rank's scores are commensurable at the merge.
Capacity mode (store_f32=False) keeps one bf16/int8 table per rank and
re-ranks the merged over-fetch exactly on the host.

`serve_rank` is the rank-side entry point `launch` runs: it builds the
engine and answers a list of requests.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..engine.block_scan import (
    S_TILES,
    BlockScanState,
    _dedup_topk_dev,
    _pow2ceil,
    _probe_batch,
    _resolve_margin,
    _screen_rescore,
    _to_host_async,
    _wait,
    build_block_unions,
)
from ..engine.serve import _SCAN_DTYPES, QueryEngine, SearchResult
from ..labels.scaler import StandardScaler
from ..models.probing_mlp import ProbingMLP, params_from_jax
from ..ops.distance import l2_to_centroids
from ..ops.topk import top_k
from ..partition.assign import BucketLayout
from .mesh import Mesh

_BIG = 3e38
_GATHER_BUDGET = 256 << 20  # bytes of the gather path's rescore staging per step


def _ici_merge(neg, out_ids, k_loc: int, fetch_k: int, k: int, perm, mesh: Mesh):
    """Pad this rank's candidates to fetch_k, gather every rank's, re-rank,
    dedup to k distinct neighbours, un-permute to caller order.  The pad
    keeps the merge uniform when a rank holds fewer than fetch_k
    candidates (a small or skewed shard)."""
    B = neg.shape[0]
    if k_loc < fetch_k:
        pad = fetch_k - k_loc
        neg = torch.cat([neg, neg.new_full((B, pad), -torch.inf)], dim=1)
        out_ids = torch.cat([out_ids, out_ids.new_full((B, pad), -1)], dim=1)
    # rank order, then lax.top_k's tie rule (lower rank first among equals)
    flat_neg = torch.cat(mesh.all_gather(neg.float()), dim=1)  # (B, size·fetch_k)
    flat_ids = torch.cat(mesh.all_gather(out_ids.to(torch.int64)), dim=1)
    best_neg, msel = top_k(flat_neg, fetch_k)
    best_ids = torch.gather(flat_ids, 1, msel)
    ded_ids, ded_neg = _dedup_topk_dev(best_ids, best_neg, k)
    out_scores = torch.empty_like(ded_neg)
    out_scores[perm] = -ded_neg
    final_ids = torch.empty_like(ded_ids)
    final_ids[perm] = ded_ids
    return out_scores, final_ids


@torch.no_grad()
def _local_scan_gather(q_perm, probed_p, sel, tb, corpus_r1, corpus, bsq, ids, *,
                       fetch_k: int, kg: int, metric: str, chunk: int, sub: int):
    """The rank's blocked union scan in plain torch, any tile size.

    q_perm (B_pad, d) f32 and probed_p (n_blocks, qb, n_bkt) in block order;
    sel/tb (n_blocks, U) local union tiles and their buckets (−1 pad);
    corpus_r1 / corpus (t_pad, tile, d): round-1 (f32 or bf16) and round-2
    (f32; bf16 in capacity mode) tables; bsq/ids (t_pad, tile).
    Returns (neg (B_pad, k_loc), ids (B_pad, k_loc), k_loc) in block order."""
    n_blocks, U = sel.shape
    qb = probed_p.shape[1]
    tile, d = corpus.shape[1], corpus.shape[2]
    kg_eff = min(kg, U)
    k_loc = min(fetch_k, kg_eff * tile)
    q_blocks = q_perm.view(n_blocks, qb, d)
    # bf16 values widen exactly: round 1 multiplies them in f32
    q_r1_blocks = q_blocks.to(corpus_r1.dtype).float()
    negs, oids = [], []
    for b in range(n_blocks):
        qs, qs1, sl, tbb = q_blocks[b], q_r1_blocks[b], sel[b], tb[b]
        # round 1: streamed group-min over the block's local union
        gmins = []
        for i in range(0, U, chunk):
            s = sl[i : i + chunk]
            safe = s.clamp_min(0)
            vec = corpus_r1[safe].float().reshape(len(s) * tile, d)
            sq = bsq[safe].reshape(1, len(s) * tile)
            dot = qs1 @ vec.T
            scores = sq - dot if metric == "inner_product" else sq - 2.0 * dot
            gmin = scores.view(qb, len(s), tile).amin(dim=2)
            gmins.append(gmin + torch.where(s < 0, _BIG, 0.0)[None, :])
        gmin = torch.cat(gmins, dim=1)  # (qb, U)
        # a query sees only tiles of buckets it probed; row n_bkt: padding
        pen_b = torch.where(probed_p[b].T, 0.0, _BIG).float()  # (n_bkt, qb)
        pen_b = torch.cat([pen_b, pen_b.new_full((1, qb), _BIG)], dim=0)
        tbx = torch.where(tbb >= 0, tbb, pen_b.shape[0] - 1).long()
        masked = gmin + pen_b[tbx].T
        vals, usel = top_k(-masked, kg_eff)
        gsel = sl[usel].clamp_min(0)  # (qb, kg_eff)
        valid = vals > -(_BIG / 2)
        # round 2: exact rescan of the selected tiles, `sub` queries a step
        for s0 in range(0, qb, sub):
            rqs, sg, val = qs[s0 : s0 + sub], gsel[s0 : s0 + sub], valid[s0 : s0 + sub]
            n = rqs.shape[0]
            vec = corpus[sg].float().view(n, kg_eff * tile, d)
            dotr = torch.bmm(vec, rqs[:, :, None]).view(n, kg_eff, tile)
            sqr = bsq[sg]
            sc = sqr - dotr if metric == "inner_product" else sqr - 2.0 * dotr
            idg = ids[sg]
            sc = sc + torch.where(val, 0.0, _BIG)[:, :, None]
            sc = torch.where(idg >= 0, sc, _BIG)
            neg, pos = top_k(-sc.reshape(n, kg_eff * tile), k_loc)
            oid = torch.gather(idg.reshape(n, kg_eff * tile), 1, pos)
            negs.append(neg)
            oids.append(torch.where(neg > -(_BIG / 2), oid, -1))
    return torch.cat(negs), torch.cat(oids), k_loc


class ShardedQueryEngine:
    """QueryEngine with the bucket corpus sharded over the ranks of `mesh`."""

    def __init__(
        self,
        x_d: np.ndarray,
        layout: BucketLayout,
        centroids: np.ndarray,
        scaler: StandardScaler,
        params,  # ProbingMLP, or a lira_tpu parameter tree (converted)
        mesh: Mesh,
        metric: str = "L2",
        n_mul: int = 2,
        probe_cap: int | None = None,
        block_q: int = 1024,
        margin: int | None = None,
        scan_dtype: str = "float32",
        prober=None,
        local_impl: str = "auto",  # 'auto' | 'pallas' (K1) | 'gather'
        sel_rows: int | None = None,  # 'pallas' selection granularity
        # (None: 64 rows f32, 32 bf16/int8)
        store_f32: bool = True,  # False (bf16 or int8) = CAPACITY mode
    ):
        """`scan_dtype='bfloat16'`/`'int8'` screens round 1 in that dtype
        (the margin absorbs the rounding; round 2 rescans in exact f32);
        `prober(q) -> (B, n_bkt)` replaces the probing MLP; `local_impl`
        'auto' takes 'pallas' when the tile is 128 and the rank's device is
        the card, else 'gather'."""
        self.mesh = mesh
        self.device = dev = mesh.device
        self.metric = metric
        self.n_mul = max(1, n_mul)
        self.probe_cap = probe_cap
        self.block_q = block_q
        self.layout = layout
        self.tile = layout.tile
        if str(scan_dtype) not in _SCAN_DTYPES:
            raise ValueError(f"scan_dtype={scan_dtype!r}: expected float32, bfloat16 or int8")
        self.scan_dtype = _SCAN_DTYPES[str(scan_dtype)]
        if sel_rows is None:
            sel_rows = 64 if self.scan_dtype == torch.float32 else 32
        self.sel_rows = sel_rows  # a divisor of 128: _resolve_margin checks it below
        if not store_f32 and self.scan_dtype not in (torch.bfloat16, torch.int8):
            raise ValueError(
                "store_f32=False (capacity mode) requires scan_dtype='bfloat16' or "
                "'int8' — the approximate table is the only corpus copy")
        self.store_f32 = store_f32
        # capacity over-fetch slack for the host re-rank after the merge:
        # 16 absorbs bf16 rank jitter; int8 quantization error is coarser
        self.capacity_slack = 32 if self.scan_dtype == torch.int8 else 16
        self.prober = prober
        if local_impl == "auto":
            local_impl = "pallas" if (self.tile == 128 and dev.type == "cuda") else "gather"
        if local_impl not in ("pallas", "gather"):
            raise ValueError(f"local_impl={local_impl!r}: expected 'auto', 'pallas' or 'gather'")
        if local_impl == "pallas" and self.tile != 128:
            raise ValueError("local_impl='pallas' needs a 128-row tile layout")
        if self.scan_dtype == torch.int8 and local_impl != "pallas":
            raise ValueError(
                "scan_dtype='int8' needs local_impl='pallas' (the gather path casts "
                "queries to the round-1 dtype, which is meaningless for a quantized "
                "corpus)")
        self.local_impl = local_impl
        if margin is None and local_impl == "gather":
            # the gather path selects whole tiles: bf16 keeps the flat 8
            margin = 8
        self.margin = _resolve_margin(margin, self.scan_dtype, sel_rows)

        x_d = np.asarray(x_d, dtype=np.float32)
        self._x_d = x_d  # the capacity re-rank's exact rows
        self._x_sq = None
        self.tiles_per_bucket = (layout.padded_sizes // self.tile).astype(np.int64)
        self.sizes = layout.sizes
        self.sizes_dev = torch.as_tensor(self.sizes, dtype=torch.int64, device=dev)

        # tile-granular placement: the global tile sequence cut into `size`
        # near-equal contiguous segments (lira_tpu's, so rank s = device s)
        nt_all = self.tiles_per_bucket
        gstart = np.concatenate([[0], np.cumsum(nt_all)]).astype(np.int64)
        total_tiles = int(gstart[-1])
        bounds = np.round(np.linspace(0, total_tiles, mesh.size + 1)).astype(np.int64)
        t_pad = max(int(np.diff(bounds).max()), 1)
        t_pad = -(-t_pad // S_TILES) * S_TILES  # whole supertiles for K1
        self.t_pad = t_pad
        lo, hi = int(bounds[mesh.rank]), int(bounds[mesh.rank + 1])
        ov_lo = np.maximum(lo, gstart[:-1])
        ov_hi = np.minimum(hi, gstart[1:])
        cnt = np.maximum(ov_hi - ov_lo, 0)
        self.local_tile_count = cnt  # (n_bkt,) this rank's tiles of each bucket
        self.local_tile_start = np.where(cnt > 0, ov_lo - lo, -1)  # local tile index
        # this rank's tiles: global tiles [lo, hi) of the bucket-contiguous
        # padded layout, then empty tiles up to t_pad
        tile = self.tile
        local_ids = np.full(t_pad * tile, -1, np.int32)
        local_ids[: (hi - lo) * tile] = layout.padded_ids[lo * tile : hi * tile]
        tile_bucket = np.full(t_pad, -1, np.int32)
        tile_bucket[: hi - lo] = np.repeat(np.arange(layout.n_bkt, dtype=np.int32),
                                           nt_all)[lo:hi]
        int8_scale = None
        if self.scan_dtype == torch.int8:
            # ONE per-dim scale of the whole corpus (a host O(n·d) pass): every
            # rank's integer scores are then commensurable before the merge
            int8_scale = (np.maximum(np.abs(x_d).max(axis=0), 1e-30) / 127.0).astype(np.float32)
        self._state = BlockScanState.from_corpus(
            x_d, local_ids, tile_bucket, metric, self.scan_dtype, tile=tile,
            store_f32=store_f32, device=dev, int8_scale=int8_scale,
        )

        from ..partition.order import centroid_tour_rank

        self.centroids = torch.tensor(np.asarray(centroids, np.float32), device=dev)
        self.scaler_mean = torch.tensor(np.asarray(scaler.mean_, np.float32), device=dev)
        self.scaler_scale = torch.tensor(np.asarray(scaler.scale_, np.float32), device=dev)
        # locality relabeling for the query-grouping sort: grouping only,
        # per-query results and ndis are rank-invariant
        self.bucket_rank_dev = torch.as_tensor(
            centroid_tour_rank(np.asarray(centroids, np.float32)), dtype=torch.int64,
            device=dev)
        # a copy: Module.to moves in place, and the caller's model may serve
        # another engine on another device
        model = copy.deepcopy(params) if isinstance(params, ProbingMLP) else params_from_jax(params)
        self.mlp = model.to(dev).eval()

    # ---------- probing ----------

    @torch.no_grad()
    def probe(self, queries: np.ndarray) -> np.ndarray:
        """Per-partition probing probabilities (B, n_bkt)."""
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        d = l2_to_centroids(q, self.centroids)
        return self.mlp((d - self.scaler_mean) / self.scaler_scale, q).cpu().numpy()

    # QueryEngine's own: they read no more than this engine also holds
    select_buckets = QueryEngine.select_buckets
    recall_against = QueryEngine.recall_against
    _empty_result = QueryEngine._empty_result
    _rerank_f32 = QueryEngine._rerank_f32

    # ---------- scan ----------

    def _block_unions(self, union_mask: np.ndarray):
        """This rank's per-block union tile lists (tile-granular, the gather
        path): (sel (n_blocks, U) i32 local tiles, tb same, buckets; −1
        pad, chunk).  U is a pow2 multiple of the streaming chunk."""
        n_blocks = union_mask.shape[0]
        cnt = self.local_tile_count
        counts = union_mask.astype(np.int64) @ cnt
        u_max = max(1, int(counts.max()))
        chunk = min(16, _pow2ceil(u_max))
        U = max(chunk, ((u_max + chunk - 1) // chunk) * chunk)
        U = _pow2ceil(U) if U > chunk else U
        sel = np.full((n_blocks, U), -1, np.int32)
        tb = np.full((n_blocks, U), -1, np.int32)
        rows, bs = np.nonzero(union_mask & (cnt > 0)[None, :])
        reps = cnt[bs]
        total = int(reps.sum())
        if total:
            starts = np.repeat(self.local_tile_start[bs], reps)
            cum = np.cumsum(reps) - reps
            within = np.arange(total, dtype=np.int64) - np.repeat(cum, reps)
            tiles = (starts + within).astype(np.int32)
            tile_rows = np.repeat(rows, reps)
            row_counts = np.bincount(tile_rows, minlength=n_blocks)
            row_start = np.cumsum(row_counts) - row_counts
            col = np.arange(total, dtype=np.int64) - row_start[tile_rows]
            sel[tile_rows, col] = tiles
            tb[tile_rows, col] = self._state.tile_bucket[tiles]
        return sel, tb, chunk

    def _dispatch_probe(self, queries: np.ndarray, threshold: float,
                        use_cache: bool = False) -> dict:
        """Upload one batch and queue its probe; the union masks and counts
        start their copy to the host."""
        h = _probe_batch(self._state, self, queries, threshold, self.block_q,
                         use_cache=use_cache)
        h["counts"] = _to_host_async([h["union"], h["nprobe"], h["ndis"]])
        return h

    @torch.no_grad()
    def _scan(self, h: dict, k: int):
        """This rank's scan of one probed batch and the merge over the
        ranks: (scores (B_pad, k_out), ids) on the device, caller order."""
        union = _wait(h["counts"])[0]
        fetch_k = k * self.n_mul
        # capacity mode keeps extra distinct candidates through the merge;
        # exact order is restored on the host
        k_out = k if self.store_f32 else fetch_k + self.capacity_slack
        fetch_k = max(fetch_k, k_out)
        kg = fetch_k + self.margin
        st, dev, qb = self._state, self.device, h["qb"]
        perm = h["perm"]
        q_perm = h["q"][perm]
        n_blocks = union.shape[0]
        probed_p = h["probed"][perm].view(n_blocks, qb, -1)
        d = q_perm.shape[1]
        if self.local_impl == "pallas":
            supers, tb, ulen = build_block_unions(
                union, self.local_tile_start, self.local_tile_count, st.tile_bucket)
            neg, oid, k_loc = _screen_rescore(
                q_perm, probed_p, torch.as_tensor(supers, device=dev),
                torch.as_tensor(tb, device=dev), torch.as_tensor(ulen, device=dev),
                st.corpus_flat, st.bsq, st.corpus_flat_f32, st.tiles_ids,
                st.tile_pad_count, metric=self.metric, kg=kg, fetch_k=fetch_k, qb=qb,
                sel_rows=self.sel_rows, dim_scale=st.dim_scale, screen_sq=st.screen_sq,
            )
        else:
            sel, tb, chunk = self._block_unions(union)
            tile = self.tile
            budget = _GATHER_BUDGET // max(kg * tile * d * 4, 1)
            sub = 64
            while sub > 8 and sub > budget:
                sub //= 2
            neg, oid, k_loc = _local_scan_gather(
                q_perm, probed_p, torch.as_tensor(sel, device=dev).long(),
                torch.as_tensor(tb, device=dev), st.corpus_flat.view(-1, tile, d),
                st.corpus_flat_f32.view(-1, tile, d), st.bsq, st.tiles_ids,
                fetch_k=fetch_k, kg=kg, metric=self.metric, chunk=chunk, sub=min(sub, qb),
            )
        return _ici_merge(neg, oid, k_loc, fetch_k, k_out, perm, self.mesh)

    def _collect(self, h: dict, out) -> tuple:
        B = h["B"]
        scores, ids = (a.cpu().numpy() for a in out)
        _, nprobe, ndis = _wait(h["counts"])
        return (scores[:B], ids[:B].astype(np.int32), nprobe[:B].astype(np.int64),
                ndis[:B].astype(np.int64))

    def search(self, queries: np.ndarray, threshold: float, k: int) -> SearchResult:
        """One probe and one scan of the batch on every rank, merged; every
        rank returns the same result."""
        t0 = time.perf_counter()
        queries = np.asarray(queries, np.float32)
        if len(queries) == 0:
            return self._empty_result(k, t0)
        h = self._dispatch_probe(queries, threshold, use_cache=True)
        scores, ids, nprobe, ndis = self._collect(h, self._scan(h, k))
        if not self.store_f32:
            ids, scores = self._rerank_capacity(queries, ids, k)
        return SearchResult(ids=ids, scores=scores, nprobe=nprobe, ndis=ndis,
                            elapsed=time.perf_counter() - t0)

    def _rerank_capacity(self, queries: np.ndarray, ids: np.ndarray, k: int):
        """Capacity mode: exact f32 host re-rank of the merged over-fetch,
        truncated to k (QueryEngine's store_f32=False contract)."""
        ids, scores = self._rerank_f32(queries, ids, None)
        return ids[:, :k], scores[:, :k]

    def search_stream(self, queries: np.ndarray, threshold: float, k: int,
                      batch_size: int = 65536) -> SearchResult:
        """Multi-batch search, equal to per-batch `search` concatenated:
        batch i+1's upload and probe are queued before batch i's scan, so
        the host builds batch i's unions while the device probes."""
        t0 = time.perf_counter()
        queries = np.asarray(queries, np.float32)
        if len(queries) == 0:
            return self._empty_result(k, t0)
        starts = list(range(0, len(queries), batch_size))
        outs = []
        h_next = self._dispatch_probe(queries[: batch_size], threshold)
        for i in range(len(starts)):
            h = h_next
            if i + 1 < len(starts):
                s = starts[i + 1]
                h_next = self._dispatch_probe(queries[s : s + batch_size], threshold)
            outs.append(self._collect(h, self._scan(h, k)))
        scores = np.concatenate([o[0] for o in outs])
        ids = np.concatenate([o[1] for o in outs])
        if not self.store_f32:
            ids, scores = self._rerank_capacity(queries, ids, k)
        return SearchResult(
            ids=ids, scores=scores,
            nprobe=np.concatenate([o[2] for o in outs]),
            ndis=np.concatenate([o[3] for o in outs]),
            elapsed=time.perf_counter() - t0,
        )

    def sweep(self, queries, gt_ids, k, thresholds, warmup: bool = True) -> list[dict]:
        """Measured end-to-end threshold sweep (lira_tpu's: one untimed
        64-query search first when `warmup`)."""
        n_q = len(queries)
        if warmup:
            self.search(queries[: min(64, n_q)], float(thresholds[0]), k)
        rows = []
        for thr in thresholds:
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


_REQUESTS = ("search", "search_stream", "sweep")


def serve_rank(x_d, layout, centroids, scaler, params, requests, *, mesh: Mesh,
               **engine_kw) -> dict:
    """The rank-side serving entry point (`launch` runs it on every rank):
    build a ShardedQueryEngine from the same arguments on every rank and
    answer `requests`, a list of (method, args, kwargs) with method one of
    'search', 'search_stream', 'sweep'.

    Returns {"results": the answers in order (the same on every rank),
    "build_s": engine build seconds, "ranks": one dict per rank, in rank
    order: its device, its K1, masked-selection and rescore launches while
    answering, and (on the card) its peak device memory}."""
    import torch.distributed as dist

    from ..engine.group_rescore import exact_group_rescore
    from ..engine.group_select import masked_group_topk
    from ..engine.screen import union_groupmin

    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = ShardedQueryEngine(x_d, layout, centroids, scaler, params, mesh, **engine_kw)
    build_s = time.perf_counter() - t0
    k1_before, select_before = union_groupmin.launches, masked_group_topk.launches
    rescore_before = exact_group_rescore.launches
    results = []
    for name, args, kwargs in requests:
        if name not in _REQUESTS:
            raise ValueError(f"serve_rank: request {name!r} (expected one of {_REQUESTS})")
        results.append(getattr(engine, name)(*args, **kwargs))
    mine = {
        "rank": mesh.rank, "device": str(dev), "local_impl": engine.local_impl,
        "k1_launches": union_groupmin.launches - k1_before,
        "select_launches": masked_group_topk.launches - select_before,
        "rescore_launches": exact_group_rescore.launches - rescore_before,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }
    ranks = [None] * mesh.size
    dist.all_gather_object(ranks, mine, group=mesh.group)
    return {"results": results, "build_s": build_s, "ranks": ranks}
