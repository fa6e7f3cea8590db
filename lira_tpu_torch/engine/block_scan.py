"""Query-blocked serving scan (port of lira_tpu/engine/block_scan.py).

One pass of the corpus rows a query block probes serves the whole block.
Per batch:

  1. `_probe_prepare` — probing MLP, top-m bucket selection with the
     engine's `score ≥ threshold` + argmax-fallback semantics, a stable
     sort of queries by top bucket (tour rank: similar queries share a
     block), per-block bucket-union masks, and exact nprobe/ndis.
  2. host: union masks → per-block supertile lists (S=8 consecutive
     128-row tiles) + tile→bucket maps (`build_block_unions`, numpy).
  3. `_scan_all` — the K1 screen (engine/screen.py, CUDA on the card)
     emits per-group minima over each block's union; each query then sees
     only the groups of buckets it probed (the masked selection,
     engine/group_select.py, CUDA on the card), the top-(fetch_k + margin)
     groups are rescored exactly in f32 (engine/group_rescore.py, CUDA on
     the card), deduplicated to k distinct neighbours, and un-permuted.

bf16 and int8 screens round or quantize round 1 only; the selection
margin absorbs that, and round 2 re-ranks in f32 from the f32 table.  In
CAPACITY mode (store_f32=False) there is no f32 table: one bf16 or int8
table serves both rounds (round 2 widens its rows in registers; int8 folds
the per-dim scale into the query), and the engine re-ranks the
over-fetched candidates exactly on the host.  A custom prober's host mask
replaces step 1's MLP (`_prepare_from_mask`).
ndis counts each query's own probed buckets' true sizes, not the union
streamed (the union is an execution strategy, not a different search).

Where lira_tpu's shape came from the TPU it gives way here: no VMEM/SMEM
caps on the block size (qb = max(8, min(block_q, pow2ceil(B)))), eager
program order instead of `optimization_barrier`/`lax.map` (each chunk's
screen output is dropped before the next chunk's screen runs), results
copied straight to the host instead of `_wire_pack`'s one-transfer
packing, and pinned buffers with asynchronous copies instead of the
stream's upload thread.

Phase profiling: `_scan_all(screen_only=True)` stops after the group
selection, and under a recording torch.profiler (`profiling.device_trace`)
the spans of `profiling.span` name each phase without synchronising:
`probe` (upload, probe launch, the counts' copy), `probe_wait` (the host
waiting for a batch's union mask), `unions` (`build_block_unions` and its
uploads), `scan` (the launch of `_scan_all` and of its result's copy;
inside it `select`, each block's masked group selection, and `rescore`,
its exact rescore) and `collect` (waiting for and unpacking results).
`probe` and `unions` also add their host seconds to the counters
`probe.host_s` and `unions.host_s`, the counter `screen.pairs` sums the
(query, row) pairs K1 screens, `select.pairs` the (query, group)
minima the selection reads; engine/group_rescore.py counts
`rescore.steps`, the round-2 launches (one a block on the card; on the CPU
one a `_round2_sub` slice of a block's queries), and `rescore.rows`, the
candidate rows they are asked to score.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import true_fp32
from ..ops.distance import l2_to_centroids
from ..ops.topk import top_k
from ..profiling import count, span
from .group_rescore import exact_group_rescore
from .group_select import masked_group_topk
from .screen import S_TILES, screen_norms, union_groupmin

_BIG = 3e38

# cap on the screen output held live at once, (rows, U·SG, qb) f32: block
# rows are chunked to it, and when one block's output alone exceeds half of
# it the union is sliced too (running top-kg merge).  Sized for an 80 GB
# card beside a 1.5× corpus table and the selection's temporaries.
_GMIN_BUDGET = 8 << 30
# set by _screen_rescore: the chunking plan it chose — tests assert the path
_LAST_CHUNK_PLAN: dict | None = None


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(x, 1)))))


# ---------------------------------------------------------------------------
# phase 1: probe + block grouping + union masks
# ---------------------------------------------------------------------------


@torch.no_grad()
def _probe_prepare(mlp, centroids, scaler_mean, scaler_scale,
                   q_pad: torch.Tensor,  # (B_pad, d) f32, zero rows beyond b_real
                   sizes: torch.Tensor,  # (n_bkt,) int64 true bucket sizes
                   b_real: int, threshold: float,
                   m: int,  # probe cap (n_bkt for dense semantics)
                   qb: int,  # block size; B_pad % qb == 0
                   rank: torch.Tensor):  # (n_bkt,) int64 locality rank
    """probe → select → sort-by-top-bucket → unions, all on the device.

    Returns (probed (B_pad, n_bkt) bool, perm (B_pad,) int64, union
    (n_blocks, n_bkt) bool, nprobe (B_pad,) int32, ndis (B_pad,) int64)."""
    d = l2_to_centroids(q_pad, centroids)
    out = mlp((d - scaler_mean) / scaler_scale, q_pad)
    B, n_bkt = out.shape
    vals, idx = top_k(out, m)
    rows = torch.arange(B, device=q_pad.device)
    live = rows < b_real
    keep = vals >= threshold
    keep[:, 0] = True  # argmax fallback (search.cpp:447-466)
    keep &= live[:, None]
    probed = torch.zeros((B, n_bkt), dtype=torch.bool, device=q_pad.device)
    probed.scatter_(1, idx, keep)
    key = rank[idx[:, 0]]
    key = torch.where(live, key, n_bkt)  # dead rows sort last
    perm = torch.sort(key, stable=True).indices
    union = probed[perm].view(B // qb, qb, n_bkt).any(dim=1)
    nprobe = probed.sum(dim=1, dtype=torch.int32)
    # int64 elementwise: CUDA has no int32 matmul
    ndis = (probed.long() * sizes[None, :]).sum(dim=1)
    return probed, perm, union, nprobe, ndis


@torch.no_grad()
def _prepare_from_mask(probed: torch.Tensor,  # (B_pad, n_bkt) bool, pad rows False
                       top1: torch.Tensor,  # (B_pad,) int64, n_bkt at pad rows
                       sizes: torch.Tensor, qb: int, rank: torch.Tensor):
    """Grouping, unions and counts for an externally supplied probed mask
    (a custom prober, e.g. the IVF baseline).  The rank table is extended
    by one entry so that pad rows (top1 == n_bkt) keep sorting last."""
    B, n_bkt = probed.shape
    ext = torch.cat([rank, rank.new_full((1,), rank.shape[0])])
    perm = torch.sort(ext[top1], stable=True).indices
    union = probed[perm].view(B // qb, qb, n_bkt).any(dim=1)
    nprobe = probed.sum(dim=1, dtype=torch.int32)
    ndis = (probed.long() * sizes[None, :]).sum(dim=1)
    return perm, union, nprobe, ndis


# ---------------------------------------------------------------------------
# phase 3: screen, masked selection, exact rescore
# ---------------------------------------------------------------------------


def _dedup_topk_dev(ids: torch.Tensor, neg: torch.Tensor, k: int):
    """Per row: drop duplicate ids (keep the best-scored first occurrence),
    compress survivors to the front, truncate to k.  Rows arrive sorted by
    score, so first occurrence = best."""
    B, _ = ids.shape
    order = torch.sort(ids, dim=1, stable=True).indices
    sorted_ids = torch.gather(ids, 1, order)
    dup_sorted = torch.zeros_like(ids, dtype=torch.bool)
    dup_sorted[:, 1:] = (sorted_ids[:, 1:] == sorted_ids[:, :-1]) & (sorted_ids[:, 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    keep = ~dup & (ids >= 0)
    comp = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, :k]
    out_ids = torch.gather(ids, 1, comp)
    out_neg = torch.gather(neg, 1, comp)
    n_keep = keep.sum(dim=1, keepdim=True)
    slot = torch.arange(comp.shape[1], device=ids.device)[None, :]
    out_ids = torch.where(slot < n_keep, out_ids, -1)
    out_neg = torch.where(slot < n_keep, out_neg, -torch.inf)
    if out_ids.shape[1] < k:
        pad = k - out_ids.shape[1]
        out_ids = torch.cat([out_ids, out_ids.new_full((B, pad), -1)], dim=1)
        out_neg = torch.cat([out_neg, out_neg.new_full((B, pad), -torch.inf)], dim=1)
    return out_ids, out_neg


def int8_width(d: int) -> int:
    """Columns of an int8 screen table of d dims: K1's int8 kernel takes
    whole 32-bit words, so the table is zero-padded to ⌈d/4⌉·4 once."""
    return -(-d // 4) * 4


def screen_queries(q_perm: torch.Tensor, dtype: torch.dtype, dim_scale, metric: str):
    """K1's query operand in the screen dtype: (q_r1, t_eff, s2).

    int8: the corpus is x ≈ s_d·x8; the query is q'_d = q_d·s_d, quantized
    with ONE scalar t over the whole padded, permuted batch, so x·q ≈
    t·(x8·q8).  t_eff = t (IP) or 2t (L2) and s2 = s² feed K1's
    dequantization and norms; q8 and s2 are zero-padded to the int8
    table's `int8_width` (a zero column changes no dot and no norm).
    Other dtypes: a cast, and (None, None)."""
    if dtype != torch.int8:
        return q_perm.to(dtype), None, None
    qp = q_perm * dim_scale[None, :]
    t = torch.clamp_min(qp.abs().max() / 127.0, 1e-30)
    q8 = torch.clamp(torch.round(qp / t), -127, 127).to(torch.int8)
    t_eff = (t if metric == "inner_product" else 2.0 * t).reshape(1).float()
    s2 = (dim_scale * dim_scale).float()
    pad = int8_width(q8.shape[1]) - q8.shape[1]
    if pad:
        q8, s2 = F.pad(q8, (0, pad)), F.pad(s2, (0, pad))
    return q8.contiguous(), t_eff, s2.contiguous()


def group_buckets(tb, supers, tile_pad_count, sel_rows: int) -> torch.Tensor:
    """The per-tile bucket map (n_blocks, U·S) int32 → per selection group
    (n_blocks, U·SG) int32, with ALL-PAD groups masked to -1: pads are a
    per-bucket (hence per-tile) suffix, so group j of G in a tile is pure
    padding iff the tile's pad count covers it.  Mixed groups stay exact in
    K1 (pads copy a real in-group row); all-pad groups' minima are a real
    row's score (the copy) and must be masked."""
    n_blocks, U = supers.shape
    G = 128 // sel_rows
    s_ar = torch.arange(S_TILES, device=tb.device, dtype=torch.int64)
    tpc = tile_pad_count[
        (supers.long()[:, :, None] * S_TILES + s_ar[None, None, :]).view(n_blocks, U * S_TILES)
    ]
    if G > 1:
        tb = tb.repeat_interleave(G, dim=1)
        tpc = tpc.repeat_interleave(G, dim=1)
    gpos = torch.arange(G, device=tb.device).repeat(U * S_TILES)[None, :]
    return torch.where(tpc >= (G - gpos) * sel_rows, -1, tb)


@true_fp32()
def _screen_rescore(
    q_perm: torch.Tensor,  # (B_pad, d) f32, already permuted to block order
    probed_p: torch.Tensor,  # (n_blocks, qb, n_bkt) bool, permuted
    supers: torch.Tensor,  # (n_blocks, U) int32 supertile indices
    tb: torch.Tensor,  # (n_blocks, U*S) int32 bucket per union tile (-1 pad)
    ulen: torch.Tensor,  # (n_blocks,) int32 TRUE union supertiles per block
    corpus_flat: torch.Tensor,  # (n_super*S*128, d) round-1 dtype
    bsq: torch.Tensor,  # (n_super*S, 128) f32 norms/penalties
    corpus_flat_f32: torch.Tensor,  # rescore table (f32; capacity: = corpus_flat)
    tiles_ids: torch.Tensor,  # (n_super*S, 128) int32 global ids
    tile_pad_count: torch.Tensor,  # (n_super*S,) int32 pad rows per tile
    *,
    metric: str,
    kg: int,
    fetch_k: int,
    qb: int,
    sel_rows: int = 128,
    dim_scale: torch.Tensor | None = None,  # (d,) f32 per-dim int8 corpus scale
    screen_sq: torch.Tensor | None = None,  # (n_rows,) f32 K1 row norms (L2)
    screen_only: bool = False,  # phase profiling: stop after the group selection
):
    """K1 screen + masked group selection + exact f32 rescore over every
    query block.  Returns (neg (B_pad, k_loc), ids (B_pad, k_loc), k_loc) in
    block (permuted) order — shared by `_scan_all` and each rank of the
    sharded engine (which merges the ranks before the dedup).
    `screen_only`: no rescore; the selected groups' negated masked minima
    and global group ids (−inf / −1 past the selection) take the place of
    neg and ids.  int8: see `screen_queries`.  Capacity mode
    (the rescore table is the bf16/int8 screen table): round 2 widens the
    table's rows to f32 as it reads them, and for int8 folds the per-dim
    scale into the query, x·q = Σ_d s_d·x8_d·q_d = x8·(q·s), so it reads
    the table's own bytes."""
    d = q_perm.shape[1]
    n_blocks, U = supers.shape
    dev = q_perm.device
    q_r1, t_eff, s2 = screen_queries(q_perm, corpus_flat.dtype, dim_scale, metric)
    G = 128 // sel_rows  # selection groups per 128-row tile
    SG = S_TILES * G  # groups per supertile

    rows_per_call = max(1, min(n_blocks, _GMIN_BUDGET // max(U * SG * qb * 4, 1)))

    def screen_chunk(sup_c, ulen_c, s: int, e: int):
        return union_groupmin(
            q_r1[s * qb : e * qb], corpus_flat, sup_c.contiguous(), ulen_c.contiguous(),
            qb=qb, metric=metric, sel_rows=sel_rows, t_eff=t_eff, s2=s2, xsq=screen_sq,
        )

    # round 2 reads the f32 table at the true d; capacity int8's one table
    # carries the int8 padding, so its queries are padded to match
    d_r2 = corpus_flat_f32.shape[1]
    groups_r2 = corpus_flat_f32.view(-1, sel_rows, d_r2)
    q_r2 = q_perm * dim_scale[None, :] if corpus_flat_f32.dtype == torch.int8 else q_perm
    if d_r2 != d:
        q_r2 = F.pad(q_r2, (0, d_r2 - d))
    bsq_g = bsq.view(-1, sel_rows)
    ids_g = tiles_ids.view(-1, sel_rows)
    supers_l = supers.long()
    tb = group_buckets(tb, supers_l, tile_pad_count, sel_rows)
    kg_eff = min(kg, U * SG)
    k_loc = min(fetch_k, kg_eff * sel_rows)

    def select_slice(gmin_b, probed_b, tb_b, supers_b, u0: int, live):
        """Masked group selection over one U-slice of one block (a query
        sees only groups of buckets it probed; `live` slots of the slice
        are the union's, the rest padding): the global top-kg over the full
        union equals the top-kg of the per-slice top-kgs merged (every
        global winner wins its own slice)."""
        vals, sel = masked_group_topk(gmin_b, tb_b, probed_b, live,
                                      min(kg_eff, gmin_b.shape[0]), unit=SG)
        ggrp = supers_b[u0 + sel // SG] * SG + sel % SG  # global group index
        return vals, ggrp

    def rescore(q_b, vals, ggrp):
        """Exact f32 rescore of the selected groups (group_rescore.py: one
        kernel launch on the card, `_round2_sub` queries a step on the
        CPU)."""
        if screen_only:
            v, g = vals[:, :k_loc], ggrp[:, :k_loc]
            if k_loc > v.shape[1]:
                pad = k_loc - v.shape[1]
                v = F.pad(v, (0, pad), value=-torch.inf)
                g = F.pad(g, (0, pad), value=-1)
            return v, g
        return exact_group_rescore(q_b, vals, ggrp, groups_r2, bsq_g, ids_g, metric=metric,
                                   k_loc=k_loc)

    u_chunk = max(1, (_GMIN_BUDGET // 2) // max(SG * qb * 4, 1))
    global _LAST_CHUNK_PLAN
    _LAST_CHUNK_PLAN = {
        "rows_per_call": rows_per_call, "u_chunk": u_chunk,
        "U": U, "n_blocks": n_blocks, "sg": SG, "qb": qb,
    }

    q_blocks = q_r2.view(n_blocks, qb, d_r2)  # round-2 queries (q·s for int8 capacity)
    neg_parts, ids_parts = [], []
    if u_chunk >= U:
        for s in range(0, n_blocks, rows_per_call):
            e = min(s + rows_per_call, n_blocks)
            gmin_c = screen_chunk(supers[s:e], ulen[s:e], s, e)
            for b in range(s, e):
                with span("select"):
                    vals, ggrp = select_slice(gmin_c[b - s], probed_p[b], tb[b], supers_l[b],
                                              0, ulen[b : b + 1])
                with span("rescore"):
                    neg_b, ids_b = rescore(q_blocks[b], vals, ggrp)
                neg_parts.append(neg_b)
                ids_parts.append(ids_b)
            del gmin_c  # this chunk's screen output dies before the next screen
    else:
        for b in range(n_blocks):
            with span("select"):
                carry_v = torch.full((qb, kg_eff), -torch.inf, device=dev)
                carry_g = torch.zeros((qb, kg_eff), dtype=torch.int64, device=dev)
            for u0 in range(0, U, u_chunk):
                u1 = min(u0 + u_chunk, U)
                # live slots of this U-slice: the block's true length clipped
                # into [u0, u1), so K1's skip stays per-slice exact
                ulen_c = torch.clamp(ulen[b : b + 1] - u0, 0, u1 - u0)
                gmin_c = screen_chunk(supers[b : b + 1, u0:u1], ulen_c, b, b + 1)[0]
                with span("select"):
                    vals_c, ggrp_c = select_slice(
                        gmin_c, probed_p[b], tb[b, u0 * SG : u1 * SG], supers_l[b], u0, ulen_c
                    )
                    del gmin_c
                    mv = torch.cat([carry_v, vals_c], dim=1)
                    mg = torch.cat([carry_g, ggrp_c], dim=1)
                    carry_v, isel = top_k(mv, kg_eff)
                    carry_g = torch.gather(mg, 1, isel)
            with span("rescore"):
                neg_b, ids_b = rescore(q_blocks[b], carry_v, carry_g)
            neg_parts.append(neg_b)
            ids_parts.append(ids_b)
    return torch.cat(neg_parts), torch.cat(ids_parts), k_loc


@torch.no_grad()
def _scan_all(q_pad, probed, perm, supers, tb, ulen, corpus_flat, bsq, corpus_flat_f32,
              tiles_ids, tile_pad_count, *, metric: str, kg: int, fetch_k: int, k: int,
              qb: int, sel_rows: int = 128, dim_scale=None, screen_sq=None,
              screen_only: bool = False):
    """(scores (B_pad, k), ids (B_pad, k)) in caller order, deduplicated to
    k distinct neighbours (`screen_only`: group minima and group ids, see
    `_screen_rescore`)."""
    n_blocks = supers.shape[0]
    q_perm = q_pad[perm]
    probed_p = probed[perm].view(n_blocks, qb, -1)
    neg, ids, k_loc = _screen_rescore(
        q_perm, probed_p, supers, tb, ulen, corpus_flat, bsq, corpus_flat_f32,
        tiles_ids, tile_pad_count, metric=metric, kg=kg, fetch_k=fetch_k, qb=qb,
        sel_rows=sel_rows, dim_scale=dim_scale, screen_sq=screen_sq, screen_only=screen_only,
    )
    ids, neg = _dedup_topk_dev(ids, neg, k)
    out_scores = torch.empty_like(neg)
    out_scores[perm] = -neg
    out_ids = torch.empty_like(ids)
    out_ids[perm] = ids
    return out_scores, out_ids


# ---------------------------------------------------------------------------
# state + orchestration
# ---------------------------------------------------------------------------


def _align_ids(padded_ids, n_rows: int, tile: int):
    """Supertile-align the id vector: returns (ids (rows_total,), n_super,
    pad_rows added)."""
    n_tiles = n_rows // tile
    n_super = max(1, -(-n_tiles // S_TILES))
    pad_rows = n_super * S_TILES * tile - n_rows
    ids = np.asarray(padded_ids, np.int32)
    if pad_rows:
        ids = np.concatenate([ids, np.full(pad_rows, -1, np.int32)])
    return ids, n_super, pad_rows


class BlockScanState:
    """Device-resident round-1/round-2 corpus views for the blocked scan.

    Device cost: one f32 corpus copy (round 2), plus a bf16 (int8) copy when
    scan_dtype is bfloat16 (int8) — 1.0× / 1.5× / 1.25× the padded corpus;
    in capacity mode (store_f32=False) the bf16 (int8) table alone — 0.5× /
    0.25×.  All other state (norms, ids, pad counts) is O(rows · 12 B)."""

    @classmethod
    @torch.no_grad()
    def from_corpus(
        cls,
        x_d: np.ndarray,  # (n, d) raw corpus, host
        padded_ids: np.ndarray,  # (padded_total,) int32 global ids, -1 = pad
        tile_bucket,
        metric: str,
        scan_dtype: torch.dtype,
        tile: int = 128,
        chunk_rows: int = 1 << 21,
        store_f32: bool = True,
        device=None,
        int8_scale: np.ndarray | None = None,  # (d,) f32 per-dim int8 scale;
        # None: the corpus's own max-abs / 127 (the sharded engine passes
        # the whole corpus's, so every rank's scores are commensurable)
    ) -> "BlockScanState":
        """Build the padded table ON THE DEVICE from the raw corpus: the raw
        corpus goes up once in dense chunks, and each chunk's rows are
        scattered to their (possibly several) padded positions there.

        Capacity mode (store_f32=False with bf16/int8) scatters straight
        into a bf16/int8 table, so device memory stays 0.5×/0.25× the
        padded corpus through the build (plus one chunk): int8 takes its
        per-dim scale from one streamed host max-abs pass and quantizes
        each chunk on the host (a quarter of the upload bytes); the exact
        f32 L2 norms come from the host rows (`row_sqnorms`)."""
        from .. import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda":
            # the serving path's kernels, K1, the masked selection and the
            # rescore: their nvcc runs in parallel, here rather than at
            # first launch
            from ..kernels import build

            build(["union_groupmin", "group_select", "group_rescore"])
        self = cls.__new__(cls)
        x_d = np.asarray(x_d)
        n, d = x_d.shape
        ids, n_super, _ = _align_ids(padded_ids, len(padded_ids), tile)
        rows_total = n_super * S_TILES * tile
        capacity = not store_f32 and scan_dtype in (torch.bfloat16, torch.int8)
        cap_int8 = capacity and scan_dtype == torch.int8
        dim_scale = None if int8_scale is None else np.asarray(int8_scale, np.float32)
        if cap_int8 and dim_scale is None:
            amax = np.zeros(d, np.float32)
            for s in range(0, n, chunk_rows):
                np.maximum(amax, np.abs(x_d[s : s + chunk_rows]).max(axis=0), out=amax)
            dim_scale = (np.maximum(amax, 1e-30) / 127.0).astype(np.float32)
        order = np.argsort(ids, kind="stable")
        first = np.searchsorted(ids[order], 0, side="left")
        sorted_pos = order[first:].astype(np.int64)  # padded positions by source id
        sorted_src = ids[order][first:].astype(np.int64)
        out_dtype = scan_dtype if capacity else torch.float32
        # capacity int8: the one table is K1's, zero-padded to int8_width
        width = int8_width(d) if cap_int8 else d
        out = torch.zeros((rows_total, width), dtype=out_dtype, device=dev)
        for s in range(0, n, chunk_rows):
            e = min(s + chunk_rows, n)
            lo = int(np.searchsorted(sorted_src, s, side="left"))
            hi = int(np.searchsorted(sorted_src, e, side="left"))
            if lo == hi:
                continue
            if cap_int8:
                chunk = np.clip(np.round(x_d[s:e].astype(np.float32) / dim_scale),
                                -127, 127).astype(np.int8)
            else:
                chunk = np.ascontiguousarray(x_d[s:e], np.float32)
            vals = torch.as_tensor(chunk, device=dev)
            out[torch.as_tensor(sorted_pos[lo:hi], device=dev), :d] = vals[
                torch.as_tensor(sorted_src[lo:hi] - s, device=dev)
            ].to(out_dtype)
            del vals
        norms_rows = None
        if capacity and metric != "inner_product":
            # no f32 device copy exists to reduce: one O(n·d) host pass
            # over the raw corpus, scattered by padded position
            from ..ops.distance import row_sqnorms

            norms_rows = np.zeros(rows_total, np.float32)
            norms_rows[sorted_pos] = row_sqnorms(x_d)[sorted_src]
        self._finish(out, ids, tile_bucket, metric, scan_dtype, tile, n_super,
                     store_f32=store_f32, norms_rows=norms_rows,
                     dim_scale=dim_scale if scan_dtype == torch.int8 else None)
        return self

    def _finish(self, corpus_dev, ids, tile_bucket, metric, scan_dtype, tile, n_super,
                store_f32=True, norms_rows=None, dim_scale=None):
        """corpus_dev: the padded table on the device — f32, or already
        bf16/int8 from the capacity build (with its host `norms_rows`).
        `dim_scale`: the int8 table's per-dim scale (capacity's, or a given
        one); None takes it from corpus_dev."""
        dev = corpus_dev.device
        self.store_f32 = store_f32 or scan_dtype not in (torch.bfloat16, torch.int8)
        # Pad rows become COPIES of their bucket's last real row: K1 takes
        # row norms of the rows as stored (no per-row penalty operand), so a
        # pad row must score exactly like a real row of its own selection
        # group.  Pads are a per-bucket suffix, so the last real row at or
        # before each position is in the same tile AND the same group
        # whenever the group holds any real row; all-pad groups are masked by
        # the per-group bucket map instead (_screen_rescore).  Round 2 masks
        # pads by id, and copies add no new values to the int8 scale.
        real = ids >= 0
        last_real = np.maximum.accumulate(
            np.where(real, np.arange(len(ids), dtype=np.int64), -1)
        )
        pad_pos = np.nonzero(~real & (last_real >= 0))[0]
        if len(pad_pos):
            corpus_dev[torch.as_tensor(pad_pos, device=dev)] = corpus_dev[
                torch.as_tensor(last_real[pad_pos], device=dev)
            ]
        self.dim_scale = None
        self.corpus_flat_f32 = corpus_dev
        if not self.store_f32:
            # capacity: ONE bf16/int8 table serves both rounds
            self.corpus_flat = corpus_dev
            if scan_dtype == torch.int8:
                self.dim_scale = torch.as_tensor(dim_scale, dtype=torch.float32, device=dev)
        elif scan_dtype == torch.bfloat16:
            self.corpus_flat = corpus_dev.to(torch.bfloat16)
        elif scan_dtype == torch.int8:
            # symmetric per-dim quantization x ≈ s_d·x8, on the device,
            # zero-padded to K1's int8_width
            if dim_scale is None:
                self.dim_scale = torch.clamp_min(corpus_dev.abs().amax(dim=0), 1e-30) / 127.0
            else:
                self.dim_scale = torch.as_tensor(dim_scale, dtype=torch.float32, device=dev)
            x8 = torch.clamp(torch.round(corpus_dev / self.dim_scale), -127, 127).to(torch.int8)
            pad = int8_width(x8.shape[1]) - x8.shape[1]
            self.corpus_flat = F.pad(x8, (0, pad)) if pad else x8
            del x8
        else:
            self.corpus_flat = corpus_dev
        # K1's L2 row norms of the screen table, built once (4 B a row)
        s2 = None
        if self.dim_scale is not None:
            s2 = self.dim_scale * self.dim_scale
            s2 = F.pad(s2, (0, self.corpus_flat.shape[1] - s2.shape[0]))
        self.screen_sq = (None if metric == "inner_product"
                          else screen_norms(self.corpus_flat, s2))

        self.tiles_ids = torch.as_tensor(ids.reshape(n_super * S_TILES, tile), device=dev)
        if metric == "inner_product":
            sq = torch.zeros(self.tiles_ids.shape, dtype=torch.float32, device=dev)
        elif norms_rows is not None:
            sq = torch.as_tensor(norms_rows, device=dev).view(n_super * S_TILES, tile)
        else:
            sq = (corpus_dev * corpus_dev).sum(dim=1).view(n_super * S_TILES, tile)
        self.bsq = torch.where(self.tiles_ids >= 0, sq, _BIG)

        tb = np.asarray(tile_bucket, np.int32)
        pad_tiles = n_super * S_TILES - len(tb)
        self.tile_bucket = (
            np.concatenate([tb, np.full(pad_tiles, -1, np.int32)]) if pad_tiles else tb
        )
        # per-tile pad-row counts (pads are a per-tile suffix) — drives the
        # all-pad selection-group masking in _screen_rescore
        self.tile_pad_count = torch.as_tensor(
            (~real).reshape(n_super * S_TILES, tile).sum(axis=1).astype(np.int32),
            device=dev,
        )
        self.n_super = n_super
        self.scan_dtype = scan_dtype
        self.device = dev


def build_block_unions(
    union_mask: np.ndarray,  # (n_blocks, n_bkt) bool
    tile_start: np.ndarray,
    tiles_per_bucket: np.ndarray,
    tile_bucket: np.ndarray,  # (n_super*S,) bucket per global tile
):
    """Union masks → per-block supertile lists + per-tile bucket maps.

    Returns (supers (n_blocks, U) i32, tb (n_blocks, U*S) i32, ulen
    (n_blocks,) i32) with U the pow2 ceiling of the largest block union
    and ulen each block's TRUE union length — K1 skips slots past it, so
    the padded width costs (almost) nothing.  Pad slots repeat the block's
    last real supertile."""
    n_blocks = union_mask.shape[0]
    per_block = []
    for i in range(n_blocks):
        bs = np.nonzero(union_mask[i])[0]
        reps = tiles_per_bucket[bs]
        total = int(reps.sum())
        if total == 0:
            per_block.append(np.zeros(0, np.int64))
            continue
        starts_rep = np.repeat(tile_start[bs], reps)
        cum = np.cumsum(reps) - reps
        within = np.arange(total, dtype=np.int64) - np.repeat(cum, reps)
        per_block.append(np.unique((starts_rep + within) // S_TILES))
    U = max(1, _pow2ceil(max(len(s) for s in per_block)))
    supers = np.zeros((n_blocks, U), np.int32)
    tb = np.full((n_blocks, U * S_TILES), -1, np.int32)
    ulen = np.zeros(n_blocks, np.int32)
    for i, s in enumerate(per_block):
        if not len(s):
            continue
        supers[i, : len(s)] = s
        supers[i, len(s):] = s[-1]
        ulen[i] = len(s)
        real = (s[:, None] * S_TILES + np.arange(S_TILES)[None, :]).reshape(-1)
        tb[i, : len(real)] = tile_bucket[real]
    return supers, tb, ulen


def _resolve_margin(margin, scan_dtype, sel_rows: int) -> int:
    """Default selection margin, counted in selection groups: bf16 covers 4
    tiles, int8 8 tiles (128/sel_rows groups per tile), f32 a flat 8 (f32
    group mins are exact; the margin only absorbs ties).  Re-validate on a
    new distribution with engine/calibrate.py."""
    if not (0 < sel_rows <= 128 and 128 % sel_rows == 0):
        raise ValueError(
            f"sel_rows={sel_rows}: must be a divisor of the 128-row tile"
        )
    if margin is None:
        if scan_dtype == torch.bfloat16:
            margin = 4 * (128 // sel_rows)
        elif scan_dtype == torch.int8:
            margin = 8 * (128 // sel_rows)
        else:
            margin = 8
    return margin


def _to_host_async(tensors):
    """Start device→host copies of `tensors`; returns a handle for _wait."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _wait(handle) -> list[np.ndarray]:
    host, ev = handle
    if ev is not None:
        ev.synchronize()
    return [t.numpy() for t in host]


def _upload_queries(state: BlockScanState, queries: np.ndarray,
                    B_pad: int) -> tuple[np.ndarray, torch.Tensor]:
    """(host rows, device copy) of the batch zero-padded to B_pad rows.  On
    the card the batch is written straight into pinned memory from the
    caching host allocator, which hands the block out again once the copy
    that read it has run: a fresh padded array and a fresh pinned copy of a
    65,536 × 960 batch took 0.11-0.16 s of host time on an H100 machine,
    which the device waited out."""
    B, d = queries.shape
    dev = state.device
    host = torch.empty((B_pad, d), dtype=torch.float32, pin_memory=dev.type == "cuda")
    rows = host.numpy()
    rows[:B] = queries
    rows[B:] = 0.0  # the int8 scale is taken over the whole padded batch
    return rows, host.to(dev, non_blocking=True) if dev.type == "cuda" else host


def _probe_batch(state: BlockScanState, engine, queries: np.ndarray, threshold: float,
                 block_q: int, use_cache: bool = False) -> dict:
    """Upload one batch and launch its probe (asynchronous on the card).

    `use_cache` reuses the previous upload when the same query CONTENT at
    the same shape is searched again (threshold sweeps re-search one
    batch); the hit is verified against a kept host copy and needs the
    same batch length, so the pad rows are zeros: the int8 scale is taken
    over the whole padded batch, and a longer batch's rows left in the pad
    would change the screen."""
    queries = np.asarray(queries, np.float32)
    B, d = queries.shape
    qb = max(8, min(block_q, _pow2ceil(B)))
    B_pad = -(-B // qb) * qb
    dev = state.device
    cache = getattr(state, "_q_cache", None)
    if (
        use_cache and cache is not None and cache[0] == B
        and cache[1].shape == (B_pad, d) and np.array_equal(cache[1][:B], queries)
    ):
        q_dev = cache[2]
    else:
        q_host, q_dev = _upload_queries(state, queries, B_pad)
        if use_cache:
            state._q_cache = (B, q_host, q_dev)
    n_bkt = engine.layout.n_bkt
    if engine.prober is not None:
        # pluggable prober (e.g. the IVF centroid-rank baseline): host
        # outputs → the engine's threshold + argmax-fallback selection
        outputs = np.asarray(engine.prober(queries))
        probed_h = np.zeros((B_pad, n_bkt), bool)
        probed_h[:B] = engine.select_buckets(outputs, threshold)
        top1 = np.full(B_pad, n_bkt, np.int64)
        top1[:B] = outputs.argmax(axis=1)
        probed = torch.as_tensor(probed_h, device=dev)
        perm, union, nprobe, ndis = _prepare_from_mask(
            probed, torch.as_tensor(top1, device=dev), engine.sizes_dev, qb,
            engine.bucket_rank_dev,
        )
    else:
        m = min(engine.probe_cap or n_bkt, n_bkt)
        probed, perm, union, nprobe, ndis = _probe_prepare(
            engine.mlp, engine.centroids, engine.scaler_mean, engine.scaler_scale, q_dev,
            engine.sizes_dev, B, float(threshold), m, qb, engine.bucket_rank_dev,
        )
    return dict(q=q_dev, probed=probed, perm=perm, union=union, nprobe=nprobe,
                ndis=ndis, B=B, qb=qb)


def _dispatch_scan(state, engine, h, union, fetch_k, k, kg, sel_rows, wire):
    """Host union build, then the launch of one batch's scan and of its
    results' copy to the host (asynchronous): a handle for _wait."""
    dev = state.device
    with span("unions", timed=True):
        supers, tb, ulen = build_block_unions(
            union, engine.tile_start, engine.tiles_per_bucket, state.tile_bucket
        )
        supers_d, tb_d, ulen_d = (torch.as_tensor(a, device=dev) for a in (supers, tb, ulen))
    # every query of a block against every row of its union's supertiles,
    # and the (query, group) minima the selection reads
    count("screen.pairs", h["qb"] * int(ulen.sum()) * S_TILES * 128)
    count("select.pairs", h["qb"] * int(ulen.sum()) * S_TILES * (128 // sel_rows))
    with span("scan"):
        scores, ids = _scan_all(
            h["q"], h["probed"], h["perm"], supers_d, tb_d, ulen_d,
            state.corpus_flat, state.bsq, state.corpus_flat_f32, state.tiles_ids,
            state.tile_pad_count, metric=engine.metric, kg=kg, fetch_k=fetch_k, k=k,
            qb=h["qb"], sel_rows=sel_rows, dim_scale=state.dim_scale,
            screen_sq=state.screen_sq,
        )
        return _to_host_async([_wire(scores, wire), ids])


def _wire(scores: torch.Tensor, wire: str) -> torch.Tensor:
    """The `wire` result contract: 'pack32' and 'f32' return the f32 scores
    bit for bit; 'bf16' rounds them to bfloat16 (ids are exact either way)."""
    if wire == "bf16":
        return scores.to(torch.bfloat16).float()
    if wire not in ("pack32", "f32"):
        raise ValueError(f"unknown wire format {wire!r}")
    return scores


def blocked_search(
    state: BlockScanState,
    engine,  # QueryEngine — probing model + tile geometry
    queries: np.ndarray,  # (B, d) f32
    threshold: float,
    fetch_k: int,
    k: int,
    block_q: int = 256,
    margin: int | None = None,
    sel_rows: int = 128,
    wire: str = "pack32",
):
    """(scores (B,k), ids (B,k), nprobe, ndis) as host arrays, deduplicated
    to k distinct neighbours."""
    margin = _resolve_margin(margin, state.scan_dtype, sel_rows)
    with span("probe", timed=True):
        h = _probe_batch(state, engine, queries, threshold, block_q, use_cache=True)
        counts = _to_host_async([h["union"], h["nprobe"], h["ndis"]])
    with span("probe_wait"):
        union, nprobe, ndis = _wait(counts)
    res = _dispatch_scan(state, engine, h, union, fetch_k, k, fetch_k + margin, sel_rows, wire)
    with span("collect"):
        B = h["B"]
        s_np, i_np = _wait(res)
        return s_np[:B], i_np[:B], nprobe[:B].astype(np.int64), ndis[:B].astype(np.int64)


def blocked_search_stream(
    state: BlockScanState,
    engine,
    queries: np.ndarray,  # (B_total, d) f32 — split into batches internally
    threshold: float,
    fetch_k: int,
    k: int,
    batch_size: int = 65536,
    block_q: int = 256,
    margin: int | None = None,
    sel_rows: int = 128,
    wire: str = "pack32",
):
    """Multi-batch blocked search, equal to per-batch `blocked_search`
    concatenated (same device work per batch, another dispatch order).

    Batch i+1's upload and probe are queued on the device before batch i's
    scan, and every device→host copy goes through pinned memory behind an
    event, so the host builds batch i's unions while the device runs batch
    i+1's probe, and batch i's results are collected only after batch
    i+1's scan is queued."""
    margin = _resolve_margin(margin, state.scan_dtype, sel_rows)
    queries = np.asarray(queries, np.float32)
    kg = fetch_k + margin
    starts = list(range(0, len(queries), batch_size))

    def probe(s):
        with span("probe", timed=True):
            h = _probe_batch(state, engine, queries[s : s + batch_size], threshold, block_q)
            h["counts"] = _to_host_async([h["union"], h["nprobe"], h["ndis"]])
            return h

    out_scores, out_ids, out_np, out_nd = [], [], [], []

    def collect(h, res):
        B = h["B"]
        s_np, i_np = _wait(res)
        _, nprobe, ndis = _wait(h["counts"])
        out_scores.append(s_np[:B])
        out_ids.append(i_np[:B])
        out_np.append(nprobe[:B].astype(np.int64))
        out_nd.append(ndis[:B].astype(np.int64))

    prev = None
    h_next = probe(starts[0])
    for i in range(len(starts)):
        h = h_next
        h_next = probe(starts[i + 1]) if i + 1 < len(starts) else None
        with span("probe_wait"):
            union = _wait(h["counts"])[0]
        res = _dispatch_scan(state, engine, h, union, fetch_k, k, kg, sel_rows, wire)
        if prev is not None:
            with span("collect"):
                collect(*prev)
        prev = (h, res)
    with span("collect"):
        collect(*prev)
        return (
            np.concatenate(out_scores),
            np.concatenate(out_ids),
            np.concatenate(out_np),
            np.concatenate(out_nd),
        )
