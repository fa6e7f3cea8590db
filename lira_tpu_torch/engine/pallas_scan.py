"""K3, the probed-tile scan: wrappers of the CUDA kernels
(csrc/probed_scan.cu) and their plain PyTorch versions.

Replaces lira_tpu/engine/pallas_scan.py::_scan_kernel and the final top-k
that lira_tpu takes after it.  For each query, an exact top-k over the rows
of its own tiles (a (B, T) list, −1 = no tile):

    L2:  sq − 2·q·x    (sq: the f32 row norm, 3e38 on padding rows)
    IP:  sq − q·x      (sq: 0 on valid rows, 3e38 on padding rows)

Rows with id < 0 score 3e38; a slot whose score is ≥ 1e37 comes out as id
−1 (its score stays 3e38).  k ≤ 128, as in lira_tpu, whose engine sends
wider fetches to its XLA scan; so does this port's (engine/serve.py).

The scan runs tile-major, so that a tile shared by many queries is read
once for a group of them, in three steps, each a kernel on the card and its
plain version on the CPU:
  1. `invert_tile_lists`: the live (query, slot) entries grouped by tile,
     each tile's entries cut into work items of at most `QCHUNK`;
  2. the scan, per item: the tile scored against the item's queries, and
     for every (query, slot) the tile's k best (score, id) pairs, sorted,
     written to the slot's row of a (B·T, k) candidate buffer
     (`pair_topk_ref` on the CPU); holes are not written;
  3. `merge_topk`: per query, the k best of its live slots' candidates, as
     lira_tpu takes its final top-k in XLA outside its kernel.
The union of the slots' top-k lists holds the query's top-k, so the
result is exact.  Of two equal scores a slot keeps the lower row, and the
merge the earlier slot: the order of the plain version `probed_scan_ref`,
which ranks every (slot, row) of a query at once.

Dropped from lira_tpu's wrapper, being TPU-shaped: the SMEM sub-batching
of the tile list (`smem_budget`), the 8-sublane query replication, the
`r_pad` rounding to 8, and the `interpret` / `double_buffer` switches (the
CPU runs the plain versions; the scan always double-buffers).

Each wrapper launches its kernel for CUDA tensors, adds one to its own
`launches`, and takes its plain version only for CPU tensors; there is no
fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from .. import true_fp32
from ..ops.topk import top_k

_BIG = 3e38
QCHUNK = 16  # (query, slot) entries of one tile a work item: the kernel's QC
# (rows, T·128, d) f32 elements the plain versions gather at once
_REF_BUDGET = 1 << 28


def _finish_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k (ascending scores) over each row of (B, m) candidates, with
    −1 ids where the score is ≥ 1e37 (a missing candidate)."""
    neg, sel = top_k(-vals, k)
    out = torch.gather(ids, 1, sel)
    scores = -neg
    return scores, torch.where(scores < 1e37, out, -1)


@true_fp32()
def probed_scan_ref(q, tile_idx, corpus, corpus_ids, corpus_sq, k: int, metric: str = "L2"):
    """Plain PyTorch K3: gather each query's tiles, score them with one
    batched product, and take a top-k over the T·128 candidates, a chunk of
    queries at a time.  Any k."""
    B, T = tile_idx.shape
    tile, d = corpus.shape[1], corpus.shape[2]
    step = max(1, _REF_BUDGET // max(T * tile * d, 1))
    scores, ids = [], []
    for s in range(0, B, step):
        idx = tile_idx[s : s + step].long()
        n = idx.shape[0]
        safe = idx.clamp_min(0)
        vec = corpus[safe].float().view(n, T * tile, d)
        dot = torch.bmm(vec, q[s : s + step].float()[:, :, None]).view(n, T, tile)
        sq = corpus_sq[safe]
        score = sq - dot if metric == "inner_product" else sq - 2.0 * dot
        cid = corpus_ids[safe]
        score = torch.where((idx[:, :, None] < 0) | (cid < 0), _BIG, score).view(n, -1)
        cid = cid.view(n, -1)
        if k > score.shape[1]:
            pad = k - score.shape[1]
            score = torch.cat([score, score.new_full((n, pad), _BIG)], dim=1)
            cid = torch.cat([cid, cid.new_full((n, pad), -1)], dim=1)
        sc, i = _finish_topk(score, cid, k)
        scores.append(sc)
        ids.append(i)
    return torch.cat(scores), torch.cat(ids)


def _item_bound(n: int, n_tiles: int) -> int:
    """W, an upper bound of the item count of n list entries over n_tiles
    tiles: each tile's last item may be partly empty."""
    return min(n, -(-n // QCHUNK) + min(n_tiles, n))


def invert_tile_lists_ref(tile_idx: torch.Tensor, n_tiles: int):
    """Plain PyTorch inversion of the (B, T) lists: (item_tile (W,) int32,
    item_pair (W, QCHUNK) int32), W = `_item_bound(B·T, n_tiles)`.

    Item w covers one tile, `item_tile[w]`, and up to QCHUNK list entries
    that name it, `item_pair[w]`: flat indices b·T + slot, −1 where unused.
    Every live entry is in exactly one item; the items of a tile are
    consecutive, tiles ascending, and a tile with m entries has ⌈m/QCHUNK⌉
    items, all full but the last.  Items past the last have tile −1.  Here
    a tile's entries go in (b, slot) order; the kernel may order them
    otherwise, which changes no result."""
    B, T = tile_idx.shape
    n = B * T
    dev = tile_idx.device
    flat = tile_idx.reshape(-1)
    key, order = torch.sort(torch.where((flat >= 0) & (flat < n_tiles), flat, n_tiles),
                            stable=True)
    rank = torch.arange(n, device=dev) - torch.searchsorted(key, key)
    live = key < n_tiles
    head = live & (rank % QCHUNK == 0)
    item = torch.cumsum(head, 0) - 1
    W = _item_bound(n, n_tiles)
    # one spare entry at the end takes the writes of dead entries
    item_tile = torch.full((W + 1,), -1, dtype=torch.int32, device=dev)
    item_tile.scatter_(0, torch.where(head, item, W), key.to(torch.int32))
    item_pair = torch.full(((W + 1) * QCHUNK,), -1, dtype=torch.int32, device=dev)
    item_pair.scatter_(0, torch.where(live, item * QCHUNK + rank % QCHUNK, W * QCHUNK),
                       order.to(torch.int32))
    return item_tile[:W], item_pair[: W * QCHUNK].view(W, QCHUNK)


def items_canonical(item_tile, item_pair):
    """What two valid inversions of the same lists share: each item's tile
    and entry count, and every entry with its item's tile (sorted by
    entry).  Which of a tile's entries share an item may differ."""
    used = item_pair >= 0
    w, j = torch.nonzero(used, as_tuple=True)
    pair, tile = item_pair[w, j], item_tile[w]
    order = torch.argsort(pair)
    return item_tile, used.sum(1), pair[order], tile[order]


def invert_tile_lists(tile_idx: torch.Tensor, n_tiles: int):
    """`invert_tile_lists_ref`'s items, built by the inversion kernel for a
    CUDA tensor (three launches, no host sync) and by the plain version for
    a CPU one."""
    if tile_idx.device.type == "cpu":
        return invert_tile_lists_ref(tile_idx, n_tiles)
    if tile_idx.device.type != "cuda" or tile_idx.dtype != torch.int32:
        raise ValueError(f"K3 inversion: tile_idx must be int32 on a CUDA device "
                         f"({tile_idx.dtype}, {tile_idx.device})")
    tile_idx = tile_idx.contiguous()
    n = tile_idx.numel()
    dev = tile_idx.device
    W = _item_bound(n, n_tiles)
    item_tile = torch.empty(W, dtype=torch.int32, device=dev)
    item_pair = torch.empty((W, QCHUNK), dtype=torch.int32, device=dev)
    scratch = torch.empty(n + 2 * n_tiles, dtype=torch.int32, device=dev)
    err = _lib().lira_invert_tile_lists(
        QCHUNK, tile_idx.data_ptr(), n, n_tiles, scratch.data_ptr(), item_tile.data_ptr(),
        item_pair.data_ptr(), W, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 inversion launch failed: cudaError {err}")
    invert_tile_lists.launches += 1
    return item_tile, item_pair


invert_tile_lists.launches = 0  # kernel launches since the last reset


@true_fp32()
def pair_topk_ref(q, item_tile, item_pair, corpus, corpus_ids, corpus_sq, out_vals, out_ids,
                  T: int, metric: str = "L2"):
    """Plain PyTorch version of the scan kernel's work on the items of
    `invert_tile_lists`: for every (query, slot) entry of an item, the
    item's tile scored against the query and its kp best (score, id) pairs
    (ascending, the lower row first among equal scores) written to row
    b·T + slot of out_vals / out_ids (B·T, kp).  Rows in no item are left
    as they are."""
    kp = out_vals.shape[1]
    w, j = torch.nonzero(item_pair >= 0, as_tuple=True)
    pair = item_pair[w, j].long()
    tile = item_tile[w].long()
    d = corpus.shape[2]
    step = max(1, _REF_BUDGET // (corpus.shape[1] * d))
    for s in range(0, pair.numel(), step):
        p, t = pair[s : s + step], tile[s : s + step]
        dot = torch.bmm(corpus[t].float(), q[p // T].float()[:, :, None])[:, :, 0]
        sq = corpus_sq[t]
        score = sq - dot if metric == "inner_product" else sq - 2.0 * dot
        cid = corpus_ids[t]
        score = torch.where(cid < 0, _BIG, score)
        top, row = torch.sort(score, dim=1, stable=True)
        out_vals[p] = top[:, :kp]
        out_ids[p] = torch.gather(cid, 1, row[:, :kp])


def merge_topk_ref(cand_v, cand_i, tile_idx, k: int):
    """Plain PyTorch merge: the top-k (ascending scores, the lower flat
    index first among equal ones) over each query's T·kp candidates of
    (B·T, kp) `cand_v` / `cand_i`, with the rows of holes (tile −1) taken
    as 3e38 / −1 whatever they hold."""
    B, T = tile_idx.shape
    kp = cand_v.shape[1]
    hole = (tile_idx < 0).reshape(B * T, 1)
    vals = torch.where(hole, _BIG, cand_v).view(B, T * kp)
    ids = torch.where(hole, -1, cand_i).view(B, T * kp)
    return _finish_topk(vals, ids, k)


def merge_topk(cand_v, cand_i, tile_idx, k: int):
    """(scores (B, k) f32, ids (B, k) int32): `merge_topk_ref`'s result,
    from the merge kernel for CUDA tensors (one warp a query merging its
    live slots' sorted lists) and from the plain version for CPU ones."""
    B, T = tile_idx.shape
    kp = cand_v.shape[1]
    if cand_v.device.type == "cpu":
        return merge_topk_ref(cand_v, cand_i, tile_idx, k)
    if not 1 <= k <= T * kp:
        raise ValueError(f"K3 merge: k={k} outside [1, {T * kp}]")
    dev = cand_v.device
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    tile_idx = tile_idx.contiguous()
    err = _lib().lira_merge_topk(
        cand_v.data_ptr(), cand_i.data_ptr(), tile_idx.data_ptr(), B, T, kp, k,
        out_v.data_ptr(), out_i.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 merge launch failed: cudaError {err}")
    merge_topk.launches += 1
    return out_v, out_i


merge_topk.launches = 0  # kernel launches since the last reset


def _check(q, tile_idx, corpus, corpus_ids, corpus_sq, metric):
    if metric not in ("L2", "inner_product"):
        raise ValueError(f"K3: metric {metric!r}")
    if corpus.dim() != 3 or corpus.shape[1] != 128:
        raise ValueError(f"K3: corpus {tuple(corpus.shape)} must be (n_tiles, 128, d)")
    n_tiles, _, d = corpus.shape
    if corpus.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError("K3: queries and corpus must be float32")
    if q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"K3: queries {tuple(q.shape)} do not match corpus d={d}")
    if tile_idx.dim() != 2 or tile_idx.shape[0] != q.shape[0] or tile_idx.shape[1] == 0:
        raise ValueError(f"K3: tile_idx {tuple(tile_idx.shape)} must be ({q.shape[0]}, T≥1)")
    if tile_idx.dtype != torch.int32 or corpus_ids.dtype != torch.int32:
        raise TypeError("K3: tile_idx and corpus_ids must be int32")
    if corpus_ids.shape != (n_tiles, 128) or corpus_sq.shape != (n_tiles, 128):
        raise ValueError(f"K3: corpus_ids and corpus_sq must be ({n_tiles}, 128)")
    if corpus_sq.dtype != torch.float32:
        raise TypeError("K3: corpus_sq must be float32")


def _lib():
    """csrc/probed_scan.cu's library (built at first use), its three C
    entry points typed."""
    from ..kernels import load

    lib = load("probed_scan")
    i, p = ctypes.c_int, ctypes.c_void_p
    # qc | tile_idx | n, n_tiles | scratch, item_tile, item_pair | W, device |
    # stream
    lib.lira_invert_tile_lists.argtypes = [i, p, i, i, p, p, p, i, i, p]
    # qc, kp, l2 | q, item_tile, item_pair, corpus, ids, sq, out_vals, out_ids
    # | W, T, d, device | stream
    lib.lira_probed_scan.argtypes = [i] * 3 + [p] * 8 + [i] * 4 + [p]
    # cand_v, cand_i, tile_idx | B, T, kp, k | out_v, out_i | device | stream
    lib.lira_merge_topk.argtypes = [p] * 3 + [i] * 4 + [p] * 2 + [i, p]
    for fn in (lib.lira_invert_tile_lists, lib.lira_probed_scan, lib.lira_merge_topk):
        fn.restype = i
    return lib


def pallas_probed_scan(q, tile_idx, corpus, corpus_ids, corpus_sq, k: int,
                       metric: str = "L2"):
    """(scores (B, k), ids (B, k)): the exact top-k over each query's probed
    tiles.  q (B, d) f32, tile_idx (B, T) int32 (−1 = no tile), corpus
    (n_tiles, 128, d) f32, corpus_ids / corpus_sq (n_tiles, 128).  Counts
    one launch of the scan kernel in `launches` on the card."""
    if k > 128:
        # a slot yields at most its tile's 128 rows; callers route wider
        # fetches to the XLA scan, as lira_tpu's engine does
        raise ValueError(f"pallas_probed_scan supports k <= 128 (got k={k})")
    if k < 1:
        raise ValueError(f"pallas_probed_scan needs k >= 1 (got k={k})")
    _check(q, tile_idx, corpus, corpus_ids, corpus_sq, metric)
    tensors = [q, tile_idx, corpus, corpus_ids, corpus_sq]
    devs = {t.device for t in tensors}
    cpu = devs == {torch.device("cpu")}
    if not cpu and (len(devs) != 1 or next(iter(devs)).type != "cuda"):
        raise ValueError(f"K3: inputs must all be on one CUDA device (got {devs})")
    if not cpu and not all(t.is_contiguous() for t in (corpus, corpus_ids, corpus_sq)):
        raise ValueError("K3: corpus, corpus_ids and corpus_sq must be contiguous")
    B, T = tile_idx.shape
    d = corpus.shape[2]
    tile_idx, q = tile_idx.contiguous(), q.contiguous()
    item_tile, item_pair = invert_tile_lists(tile_idx, corpus.shape[0])
    dev = corpus.device
    out_vals = torch.empty((B * T, k), dtype=torch.float32, device=dev)
    out_ids = torch.empty((B * T, k), dtype=torch.int32, device=dev)
    if cpu:
        pair_topk_ref(q, item_tile, item_pair, corpus, corpus_ids, corpus_sq, out_vals,
                      out_ids, T, metric)
    else:
        err = _lib().lira_probed_scan(
            QCHUNK, k, int(metric != "inner_product"), q.data_ptr(), item_tile.data_ptr(),
            item_pair.data_ptr(), corpus.data_ptr(), corpus_ids.data_ptr(),
            corpus_sq.data_ptr(), out_vals.data_ptr(), out_ids.data_ptr(), item_tile.shape[0],
            T, d, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"K3 launch failed: cudaError {err}")
        pallas_probed_scan.launches += 1
    return merge_topk(out_vals, out_ids, tile_idx, k)


pallas_probed_scan.launches = 0  # scan kernel launches since the last reset
