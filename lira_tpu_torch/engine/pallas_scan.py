"""K3, the per-query probed-tile scan: wrapper of the CUDA kernel
(csrc/probed_scan.cu) and its plain PyTorch version.

Replaces lira_tpu/engine/pallas_scan.py::_scan_kernel.  For each query, an
exact top-k over the rows of its own tiles (a (B, T) list, −1 = no tile):

    L2:  sq − 2·q·x    (sq: the f32 row norm, 3e38 on padding rows)
    IP:  sq − q·x      (sq: 0 on valid rows, 3e38 on padding rows)

Rows with id < 0 score 3e38; a slot whose score is ≥ 1e37 comes out as id
−1 (its score stays 3e38).  k ≤ 128: the kernel keeps a sorted stack of R
rows per row position ("lane") of a tile, and a stack at least k deep per
lane is what makes the per-lane top-k exact.  lira_tpu's engine sends
wider fetches to its XLA scan, and so does this port's (engine/serve.py).

The kernel writes the stacks, (B, R, 128) values and ids, and this wrapper
takes the final top-k over the R·128 candidates with the port's `top_k`,
as lira_tpu takes it in XLA outside its kernel.  Of two equal scores the
stacks keep the earlier tile's row, and the final top-k the lower flat
index; the plain version ranks tile-major instead, so the two may pick
different rows only among exactly equal scores.

Dropped from lira_tpu's wrapper, being TPU-shaped: the SMEM sub-batching
of the tile list (`smem_budget`), the 8-sublane query replication, the
`r_pad` rounding to 8, and the `interpret` / `double_buffer` switches (the
CPU runs the plain version; the kernel always double-buffers, four deep).

`pallas_probed_scan` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from .. import true_fp32
from ..ops.topk import top_k

_BIG = 3e38
_STACK_ROWS = (8, 16, 32, 64, 128)  # the kernel's compiled stack depths
# (rows, T·128, d) f32 elements the plain version gathers at once
_REF_BUDGET = 1 << 28


def stack_rows(k: int) -> int:
    """The kernel's per-lane stack depth for a top-k: the smallest compiled
    depth ≥ k (a deeper stack holds more candidates, never fewer)."""
    return next(r for r in _STACK_ROWS if r >= k)


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


def _kernel():
    """The C entry point of csrc/probed_scan.cu (built at first use)."""
    from ..kernels import load

    fn = load("probed_scan").lira_probed_scan
    fn.restype = ctypes.c_int
    # R, l2 | q, tile_idx, corpus, ids, sq, out_vals, out_ids | B, T, d,
    # device | stream
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def pallas_probed_scan(q, tile_idx, corpus, corpus_ids, corpus_sq, k: int,
                       metric: str = "L2"):
    """(scores (B, k), ids (B, k)): the exact top-k over each query's probed
    tiles.  q (B, d) f32, tile_idx (B, T) int32 (−1 = no tile), corpus
    (n_tiles, 128, d) f32, corpus_ids / corpus_sq (n_tiles, 128)."""
    if k > 128:
        # the per-lane stacks hold at most 128 rows; callers route wider
        # fetches to the XLA scan, as lira_tpu's engine does
        raise ValueError(f"pallas_probed_scan supports k <= 128 (got k={k})")
    _check(q, tile_idx, corpus, corpus_ids, corpus_sq, metric)
    tensors = [q, tile_idx, corpus, corpus_ids, corpus_sq]
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return probed_scan_ref(q, tile_idx, corpus, corpus_ids, corpus_sq, k, metric)
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"K3: inputs must all be on one CUDA device (got {devs})")
    if not all(t.is_contiguous() for t in (corpus, corpus_ids, corpus_sq)):
        raise ValueError("K3: corpus, corpus_ids and corpus_sq must be contiguous")
    B, T = tile_idx.shape
    d = corpus.shape[2]
    tile_idx, q = tile_idx.contiguous(), q.contiguous()  # the kernel skips −1 entries
    R = stack_rows(k)
    dev = corpus.device
    out_vals = torch.empty((B, R, 128), dtype=torch.float32, device=dev)
    out_ids = torch.empty((B, R, 128), dtype=torch.int32, device=dev)
    fn = _kernel()
    err = fn(R, int(metric != "inner_product"), q.data_ptr(), tile_idx.data_ptr(),
             corpus.data_ptr(), corpus_ids.data_ptr(), corpus_sq.data_ptr(),
             out_vals.data_ptr(), out_ids.data_ptr(), B, T, d, dev.index or 0,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    pallas_probed_scan.launches += 1
    return _finish_topk(out_vals.view(B, R * 128), out_ids.view(B, R * 128), k)


pallas_probed_scan.launches = 0  # kernel launches since the last reset
