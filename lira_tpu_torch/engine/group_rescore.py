"""The blocked engine's exact round-2 rescore: wrapper of the CUDA kernel
(csrc/group_rescore.cu) and its plain PyTorch version.

For one query block: queries q (qb, d) f32; the selected global groups
ggrp (qb, kg) int64 and their selection values vals (qb, kg) f32 (a slot
is valid where vals > −1.5e38); the table (n_groups, sel_rows, d) in f32,
bf16 or int8 (widened exactly; int8's per-dim scale already folded into
q); its norms bsq and ids (n_groups, sel_rows), f32 and int32.  Each
candidate row (slot j, row r, flat position j·sel_rows + r) scores

    s = bsq − 2·dot (L2),  bsq − dot (inner product),

3e38 where its slot is invalid or its id is −1.  Output: each query's
k_loc largest −s, descending, the lower flat position first among equal
values (`ops.topk.top_k`'s order), as (neg (qb, k_loc) f32, ids (qb,
k_loc) int32), the id −1 where neg ≤ −1.5e38.  The kernel accumulates the
dot in f32 in another order than the plain version's matrix product, and
neither reads nor ranks dead candidates: the plain version's 3e38 plus
|s| < 2^103 rounds to 3e38, so both fill a short list with (−3e38, −1).

Replaces no Pallas kernel: the JAX package rescores in XLA
(lira_tpu/engine/block_scan.py::_screen_rescore's round 2).

`exact_group_rescore` launches the kernel for CUDA tensors and takes the
plain version, `_round2_sub` queries a step, only for CPU tensors; there is
no fallback between the two.  Under a recording profiler it counts
`rescore.steps` (one a launch, or one a plain step) and `rescore.rows`
(qb·kg·sel_rows a call, the candidate rows it is asked to score), on the
host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.topk import top_k
from ..profiling import count

_BIG = 3e38
# device bytes of the plain version's gather (sub, kg, sel_rows, d) f32 a step
_R2_BUDGET = 1 << 30
# the kernel's candidate buffer, keys a CTA (csrc/group_rescore.cu): at
# least four times k_loc rounded up to a power of two, and never below this
_CAP_MIN = 4096
_SMEM = 232448  # shared memory a CTA may hold on an H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _round2_sub(kg: int, sel_rows: int, d: int, qb: int) -> int:
    """Queries per step of the plain version: its gather stages (sub, kg,
    sel_rows, d) f32, bounded by _R2_BUDGET; a power of two, at most qb."""
    budget = _R2_BUDGET // max(kg * sel_rows * d * 4, 1)
    sub = 1 << max(0, int(budget).bit_length() - 1)
    return max(1, min(sub, qb))


def exact_group_rescore_ref(q, vals, ggrp, table, bsq, ids, *, metric: str, k_loc: int,
                            sub: int):
    """Plain PyTorch rescore, `sub` queries a step: the group gather, a
    batched matrix-vector product in f32, the norms' and ids' gathers and
    `top_k` over every candidate."""
    kg = ggrp.shape[1]
    sel_rows, d = table.shape[1], table.shape[2]
    valid = vals > -(_BIG / 2)
    negs, oids = [], []
    for s in range(0, q.shape[0], sub):
        qs, sg, val = q[s : s + sub], ggrp[s : s + sub], valid[s : s + sub]
        n = qs.shape[0]
        vec = table[sg].float().view(n, kg * sel_rows, d)  # group gather
        dot = torch.bmm(vec, qs[:, :, None]).view(n, kg, sel_rows)
        sq = bsq[sg]
        score = sq - dot if metric == "inner_product" else sq - 2.0 * dot
        oid = ids[sg]
        score = score + torch.where(val, 0.0, _BIG)[:, :, None]
        score = torch.where(oid >= 0, score, _BIG)
        neg, pos = top_k(-score.view(n, kg * sel_rows), k_loc)
        oid = torch.gather(oid.view(n, kg * sel_rows), 1, pos)
        negs.append(neg)
        oids.append(torch.where(neg > -(_BIG / 2), oid, -1))
    return torch.cat(negs), torch.cat(oids)


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points of csrc/group_rescore.cu (built at first use)."""
    from ..kernels import load

    lib = load("group_rescore")
    fn = lib.lira_group_rescore
    fn.restype = ctypes.c_int
    # q, d, vals, ggrp, qb, kg, table, dtype, vec, bsq, ids, sel_rows, ip,
    # k_loc, cap, out_neg, out_ids, device, stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    lib.lira_group_rescore_smem.restype = ctypes.c_longlong
    lib.lira_group_rescore_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def exact_group_rescore(q, vals, ggrp, table, bsq, ids, *, metric: str, k_loc: int):
    """Each query's top-`k_loc` exact scores over its selected groups (see
    the module docstring): (neg (qb, k_loc) f32, ids (qb, k_loc) int32);
    1 ≤ k_loc ≤ kg·sel_rows."""
    if table.dim() != 3 or table.dtype not in _DTYPES:
        raise ValueError(f"exact_group_rescore: table must be (n_groups, sel_rows, d) "
                         f"float32, bfloat16 or int8 ({tuple(table.shape)}, {table.dtype})")
    _, sel_rows, d = table.shape
    if q.dim() != 2 or q.shape[1] != d or q.dtype != torch.float32:
        raise ValueError(f"exact_group_rescore: q must be (qb, {d}) float32 "
                         f"({tuple(q.shape)}, {q.dtype})")
    qb = q.shape[0]
    if ggrp.dim() != 2 or ggrp.shape[0] != qb or ggrp.dtype != torch.int64:
        raise ValueError(f"exact_group_rescore: ggrp must be ({qb}, kg) int64 "
                         f"({tuple(ggrp.shape)}, {ggrp.dtype})")
    kg = ggrp.shape[1]
    if vals.shape != (qb, kg) or vals.dtype != torch.float32:
        raise ValueError(f"exact_group_rescore: vals must be ({qb}, {kg}) float32 "
                         f"({tuple(vals.shape)}, {vals.dtype})")
    if bsq.shape != table.shape[:2] or bsq.dtype != torch.float32:
        raise ValueError(f"exact_group_rescore: bsq must be {tuple(table.shape[:2])} float32 "
                         f"({tuple(bsq.shape)}, {bsq.dtype})")
    if ids.shape != table.shape[:2] or ids.dtype != torch.int32:
        raise ValueError(f"exact_group_rescore: ids must be {tuple(table.shape[:2])} int32 "
                         f"({tuple(ids.shape)}, {ids.dtype})")
    if metric not in ("L2", "inner_product"):
        raise ValueError(f"exact_group_rescore: unknown metric {metric!r}")
    if not 1 <= k_loc <= kg * sel_rows:
        raise ValueError(f"exact_group_rescore: k_loc={k_loc} outside [1, {kg * sel_rows}]")
    tensors = (q, vals, ggrp, table, bsq, ids)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("exact_group_rescore: inputs must be contiguous")
    dev = q.device
    if dev.type == "cpu" and all(t.device == dev for t in tensors):
        sub = _round2_sub(kg, sel_rows, d, qb)
        count("rescore.steps", -(-qb // sub))
        count("rescore.rows", qb * kg * sel_rows)
        return exact_group_rescore_ref(q, vals, ggrp, table, bsq, ids, metric=metric,
                                       k_loc=k_loc, sub=sub)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"exact_group_rescore: inputs must all be on one CUDA device "
                         f"(got {[t.device for t in tensors]})")
    if kg * sel_rows >= 1 << 31:
        raise ValueError(f"exact_group_rescore: {kg} x {sel_rows} candidates a query "
                         f"exceed 32-bit positions")
    cap = max(_CAP_MIN, 4 << (k_loc - 1).bit_length())
    lib = _lib()
    if lib.lira_group_rescore_smem(d, cap) > _SMEM:
        raise ValueError(f"exact_group_rescore: k_loc={k_loc} at d={d} needs a buffer of "
                         f"{cap} keys beside the query, above the {_SMEM} bytes of shared "
                         f"memory a CTA holds")
    # 16-byte loads where the table and each row are 16-byte aligned
    vec = int(table.data_ptr() % 16 == 0 and d * table.element_size() % 16 == 0)
    neg = torch.empty((qb, k_loc), dtype=torch.float32, device=dev)
    out_ids = torch.empty((qb, k_loc), dtype=torch.int32, device=dev)
    err = lib.lira_group_rescore(
        q.data_ptr(), d, vals.data_ptr(), ggrp.data_ptr(), qb, kg, table.data_ptr(),
        _DTYPES[table.dtype], vec, bsq.data_ptr(), ids.data_ptr(), sel_rows,
        int(metric == "inner_product"), k_loc, cap, neg.data_ptr(), out_ids.data_ptr(),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"exact_group_rescore launch failed: cudaError {err}")
    exact_group_rescore.launches += 1
    count("rescore.steps", 1)
    count("rescore.rows", qb * kg * sel_rows)
    return neg, out_ids


exact_group_rescore.launches = 0  # kernel calls (one a block)
