"""The blocked engine's masked group selection: wrapper of the CUDA kernel
(csrc/group_select.cu) and its plain PyTorch version.

For one query block's K1 output `gmin` (n_g, qb) f32 and the bucket of
each group `tb` (n_g,) int32 (−1: a padding group), each query's top-kg of

    −(gmin[g, q] + pen),  pen = 0.0 where the query probed tb[g], else 3e38,

descending, the lower group first among equal values (`ops.topk.top_k`'s
order): (vals (qb, kg) f32, positions on the group axis (qb, kg) int64).
Groups at and past `n_live` are the union's padding slots, which K1 writes
as exactly 3e38 and whose tb is −1: their value is −inf, so they rank last,
in order.  The kernel never reads them; the plain version computes them.

Replaces no Pallas kernel: the JAX package selects in XLA
(lira_tpu/engine/block_scan.py::_screen_rescore's `select_slice`).

`masked_group_topk` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.topk import top_k

_BIG = 3e38
# bytes of masked minima, (n_g, queries) f32, the plain version selects at a
# time: its temporaries (the penalty gather, the masked and negated copies,
# top_k's int64 keys) are ~6× that, whatever sel_rows makes of n_g
_SEL_BUDGET = 256 << 20
# the kernel's plan: shared memory a CTA may hold (an H100's 227 KB), the
# pending entries beside each list (csrc/group_select.cu's PEND), warps a
# CTA, and sorted lists a query's merge takes (MAX_LISTS)
_SMEM = 232448
_PEND = 64
_MAX_WARPS = 8
_MAX_LISTS = 64


def masked_group_topk_ref(gmin, tb, probed, n_live, kg: int, *, unit: int = 1):
    """Plain PyTorch selection: the penalty table, its gather by bucket, the
    masked add and `top_k` over every group, `_SEL_BUDGET` bytes of groups
    at a time.  `n_live` and `unit` are not read: the padding slots' −inf
    comes out of the arithmetic."""
    n_g, qb = gmin.shape
    pen = torch.where(probed.T, 0.0, _BIG).float()  # (n_bkt, qb)
    # row n_bkt: the catch-all penalty of padding groups (tb == −1)
    pen = torch.cat([pen, pen.new_full((1, qb), _BIG)], dim=0)
    tbx = torch.where(tb >= 0, tb, pen.shape[0] - 1).long()
    step = max(1, _SEL_BUDGET // (n_g * 4))
    vals, sel = [], []
    for q0 in range(0, qb, step):
        masked = gmin[:, q0 : q0 + step] + pen[tbx, q0 : q0 + step]  # (n_g, step)
        v, i = top_k(-masked.T, kg)
        vals.append(v)
        sel.append(i)
    return torch.cat(vals), torch.cat(sel)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def select_plan(n_bkt: int, qb: int, kg: int, sms: int = 132) -> dict:
    """The kernel's launch plan: `qt` queries a CTA (32, or 16 or 8 where a
    warp's lists of kg keys would not fit in shared memory), `warps` a CTA
    (as many lists as fit), `chunks` of the live groups (one CTA an SM, ≤
    `_MAX_LISTS` lists a query), `kk` keys a pass (kg, or what fits at qt
    8: larger kg runs in `passes`) and the list `stride` (a lane's list,
    its pending keys and the room to sort them: a power of two, + 1)."""
    room = _SMEM - -(-n_bkt * 4 // 16) * 16  # less the probed bits of each bucket
    for qt in (32, 16, 8):
        # the CTA's thresholds, and one warp's lists of n_sort + 1 keys
        n_sort = 1 << max(0, (room // (qt * 8) - 2).bit_length() - 1)
        kk_max = n_sort - _PEND
        if kg <= kk_max:
            break
    if kk_max < 1:
        raise ValueError(f"masked_group_topk: n_bkt={n_bkt} leaves no shared memory for "
                         f"the lists")
    kk = min(kg, kk_max)
    stride = 1 << (kk + _PEND - 1).bit_length()
    stride += 1  # odd: lanes' lists start in distinct banks
    warps = min(_MAX_WARPS, (room - qt * 8) // (qt * stride * 8))
    qtiles = -(-qb // qt)
    chunks = max(1, min(_MAX_LISTS // warps, sms // qtiles))
    return dict(qt=qt, warps=warps, chunks=chunks, kk=kk, stride=stride,
                passes=-(-kg // kk))


_plan = functools.lru_cache(maxsize=None)(select_plan)  # a call's plan, once a shape


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/group_select.cu (built at first use)."""
    from ..kernels import load

    fn = load("group_select").lira_group_select
    fn.restype = ctypes.c_int
    # gmin, tb, probed, live | unit, n_g, qb, n_bkt, kg, qt, warps, chunks,
    # kk_pass, stride | part, bound, out_v, out_i | device | stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    return fn


def masked_group_topk(gmin, tb, probed, n_live, kg: int, *, unit: int = 1):
    """Each query's top-`kg` masked groups of one block (see the module
    docstring): (vals (qb, kg) f32, positions (qb, kg) int64).  gmin (n_g,
    qb) f32, tb (n_g,) int32, probed (qb, n_bkt) bool; `n_live`: a
    one-element int32 tensor of live union slots, `unit` groups each (live
    groups = min(n_live·unit, n_g)); 1 ≤ kg ≤ n_g."""
    if gmin.dim() != 2 or gmin.dtype != torch.float32:
        raise ValueError(f"masked_group_topk: gmin must be (n_g, qb) float32 "
                         f"({tuple(gmin.shape)}, {gmin.dtype})")
    n_g, qb = gmin.shape
    if tb.shape != (n_g,) or tb.dtype != torch.int32:
        raise ValueError(f"masked_group_topk: tb must be ({n_g},) int32 "
                         f"({tuple(tb.shape)}, {tb.dtype})")
    if probed.dim() != 2 or probed.shape[0] != qb or probed.dtype != torch.bool:
        raise ValueError(f"masked_group_topk: probed must be ({qb}, n_bkt) bool "
                         f"({tuple(probed.shape)}, {probed.dtype})")
    if n_live.shape != (1,) or n_live.dtype != torch.int32:
        raise ValueError(f"masked_group_topk: n_live must be (1,) int32 "
                         f"({tuple(n_live.shape)}, {n_live.dtype})")
    if not 1 <= kg <= n_g:
        raise ValueError(f"masked_group_topk: kg={kg} outside [1, {n_g}]")
    dev = gmin.device
    tensors = (gmin, tb, probed, n_live)
    if dev.type == "cpu" and all(t.device == dev for t in tensors):
        return masked_group_topk_ref(gmin, tb, probed, n_live, kg, unit=unit)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"masked_group_topk: inputs must all be on one CUDA device "
                         f"(got {[t.device for t in tensors]})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("masked_group_topk: inputs must be contiguous")
    n_bkt = probed.shape[1]
    plan = _plan(n_bkt, qb, kg, _sm_count(dev.index or 0))
    part = torch.empty((plan["chunks"] * plan["warps"], plan["kk"], qb), dtype=torch.int64,
                       device=dev)
    bound = torch.empty(qb, dtype=torch.int64, device=dev) if plan["passes"] > 1 else None
    vals = torch.empty((qb, kg), dtype=torch.float32, device=dev)
    idx = torch.empty((qb, kg), dtype=torch.int64, device=dev)
    err = _kernel()(
        gmin.data_ptr(), tb.data_ptr(), probed.data_ptr(), n_live.data_ptr(), unit, n_g, qb,
        n_bkt, kg, plan["qt"], plan["warps"], plan["chunks"], plan["kk"], plan["stride"],
        part.data_ptr(), None if bound is None else bound.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"masked_group_topk launch failed: cudaError {err}")
    masked_group_topk.launches += 1
    return vals, idx


masked_group_topk.launches = 0  # kernel calls (one a block, or a block's U-slice)
