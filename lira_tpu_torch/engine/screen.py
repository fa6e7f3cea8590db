"""K1, the union group-min screen: wrapper of the CUDA kernel
(csrc/union_groupmin.cu) and its plain PyTorch version.

Replaces lira_tpu/engine/block_scan.py::_union_groupmin_kernel.  For each
query block i and union slot u, the 1024 rows of supertile supers[i, u]
are scored against the block's qb queries and reduced to the min over each
`sel_rows`-row group:

    L2:   ‖x‖² − 2·x·q, ‖x‖² from the rows as stored (bf16-rounded for bf16)
    IP:   −x·q
    int8: −t·(x8·q8) with t = t_eff (the caller doubles it for L2), plus
          ‖x̂‖² = Σ_d s2_d·x8_d² for L2

‖x‖² is one f32 per corpus row, `screen_norms` of the table: the engine
builds it once with the index and passes it as `xsq`; without it the
wrapper builds it for the call.  On the card bf16 and int8 run on the
tensor cores (wgmma), f32 on CUDA-core FMAs (no TF32).

Slots with u ≥ ulen[i] are union padding and come out as exactly 3e38.
Output (rows, U·SG, qb) f32, SG = 1024 / sel_rows — lira_tpu's layout;
sel_rows is any divisor of 128.  The int8 kernel takes d % 4 == 0 (a
32-bit word of the product): the engine pads its int8 table once.

`union_groupmin` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import true_fp32

S_TILES = 8  # 128-row tiles per supertile
SUPER_ROWS = S_TILES * 128
SEL_ROWS = (1, 2, 4, 8, 16, 32, 64, 128)  # group sizes K1 takes: the divisors of 128
_BIG = 3e38
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_NORM_CHUNK = 1 << 18  # rows widened to f32 at a time by screen_norms


@true_fp32()
@torch.no_grad()
def screen_norms(corpus, s2=None) -> torch.Tensor:
    """K1's ‖x‖² per row of the screen table, (n_rows,) f32, from the rows
    as stored: Σ_d x_d² (bf16 widened exactly), or Σ_d s2_d·x8_d² for an
    int8 table — the plain version's own formula, in row chunks."""
    out = torch.empty(corpus.shape[0], dtype=torch.float32, device=corpus.device)
    for s in range(0, corpus.shape[0], _NORM_CHUNK):
        x = corpus[s : s + _NORM_CHUNK].float()
        out[s : s + _NORM_CHUNK] = (x * x) @ s2.float() if corpus.dtype == torch.int8 else (
            (x * x).sum(dim=1))
    return out


@true_fp32()
def union_groupmin_ref(q, corpus, supers, ulen, *, qb: int, metric: str, sel_rows: int,
                       t_eff=None, s2=None, xsq=None) -> torch.Tensor:
    """Plain PyTorch K1 (one block row at a time).  bf16 and int8 inputs are
    widened to f32 exactly; int8 dots are exact in f32 (|x8·q8| ≤ 127²·d <
    2²⁴), and so are bf16 products, so only the f32 summation order differs
    from the kernel.  `xsq` (per-row ‖x‖², `screen_norms`) replaces the
    norms computed here from the loaded rows."""
    rows, U = supers.shape
    d = corpus.shape[1]
    SG = SUPER_ROWS // sel_rows
    sup_view = corpus.view(-1, SUPER_ROWS, d)
    sq_view = None if xsq is None else xsq.view(-1, SUPER_ROWS)
    out = torch.empty((rows, U * SG, qb), dtype=torch.float32, device=corpus.device)
    slot = torch.arange(U, device=corpus.device).repeat_interleave(SG)
    for i in range(rows):
        x = sup_view[supers[i].long()].float()  # (U, 1024, d)
        dot = torch.matmul(x, q[i * qb : (i + 1) * qb].float().T)  # (U, 1024, qb)
        if metric == "inner_product":
            xn = None
        elif sq_view is not None:
            xn = sq_view[supers[i].long()][..., None]
        elif corpus.dtype == torch.int8:
            xn = ((x * x) @ s2.float())[..., None]
        else:
            xn = (x * x).sum(dim=-1, keepdim=True)
        if corpus.dtype == torch.int8:
            scores = -t_eff.reshape(()) * dot
            if xn is not None:
                scores = xn + scores
        elif xn is None:
            scores = -dot
        else:
            scores = xn - 2.0 * dot
        mins = scores.view(U, SG, sel_rows, qb).amin(dim=2).view(U * SG, qb)
        out[i] = torch.where((slot >= ulen[i])[:, None], _BIG, mins)
    return out


def _check(q, corpus, supers, ulen, qb, metric, sel_rows, t_eff, s2, xsq):
    if corpus.dtype not in _DTYPE_CODE:
        raise TypeError(f"K1: corpus dtype {corpus.dtype} (expected float32, bfloat16, int8)")
    if q.dtype != corpus.dtype:
        raise TypeError(f"K1: query dtype {q.dtype} != corpus dtype {corpus.dtype}")
    if supers.dtype != torch.int32 or ulen.dtype != torch.int32:
        raise TypeError("K1: supers and ulen must be int32")
    if metric not in ("L2", "inner_product"):
        raise ValueError(f"K1: metric {metric!r}")
    if sel_rows not in SEL_ROWS:
        raise ValueError(f"K1: sel_rows={sel_rows} (the kernel takes a divisor of 128)")
    if corpus.dim() != 2 or corpus.shape[0] % SUPER_ROWS:
        raise ValueError(f"K1: corpus {tuple(corpus.shape)} is not whole supertiles")
    if supers.dim() != 2:
        raise ValueError(f"K1: supers {tuple(supers.shape)} must be (rows, U)")
    rows, U = supers.shape
    d = corpus.shape[1]
    if q.shape != (rows * qb, d):
        raise ValueError(f"K1: queries {tuple(q.shape)} != ({rows}·{qb}, {d})")
    if ulen.shape != (rows,):
        raise ValueError(f"K1: ulen {tuple(ulen.shape)} != ({rows},)")
    if corpus.dtype == torch.int8:
        if t_eff is None or t_eff.numel() != 1 or t_eff.dtype != torch.float32:
            raise ValueError("K1 int8: t_eff must be one float32")
        if s2 is None or s2.shape != (d,) or s2.dtype != torch.float32:
            raise ValueError(f"K1 int8: s2 must be ({d},) float32")
        if d % 4:
            raise ValueError(f"K1 int8: d={d} must be a multiple of 4 (BlockScanState "
                             f"zero-pads its int8 table, and screen_queries the queries "
                             f"and s2, to the next multiple)")
    if xsq is not None and (xsq.shape != (corpus.shape[0],) or xsq.dtype != torch.float32):
        raise ValueError(f"K1: xsq must be ({corpus.shape[0]},) float32 (one norm per row)")
    return rows, U, d


def _kernel():
    """The C entry point of csrc/union_groupmin.cu (built at first use)."""
    from ..kernels import load

    fn = load("union_groupmin").lira_union_groupmin
    fn.restype = ctypes.c_int
    # dtype, l2 | q, corpus, supers, ulen, t_eff, xsq, out | rows, U, qb, d,
    # n_rows, sel_rows, device | stream
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


def union_groupmin(q, corpus, supers, ulen, *, qb: int, metric: str, sel_rows: int,
                   t_eff=None, s2=None, xsq=None) -> torch.Tensor:
    """K1 on (rows·qb, d) queries `q` of block rows [0, rows) against the
    supertiles `supers` (rows, U) int32 of `corpus` (n_super·1024, d), both
    in the screen dtype.  `xsq`: the table's `screen_norms` (L2; built here
    when None).  Returns (rows, U·SG, qb) f32 group minima."""
    rows, U, d = _check(q, corpus, supers, ulen, qb, metric, sel_rows, t_eff, s2, xsq)
    l2 = metric != "inner_product"
    int8 = corpus.dtype == torch.int8
    tensors = [q, corpus, supers, ulen] + ([t_eff, s2] if int8 else []) + (
        [xsq] if xsq is not None else [])
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return union_groupmin_ref(q, corpus, supers, ulen, qb=qb, metric=metric,
                                  sel_rows=sel_rows, t_eff=t_eff, s2=s2, xsq=xsq)
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"K1: inputs must all be on one CUDA device (got {devs})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K1: inputs must be contiguous")
    if l2 and xsq is None:
        xsq = screen_norms(corpus, s2)
    if l2 and xsq.data_ptr() % 16:  # the kernel copies norms 16 bytes at a time
        xsq = xsq.clone()
    fn = _kernel()
    dev = corpus.device
    SG = SUPER_ROWS // sel_rows
    out = torch.empty((rows, U * SG, qb), dtype=torch.float32, device=dev)
    err = fn(
        _DTYPE_CODE[corpus.dtype], int(l2),
        q.data_ptr(), corpus.data_ptr(), supers.data_ptr(), ulen.data_ptr(),
        t_eff.data_ptr() if int8 else None, xsq.data_ptr() if l2 else None,
        out.data_ptr(), rows, U, qb, d, corpus.shape[0], sel_rows, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    union_groupmin.launches += 1
    union_groupmin.launches_by_dtype[str(corpus.dtype).removeprefix("torch.")] += 1
    return out


union_groupmin.launches = 0  # kernel launches since the last reset
union_groupmin.launches_by_dtype = Counter()  # the same, by screen dtype
