"""K2, the dense group-min sweep of the fused kNN: wrapper of the CUDA
kernel (csrc/groupmin.cu) and its plain PyTorch version.

Replaces lira_tpu/ops/knn_pallas.py::_groupmin_kernel.  For each query and
each 128-row group of the padded corpus, the minimum over the group of

    L2:   bsq − 2·q·x
    IP:   bsq − q·x
    int8: bsq − t_eff·(q8·x8)   (t_eff = 2t for L2, t for IP)

where `bsq` (n_groups, 128) is given by the caller: exact f32 norms (or 0)
plus the 1e30 pad penalty.  `precision`: "highest" multiplies true f32
values, "default" takes bf16 values (bf16 tables, or f32 ones rounded to
bf16) and accumulates in f32 (the TPU's default-precision pass), and int8
inputs take an exact int32 dot.  bf16 and int8 run on the tensor cores,
whose rows are whole 128-byte steps of d: `pad_cols` zero-pads a table to
that width once (zero columns change no dot); the wrapper pads, and rounds
f32 to bf16, on each call for inputs that come otherwise.

Output (Q, n_groups) f32 — the transpose of lira_tpu's (n_groups, Q): the
top-kg that follows takes one contiguous row per query.

`groupmin` launches the kernel for CUDA tensors and takes the plain version
only for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import true_fp32

GROUP = 128
_MODE = {"highest": 0, "default": 1}
# the tensor-core modes' row width: a multiple of 128 bytes
_COLS = {torch.bfloat16: 64, torch.int8: 128}
# (Q, rows) score elements the plain version holds at once
_REF_BUDGET = 1 << 28


@true_fp32()
def groupmin_ref(q, base, bsq, *, metric: str, precision: str = "highest",
                 t_eff=None) -> torch.Tensor:
    """Plain PyTorch K2, a chunk of groups at a time.  int8 dots are taken
    in f64 (exact for any d) and rounded to f32 as the kernel's int32 sum
    is.  "default" takes the inputs as bf16 values (f32 ones rounded to
    bf16 first) and their dot in f64, rounded to f32: the bf16 products are
    exact and so, at realistic value ranges, is their f64 sum, so the answer
    does not depend on zero columns or the order of the sum; the kernel's
    f32 sums differ from it by their own rounding only."""
    Q = q.shape[0]
    n_groups = base.shape[0] // GROUP
    bsq = bsq.reshape(n_groups, GROUP)
    int8 = base.dtype == torch.int8

    def widen(t):
        if int8:
            return t.double()
        return t.to(torch.bfloat16).double() if precision == "default" else t.float()

    qf = widen(q)
    out = torch.empty((Q, n_groups), dtype=torch.float32, device=base.device)
    step = max(1, _REF_BUDGET // max(Q * GROUP, 1))
    for g0 in range(0, n_groups, step):
        g1 = min(g0 + step, n_groups)
        x = widen(base[g0 * GROUP : g1 * GROUP])
        dot = (qf @ x.T).float()  # (Q, rows)
        if int8:
            dot = t_eff.reshape(()) * dot
        elif metric != "inner_product":
            dot = 2.0 * dot
        scores = bsq[g0:g1].reshape(1, -1) - dot
        out[:, g0:g1] = scores.view(Q, g1 - g0, GROUP).amin(dim=2)
    return out


def pad_cols(t: torch.Tensor) -> torch.Tensor:
    """A bf16 or int8 table zero-padded to whole 128-byte rows (itself if
    it has them)."""
    pad = -t.shape[1] % _COLS[t.dtype]
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _check(q, base, bsq, metric, precision, t_eff):
    if metric not in ("L2", "inner_product"):
        raise ValueError(f"K2: metric {metric!r}")
    floats = (torch.float32, torch.bfloat16)
    if base.dtype not in floats + (torch.int8,):
        raise TypeError(f"K2: corpus dtype {base.dtype} (expected float32, bfloat16 or int8)")
    if q.dtype != base.dtype and not (q.dtype in floats and base.dtype in floats):
        raise TypeError(f"K2: query dtype {q.dtype} != corpus dtype {base.dtype}")
    if base.dtype != torch.int8 and precision not in _MODE:
        raise ValueError(f"K2: precision {precision!r} (expected 'highest' or 'default')")
    if torch.bfloat16 in (q.dtype, base.dtype) and precision != "default":
        raise ValueError("K2: bf16 inputs take precision='default'")
    if base.dim() != 2 or base.shape[0] % GROUP or base.shape[0] == 0:
        raise ValueError(f"K2: corpus {tuple(base.shape)} is not whole 128-row groups")
    if q.dim() != 2 or q.shape[1] != base.shape[1] or q.shape[0] == 0:
        raise ValueError(f"K2: queries {tuple(q.shape)} do not match corpus d={base.shape[1]}")
    if bsq.dtype != torch.float32 or bsq.numel() != base.shape[0]:
        raise ValueError(f"K2: bsq must hold {base.shape[0]} float32 values")
    if base.dtype == torch.int8 and (t_eff is None or t_eff.numel() != 1
                                     or t_eff.dtype != torch.float32):
        raise ValueError("K2 int8: t_eff must be one float32")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it when its data is not 16-byte aligned (TMA)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel():
    """The C entry point of csrc/groupmin.cu (built at first use)."""
    from ..kernels import load

    fn = load("groupmin").lira_groupmin
    fn.restype = ctypes.c_int
    # mode, l2 | q, base, bsq, t_eff, out | Q, n_groups, d, device | stream
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def groupmin(q, base, bsq, *, metric: str, precision: str = "highest",
             t_eff=None) -> torch.Tensor:
    """K2 on queries `q` (Q, d) against the padded corpus `base`
    (n_groups·128, d), both int8 or both float (f32, or bf16 under
    "default"), with the given `bsq`.  Returns (Q, n_groups) f32 group
    minima."""
    _check(q, base, bsq, metric, precision, t_eff)
    tensors = [q, base, bsq] + ([t_eff] if base.dtype == torch.int8 else [])
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return groupmin_ref(q, base, bsq, metric=metric, precision=precision, t_eff=t_eff)
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"K2: inputs must all be on one CUDA device (got {devs})")
    int8 = base.dtype == torch.int8
    if precision == "default" and not int8:
        q, base = q.to(torch.bfloat16), base.to(torch.bfloat16)
    if base.dtype != torch.float32:  # the tensor cores' TMA rows
        q, base = pad_cols(q), pad_cols(base)
    q, base, bsq = (_aligned(t.contiguous()) for t in (q, base, bsq))
    t = t_eff.contiguous() if int8 else None  # held until the launch is queued
    fn = _kernel()
    dev = base.device
    Q, d = q.shape
    n_groups = base.shape[0] // GROUP
    out = torch.empty((Q, n_groups), dtype=torch.float32, device=dev)
    err = fn(
        2 if int8 else _MODE[precision], int(metric != "inner_product"),
        q.data_ptr(), base.data_ptr(), bsq.data_ptr(),
        t.data_ptr() if int8 else None, out.data_ptr(),
        Q, n_groups, d, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err}")
    groupmin.launches += 1
    groupmin.launches_by_dtype[str(base.dtype).removeprefix("torch.")] += 1
    return out


groupmin.launches = 0  # kernel launches since the last reset
groupmin.launches_by_dtype = Counter()  # the same, by the dtype the kernel took
