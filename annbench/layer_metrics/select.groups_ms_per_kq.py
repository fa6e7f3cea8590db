"""masked group selection (`engine/block_scan.py::_screen_rescore`: each
block's `block_penalty`, its `select_slice` (penalty gather, masked add,
top-k over the union's groups) and, where the union is screened in
slices, the `top_k` that merges a slice into the carry): device ms of the
kernels launched there in the traced calls, per 1,000 queries (attributed
by the Python frames around each launch).  One part of
`select.ms_per_kq`."""

import re

SELECT = re.compile(r"engine/block_scan\.py\(\d+\): (block_penalty|select_slice)$")
OUTER = re.compile(r"engine/block_scan\.py\(\d+\): _screen_rescore$")
MERGE = re.compile(r"ops/topk\.py\(\d+\): top_k$")


def _selects(frames) -> bool:
    for i, f in enumerate(frames):
        if SELECT.search(f):
            return True
        if OUTER.search(f) and i + 1 < len(frames) and MERGE.search(frames[i + 1]):
            return True  # the carry merge: top_k called by _screen_rescore itself
    return False


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    s = sum(op.dur for op in ctx.trace.ops if _selects(op.frames)) / 1e6
    return 1e6 * s / ctx.traced["queries"] if s > 0 else None
