"""screen, K1: the least time of the work the traced calls' queries need
(`core/roofline.py::scan_bound` at the screen's dtype: 2·d per (query,
probed row) pair; each call's distinct probed rows read once, with their
norms; the queries in, k results out) over K1's device time, in %.  The
blocked engine screens each block's whole union, so this reads far below
100%: the headroom of the blocked design."""

import sys

from annbench.core.roofline import roofline_pct, scan_bound

KERNELS = ("k1_groupmin_fma", "groupmin_wgmma")
WITHIN = (r"engine/screen\.py\(\d+\): union_groupmin$",)


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    s = ctx.trace.device_s(kernels=KERNELS, within=WITHIN)
    t = ctx.traced
    b = scan_bound(t["pairs"], t["distinct_rows"], t["queries"], ctx.d, ctx.k, ctx.scan_dtype)
    print(f"[annbench] screen bound {b['seconds'] * 1e3:.4f} ms ({b['by']}) against "
          f"{s * 1e3:.3f} ms of K1", file=sys.stderr)
    return roofline_pct(b["seconds"], s)
