"""per-query scan, K3: the least time of the work the traced requests'
queries need (`core/roofline.py::scan_bound` in f32: 2·d per (query,
probed row) pair; each request's distinct probed rows read once, with
their norms; the queries in, k results out) over K3's device time, in %."""

import sys

from annbench.core.roofline import roofline_pct, scan_bound

KERNELS = ("invert_count_kernel", "invert_scan_kernel", "invert_scatter_kernel",
           "tile_scan_kernel", "merge_kernel")
WITHIN = (r"engine/pallas_scan\.py\(\d+\): ",)


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    s = ctx.trace.device_s(kernels=KERNELS, within=WITHIN)
    t = ctx.traced
    b = scan_bound(t["pairs"], t["distinct_rows"], t["queries"], ctx.d, ctx.k, "float32")
    print(f"[annbench] K3 bound {b['seconds'] * 1e3:.4f} ms ({b['by']}) against "
          f"{s * 1e3:.3f} ms of K3", file=sys.stderr)
    return roofline_pct(b["seconds"], s)
