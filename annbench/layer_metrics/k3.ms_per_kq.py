"""per-query scan, K3 (`engine/pallas_scan.py::pallas_probed_scan` ->
`csrc/probed_scan.cu`: list inversion, tile-major scan, merge): device ms
of its kernels in the traced requests, per 1,000 queries."""

KERNELS = ("invert_count_kernel", "invert_scan_kernel", "invert_scatter_kernel",
           "tile_scan_kernel", "merge_kernel")
WITHIN = (r"engine/pallas_scan\.py\(\d+\): ",)


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    s = ctx.trace.device_s(kernels=KERNELS, within=WITHIN)
    return 1e6 * s / ctx.traced["queries"] if s > 0 else None
