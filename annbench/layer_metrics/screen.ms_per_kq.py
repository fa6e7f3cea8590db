"""screen, K1 (`engine/screen.py::union_groupmin` -> `csrc/union_groupmin.cu`):
device ms of K1's kernels in the traced calls, per 1,000 queries."""

KERNELS = ("k1_groupmin_fma", "groupmin_wgmma")
WITHIN = (r"engine/screen\.py\(\d+\): union_groupmin$",)


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    s = ctx.trace.device_s(kernels=KERNELS, within=WITHIN)
    return 1e6 * s / ctx.traced["queries"] if s > 0 else None
