"""selection + rescore (`engine/block_scan.py::_screen_rescore`,
`_dedup_topk_dev`): device ms of the kernels these functions launch, other
than K1's, in the traced calls, per 1,000 queries (attributed by the
Python frames around each launch)."""

WITHIN = (r"engine/block_scan\.py\(\d+\): _screen_rescore$",
          r"engine/block_scan\.py\(\d+\): _dedup_topk_dev$")
K1 = ("k1_groupmin_fma", "groupmin_wgmma")


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    s = ctx.trace.device_s(within=WITHIN, exclude=K1)
    return 1e6 * s / ctx.traced["queries"] if s > 0 else None
