"""rescore (`engine/block_scan.py::_screen_rescore`'s `rescore`: the group
gather, the exact f32 `bmm` and its top-k): device ms of the kernels
launched inside `rescore` in the traced calls, per 1,000 queries
(attributed by the Python frames around each launch).  One part of
`select.ms_per_kq`."""

WITHIN = (r"engine/block_scan\.py\(\d+\): rescore$",)


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    s = ctx.trace.device_s(within=WITHIN)
    return 1e6 * s / ctx.traced["queries"] if s > 0 else None
