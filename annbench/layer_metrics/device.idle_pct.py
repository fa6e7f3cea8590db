"""device (one H100): the share of the traced stretch's wall time in which
no operation runs on the device (the union of kernel, copy and fill
intervals, as `chip_smoke.py::profile_device` takes it), in %."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
