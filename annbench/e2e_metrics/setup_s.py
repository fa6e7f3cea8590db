"""Seconds from the process's start to the first timed call: the inputs
drawn, the index built, the engine made and calibrated, one warm-up call
(and, in a fresh checkout, the kernels compiled); less the reference's
seconds in between (the build queries' ground truth, a quantile
threshold's probe outputs)."""


def read(ctx):
    return ctx.setup_s
