"""The 95th percentile of the window's per-request latency, from the call
to its results on the host (host clock), over every request."""

import numpy as np


def read(ctx):
    lat = [c.end - c.start for c in ctx.calls]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
