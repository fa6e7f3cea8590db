"""probe: the mean `SearchResult.ndis` (rows in the probed buckets, counted
by the engine) over the window's queries, as % of the corpus rows."""

import numpy as np


def read(ctx):
    if not ctx.calls:
        return None
    return 100.0 * float(np.concatenate([c.ndis for c in ctx.calls]).mean()) / ctx.n
