"""screen, K1: the share of the (query, row) pairs K1 screened in the
traced calls that a query probed, in %: 100 × Σ `SearchResult.ndis` of
the traced calls' queries over the program's counter `screen.pairs`
(`engine/block_scan.py::_dispatch_scan`: each block's queries against
every row of its union's supertiles, pad queries included; recorded only
while a profiler records; process-wide and never reset here, so it
covers the traced calls while the run traces one stretch of calls, as
`core/loop.py::closed_loop` does).  The headroom of the blocked design:
K1 screens whole unions, not the rows a query probed.  None where the
program keeps no such counter (a program without `profiling.counters`
included)."""


def read(ctx):
    if not ctx.traced:
        return None
    from lira_tpu_torch import profiling

    pairs = getattr(profiling, "counters", dict)().get("screen.pairs")
    if not pairs:
        return None
    tp = ctx.cell["traffic"]
    traced = ctx.calls[tp["trace_from"] : tp["trace_from"] + tp["trace_calls"]]
    return 100.0 * sum(int(c.ndis.sum()) for c in traced) / pairs
