"""selection + rescore (`engine/block_scan.py::_screen_rescore`'s exact f32
rescore): round-2 steps launched per 1,000 queries of the traced calls,
from the program's counter `rescore.steps` (one a `_round2_sub` slice of a
block's queries, each ~15 launches; recorded only while a profiler
records; process-wide and never reset here, so it covers the traced calls
while the run traces one stretch of calls, as `core/loop.py::closed_loop`
does).  Wider rows stage fewer queries a step, so a block takes more steps.
None where the program keeps no such counter (a program without
`profiling.counters` included)."""


def read(ctx):
    if not ctx.traced:
        return None
    from lira_tpu_torch import profiling

    steps = getattr(profiling, "counters", dict)().get("rescore.steps")
    return 1e3 * steps / ctx.traced["queries"] if steps else None
