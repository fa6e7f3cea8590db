"""host unions (`engine/block_scan.py::_dispatch_scan`: `build_block_unions`
and the uploads of its result): host ms inside the program's `unions`
spans in the traced calls, per 1,000 queries, from the counter
`unions.host_s` that each such span adds its host seconds to while a
profiler records.  The program's counters are process-wide and never
reset here, so this holds while the run traces one stretch of calls, as
`core/loop.py::closed_loop` does.  None where the program keeps no such
counter (a program without `profiling.counters` included)."""


def read(ctx):
    if not ctx.traced:
        return None
    from lira_tpu_torch import profiling

    s = getattr(profiling, "counters", dict)().get("unions.host_s")
    return 1e6 * s / ctx.traced["queries"] if s else None
