"""probe (`engine/block_scan.py::_probe_batch` and the copy of its counts:
padding, pinning, upload, the probe's launch): host ms inside the
program's `probe` spans in the traced calls, per 1,000 queries, from the
counter `probe.host_s` (read as `unions.host_ms_per_kq.py` reads
`unions.host_s`, with the same reliance on one traced stretch).  None
where the program keeps no such counter."""


def read(ctx):
    if not ctx.traced:
        return None
    from lira_tpu_torch import profiling

    s = getattr(profiling, "counters", dict)().get("probe.host_s")
    return 1e6 * s / ctx.traced["queries"] if s else None
