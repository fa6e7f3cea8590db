"""Reads a Chrome trace of `lira_tpu_torch.profiling.device_trace` by the
port's spans (`profiling.span`, `user_annotation` events), through the
benchmark's trace reader (`annbench/core/trace.py::Trace`) with the spans
in the place of Python frames.

    python scripts/torch_trace_spans.py <log_dir>/trace.json

Prints one JSON object: the traced stretch's wall, busy and idle seconds
of the device, and for each span name: `n`, `host_self_s` (its time less
that of the spans it encloses), `device_s` (device operations launched
while it was the innermost open span on the launching thread) and
`idle_s` (the device's idle stretches whose middle fell while it was the
innermost open span on the caller's thread, as `Trace.breakdown` labels
them); `(no span)` holds what lay outside every span.  Imports nothing of
the port.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from annbench.core.trace import Trace  # noqa: E402

NO_SPAN = "(no span)"


def span_trace(events: list[dict]) -> Trace:
    """The `Trace` of `events` with the spans as its Python frames (any
    frames the profiler recorded are left out)."""
    return Trace([dict(e, cat="python_function") if e.get("cat") == "user_annotation" else e
                  for e in events if e.get("cat") != "python_function"])


def _host_self(spans: list[dict]) -> list[tuple[str, float]]:
    """(name, µs) of each span of one thread, less its child spans."""
    out, stack = [], []  # stack: [name, end, self]
    for e in sorted(spans, key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0)))):
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        while stack and stack[-1][1] <= ts:
            out.append(tuple(stack.pop()[::2]))
        if stack:
            stack[-1][2] -= dur
        stack.append([e["name"], ts + dur, dur])
    return out + [tuple(s[::2]) for s in stack]


def summarize(events: list[dict]) -> dict:
    tr = span_trace(events)
    out: dict = {}

    def entry(name):
        return out.setdefault(name, {"n": 0, "host_self_s": 0.0, "device_s": 0.0, "idle_s": 0.0})

    by_tid: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            by_tid.setdefault(e.get("tid"), []).append(e)
    for spans in by_tid.values():
        for name, us in _host_self(spans):
            entry(name)["n"] += 1
            entry(name)["host_self_s"] += us / 1e6
    for op in tr.ops:
        entry(op.frames[-1] if op.frames else NO_SPAN)["device_s"] += op.dur / 1e6
    for label, s in tr.breakdown(top=len(tr.gaps))["idle_gaps"]:
        entry(NO_SPAN if label == "(no Python frame)" else label)["idle_s"] += s
    return {"window_s": tr.window_s, "busy_s": tr.busy_s,
            "idle_s": tr.window_s - tr.busy_s, "spans": out}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        doc = json.load(f)
    print(json.dumps(summarize(doc["traceEvents"] if isinstance(doc, dict) else doc), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
