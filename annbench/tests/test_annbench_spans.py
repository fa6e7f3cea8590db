"""The readers of the program's spans and counters, on the CPU at the tiny
size: a traced run of the stream cell reports each of them, and the
program's spans leave every other per-layer reading of a recorded trace
as it was.  The CPU profiler records no device operation, so where a
reader needs one the recorded trace gets a stand-in: each CPU operator
mirrored as a kernel launched and run at its own time."""

from __future__ import annotations

import numpy as np
import pytest

from annbench.core import trace as trace_mod
from annbench.core.runner import Ctx
from annbench.tests.annbench_tiny import make_registry, run

NEW = ("select.groups_ms_per_kq", "rescore.ms_per_kq", "screen.useful_pct",
       "unions.host_ms_per_kq", "probe.host_ms_per_kq", "build.epoch_s")
# the readers of the program's counters, calls or stage lines, not of the trace
OFF_TRACE = ("screen.useful_pct", "unions.host_ms_per_kq", "probe.host_ms_per_kq",
             "build.epoch_s", "build.train_s", "probe.ndis_pct")


def _with_device_stand_in(events: list[dict]) -> list[dict]:
    out = list(events)
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    for c, e in enumerate(ops, start=1 << 20):
        out.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=e["ts"],
                        dur=0, pid=e.get("pid"), tid=e.get("tid"), args={"correlation": c}))
        out.append(dict(ph="X", cat="kernel", name=e["name"], ts=e["ts"], dur=e["dur"],
                        pid=0, tid=0, args={"correlation": c}))
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced run of the tiny stream cell: (result, ctx, its events)."""
    from lira_tpu_torch import profiling

    reg = make_registry(tmp_path_factory.mktemp("annbench_spans"))
    kept = {}

    class Recorded(trace_mod.Trace):
        def __init__(self, events):
            kept["events"] = _with_device_stand_in(events)
            super().__init__(kept["events"])

    mp = pytest.MonkeyPatch()
    mp.setattr(trace_mod, "Trace", Recorded)
    profiling.reset_counters()
    try:
        result = run(reg, "tiny.stream-int8", trace=True)
    finally:
        mp.undo()
    return reg, result, kept["events"]


def test_traced_run_reports_the_span_and_counter_metrics(traced):
    reg, r, _ = traced
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW) <= set(m)
    assert 0 < m["screen.useful_pct"] <= 100
    assert m["unions.host_ms_per_kq"] > 0 and m["probe.host_ms_per_kq"] > 0
    assert m["build.epoch_s"] > 0
    # the selection and the rescore are two parts of select.ms_per_kq
    assert 0 < m["select.groups_ms_per_kq"] and 0 < m["rescore.ms_per_kq"]
    assert m["select.groups_ms_per_kq"] + m["rescore.ms_per_kq"] <= m["select.ms_per_kq"]
    for name in NEW:
        entry = next(e for e in reg.benchmark()["per_layer"] if e["name"] == name)
        assert r["metrics"][name]["unit"] == entry["unit"]


def test_program_spans_leave_the_other_readings_alone(traced):
    """Every per-layer reader of the trace reads the same on the recorded
    trace with the program's span events as without them."""
    reg, r, events = traced
    bare = [e for e in events if e.get("cat") != "user_annotation"]
    assert len(bare) < len(events)
    _, layer = reg.metrics_for("tiny.stream-int8")
    cell = reg.workload("tiny.stream-int8")

    def ctx(evs):
        return Ctx(cell=cell, config=reg.config("tiny-lira"), n=20000, d=32, k=10,
                   setup_s=1.0, trace=trace_mod.Trace(evs), scan_dtype="int8",
                   traced={"queries": 2048, "pairs": 10 ** 6, "distinct_rows": 10 ** 4})

    with_spans, without = ctx(events), ctx(bare)
    read = 0
    for m in layer:
        if m["name"] in OFF_TRACE:
            continue
        a = reg.layer_metric(m["name"]).read(with_spans)
        b = reg.layer_metric(m["name"]).read(without)
        assert a == b, m["name"]
        read += a is not None
    assert read >= 4  # the stand-in gives the device readers something to read
    assert with_spans.trace.breakdown() == without.trace.breakdown()
    assert np.isclose(with_spans.trace.busy_s, without.trace.busy_s)
