"""A tiny copy of the benchmark's cells for the CPU tests: the hard1m-lira
configuration at 20,000 x 32 with 32 buckets and two epochs, and one cell
per engine path, written as new files in a temporary folder that the
registry searches before the benchmark's own.  The per-query cell's
metrics are added as a later change would add that cell's: entries in the
copy of BENCHMARK.json, with no file of their own where a reader exists."""

from __future__ import annotations

import json
import time
from pathlib import Path

from annbench.core.loader import ANNBENCH, ROOT, Registry
from annbench.core.runner import run_cell

CELLS = {
    "tiny.stream-int8": ("hard1m.stream-int8", {"call_queries": 2048, "batch_size": 1024,
                                                "max_qps": 4000, "recall_sample": 1024,
                                                "trace_from": 1, "trace_calls": 1}),
    "tiny.online-k3": ("hard1m.online-k3", {"request_queries": 64, "max_qps": 3000,
                                            "recall_sample": 1024, "trace_from": 2,
                                            "trace_calls": 3}),
}
ONLINE_METRICS = {
    "end_to_end": [("qps.online", "queries/s", "higher", None),
                   ("latency_p95_ms", "ms", "lower", None)],
    "per_layer": [("probe.ndis_pct.online", "%", "lower", "probe"),
                  ("k3.ms_per_kq", "ms/kq", "lower", "per-query scan, K3"),
                  ("k3.roofline_pct", "%", "higher", "per-query scan, K3"),
                  ("device.idle_pct.online", "%", "lower", "device")],
}


def make_registry(tmp: Path) -> Registry:
    (tmp / "configs").mkdir()
    (tmp / "workloads").mkdir()
    cfg = json.loads((ANNBENCH / "configs/hard1m-lira.json").read_text())
    cfg["name"] = "tiny-lira"
    cfg["data"].update(n_base=20000, dim=32, intrinsic_dim=8, n_clusters=16)
    cfg["index"]["config"].update(n_bkt=32, n_epoch=2, lr=1e-3)
    cfg["serve"].update(probe_cap=16, tune_queries=256, threshold={"buckets": 4, "queries": 256})
    (tmp / "configs/tiny-lira.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = []
    for name, (model, traffic) in CELLS.items():
        cell = json.loads((ANNBENCH / f"workloads/{model}.json").read_text())
        cell.update(config="tiny-lira", name=name)
        cell["traffic"].update(traffic)
        cell["check"]["sample"] = 1 << 20  # every answer of the window
        (tmp / f"workloads/{name}.json").write_text(json.dumps(cell))
        cells.append({"name": name, "config": "tiny-lira", "traffic": name.split(".")[1],
                      "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if model in m.get("workloads", ()):
                m["workloads"].append(name)
    bench["workloads"] = cells
    for kind, entries in ONLINE_METRICS.items():
        for name, unit, better, layer in entries:
            m = {"name": name, "unit": unit, "better": better, "source": "device_trace",
                 "workloads": ["tiny.online-k3"]}
            if layer is None:
                m.update(bound=0.25, source="host_clock")
            else:
                m.update(layer=layer, moves="latency_p95_ms")
            bench[kind].append(m)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(roots=[tmp, ANNBENCH], benchmark=tmp / "BENCHMARK.json")


def run(reg: Registry, cell: str, trace: bool = False, control: bool = False,
        seed: int = 2**31 + 11) -> dict:
    return run_cell(cell, seed, 0.5, trace, t_process=time.perf_counter(), device="cpu",
                    registry=reg, control=control)
