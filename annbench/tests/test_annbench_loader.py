"""Every part of BENCHMARK.json is found by name, and a part added as a
new file in another folder is found without editing anything."""

from __future__ import annotations

import json
import re

import pytest

from annbench.core.check import NUMBERS
from annbench.core.loader import ANNBENCH, ROOT, Registry, check_name

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["annbench"] and BENCH["command"][1] == "annbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_load_by_name(cell):
    reg = Registry()
    spec = reg.workload(cell)
    cfg = reg.config(spec["config"])
    assert reg.traffic(spec["traffic"]["driver"]).plan(spec["traffic"], 10)["pool"] > 0
    assert hasattr(reg.builder(cfg["index"]["builder"]), "build")
    assert hasattr(reg.generator(cfg["data"]["generator"]), "make")
    e2e, layer = reg.metrics_for(cell)
    for m in e2e:
        assert callable(reg.e2e_metric(m["name"]).read)
    for m in layer:
        assert callable(reg.layer_metric(m["name"]).read)
    assert {"setup_s", "recall_at_10", "device_peak_gib"} <= {m["name"] for m in e2e}
    assert len({"qps", "qps.online"} & {m["name"] for m in e2e}) == 1
    assert layer and set(spec["check"]["limits"]) == set(NUMBERS)


def test_config_files_match_benchmark():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and set(cfg["reduced"]) <= set(cfg)


def test_new_parts_found_without_edits(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "workloads").mkdir()
    (tmp_path / "layer_metrics").mkdir()
    cfg = json.loads((ANNBENCH / "configs/hard1m-lira.json").read_text())
    cfg["name"] = "new-config"
    (tmp_path / "configs/new-config.json").write_text(json.dumps(cfg))
    cell = json.loads((ANNBENCH / "workloads/hard1m.online-k3.json").read_text())
    cell["config"] = "new-config"
    (tmp_path / "workloads/new.cell.json").write_text(json.dumps(cell))
    (tmp_path / "layer_metrics/new.metric.py").write_text("def read(ctx):\n    return 42.0\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "new.cell", "config": "new-config", "traffic": "cell", "chips": 1, "why": "t"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "new.metric", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "device", "moves": "qps", "workloads": ["new.cell"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(roots=[tmp_path, ANNBENCH], benchmark=tmp_path / "BENCHMARK.json")
    assert reg.config(reg.workload("new.cell")["config"])["name"] == "new-config"
    _, layer = reg.metrics_for("new.cell")
    assert [m["name"] for m in layer] == ["new.metric"]
    assert reg.layer_metric("new.metric").read(None) == 42.0
    assert reg.workload("hard1m.stream-int8")["config"] == "hard1m-lira"  # the own root still


@pytest.mark.parametrize("bad", ["../x", "a/b", "", ".hidden", "x" * 65, "a b"])
def test_names_are_checked(bad):
    with pytest.raises(ValueError):
        check_name(bad)


def test_split_metric_reads_through_the_shorter_name():
    reg = Registry()
    assert reg.e2e_metric("qps.online") is reg.e2e_metric("qps")
    assert reg.layer_metric("device.idle_pct.online") is reg.layer_metric("device.idle_pct")
    assert reg.layer_metric("probe.ndis_pct.stream") is reg.layer_metric("probe.ndis_pct")
    with pytest.raises(FileNotFoundError):
        reg.layer_metric("nothing.here")
