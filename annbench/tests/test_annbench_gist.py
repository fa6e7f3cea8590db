"""The GIST-width configuration and cell on the CPU at a tiny size (20,000
x 960, 32 buckets, n_mul 2, learned redundancy 0.03): a traced run reads
the readers this cell brought (`build.knn_s`, `build.redundancy_s`,
`rescore.steps_per_kq`) beside the existing ones, an untraced run is
correct, and each new reader gives None where there is nothing to read."""

from __future__ import annotations

import json

import pytest

from annbench.core.loader import ANNBENCH
from annbench.core.runner import Ctx
from annbench.tests.annbench_tiny import make_registry, run

CELL = "tinygist.stream-int8"
NEW = ("build.knn_s", "build.redundancy_s", "rescore.steps_per_kq")


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("annbench_gist")
    reg = make_registry(tmp)
    cfg = json.loads((ANNBENCH / "configs/gist1m-lira.json").read_text())
    cfg["name"] = "tinygist-lira"
    cfg["data"].update(n_base=20000, intrinsic_dim=8, n_clusters=16)
    cfg["index"]["config"].update(n_bkt=32, n_epoch=2, lr=1e-3)
    cfg["serve"].update(probe_cap=16, tune_queries=256, threshold={"buckets": 4, "queries": 256})
    (tmp / "configs/tinygist-lira.json").write_text(json.dumps(cfg))
    cell = json.loads((ANNBENCH / "workloads/gist1m.stream-int8.json").read_text())
    cell.update(name=CELL, config="tinygist-lira")
    cell["traffic"].update(call_queries=512, batch_size=256, max_qps=2000, recall_sample=512)
    cell["check"]["sample"] = 1 << 20  # every answer of the window
    (tmp / f"workloads/{CELL}.json").write_text(json.dumps(cell))
    bench = json.loads(reg.benchmark_path.read_text())
    bench["workloads"].append({"name": CELL, "config": "tinygist-lira",
                               "traffic": "stream-int8", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gist1m.stream-int8" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    reg.benchmark_path.write_text(json.dumps(bench))
    return reg


@pytest.fixture(scope="module")
def traced(reg):
    from lira_tpu_torch import profiling

    profiling.reset_counters()
    return run(reg, CELL, trace=True)


def test_the_cell_lists_the_new_readers(reg):
    _, layer = reg.metrics_for(CELL)
    assert set(NEW) <= {m["name"] for m in layer}
    _, layer_1m = reg.metrics_for("tiny.stream-int8")
    names_1m = {m["name"] for m in layer_1m}
    assert {"build.knn_s", "rescore.steps_per_kq"} <= names_1m
    assert "build.redundancy_s" not in names_1m


def test_traced_run_reads_the_new_metrics(reg, traced):
    assert traced["correct"] is True and traced["failed"] == 0
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    assert set(NEW) <= set(m)
    assert m["build.knn_s"] > 0 and m["build.redundancy_s"] > 0
    # a 512-query call in batches of 256 at d 960: qb 256, one step a block
    # at most, so at least 1,000 / 256 steps per 1,000 queries
    assert m["rescore.steps_per_kq"] >= 1e3 / 256
    for name in NEW:
        entry = next(e for e in reg.benchmark()["per_layer"] if e["name"] == name)
        assert traced["metrics"][name]["unit"] == entry["unit"]


def test_untraced_run_is_correct(reg):
    r = run(reg, CELL, seed=2**32 + 5)
    assert r["correct"] is True and r["failed"] == 0
    assert {"qps", "recall_at_10", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_where_nothing_is(reg, monkeypatch, name):
    from lira_tpu_torch import profiling

    monkeypatch.setattr(profiling, "_counters", {})
    empty = Ctx(cell=reg.workload(CELL), config=reg.config("tinygist-lira"), n=4000, d=960,
                k=10, setup_s=1.0, spans={}, traced={"queries": 512, "pairs": 1,
                                                      "distinct_rows": 1})
    assert reg.layer_metric(name).read(empty) is None
    untraced = Ctx(cell=reg.workload(CELL), config=reg.config("tinygist-lira"), n=4000, d=960,
                   k=10, setup_s=1.0, spans={"training": 1.0})
    assert reg.layer_metric(name).read(untraced) is None
