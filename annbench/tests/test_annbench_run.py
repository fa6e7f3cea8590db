"""A run end to end on the CPU at a tiny size: the result line's schema,
the check's control and planted faults (in the answers and in the build)
coming out not correct, the readings the limits are set from, and the
no-JAX rule."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from annbench.core import check
from annbench.core.loader import ROOT
from annbench.core.runner import forbidden_modules
from annbench.readings import readings
from annbench.tests.annbench_tiny import make_registry, run


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return make_registry(tmp_path_factory.mktemp("annbench"))


@pytest.mark.parametrize("cell", ["tiny.stream-int8", "tiny.online-k3"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_schema(reg, cell, trace):
    r = run(reg, cell, trace=trace)
    assert list(r)[-1] == "check" and r["correct"] is True
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"} and np.isfinite(v["value"])
    names = set(r["metrics"])
    if trace:
        assert any(n.startswith("probe.ndis_pct") for n in names) and "qps" not in names
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in r["device"] and r["device"]["window_s"] > 0
    else:
        assert {"recall_at_10", "setup_s"} <= names and ("qps" in names) != ("qps.online" in names)
        assert ("latency_p95_ms" in names) == (cell == "tiny.online-k3")
    assert set(r["check"]) == set(check.NUMBERS)
    json.dumps(r)


@pytest.mark.parametrize("cell", ["tiny.stream-int8", "tiny.online-k3"])
def test_control_is_not_correct(reg, cell):
    r = run(reg, cell, control=True)
    limits = {n: v["limit"] for n, v in r["check"].items()}
    assert r["correct"] is True
    assert not check.verdict(r["control"], limits), r["control"]


def _plant(monkeypatch, fault):
    from lira_tpu_torch.engine.serve import QueryEngine

    for name in ("search", "search_stream"):
        orig = getattr(QueryEngine, name)

        def broken(self, queries, threshold, k, *a, _orig=orig, **kw):
            res = _orig(self, queries, threshold, k, *a, **kw)
            if fault == "half":  # the second half left out: the first half's answers
                h = len(res.ids) // 2
                res.ids[h : 2 * h] = res.ids[:h]
            else:  # one answer altered where it is produced
                res.ids[0, 0] = (res.ids[0, 0] + 1) % self._x_d.shape[0]
            return res

        monkeypatch.setattr(QueryEngine, name, broken)


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("cell", ["tiny.stream-int8", "tiny.online-k3"])
def test_planted_faults_are_not_correct(reg, monkeypatch, cell, fault):
    _plant(monkeypatch, fault)
    assert run(reg, cell)["correct"] is False


def _plant_build(monkeypatch, reg, fault):
    from lira_tpu_torch.partition.assign import build_bucket_layout

    mod = reg.builder("build_index")
    orig = mod.build

    def broken(x_d, queries, groundtruth, spec, metric, device):
        if fault == "untrained":  # the probing MLP left as initialised
            spec = copy.deepcopy(spec)
            spec["config"]["n_epoch"] = 0
        built = orig(x_d, queries, groundtruth, spec, metric, device)
        if fault == "misassigned":  # one row moved to another bucket, served as moved
            d2b = built["data_2_bkt"].copy()
            n_bkt = len(built["centroids"])
            d2b[7, 0] = (d2b[7, 0] + n_bkt // 2) % n_bkt
            built.update(data_2_bkt=d2b, layout=build_bucket_layout(d2b, n_bkt))
        return built

    monkeypatch.setattr(mod, "build", broken)


@pytest.mark.parametrize("fault", ["untrained", "misassigned"])
@pytest.mark.parametrize("cell", ["tiny.stream-int8", "tiny.online-k3"])
def test_planted_build_faults_are_not_correct(reg, monkeypatch, cell, fault):
    _plant_build(monkeypatch, reg, fault)
    r = run(reg, cell)
    assert r["correct"] is False
    failing = {n for n, v in r["check"].items() if v["value"] > v["limit"]}
    assert failing == {"recall_miss" if fault == "untrained" else "assign_gap"}


def test_readings_of_program_and_controls(reg):
    lines = readings("tiny.stream-int8", [3, 2**33 + 3], 0.3, [3], [0], registry=reg,
                     device="cpu", t_process=time.perf_counter(), emit=lambda s: None)
    kinds = [r["kind"] for r in lines]
    assert kinds == ["program", "control", "program", "build_epochs_0", "summary"]
    limits = lines[-1]["limits"]
    assert all(r["correct"] for r in lines if r["kind"] == "program")
    assert lines[1]["correct"] is False
    assert lines[3]["numbers"]["recall_miss"] > limits["recall_miss"]
    assert lines[-1]["program_max"]["recall_miss"] < limits["recall_miss"]


def test_forbidden_modules_compares_top_level_names(monkeypatch):
    for name in ("lira_tpu_torch.fake", "jaxfake", "lira_tpu_torchy"):
        monkeypatch.setitem(sys.modules, name, object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lira_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert forbidden_modules() == ["jaxlib", "lira_tpu.fake"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import annbench.reference.ann, annbench.core.check, "
            "annbench.core.roofline, annbench.data.hard_regime; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('lira_tpu_torch', 'lira_tpu', 'jax', 'jaxlib', 'flax')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax(reg):
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from pathlib import Path; from annbench.core.loader import Registry, ANNBENCH; "
            "from annbench.core.runner import run_cell, forbidden_modules; "
            f"reg = Registry(roots=[Path({str(reg.roots[0])!r}), ANNBENCH], "
            f"benchmark=Path({str(reg.benchmark_path)!r})); "
            "run_cell('tiny.online-k3', 3, 0.2, False, t_process=time.perf_counter(), "
            "device='cpu', registry=reg); print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "annbench/run.py", "--workload", "hard1m.stream-int8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
