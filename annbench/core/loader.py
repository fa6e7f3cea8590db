"""Finds the benchmark's parts by name.

Each configuration, cell, traffic driver, corpus generator, index builder
and metric reader is a file of its own, named after it:

    configs/<config>.json       workloads/<cell>.json
    traffic/<driver>.py         data/<generator>.py
    builders/<builder>.py       e2e_metrics/<metric>.py
    layer_metrics/<metric>.py

A metric split by the cells that report it (`qps.online` beside `qps`)
reads through the file of its shorter name.  `Registry` looks a name up
in each of its roots in turn (the benchmark's own folder by default), so
a later change adds a part as a new file and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ANNBENCH = Path(__file__).resolve().parents[1]
ROOT = ANNBENCH.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name (letters, digits, _ . -; <= 64)")
    return name


class Registry:
    def __init__(self, roots=(ANNBENCH,), benchmark: Path = ROOT / "BENCHMARK.json"):
        self.roots = [Path(r) for r in roots]
        self.benchmark_path = Path(benchmark)
        self._modules: dict = {}

    def path(self, kind: str, name: str, ext: str) -> Path:
        check_name(name)
        for root in self.roots:
            p = root / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under {[str(r) for r in self.roots]}")

    def _json(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        p = self.path(kind, name, ".py")
        mod = self._modules.get(p)
        if mod is None:
            mod_name = "annbench_" + re.sub(r"\W", "_", f"{kind}_{name}")
            spec = importlib.util.spec_from_file_location(mod_name, p)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[p] = mod
        return mod

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def traffic(self, name: str):
        return self.module("traffic", name)

    def generator(self, name: str):
        return self.module("data", name)

    def builder(self, name: str):
        return self.module("builders", name)

    def _reader(self, kind: str, name: str):
        """A metric's reader: `<name>.py`, or for one quantity split by the
        cells that report it (`x.online` beside `x`, each moving another
        end-to-end metric) the reader of the name less its last dotted
        parts, so the split needs no copy of the file."""
        parts = check_name(name).split(".")
        for i in range(len(parts), 0, -1):
            try:
                return self.module(kind, ".".join(parts[:i]))
            except FileNotFoundError:
                continue
        raise FileNotFoundError(f"no {kind} reader for {name!r} under "
                                f"{[str(r) for r in self.roots]}")

    def e2e_metric(self, name: str):
        return self._reader("e2e_metrics", name)

    def layer_metric(self, name: str):
        return self._reader("layer_metrics", name)

    def benchmark(self) -> dict:
        with open(self.benchmark_path) as f:
            return json.load(f)

    def metrics_for(self, cell: str) -> tuple[list[dict], list[dict]]:
        """(end-to-end metrics, per-layer metrics) that `cell` reports: those
        listing it under `workloads`, and those without the key (per-layer
        ones then where the end-to-end metric they move is reported)."""
        bench = self.benchmark()
        if cell not in [w["name"] for w in bench["workloads"]]:
            raise KeyError(f"cell {cell!r} is not in {self.benchmark_path}")

        def listed(m):
            return cell in m["workloads"] if "workloads" in m else None

        e2e = [m for m in bench["end_to_end"] if listed(m) is not False]
        names = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if listed(m) or (listed(m) is None and m["moves"] in names)]
        return e2e, layer
