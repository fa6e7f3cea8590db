"""lira_tpu_torch and chip_smoke.py import neither jax nor lira_tpu: checked
statically (every import statement) and at run time (tiny CPU searches on
every scan path, capacity mode and the IVF prober, a self-kNN and a
training epoch in a fresh interpreter leave no jax module loaded)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _forbidden(name: str) -> bool:
    # lira_tpu_torch starts with "lira_tpu": match whole module names only
    return (name == "jax" or name.startswith("jax.") or name == "lira_tpu"
            or name.startswith("lira_tpu."))


def test_no_jax_or_lira_tpu_imports_in_source():
    files = sorted((ROOT / "lira_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_cpu_search_loads_no_jax():
    code = """
import sys
import numpy as np
import torch
from lira_tpu_torch.engine.serve import QueryEngine
from lira_tpu_torch.labels.scaler import scaled_centroid_distances
from lira_tpu_torch.models.probing_mlp import ProbingMLP
from lira_tpu_torch.partition import build_bucket_layout, kmeans_assign, kmeans_fit
from lira_tpu_torch.pipelines.smallscale import run_smallscale
from lira_tpu_torch.ops.knn_pallas import self_knn_fused
from lira_tpu_torch.models.train import make_train_state, train_epoch
import lira_tpu_torch.config, lira_tpu_torch.io.cache, lira_tpu_torch.engine.sweep  # noqa: F401
import lira_tpu_torch.redundancy.assign, lira_tpu_torch.models.metrics  # noqa: F401
import lira_tpu_torch.engine.tuning  # noqa: F401
from lira_tpu_torch.engine.ivf_baseline import ivf_probe_matrix
import chip_smoke  # noqa: F401

rng = np.random.default_rng(0)
x = rng.normal(size=(600, 8)).astype(np.float32)
km = kmeans_fit(x, 4, niter=2, device="cpu")
layout = build_bucket_layout(kmeans_assign(x, km.centroids, device="cpu"), 4)
_, _, sc = scaled_centroid_distances(x, None, km.centroids, device="cpu")
mlp = ProbingMLP(4, 8, generator=torch.Generator().manual_seed(0))
eng = QueryEngine(x, layout, km.centroids, sc, mlp, scan_dtype="int8", device="cpu")
r = eng.search(x[:5], 0.5, 3)
assert r.ids.shape == (5, 3)
for kw in (dict(scan_impl="xla", scan_dtype="bfloat16"), dict(scan_impl="pallas"),
           dict(scan_dtype="int8", store_f32=False),
           dict(prober=lambda q: ivf_probe_matrix(q, km.centroids, device="cpu"))):
    e = QueryEngine(x, layout, km.centroids, sc, mlp, device="cpu", **kw)
    assert e.search(x[:5], 0.5, 3).ids.shape == (5, 3), kw
knn = self_knn_fused(x, 3, precision="int8", device="cpu")
assert knn.shape == (600, 3)
st = make_train_state(0, 4, 8, device="cpu")
train_epoch(st, np.zeros((70, 4), np.float32), x[:70], np.zeros((70, 4), np.float32))
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "lira_tpu"
                or m.startswith("lira_tpu."))
assert not loaded, loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
