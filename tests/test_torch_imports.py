"""lira_tpu_torch, chip_smoke.py and scripts/torch_*.py import neither jax
nor lira_tpu: checked statically (every import statement) and at run time
(tiny CPU searches on every scan path, capacity mode and the IVF prober,
a self-kNN and a training epoch in a fresh interpreter leave no jax
module loaded; the sharded path's spawned ranks run with `jax` and
`lira_tpu` made unimportable, so any import of either fails the run)."""

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
    files = (sorted((ROOT / "lira_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("torch_*.py")))
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
import lira_tpu_torch.native, lira_tpu_torch.profiling, lira_tpu_torch.parallel  # noqa: F401
import lira_tpu_torch.pipelines.distributed, lira_tpu_torch.pipelines.search_cli  # noqa: F401
from lira_tpu_torch.io.streaming import stream_to_shards  # noqa: F401
from lira_tpu_torch.ops.topk import grouped_topk
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
assert lira_tpu_torch.native.available()
assert grouped_topk(torch.tensor(x[:4, :8]), 3)[1].shape == (4, 3)
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


def test_spawned_ranks_load_no_jax(tmp_path):
    """The sharded path's ranks (spawned processes: they import the modules
    they run afresh) with `jax` and `lira_tpu` shadowed by packages whose
    import raises: serving (K1's plain version and the gather scan), the
    sharded kNN (K2's), K-Means and DP training all run."""
    for name in ("jax", "lira_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} imported by the port')\n")
    code = """
import numpy as np
import torch
from lira_tpu_torch.labels.scaler import StandardScaler
from lira_tpu_torch.models.probing_mlp import ProbingMLP
from lira_tpu_torch.models.train import make_train_state
from lira_tpu_torch.parallel import launch_many, serve_rank
from lira_tpu_torch.parallel.sharded_kmeans import sharded_kmeans_fit
from lira_tpu_torch.parallel.sharded_knn import sharded_self_knn
from lira_tpu_torch.parallel.train_dp import dp_train_epoch
from lira_tpu_torch.partition import build_bucket_layout

if __name__ == "__main__":
    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 8)).astype(np.float32)
    layout = build_bucket_layout(rng.integers(0, 4, size=600).astype(np.int32), 4)
    sc = StandardScaler()
    sc.mean_, sc.scale_ = np.zeros(4, np.float32), np.ones(4, np.float32)
    mlp = ProbingMLP(4, 8, generator=torch.Generator().manual_seed(0))
    req = [("search", (x[:9], 0.5, 3), {})]
    calls = [(serve_rank, (x, layout, x[:4], sc, mlp, req), dict(local_impl=impl,
              scan_dtype=dt)) for impl, dt in (("pallas", "int8"), ("gather", "bfloat16"))]
    calls += [(sharded_self_knn, (x, 3), {}), (sharded_kmeans_fit, (x, 4), dict(niter=2)),
              (dp_train_epoch, (make_train_state(0, 4, 8, device="cpu"),),
               dict(dist=x[:70, :4], vec=x[:70], targets=np.zeros((70, 4), np.float32)))]
    out = launch_many(2, calls, backend="gloo", device="cpu")
    assert out[0]["results"][0].ids.shape == (9, 3) and out[2].shape == (600, 3)
    print("ok")
"""
    script = tmp_path / "ranks.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
