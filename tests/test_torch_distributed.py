"""The sharded pipeline and CLIs of lira_tpu_torch on 2 gloo ranks on the
CPU, against lira_tpu on a mesh of the same 2 devices.

`run_distributed` runs once in the port's ranks (a module fixture) and
once in lira_tpu, from the same corpus, Config and initial MLP parameters
(lira_tpu's make_train_state, carried across): the K-Means assignments are
exactly equal, so are the kNN bucket labels, the epochs' losses agree to
1e-4 (DP training sums its gradients in another order) and the measured
sweep's nprobe and ndis are exactly equal.  Then the commands end to end:
`python -m lira_tpu_torch distributed --n_shards 2 --backend gloo --device
cpu` writes its log and CSVs, and `search --n_shards 2` serves a built
index with the rows of `search --n_shards 1` (nprobe, ndis and recall).
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from lira_tpu.config import Config as JConfig
from lira_tpu.io.datasets import synthetic_dataset, write_dataset
from lira_tpu.labels.distr import knn_bucket_labels
from lira_tpu.models.train import make_train_state as j_make_train_state
from lira_tpu.parallel.mesh import make_mesh as j_make_mesh
from lira_tpu.parallel.sharded_knn import sharded_self_knn as j_self_knn
from lira_tpu.partition.kmeans import kmeans_assign as j_kmeans_assign
from lira_tpu.pipelines.distributed import run_distributed as j_run_distributed
from lira_tpu_torch.config import Config
from lira_tpu_torch.models.probing_mlp import params_from_jax
from lira_tpu_torch.parallel import launch
from lira_tpu_torch.pipelines.build_index import build_index
from lira_tpu_torch.pipelines.distributed import distributed_rank
from lira_tpu_torch.pipelines.search_cli import run_search

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 2
CFG = dict(dataset="synthetic", k=5, n_bkt=8, n_epoch=2, batch_size=64,
           redundancy_ratio=0.05, sigma=0.25, t_min=0.1, t_max=0.5, t_step=0.2)


def _bundle():
    # overlapping clusters (tests/test_distributed_pipeline.py's knobs):
    # boundary points exist, so the redundancy stage acts
    return synthetic_dataset(
        n_base=1600, n_query=30, dim=16, n_clusters=6, k_gt=10, seed=4,
        center_scale=1.0, noise_scale=1.0, query_noise=0.35,
        intrinsic_dim=8, ambient_noise=0.02,
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    bundle = _bundle()
    root = tmp_path_factory.mktemp("dist")
    cfg_t = Config(data_path=str(root / "t"), **CFG).update()
    cfg_t.pth_log = str(root / "t_logs")
    cfg_j = JConfig(data_path=str(root / "j"), **CFG).update()
    cfg_j.pth_log = str(root / "j_logs")
    init = j_make_train_state(cfg_j.seed, cfg_j.n_bkt, bundle.base.shape[1], lr=cfg_j.lr)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, init.params))
    # the ranks run while this process runs lira_tpu's pipeline
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(launch, N_RANKS, distributed_rank, cfg_t, bundle, model,
                          backend="gloo", device="cpu")
        mesh = j_make_mesh(N_RANKS)
        res_j = j_run_distributed(cfg_j, mesh, bundle=bundle)
        res_t = fut.result(timeout=600)
    return dict(t=res_t, j=res_j, bundle=bundle, cfg=cfg_t, mesh=mesh)


def test_run_distributed_kmeans_and_labels_match_lira_tpu(runs):
    t, j, b = runs["t"], runs["j"], runs["bundle"]
    x = b.base
    np.testing.assert_allclose(t["kmeans"].centroids, np.asarray(j["kmeans"].centroids),
                               rtol=1e-4, atol=1e-4)
    a_j = np.asarray(j_kmeans_assign(x, j["kmeans"].centroids))
    np.testing.assert_array_equal(t["assign"], a_j)
    knn_j = np.asarray(j_self_knn(x, runs["cfg"].k, runs["mesh"]))
    d2b_t = np.full((len(x), 1), -1, np.int32)
    d2b_t[:, 0] = t["assign"]
    d2b_j = d2b_t.copy()
    d2b_j[:, 0] = a_j
    np.testing.assert_array_equal(knn_bucket_labels(t["knn_data"], d2b_t, 8),
                                  knn_bucket_labels(knn_j, d2b_j, 8))


def test_run_distributed_training_and_sweep_match_lira_tpu(runs):
    t, j = runs["t"], runs["j"]
    assert len(t["epoch_rows"]) == runs["cfg"].n_epoch + 1
    for rt, rj in zip(t["epoch_rows"], j["epoch_rows"]):
        assert rt["Loss"] == pytest.approx(rj["Loss"], rel=1e-4, abs=1e-4)
    np.testing.assert_array_equal(t["data_2_bkt"], np.asarray(j["data_2_bkt"]))
    assert (t["data_2_bkt"][:, 1] >= 0).sum() > 0  # redundancy acted
    assert len(t["serve_rows"]) == len(j["serve_rows"]) == 3
    for rt, rj in zip(t["serve_rows"], j["serve_rows"]):
        assert rt["threshold"] == pytest.approx(rj["threshold"])
        assert rt["avg_nprobe"] == rj["avg_nprobe"]
        assert rt["avg_cmp"] == rj["avg_cmp"]
        assert rt["avg_recall"] == pytest.approx(rj["avg_recall"], abs=1e-9)
    # rank 0 wrote the log and the CSVs
    cfg = runs["cfg"]
    log = open(os.path.join(cfg.pth_log, cfg.log_name)).read()
    assert "finish!" in log and "sharded self-kNN time" in log
    csv = os.path.join(cfg.pth_log, cfg.file_name + "_tuning_threshold", "model_sharded.csv")
    assert open(csv).readline().strip() == "threshold,nprobe,Recall,Computations,QPS"
    assert os.path.exists(os.path.join(cfg.pth_log, cfg.df_name))


def _cli(tmp_path, *args):
    """`python -m lira_tpu_torch <args>` started in the background."""
    return subprocess.Popen([sys.executable, "-m", "lira_tpu_torch", *args], cwd=tmp_path,
                            env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


def test_distributed_and_sharded_search_commands(tmp_path):
    bundle = _bundle()
    bundle.name = "synthetic"
    write_dataset(bundle, str(tmp_path))
    dist_cli = _cli(tmp_path, "distributed", "--n_shards", "2", "--backend", "gloo",
                    "--device", "cpu", "--dataset", "synthetic", "--data_path", str(tmp_path),
                    "--k", "5", "--n_bkt", "8", "--n_epoch", "1", "--batch_size", "64")
    # meanwhile: build an index once, serve it from 1 and from 2 ranks
    cfg = Config(data_path=str(tmp_path), k=5, n_bkt=8, n_epoch=1, batch_size=64,
                 dataset="synthetic").update()
    run_dir = tmp_path / cfg.pth_log
    cfg.pth_log = str(tmp_path / "art")
    build_index(cfg, bundle=bundle, use_cache=False, device="cpu")
    search_cli = _cli(tmp_path, "search", "--device", "cpu", "--dataset", "synthetic",
                      "--data_path", str(tmp_path), "--artifacts_dir", cfg.pth_log,
                      "--prefix", cfg.file_name, "--k", "5", "--t_min", "0.3", "--t_max", "0.3",
                      "--n_shards", "2", "--backend", "gloo")
    kw = dict(dataset="synthetic", data_path=str(tmp_path), k=5, t_min=0.2, t_max=0.4,
              t_step=0.2, device="cpu")
    for dtype in ("float32", "int8"):
        one = run_search(cfg.pth_log, cfg.file_name, scan_dtype=dtype, **kw)
        two = run_search(cfg.pth_log, cfg.file_name, scan_dtype=dtype, n_shards=2,
                         backend="gloo", **kw)
        assert len(one) == len(two) == 2
        for a, b in zip(one, two):
            assert (a["avg_nprobe"], a["avg_cmp"], a["avg_recall"]) == (
                b["avg_nprobe"], b["avg_cmp"], b["avg_recall"]), dtype
    assert "threshold 0.300  recall" in _finish(search_cli)  # rank 0 prints
    out = _finish(dist_cli)
    assert "finish!" in out and "2 ranks (gloo, cpu)" in out
    csv = run_dir / (cfg.file_name + "_tuning_threshold") / "model_sharded.csv"
    assert len(csv.read_text().splitlines()) > 2
