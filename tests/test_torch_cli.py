"""The port's command-line surface on the CPU (--device cpu), against
lira_tpu's where both have one: `knn` (exact and IVF), `extract-k1`,
`batch`, `parity`, the diagnostics, `build --calibrate_margin` → `search`,
the streaming reader, and `python -m lira_tpu_torch` itself.

Held exactly: each row's kNN id set (IVF mode: K-Means assignments are
exact across the packages, so the same partitions are scanned; the order
within a row may differ where two scores differ only by f32 rounding),
extract-k1's files byte for byte, the diagnostics' arrays, and the
streamed corpus.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lira_tpu import diagnostics as jdiag
from lira_tpu.io.datasets import synthetic_dataset, write_dataset
from lira_tpu.pipelines import compute_knn_cli as jknn
from lira_tpu.pipelines import extract_k1 as jext
from lira_tpu_torch import __main__ as tmain
from lira_tpu_torch import diagnostics as tdiag
from lira_tpu_torch.config import Config as TConfig
from lira_tpu_torch.io import cache as tcache
from lira_tpu_torch.io.streaming import XvecsStream, base_file_path, stream_to_device
from lira_tpu_torch.ops.knn import self_knn
from lira_tpu_torch.pipelines import extract_k1 as text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(root, n=600, dim=8, seed=2, name="synthetic"):
    bundle = synthetic_dataset(n_base=n, n_query=10, dim=dim, n_clusters=4, k_gt=5, seed=seed)
    bundle.name = name
    write_dataset(bundle, str(root))
    return bundle


@pytest.mark.parametrize("nprobe", [0, 8])
def test_knn_cli_matches_lira_tpu(tmp_path, nprobe):
    """`knn` exact (nprobe 0) and IVF (nprobe 8): each package writes its
    cache into its own copy of the dataset; the ids agree."""
    for side in ("j", "t"):
        _dataset(tmp_path / side, n=600 if nprobe == 0 else 500, seed=2 + (nprobe > 0))
    argv = ["synthetic", None, "4", str(nprobe)]
    jknn.main([str(tmp_path / "j") if a is None else a for a in argv])
    path = tmain.main(["knn"] + [str(tmp_path / "t") if a is None else a for a in argv]
                      + ["--device", "cpu"])
    n = 600 if nprobe == 0 else 500
    found = tcache.find_knn_cache(str(tmp_path / "t"), "synthetic", 4, n)
    assert found == path
    meta = tcache.read_knn_meta(path)
    assert meta["method"] == ("cpu_flat_exact" if nprobe == 0 else "ivf_approximate")
    if nprobe:
        assert "_ivf_nprobe8" in path and meta["nprobe"] == "8"
    ids_t = np.fromfile(path, dtype=np.int32).reshape(n, 4)
    ids_j = np.fromfile(tcache.find_knn_cache(str(tmp_path / "j"), "synthetic", 4, n),
                        dtype=np.int32).reshape(n, 4)
    # the same neighbours; their order may differ where two candidates'
    # f32 scores ‖x‖² − 2x·q differ only by rounding (summed in another
    # order by XLA and torch)
    np.testing.assert_array_equal(np.sort(ids_t, axis=1), np.sort(ids_j, axis=1))


def test_knn_streaming_reads_the_file(tmp_path):
    """`knn --streaming` uploads the base file chunk by chunk; the chunks
    assemble the file's rows exactly, and the kNN equals the in-memory
    run's."""
    bundle = _dataset(tmp_path, n=700)
    path = base_file_path(str(tmp_path), "synthetic")
    stream = XvecsStream(path)
    assert (stream.n, stream.dim) == bundle.base.shape
    up = stream_to_device(path, chunk_rows=256, device="cpu")
    assert up.shape == (700, 8) and up.dtype == torch.float32
    np.testing.assert_array_equal(up.numpy(), bundle.base)
    out = tmain.main(["knn", "synthetic", str(tmp_path), "3", "--streaming",
                      "--chunk_rows", "256", "--device", "cpu"])
    streamed = np.fromfile(out, dtype=np.int32).reshape(700, 3)
    np.testing.assert_array_equal(streamed, self_knn(bundle.base, 3, device="cpu"))


def test_extract_k1_files_are_byte_identical(tmp_path):
    knn = np.random.default_rng(0).integers(0, 50, size=(50, 10)).astype(np.int32)
    paths = {}
    for side, mod in (("j", jext), ("t", text)):
        tcache.save_knn_cache(str(tmp_path / side), "toy", knn, dim=8, method="cpu_flat_exact")
        src = mod.find_cache_file(str(tmp_path / side), "toy", 10)
        paths[side] = mod.extract_k_subset(src, 10, 1)
    assert os.path.basename(paths["j"]) == os.path.basename(paths["t"])
    for suffix in ("", ".meta"):
        with open(paths["j"] + suffix, "rb") as a, open(paths["t"] + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    tmain.main(["extract-k1", "toy", str(tmp_path / "t"), "--k_src", "10", "--k_dst", "3"])
    k3 = text.find_cache_file(str(tmp_path / "t"), "toy", 3)
    np.testing.assert_array_equal(np.fromfile(k3, dtype=np.int32).reshape(50, 3), knn[:, :3])


def test_batch_goes_on_past_a_failing_cell(tmp_path, monkeypatch):
    from lira_tpu_torch.pipelines.batch import run_grid

    _dataset(tmp_path, n=800, seed=5)
    monkeypatch.chdir(tmp_path)  # logs land under tmp
    results = run_grid(
        ["synthetic", "missing_ds"], data_path=str(tmp_path), k=3, n_epoch=1,
        grid={"synthetic": {"n_bkt": [4], "metric": "L2"},
              "missing_ds": {"n_bkt": [4], "metric": "L2"}},
        device="cpu",
    )
    by_ds = {r["dataset"]: r for r in results}
    assert len(results) == 2
    assert by_ds["synthetic"]["status"] == "ok"
    assert by_ds["missing_ds"]["status"].startswith("failed")
    assert os.path.exists("logs/synthetic/ML_kmeans_RE_FLAT")


def test_parity_self_match_and_divergence(tmp_path):
    import csv

    from lira_tpu_torch.pipelines.parity import diff_curves, load_reference_csv, run_parity

    bundle = synthetic_dataset(n_base=1500, n_query=30, dim=12, n_clusters=8, k_gt=10, seed=7)
    bundle.name = "ptoy"
    write_dataset(bundle, str(tmp_path))
    cfg = TConfig(dataset="ptoy", data_path=str(tmp_path), k=5, n_bkt=8, n_epoch=1,
                  t_min=0.2, t_max=0.6, t_step=0.2).update()
    cfg.pth_log = str(tmp_path / "logs") + "/"
    out = run_parity(cfg, reference_csv=None, recall_tol=0.02, ndis_rtol=0.05, device="cpu")
    assert out["parity_ok"] is None and len(out["sweep"]) == 3
    sweep = out["sweep"]

    def write(path, rows):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["threshold", "nprobe", "Recall", "Computations", "QPS"])
            w.writerows(rows)

    write(tmp_path / "ref.csv", [[r.threshold, r.nprobe, r.recall, r.computations, r.qps]
                                 for r in sweep])
    joined, ok = diff_curves(sweep, load_reference_csv(str(tmp_path / "ref.csv")), 0.02, 0.05)
    assert ok and len(joined) == len(sweep)
    assert all(j["d_recall"] == 0 and j["ndis_rel"] == 0 for j in joined)
    write(tmp_path / "bad.csv", [[r.threshold, r.nprobe, max(0.0, r.recall - 0.1),
                                  r.computations * 1.2, 0.0] for r in sweep])
    joined, ok = diff_curves(sweep, load_reference_csv(str(tmp_path / "bad.csv")), 0.02, 0.05)
    assert joined and not ok


def test_diagnostics_match_lira_tpu(tmp_path):
    rng = np.random.default_rng(3)
    n_q, n_d, n_bkt, k = 40, 300, 12, 6
    knn = rng.integers(0, n_d, size=(n_q, k))
    knn[0, -1] = -1  # padding never wraps to the last corpus point
    d2b = np.full((n_d, 2), -1, np.int32)
    d2b[:, 0] = rng.integers(0, n_bkt, size=n_d)
    d2b[::7, 1] = (d2b[::7, 0] + 3) % n_bkt
    cnt = np.zeros((n_q, n_bkt), np.int64)
    for q in range(n_q):
        for nb in knn[q][knn[q] >= 0]:
            cnt[q, d2b[nb][d2b[nb] >= 0]] += 1
    out_d = rng.random((n_d, n_bkt)).astype(np.float32)
    dist_d = rng.normal(size=(n_d, n_bkt)).astype(np.float32)
    for mp in (None, 5):
        a = jdiag.observe_knn_tail(cnt, out_d, dist_d, knn, d2b, max_points=mp)
        b = tdiag.observe_knn_tail(cnt, out_d, dist_d, knn, d2b, max_points=mp)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    outputs = rng.random((n_q, n_bkt)).astype(np.float32)
    sizes = rng.integers(1, 50, size=n_bkt)
    pa = jdiag.per_query_nprobe(outputs, cnt, sizes, k, csv_path=str(tmp_path / "j.csv"))
    pb = tdiag.per_query_nprobe(outputs, cnt, sizes, k, csv_path=str(tmp_path / "t.csv"))
    np.testing.assert_array_equal(pa, pb)
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()


def test_smallscale_runs_the_diagnostics(tmp_path):
    from lira_tpu_torch.pipelines.smallscale import run_smallscale

    bundle = synthetic_dataset(n_base=1200, n_query=20, dim=8, n_clusters=6, k_gt=10, seed=9)
    cfg = TConfig(dataset="synthetic", k=5, n_bkt=6, n_epoch=1, data_path=str(tmp_path),
                  run_diagnostics=True).update()
    cfg.pth_log = str(tmp_path) + "/"
    res = run_smallscale(cfg, bundle=bundle, use_cache=False, device="cpu")
    assert res["per_query"].shape == (20, 3)
    assert len(res["knn_tail"]["output_rank_valid"]) == 6
    assert os.path.exists(os.path.join(cfg.pth_log, f"{cfg.file_name}_perquery.csv"))


def test_build_calibrate_then_search_cli(tmp_path, capsys, monkeypatch):
    """`build --calibrate_margin` stores both screens' margins with
    lira_tpu's keys; `search` serves int8 at them, with f32's nprobe, ndis
    and recall (the default margin is exhaustive at this scale)."""
    import json

    from lira_tpu_torch.pipelines.search_cli import manifest_margin, run_search

    bundle = _dataset(tmp_path, n=2000, dim=12, seed=1)
    monkeypatch.chdir(tmp_path)  # the build writes under ./logs
    tmain.main(["build", "--device", "cpu", "--dataset", "synthetic", "--data_path",
                str(tmp_path), "--k", "5", "--n_bkt", "8", "--n_epoch", "2",
                "--calibrate_margin", "true"])
    cfg = TConfig(dataset="synthetic", k=5, n_bkt=8).update()
    with open(os.path.join(cfg.pth_log, cfg.file_name + "_manifest.json")) as f:
        manifest = json.load(f)
    for dtype in ("bfloat16", "int8"):
        cal = manifest["calibrated_margins"][dtype]
        assert set(cal) == {"margin", "zero_miss_margin", "miss_rates", "sel_rows"}
        assert cal["margin"] >= 1 and cal["sel_rows"] == 32
        assert manifest_margin(manifest, dtype) == cal["margin"]
    kw = dict(data_path=str(tmp_path), k=5, t_min=0.1, t_max=0.5, t_step=0.2, bundle=bundle,
              device="cpu")
    rows = run_search(cfg.pth_log, cfg.file_name, "synthetic", **kw)
    rows8 = run_search(cfg.pth_log, cfg.file_name, "synthetic", scan_dtype="int8",
                       block_q="auto", **kw)
    for a, b in zip(rows, rows8):
        assert (a["avg_nprobe"], a["avg_cmp"], a["avg_recall"]) == (
            b["avg_nprobe"], b["avg_cmp"], b["avg_recall"])
    capsys.readouterr()
    tmain.main(["search", "--device", "cpu", "--dataset", "synthetic", "--data_path",
                str(tmp_path), "--artifacts_dir", cfg.pth_log, "--prefix", cfg.file_name,
                "--k", "5", "--t_min", "0.3", "--t_max", "0.3", "--scan_dtype", "bfloat16"])
    assert "threshold 0.300  recall" in capsys.readouterr().out


def _run(*args):
    return subprocess.run([sys.executable, "-m", "lira_tpu_torch", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_module_cli_help_unknown_and_unported():
    r = _run("--help")
    assert r.returncode == 0 and "extract-k1" in r.stdout and "distributed" in r.stdout
    assert _run("no-such-command").returncode != 0
    # both are ported: without a card their default (cuda, nccl) refuses
    if not torch.cuda.is_available():
        r = _run("distributed", "--dataset", "x", "--k", "5", "--n_bkt", "8")
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        r = _run("search", "--dataset", "x", "--prefix", "y", "--n_shards", "2")
        assert r.returncode != 0 and "no CUDA device" in r.stderr
    r = _run("search", "--dataset", "x", "--prefix", "y", "--n_shards", "2",
             "--device", "cpu")
    assert r.returncode != 0 and "backend='gloo'" in r.stderr


def test_entry_points_need_a_card_unless_told_cpu(tmp_path):
    """Without --device cpu a CLI asks for cuda, and on a machine with no
    card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    _dataset(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["knn", "synthetic", str(tmp_path), "4"])
