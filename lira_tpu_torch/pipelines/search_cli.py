"""Serving CLI: load exported artifacts, run the end-to-end threshold sweep
(port of lira_tpu/pipelines/search_cli.py).

Loads the artifact contract written by build_index.py of either package,
rebuilds the engine, and prints per-threshold avg_recall / avg_nprobe /
avg_cmp / per-query time / QPS.  `--n_shards N` > 1 serves the index from
N ranks with the sharded engine (parallel/sharded_engine.py): `--backend
nccl` takes one card a rank, `gloo` lets ranks share a card or run on the
CPU.

    python -m lira_tpu_torch search --device cpu --dataset toyv \\
        --data_path /path/to/data --artifacts_dir ./logs/toyv/ML_kmeans_RE_FLAT \\
        --prefix <file_name> --k 5 [--n_shards 2 --backend gloo]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..engine.serve import QueryEngine, default_block_sel_rows
from ..io.artifacts import load_index_artifacts
from ..io.datasets import load_data
from ..partition.assign import build_bucket_layout

def manifest_margin(manifest: dict, scan_dtype: str,
                    sel_rows: int | None = None) -> int | None:
    """Calibrated selection margin for `scan_dtype` from the build manifest.

    build_index --calibrate_margin stores the measured zero-miss margin (in
    selection groups, with the sel_rows it was measured at).  A serving
    engine at another granularity gets the margin rescaled to keep the ROW
    coverage constant.  None when the manifest has no calibration for this
    dtype (the engine then takes its default), including lira_tpu's
    {"skipped": reason} entries, which are reported."""
    cal = (manifest.get("calibrated_margins") or {}).get(scan_dtype)
    if not cal or "margin" not in cal:
        if cal and cal.get("skipped"):
            print(f"[search] {scan_dtype} margin calibration was skipped at "
                  f"build time ({cal['skipped']}); serving the default")
        return None
    margin = int(cal["margin"])
    cal_rows = int(cal.get("sel_rows", 128))
    if sel_rows is None:
        sel_rows = default_block_sel_rows(scan_dtype)
    if sel_rows != cal_rows:
        margin = int(np.ceil(margin * cal_rows / sel_rows))
    return margin


def run_search(
    artifacts_dir: str,
    prefix: str,
    dataset: str,
    data_path: str = "/data/vector_datasets",
    k: int = 10,
    t_min: float = 0.02,
    t_max: float = 0.80,
    t_step: float = 0.02,
    n_shards: int = 1,
    bundle=None,
    stream_batch: int = 0,  # > 0: pipelined search_stream at this batch size
    scan_dtype: str = "float32",  # 'float32' | 'bfloat16' | 'int8' screen
    capacity: bool = False,  # bf16/int8: one table for both rounds (0.5x/0.25x)
    block_margin: int | None = None,  # None: manifest calibration, else default
    block_q: int | str | None = None,  # None: engine default; int: fixed;
    # 'auto': measured in-run pick at the sweep's median threshold
    device=None,
    backend: str = "nccl",  # n_shards > 1: 'nccl' (a card a rank) | 'gloo'
) -> list[dict]:
    """The serving sweep's rows (rank 0's when n_shards > 1)."""
    args = (artifacts_dir, prefix, dataset, data_path, k, t_min, t_max, t_step, bundle,
            stream_batch, scan_dtype, capacity, block_margin, block_q)
    if n_shards > 1:
        from ..parallel.mesh import launch

        return launch(n_shards, _sharded_search, *args, backend=backend, device=device)
    art, manifest, bundle, k, layout = _load(artifacts_dir, prefix, dataset, data_path,
                                             k, bundle)
    # int8 and capacity mode are blocked-only: pin the path
    kw = dict(scan_impl="blocked") if scan_dtype == "int8" or capacity else {}
    engine = QueryEngine(
        art["x_d"], layout, art["centroids"], art["scaler"], art["params"],
        metric=manifest["metric"], n_mul=manifest["n_mul"],
        scan_dtype=scan_dtype, store_f32=not capacity,
        block_margin=block_margin, device=device, **kw,
    )
    if block_margin is None:  # the calibration, at the engine's own granularity
        engine.block_margin = manifest_margin(manifest, scan_dtype, engine.block_sel_rows)

    thresholds = np.arange(t_min, t_max + 1e-6, t_step)
    n_q = len(bundle.query)
    engine.search(bundle.query[: min(64, n_q)], float(thresholds[0]), k)  # warmup
    if block_q is not None:
        if str(block_q) == "auto":
            if engine.scan_impl == "blocked":
                from ..engine.calibrate import autotune_block_q

                thr_mid = float(thresholds[len(thresholds) // 2])
                tune = autotune_block_q(engine, bundle.query, thr_mid, k)
                engine.block_q = tune.block_q
                print(f"[search] block_q autotuned at thr {thr_mid:.3f}: "
                      + ", ".join(f"{q}: {s * 1e3:.0f}ms"
                                  for q, s in sorted(tune.medians.items(), reverse=True))
                      + f" -> {tune.block_q}")
            else:
                print("[search] --block_q auto needs the blocked engine; keeping the default")
        else:
            engine.block_q = int(block_q)
    return _sweep(engine, bundle, thresholds, k, stream_batch, echo=True)


def _load(artifacts_dir, prefix, dataset, data_path, k, bundle):
    art = load_index_artifacts(artifacts_dir, prefix)
    manifest = art["manifest"]
    if bundle is None:
        bundle = load_data(dataset, data_path=data_path)
    if bundle.groundtruth is None:
        raise ValueError("groundtruth required for the search sweep")
    k = min(k, bundle.groundtruth.shape[1])
    layout = build_bucket_layout(art["data_2_bkt"], manifest["n_bkt"])
    return art, manifest, bundle, k, layout


def _sweep(engine, bundle, thresholds, k: int, stream_batch: int, echo: bool) -> list[dict]:
    rows = []
    n_q = len(bundle.query)
    for thr in thresholds:
        if stream_batch > 0:
            # sustained-throughput mode: batch i+1's probe and unions hide
            # behind batch i's scan
            res = engine.search_stream(bundle.query, float(thr), k, stream_batch)
        else:
            res = engine.search(bundle.query, float(thr), k)
        recall = engine.recall_against(res.ids, bundle.groundtruth, k)
        row = {
            "threshold": float(thr),
            "avg_recall": float(recall.mean()),
            "avg_nprobe": float(res.nprobe.mean()),
            "avg_cmp": float(res.ndis.mean()),
            "avg_time": res.elapsed / n_q,
            "qps": n_q / res.elapsed,
        }
        rows.append(row)
        if echo:
            print(
                f"threshold {row['threshold']:.3f}  recall {row['avg_recall']:.4f}  "
                f"nprobe {row['avg_nprobe']:.2f}  cmp {row['avg_cmp']:.0f}  "
                f"time/q {row['avg_time'] * 1e6:.1f}us  QPS {row['qps']:.0f}"
            )
    return rows


def _sharded_search(artifacts_dir, prefix, dataset, data_path, k, t_min, t_max, t_step,
                    bundle, stream_batch, scan_dtype, capacity, block_margin, block_q, *,
                    mesh):
    """One rank of `run_search(n_shards > 1)`: the sharded engine over the
    artifacts, lira_tpu's sweep; rank 0 prints the rows."""
    from ..parallel.sharded_engine import ShardedQueryEngine

    art, manifest, bundle, k, layout = _load(artifacts_dir, prefix, dataset, data_path,
                                             k, bundle)
    if block_margin is None:
        block_margin = manifest_margin(manifest, scan_dtype)
    # int8 is K1-only: pin the local scan so the request also runs on CPU ranks
    kw = dict(local_impl="pallas") if scan_dtype == "int8" else {}
    engine = ShardedQueryEngine(
        art["x_d"], layout, art["centroids"], art["scaler"], art["params"], mesh,
        metric=manifest["metric"], n_mul=manifest["n_mul"], scan_dtype=scan_dtype,
        store_f32=not capacity, margin=block_margin, **kw,
    )
    thresholds = np.arange(t_min, t_max + 1e-6, t_step)
    engine.search(bundle.query[: min(64, len(bundle.query))], float(thresholds[0]), k)
    if block_q is not None:
        if str(block_q) == "auto":
            if mesh.rank == 0:
                print("[search] --block_q auto needs the single-device blocked engine; "
                      "keeping the default")
        else:
            engine.block_q = int(block_q)
    return _sweep(engine, bundle, thresholds, k, stream_batch, echo=mesh.rank == 0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_path", default="/data/vector_datasets")
    p.add_argument("--artifacts_dir", default=".")
    p.add_argument("--prefix", required=True)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--t_min", type=float, default=0.02)
    p.add_argument("--t_max", type=float, default=0.80)
    p.add_argument("--t_step", type=float, default=0.02)
    p.add_argument("--n_shards", type=int, default=1,
                   help="> 1: serve from this many ranks (the sharded engine)")
    p.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                   help="--n_shards > 1: nccl (one card a rank) or gloo (ranks "
                        "sharing a card, or CPU ranks)")
    p.add_argument("--stream_batch", type=int, default=0,
                   help="pipelined search_stream batch size (0 = one batch)")
    p.add_argument("--scan_dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="round-1 screen dtype (bfloat16/int8 halve/quarter the "
                        "screen's bytes; round 2 is always f32-exact)")
    p.add_argument("--capacity", action="store_true",
                   help="capacity mode: ONE approximate table serves both rounds "
                        "(bf16 0.5x / int8 0.25x the corpus on the device); exact "
                        "order restored by a host f32 re-rank (requires "
                        "--scan_dtype bfloat16 or int8)")
    p.add_argument("--block_margin", type=int, default=None,
                   help="selection margin in groups (default: the manifest's "
                        "calibrated margin if the index was built with "
                        "--calibrate_margin, else the engine's default)")
    p.add_argument("--block_q", default=None,
                   help="blocked-scan queries per union block: an int, or 'auto' "
                        "to measure the fastest at the sweep's median threshold")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    a = p.parse_args(argv)
    run_search(
        a.artifacts_dir, a.prefix, a.dataset, a.data_path, a.k,
        a.t_min, a.t_max, a.t_step, a.n_shards, stream_batch=a.stream_batch,
        scan_dtype=a.scan_dtype, capacity=a.capacity,
        block_margin=a.block_margin, block_q=a.block_q, device=a.device,
        backend=a.backend,
    )


if __name__ == "__main__":
    main()
