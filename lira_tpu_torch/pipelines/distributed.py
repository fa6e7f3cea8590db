"""Sharded end-to-end pipeline: every heavy stage runs over the ranks (port
of lira_tpu/pipelines/distributed.py).

  1. self-kNN labels      : `sharded_self_knn` (corpus row-sharded, each
                            rank's chunked scan through K2, one merge per
                            query tile)
  2. K-Means partitioning : `sharded_kmeans_fit` / `sharded_kmeans_assign`
                            (all-reduced Lloyd)
  3. label construction   : host ops on (n, k) ints, as smallscale
  4. probing-MLP training : `dp_train_epoch` (batch data-parallel,
                            gradients all-reduced)
  5. redundancy           : device-reduced predicted-nprobe counts and a
                            re-score of the selected rows (the model is
                            replicated, so smallscale's path applies)
  6. serving              : the `ShardedQueryEngine` measured sweep (tiles
                            sharded, K1 on each rank's card, one merge per
                            batch)

Every rank runs `run_distributed` on the same inputs (SPMD); rank 0 prints
and writes the log and the CSVs (the epoch table and the measured sweep).

    python -m lira_tpu_torch distributed --n_shards 2 --backend gloo \\
        --device cpu --dataset toyv --data_path /path/to/data --k 5 --n_bkt 8
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..config import Config
from ..engine.sweep import SweepRow, sweep_to_csv
from ..io.datasets import DatasetBundle, load_data
from ..labels.distr import gt_bucket_map, knn_bucket_labels
from ..labels.scaler import scaled_centroid_distances
from ..logging_utils import ascii_table, fprint, stage_timer
from ..models.metrics import probing_metrics
from ..models.probing_mlp import ProbingMLP
from ..models.train import evaluate, infer, make_train_state, predict_counts
from ..parallel.mesh import Mesh, launch
from ..parallel.sharded_engine import ShardedQueryEngine
from ..parallel.sharded_kmeans import sharded_kmeans_assign, sharded_kmeans_fit
from ..parallel.sharded_knn import sharded_self_knn
from ..parallel.train_dp import dp_train_epoch
from ..partition.assign import build_bucket_layout
from .smallscale import _epochs_to_csv
from ..redundancy.assign import apply_redundancy_subset, select_top_ratio


def run_distributed(
    cfg: Config,
    mesh: Mesh,
    bundle: DatasetBundle | None = None,
    log_file=None,
    serve_sweep: bool = True,
    init_model: ProbingMLP | None = None,
) -> dict:
    """Build → train → redundancy → sharded-serve on the ranks of `mesh`.

    `init_model`: the MLP's initial weights (None: make_train_state's,
    seeded with cfg.seed).  Returns smallscale's result keys plus
    'knn_data', 'assign' (the K-Means assignment), 'serve_rows' (the
    measured sharded sweep) and 'engine' (live)."""
    lead = mesh.rank == 0
    fw = log_file if lead else None

    def say(msg):
        if lead:
            fprint(msg, fw)

    def timer(name):
        return stage_timer(name, fw) if lead else contextlib.nullcontext()

    dev = mesh.device
    if bundle is None:
        bundle = load_data(cfg.dataset, data_path=cfg.data_path)
    if bundle.groundtruth is None:
        raise ValueError(f"Ground truth missing for dataset {cfg.dataset}")
    x_d, x_q = bundle.base, bundle.query
    n_d, dim = x_d.shape
    n_bkt = cfg.n_bkt
    say(f">> distributed pipeline: {mesh.size} ranks ({mesh.backend}, {dev}), data "
        f"{x_d.shape}, query {x_q.shape}, n_bkt {n_bkt}, k {cfg.k}, metric {cfg.dis_metric}")

    # (1) self-kNN labels over the ranks; query labels from ground truth
    with timer("sharded self-kNN"):
        knn_data = sharded_self_knn(x_d, cfg.k, mesh, metric=cfg.dis_metric)
    knn_query = bundle.groundtruth[:, : cfg.k]

    # (2) partitioning: all-reduced Lloyd + sharded assignment
    with timer("sharded kmeans"):
        km = sharded_kmeans_fit(x_d, n_bkt, mesh, niter=cfg.kmeans_niter, seed=cfg.seed)
        assign = sharded_kmeans_assign(x_d, km.centroids, mesh)
    data_2_bkt = np.full((n_d, cfg.n_mul), -1, dtype=np.int32)
    data_2_bkt[:, 0] = assign
    layout = build_bucket_layout(data_2_bkt, n_bkt)

    # (3) targets + standardized centroid-distance features
    with timer("label construction"):
        labels_data = knn_bucket_labels(knn_data, data_2_bkt, n_bkt)
        labels_query = knn_bucket_labels(knn_query, data_2_bkt, n_bkt)
        gt_buckets = gt_bucket_map(knn_query, data_2_bkt)
    with timer("scaled distances"):
        dist_d, dist_q, scaler = scaled_centroid_distances(x_d, x_q, km.centroids, device=dev)
        if lead and cfg.pth_log and cfg.file_name:
            scaler.save(cfg.pth_log, cfg.file_name)

    # (4) data-parallel training: each rank a slice of every batch
    state = make_train_state(cfg.seed, n_bkt, dim, lr=cfg.lr, device=dev)
    if init_model is not None:
        state.model.load_state_dict(init_model.state_dict())
    epoch_rows = []
    headers = ["Epoch", "Loss", "Accuracy", "Hit Rate", "nprobe predict",
               "nprobe target", "KNN Recall", "KNN Computations"]

    def eval_epoch(epoch):
        _, predicts, loss_test, outputs = evaluate(
            state, dist_q, x_q, labels_query, sigma=cfg.sigma, batch_size=cfg.batch_size,
        )
        m = probing_metrics(
            predicts, labels_query, gt_buckets, layout.sizes, cfg.k,
            epoch=epoch, loss=round(loss_test, 4),
        )
        epoch_rows.append(m)
        say(ascii_table(headers, [[m[h] for h in headers]]))
        return outputs

    outputs = eval_epoch(-1)
    for epoch in range(cfg.n_epoch):
        t0 = time.perf_counter()
        state, loss_train = dp_train_epoch(state, mesh, dist_d, x_d, labels_data,
                                           global_batch=cfg.batch_size)
        say(f"Epoch {epoch}, DP Train Loss: {loss_train:.5f}, "
            f"time_train: {time.perf_counter() - t0:.2f}s")
        outputs = eval_epoch(epoch)

    results: dict = {"epoch_rows": epoch_rows, "state": state, "kmeans": km,
                     "scaler": scaler, "knn_data": knn_data, "assign": assign}

    # (5) learning-based redundancy (the model is replicated on every rank)
    thresholds = np.arange(cfg.t_min, cfg.t_max + cfg.t_step / 2, cfg.t_step)
    if cfg.duplicate_type == "model":
        counts = predict_counts(state, dist_d, x_d, sigma=cfg.sigma)
        selected = select_top_ratio(counts, cfg.redundancy_ratio)
        say(f">> redundancy: duplicating top {len(selected)}/{n_d} boundary vectors")
        with timer("redundancy assignment"):
            sel_idx = np.sort(selected)
            sel_t = torch.as_tensor(sel_idx, device=dev)
            sel_predicts, sel_scores = infer(state, dist_d[sel_t], x_d[sel_idx],
                                             sigma=cfg.sigma)
            data_2_bkt = apply_redundancy_subset(data_2_bkt, sel_scores, sel_predicts,
                                                 sel_idx, device=dev)
            layout = build_bucket_layout(data_2_bkt, n_bkt)
    del dist_d

    # (6) the measured sweep on the sharded engine (the analytic sweep needs
    # a per-(query, bucket) single-device scan, which sharding avoids)
    if serve_sweep:
        with timer("sharded engine build + measured sweep"):
            engine = ShardedQueryEngine(
                x_d, layout, km.centroids, scaler, state.params, mesh,
                metric=cfg.dis_metric, n_mul=cfg.n_mul,
            )
            serve_rows = engine.sweep(x_q, knn_query, cfg.k, thresholds)
        for r in serve_rows:
            say(f"threshold {r['threshold']:.3f}  recall {r['avg_recall']:.4f}  "
                f"nprobe {r['avg_nprobe']:.2f}  cmp {r['avg_cmp']:.0f}  QPS {r['qps']:.0f}")
        results["serve_rows"] = serve_rows
        results["engine"] = engine

    if lead and cfg.pth_log and cfg.file_name:
        os.makedirs(cfg.pth_log, exist_ok=True)
        if serve_sweep:
            sweep_to_csv(
                [SweepRow(r["threshold"], r["avg_nprobe"], r["avg_recall"], r["avg_cmp"],
                          r["qps"]) for r in results["serve_rows"]],
                os.path.join(cfg.pth_log, cfg.file_name + "_tuning_threshold",
                             f"{cfg.duplicate_type}_sharded.csv"),
            )
        _epochs_to_csv(epoch_rows, os.path.join(cfg.pth_log, cfg.df_name))

    results.update({"data_2_bkt": data_2_bkt, "layout": layout, "outputs": outputs})
    return results


def distributed_rank(cfg: Config, bundle: DatasetBundle | None = None,
                     init_model: ProbingMLP | None = None, *, mesh: Mesh) -> dict:
    """One rank of the pipeline (`launch` runs it on every rank).  Rank 0
    appends to the log file; the result is run_distributed's with host
    values only: the engine dropped, the model as lira_tpu's parameter
    tree ('params'), and 'ranks': each rank's device and its K2 (the
    sharded kNN) and K1 (the sharded engine) launches, in rank order."""
    import torch.distributed as dist

    from ..engine.screen import union_groupmin
    from ..models.probing_mlp import params_to_jax
    from ..ops.groupmin import groupmin

    k2_0, k1_0 = groupmin.launches, union_groupmin.launches
    with contextlib.ExitStack() as stack:
        fw = None
        if mesh.rank == 0 and cfg.pth_log and cfg.log_name:
            os.makedirs(cfg.pth_log, exist_ok=True)
            fw = stack.enter_context(
                open(os.path.join(cfg.pth_log, cfg.log_name), "a", encoding="utf-8"))
        res = run_distributed(cfg, mesh, bundle=bundle, log_file=fw, init_model=init_model)
        if mesh.rank == 0:
            fprint("finish!", fw)
    res.pop("engine", None)
    res["params"] = params_to_jax(res.pop("state").model)
    mine = {"rank": mesh.rank, "device": str(mesh.device),
            "k2_launches": groupmin.launches - k2_0,
            "k1_launches": union_groupmin.launches - k1_0}
    res["ranks"] = [None] * mesh.size
    dist.all_gather_object(res["ranks"], mine, group=mesh.group)
    return res


def main(argv=None):
    """CLI: `python -m lira_tpu_torch distributed --n_shards 8 ...` (the
    smallscale pipeline's Config flags, plus the rank count, --backend
    'nccl' (one card a rank) or 'gloo' (ranks sharing a card, or CPU
    ranks), and --device 'cuda' or 'cpu').  Returns rank 0's
    `distributed_rank` result."""
    import sys

    from ..config import parse_config, split_device

    argv = list(sys.argv[1:] if argv is None else argv)
    n_shards, backend = 8, "nccl"
    for flag in ("--n_shards", "--backend"):
        if flag in argv:
            i = argv.index(flag)
            if flag == "--n_shards":
                n_shards = int(argv[i + 1])
            else:
                backend = argv[i + 1]
            del argv[i : i + 2]
    device, rest = split_device(argv)
    cfg = parse_config(rest)
    return launch(n_shards, distributed_rank, cfg, backend=backend, device=device)


if __name__ == "__main__":
    main()
