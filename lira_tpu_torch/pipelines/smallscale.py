"""Small-scale end-to-end pipeline: build → train → evaluate → redundancy →
sweep (port of lira_tpu/pipelines/smallscale.py).

  1. load dataset (+ ground truth), compute/load cached self-kNN
  2. K-Means partition build, single-bucket assignment
  3. multi-label targets: data 0/1 labels + query gt bucket map
  4. standardized centroid-distance features (scaler persisted)
  5. probing-MLP training, per-epoch eval metrics table
  6. baseline threshold sweep (part 0) via one corpus scan
  7. learning-based redundancy of the top-x% boundary vectors
  8. rebuilt layout, part-1 sweep
  9. optional: measured serving-engine sweep (batched QPS)

Everything runs on `device` (cuda unless the caller passes "cpu"; the
CLI's `--device` flag is the counterpart of lira_tpu's JAX_PLATFORMS).

    python -m lira_tpu_torch.pipelines.smallscale --device cpu \\
        --dataset toyv --data_path /path/to/data --k 5 --n_bkt 8 --n_epoch 2
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..engine.scan import BucketCorpus, bucket_topk
from ..engine.serve import QueryEngine
from ..engine.sweep import gt_hit_tensor, sweep_to_csv, threshold_sweep
from ..io.cache import load_knn_cache, save_knn_cache
from ..io.datasets import DatasetBundle, load_data
from ..labels.distr import gt_bucket_map, knn_bucket_labels
from ..labels.scaler import scaled_centroid_distances
from ..logging_utils import ascii_table, fprint, stage_timer
from ..models.metrics import probing_metrics
from ..models.train import evaluate, infer, make_train_state, predict_counts, train_epoch
from ..ops.knn import self_knn
from ..ops.knn_pallas import self_knn_fused
from ..partition.assign import build_bucket_layout
from ..partition.kmeans import kmeans_assign, kmeans_fit
from ..redundancy.assign import apply_redundancy_subset, select_top_ratio

# training features (distances, vectors, uint8 targets) up to this many
# bytes stay on the card for every epoch; lira_tpu keeps < 9e9 on a 16 GB
# TPU.  40 GB leaves half of an 80 GB H100 for the kNN, the bucket corpus
# and the serving engine.
TRAIN_ON_DEVICE_BYTES = 40e9


def get_self_knn(
    x_d: np.ndarray, cfg: Config, use_cache: bool = True, cache_tag: str = "",
    device=None,
) -> np.ndarray:
    """Cache hit, or the self-kNN and a cache write.  On the card it goes
    through the fused two-round path at f32 selection precision (K2, with
    no score matrix): the cache is labelled exact, so the bf16 round 1 is
    not used.  On the CPU the chunked exact `self_knn`.

    `cache_tag` must identify the row membership when x_d is a subset of
    the dataset."""
    dev = resolve_device(device)
    if use_cache and cfg.dataset:
        cached = load_knn_cache(
            cfg.data_path, cfg.dataset, cfg.k, len(x_d), tag=cache_tag,
            metric=cfg.dis_metric,
        )
        if cached is not None:
            return cached
    t0 = time.perf_counter()
    if dev.type == "cuda":
        knn = self_knn_fused(x_d, cfg.k, metric=cfg.dis_metric, precision="highest",
                             device=dev)
    else:
        knn = self_knn(x_d, cfg.k, metric=cfg.dis_metric, device=dev)
    elapsed = time.perf_counter() - t0
    if use_cache and cfg.dataset:
        try:
            save_knn_cache(
                cfg.data_path, cfg.dataset, knn, dim=x_d.shape[1],
                method=f"{dev.type}_flat_exact", timings={"search_time": round(elapsed, 3)},
                tag=cache_tag, metric=cfg.dis_metric,
            )
        except OSError:
            pass  # read-only dataset dir: skip caching
    return knn


def run_smallscale(
    cfg: Config,
    bundle: DatasetBundle | None = None,
    log_file=None,
    serve_sweep: bool = False,
    use_cache: bool = True,
    device=None,
) -> dict:
    dev = resolve_device(device)
    fw = log_file
    if bundle is None:
        bundle = load_data(cfg.dataset, data_path=cfg.data_path)
    if bundle.groundtruth is None:
        raise ValueError(f"Ground truth missing for dataset {cfg.dataset}")
    x_d, x_q = bundle.base, bundle.query
    n_d, dim = x_d.shape
    n_bkt = cfg.n_bkt
    fprint(
        f">> dataset: {cfg.dataset}, data: {x_d.shape}, query: {x_q.shape}, "
        f"n_bkt: {n_bkt}, k: {cfg.k}, metric: {cfg.dis_metric}, device: {dev}",
        fw,
    )

    # (1) self-kNN labels for the corpus; query labels from ground truth
    knn_data = get_self_knn(x_d, cfg, use_cache=use_cache, device=dev)
    knn_query = bundle.groundtruth[:, : cfg.k]

    # (2) initial partitioning
    with stage_timer("build kmeans index", fw):
        km = kmeans_fit(x_d, n_bkt, niter=cfg.kmeans_niter, seed=cfg.seed,
                        init=cfg.kmeans_init, device=dev)
        assign = kmeans_assign(x_d, km.centroids, device=dev)
    data_2_bkt = np.full((n_d, cfg.n_mul), -1, dtype=np.int32)
    data_2_bkt[:, 0] = assign
    layout = build_bucket_layout(data_2_bkt, n_bkt)

    # (3) multi-label targets + distance features
    with stage_timer("label construction", fw):
        labels_data = knn_bucket_labels(knn_data, data_2_bkt, n_bkt)
        labels_query = knn_bucket_labels(knn_query, data_2_bkt, n_bkt)
        gt_buckets = gt_bucket_map(knn_query, data_2_bkt)
    with stage_timer("scaled distances", fw):
        # the (n, n_bkt) features come back on the device
        dist_d, dist_q, scaler = scaled_centroid_distances(x_d, x_q, km.centroids,
                                                           device=dev)
        if cfg.pth_log and cfg.file_name:
            scaler.save(cfg.pth_log, cfg.file_name)

    # training features that fit the budget go to the device once, and
    # every epoch trains from device slices
    train_dist, train_vec, train_tgt = dist_d, x_d, labels_data
    if dist_d.nbytes + labels_data.nbytes + x_d.nbytes < TRAIN_ON_DEVICE_BYTES:
        train_vec = torch.as_tensor(x_d, device=dev)
        train_tgt = torch.as_tensor(labels_data, device=dev)

    # (4) probing model training
    state = make_train_state(cfg.seed, n_bkt, dim, lr=cfg.lr, device=dev)
    epoch_rows = []
    headers = ["Epoch", "Loss", "Accuracy", "Hit Rate", "nprobe predict",
               "nprobe target", "KNN Recall", "KNN Computations"]

    def eval_epoch(epoch):
        _, predicts, loss_test, outputs = evaluate(
            state, dist_q, x_q, labels_query, sigma=cfg.sigma, batch_size=cfg.batch_size
        )
        m = probing_metrics(
            predicts, labels_query, gt_buckets, layout.sizes, cfg.k, epoch=epoch,
            loss=round(loss_test, 4),
        )
        epoch_rows.append(m)
        fprint(ascii_table(headers, [[m[h] for h in headers]]), fw)
        return outputs

    # keep the pre-training outputs: with n_epoch=0 the loop never runs
    outputs = eval_epoch(-1)
    for epoch in range(cfg.n_epoch):
        t0 = time.perf_counter()
        state, loss_train = train_epoch(state, train_dist, train_vec, train_tgt,
                                        batch_size=cfg.batch_size)
        t_train = time.perf_counter() - t0
        fprint(f"Epoch {epoch}, Train Loss: {loss_train:.5f}, time_train: {t_train:.2f}s", fw)
        outputs = eval_epoch(epoch)

    results: dict = {"epoch_rows": epoch_rows, "state": state, "kmeans": km, "scaler": scaler}

    # optional diagnostics: per-query nprobe study + kNN-tail analysis
    # (reference: utils.py:502-519 / utils.py:438-500)
    if cfg.run_diagnostics:
        from ..diagnostics import observe_knn_tail, per_query_nprobe
        from ..labels.distr import knn_bucket_counts

        cnt_query = knn_bucket_counts(knn_query, data_2_bkt, n_bkt)
        csv = None
        if cfg.pth_log and cfg.file_name:
            csv = os.path.join(cfg.pth_log, f"{cfg.file_name}_perquery.csv")
        results_pq = per_query_nprobe(outputs, cnt_query, layout.sizes, cfg.k, csv_path=csv)
        fprint(f">> per-query study: mean nprobe@0.98 = {results_pq[:, 1].mean():.2f}", fw)
        _, data_outputs_diag = infer(state, train_dist, train_vec, sigma=cfg.sigma)
        tail = observe_knn_tail(
            cnt_query, data_outputs_diag, dist_d.cpu().numpy(), knn_query, data_2_bkt,
            max_points=2000,
        )
        fprint(
            f">> kNN-tail: {len(tail['tail_ids'])} boundary points; "
            f"probing-rank validity@1 {tail['output_rank_valid'][:2]}, "
            f"distance-rank validity@1 {tail['dist_rank_valid'][:2]}",
            fw,
        )
        results["per_query"], results["knn_tail"] = results_pq, tail

    # (5) baseline sweep (part 0) + redundancy + part-1 sweep
    thresholds = np.arange(cfg.t_min, cfg.t_max + cfg.t_step / 2, cfg.t_step)
    sweep_parts = []

    def scan_and_sweep():
        corpus = BucketCorpus.build(x_d, layout, device=dev)
        found = bucket_topk(x_q, corpus, cfg.k, metric=cfg.dis_metric)
        del corpus  # corpus-sized on the device: freed before the next stage
        hit = gt_hit_tensor(found, knn_query, gt_buckets)
        return threshold_sweep(outputs, gt_buckets, hit, layout.sizes, cfg.k, thresholds)

    if cfg.duplicate_type == "model":
        # boundary selection from device-reduced counts; the selected
        # minority is re-scored below
        counts = predict_counts(state, train_dist, train_vec, sigma=cfg.sigma)
        with stage_timer("baseline scan + sweep (part 0)", fw):
            sweep_parts.append(scan_and_sweep())

        selected = select_top_ratio(counts, cfg.redundancy_ratio)
        fprint(f">> redundancy: duplicating top {len(selected)}/{n_d} boundary vectors", fw)
        with stage_timer("redundancy assignment", fw):
            sel_idx = np.sort(selected)  # monotone gather; set-identical
            sel_t = torch.as_tensor(sel_idx, device=dev)
            sel_vec = train_vec[sel_t] if isinstance(train_vec, torch.Tensor) else x_d[sel_idx]
            sel_predicts, sel_scores = infer(state, train_dist[sel_t], sel_vec, sigma=cfg.sigma)
            # last use of the training features: free them before the
            # part-1 corpus build and the serving engine's tables
            del train_dist, train_vec, train_tgt, dist_d
            data_2_bkt = apply_redundancy_subset(data_2_bkt, sel_scores, sel_predicts,
                                                 sel_idx, device=dev)
            layout = build_bucket_layout(data_2_bkt, n_bkt)
            gt_buckets = gt_bucket_map(knn_query, data_2_bkt)

        with stage_timer("redundant scan + sweep (part 1)", fw):
            sweep_parts.append(scan_and_sweep())
    else:
        with stage_timer("scan + sweep", fw):
            sweep_parts.append(scan_and_sweep())

    # (6) measured serving sweep (batched QPS) on the final layout; the
    # measured QPS is joined onto the matching (last) analytic sweep part
    if serve_sweep:
        engine = QueryEngine(
            x_d, layout, km.centroids, scaler, state.params, metric=cfg.dis_metric,
            n_mul=cfg.n_mul, scan_impl="blocked", device=dev,
        )
        serve_rows = engine.sweep(x_q, knn_query, cfg.k, thresholds)
        results["serve_rows"] = serve_rows
        results["engine"] = engine
        qps_by_thr = {round(r["threshold"], 6): r["qps"] for r in serve_rows}
        for row in sweep_parts[-1]:
            row.qps = qps_by_thr.get(round(row.threshold, 6), row.qps)

    if cfg.pth_log and cfg.file_name:
        os.makedirs(cfg.pth_log, exist_ok=True)
        for part, rows in enumerate(sweep_parts):
            sweep_to_csv(
                rows,
                os.path.join(
                    cfg.pth_log, cfg.file_name + "_tuning_threshold",
                    f"{cfg.duplicate_type}_{part}.csv",
                ),
            )
        _epochs_to_csv(epoch_rows, os.path.join(cfg.pth_log, cfg.df_name))

    results.update(
        {
            "data_2_bkt": data_2_bkt,
            "layout": layout,
            "sweep_parts": sweep_parts,
            "outputs": outputs,
        }
    )
    return results


def _epochs_to_csv(rows: list[dict], path: str) -> None:
    if not rows:
        return
    headers = list(rows[0].keys())
    with open(path, "w") as f:
        f.write(",".join(headers) + "\n")
        for r in rows:
            f.write(",".join(str(r[h]) for h in headers) + "\n")


def main(argv=None):
    from ..config import parse_config, split_device

    device, rest = split_device(argv)
    cfg = parse_config(rest)
    os.makedirs(cfg.pth_log, exist_ok=True)
    with open(os.path.join(cfg.pth_log, cfg.log_name), "a", encoding="utf-8") as fw:
        run_smallscale(cfg, log_file=fw, serve_sweep=True, device=device)
        fprint("finish!", fw)


if __name__ == "__main__":
    main()
