"""Large-scale pipeline: train on a sampled subset, redundancy over the full
corpus (port of lira_tpu/pipelines/largescale.py).

  1. uniform subset (default 1%) of the corpus
  2. subset self-kNN (`get_self_knn`: K2 on the card) + query kNN on the
     subset (both cached)
  3. K-Means trained on the subset; probing MLP trained on subset labels
  4. full corpus assigned to the trained centroids in streaming chunks
  5. learning-based redundancy applied to *every* point, scored in
     `redundancy_batch`-row batches on the device
  6. threshold sweeps before/after redundancy (default range 0.1–0.95)

As in lira_tpu, batch features reuse the subset-fitted scaler (the
reference re-fits a scaler on every 1M-row batch).  With cfg.checkpoint the
run is restartable at stage and batch granularity under
{pth_log}/{file_name}_ckpt/, with lira_tpu's file names and keys.

    python -m lira_tpu_torch largescale --device cpu --dataset toyv \\
        --data_path /path/to/data --k 5 --n_bkt 8 --n_epoch 1 --subset_fraction 0.25
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..engine.scan import BucketCorpus, bucket_topk
from ..engine.sweep import gt_hit_tensor, sweep_to_csv, threshold_sweep
from ..io.datasets import DatasetBundle, load_data
from ..labels.distr import gt_bucket_map, knn_bucket_labels
from ..labels.scaler import scaled_centroid_distances
from ..logging_utils import ascii_table, fprint, stage_timer
from ..models.checkpoint import load_train_state, save_train_state
from ..models.metrics import probing_metrics
from ..models.train import evaluate, make_train_state, train_epoch
from ..ops.distance import l2_to_centroids
from ..ops.knn import exact_knn
from ..partition.assign import build_bucket_layout
from ..partition.kmeans import KMeans, kmeans_assign, kmeans_fit
from ..redundancy.assign import _redundancy_rows_dev
from .smallscale import _epochs_to_csv, get_self_knn


class PipelineCheckpoint:
    """Stage/array checkpoint store for restartable pipelines: stages
    (kmeans, assignment, part-0/1 scans), the redundancy cursor per batch,
    and training per epoch (models/checkpoint.py).  Writes are atomic (tmp
    + rename)."""

    def __init__(self, root: str, fresh: bool = False):
        self.root = root
        if fresh and os.path.isdir(root):
            shutil.rmtree(root)
        os.makedirs(root, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def has(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def save(self, name: str, **arrays) -> None:
        tmp = self.path(name + ".tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, self.path(name))

    def load(self, name: str):
        return np.load(self.path(name))


def query_knn_on_subset(
    x_sub: np.ndarray, x_q: np.ndarray, cfg: Config, use_cache: bool = True,
    cache_tag: str = "", device=None,
) -> np.ndarray:
    """Query ground truth restricted to the training subset, cached
    (reference: LIRA_largescale.py:217-234).  `cache_tag` identifies the
    subset membership: (k, nsub) alone would collide across seeds."""
    cache_file = None
    if use_cache and cfg.dataset:
        cache_dir = os.path.join(cfg.data_path, cfg.dataset, "knn_cache")
        tag = f"-{cache_tag}" if cache_tag else ""
        cache_file = os.path.join(
            cache_dir, f"{cfg.dataset}-query_on_subset_knn{cfg.k}-nsub{len(x_sub)}{tag}.npy"
        )
        if os.path.exists(cache_file):
            return np.load(cache_file).astype(np.int32)
    _, knn = exact_knn(x_sub, x_q, cfg.k, metric=cfg.dis_metric, device=device)
    if cache_file:
        try:
            os.makedirs(os.path.dirname(cache_file), exist_ok=True)
            np.save(cache_file, knn)
        except OSError:
            pass  # read-only dataset dir: skip caching
    return knn


@torch.no_grad()
def _fused_redundancy_batch(model, centroids, mean, scale, batch, cur, sigma: float,
                            n_mul: int) -> torch.Tensor:
    """probe → σ-threshold → redundancy rule, all on the device: only the
    (rows, n_mul) int32 assignment leaves it, never the (rows, n_bkt)
    scores."""
    d = l2_to_centroids(batch, centroids)
    outputs = model((d - mean) / scale, batch)
    return _redundancy_rows_dev(outputs, outputs > sigma, cur, n_mul)


def full_corpus_redundancy(
    x_d: np.ndarray,
    data_2_bkt: np.ndarray,
    centroids: np.ndarray,
    scaler,
    state,
    cfg: Config,
    ckpt: PipelineCheckpoint | None = None,
    device=None,
) -> np.ndarray:
    """Score and re-assign every corpus point in device-sized batches
    (reference: LIRA_largescale.py:320-329 + the offset-aware
    mul_partition_by_model at :51-72).  `state` is a TrainState or a
    ProbingMLP, on `device`.  With `ckpt`, the batch cursor and the
    batch's rows are saved after every batch, so a killed run resumes at
    the first unfinished batch."""
    dev = resolve_device(device)
    n_d = len(x_d)
    out = np.array(data_2_bkt, copy=True)
    cj = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    mean = torch.as_tensor(np.asarray(scaler.mean_, np.float32), device=dev)
    scale = torch.as_tensor(np.asarray(scaler.scale_, np.float32), device=dev)
    model = getattr(state, "params", state)
    n_bkt = cj.shape[0]
    # keep the (rows, n_bkt) f32 score and rank tensors within a fixed
    # budget (lira_tpu's 4 GiB)
    budget_rows = max(1 << 14, (1 << 32) // (max(n_bkt, 1) * 8))
    batch_rows = min(cfg.redundancy_batch, budget_rows)
    cursor = 0
    if ckpt is not None and ckpt.has("redundancy_cursor.npz"):
        f = ckpt.load("redundancy_cursor.npz")
        # a cursor is valid only at this run's batch boundaries
        if int(f["batch_rows"]) == batch_rows:
            cursor = int(f["cursor"])
            # completed batches live in per-batch files: O(n) writes in all
            for s in range(0, cursor, batch_rows):
                out[s : min(s + batch_rows, n_d)] = ckpt.load(
                    f"redundancy_rows_{s}.npz"
                )["rows"]
    for s in range(0, n_d, batch_rows):
        e = min(s + batch_rows, n_d)
        if e <= cursor:  # batch finished by the run we resumed from
            continue
        rows = _fused_redundancy_batch(
            model, cj, mean, scale,
            torch.as_tensor(np.ascontiguousarray(x_d[s:e], np.float32), device=dev),
            torch.as_tensor(out[s:e, 0], dtype=torch.int32, device=dev),
            float(cfg.sigma), cfg.n_mul,
        )
        out[s:e] = rows.cpu().numpy()
        if ckpt is not None:
            ckpt.save(f"redundancy_rows_{s}.npz", rows=out[s:e])
            ckpt.save("redundancy_cursor.npz", cursor=np.int64(e),
                      batch_rows=np.int64(batch_rows))
    return out


def run_largescale(
    cfg: Config,
    bundle: DatasetBundle | None = None,
    log_file=None,
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

    # checkpoint store: fresh unless resuming (stages of another
    # configuration must not be reused)
    ckpt = None
    if cfg.checkpoint and cfg.pth_log and cfg.file_name:
        ckpt = PipelineCheckpoint(
            os.path.join(cfg.pth_log, cfg.file_name + "_ckpt"), fresh=not cfg.resume
        )
        if cfg.resume:
            fprint(f">> resume: checkpoint dir {ckpt.root}", fw)
    resumed = ckpt is not None and cfg.resume

    # (1) training subset
    nd_sub = max(1, int(n_d * cfg.subset_fraction))
    rng = np.random.default_rng(cfg.seed)
    sub_idx = rng.choice(n_d, size=nd_sub, replace=False)
    x_sub = np.ascontiguousarray(x_d[sub_idx])
    fprint(f">> subset: {nd_sub}/{n_d} rows for training, device: {dev}", fw)

    # (2) labels on the subset, caches keyed by subset membership
    sub_tag = f"seed{cfg.seed}"
    knn_sub = get_self_knn(x_sub, cfg, use_cache=use_cache, cache_tag=sub_tag, device=dev)
    knn_query_sub = query_knn_on_subset(x_sub, x_q, cfg, use_cache=use_cache,
                                        cache_tag=sub_tag, device=dev)

    # (3) subset partitioning + model training
    with stage_timer("build kmeans (subset)", fw):
        if resumed and ckpt.has("kmeans.npz"):
            f = ckpt.load("kmeans.npz")
            km = KMeans(centroids=f["centroids"], objective=f["objective"])
            assign_sub = f["assign_sub"]
        else:
            km = kmeans_fit(x_sub, n_bkt, niter=cfg.kmeans_niter, seed=cfg.seed,
                            init=cfg.kmeans_init, device=dev)
            assign_sub = kmeans_assign(x_sub, km.centroids, device=dev)
            if ckpt is not None:
                ckpt.save("kmeans.npz", centroids=km.centroids,
                          objective=km.objective, assign_sub=assign_sub)
    d2b_sub = np.full((nd_sub, cfg.n_mul), -1, dtype=np.int32)
    d2b_sub[:, 0] = assign_sub
    layout_sub = build_bucket_layout(d2b_sub, n_bkt)

    labels_sub = knn_bucket_labels(knn_sub, d2b_sub, n_bkt)
    labels_query_sub = knn_bucket_labels(knn_query_sub, d2b_sub, n_bkt)
    gtb_sub = gt_bucket_map(knn_query_sub, d2b_sub)

    with stage_timer("scaled distances (subset)", fw):
        dist_sub, dist_q, scaler = scaled_centroid_distances(x_sub, x_q, km.centroids,
                                                             device=dev)
        if cfg.pth_log and cfg.file_name:
            scaler.save(cfg.pth_log, cfg.file_name)

    state = make_train_state(cfg.seed, n_bkt, dim, lr=cfg.lr, device=dev)
    start_epoch = 0
    if resumed and ckpt.has("train_state.npz"):
        state, start_epoch = load_train_state(ckpt.path("train_state.npz"), state)
        fprint(f">> resume: training restored at epoch {start_epoch}", fw)
    # the subset's epoch inputs go to the device once
    x_sub_dev = torch.as_tensor(x_sub, device=dev)
    labels_sub_dev = torch.as_tensor(labels_sub, device=dev)
    headers = ["Epoch", "Loss", "Accuracy", "Hit Rate", "nprobe predict",
               "nprobe target", "KNN Recall", "KNN Computations"]
    epoch_rows = []

    def eval_epoch(epoch):
        _, predicts, loss_test, outputs = evaluate(
            state, dist_q, x_q, labels_query_sub, sigma=cfg.sigma, batch_size=cfg.batch_size
        )
        m = probing_metrics(
            predicts, labels_query_sub, gtb_sub, layout_sub.sizes, cfg.k,
            epoch=epoch, loss=round(loss_test, 4),
        )
        epoch_rows.append(m)
        fprint(ascii_table(headers, [[m[h] for h in headers]]), fw)
        return outputs

    outputs = eval_epoch(start_epoch - 1)
    for epoch in range(start_epoch, cfg.n_epoch):
        with stage_timer("training epoch", fw):
            state, _ = train_epoch(state, dist_sub, x_sub_dev, labels_sub_dev,
                                   batch_size=cfg.batch_size)
        if ckpt is not None:
            save_train_state(state, ckpt.path("train_state.npz"), step=epoch + 1)
        outputs = eval_epoch(epoch)
    del dist_sub, x_sub_dev, labels_sub_dev

    # (4) full-corpus assignment with the trained quantizer
    with stage_timer("full corpus assignment", fw):
        if resumed and ckpt.has("assign_full.npz"):
            assign_full = ckpt.load("assign_full.npz")["assign"]
        else:
            assign_full = kmeans_assign(x_d, km.centroids, device=dev)
            if ckpt is not None:
                ckpt.save("assign_full.npz", assign=assign_full)
    data_2_bkt = np.full((n_d, cfg.n_mul), -1, dtype=np.int32)
    data_2_bkt[:, 0] = assign_full
    layout = build_bucket_layout(data_2_bkt, n_bkt)

    knn_query = bundle.groundtruth[:, : cfg.k]
    gt_buckets = gt_bucket_map(knn_query, data_2_bkt)

    thresholds = np.arange(cfg.t_min, cfg.t_max + 1e-9, cfg.t_step)
    sweep_parts = []

    def scan(name):
        if resumed and ckpt.has(name):
            return ckpt.load(name)["found"]
        corpus = BucketCorpus.build(x_d, layout, device=dev)
        found = bucket_topk(x_q, corpus, cfg.k, metric=cfg.dis_metric)
        del corpus  # corpus-sized on the device: freed before the next stage
        if ckpt is not None:
            ckpt.save(name, found=found)
        return found

    with stage_timer("baseline scan + sweep (part 0)", fw):
        hit = gt_hit_tensor(scan("part0_found.npz"), knn_query, gt_buckets)
        sweep_parts.append(
            threshold_sweep(outputs, gt_buckets, hit, layout.sizes, cfg.k, thresholds)
        )

    # (5) full-corpus learning-based redundancy (batch-cursor checkpointed)
    with stage_timer("full-corpus redundancy", fw):
        if resumed and ckpt.has("d2b_final.npz"):
            data_2_bkt = ckpt.load("d2b_final.npz")["d2b"]
        else:
            data_2_bkt = full_corpus_redundancy(
                x_d, data_2_bkt, km.centroids, scaler, state, cfg, ckpt=ckpt, device=dev
            )
            if ckpt is not None:
                ckpt.save("d2b_final.npz", d2b=data_2_bkt)
        layout = build_bucket_layout(data_2_bkt, n_bkt)
        gt_buckets = gt_bucket_map(knn_query, data_2_bkt)

    with stage_timer("redundant scan + sweep (part 1)", fw):
        hit = gt_hit_tensor(scan("part1_found.npz"), knn_query, gt_buckets)
        sweep_parts.append(
            threshold_sweep(outputs, gt_buckets, hit, layout.sizes, cfg.k, thresholds)
        )

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

    return {
        "epoch_rows": epoch_rows,
        "state": state,
        "kmeans": km,
        "scaler": scaler,
        "data_2_bkt": data_2_bkt,
        "assign_full": assign_full,
        "layout": layout,
        "sweep_parts": sweep_parts,
        "outputs": outputs,
        "sub_idx": sub_idx,
    }


def main(argv=None):
    from ..config import parse_config, split_device

    device, rest = split_device(argv)
    cfg = parse_config(rest)
    # large-scale defaults (reference: n_epoch=30, batch 512, coarse sweep
    # 0.1..0.95 step 0.05), applied only where the flag was not passed
    explicit = getattr(cfg, "_explicit", frozenset())
    if "n_epoch" not in explicit:
        cfg.n_epoch = 30
    if "batch_size" not in explicit:
        cfg.batch_size = 512
    if "t_min" not in explicit:
        cfg.t_min = 0.1
    if "t_max" not in explicit:
        cfg.t_max = 0.95
    if "t_step" not in explicit:
        cfg.t_step = 0.05
    os.makedirs(cfg.pth_log, exist_ok=True)
    with open(os.path.join(cfg.pth_log, cfg.log_name), "a", encoding="utf-8") as fw:
        run_largescale(cfg, log_file=fw, device=device)
        fprint("finish!", fw)


if __name__ == "__main__":
    main()
