"""Index builder: build + train + redundancy, then export the serving
artifacts (port of lira_tpu/pipelines/build_index.py).

The self-kNN goes through `get_self_knn` (on the card the fused path and
K2 at "highest"); `--calibrate_margin` measures the bf16 and int8 screens'
zero-miss margins on blocked engines (K1) and stores them in the manifest.
Unlike lira_tpu, which passes over a screen dtype that fails to build in
its environment, the port lets any failure fail the build.  The artifacts
are read by pipelines/search_cli.py of either package.

    python -m lira_tpu_torch build --device cpu --dataset toyv \\
        --data_path /path/to/data --k 5 --n_bkt 8 --n_epoch 2
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..config import Config, parse_config, split_device
from ..io.artifacts import save_index_artifacts
from ..io.datasets import DatasetBundle, load_data
from ..labels.distr import knn_bucket_labels
from ..labels.scaler import scaled_centroid_distances
from ..logging_utils import fprint, stage_timer
from ..models.train import infer, make_train_state, predict_counts, train_epoch
from ..partition.assign import build_bucket_layout
from ..partition.kmeans import kmeans_assign, kmeans_fit
from ..redundancy.assign import apply_redundancy_subset, select_top_ratio
from .smallscale import TRAIN_ON_DEVICE_BYTES, get_self_knn


def build_index(
    cfg: Config,
    bundle: DatasetBundle | None = None,
    out_dir: str | None = None,
    log_file=None,
    use_cache: bool = True,
    device=None,
) -> str:
    """Run the build pipeline and export artifacts; returns the prefix path."""
    dev = resolve_device(device)
    fw = log_file
    if bundle is None:
        bundle = load_data(cfg.dataset, data_path=cfg.data_path)
    x_d, x_q = bundle.base, bundle.query
    n_d, dim = x_d.shape
    n_bkt = cfg.n_bkt

    with stage_timer("self knn", fw):
        knn_data = get_self_knn(x_d, cfg, use_cache=use_cache, device=dev)

    with stage_timer("build kmeans index", fw):
        km = kmeans_fit(x_d, n_bkt, niter=cfg.kmeans_niter, seed=cfg.seed,
                        init=cfg.kmeans_init, device=dev)
        assign = kmeans_assign(x_d, km.centroids, device=dev)
    data_2_bkt = np.full((n_d, cfg.n_mul), -1, dtype=np.int32)
    data_2_bkt[:, 0] = assign

    labels_data = knn_bucket_labels(knn_data, data_2_bkt, n_bkt)
    with stage_timer("scaled distances", fw):
        dist_d, _, scaler = scaled_centroid_distances(x_d, None, km.centroids, device=dev)

    # training features that fit the budget go to the device once
    train_vec, train_tgt = x_d, labels_data
    if dist_d.nbytes + labels_data.nbytes + x_d.nbytes < TRAIN_ON_DEVICE_BYTES:
        train_vec = torch.as_tensor(x_d, device=dev)
        train_tgt = torch.as_tensor(labels_data, device=dev)
    state = make_train_state(cfg.seed, n_bkt, dim, lr=cfg.lr, device=dev)
    with stage_timer("training", fw):
        for epoch in range(cfg.n_epoch):
            with stage_timer("training epoch", fw):
                state, loss = train_epoch(state, dist_d, train_vec, train_tgt,
                                          batch_size=cfg.batch_size)
            fprint(f"Epoch {epoch}, Train Loss: {loss:.5f}", fw)

    if cfg.duplicate_type == "model":
        # device-reduced counts select the boundary minority; only its rows
        # are re-scored
        with stage_timer("redundancy", fw):
            counts = predict_counts(state, dist_d, train_vec, sigma=cfg.sigma)
            selected = np.sort(select_top_ratio(counts, cfg.redundancy_ratio))
            fprint(f">> redundancy: duplicating {len(selected)}/{n_d} boundary vectors", fw)
            sel_t = torch.as_tensor(selected, device=dev)
            sel_vec = train_vec[sel_t] if isinstance(train_vec, torch.Tensor) else x_d[selected]
            sel_predicts, sel_scores = infer(state, dist_d[sel_t], sel_vec, sigma=cfg.sigma)
            data_2_bkt = apply_redundancy_subset(data_2_bkt, sel_scores, sel_predicts, selected,
                                                 device=dev)
    del dist_d, train_vec, train_tgt

    extra_meta = {"k": cfg.k, "redundancy_ratio": cfg.redundancy_ratio}
    if cfg.calibrate_margin:
        # measured zero-miss selection margins for the approximate screens
        # on this dataset's queries, stored for serving
        with stage_timer("calibrate screen margins", fw):
            extra_meta["calibrated_margins"] = calibrate_screen_margins(
                x_d, data_2_bkt, km.centroids, scaler, state.params,
                x_q, n_bkt, cfg.k, log_file=fw, device=dev, metric=cfg.dis_metric,
            )

    out_dir = out_dir or cfg.pth_log
    with stage_timer("save artifacts", fw):
        prefix = save_index_artifacts(
            out_dir,
            cfg.file_name,
            centroids=km.centroids,
            data_2_bkt=data_2_bkt,
            x_d=x_d,
            scaler=scaler,
            params=state.params,
            metric=cfg.dis_metric,
            extra_meta=extra_meta,
        )
    fprint(f">> artifacts saved under prefix {prefix}", fw)
    return prefix


def calibrate_screen_margins(
    x_d, data_2_bkt, centroids, scaler, params, x_q, n_bkt, k,
    n_cal: int = 4096, log_file=None, device=None, metric: str = "L2",
) -> dict:
    """Measured zero-miss selection margin per screen dtype on this index.

    Runs engine/calibrate.calibrate_block_margin for the bfloat16 and int8
    screens at a wide operating point (mean nprobe ≈ min(32, n_bkt/4): more
    probed tiles per query, more chances for a rounding miss, so the wide
    point upper-bounds the narrow ones) and returns {dtype: {"margin",
    "zero_miss_margin", "miss_rates", "sel_rows"}} for the manifest.  A
    failure of either dtype fails the calibration."""
    from ..engine.calibrate import calibrate_block_margin
    from ..engine.serve import QueryEngine

    layout = build_bucket_layout(data_2_bkt, n_bkt)
    q = np.asarray(x_q[:n_cal], np.float32)
    out: dict = {}
    for dtype in ("bfloat16", "int8"):
        eng = QueryEngine(
            x_d, layout, centroids, scaler, params, metric=metric,
            scan_impl="blocked", scan_dtype=dtype, device=device,
        )
        probe_out = eng.probe(q[: min(512, len(q))])
        target = min(32.0, n_bkt / 4.0)
        thr = float(np.quantile(probe_out, 1.0 - target / n_bkt))
        cal = calibrate_block_margin(eng, q, thr, k)
        out[dtype] = {
            "margin": int(cal.margin),
            "zero_miss_margin": (
                None if cal.zero_miss_margin is None else int(cal.zero_miss_margin)
            ),
            "miss_rates": {str(m): r for m, r in cal.miss_rates.items()},
            "sel_rows": int(eng.block_sel_rows),
        }
        fprint(
            f">> calibrated {dtype} screen margin: {cal.margin} groups "
            f"(zero-miss at {cal.zero_miss_margin}, sel_rows="
            f"{eng.block_sel_rows}, {len(q)} queries)", log_file,
        )
        del eng
    return out


def main(argv=None):
    device, rest = split_device(argv)
    cfg = parse_config(rest)
    os.makedirs(cfg.pth_log, exist_ok=True)
    with open(os.path.join(cfg.pth_log, cfg.log_name), "a", encoding="utf-8") as fw:
        build_index(cfg, log_file=fw, device=device)


if __name__ == "__main__":
    main()
