"""Builds the index through the port's `pipelines/largescale.py::
run_largescale`: a training subset (self-kNN through K2, K-Means, the
probing MLP), the full corpus assigned, full-corpus learning-based
redundancy and the pipeline's two evaluation sweeps (which need the build
queries' ground truth).  Nothing is written: no log directory, no caches,
no checkpoints.  `config` holds the port's `Config` fields; the stage
timers are kept as spans.
"""

from __future__ import annotations

import contextlib
import io
import sys

from annbench.core.spans import stage_spans


def build(x_d, queries, groundtruth, spec: dict, metric: str, device) -> dict:
    from lira_tpu_torch.config import Config
    from lira_tpu_torch.io.datasets import DatasetBundle
    from lira_tpu_torch.pipelines.largescale import run_largescale

    cfg = Config(dataset="annbench", data_path="", dis_metric=metric,
                 **spec["config"]).update()
    cfg.pth_log = None  # no checkpoints, CSVs or scaler files
    log = io.StringIO()
    with contextlib.redirect_stdout(sys.stderr):
        res = run_largescale(cfg, DatasetBundle("annbench", x_d, queries, groundtruth),
                             log_file=log, use_cache=False, device=device)
    return {"centroids": res["kmeans"].centroids, "data_2_bkt": res["data_2_bkt"],
            "scaler": res["scaler"], "mlp": res["state"].params, "n_mul": cfg.n_mul,
            "layout": res["layout"], "spans": stage_spans(log.getvalue())}
