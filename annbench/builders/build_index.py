"""Builds the index through the port's `pipelines/build_index.py::
build_index` (self-kNN, K-Means, labels, training, optional redundancy),
then reads its artifacts back, as a server loads a built index.

The artifacts go to a fresh directory under the temporary directory and
are deleted once read.  `config` holds the port's `Config` fields; the
build's stage timers are kept as spans (`>> <stage> time: <s>s`).
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import sys
import tempfile

from annbench.core.spans import stage_spans


def build(x_d, queries, groundtruth, spec: dict, metric: str, device) -> dict:
    from lira_tpu_torch.config import Config
    from lira_tpu_torch.io.artifacts import load_index_artifacts
    from lira_tpu_torch.io.datasets import DatasetBundle
    from lira_tpu_torch.partition.assign import build_bucket_layout
    from lira_tpu_torch.pipelines.build_index import build_index

    out = tempfile.mkdtemp(prefix="annbench_index_")
    cfg = Config(dataset="annbench", data_path=out, dis_metric=metric,
                 **spec["config"]).update()
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            prefix = build_index(cfg, DatasetBundle("annbench", x_d, queries, groundtruth),
                                 out_dir=out, log_file=log, use_cache=False, device=device)
        art = load_index_artifacts(out, os.path.basename(prefix))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    n_bkt = art["manifest"]["n_bkt"]
    return {"centroids": art["centroids"], "data_2_bkt": art["data_2_bkt"],
            "scaler": art["scaler"], "mlp": art["params"], "n_mul": art["manifest"]["n_mul"],
            "layout": build_bucket_layout(art["data_2_bkt"], n_bkt),
            "spans": stage_spans(log.getvalue())}
