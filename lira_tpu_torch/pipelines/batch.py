"""Batch experiment runner: grids of (dataset × n_bkt × metric × ratio)
(port of lira_tpu/pipelines/batch.py, over the port's pipelines).

The Python replacement for the reference's shell orchestration layer
(run_batch_smallscale.sh / index_batch.sh / run_smallscale_simple.sh grids).
Failures in one config are logged and the grid continues, like the
reference's `continue past failed configs` behavior.
"""

from __future__ import annotations

import argparse
import os
import time
import traceback

from ..config import Config

# canonical grids from the reference's batch scripts (SURVEY.md §2.3)
DEFAULT_GRID = {
    "sift": {"n_bkt": [64, 256, 512, 1024], "metric": "L2"},
    "gist": {"n_bkt": [64, 256, 512, 1024], "metric": "L2"},
    "tiny5m": {"n_bkt": [64, 256, 512, 2048], "metric": "L2"},
    "sift10m": {"n_bkt": [256, 2048], "metric": "L2"},
    "deep10m": {"n_bkt": [256, 2048], "metric": "L2"},
    "bigann10m": {"n_bkt": [256, 2048], "metric": "L2"},
    "openai1536": {"n_bkt": [256], "metric": "inner_product"},
    "openai3072": {"n_bkt": [256], "metric": "inner_product"},
    "glove2m_normalized": {"n_bkt": [256], "metric": "inner_product"},
    "word2vec_normalized": {"n_bkt": [256], "metric": "inner_product"},
}


def run_grid(
    datasets: list[str],
    data_path: str,
    k: int = 10,
    redundancy_ratio: float = 0.03,
    n_epoch: int = 10,
    pipeline: str = "smallscale",
    grid: dict | None = None,
    device=None,
) -> list[dict]:
    from .largescale import run_largescale
    from .smallscale import run_smallscale

    grid = grid or DEFAULT_GRID
    runner = run_smallscale if pipeline == "smallscale" else run_largescale
    results = []
    for ds in datasets:
        spec = grid.get(ds, {"n_bkt": [256], "metric": "L2"})
        for n_bkt in spec["n_bkt"]:
            cfg = Config(
                dataset=ds, data_path=data_path, k=k, n_bkt=n_bkt,
                dis_metric=spec["metric"], n_epoch=n_epoch,
                redundancy_ratio=redundancy_ratio,
            ).update()
            os.makedirs(cfg.pth_log, exist_ok=True)
            t0 = time.time()
            entry = {"dataset": ds, "n_bkt": n_bkt, "metric": spec["metric"]}
            try:
                with open(os.path.join(cfg.pth_log, cfg.log_name), "a") as fw:
                    runner(cfg, log_file=fw, device=device)
                entry["status"] = "ok"
            except Exception as exc:  # a failed cell is reported; the grid goes on
                traceback.print_exc()
                entry["status"] = f"failed: {exc}"
            entry["seconds"] = round(time.time() - t0, 1)
            print(f">> {entry}")
            results.append(entry)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datasets", nargs="+", required=True)
    p.add_argument("--data_path", default="/data/vector_datasets")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--redundancy_ratio", type=float, default=0.03)
    p.add_argument("--n_epoch", type=int, default=10)
    p.add_argument("--pipeline", choices=["smallscale", "largescale"], default="smallscale")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    a = p.parse_args(argv)
    run_grid(a.datasets, a.data_path, a.k, a.redundancy_ratio, a.n_epoch, a.pipeline,
             device=a.device)


if __name__ == "__main__":
    main()
