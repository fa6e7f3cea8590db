"""Real-dataset parity harness: run the pipeline + sweeps, diff against a
reference CSV.

Points at a dataset directory in the standard layout (SIFT1M etc.), runs
the full small-scale pipeline plus the measured serving sweep, writes the
sweep in the reference CSV schema, and — when a reference-produced CSV is
supplied — joins the two curves on threshold and reports recall / nprobe /
ndis deltas row by row.

The reference side runs on any machine with faiss + torch (reference:
LIRA_smallscale.py:176-241 writes `{duplicate_type}_{part}.csv` under
`./logs/{dataset}/ML_kmeans_RE_FLAT/{file_name}_tuning_threshold/`):

    python LIRA_smallscale.py --dataset sift --data_path <dir> \
        --n_bkt 64 --k 10 --duplicate_type model --redundancy_ratio 0.03

then pass that CSV here via --reference_csv.

Usage (port of lira_tpu/pipelines/parity.py, over the port's small-scale
pipeline; `--device cpu` runs it on the CPU):
    python -m lira_tpu_torch parity --dataset sift --data_path /data/vector_datasets \
        --k 10 --n_bkt 64 [--reference_csv model_1.csv] [--recall_tol 0.02]
"""

from __future__ import annotations

import argparse
import csv
import os


from ..config import Config
from ..logging_utils import ascii_table, fprint


def load_reference_csv(path: str) -> list[dict]:
    """Reference sweep schema: threshold,nprobe,Recall,Computations,QPS."""
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append(
                {
                    "threshold": float(row["threshold"]),
                    "nprobe": float(row["nprobe"]),
                    "recall": float(row["Recall"]),
                    "computations": float(row["Computations"]),
                    "qps": float(row.get("QPS", 0.0)),
                }
            )
    return rows


def diff_curves(ours: list, ref_rows: list[dict], recall_tol: float, ndis_rtol: float):
    """Join on threshold; per-row deltas + overall verdict."""
    ref_by_thr = {round(r["threshold"], 6): r for r in ref_rows}
    joined = []
    for row in ours:
        r = ref_by_thr.get(round(row.threshold, 6))
        if r is None:
            continue
        joined.append(
            {
                "threshold": row.threshold,
                "recall_ours": row.recall,
                "recall_ref": r["recall"],
                "d_recall": row.recall - r["recall"],
                "nprobe_ours": row.nprobe,
                "nprobe_ref": r["nprobe"],
                "ndis_ours": row.computations,
                "ndis_ref": r["computations"],
                "ndis_rel": (row.computations / r["computations"] - 1.0)
                if r["computations"]
                else 0.0,
            }
        )
    ok = bool(joined) and all(
        abs(j["d_recall"]) <= recall_tol and abs(j["ndis_rel"]) <= ndis_rtol for j in joined
    )
    return joined, ok


def run_parity(cfg: Config, reference_csv: str | None, recall_tol: float,
               ndis_rtol: float, bundle=None, log_file=None, device=None) -> dict:
    from .smallscale import run_smallscale

    fw = log_file
    res = run_smallscale(cfg, bundle=bundle, log_file=fw, serve_sweep=True, device=device)
    sweep = res["sweep_parts"][-1]  # final (post-redundancy) analytic curve
    serve = res["serve_rows"]

    headers = ["threshold", "Recall", "nprobe", "Computations", "measured QPS"]
    fprint("== lira_tpu_torch sweep (final layout) ==", fw)
    fprint(
        ascii_table(
            headers,
            [[r.threshold, r.recall, r.nprobe, r.computations, r.qps] for r in sweep],
        ),
        fw,
    )

    out = {"sweep": sweep, "serve_rows": serve, "parity_ok": None, "joined": None}
    if reference_csv:
        ref_rows = load_reference_csv(reference_csv)
        joined, ok = diff_curves(sweep, ref_rows, recall_tol, ndis_rtol)
        out["parity_ok"], out["joined"] = ok, joined
        if not joined:
            fprint("!! no overlapping thresholds between ours and the reference CSV", fw)
        else:
            fprint("== parity vs reference CSV ==", fw)
            fprint(
                ascii_table(
                    ["threshold", "recall Δ", "ndis rel Δ", "nprobe ours", "nprobe ref"],
                    [
                        [j["threshold"], j["d_recall"], j["ndis_rel"],
                         j["nprobe_ours"], j["nprobe_ref"]]
                        for j in joined
                    ],
                ),
                fw,
            )
            fprint(
                f"parity {'OK' if ok else 'FAIL'}: max |recall Δ| = "
                f"{max(abs(j['d_recall']) for j in joined):.4f} (tol {recall_tol}), "
                f"max |ndis rel Δ| = {max(abs(j['ndis_rel']) for j in joined):.4f} "
                f"(tol {ndis_rtol})",
                fw,
            )
    else:
        fprint(
            "No --reference_csv given.  To produce it, run the reference "
            "implementation on a faiss/torch machine:\n"
            f"  python LIRA_smallscale.py --dataset {cfg.dataset} --data_path <dir> "
            f"--n_bkt {cfg.n_bkt} --k {cfg.k} --duplicate_type model "
            f"--redundancy_ratio {cfg.redundancy_ratio}\n"
            "and pass logs/<dataset>/ML_kmeans_RE_FLAT/<file_name>_tuning_threshold/"
            "model_1.csv here.",
            fw,
        )
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_path", default="/data/vector_datasets")
    p.add_argument("--k", type=int, required=True)
    p.add_argument("--n_bkt", type=int, required=True)
    p.add_argument("--n_epoch", type=int, default=10)
    p.add_argument("--reference_csv", default=None)
    p.add_argument("--recall_tol", type=float, default=0.02)
    p.add_argument("--ndis_rtol", type=float, default=0.05)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    a = p.parse_args(argv)

    cfg = Config(dataset=a.dataset, data_path=a.data_path, k=a.k, n_bkt=a.n_bkt,
                 n_epoch=a.n_epoch).update()
    os.makedirs(cfg.pth_log, exist_ok=True)
    with open(os.path.join(cfg.pth_log, "parity_" + cfg.log_name), "a", encoding="utf-8") as fw:
        out = run_parity(cfg, a.reference_csv, a.recall_tol, a.ndis_rtol, log_file=fw,
                         device=a.device)
    if out["parity_ok"] is False:
        raise SystemExit(2)


if __name__ == "__main__":
    main()
