"""The readings a cell's check limits are set from: many seeds' windows on
one build, the control, and control builds, in one process.

    python3 annbench/readings.py --workload <cell> --seeds 11,12,13 --seconds 3 \
        --control-seeds 11,12,13 --build-epochs 0,1

Sets the cell up once, as a run does (the dataset is the configuration's,
so every seed's run builds this index).  For each seed it draws the
traffic that a run with that seed serves, serves a window of `--seconds`
at the cell's own load, and prints the check's numbers as one JSON line.
For the control seeds it also prints the control's: the reference in TF32
put in the program's place.  Then for each of `--build-epochs` it builds
the index again with that many epochs of training (a build fault; 0
leaves the probing MLP untrained) and prints, for the control seeds,
the recall_miss that the reference, put in the program's place on that
index, reads on the recall positions that seed's window served.  The last
line sums up: each number's largest program reading and smallest control
reading.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell: str, seeds: list[int], seconds: float, control_seeds: list[int],
             build_epochs: list[int], *, registry, device, t_process: float, emit=print) -> list:
    import torch

    from annbench.core import check
    from annbench.core.runner import (_free, build_index, check_window, draw_traffic, set_up,
                                      window)

    dev = torch.device(device)
    lines = []

    def out(rec):
        lines.append(rec)
        emit(json.dumps(rec))

    run = set_up(cell, seeds[0], seconds, t_process=t_process, dev=dev, reg=registry,
                 keep_generator=True)
    limits = run.cell["check"]["limits"]
    ref = check.Reference(run.raw, run.x_d, dev)
    served = {}
    for s in seeds:
        run.gen.reseed(s)
        draw_traffic(run, seconds)
        calls, _, _ = window(run, seconds, False)
        res = check_window(run, ref, calls, s, control=s in control_seeds)
        pos, knn = res["recall_knn"]
        served[s] = (run.pool[pos], knn)
        out({"kind": "program", "seed": s, "served": res["served"], "recall_positions": len(pos),
             "numbers": res["numbers"], "correct": check.verdict(res["numbers"], limits)})
        if "control" in res:
            out({"kind": "control", "seed": s, "numbers": res["control"],
                 "correct": check.verdict(res["control"], limits)})
    run.engine = run.built = None
    del ref
    _free(dev)

    for ep in build_epochs:
        build_index(run, registry, epochs=ep)
        ref = check.Reference(run.raw, run.x_d, dev)
        for s in control_seeds:
            q, knn = served[s]
            ans = ref.answer(q, run.threshold, run.probe_cap, run.k, "f32")
            miss = check.recall_miss(check.recall(ans["ids"], knn, run.k))
            out({"kind": f"build_epochs_{ep}", "seed": s, "threshold": run.threshold,
                 "nprobe_mean": float(ans["nprobe"].mean()), "assign_gap": ref.assign_gap(),
                 "numbers": {"recall_miss": miss}})
        del ref
        _free(dev)

    summary = {"kind": "summary", "limits": limits, "program_max": {}, "control_min": {}}
    for rec in lines:
        side = "program_max" if rec["kind"] == "program" else "control_min"
        for name, v in rec["numbers"].items():
            best = summary[side].get(name)
            keep = max if side == "program_max" else min
            summary[side][name] = v if best is None else keep(best, v)
    out(summary)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", default="", help="comma-separated, among --seeds")
    ap.add_argument("--build-epochs", default="", help="comma-separated epoch counts")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    ctl = [int(s) for s in a.control_seeds.split(",") if s]
    if not set(ctl) <= set(seeds):
        ap.error("--control-seeds must be among --seeds")
    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    from annbench.core.loader import Registry

    readings(a.workload, seeds, a.seconds, ctl, [int(e) for e in a.build_epochs.split(",") if e],
             registry=Registry(), device=a.device, t_process=T_PROCESS,
             emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
