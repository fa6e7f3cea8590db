"""The benchmark of `lira_tpu_torch` on NVIDIA H100s: one run of one cell.

    python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device (and
with --trace 1 a breakdown), and last the numbers the check compared, each
with its limit; the same numbers close standard error.  Exits non-zero,
printing no result, without enough CUDA devices, or when a module of JAX
or of the JAX package is loaded once the window has closed.

`--control 1` also runs the check's control (the reference in TF32 in the
program's place) and adds its numbers under "control"; the benchmark's own
runs leave it off.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if a.seed < 0:
        ap.error("--seed must be non-negative")

    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from annbench.core.loader import Registry
    from annbench.core.runner import forbidden_modules, run_cell

    reg = Registry()
    chips = next((w["chips"] for w in reg.benchmark()["workloads"] if w["name"] == a.workload),
                 None)
    if chips is None:
        print(f"annbench: no cell {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"annbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_process=T_PROCESS,
                      registry=reg, control=bool(a.control))
    bad = forbidden_modules()
    if bad:
        print(f"annbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    if "control" in result:
        print("control " + json.dumps(result.pop("control")), file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
