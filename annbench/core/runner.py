"""One run of one cell: set-up, the measured window, the check, the result.

  set-up   the dataset (the corpus and its own queries, fixed by the
           configuration) and the traffic (from the seed) drawn on the
           device; the index built by the port's own pipeline; the engine;
           the threshold; one warm-up call of the cell's own shape.  The
           reference's part in it (the build queries' exact kNN, where the
           builder needs ground truth, and the probe outputs a quantile
           threshold is read from) is timed apart and left out of setup_s.
  window   the traffic driver's calls, timed on the host; with --trace 1
           the traffic driver's traced calls under torch.profiler.
  check    after the window, the peak memory read and the engine freed:
           the reference's exact kNN of the recall sample's served
           positions, and its judgement of the index and of a sample of
           the window's answers drawn from the seed (`check.py`).

The metrics are computed by readers found by name (`e2e_metrics/`,
`layer_metrics/`) from one context, `Ctx`.  `set_up`, `draw_traffic`,
`window` and `check_window` are the stages; `annbench/readings.py` runs
them for many seeds on one build.
"""

from __future__ import annotations

import copy
import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from annbench.core import check
from annbench.core.loader import Registry
from annbench.core.trace import Profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "lira_tpu")


def log(msg: str) -> None:
    print(f"[annbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Modules in sys.modules whose top-level name is one of FORBIDDEN,
    compared whole (`lira_tpu_torch` is not `lira_tpu`)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclass
class Ctx:
    """What the metric readers read."""
    cell: dict
    config: dict
    n: int
    d: int
    k: int
    setup_s: float
    calls: list = field(default_factory=list)
    peak_bytes: int = 0
    recall: float | None = None
    spans: dict = field(default_factory=dict)
    trace: object = None
    traced: dict | None = None  # {"queries", "pairs", "distinct_rows"} of the traced calls
    scan_dtype: str = "float32"

    @property
    def window_s(self) -> float:
        return self.calls[-1].end - self.calls[0].start if self.calls else 0.0

    @property
    def queries(self) -> int:
        return sum(c.hi - c.lo for c in self.calls)


@dataclass
class Run:
    """One cell set up on one device: its parts, inputs, index and engine."""
    cell: dict
    cfg: dict
    driver: object
    dev: torch.device
    gen: object
    x_d: np.ndarray
    q_tune: np.ndarray
    q_build: np.ndarray
    gt_build: np.ndarray | None
    built: dict | None = None
    raw: dict | None = None
    threshold: float = 0.0
    engine: object = None
    pool: np.ndarray | None = None
    recall_pos: np.ndarray | None = None
    setup_s: float = 0.0
    ref_s: float = 0.0  # the reference's seconds inside set-up

    @property
    def k(self) -> int:
        return int(self.cfg["k"])

    @property
    def tp(self) -> dict:
        return self.cell["traffic"]

    @property
    def probe_cap(self):
        return self.cfg["serve"].get("probe_cap")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def draw_traffic(run: Run, seconds: float) -> np.ndarray:
    """Draws the warm-up queries and the window's pool from the generator's
    traffic stream; sets run.pool and run.recall_pos; returns the warm-up
    queries."""
    plan = run.driver.plan(run.tp, seconds)
    d = run.x_d.shape[1]
    q_warm = run.gen.queries(plan["warmup"]).cpu().numpy()
    pool = np.empty((plan["pool"], d), np.float32)
    for s in range(0, len(pool), 1 << 20):
        pool[s : s + (1 << 20)] = run.gen.queries(min(1 << 20, len(pool) - s)).cpu().numpy()
    run.pool = pool
    run.recall_pos = np.unique(np.linspace(0, len(pool) - 1, int(run.tp["recall_sample"]))
                               .astype(np.int64))
    return q_warm


def build_index(run: Run, reg: Registry, epochs: int | None = None) -> None:
    """Builds the index by the configuration's builder (with `epochs` in
    place of the configuration's, for a control build), and sets run.built,
    run.raw and run.threshold.  The quantile threshold's probe outputs are
    the reference's, timed into run.ref_s."""
    spec = run.cfg["index"]
    if epochs is not None:
        spec = copy.deepcopy(spec)
        spec["config"]["n_epoch"] = int(epochs)
    run.built = reg.builder(spec["builder"]).build(run.x_d, run.q_build, run.gt_build, spec,
                                                   run.cfg["data"]["metric"], run.dev)
    _sync(run.dev)
    run.raw = check.raw_index(run.built)
    thr_spec = run.cfg["serve"]["threshold"]
    if "value" in thr_spec:
        run.threshold = float(thr_spec["value"])
    else:  # the (1 - buckets/n_bkt) quantile of the tune queries' reference probe outputs
        t0 = time.perf_counter()
        sc = check.Reference(run.raw, None, run.dev).scores(
            run.q_tune[: int(thr_spec["queries"])], "f64")
        run.threshold = float(np.quantile(sc, 1.0 - float(thr_spec["buckets"]) / sc.shape[1]))
        run.ref_s += time.perf_counter() - t0


def set_up(cell_name: str, seed: int, seconds: float, *, t_process: float, dev: torch.device,
           reg: Registry, keep_generator: bool = False) -> Run:
    """Everything before the window, ending with one warm-up call; sets
    run.setup_s (from t_process, less the reference's seconds).  With
    keep_generator the generator can draw further traffic (`reseed`)."""
    from lira_tpu_torch.engine.serve import QueryEngine

    from annbench.reference import ann

    cell = reg.workload(cell_name)
    cfg = reg.config(cell["config"])
    data, idx_spec = cfg["data"], cfg["index"]
    gen = reg.generator(data["generator"]).make(data, seed, dev)
    x = gen.corpus(int(data["n_base"]))
    q_tune = gen.dataset_queries(int(cfg["serve"].get("tune_queries", 0)))
    q_build = gen.dataset_queries(int(idx_spec.get("build_queries", 0)))
    ref_s, gt_build = 0.0, None
    if idx_spec.get("build_groundtruth"):
        t0 = time.perf_counter()
        gt_build = ann.exact_knn(q_build, x, int(cfg["k"])).astype(np.int32)
        ref_s = time.perf_counter() - t0
    run = Run(cell=cell, cfg=cfg, driver=reg.traffic(cell["traffic"]["driver"]), dev=dev,
              gen=gen, x_d=x.cpu().numpy(), q_tune=q_tune.cpu().numpy(),
              q_build=q_build.cpu().numpy(), gt_build=gt_build, ref_s=ref_s)
    del x, q_tune, q_build
    q_warm = draw_traffic(run, seconds)
    if not keep_generator:
        gen.release()
    _free(dev)
    log(f"inputs: corpus {run.x_d.shape}, pool {run.pool.shape}: "
        f"{time.perf_counter() - t_process:.1f}s")

    build_index(run, reg)
    log(f"index built ({run.built['spans']}): {time.perf_counter() - t_process:.1f}s")
    eng_spec = cell["engine"]
    run.engine = QueryEngine(run.x_d, run.built["layout"], run.built["centroids"],
                             run.built["scaler"], run.built["mlp"], metric=data["metric"],
                             n_mul=run.built["n_mul"], scan_impl=eng_spec["scan_impl"],
                             scan_dtype=eng_spec["scan_dtype"],
                             store_f32=eng_spec.get("store_f32", True),
                             probe_cap=run.probe_cap, device=dev)
    run.driver.call(run.engine, q_warm, run.threshold, run.k, run.tp)
    _sync(dev)
    run.setup_s = time.perf_counter() - t_process - run.ref_s
    log(f"threshold {run.threshold:.6g}; set-up {run.setup_s:.1f}s "
        f"(the reference's {run.ref_s:.1f}s left out)")
    return run


def window(run: Run, seconds: float, trace: bool) -> tuple[list, object, int]:
    """The measured window: (calls, trace or None, peak device bytes)."""
    if run.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.dev)
    tracer = Profiler(run.dev) if trace else None
    calls, tr = run.driver.run(run.engine, run.pool, run.threshold, run.k, run.tp, seconds,
                               tracer)
    peak = torch.cuda.max_memory_allocated(run.dev) if run.dev.type == "cuda" else 0
    return calls, tr, int(peak)


def check_window(run: Run, ref: check.Reference, calls: list, seed: int,
                 control: bool = False) -> dict:
    """The check of a window's answers and of the index: {"numbers",
    "recall", "served", "recall_knn"} and, with `control`, "control": the
    numbers of the reference in TF32 in the program's place."""
    k, cell = run.k, run.cell
    served = sum(c.hi - c.lo for c in calls)
    ids = np.concatenate([c.ids for c in calls])
    pos = run.recall_pos[run.recall_pos < served]
    knn = ref.exact_knn(run.pool[pos], k)
    rec = check.recall(ids[pos], knn, k)
    rng = np.random.default_rng(seed)
    sample = np.sort(rng.choice(served, min(int(cell["check"]["sample"]), served), replace=False))
    q_s = run.pool[sample]
    want = ref.answer(q_s, run.threshold, run.probe_cap, k, "f64")
    got = {"ids": ids[sample], "nprobe": np.concatenate([c.nprobe for c in calls])[sample],
           "ndis": np.concatenate([c.ndis for c in calls])[sample]}
    numbers = check.judge(ref, q_s, want, got, k)
    numbers["assign_gap"] = ref.assign_gap()
    numbers["recall_miss"] = check.recall_miss(rec)
    out = {"numbers": numbers, "recall": rec, "served": served, "recall_knn": (pos, knn)}
    if control:
        alt = ref.answer(q_s, run.threshold, run.probe_cap, k, "tf32")
        ctl = check.judge(ref, q_s, want, alt, k)
        ctl["assign_gap"] = ref.assign_gap(ref.nearest("tf32"))
        ctl["recall_miss"] = check.recall_miss(check.recall(alt["ids"], ref.exact_knn(q_s, k), k))
        out["control"] = ctl
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, t_process: float,
             device="cuda", registry: Registry | None = None, control: bool = False) -> dict:
    """Runs the cell and returns the result line's object (with a "control"
    key when `control`)."""
    reg = registry or Registry()
    dev = torch.device(device)
    run = set_up(cell_name, seed, seconds, t_process=t_process, dev=dev, reg=reg)
    cell, cfg = run.cell, run.cfg
    e2e, layer = reg.metrics_for(cell_name)
    n, d = run.x_d.shape

    calls, tr, peak = window(run, seconds, trace)
    ctx = Ctx(cell=cell, config=cfg, n=n, d=d, k=run.k, setup_s=run.setup_s, calls=calls,
              peak_bytes=peak, spans=run.built["spans"], trace=tr,
              scan_dtype=cell["engine"]["scan_dtype"])
    log(f"window: {len(calls)} calls, {ctx.queries} queries in {ctx.window_s:.3f}s")
    run.engine = run.built = None
    _free(dev)

    # ---- the check, by the reference on the device
    t0 = time.perf_counter()
    ref = check.Reference(run.raw, run.x_d, dev)
    res = check_window(run, ref, calls, seed, control)
    numbers, ctx.recall = res["numbers"], res["recall"]
    limits = cell["check"]["limits"]
    correct = check.verdict(numbers, limits)
    log(f"check of {min(int(cell['check']['sample']), res['served'])} answers, "
        f"{len(res['recall_knn'][0])} recall positions and the index: "
        f"{time.perf_counter() - t0:.1f}s")

    if tr is not None:  # the needed work of the traced calls, from the reference's probe
        tp = run.tp
        tc = calls[tp["trace_from"] : tp["trace_from"] + tp["trace_calls"]]
        pairs = rows = 0
        for c in tc:
            probed = ref.probe(run.pool[c.lo : c.hi], run.threshold, run.probe_cap, "f64")
            pairs += int((probed.astype(np.int64) @ ref.buckets.sizes).sum())
            rows += ref.distinct_rows(probed)
        ctx.traced = {"queries": sum(c.hi - c.lo for c in tc), "pairs": pairs,
                      "distinct_rows": rows}
    del ref
    _free(dev)

    listed, reader = (layer, reg.layer_metric) if trace else (e2e, reg.e2e_metric)
    metrics = {}
    for m in listed:
        v = reader(m["name"]).read(ctx)
        if v is not None:  # a reader that finds nothing to read leaves its metric out
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    failed = int(sum(int((c.ids < 0).any(axis=1).sum()) for c in calls))
    result = {"correct": bool(correct), "attempted": res["served"], "failed": failed,
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    if "control" in res:
        result["control"] = res["control"]
    result["check"] = {name: {"value": numbers[name], "limit": limits[name]}
                       for name in check.NUMBERS}
    return result
