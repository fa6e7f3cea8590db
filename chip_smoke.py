"""Smoke run of lira_tpu_torch on one NVIDIA H100: builds every CUDA kernel
of the serving path from csrc/, holds each against its plain PyTorch
version, drives the blocked serving path at full size, and checks its
answers.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the device: name, count, `nvidia-smi` name and power limit;
  2. the kernel build (nvcc, sm_90a) and what `-Xptxas -v` reports;
  3. K1 against its plain version on the card: every dtype × metric ×
     sel_rows at qb=1024, d=128, U=64 with a partly dead union, timed;
  4. the main path: a 1M×128 hard-regime corpus, K-Means to 1024 buckets,
     a seeded untrained probing MLP, and QueryEngine(scan_impl="blocked",
     probe_cap=128, block_q=1024) in int8, bfloat16 and float32 — margin
     calibration, one 65536-query `search`, a 4-batch `search_stream`;
     recall@10 against exact ground truth (4096 queries, f32 on the card),
     exact neighbour sets on 64 sampled queries against a numpy oracle over
     the probed buckets, and stream == per-batch search;
     and a torch.profiler breakdown of one warm `search` per dtype;
  5. a `{"kernels": [...]}` line (K1 at the main path's shapes: time, plain
     time, bound, library yardstick, launches in the main path's run).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, dense): FP32 without tensor
# cores (TF32 is off on every f32 path), bf16 and int8 tensor cores, HBM3
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12}
PEAK_BYTES = 3.35e12
K1_SOURCE = "lira_tpu_torch/csrc/union_groupmin.cu"
K1_REPLACES = "lira_tpu/engine/block_scan.py:145"
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}
EPS32 = float(np.finfo(np.float32).eps)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Mean ms per call on the card (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k1_measure(q, corpus, supers, ulen, *, qb, metric, sel_rows, t_eff=None, s2=None,
               reps=5):
    """Kernel vs plain version on one input: the kernel's output, the plain
    one's, and the timing/bound record (library_ms: the dominant product
    alone, torch.matmul or torch._int_mm, over the live slots)."""
    from lira_tpu_torch.engine.screen import SUPER_ROWS, union_groupmin, union_groupmin_ref

    kw = dict(qb=qb, metric=metric, sel_rows=sel_rows, t_eff=t_eff, s2=s2)
    out = union_groupmin(q, corpus, supers, ulen, **kw)
    ref = union_groupmin_ref(q, corpus, supers, ulen, **kw)
    torch.cuda.synchronize()
    ms = time_ms(lambda: union_groupmin(q, corpus, supers, ulen, **kw), reps)
    plain_ms = time_ms(lambda: union_groupmin_ref(q, corpus, supers, ulen, **kw), 2)

    rows, U = supers.shape
    d = corpus.shape[1]
    live = int(ulen.clamp(max=U).sum())
    elt = corpus.element_size()
    ops = 2.0 * live * SUPER_ROWS * qb * d
    nbytes = q.numel() * elt + live * SUPER_ROWS * d * elt + out.numel() * 4
    t_ops, t_bytes = ops / PEAK_OPS[corpus.dtype], nbytes / PEAK_BYTES
    # the same products one block row at a time (its live rows × its own
    # queries), timed per block and summed: the whole call's operation
    # count, with one block's product live at once
    mm = torch._int_mm if corpus.dtype == torch.int8 else torch.matmul
    sup_view = corpus.view(-1, SUPER_ROWS, d)
    library_ms = 0.0
    for i in range(rows):
        n_live = min(int(ulen[i]), U)
        if n_live == 0:
            continue
        x_i = sup_view[supers[i, :n_live].long()].reshape(-1, d)
        q_i = q[i * qb : (i + 1) * qb]
        library_ms += time_ms(lambda x=x_i, y=q_i: mm(x, y.T), reps)
        del x_i
    rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=library_ms, live_slots=live)
    return out, ref, rec


def k1_tolerance(q, corpus, metric, t_eff=None, s2=None) -> float:
    """Bound on |kernel − plain|: both sum the same exact products in f32 in
    different orders, so each dot differs by at most ~d·eps·Σ|x_d q_d| ≤
    d·eps·‖x‖‖q‖, and each norm by d·eps·‖x‖².  int8 dots are exact
    integers (only the L2 norm term Σ s²x8² is summed in f32)."""
    d = corpus.shape[1]
    xf = corpus.float()
    if corpus.dtype == torch.int8:
        if metric == "inner_product":
            return 0.0
        return 2.0 * d * EPS32 * float(((xf * xf) @ s2).max())
    xn = float((xf * xf).sum(1).max())
    qn = float((q.float() ** 2).sum(1).max())
    return 2.0 * d * EPS32 * (xn + 2.0 * (xn * qn) ** 0.5)


def phase_k1_grid(dev) -> None:
    """Every dtype × metric × sel_rows at the bench's qb and d, U=64, with
    one block row's union cut short (dead slots)."""
    from lira_tpu_torch.engine.block_scan import screen_queries

    qb, d, U, rows, n_super = 1024, 128, 64, 2, 96
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn(n_super * 1024, d, generator=g).to(dev)
    qf = torch.randn(rows * qb, d, generator=g).to(dev)
    supers = torch.randint(0, n_super, (rows, U), generator=g, dtype=torch.int32).to(dev)
    ulen = torch.tensor([U, 37], dtype=torch.int32, device=dev)
    dim_scale = torch.clamp_min(x.abs().amax(0), 1e-30) / 127.0
    x8 = torch.clamp(torch.round(x / dim_scale), -127, 127).to(torch.int8)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for metric in ("L2", "inner_product"):
            for sel_rows in (32, 64, 128):
                q, t_eff, s2 = screen_queries(qf, dtype, dim_scale, metric)
                corpus = x8 if dtype == torch.int8 else x.to(dtype)
                out, ref, rec = k1_measure(q, corpus, supers, ulen, qb=qb, metric=metric,
                                           sel_rows=sel_rows, t_eff=t_eff, s2=s2)
                SG = 1024 // sel_rows
                dead = out[1, 37 * SG:]
                if not bool((dead == torch.tensor(3e38, dtype=torch.float32)).all()):
                    raise AssertionError(f"K1 {dtype} {metric} {sel_rows}: dead slots not 3e38")
                err = float((out - ref).abs().max())
                tol = k1_tolerance(q, corpus, metric, t_eff, s2)
                ok = err <= tol
                log(f"K1 {DTYPE_NAME[dtype]:8s} {metric:13s} sel_rows={sel_rows:3d}: "
                    f"max|kernel-plain|={err:.3g} (tol {tol:.3g}) "
                    f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
                    f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                    f"library {rec['library_ms']:.3f} ms, {rec['live_slots']} live slots")
                if not ok:
                    raise AssertionError(f"K1 {dtype} {metric} {sel_rows}: {err} > {tol}")


def profile_search(eng, x_q, thr, k, tag) -> None:
    """Where one warm `search` spends the card's time: torch.profiler's
    device events, summed by kernel name, and the device-busy share of the
    wall time (the union of kernel intervals over the host clock; both
    include the profiler's own overhead).  Reports only; prints "not
    measured" when the profiler records no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.search(x_q, thr, k)
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > 0]
    if not evs:
        log(f"profile[{tag}]: no device events recorded; breakdown not measured")
        return
    busy, end = 0.0, -1.0
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name: dict = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    log(f"profile[{tag}]: wall {1e3 * wall:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / 1e6 / wall:.1f}% of wall, idle {100 - 100 * busy / 1e6 / wall:.1f}%)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile[{tag}]:   {us / 1e3:8.2f} ms  {name[:90]}")


def exact_gt(x_d_dev, q_dev, k):
    """Exact L2 top-k ids on the card in f32 (TF32 off)."""
    xsq = (x_d_dev * x_d_dev).sum(1)
    out = []
    for s in range(0, len(q_dev), 512):
        sc = xsq[None, :] - 2.0 * (q_dev[s : s + 512] @ x_d_dev.T)
        out.append(torch.topk(sc, k, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy()


def k1_main_path_inputs(eng, x_q, thr):
    """K1's inputs exactly as the engine's screen gets them for this
    65536-query batch (probe, unions, block order, screen dtype)."""
    from lira_tpu_torch.engine import block_scan as bs

    st = eng._block_state
    h = bs._probe_batch(st, eng, x_q, thr, eng.block_q)
    union = h["union"].cpu().numpy()
    supers, _, ulen = bs.build_block_unions(union, eng.tile_start, eng.tiles_per_bucket,
                                            st.tile_bucket)
    q, t_eff, s2 = bs.screen_queries(h["q"][h["perm"]], st.corpus_flat.dtype,
                                     st.dim_scale, eng.metric)
    dev = st.device
    return (q.contiguous(), st.corpus_flat, torch.as_tensor(supers, device=dev),
            torch.as_tensor(ulen, device=dev), h["qb"], t_eff, s2)


def phase_main_path(dev, n=1_000_000, d=128, n_bkt=1024, batch=65536, n_gt=4096):
    from lira_tpu_torch.engine.calibrate import calibrate_block_margin
    from lira_tpu_torch.engine.screen import union_groupmin
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.io.datasets import HARD_REGIME, hard_regime_sig, synthetic_dataset
    from lira_tpu_torch.labels.scaler import scaled_centroid_distances
    from lira_tpu_torch.models.probing_mlp import ProbingMLP
    from lira_tpu_torch.partition.assign import build_bucket_layout
    from lira_tpu_torch.partition.kmeans import kmeans_assign, kmeans_fit

    k = 10
    t0 = time.perf_counter()
    ds = synthetic_dataset(**HARD_REGIME, n_base=n, n_query=batch, dim=d, compute_gt=False)
    x_d, x_q = ds.base, ds.query
    log(f"corpus {n}x{d} + {batch} queries ({hard_regime_sig()}): "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    km = kmeans_fit(x_d, n_bkt, niter=20, seed=43, device=dev)
    assign = kmeans_assign(x_d, km.centroids, device=dev)
    layout = build_bucket_layout(assign, n_bkt)
    dist, _, scaler = scaled_centroid_distances(x_d, x_q[:8], km.centroids, device=dev)
    del dist
    torch.cuda.synchronize()
    log(f"index: kmeans objective {km.objective[0]:.4g} -> {km.objective[-1]:.4g}, "
        f"{layout.total} rows in {n_bkt} buckets (sizes {layout.sizes.min()}.."
        f"{layout.sizes.max()}), scaler fitted: {time.perf_counter() - t0:.1f}s")
    mlp = ProbingMLP(n_bkt, d, generator=torch.Generator().manual_seed(43))

    t0 = time.perf_counter()
    gt = exact_gt(torch.as_tensor(x_d, device=dev), torch.as_tensor(x_q[:n_gt], device=dev), k)
    log(f"exact ground truth for {n_gt} queries on the card: {time.perf_counter() - t0:.1f}s")

    kernels = []
    rng = np.random.default_rng(0)
    for scan_dtype in ("int8", "bfloat16", "float32"):
        t0 = time.perf_counter()
        eng = QueryEngine(x_d, layout, km.centroids, scaler, mlp, probe_cap=128,
                          scan_impl="blocked", block_q=1024, scan_dtype=scan_dtype,
                          device=dev)
        thr = float(np.quantile(eng.probe(x_q[:512]), 1.0 - 8 / n_bkt))
        log(f"engine[{scan_dtype}] built, threshold {thr:.6g}: "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        cal = calibrate_block_margin(eng, x_q[:2048], thr, k, ladder=(0, 2, 4, 8))
        eng.block_margin = cal.margin
        log(f"calibrate[{scan_dtype}]: zero-miss at {cal.zero_miss_margin}, margin "
            f"{cal.margin} (miss rates {cal.miss_rates}): {time.perf_counter() - t0:.1f}s")

        big = np.tile(x_q, (4, 1))
        torch.cuda.reset_peak_memory_stats()
        union_groupmin.launches = 0
        r = eng.search(x_q, thr, k)
        r_s = eng.search_stream(big, thr, k, batch_size=batch)
        launches = union_groupmin.launches
        log(f"K1 launches in the main path's run [{scan_dtype}]: {launches}")
        if launches <= 0:
            raise AssertionError("the main path did not launch K1")
        peak = torch.cuda.max_memory_allocated()

        ndis_pct = 100 * r.ndis.mean() / n
        recall = float((r.ids[:n_gt, :, None] == gt[:, None, :]).any(axis=1).mean())
        log(f"serve[{scan_dtype}]: margin={eng.block_margin} nprobe={r.nprobe.mean():.2f} "
            f"ndis={r.ndis.mean():.0f} ({ndis_pct:.3f}% corpus) recall@{k}={recall:.4f} "
            f"(untrained MLP) search {batch / r.elapsed:.0f} QPS ({r.elapsed:.3f}s), "
            f"stream {len(big) / r_s.elapsed:.0f} QPS ({r_s.elapsed:.3f}s), "
            f"peak device memory {peak / 2**30:.2f} GiB")
        if r.ids.shape != (batch, k) or not np.isfinite(r.scores[r.ids >= 0]).all():
            raise AssertionError("search result has the wrong shape or non-finite scores")

        for b in range(4):
            sl = slice(b * batch, (b + 1) * batch)
            for name in ("ids", "scores", "nprobe", "ndis"):
                if not np.array_equal(getattr(r_s, name)[sl], getattr(r, name)):
                    raise AssertionError(f"search_stream batch {b} {name} != search")
        log(f"stream[{scan_dtype}]: 4 batches equal per-batch search")

        n_chk = 256
        probed = eng._select_probed(x_q[:n_chk], thr)
        for i in rng.choice(n_chk, size=64, replace=False):
            members = np.unique(np.concatenate(
                [layout.bucket_members(bb) for bb in np.nonzero(probed[i])[0]]
            ))
            dd = ((x_d[members] - x_q[i]) ** 2).sum(axis=1)
            expect = set(members[np.argsort(dd, kind="stable")][: min(k, len(members))])
            got = set(int(v) for v in r.ids[i] if v >= 0)
            if got != expect:
                raise AssertionError(f"[{scan_dtype}] query {i}: engine != oracle")
        log(f"oracle[{scan_dtype}]: neighbour sets exact on 64 sampled queries")

        profile_search(eng, x_q, thr, k, scan_dtype)
        q, corpus, supers, ulen, qb, t_eff, s2 = k1_main_path_inputs(eng, x_q, thr)
        sel = eng.block_sel_rows
        out, ref, rec = k1_measure(q, corpus, supers, ulen, qb=qb, metric=eng.metric,
                                   sel_rows=sel, t_eff=t_eff, s2=s2, reps=3)
        err = float((out - ref).abs().max())
        tol = k1_tolerance(q, corpus, eng.metric, t_eff, s2)
        log(f"K1 at the main path's shape [{scan_dtype}]: blocks {supers.shape[0]}, "
            f"U {supers.shape[1]}, {rec['live_slots']} live slots, max|kernel-plain|="
            f"{err:.3g} (tol {tol:.3g}), {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
            f"bound {rec['bound_ms']:.3f} ms, library {rec['library_ms']:.3f} ms")
        if err > tol:
            raise AssertionError(f"K1 [{scan_dtype}] main-path inputs: {err} > {tol}")
        kernels.append({
            "name": f"union_groupmin[{scan_dtype},L2,sel_rows={sel}]", "route": "cuda",
            "source": K1_SOURCE, "replaces": K1_REPLACES, "launches": launches,
            "max_abs_err": err, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
        del eng, out, ref, q, corpus
        torch.cuda.empty_cache()
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from lira_tpu_torch import resolve_device, true_fp32
    from lira_tpu_torch.kernels import build

    dev = resolve_device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    info = build(["union_groupmin"])["union_groupmin"]
    log(f"built K1 in {time.perf_counter() - t0:.1f}s -> {info['path']}")
    log(info["ptxas"])

    # the script's own f32 products (the exact ground truth, the library
    # yardstick, the tolerances) in true fp32, as the port's f32 paths are
    with true_fp32():
        phase_k1_grid(dev)
        kernels = phase_main_path(dev)
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
