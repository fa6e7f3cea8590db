"""Smoke run of lira_tpu_torch on one NVIDIA H100: builds every CUDA kernel
of the ported paths from csrc/, holds each against its plain PyTorch
version, trains the probing model at full size, serves with it through
every scan path (blocked, per-query xla and pallas, capacity mode, the IVF
prober), drives the command-line path (index artifacts written and served
back, knn, build, search, largescale), runs the small-scale pipeline, and
checks the answers.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the device: name, count, `nvidia-smi` name and power limit;
  2. the kernel build (nvcc, sm_90a, one process per source, in parallel)
     and what `-Xptxas -v` reports; `cuobjdump -sass` read per function:
     K1's bf16/int8 functions and K2's "default"/int8 ones hold warpgroup
     MMAs (HGMMA, IGMMA, each count > 0), K1's and K2's f32 functions and
     K3's FFMA and no HMMA/HGMMA;
  3. K1 against its plain version on the card: every dtype × metric ×
     sel_rows (1, 8, 16, 32, 64, 128) at qb=1024, d=128, U=64, and every
     dtype × metric at qb=256, d=960, U=16, each with a partly dead union,
     timed (f32 at d=960 beside its library call); then blocked int8 at
     d=37 (the engine's zero-padded table) and at sel_rows 16 beside f32
     on a small index, each exact against the numpy oracle;
  4. K2 against its plain version on the card: f32, bf16 (the tables
     knn_fused passes) and int8 × L2 and IP at Q=8192, d=128 over 64
     groups, one partly padded, timed;
     K3 against its plain version: k in {1, 20, 36, 128} × L2 and IP at
     B=2048, T=64, d=128 (lists with -1 holes, a tile listed twice, a
     partly padded tile, one tile in every query's list), and one small
     case at d=960, timed, with the list inversion timed apart;
     then every kernel on one table built on the card past 2^31 elements
     (17M rows x 128: 8.7 GB f32, and 2^31 bytes in bf16 and int8), the
     rows each comparison reads lying past the mark (`phase_large_tables`):
     K1 in f32, bf16, int8, K2 in "highest", "default", int8 over the
     whole table, K3 in f32, each against its plain version on those rows;
  5. the trained index at full size (bench.py's recipe): a 1M×128
     hard-regime corpus, K-Means to 1024 buckets, the self-kNN (k=10)
     through the fused path and K2 in f32 (123 launches, checked exact on
     1024 sampled rows against a brute-force top-k on the card; the SM
     clock and power sampled while K2 runs), kNN
     labels, scaled distances, and 6 epochs of training at batch 256;
     K2 at the main path's shape against its plain version; K2's
     tensor-core modes ("default" bf16, int8) at the same shape against
     their plain versions, and the 1M self-kNN in each of them at its
     default margin (123 launches each, wall s, the share of the f32
     self-kNN's neighbours missed);
  6. serving with the trained MLP: QueryEngine(scan_impl="blocked",
     probe_cap=128, block_q=1024) in int8, bfloat16 and float32 — margin
     calibration, one 65536-query `search`, a 4-batch `search_stream`;
     recall@10 against exact ground truth (4096 queries, the port's
     `exact_knn` on the card) beside the TPU record, exact neighbour sets on
     64 sampled queries against a numpy oracle over the probed buckets,
     stream == per-batch search, a torch.profiler breakdown of one warm
     `search`, K1 at the main path's inputs against its plain version, and
     the masked group selection there: launched once a block and U-slice
     by the `search` (counted over the search and the stream), bit for bit
     equal to its plain version on 8 blocks of that K1 output at the
     engine's own kg and sel_rows, and on block 0 at the calibration's
     exhaustive kg; then the selection alone (`phase_group_select`) on a
     10M-shaped block (524,288 groups x 1,024 queries) and a 1M-shaped
     one; each timed beside its bytes bound, the plain chain and
     `torch.topk` over the masked minima; the exact rescore launched once a
     block by the `search`, then (`phase_group_rescore`) held against its
     plain version on the first 4 blocks of a `search` of an int8 engine
     and of capacity mode's bf16 and int8 engines, as the engines pass
     them, and on seeded 10M- and GIST-shaped blocks, each timed beside
     its bytes bounds, the plain chain and the gather + `torch.bmm`;
     then on the same trained index and threshold:
     - the per-query engines, scan_impl "pallas" (K3) and "xla", in f32
       and bf16 on the full 65536-query batch: nprobe/ndis equal to the
       blocked f32 engine's, neighbour sets equal to its up to ties,
       recall beside it, the oracle, stream (2 batches) == search, 32
       launches per batch of each of K3's three kernels (inversion, scan,
       merge); K3 alone at the main path's inputs (one 2048-query block and all 32)
       against its plain version and a gather + bmm yardstick, the xla
       scan on the same blocks, its inversion and merge kernels against
       their plain versions, and the seconds of `_probe_tiles`; in
       f32 the batch's K3 time must be below its streamed floor (the bytes
       of every query's own tiles at 3.35 TB/s), which only a kernel that
       reads a shared tile once for its queries can reach;
     - capacity mode (store_f32=False) in bf16 and int8: K1 launched,
       nprobe/ndis equal to the store_f32 engine's, recall within 0.01 of
       it, queries whose neighbour sets differ, table bytes, peak memory;
     - the IVF baseline (prober=ivf_probe_matrix, blocked f32) at exactly
       8 buckets a query: recall and ndis beside LIRA's, and the oracle
       over the 8 nearest centroids' buckets;
     - the blocked bf16 engine at sel_rows 1, 8 and 16 (K1's output 32×,
       4× and 2× the default's): nprobe/ndis equal to phase 6's, recall,
       K1 launches, the chunk plan, and the peak device memory of the
       search beyond the engine's tables, held within 2 × _GMIN_BUDGET;
  7. the CLI path on the same index and threshold (a temp directory):
     the index written with `save_index_artifacts` and served back, by an
     engine on `load_index_artifacts` (nprobe/ndis and f32 neighbour sets
     equal to phase 6's) and by `run_search` in f32, bf16, int8 and
     capacity int8 (nprobe, ndis and recall equal to phase 6's), the
     TorchScript export held to the MLP; the corpus written as a dataset
     and `python -m lira_tpu_torch knn` (exact, 123 K2 launches, equal to
     phase 5's self-kNN up to ties); `build --calibrate_margin` from that
     kNN cache (6 epochs at batch 256, n_mul 1) and `search` at its
     measured margins in three dtypes (recall within 0.01 of phase 6's);
      `knn` in IVF mode on a 100k cut (recall against the exact kNN); and
     `largescale` on a 200k cut (a 5% subset, 30 epochs at batch 64) to
     its sweep CSVs: the MLP trained (the last epoch's kNN recall above
     the untrained model's at fewer predicted buckets; part 1's recall at
     the lowest threshold ≥ 0.9), redundancy adding only (part 1's recall
     and computations ≥ part 0's at every threshold), and the final
     assignment of 4096 sampled rows equal to a plain numpy recomputation
     of the redundancy rule from the run's checkpointed MLP, centroids,
     scaler and native assignment;
  8. `run_smallscale` on the card: 200k×128, 2000 queries with exact
     ground truth, 256 buckets, k=10, 3 epochs, model redundancy, the
     serving sweep;
  the sharded path and the native runtime, on the same card:
  - after phase 6's per-query engines, the native host runtime
    (`lira_tpu_torch/native`, g++): loaded (the run fails without it), the
    CSR build and `_probe_tiles` equal to the numpy branches on the 1M
    index, their seconds and the pallas f32 `search` QPS native against
    numpy;
  - before phase 7, the sharded engine on the trained index at phase 6's
    threshold and margins: 2 gloo ranks sharing the card in f32, bf16,
    int8, capacity bf16/int8, and 1 nccl rank in f32 (nprobe/ndis equal to
    phase 6's, f32 sets equal up to exact ties, the bf16/int8 oracle,
    stream == search, K1 launched on every rank; QPS, per-rank peak
    memory); in phase 7, `run_search --n_shards 2 --backend gloo` on its
    artifacts (the f32 row equal to `--n_shards 1`'s);
  - last, `python -m lira_tpu_torch distributed --n_shards 2 --backend
    gloo` on the small-scale corpus written as a dataset (the sharded
    self-kNN against knn_fused on 1024 rows, the sharded assignment against
    kmeans_assign, the sweep CSV, K2 and K1 launched on each rank);
  - last, the JAX package's own 10M scale (`phase_largescale_10m`,
    scripts/torch_10m_demo.py's stages): the 10M x 128 hard-regime corpus,
    2048 buckets, exact GT of 2048 queries, `run_largescale` (1% subset,
    K2's self-kNN, 40 epochs, full-corpus assignment and redundancy, both
    analytic sweeps: the MLP learned, part 1 >= part 0, the redundancy of
    4096 rows equal to the plain rule), the layout's rows and f32 elements
    against 2^31, then the blocked engine in f32 over the demo's sweep
    (recall non-increasing in the threshold, >= 0.95 at some threshold
    within 2.5% ndis) and a 65536-query batch + stream at thr 0.1, then
    bf16 and int8 at thr 0.1 on half the batch (margins calibrated): the
    64-query oracle and stream == per-batch search in every dtype, K1
    launched in each, peak memory;
  9. a `{"kernels": [...]}` line (K1 ×3 dtypes, K2 ×3 modes, K3 — one launch and a
     whole batch — and K3's list inversion and merge kernels, at the main
     path's shapes: time, plain time, bound, library yardstick, launches
     in the main path's run (for K2 "default" and int8: their self-kNN),
     for K1 and K2 `cli_launches`, their launches
     in phase 7 in the record's own dtype; K1's `sharded_launches` per rank
     (f32 also `sharded_nccl_launches` and the distributed pipeline's
     `distributed_launches`) and K2 f32's `sharded_knn_launches` per rank
     in the distributed pipeline, `largescale_10m_launches` (K1 by
     dtype in the 10M phase's serving, K2 f32 in its self-kNN), and for
     K3 the xla scan's time,
     the streamed floor and the list inversion's time on the same inputs).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, dense): FP32 without tensor
# cores (TF32 is off on every f32 path), bf16 and int8 tensor cores, HBM3
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12}
PEAK_BYTES = 3.35e12
K1_SOURCE = "lira_tpu_torch/csrc/union_groupmin.cu"
K1_REPLACES = "lira_tpu/engine/block_scan.py:145"
K2_SOURCE = "lira_tpu_torch/csrc/groupmin.cu"
K2_REPLACES = "lira_tpu/ops/knn_pallas.py:39"
K3_SOURCE = "lira_tpu_torch/csrc/probed_scan.cu"
K3_REPLACES = "lira_tpu/engine/pallas_scan.py:33"
# K3's other two launches: the tile lists that lira_tpu's kernel takes by
# scalar prefetch, turned tile-major, and the final top-k it takes in XLA
K3_INVERT_REPLACES = "lira_tpu/engine/pallas_scan.py:209"
K3_MERGE_REPLACES = "lira_tpu/engine/pallas_scan.py:247"
# the masked group selection replaces no Pallas kernel: the JAX package
# selects in XLA (select_slice's masked add and lax.top_k)
GS_SOURCE = "lira_tpu_torch/csrc/group_select.cu"
GS_REPLACES = "none: XLA in lira_tpu/engine/block_scan.py:443"
# the exact rescore replaces none either: the JAX package rescores in XLA
# (rescore_block's gather, einsum and lax.top_k)
GR_SOURCE = "lira_tpu_torch/csrc/group_rescore.cu"
GR_REPLACES = "none: XLA in lira_tpu/engine/block_scan.py:457"
# the TPU record (BENCH_r05.json; only its hardware-independent columns)
TPU_RECALL, TPU_NDIS = 0.8370, 7755
MIN_INT8_RECALL = 0.75  # the trained MLP's floor at the bench's operating point
# the 10M recipe's gate (recall@10 at some swept threshold within an ndis
# share) and the JAX record at thr 0.1 (logs/tpu_10m_hard_run6.log; quality
# columns only)
MIN_10M_RECALL, MAX_10M_NDIS = 0.95, 0.025
TPU_10M_RECALL, TPU_10M_NDIS = 0.9639, 0.0151
CAPACITY_RECALL_DROP = 0.01  # capacity mode may lose at most this much recall@10
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}
EPS32 = float(np.finfo(np.float32).eps)


def log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()


def timed(phase, *args, **kw):
    """Runs one phase and logs its seconds and the run's so far."""
    t0 = time.perf_counter()
    out = phase(*args, **kw)
    log(f"[{phase.__name__}: {time.perf_counter() - t0:.1f}s; "
        f"{time.perf_counter() - _START:.1f}s into the run]")
    return out


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
               xsq=None, reps=5):
    """Kernel vs plain version on one input: the kernel's output, the plain
    one's, and the timing/bound record (library_ms: the dominant product
    alone, torch.matmul or torch._int_mm, over the live slots).  `xsq`: the
    table's row norms (L2), as the engine passes them; built here if None."""
    from lira_tpu_torch.engine.screen import (SUPER_ROWS, screen_norms, union_groupmin,
                                              union_groupmin_ref)

    if xsq is None and metric != "inner_product":
        xsq = screen_norms(corpus, s2)
    kw = dict(qb=qb, metric=metric, sel_rows=sel_rows, t_eff=t_eff, s2=s2, xsq=xsq)
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
    nbytes = (q.numel() * elt + live * SUPER_ROWS * (d * elt + (4 if xsq is not None else 0))
              + out.numel() * 4)
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
    """Every dtype × metric × sel_rows (1, 8, 16: groups below a wgmma
    quad's and the FMA tile's lanes; 32, 64, 128) at the bench's qb and d,
    U=64, and every dtype × metric at d=960 (GIST; beyond shared memory
    before d was staged in chunks), each with one block row's union cut
    short (dead slots)."""
    from lira_tpu_torch.engine.block_scan import screen_queries

    cases = [  # qb, d, U, rows, n_super, live slots of block row 1, sel_rows
        (1024, 128, 64, 2, 96, 37, (1, 8, 16, 32, 64, 128)),
        (256, 960, 16, 2, 16, 7, (32,)),
    ]
    for qb, d, U, rows, n_super, live1, sels in cases:
        g = torch.Generator(device="cpu").manual_seed(7)
        x = torch.randn(n_super * 1024, d, generator=g).to(dev)
        qf = torch.randn(rows * qb, d, generator=g).to(dev)
        supers = torch.randint(0, n_super, (rows, U), generator=g, dtype=torch.int32).to(dev)
        ulen = torch.tensor([U, live1], dtype=torch.int32, device=dev)
        dim_scale = torch.clamp_min(x.abs().amax(0), 1e-30) / 127.0
        x8 = torch.clamp(torch.round(x / dim_scale), -127, 127).to(torch.int8)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for metric in ("L2", "inner_product"):
                for sel_rows in sels:
                    q, t_eff, s2 = screen_queries(qf, dtype, dim_scale, metric)
                    corpus = x8 if dtype == torch.int8 else x.to(dtype)
                    out, ref, rec = k1_measure(q, corpus, supers, ulen, qb=qb, metric=metric,
                                               sel_rows=sel_rows, t_eff=t_eff, s2=s2)
                    tag = f"K1 d={d} {DTYPE_NAME[dtype]} {metric} sel_rows={sel_rows}"
                    dead = out[1, live1 * (1024 // sel_rows):]
                    if not bool((dead == torch.tensor(3e38, dtype=torch.float32)).all()):
                        raise AssertionError(f"{tag}: dead slots not 3e38")
                    err = float((out - ref).abs().max())
                    tol = k1_tolerance(q, corpus, metric, t_eff, s2)
                    log(f"K1 d={d:4d} {DTYPE_NAME[dtype]:8s} {metric:13s} sel_rows={sel_rows:3d}: "
                        f"max|kernel-plain|={err:.3g} (tol {tol:.3g}) "
                        f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
                        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                        f"library {rec['library_ms']:.3f} ms, {rec['live_slots']} live slots")
                    if err > tol:
                        raise AssertionError(f"{tag}: {err} > {tol}")
                    if d == 960 and dtype == torch.float32:
                        log(f"K1 d=960 float32 {metric}: kernel {rec['ms']:.3f} ms, library "
                            f"{rec['library_ms']:.3f} ms ({rec['ms'] / rec['library_ms']:.2f}x)")


def phase_k1_engine_any_width(dev, n=50_000, d=37, n_bkt=64, n_q=2048, k=10) -> None:
    """Blocked int8 at d = 37 (the engine zero-pads its int8 table to 40
    columns) and at sel_rows 16, beside the f32 engine on the same small
    index: nprobe/ndis equal, K1 launched, and each engine's neighbour sets
    exact against the numpy oracle over the probed buckets."""
    from lira_tpu_torch.engine.calibrate import calibrate_block_margin
    from lira_tpu_torch.engine.screen import union_groupmin
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.io.datasets import synthetic_dataset
    from lira_tpu_torch.labels.scaler import scaled_centroid_distances
    from lira_tpu_torch.models.probing_mlp import ProbingMLP
    from lira_tpu_torch.partition.assign import build_bucket_layout
    from lira_tpu_torch.partition.kmeans import kmeans_assign, kmeans_fit

    ds = synthetic_dataset(n_base=n, n_query=n_q, dim=d, n_clusters=n_bkt, compute_gt=False,
                           seed=5)
    km = kmeans_fit(ds.base, n_bkt, niter=10, device=dev)
    layout = build_bucket_layout(kmeans_assign(ds.base, km.centroids, device=dev), n_bkt)
    _, _, scaler = scaled_centroid_distances(ds.base, None, km.centroids, device=dev)
    mlp = ProbingMLP(n_bkt, d, generator=torch.Generator().manual_seed(0))
    idx = dict(x_d=ds.base, x_q=ds.query, layout=layout)
    ref = None
    for dtype, sel in (("float32", None), ("int8", None), ("int8", 16)):
        eng = QueryEngine(ds.base, layout, km.centroids, scaler, mlp, probe_cap=16,
                          block_q=1024, scan_dtype=dtype, block_sel_rows=sel, device=dev)
        width = eng._block_state.corpus_flat.shape[1]
        thr = float(np.quantile(eng.probe(ds.query[:512]), 1.0 - 4 / n_bkt))
        cal = calibrate_block_margin(eng, ds.query, thr, k, ladder=(0, 2, 4, 8))
        eng.block_margin = cal.margin
        union_groupmin.launches = 0
        r = eng.search(ds.query, thr, k)
        launches = union_groupmin.launches
        if launches <= 0:
            raise AssertionError(f"d={d} {dtype}: K1 was not launched")
        if ref is None:
            ref = r
        elif not (np.array_equal(r.nprobe, ref.nprobe) and np.array_equal(r.ndis, ref.ndis)):
            raise AssertionError(f"d={d} {dtype} sel_rows={sel}: nprobe/ndis != f32's")
        tag = f"d={d} {dtype} sel_rows={eng.block_sel_rows}"
        check_oracle(eng, r, idx, thr, k, tag, np.random.default_rng(3))
        log(f"engine[{tag}]: screen table width {width}, margin {cal.margin}, K1 launches "
            f"{launches}, nprobe={r.nprobe.mean():.2f} ndis={r.ndis.mean():.0f}")
        del eng
    torch.cuda.empty_cache()


def sass_functions(lib_path) -> dict:
    """`cuobjdump -sass` of a built library, split by function: {mangled
    name: its SASS}."""
    from lira_tpu_torch.kernels import _nvcc

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = chunk.partition("\n")
        funcs[name.strip()] = body
    return funcs


def kernel_sass_check(built) -> None:
    """What the built kernels run on, read per function from their SASS:
    K1's bf16 and int8 screens (`groupmin_wgmma`) must hold warpgroup MMAs,
    HGMMA (bf16) and IGMMA (int8), and so must K2's "default" and int8
    sweeps (`k2_groupmin_bf16`: HGMMA, `k2_groupmin_int8`: IGMMA); K1's and
    K2's f32 functions
    (`k1_groupmin_fma`, `k2_groupmin_fma`), K3's (`tile_scan_kernel`) and
    the rescore's (`rescore_kernel`, every table dtype) must hold FFMA and
    no HMMA or HGMMA — f32 stays on CUDA-core FMAs, never TF32.  Fails
    otherwise."""
    k1 = sass_functions(built["union_groupmin"]["path"])
    wg = "".join(body for name, body in k1.items() if "groupmin_wgmma" in name)
    ops = re.findall(r"\b[A-Z]*GMMA\.[\w.]+", wg)
    counts = {m: sum(1 for o in ops if o.startswith(m + ".")) for m in ("HGMMA", "IGMMA")}
    log(f"K1 SASS warpgroup MMAs: {counts}; forms {sorted(set(ops))}")
    if not all(counts.values()):
        raise AssertionError(f"K1's library lacks warpgroup MMAs: {counts}")
    k2 = sass_functions(built["groupmin"]["path"])
    for func, mma in (("k2_groupmin_bf16", "HGMMA"), ("k2_groupmin_int8", "IGMMA")):
        found = {name: body for name, body in k2.items() if func in name}
        if not found:
            raise AssertionError(f"K2: no {func} function in its library's SASS")
        for name, body in sorted(found.items()):
            n_mma = len(re.findall(rf"\b{mma}\.", body))
            log(f"K2 SASS {name}: {n_mma} {mma}")
            if n_mma == 0:
                raise AssertionError(f"K2 {func}: no {mma} (must run on the tensor cores)")
    k3 = sass_functions(built["probed_scan"]["path"])
    gr = sass_functions(built["group_rescore"]["path"])
    for lib, tag, funcs in ((k1, "K1", "k1_groupmin_fma"), (k2, "K2", "k2_groupmin_fma"),
                            (k3, "K3", "tile_scan_kernel"), (gr, "rescore", "rescore_kernel")):
        found = {name: body for name, body in lib.items() if funcs in name}
        if not found:
            raise AssertionError(f"{tag}: no {funcs} function in its library's SASS")
        for name, body in sorted(found.items()):
            ffma = len(re.findall(r"\bFFMA\b", body))
            mma = len(re.findall(r"\bH(?:G)?MMA\b", body))
            log(f"{tag} f32 SASS {name}: {ffma} FFMA, {mma} HMMA/HGMMA")
            if ffma == 0 or mma:
                raise AssertionError(f"{tag} f32 function {name}: {ffma} FFMA, {mma} HMMA/HGMMA "
                                     f"(must be FMAs only, no TF32)")


def profile_device(fn, tag) -> None:
    """Where one warm call of `fn` spends the card's time: torch.profiler's
    device events, summed by kernel name, and the device-busy share of the
    wall time (the union of kernel intervals over the host clock; both
    include the profiler's own overhead).  Reports only; prints "not
    measured" when the profiler records no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: user annotations (e.g. "Optimizer.step#Adam.step")
    # are mirrored onto the device timeline but are no device work
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > 0
           and not getattr(e, "is_user_annotation", False)]
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


def k2_measure(q, base, bsq, *, metric, precision="highest", t_eff=None, reps=5,
               library_chunk=131072):
    """K2 vs its plain version on one input: the kernel's output, the plain
    one's, and the timing/bound record.  library_ms: the same (Q, d)×(d,
    n_pad) product alone (no norms, no group min) — torch.matmul in f32
    (bf16 for "default", whose inputs the kernel rounds to bf16),
    torch._int_mm for int8 — in corpus chunks whose output fits, each
    timed, summed."""
    from lira_tpu_torch.ops.groupmin import groupmin, groupmin_ref

    kw = dict(metric=metric, precision=precision, t_eff=t_eff)
    out = groupmin(q, base, bsq, **kw)
    ref = groupmin_ref(q, base, bsq, **kw)
    torch.cuda.synchronize()
    ms = time_ms(lambda: groupmin(q, base, bsq, **kw), reps)
    plain_ms = time_ms(lambda: groupmin_ref(q, base, bsq, **kw), 2)

    Q, d = q.shape
    n_pad = base.shape[0]
    peak = PEAK_OPS[torch.int8 if base.dtype == torch.int8 else
                    torch.bfloat16 if precision == "default" else torch.float32]
    ops = 2.0 * Q * n_pad * d
    nbytes = (q.numel() * q.element_size() + base.numel() * base.element_size()
              + bsq.numel() * 4 + out.numel() * 4)
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    if base.dtype == torch.int8:
        mm, qq, xx = torch._int_mm, q, base
    elif precision == "default":
        mm, qq, xx = torch.matmul, q.to(torch.bfloat16), base.to(torch.bfloat16)
    else:
        mm, qq, xx = torch.matmul, q, base
    library_ms = 0.0
    for c in range(0, n_pad, library_chunk):
        xc = xx[c : c + library_chunk]
        library_ms += time_ms(lambda x=xc: mm(qq, x.T), reps)
    rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=library_ms)
    return out, ref, rec


def k2_tolerance(q, base) -> float:
    """Bound on |kernel − plain| for f32 and bf16-rounded inputs: the same
    exact products summed in another f32 order, 2·d·eps·(max‖x‖² +
    2·max‖x‖·max‖q‖).  int8: 0 — both round the exact integer dot to f32
    and apply the same two f32 operations."""
    if base.dtype == torch.int8:
        return 0.0
    d = base.shape[1]
    base, q = base.float(), q.float()
    xn = float((base * base).sum(1).max())
    qn = float((q * q).sum(1).max())
    return 2.0 * d * EPS32 * (xn + 2.0 * (xn * qn) ** 0.5)


def phase_k2_grid(dev) -> None:
    """Every mode × metric at the main path's Q and d over 64 groups, the
    last one partly padded (pad rows zero, bsq 1e30)."""
    from lira_tpu_torch.ops.knn_pallas import _pad_and_norms, _quantize_corpus

    Q, d, n = 8192, 128, 64 * 128 - 50
    g = torch.Generator(device="cpu").manual_seed(8)
    x = torch.randn(n, d, generator=g).to(dev)
    qf = torch.randn(Q, d, generator=g).to(dev)
    for metric in ("L2", "inner_product"):
        base_p, bsq = _pad_and_norms(x, 64 * 128, metric != "inner_product")
        dim_scale, base8 = _quantize_corpus(base_p)
        for mode in ("highest", "default", "int8"):
            if mode == "int8":
                qp = qf * dim_scale[None, :]
                t = torch.clamp_min(qp.abs().amax() / 127.0, 1e-30)
                q = torch.clamp(torch.round(qp / t), -127, 127).to(torch.int8)
                t_eff = (t if metric == "inner_product" else 2.0 * t).reshape(1, 1)
                out, ref, rec = k2_measure(q, base8, bsq, metric=metric, t_eff=t_eff)
                tol = k2_tolerance(q, base8)
            elif mode == "default":  # bf16 tables, as knn_fused passes them
                qb, xb = qf.to(torch.bfloat16), base_p.to(torch.bfloat16)
                out, ref, rec = k2_measure(qb, xb, bsq, metric=metric, precision=mode)
                tol = k2_tolerance(qb, xb)
            else:
                out, ref, rec = k2_measure(qf, base_p, bsq, metric=metric, precision=mode)
                tol = k2_tolerance(qf, base_p)
            if not bool((out[:, -1] < 1e29).all()):
                raise AssertionError(f"K2 {mode} {metric}: the padded group lost its real rows")
            err = float((out - ref).abs().max())
            log(f"K2 {mode:8s} {metric:13s}: max|kernel-plain|={err:.3g} (tol {tol:.3g}) "
                f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), library "
                f"{rec['library_ms']:.3f} ms")
            if err > tol:
                raise AssertionError(f"K2 {mode} {metric}: {err} > {tol}")


def k3_tolerance(q, corpus) -> float:
    """Bound on |kernel − plain| for K3's scores: the same exact products
    summed in another f32 order, 2·d·eps·(max‖x‖² + 2·max‖x‖·max‖q‖)."""
    d = corpus.shape[-1]
    xn = float((corpus * corpus).sum(-1).max())
    qn = float((q * q).sum(1).max())
    return 2.0 * d * EPS32 * (xn + 2.0 * (xn * qn) ** 0.5)


def k3_compare(s_k, i_k, s_r, i_r, tol):
    """K3 against its plain version on one output: (max |score diff| over
    the found slots, queries whose id sets differ beyond a tie).  Missing
    slots must match exactly; an id may differ only where its score is
    within `tol` of the row's k-th score (the stacks keep the earlier of
    two equal scores, the plain top-k the lower tile-major index)."""
    miss_k, miss_r = s_k >= 1e37, s_r >= 1e37
    if not torch.equal(miss_k, miss_r):
        raise AssertionError("K3: the kernel and the plain version miss different slots")
    live = ~miss_r
    err = float((s_k - s_r)[live].abs().max()) if bool(live.any()) else 0.0
    kth = torch.where(live, s_r, -torch.inf).amax(dim=1, keepdim=True)
    inside_r, inside_k = live & (s_r < kth - tol), live & (s_k < kth - tol)
    in_k = (i_r[:, :, None] == i_k[:, None, :]).any(dim=2)
    in_r = (i_k[:, :, None] == i_r[:, None, :]).any(dim=2)
    bad = (inside_r & ~in_k).any(dim=1) | (inside_k & ~in_r).any(dim=1)
    return err, int(bad.sum())


def k3_work(q, tiles, corpus, k):
    """(operations, bytes, streamed bytes) of one K3 call on these inputs:
    2·d per (query, live tile row); bytes read once each (the distinct
    tiles with their ids and norms, the queries, the lists) plus the (B, k)
    result; streamed = what each query reads of its own tiles."""
    d = corpus.shape[-1]
    valid = tiles >= 0
    pairs = int(valid.sum())
    uniq = int(torch.unique(tiles[valid]).numel())
    ops = 2.0 * pairs * 128 * d
    nbytes = (uniq * 128 * (4 * d + 8) + q.numel() * 4 + tiles.numel() * 4
              + tiles.shape[0] * k * 8)
    return ops, nbytes, pairs * 128 * (4 * d + 8)


def k3_library_ms(q, tiles, corpus, reps, budget=1 << 28):
    """The gather of each query's listed tiles plus one torch.bmm (cuBLAS,
    TF32 off) against its query, in chunks of queries whose gather fits
    `budget` f32 elements, each chunk timed, summed; no top-k."""
    B, T = tiles.shape
    d = corpus.shape[-1]
    step = max(1, budget // (T * 128 * d))
    total = 0.0
    for s in range(0, B, step):
        idx = tiles[s : s + step].long().clamp_min(0)
        qs = q[s : s + step, :, None]
        n = idx.shape[0]
        total += time_ms(lambda i=idx, x=qs, n=n: torch.bmm(
            corpus[i].view(n, T * 128, d), x), reps)
    return total


def k3_measure(q, tiles, corpus, ids, sq, k, metric, reps=5, plain_reps=2):
    """K3 vs its plain version on one input: outputs, and the timing/bound
    record.  `inversion_ms`: the wrapper's list inversion alone (part of
    `ms`)."""
    from lira_tpu_torch.engine.pallas_scan import (invert_tile_lists, pallas_probed_scan,
                                                   probed_scan_ref)

    out = pallas_probed_scan(q, tiles, corpus, ids, sq, k, metric)
    ref = probed_scan_ref(q, tiles, corpus, ids, sq, k, metric)
    torch.cuda.synchronize()
    ms = time_ms(lambda: pallas_probed_scan(q, tiles, corpus, ids, sq, k, metric), reps)
    plain_ms = time_ms(lambda: probed_scan_ref(q, tiles, corpus, ids, sq, k, metric),
                       plain_reps)
    inversion_ms = time_ms(lambda: invert_tile_lists(tiles, corpus.shape[0]), reps)
    ops, nbytes, streamed = k3_work(q, tiles, corpus, k)
    t_ops, t_bytes = ops / PEAK_OPS[torch.float32], nbytes / PEAK_BYTES
    rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=k3_library_ms(q, tiles, corpus, reps),
               streamed_ms=1e3 * streamed / PEAK_BYTES, streamed_gb=streamed / 1e9,
               inversion_ms=inversion_ms)
    return out, ref, rec


def phase_k3_grid(dev) -> None:
    """k in {1, 20, 36, 128} × L2 and IP at the main path's block size and
    d, lists with -1 holes in the middle, a tile listed twice, a partly
    padded tile and one tile in every query's list (2048 entries: 128 of
    the kernel's work items); plus one small case at d=960."""
    g = torch.Generator(device="cpu").manual_seed(9)
    for d, n_tiles, B, T, ks in ((128, 4096, 2048, 64, (1, 20, 36, 128)),
                                 (960, 64, 256, 16, (20,))):
        corpus = torch.randn(n_tiles, 128, d, generator=g).to(dev)
        ids = torch.arange(n_tiles * 128, dtype=torch.int32).view(n_tiles, 128)
        ids[-1, 77:] = -1  # a partly padded tile
        ids = ids.to(dev)
        tiles = torch.randint(0, n_tiles, (B, T), generator=g, dtype=torch.int32)
        tiles[torch.rand(B, T, generator=g) < 0.25] = -1  # holes
        tiles[:, 1] = tiles[:, 0]  # a tile listed twice
        tiles[::7, 2] = n_tiles - 1
        tiles[:, 4] = 5  # skew: one tile in every query's list
        tiles[3] = -1  # a query with no tile
        tiles, q = tiles.to(dev), torch.randn(B, d, generator=g).to(dev)
        norms = (corpus * corpus).sum(-1)
        for metric in ("L2", "inner_product"):
            sq = norms if metric == "L2" else torch.zeros_like(norms)
            sq = torch.where(ids >= 0, sq, 3e38)
            for k in ks:
                (s_k, i_k), (s_r, i_r), rec = k3_measure(q, tiles, corpus, ids, sq, k,
                                                         metric, reps=3)
                tol = k3_tolerance(q, corpus)
                err, bad = k3_compare(s_k, i_k, s_r, i_r, tol)
                log(f"K3 d={d} {metric:13s} k={k:3d}: max|kernel-plain|={err:.3g} (tol "
                    f"{tol:.3g}), {bad} queries with other ids; {rec['ms']:.3f} ms, plain "
                    f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']}), streamed {rec['streamed_gb']:.2f} GB "
                    f"({rec['streamed_ms']:.3f} ms at peak), library "
                    f"{rec['library_ms']:.3f} ms; list inversion {rec['inversion_ms']:.3f} ms "
                    f"of the kernel's")
                if err > tol or bad:
                    raise AssertionError(f"K3 d={d} {metric} k={k}: err {err} (tol {tol}), "
                                         f"{bad} queries differ")
        del corpus, norms
        torch.cuda.empty_cache()


LARGE_MARK = 1 << 31  # elements (f32) or bytes (bf16, int8) a flat offset passes int32 at


def phase_large_tables(dev, n_super=16_640, d=128, qb=1024, U=32, n_q=256, B=2048, T=16,
                       k=20, reps=3) -> dict:
    """K1 (f32, bf16, int8), K2 ("highest", "default", int8) and K3 (f32)
    on one table built on the card from a seeded torch.Generator:
    n_super·1024 rows × d, past 2^31 elements (f32 and int8: 2^31 bytes
    too; bf16's table passes 2^31 bytes at half the rows, and the same rows
    are used).  Every supertile and tile the comparisons read lies past the
    mark, at the table's end; each kernel is held against its plain
    version, which reads only those rows, within the grids' tolerances.
    K2 sweeps the whole table (n_pad·d > 2^31) and its last groups and the
    groups around the mark are compared.  Returns {case: max |err|}."""
    from lira_tpu_torch.engine.block_scan import screen_queries
    from lira_tpu_torch.engine.pallas_scan import pallas_probed_scan, probed_scan_ref
    from lira_tpu_torch.engine.screen import screen_norms, union_groupmin, union_groupmin_ref
    from lira_tpu_torch.ops.groupmin import GROUP, groupmin, groupmin_ref

    n_rows = n_super * 1024
    if n_rows * d <= LARGE_MARK:
        raise ValueError(f"phase_large_tables: {n_rows} x {d} does not pass 2^31 elements")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    amax = torch.zeros(d, device=dev)
    for s in range(0, n_rows, 1 << 22):  # row chunks: no table-sized temporaries
        x[s : s + (1 << 22)] = torch.randn((min(1 << 22, n_rows - s), d), generator=g,
                                           device=dev)
        amax = torch.maximum(amax, x[s : s + (1 << 22)].abs().amax(0))
    dim_scale = torch.clamp_min(amax, 1e-30) / 127.0
    xb = torch.empty((n_rows, d), dtype=torch.bfloat16, device=dev)
    x8 = torch.empty((n_rows, d), dtype=torch.int8, device=dev)
    for s in range(0, n_rows, 1 << 22):
        xs = x[s : s + (1 << 22)]
        xb[s : s + (1 << 22)] = xs.to(torch.bfloat16)
        x8[s : s + (1 << 22)] = torch.clamp(torch.round(xs / dim_scale), -127, 127).to(
            torch.int8)
    torch.cuda.synchronize()
    mark_super = LARGE_MARK // (1024 * d)  # the first supertile wholly past the mark
    log(f"large tables: {n_rows:,} x {d} ({n_rows * d / LARGE_MARK:.4f} x 2^31 elements; "
        f"f32 {x.numel() * 4 / 2**30:.2f} GiB, bf16 {xb.numel() * 2 / 2**30:.2f} GiB, "
        f"int8 {x8.numel() / 2**30:.2f} GiB) built on the card in "
        f"{time.perf_counter() - t0:.1f}s; supertile {mark_super} onward lies past the mark")
    gq = torch.Generator(device="cpu").manual_seed(12)
    errs = {}

    # K1: two block rows, every slot a supertile past the mark, the table's
    # last one included, block row 1's union cut short
    tail = n_super - mark_super
    supers = (mark_super + torch.randint(0, tail, (2, U), generator=gq, dtype=torch.int32))
    supers[0, 0] = n_super - 1
    supers = supers.to(dev)
    ulen = torch.tensor([U, U // 2 + 1], dtype=torch.int32, device=dev)
    qf = torch.randn(2 * qb, d, generator=gq).to(dev)
    for dtype, table in ((torch.float32, x), (torch.bfloat16, xb), (torch.int8, x8)):
        q, t_eff, s2 = screen_queries(qf, dtype, dim_scale, "L2")
        xsq = screen_norms(table, s2)
        kw = dict(qb=qb, metric="L2", sel_rows=32, t_eff=t_eff, s2=s2, xsq=xsq)
        out = union_groupmin(q, table, supers, ulen, **kw)
        ref = union_groupmin_ref(q, table, supers, ulen, **kw)
        ms = time_ms(lambda: union_groupmin(q, table, supers, ulen, **kw), reps)
        read = table.view(-1, 1024, d)[supers.long()].reshape(-1, d)
        tol = k1_tolerance(q, read, "L2", t_eff, s2)
        err = float((out - ref).abs().max())
        name = f"K1 {DTYPE_NAME[dtype]}"
        log(f"{name} past 2^31 ({table.numel() * table.element_size() / 2**30:.2f} GiB "
            f"table, supertiles {int(supers.min())}..{int(supers.max())}): "
            f"max|kernel-plain|={err:.3g} (tol {tol:.3g}), {ms:.3f} ms")
        if err > tol or not bool((out[1, ulen[1] * 32:] == 3e38).all()):
            raise AssertionError(f"{name} on a table past 2^31: err {err} (tol {tol}) "
                                 f"or dead slots not 3e38")
        errs[name] = err
        del out, ref, read, xsq

    # K2: the whole table swept; the last groups and those around the mark
    n_groups = n_rows // GROUP
    mark_group = LARGE_MARK // (GROUP * d)
    q2 = torch.randn(n_q, d, generator=gq).to(dev)
    bsq = screen_norms(x)
    for mode in ("highest", "default", "int8"):
        if mode == "int8":
            qp = q2 * dim_scale[None, :]
            t = torch.clamp_min(qp.abs().amax() / 127.0, 1e-30)
            qm = torch.clamp(torch.round(qp / t), -127, 127).to(torch.int8)
            kw, table = dict(metric="L2", t_eff=(2.0 * t).reshape(1, 1)), x8
        elif mode == "default":
            qm, kw, table = q2.to(torch.bfloat16), dict(metric="L2", precision=mode), xb
        else:
            qm, kw, table = q2, dict(metric="L2", precision=mode), x
        out = groupmin(qm, table, bsq, **kw)
        ms = time_ms(lambda: groupmin(qm, table, bsq, **kw), reps)
        err, tol = 0.0, 0.0
        for lo, hi in ((mark_group - 64, mark_group + 64), (n_groups - 256, n_groups)):
            part = table[lo * GROUP : hi * GROUP]
            ref = groupmin_ref(qm, part, bsq[lo * GROUP : hi * GROUP], **kw)
            err = max(err, float((out[:, lo:hi] - ref).abs().max()))
            tol = max(tol, k2_tolerance(qm, part))
        name = f"K2 {mode}"
        log(f"{name} past 2^31 (n_pad {n_rows:,} x d {d} = {n_rows * d:,} elements, "
            f"{table.numel() * table.element_size() / 2**30:.2f} GiB; groups "
            f"{mark_group - 64}..{mark_group + 63} and the last 256 compared): "
            f"max|kernel-plain|={err:.3g} (tol {tol:.3g}), {ms:.3f} ms")
        if err > tol or out.shape != (n_q, n_groups):
            raise AssertionError(f"{name} on a table past 2^31: {err} > {tol}")
        errs[name] = err
        del out
    del bsq, xb, x8

    # K3: B queries, each listing T tiles past the mark (the last one included)
    n_tiles = n_rows // 128
    mark_tile = LARGE_MARK // (128 * d)
    corpus = x.view(n_tiles, 128, d)
    ids = torch.arange(n_rows, dtype=torch.int32, device=dev).view(n_tiles, 128)
    sq = screen_norms(x).view(n_tiles, 128)
    tiles = mark_tile + torch.randint(0, n_tiles - mark_tile, (B, T), generator=gq,
                                      dtype=torch.int32)
    tiles[:, 0] = n_tiles - 1
    tiles[torch.rand(B, T, generator=gq) < 0.2] = -1
    tiles, q3 = tiles.to(dev), torch.randn(B, d, generator=gq).to(dev)
    s_k, i_k = pallas_probed_scan(q3, tiles, corpus, ids, sq, k, "L2")
    s_r, i_r = probed_scan_ref(q3, tiles, corpus, ids, sq, k, "L2")
    ms = time_ms(lambda: pallas_probed_scan(q3, tiles, corpus, ids, sq, k, "L2"), reps)
    tol = k3_tolerance(q3, corpus[torch.unique(tiles[tiles >= 0]).long()])
    err, bad = k3_compare(s_k, i_k, s_r, i_r, tol)
    if not bool((i_k[i_k >= 0] >= mark_tile * 128).all()):
        raise AssertionError("K3 past 2^31: an id from before the mark")
    log(f"K3 float32 past 2^31 ({n_tiles:,} tiles, lists in tiles {mark_tile}..{n_tiles - 1}, "
        f"B={B}, T={T}, k={k}): max|kernel-plain|={err:.3g} (tol {tol:.3g}), {bad} queries "
        f"with other ids, {ms:.3f} ms")
    if err > tol or bad:
        raise AssertionError(f"K3 on a table past 2^31: err {err} (tol {tol}), {bad} differ")
    errs["K3 float32"] = err
    del x, corpus, ids, sq
    torch.cuda.empty_cache()
    return errs


def check_self_knn(x_dev, knn, k, n_rows=1024, seed=0) -> None:
    """The self-kNN on `n_rows` sampled rows against a brute-force top-k in
    true fp32 on the card (the rule of tests/test_knn_pallas.py): the f64
    distances of the returned ids allclose, ids exact where no tie, no row
    holding itself.  Two f32 rankings may swap candidates whose distances
    differ by less than the f32 score error, 2·d·eps·(‖x_i‖² + max‖x‖² +
    2‖x_i‖·max‖x‖); such pairs count as ties."""
    n, d = x_dev.shape
    rows = torch.as_tensor(np.random.default_rng(seed).choice(n, n_rows, replace=False),
                           device=x_dev.device)
    xs = x_dev[rows]
    xsq = (x_dev * x_dev).sum(1)
    sc = xsq[None, :] - 2.0 * (xs @ x_dev.T)
    sc[torch.arange(n_rows, device=x_dev.device), rows] = torch.inf
    brute = torch.topk(sc, k, dim=1, largest=False).indices
    got = torch.as_tensor(knn, device=x_dev.device)[rows].long()
    if bool((got == rows[:, None]).any()) or bool((got < 0).any()):
        raise AssertionError("self-kNN: a row holds itself or a -1")
    x64 = x_dev.double()

    def dist(ids):
        return ((x64[ids] - x64[rows][:, None, :]) ** 2).sum(-1)

    d_got, d_brute = dist(got), dist(brute)
    xn_max = float(xsq.max())
    tol = (2 * d * EPS32 * (xsq[rows] + xn_max + 2 * (xsq[rows] * xn_max).sqrt())).double()
    off = (d_got - d_brute).abs()
    if not bool((off <= tol[:, None]).all()):
        raise AssertionError(f"self-kNN ids differ from brute force beyond a tie: "
                             f"distance off by {float(off.max())}")
    log(f"self-kNN check: {n_rows} sampled rows exact against a brute-force top-{k} "
        f"({int((got != brute).sum())} swaps between tied candidates, largest distance "
        f"gap {float(off.max()):.3g}, tie tolerance >= {float(tol.min()):.3g})")


def phase_trained_index(dev, n=1_000_000, d=128, n_bkt=1024, batch=65536, k=10,
                        n_epoch=6):
    """bench.py's build_trained_index on the card, with the self-kNN through
    the fused path and K2 (as the pipelines run it on an accelerator)."""
    from lira_tpu_torch.config import Config
    from lira_tpu_torch.io.datasets import HARD_REGIME, hard_regime_sig, synthetic_dataset
    from lira_tpu_torch.labels.distr import knn_bucket_labels
    from lira_tpu_torch.labels.scaler import scaled_centroid_distances
    from lira_tpu_torch.models.train import make_train_state, train_epoch
    from lira_tpu_torch.ops.groupmin import groupmin
    from lira_tpu_torch.ops.knn_pallas import _pad_and_norms
    from lira_tpu_torch.partition.assign import build_bucket_layout
    from lira_tpu_torch.partition.kmeans import kmeans_assign, kmeans_fit
    from lira_tpu_torch.pipelines.smallscale import get_self_knn

    t0 = time.perf_counter()
    ds = synthetic_dataset(**HARD_REGIME, n_base=n, n_query=batch, dim=d, compute_gt=False)
    x_d, x_q = ds.base, ds.query
    log(f"corpus {n}x{d} + {batch} queries ({hard_regime_sig()}): "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    km = kmeans_fit(x_d, n_bkt, niter=20, seed=43, device=dev)
    assign = kmeans_assign(x_d, km.centroids, device=dev)
    layout = build_bucket_layout(assign, n_bkt)
    log(f"index: kmeans objective {km.objective[0]:.4g} -> {km.objective[-1]:.4g}, "
        f"{layout.total} rows in {n_bkt} buckets (sizes {layout.sizes.min()}.."
        f"{layout.sizes.max()}): {time.perf_counter() - t0:.1f}s")

    q_tile = 8192
    groupmin.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knn = get_self_knn(x_d, Config(k=k), use_cache=False, device=dev)
    t_knn = time.perf_counter() - t0
    launches = groupmin.launches
    log(f"self-kNN k={k} through K2 (f32): {t_knn:.2f}s, {launches} K2 launches")
    if launches != -(-n // q_tile):
        raise AssertionError(f"self-kNN launched K2 {launches} times, not {-(-n // q_tile)}")
    if knn.shape != (n, k):
        raise AssertionError(f"self-kNN shape {knn.shape}")
    x_dev = torch.as_tensor(x_d, device=dev)
    check_self_knn(x_dev, knn, k)

    # K2 at the main path's shape: one launch (the first query tile of the
    # self-kNN against the whole padded corpus), and all of the run's
    # launches timed back to back
    n_pad = -(-n // 128) * 128
    base_p, bsq = _pad_and_norms(x_dev, n_pad, True)
    del x_dev
    out, ref, rec = k2_measure(base_p[:q_tile], base_p, bsq, metric="L2", reps=3)
    err = float((out - ref).abs().max())
    tol = k2_tolerance(base_p[:q_tile], base_p)
    del out, ref
    tiles = [base_p[s : s + q_tile] for s in range(0, n, q_tile)]
    tiles[-1] = torch.nn.functional.pad(tiles[-1], (0, 0, 0, q_tile - len(tiles[-1])))
    # the SM clock and power while the FMAs run flat out (nvidia-smi every 0.5 s)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "500"],
                           stdout=subprocess.PIPE, text=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for qt in tiles:
        groupmin(qt, base_p, bsq, metric="L2")
    end.record()
    end.synchronize()
    all_ms = start.elapsed_time(end)
    smi.terminate()
    samples = [[float(v) for v in line.split(",")]
               for line in smi.communicate()[0].splitlines() if line.count(",") == 1]
    if samples:
        clk, pw = [s[0] for s in samples], [s[1] for s in samples]
        log(f"under K2's load: SM clock {min(clk):.0f}-{max(clk):.0f} MHz, power "
            f"{min(pw):.0f}-{max(pw):.0f} W ({len(samples)} samples)")
    else:
        log("under K2's load: SM clock and power not measured (no nvidia-smi samples)")
    log(f"K2 at the main path's shape (Q={q_tile}, n_pad={n_pad}, d={d}, f32 L2): "
        f"max|kernel-plain|={err:.3g} (tol {tol:.3g}), {rec['ms']:.3f} ms, plain "
        f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
        f"library {rec['library_ms']:.3f} ms, "
        f"{2.0 * q_tile * n_pad * d / rec['ms'] / 1e9:.1f} TFLOP/s; "
        f"all {len(tiles)} tiles {all_ms:.1f} ms (bound {len(tiles) * rec['bound_ms']:.1f} ms)")
    if err > tol:
        raise AssertionError(f"K2 main-path inputs: {err} > {tol}")
    k2 = {"name": "groupmin[float32,L2]", "route": "cuda", "source": K2_SOURCE,
          "replaces": K2_REPLACES, "launches": launches, "max_abs_err": err,
          "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
          "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
          "all_launches_ms": all_ms, "all_launches_bound_ms": len(tiles) * rec["bound_ms"]}
    del base_p, bsq, tiles
    torch.cuda.empty_cache()
    k2 = [k2] + phase_k2_tensor_cores(dev, x_d, knn, k, q_tile)

    t0 = time.perf_counter()
    labels = knn_bucket_labels(knn, assign.reshape(-1, 1), n_bkt)
    log(f"labels: {labels.shape} {labels.dtype}, mean {labels.sum(1).mean():.2f} buckets "
        f"per row: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dist, _, scaler = scaled_centroid_distances(x_d, x_q[:8], km.centroids, device=dev)
    torch.cuda.synchronize()
    log(f"scaled distances {tuple(dist.shape)} on the card: {time.perf_counter() - t0:.1f}s")
    state = make_train_state(43, n_bkt, d, device=dev)
    x_tr = torch.as_tensor(x_d, device=dev)
    lab = torch.as_tensor(labels, device=dev)
    losses = []
    for epoch in range(n_epoch):
        t0 = time.perf_counter()
        state, loss = train_epoch(state, dist, x_tr, lab, batch_size=256)
        torch.cuda.synchronize()
        losses.append(loss)
        log(f"train epoch {epoch}: loss {loss:.6f}, {time.perf_counter() - t0:.1f}s "
            f"({-(-n // 256)} steps at batch 256)")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"training did not lower the loss: {losses}")
    # the device's share of a training step: 64 steps on a copy of the state
    probe = copy.deepcopy(state)
    rows = slice(0, 64 * 256)
    profile_device(lambda: train_epoch(probe, dist[rows], x_tr[rows], lab[rows],
                                       batch_size=256), "train 64 steps")
    del probe
    del dist, x_tr, lab
    torch.cuda.empty_cache()
    return dict(x_d=x_d, x_q=x_q, km=km, layout=layout, scaler=scaler,
                mlp=state.params, k2=k2, assign=assign, knn=knn)


def missed_rate(knn, ref, dev) -> tuple[float, int]:
    """The share of `ref`'s neighbours that `knn` lacks (1 − recall), and
    the rows whose neighbour sets differ."""
    a = torch.as_tensor(knn, device=dev).long()
    b = torch.as_tensor(ref, device=dev).long()
    hit = (b[:, :, None] == a[:, None, :]).any(2)
    return 1.0 - float(hit.float().mean()), int((~hit).any(1).sum())


def phase_k2_tensor_cores(dev, x_d, knn_f32, k, q_tile) -> list:
    """K2's tensor-core modes on the main path's data.  One launch of each
    at the main path's shape (the self-kNN's first query tile against the
    whole padded corpus, as knn_fused gives them: the bf16 table and its
    slice; the int8 table and the tile quantized) against its plain
    version (k2_tolerance; int8 exact), timed beside its bound and library
    call.  Then the 1M self-kNN through the fused path in "default" and in
    int8 at their default margins (8, 16): K2's launches (counts set to 0
    just before, read just after), wall seconds, and the share of phase
    5's f32 neighbours it misses (docs/bf16_screen.md measured 0 on the TPU
    at these margins, on its own corpus).  Returns the two K2 records."""
    from lira_tpu_torch.ops.groupmin import groupmin, pad_cols
    from lira_tpu_torch.ops.knn_pallas import _pad_and_norms, _quantize_corpus, self_knn_fused

    n, d = x_d.shape
    n_pad = -(-n // 128) * 128
    recs = []
    for mode, dt in (("default", "bfloat16"), ("int8", "int8")):
        base_p, bsq = _pad_and_norms(torch.as_tensor(x_d, device=dev), n_pad, True)
        if mode == "int8":
            dim_scale, table = _quantize_corpus(base_p)
            table = pad_cols(table)
            qp = base_p[:q_tile] * dim_scale[None, :]
            t = torch.clamp_min(qp.abs().amax() / 127.0, 1e-30)
            q = pad_cols(torch.clamp(torch.round(qp / t), -127, 127).to(torch.int8))
            kw = dict(t_eff=(2.0 * t).reshape(1, 1))
        else:
            table = pad_cols(base_p.to(torch.bfloat16))
            q, kw = table[:q_tile], dict(precision="default")
        del base_p
        out, ref, rec = k2_measure(q, table, bsq, metric="L2", reps=5, **kw)
        err = float((out - ref).abs().max())
        tol = k2_tolerance(q, table)
        padded_ok = bool((out[:, -1] < 1e29).all())
        del out, ref, q, table, bsq
        torch.cuda.empty_cache()
        log(f"K2 {mode} at the main path's shape (Q={q_tile}, n_pad={n_pad}, d={d}, L2): "
            f"max|kernel-plain|={err:.3g} (tol {tol:.3g}), {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
            f"library {rec['library_ms']:.3f} ms, "
            f"{2.0 * q_tile * n_pad * d / rec['ms'] / 1e9:.1f} T/s")
        if err > tol or not padded_ok:
            raise AssertionError(f"K2 {mode} main-path inputs: {err} > {tol}, or the last "
                                 f"group lost its real rows")

        groupmin.launches = 0
        groupmin.launches_by_dtype.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        knn = self_knn_fused(x_d, k, precision=mode, q_tile=q_tile, device=dev)
        wall = time.perf_counter() - t0
        launches = groupmin.launches
        miss, rows = missed_rate(knn, knn_f32, dev)
        log(f"self-kNN k={k} through K2 ({mode}, margin {16 if mode == 'int8' else 8}): "
            f"{wall:.2f}s, {launches} K2 launches; against the f32 self-kNN: missed-neighbour "
            f"rate {miss:.3g} ({rows} of {n} rows differ; docs/bf16_screen.md on the TPU: 0)")
        if (launches != -(-n // q_tile) or groupmin.launches_by_dtype[dt] != launches
                or knn.shape != (n, k) or int(knn.min()) < 0):
            raise AssertionError(f"self-kNN {mode}: {launches} K2 launches "
                                 f"({dict(groupmin.launches_by_dtype)}), shape {knn.shape}")
        recs.append({"name": f"groupmin[{dt},L2]", "route": "cuda", "source": K2_SOURCE,
                     "replaces": K2_REPLACES, "launches": launches, "max_abs_err": err,
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                     "self_knn_s": wall, "missed_rate": miss})
    return recs


def k1_main_path_inputs(eng, x_q, thr):
    """K1's inputs exactly as the engine's screen gets them for this
    65536-query batch (probe, unions, block order, screen dtype), and the
    selection's: each group's bucket (n_blocks, U·SG) int32 and each
    block's probed rows (n_blocks, qb, n_bkt)."""
    from lira_tpu_torch.engine import block_scan as bs

    st = eng._block_state
    h = bs._probe_batch(st, eng, x_q, thr, eng.block_q)
    union = h["union"].cpu().numpy()
    supers, tb, ulen = bs.build_block_unions(union, eng.tile_start, eng.tiles_per_bucket,
                                             st.tile_bucket)
    q, t_eff, s2 = bs.screen_queries(h["q"][h["perm"]], st.corpus_flat.dtype,
                                     st.dim_scale, eng.metric)
    dev = st.device
    supers = torch.as_tensor(supers, device=dev)
    tb_g = bs.group_buckets(torch.as_tensor(tb, device=dev), supers, st.tile_pad_count,
                            eng.block_sel_rows)
    probed_p = h["probed"][h["perm"]].view(supers.shape[0], h["qb"], -1)
    return (q.contiguous(), st.corpus_flat, supers, torch.as_tensor(ulen, device=dev),
            h["qb"], t_eff, s2, st.screen_sq, tb_g, probed_p)


def check_oracle(eng, r, idx, thr, k, tag, rng, n_chk=256, n=64):
    """Exact neighbour sets on `n` of the first `n_chk` queries against a
    numpy oracle over the buckets the engine probes for them."""
    x_d, x_q, layout = idx["x_d"], idx["x_q"], idx["layout"]
    probed = eng._select_probed(x_q[:n_chk], thr)
    for i in rng.choice(n_chk, size=n, replace=False):
        members = np.unique(np.concatenate(
            [layout.bucket_members(bb) for bb in np.nonzero(probed[i])[0]]
        ))
        dd = ((x_d[members] - x_q[i]) ** 2).sum(axis=1)
        expect = set(members[np.argsort(dd, kind="stable")][: min(k, len(members))])
        got = set(int(v) for v in r.ids[i] if v >= 0)
        if got != expect:
            raise AssertionError(f"[{tag}] query {i}: engine != oracle")
    log(f"oracle[{tag}]: neighbour sets exact on {n} sampled queries")
    return probed


def check_stream(r, r_s, batch, tag):
    for b in range(len(r_s.ids) // batch):
        sl = slice(b * batch, (b + 1) * batch)
        for name in ("ids", "scores", "nprobe", "ndis"):
            if not np.array_equal(getattr(r_s, name)[sl], getattr(r, name)):
                raise AssertionError(f"[{tag}] search_stream batch {b} {name} != search")
    log(f"stream[{tag}]: {len(r_s.ids) // batch} batches equal per-batch search")


def recall_at(ids, gt):
    return float((ids[: len(gt), :, None] == gt[:, None, :]).any(axis=1).mean())


def phase_serving(dev, idx, batch=65536, n_gt=4096, k=10):
    """The blocked serving path on the trained index, in every screen dtype.
    Returns (kernel records, the run: threshold, ground truth and each
    dtype's result, recall and margin)."""
    from lira_tpu_torch.engine import block_scan as bs
    from lira_tpu_torch.engine.calibrate import calibrate_block_margin
    from lira_tpu_torch.engine.group_rescore import exact_group_rescore
    from lira_tpu_torch.engine.group_select import masked_group_topk
    from lira_tpu_torch.engine.screen import union_groupmin
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.ops.knn import exact_knn

    x_d, x_q, km, layout, scaler, mlp = (idx[key] for key in
                                         ("x_d", "x_q", "km", "layout", "scaler", "mlp"))
    n, n_bkt = len(x_d), layout.n_bkt
    t0 = time.perf_counter()
    _, gt = exact_knn(x_d, x_q[:n_gt], k, device=dev)
    log(f"exact ground truth for {n_gt} queries on the card (ops.knn.exact_knn): "
        f"{time.perf_counter() - t0:.1f}s")

    kernels = []
    run = dict(gt=gt, results={})
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
        union_groupmin.launches = masked_group_topk.launches = exact_group_rescore.launches = 0
        r = eng.search(x_q, thr, k)
        plan = dict(bs._LAST_CHUNK_PLAN)
        sel_search, rescore_search = masked_group_topk.launches, exact_group_rescore.launches
        r_s = eng.search_stream(big, thr, k, batch_size=batch)
        launches, sel_launches = union_groupmin.launches, masked_group_topk.launches
        slices = plan["n_blocks"] * -(-plan["U"] // plan["u_chunk"])
        log(f"K1 launches in the main path's run [{scan_dtype}]: {launches}; the masked "
            f"selection's: {sel_launches}, {sel_search} in the `search` ({plan['n_blocks']} "
            f"blocks, U {plan['U']} in slices of {plan['u_chunk']}: {slices} selections)")
        if launches <= 0:
            raise AssertionError("the main path did not launch K1")
        if sel_search != slices:
            raise AssertionError(f"the `search` launched the masked selection {sel_search} "
                                 f"times, not once a block and U-slice ({slices})")
        if rescore_search != plan["n_blocks"]:
            raise AssertionError(f"the `search` launched the rescore {rescore_search} times, "
                                 f"not once a block ({plan['n_blocks']})")
        peak = torch.cuda.max_memory_allocated()

        ndis = float(r.ndis.mean())
        recall = recall_at(r.ids, gt)
        log(f"serve[{scan_dtype}]: margin={eng.block_margin} nprobe={r.nprobe.mean():.2f} "
            f"ndis={ndis:.0f} ({100 * ndis / n:.3f}% corpus) recall@{k}={recall:.4f} "
            f"(trained MLP; TPU record {TPU_RECALL} at ndis {TPU_NDIS}) "
            f"search {batch / r.elapsed:.0f} QPS ({r.elapsed:.3f}s), "
            f"stream {len(big) / r_s.elapsed:.0f} QPS ({r_s.elapsed:.3f}s), "
            f"peak device memory {peak / 2**30:.2f} GiB")
        if r.ids.shape[1] != k or not np.isfinite(r.scores[r.ids >= 0]).all():
            raise AssertionError("search result has the wrong shape or non-finite scores")
        if scan_dtype == "int8" and recall < MIN_INT8_RECALL:
            raise AssertionError(f"int8 recall@{k} {recall:.4f} < {MIN_INT8_RECALL} "
                                 f"with the trained MLP")

        check_stream(r, r_s, batch, scan_dtype)
        check_oracle(eng, r, idx, thr, k, scan_dtype, rng)
        run["thr"] = thr
        run["results"][scan_dtype] = dict(r=r, recall=recall, margin=eng.block_margin,
                                          peak=peak)

        profile_device(lambda: eng.search(x_q, thr, k), scan_dtype)
        (q, corpus, supers, ulen, qb, t_eff, s2, xsq, tb_g,
         probed_p) = k1_main_path_inputs(eng, x_q, thr)
        sel = eng.block_sel_rows
        out, ref, rec = k1_measure(q, corpus, supers, ulen, qb=qb, metric=eng.metric,
                                   sel_rows=sel, t_eff=t_eff, s2=s2, xsq=xsq, reps=3)
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
        del ref
        # the engine's own kg (its calibrated margin) on its own K1 output
        kg = min(k * eng.n_mul + eng.block_margin, out.shape[1])
        first, exh = select_main_path(out, tb_g, probed_p, ulen, bs.S_TILES * (128 // sel), kg,
                                      f"{scan_dtype} main path")
        kernels.append({
            "name": f"masked_group_topk[{scan_dtype},sel_rows={sel},kg={kg}]", "route": "cuda",
            "source": GS_SOURCE, "replaces": GS_REPLACES, "launches": sel_launches,
            "max_abs_err": 0.0, "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": first["library_ms"], "live_groups": first["n_live"],
            "groups": first["n_g"],
            "exhaustive": {key: exh[key] for key in ("kg", "passes", "ms", "plain_ms")},
        })
        del eng, out, q, corpus, tb_g, probed_p
        torch.cuda.empty_cache()
    return kernels, run


def group_select_measure(gmin, tb, probed, live, unit, kg, tag, reps=5) -> dict:
    """The masked selection on one block: the kernel bit for bit against
    its plain version, then ms a block of the kernel, of the plain chain,
    of `torch.topk` over the block's masked minima (the library yardstick:
    one PyTorch call, no tie rule, its input prepared outside the timing)
    and the bytes bound (the live minima, the bucket map, the probed rows
    read once, the output written once, at 3.35 TB/s)."""
    from lira_tpu_torch.engine.group_select import (masked_group_topk, masked_group_topk_ref,
                                                    select_plan)

    n_g, qb = gmin.shape
    passes = select_plan(probed.shape[1], qb, kg)["passes"]
    live_t = torch.tensor([live], dtype=torch.int32, device=gmin.device)
    n_live = min(live * unit, n_g)
    v, i = masked_group_topk(gmin, tb, probed, live_t, kg, unit=unit)
    v_r, i_r = masked_group_topk_ref(gmin, tb, probed, live_t, kg, unit=unit)
    torch.cuda.synchronize()
    if not (torch.equal(v.view(torch.int32), v_r.view(torch.int32)) and torch.equal(i, i_r)):
        bad = int(((v.view(torch.int32) != v_r.view(torch.int32)) | (i != i_r)).any(1).sum())
        raise AssertionError(f"group select [{tag}]: kernel != plain version on {bad} of "
                             f"{qb} queries")
    del v, i, v_r, i_r
    ms = time_ms(lambda: masked_group_topk(gmin, tb, probed, live_t, kg, unit=unit), reps)
    plain_ms = time_ms(lambda: masked_group_topk_ref(gmin, tb, probed, live_t, kg, unit=unit),
                       2)
    pen = torch.where(probed.T, 0.0, 3e38).float()
    pen = torch.cat([pen, pen.new_full((1, qb), 3e38)], dim=0)
    masked = (-(gmin + pen[torch.where(tb >= 0, tb, pen.shape[0] - 1).long()])).T.contiguous()
    del pen
    library_ms = time_ms(lambda: torch.topk(masked, kg, dim=1), reps)
    del masked
    nbytes = n_live * qb * 4 + n_live * 4 + probed.numel() + qb * kg * 12
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=1e3 * nbytes / PEAK_BYTES, n_g=n_g, n_live=n_live, qb=qb, kg=kg,
               passes=passes)
    log(f"group select [{tag}]: {n_live:,} live of {n_g:,} groups x {qb} queries, kg {kg} "
        f"({passes} pass{'es' if passes > 1 else ''}): "
        f"equal to the plain version; {ms:.3f} ms a block, plain {plain_ms:.3f} ms, "
        f"torch.topk {library_ms:.3f} ms, bound {rec['bound_ms']:.3f} ms (bytes)")
    torch.cuda.empty_cache()
    return rec


def synthetic_select_block(dev, n_slots, sg, live, qb, n_bkt, n_probed, seed):
    """A block shaped like K1's output on the blocked path: `live` union
    slots of `sg` groups in runs of one bucket (a bucket's tiles are
    consecutive), minima of a unit-variance corpus's L2 scores, `n_probed`
    buckets a query; the padding slots at exactly 3e38 and bucket -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_g = n_slots * sg
    gmin = 50.0 + 10.0 * torch.randn(n_g, qb, generator=g, device=dev)
    run = max(1, (live * sg) // n_bkt)  # groups a bucket: the union covers the buckets
    tb = (torch.arange(n_g, device=dev) // run % n_bkt).to(torch.int32)
    tb[torch.rand(n_g, generator=g, device=dev) < 0.02] = -1  # all-pad groups
    gmin[live * sg:] = 3e38
    tb[live * sg:] = -1
    probed = torch.zeros(qb, n_bkt, dtype=torch.bool, device=dev)
    probed.scatter_(1, torch.randint(0, n_bkt, (qb, n_probed), generator=g, device=dev), True)
    return gmin, tb, probed


def select_main_path(gmin, tb_g, probed_p, ulen, unit, kg, tag, n_blocks=8):
    """The masked selection on an engine's own K1 output (gmin (n_blocks,
    U·SG, qb), unsliced as at 1M): the first `n_blocks` blocks bit for bit
    against the plain version at the engine's kg, block 0 timed; then block
    0 at the margin calibration's exhaustive kg (every group of the union,
    in passes).  Returns (block 0's record, the exhaustive one)."""
    recs = [group_select_measure(gmin[b], tb_g[b].contiguous(), probed_p[b], int(ulen[b]),
                                 unit, kg, f"{tag}, block {b}", reps=5 if b == 0 else 1)
            for b in range(min(n_blocks, gmin.shape[0]))]
    exh = group_select_measure(gmin[0], tb_g[0].contiguous(), probed_p[0], int(ulen[0]), unit,
                               gmin.shape[1], f"{tag}, block 0, exhaustive kg", reps=1)
    return recs[0], exh


def phase_group_select(dev) -> list:
    """The masked group selection (csrc/group_select.cu) against its plain
    version on synthetic blocks of the 10M cell's shape (16,384 slots of
    32 groups, ~94% live, 34 of 2048 buckets a query) and the 1M cell's
    (1,024 slots, 75% live, 8 of 1024), timed beside its bytes bound, the
    plain chain and `torch.topk`.  (phase_serving holds it on each engine's
    own K1 output and counts its launches.)  Returns the kernel records."""
    recs = []
    for tag, n_slots, live, n_bkt, n_probed, kg in (
            ("10M-shaped", 16384, 15400, 2048, 34, 52), ("1M-shaped", 1024, 768, 1024, 8, 42)):
        gmin, tb, probed = synthetic_select_block(dev, n_slots, 32, live, 1024, n_bkt,
                                                  n_probed, seed=11)
        rec = group_select_measure(gmin, tb, probed, live, 32, kg, tag)
        recs.append({
            "name": f"masked_group_topk[sel_rows=32,kg={kg},{tag} block]", "route": "cuda",
            "source": GS_SOURCE, "replaces": GS_REPLACES, "max_abs_err": 0.0,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": rec["library_ms"],
            "live_groups": rec["n_live"], "groups": rec["n_g"],
        })
        del gmin, tb, probed
        torch.cuda.empty_cache()
    return recs


def rescore_compare(neg, ids, neg_r, ids_r, q, table, tag):
    """The rescore kernel's (neg, ids) against its plain version's: scores
    within 2·d·eps32·(max‖x‖² + 2·max‖x‖·‖q‖) (the same products summed in
    another f32 order), ids equal except at slots whose plain scores lie
    within twice that of a neighbour's, or at the list's cut.  Returns (max
    |kernel − plain|, slots whose ids differ)."""
    x = table.float()
    xn = float((x * x).sum(-1).max())
    del x
    tol = 2 * table.shape[2] * EPS32 * (xn + 2 * (xn * (q * q).sum(1, keepdim=True)).sqrt())
    diff = (neg - neg_r).abs()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"rescore [{tag}]: |kernel - plain| {float(diff.max()):.3g} "
                             f"above the summation-order bound")
    near = torch.zeros_like(ids, dtype=torch.bool)
    gap = (neg_r[:, 1:] - neg_r[:, :-1]).abs() <= 2 * tol
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    near[:, -1] = True
    mism = ids != ids_r
    if bool((mism & ~near).any()):
        raise AssertionError(f"rescore [{tag}]: ids differ from the plain version's away from "
                             f"near-ties on {int((mism & ~near).any(1).sum())} queries")
    return float(diff.max()), int(mism.sum())


def rescore_measure(args, metric, k_loc, tag, reps=5) -> dict:
    """The exact rescore on one block (args: q, vals, ggrp, table, bsq,
    ids as the engine passes them): the kernel against its plain version
    (`rescore_compare`), then ms a block of the kernel, of the plain chain,
    of the library yardstick (the group gather and `torch.bmm` in the plain
    version's steps, no top-k), and two bytes bounds at 3.35 TB/s: each
    query's live selected rows read once (`query_bound_ms`) and the block's
    distinct live rows read once (`bound_ms`, the least), with the queries,
    selections, norms, ids and output."""
    from lira_tpu_torch.engine.group_rescore import (_round2_sub, exact_group_rescore,
                                                     exact_group_rescore_ref)

    q, vals, ggrp, table, bsq, ids = args
    qb, kg = ggrp.shape
    _, sel_rows, d = table.shape
    sub = _round2_sub(kg, sel_rows, d, qb)
    kw = dict(metric=metric, k_loc=k_loc)
    neg, ids_k = exact_group_rescore(*args, **kw)
    neg_r, ids_r = exact_group_rescore_ref(*args, sub=sub, **kw)
    torch.cuda.synchronize()
    err, differ = rescore_compare(neg, ids_k, neg_r, ids_r, q, table, tag)
    del neg, ids_k, neg_r, ids_r
    ms = time_ms(lambda: exact_group_rescore(*args, **kw), reps)
    plain_ms = time_ms(lambda: exact_group_rescore_ref(*args, sub=sub, **kw), 2)

    def library():
        for s0 in range(0, qb, sub):
            sg = ggrp[s0 : s0 + sub]
            vec = table[sg].float().view(sg.shape[0], kg * sel_rows, d)
            torch.bmm(vec, q[s0 : s0 + sub, :, None])

    library_ms = time_ms(library, reps)
    valid = vals > -1.5e38
    live = (ids[ggrp] >= 0) & valid[:, :, None]  # (qb, kg, sel_rows)
    row_bytes = d * table.element_size() + 8  # the row, its norm and id
    extra = qb * (d * 4 + kg * 12 + k_loc * 8)
    n_live = int(live.sum())
    n_distinct = int((ids[torch.unique(ggrp[valid])] >= 0).sum())
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=1e3 * (n_distinct * row_bytes + extra) / PEAK_BYTES,
               query_bound_ms=1e3 * (n_live * row_bytes + extra) / PEAK_BYTES,
               live_rows_per_query=n_live / qb, distinct_rows=n_distinct, max_abs_err=err,
               ids_differ=differ, qb=qb, kg=kg, d=d, k_loc=k_loc, sub=sub)
    log(f"rescore [{tag}]: {qb} queries, kg {kg}, sel_rows {sel_rows}, d {d}, "
        f"{str(table.dtype).removeprefix('torch.')}, k_loc {k_loc}: {n_live / qb:.0f} live rows "
        f"a query, {n_distinct:,} distinct; max|kernel-plain| {err:.3g}, {differ} ids apart "
        f"at near-ties; {ms:.3f} ms a block, plain {plain_ms:.3f} ms ({-(-qb // sub)} steps), "
        f"gather + bmm {library_ms:.3f} ms, bound {rec['bound_ms']:.3f} ms (distinct rows) / "
        f"{rec['query_bound_ms']:.3f} ms (each query's rows)")
    return rec


def captured_rescores(eng, x_q, thr, k, n_blocks=4):
    """The rescore's inputs on the first `n_blocks` blocks of a `search` of
    x_q, as the engine passes them (the engine's own selections, tables and
    k_loc), recorded around block_scan's call of the wrapper."""
    from lira_tpu_torch.engine import block_scan as bs

    real, calls = bs.exact_group_rescore, []

    def record(*args, **kw):
        if len(calls) < n_blocks:
            calls.append(([a.clone() for a in args[:3]] + list(args[3:]), kw))
        return real(*args, **kw)

    bs.exact_group_rescore = record
    try:
        eng.search(x_q, thr, k)
    finally:
        bs.exact_group_rescore = real
    return calls


def synthetic_rescore_block(dev, n_groups, d, qb, kg, seed, sel_rows=32):
    """A block shaped like the engine's: a Gaussian f32 table of n_groups
    groups (norms, ids, 2% −1 ids), each query's kg distinct groups drawn
    from a window of 6·kg groups that 32 consecutive queries share and that
    moves 3·kg groups every 32 queries (queries of a tour-grouped block
    share their top buckets), 1% of the slots invalid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.empty((n_groups, sel_rows, d), device=dev)
    for s0 in range(0, n_groups, 4096):
        x[s0 : s0 + 4096] = torch.randn(x[s0 : s0 + 4096].shape, generator=g, device=dev)
    ids = torch.arange(n_groups * sel_rows, device=dev, dtype=torch.int32).view(n_groups,
                                                                              sel_rows)
    ids[torch.rand(ids.shape, generator=g, device=dev) < 0.02] = -1
    bsq = torch.where(ids >= 0, (x * x).sum(-1), 3e38)
    q = torch.randn((qb, d), generator=g, device=dev)
    home = (torch.arange(qb, device=dev)[:, None] // 32) * 3 * kg
    pick = torch.argsort(torch.rand((qb, 6 * kg), generator=g, device=dev), dim=1)[:, :kg]
    ggrp = ((home + pick) % n_groups).contiguous()
    vals = -50.0 - torch.rand((qb, kg), generator=g, device=dev)
    vals[torch.rand((qb, kg), generator=g, device=dev) < 0.01] = -torch.inf
    return q, vals, ggrp, x, bsq, ids


def phase_group_rescore(dev, idx=None, run=None, k=10) -> list:
    """The exact rescore (csrc/group_rescore.cu) against its plain version
    on each cell's block shape: where phase_serving's 1M index is given,
    the first 4 blocks of a 65,536-query `search` of its int8 engine
    (kg 10 + margin, k_loc 10, d 128: the 1M cell's block) and of capacity
    mode's bf16 and int8 engines (their tables widened in the kernel),
    captured as the engine passes them; else a seeded 1M-shaped block; and
    seeded blocks of the 10M cell's shape (kg 52, k_loc 20, d 128) and
    GIST's (kg 52, k_loc 20, d 960).  Returns the kernel records."""
    from lira_tpu_torch.engine.serve import QueryEngine

    recs = []

    def record(rec, tag, table_dtype):
        recs.append({
            "name": f"exact_group_rescore[{table_dtype},kg={rec['kg']},k_loc={rec['k_loc']},"
                    f"d={rec['d']},{tag}]",
            "route": "cuda", "source": GR_SOURCE, "replaces": GR_REPLACES,
            **{key: rec[key] for key in ("max_abs_err", "ids_differ", "ms", "plain_ms",
                                         "bound_ms", "query_bound_ms", "library_ms",
                                         "live_rows_per_query", "distinct_rows")},
            "bound_by": "bytes",
        })

    if idx is not None:
        x_d, x_q, km, layout, scaler, mlp = (idx[key] for key in
                                             ("x_d", "x_q", "km", "layout", "scaler", "mlp"))
        for dt, store_f32 in (("int8", True), ("bfloat16", False), ("int8", False)):
            eng = QueryEngine(x_d, layout, km.centroids, scaler, mlp, probe_cap=128,
                              scan_impl="blocked", block_q=1024, scan_dtype=dt,
                              store_f32=store_f32, block_margin=run["results"][dt]["margin"],
                              device=dev)
            tag = f"1M main path{'' if store_f32 else ' capacity'} {dt}"
            table_dtype = "float32" if store_f32 else dt
            for b, (args, kw) in enumerate(captured_rescores(eng, x_q, run["thr"], k)):
                rec = rescore_measure(args, kw["metric"], kw["k_loc"], f"{tag}, block {b}",
                                      reps=5 if b == 0 else 1)
                if b == 0:
                    record(rec, f"{tag} block 0", table_dtype)
            del eng
            torch.cuda.empty_cache()
    shapes = [("10M-shaped", 65536, 128, 52, 20), ("GIST-shaped", 32768, 960, 52, 20)]
    if idx is None:
        shapes.insert(0, ("1M-shaped", 32768, 128, 42, 10))
    for tag, n_groups, d, kg, k_loc in shapes:
        args = synthetic_rescore_block(dev, n_groups, d, 1024, kg, seed=13)
        record(rescore_measure(args, "L2", k_loc, tag), f"{tag} block", "float32")
        del args
        torch.cuda.empty_cache()
    return recs


def set_diff(x_d, x_q, ids_a, ids_b):
    """Queries whose neighbour sets differ, split by the exact (f64)
    distances of both lists: a tie when the sorted distances agree within
    the f32 score error 2·d·eps·(‖q‖² + max‖x‖² + 2‖q‖·max‖x‖), else a
    real difference, counted by which side is nearer.  Returns (differ,
    a nearer, b nearer)."""
    rows = np.nonzero((np.sort(ids_a, axis=1) != np.sort(ids_b, axis=1)).any(axis=1))[0]
    if not len(rows):
        return 0, 0, 0
    d = x_d.shape[1]
    xn_max = float(np.einsum("nd,nd->n", x_d, x_d, dtype=np.float64).max())
    a_near = b_near = 0
    for i in rows:
        q = x_q[i].astype(np.float64)
        qn = float(q @ q)
        tol = 2 * d * EPS32 * (qn + xn_max + 2 * (qn * xn_max) ** 0.5)

        def dist(ids):
            x = x_d[np.maximum(ids, 0)].astype(np.float64)
            return np.sort(np.where(ids >= 0, ((x - q) ** 2).sum(axis=1), np.inf))

        da, db = dist(ids_a[i]), dist(ids_b[i])
        same = (da == db) | (np.abs(da - db) <= tol)
        if same.all():
            continue
        if (da <= db + tol).all():
            a_near += 1
        else:
            b_near += 1
    return len(rows), a_near, b_near


def per_query_host_steps(eng, x_q, thr):
    """Seconds of the per-query path's host steps on this batch: the probe
    with its bucket selection, and `_probe_tiles` (numpy); and the lists'
    shape."""
    t0 = time.perf_counter()
    probed = eng._select_probed(x_q, thr)
    t1 = time.perf_counter()
    tiles = eng._probe_tiles(probed)
    return t1 - t0, time.perf_counter() - t1, tiles.shape


def record_scans(eng):
    """Wrap the engine's `_scan` so that every (queries, tile lists, fetch_k)
    it is given is kept; returns that list.  `del eng._scan` restores it."""
    calls = []
    scan = eng._scan

    def record(q, tiles, fetch_k):
        calls.append((q, tiles, fetch_k))
        return scan(q, tiles, fetch_k)

    eng._scan = record
    return calls


def phase_per_query(dev, idx, run, batch=65536, k=10):
    """QueryEngine(scan_impl="pallas" / "xla") in f32 and bf16 on the
    trained index, held against the blocked f32 engine of the same run, and
    K3 alone at the main path's inputs."""
    from lira_tpu_torch.engine.pallas_scan import (invert_tile_lists, merge_topk,
                                                   pallas_probed_scan)
    from lira_tpu_torch.engine.serve import QueryEngine

    k3_wrappers = (invert_tile_lists, pallas_probed_scan, merge_topk)
    x_d, x_q, km, layout, scaler, mlp = (idx[key] for key in
                                         ("x_d", "x_q", "km", "layout", "scaler", "mlp"))
    thr, gt = run["thr"], run["gt"]
    base = run["results"]["float32"]
    r_b = base["r"]
    big = np.tile(x_q, (2, 1))  # 2 batches (4 before the 10M phase came)
    n_blocks = -(-batch // 2048)
    rng = np.random.default_rng(1)
    got, kernels = {}, []
    for impl in ("pallas", "xla"):
        for dt in ("float32", "bfloat16"):
            tag = f"{impl} {dt}"
            t0 = time.perf_counter()
            eng = QueryEngine(x_d, layout, km.centroids, scaler, mlp, probe_cap=128,
                              scan_impl=impl, scan_dtype=dt, device=dev)
            eng.search(x_q[:2048], thr, k)  # first touch: the kernel load, K3's f32 table
            log(f"engine[{tag}] built and warmed: {time.perf_counter() - t0:.1f}s")
            calls = record_scans(eng) if impl == "pallas" else None
            for fn in k3_wrappers:
                fn.launches = 0
            r = eng.search(x_q, thr, k)
            launches = {fn.__name__: fn.launches for fn in k3_wrappers}
            if calls is not None:
                del eng._scan
            r_s = eng.search_stream(big, thr, k, batch_size=batch)
            launches_s = {fn.__name__: fn.launches - launches[fn.__name__] for fn in k3_wrappers}
            want = n_blocks if impl == "pallas" else 0
            log(f"K3 launches [{tag}] (inversion, scan, merge): search {launches}, stream "
                f"{launches_s} (want {want} each per batch)")
            if (set(launches.values()) != {want} or set(launches_s.values()) != {2 * want}):
                raise AssertionError(f"[{tag}] K3 launched {launches}/{launches_s} times")
            if not (np.array_equal(r.nprobe, r_b.nprobe) and np.array_equal(r.ndis, r_b.ndis)):
                raise AssertionError(f"[{tag}] nprobe/ndis differ from the blocked engine's")
            if r.ids.shape[1] != k or not np.isfinite(r.scores[r.ids >= 0]).all():
                raise AssertionError(f"[{tag}] wrong shape or non-finite scores")
            differ, pq_near, blk_near = set_diff(x_d, x_q, r.ids, r_b.ids)
            recall = recall_at(r.ids, gt)
            log(f"serve[{tag}]: nprobe={r.nprobe.mean():.2f} ndis={r.ndis.mean():.0f} (equal "
                f"to blocked f32) recall@{k}={recall:.4f} (blocked f32 {base['recall']:.4f}); "
                f"{differ} queries with other neighbour sets than blocked f32: "
                f"{differ - pq_near - blk_near} ties, {pq_near} nearer here, {blk_near} "
                f"nearer in blocked; search {batch / r.elapsed:.0f} QPS ({r.elapsed:.3f}s), "
                f"stream {len(big) / r_s.elapsed:.0f} QPS ({r_s.elapsed:.3f}s)")
            if blk_near:
                raise AssertionError(f"[{tag}] {blk_near} queries farther than blocked f32")
            check_stream(r, r_s, batch, tag)
            check_oracle(eng, r, idx, thr, k, tag, rng)
            got[tag] = r
            if impl == "pallas":
                if dt == "float32":
                    probe_s, tiles_s, shape = per_query_host_steps(eng, x_q, thr)
                    from lira_tpu_torch import native

                    log(f"per-query host steps for {len(x_q)} queries: probe + selection "
                        f"{probe_s:.3f}s, _probe_tiles {tiles_s:.3f}s "
                        f"({'native' if native.available() else 'numpy'}) -> lists {shape}")
                kernels += k3_main_path(eng, calls, launches, dt)
            del eng, r_s
            torch.cuda.empty_cache()
    for dt in ("float32", "bfloat16"):
        differ, a_near, b_near = set_diff(x_d, x_q, got[f"pallas {dt}"].ids,
                                          got[f"xla {dt}"].ids)
        log(f"pallas vs xla [{dt}]: {differ} queries differ, {a_near + b_near} beyond a tie")
        if a_near or b_near:
            raise AssertionError(f"pallas and xla {dt} differ beyond ties")
    return kernels


def k3_parts(q, tiles, corpus, ids, sq, k, metric, table, launches, reps=10):
    """K3's list inversion and merge kernels alone on one block, each
    against its plain version: the inversion's items equal up to which of
    a tile's entries share an item (`items_canonical`), the merge's output
    exactly (its input: the plain scan's candidates).  Their records."""
    from lira_tpu_torch.engine.pallas_scan import (QCHUNK, invert_tile_lists,
                                                   invert_tile_lists_ref, items_canonical,
                                                   merge_topk, merge_topk_ref, pair_topk_ref)

    n_tiles = corpus.shape[0]
    B, T = tiles.shape
    got = invert_tile_lists(tiles, n_tiles)
    want = invert_tile_lists_ref(tiles, n_tiles)
    if not all(torch.equal(a, b) for a, b in zip(items_canonical(*got), items_canonical(*want))):
        raise AssertionError(f"K3 inversion [{table}]: the items differ from the plain version's")
    inv_ms = time_ms(lambda: invert_tile_lists(tiles, n_tiles), reps)
    inv_plain_ms = time_ms(lambda: invert_tile_lists_ref(tiles, n_tiles), reps)
    W = got[0].shape[0]
    inv_bytes = tiles.numel() * 4 + W * (QCHUNK + 1) * 4  # the lists in, the items out
    cand_v = torch.empty((B * T, k), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((B * T, k), dtype=torch.int32, device=q.device)
    pair_topk_ref(q, *got, corpus, ids, sq, cand_v, cand_i, T, metric)
    s_k, i_k = merge_topk(cand_v, cand_i, tiles, k)
    s_r, i_r = merge_topk_ref(cand_v, cand_i, tiles, k)
    if not (torch.equal(s_k, s_r) and torch.equal(i_k, i_r)):
        raise AssertionError(f"K3 merge [{table}, k={k}]: not equal to the plain version")
    merge_ms = time_ms(lambda: merge_topk(cand_v, cand_i, tiles, k), reps)
    merge_plain_ms = time_ms(lambda: merge_topk_ref(cand_v, cand_i, tiles, k), reps)
    masked = torch.where((tiles < 0).reshape(B * T, 1), 3e38, cand_v).view(B, T * k)
    topk_ms = time_ms(lambda: torch.topk(masked, k, dim=1, largest=False), reps)
    live = int((tiles >= 0).sum())
    # the merge reads the list heads and what it takes, and writes (B, k)
    merge_bytes = tiles.numel() * 4 + live * 4 + 2 * B * k * 8
    log(f"K3 inversion [{table}] at the main path's block (B={B}, T={T}, {live} live "
        f"entries, {int((got[0] >= 0).sum())} items): {inv_ms:.4f} ms, plain "
        f"{inv_plain_ms:.4f} ms, bound {1e3 * inv_bytes / PEAK_BYTES:.4f} ms (bytes); merge "
        f"k={k}: {merge_ms:.4f} ms, plain {merge_plain_ms:.4f} ms, bound "
        f"{1e3 * merge_bytes / PEAK_BYTES:.4f} ms (bytes), torch.topk {topk_ms:.4f} ms; equal to "
        f"their plain versions")
    common = dict(route="cuda", source=K3_SOURCE, max_abs_err=0.0, bound_by="bytes")
    return [
        dict(name=f"invert_tile_lists[{table}] one 2048-query block", **common,
             replaces=K3_INVERT_REPLACES, launches=launches["invert_tile_lists"], ms=inv_ms,
             plain_ms=inv_plain_ms, bound_ms=1e3 * inv_bytes / PEAK_BYTES, library_ms=None),
        dict(name=f"merge_topk[{table},k={k}] one 2048-query block", **common,
             replaces=K3_MERGE_REPLACES, launches=launches["merge_topk"], ms=merge_ms,
             plain_ms=merge_plain_ms, bound_ms=1e3 * merge_bytes / PEAK_BYTES,
             library_ms=topk_ms),
    ]


def k3_main_path(eng, calls, launches, dt):
    """K3 alone on the (queries, tile lists) that the engine's counted
    `search` gave it, block by block: one block (the median one of the
    count-sorted batch) and all of them, against the plain version, the
    gather + bmm yardstick and the xla scan on the same blocks; then its
    inversion and merge kernels alone on the median block."""
    from lira_tpu_torch.engine.pallas_scan import pallas_probed_scan, probed_scan_ref
    from lira_tpu_torch.engine.serve import _scan_probed_tiles

    fetch_k = calls[0][2]
    if (len(calls) != launches["pallas_probed_scan"] or any(f != fetch_k for _, _, f in calls)
            or fetch_k > 128):
        raise AssertionError(f"[pallas {dt}] {len(calls)} scans at fetch_k {fetch_k} for "
                             f"{launches} launches")
    blocks = [(q, torch.as_tensor(t, device=eng.device)) for q, t, _ in calls]
    args = (eng._pallas_corpus, eng.corpus_ids, eng._pallas_sq)
    table = "f32" if dt == "float32" else "bf16-rounded f32"
    mid = len(blocks) // 2
    q_m, t_m = blocks[mid]
    (s_k, i_k), (s_r, i_r), rec = k3_measure(q_m, t_m, *args, fetch_k, eng.metric, reps=5)
    tol = k3_tolerance(q_m, eng._pallas_corpus)
    err, bad = k3_compare(s_k, i_k, s_r, i_r, tol)
    log(f"K3 [pallas {dt}, {table} table] at the main path's inputs (block {mid} of "
        f"{len(blocks)}: B={q_m.shape[0]}, T={t_m.shape[1]}, k={fetch_k}): "
        f"max|kernel-plain|={err:.3g} (tol {tol:.3g}), {bad} queries with other ids; "
        f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), streamed {rec['streamed_gb']:.2f} GB ({rec['streamed_ms']:.3f} "
        f"ms at peak), library {rec['library_ms']:.3f} ms; list inversion "
        f"{rec['inversion_ms']:.3f} ms of the kernel's")
    if err > tol or bad:
        raise AssertionError(f"K3 [{dt}] main-path block: err {err} (tol {tol}), {bad} differ")
    xla_ms = time_ms(lambda: _scan_probed_tiles(q_m, t_m, eng.corpus, eng.corpus_ids,
                                                eng.corpus_sq, fetch_k, eng.metric), reps=1)

    all_ms = time_ms(lambda: [pallas_probed_scan(q, t, *args, fetch_k, eng.metric)
                              for q, t in blocks], reps=3)
    plain_all_ms = time_ms(lambda: [probed_scan_ref(q, t, *args, fetch_k, eng.metric)
                                    for q, t in blocks], reps=1)
    xla_all_ms = time_ms(lambda: [_scan_probed_tiles(q, t, eng.corpus, eng.corpus_ids,
                                                     eng.corpus_sq, fetch_k, eng.metric)
                                  for q, t in blocks], reps=1)
    lib_all_ms = sum(k3_library_ms(q, t, eng._pallas_corpus, reps=1) for q, t in blocks)
    err_all, bad_all, ops, nbytes, streamed = 0.0, 0, 0.0, 0, 0
    for q, t in blocks:
        s_k, i_k = pallas_probed_scan(q, t, *args, fetch_k, eng.metric)
        s_r, i_r = probed_scan_ref(q, t, *args, fetch_k, eng.metric)
        e, b = k3_compare(s_k, i_k, s_r, i_r, k3_tolerance(q, eng._pallas_corpus))
        err_all, bad_all = max(err_all, e), bad_all + b
        o, nb, st = k3_work(q, t, eng._pallas_corpus, fetch_k)
        ops, nbytes, streamed = ops + o, nbytes + nb, streamed + st
    t_ops, t_bytes = ops / PEAK_OPS[torch.float32], nbytes / PEAK_BYTES
    bound_all = 1e3 * max(t_ops, t_bytes)
    log(f"K3 [pallas {dt}] over the whole batch ({len(blocks)} launches, T "
        f"{min(t.shape[1] for _, t in blocks)}..{max(t.shape[1] for _, t in blocks)}): "
        f"{all_ms:.2f} ms, plain {plain_all_ms:.2f} ms, xla scan {xla_all_ms:.2f} ms, "
        f"library {lib_all_ms:.2f} ms, bound {bound_all:.3f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}), streamed {streamed / 1e9:.1f} GB "
        f"({1e3 * streamed / PEAK_BYTES:.2f} ms at peak, {streamed / all_ms / 1e9:.2f} TB/s "
        f"achieved); max|kernel-plain|={err_all:.3g}, {bad_all} queries with other ids")
    if bad_all:
        raise AssertionError(f"K3 [{dt}] whole batch: {bad_all} queries differ")
    parts = k3_parts(q_m, t_m, *args, fetch_k, eng.metric, table, launches)
    streamed_ms = 1e3 * streamed / PEAK_BYTES
    if dt == "float32" and not all_ms < streamed_ms:
        raise AssertionError(f"K3 [{dt}] whole batch: {all_ms:.2f} ms, not below the streamed "
                             f"floor {streamed_ms:.2f} ms: shared tiles are not read once")
    name = f"probed_scan[{table},{eng.metric},k={fetch_k}]"
    common = dict(route="cuda", source=K3_SOURCE, replaces=K3_REPLACES,
                  launches=launches["pallas_probed_scan"])
    return [
        dict(name=f"{name} one 2048-query block", **common, max_abs_err=err, ms=rec["ms"],
             plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
             library_ms=rec["library_ms"], xla_scan_ms=xla_ms,
             streamed_bound_ms=rec["streamed_ms"], inversion_ms=rec["inversion_ms"]),
        dict(name=f"{name} whole batch ({len(blocks)} launches)", **common,
             max_abs_err=err_all, ms=all_ms, plain_ms=plain_all_ms, bound_ms=bound_all,
             bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=lib_all_ms,
             xla_scan_ms=xla_all_ms, streamed_bound_ms=streamed_ms),
    ] + parts


def phase_capacity(dev, idx, run, batch=65536, k=10):
    """Capacity mode (store_f32=False, blocked, K1) in bf16 and int8 against
    the store_f32 engine of the same dtype in this run."""
    from lira_tpu_torch.engine.screen import union_groupmin
    from lira_tpu_torch.engine.serve import QueryEngine

    x_d, x_q, km, layout, scaler, mlp = (idx[key] for key in
                                         ("x_d", "x_q", "km", "layout", "scaler", "mlp"))
    thr, gt = run["thr"], run["gt"]
    for dt in ("bfloat16", "int8"):
        base = run["results"][dt]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = QueryEngine(x_d, layout, km.centroids, scaler, mlp, probe_cap=128,
                          scan_impl="blocked", block_q=1024, scan_dtype=dt, store_f32=False,
                          block_margin=base["margin"], device=dev)
        st = eng._block_state
        table = st.corpus_flat.numel() * st.corpus_flat.element_size()
        f32_table = st.corpus_flat.numel() * 4
        if st.corpus_flat_f32 is not st.corpus_flat:
            raise AssertionError(f"capacity[{dt}]: a second corpus table exists")
        log(f"engine[capacity {dt}] built: {time.perf_counter() - t0:.1f}s; device table "
            f"{table / 2**30:.3f} GiB = {table / f32_table:.2f}x the padded f32 table "
            f"({f32_table / 2**30:.3f} GiB)")
        union_groupmin.launches = 0
        r = eng.search(x_q, thr, k)
        launches = union_groupmin.launches
        peak = torch.cuda.max_memory_allocated()
        if launches <= 0:
            raise AssertionError(f"capacity[{dt}] did not launch K1")
        r_b = base["r"]
        if not (np.array_equal(r.nprobe, r_b.nprobe) and np.array_equal(r.ndis, r_b.ndis)):
            raise AssertionError(f"capacity[{dt}]: nprobe/ndis differ from store_f32's")
        recall = recall_at(r.ids, gt)
        differ = int((np.sort(r.ids, axis=1) != np.sort(r_b.ids, axis=1)).any(axis=1).sum())
        log(f"serve[capacity {dt}]: K1 launches {launches}, nprobe={r.nprobe.mean():.2f} "
            f"ndis={r.ndis.mean():.0f} (equal to store_f32) recall@{k}={recall:.4f} "
            f"(store_f32 {base['recall']:.4f}); {differ} of {batch} queries with other "
            f"neighbour sets; search {batch / r.elapsed:.0f} QPS ({r.elapsed:.3f}s); peak "
            f"device memory {peak / 2**30:.2f} GiB (store_f32 {base['peak'] / 2**30:.2f} GiB)")
        if recall < base["recall"] - CAPACITY_RECALL_DROP:
            raise AssertionError(f"capacity[{dt}] recall {recall} more than "
                                 f"{CAPACITY_RECALL_DROP} below store_f32's {base['recall']}")
        del eng, st
        torch.cuda.empty_cache()


def phase_ivf(dev, idx, run, k=10, m=8):
    """The IVF baseline on the same layout: prober=ivf_probe_matrix on the
    blocked f32 engine at threshold 1 − (m − 0.5)/n_bkt, so every query
    probes its m nearest centroids' buckets — the paper's comparison at
    LIRA's nprobe."""
    from lira_tpu_torch.engine.ivf_baseline import ivf_probe_matrix
    from lira_tpu_torch.engine.serve import QueryEngine

    x_d, x_q, km, layout, scaler, mlp = (idx[key] for key in
                                         ("x_d", "x_q", "km", "layout", "scaler", "mlp"))
    base = run["results"]["float32"]
    cent = np.asarray(km.centroids, np.float32)
    eng = QueryEngine(x_d, layout, cent, scaler, mlp, scan_impl="blocked", block_q=1024,
                      block_margin=base["margin"], device=dev,
                      prober=lambda q: ivf_probe_matrix(q, cent, device=dev))
    thr = 1.0 - (m - 0.5) / layout.n_bkt
    r = eng.search(x_q, thr, k)
    if not (r.nprobe == m).all():
        raise AssertionError(f"IVF: nprobe {np.unique(r.nprobe)} != {m}")
    recall = recall_at(r.ids, run["gt"])
    log(f"serve[IVF nprobe={m}]: ndis={r.ndis.mean():.0f} recall@{k}={recall:.4f}; LIRA "
        f"(trained MLP, blocked f32) nprobe={base['r'].nprobe.mean():.2f} "
        f"ndis={base['r'].ndis.mean():.0f} recall@{k}={base['recall']:.4f}; search "
        f"{len(x_q) / r.elapsed:.0f} QPS ({r.elapsed:.3f}s)")
    probed = check_oracle(eng, r, idx, thr, k, f"IVF nprobe={m}", np.random.default_rng(2))
    cd = ((x_q[: len(probed), None, :].astype(np.float64) - cent[None].astype(np.float64))
          ** 2).sum(-1)
    near = np.zeros_like(probed)
    np.put_along_axis(near, np.argsort(cd, axis=1, kind="stable")[:, :m], True, axis=1)
    if not np.array_equal(probed, near):
        raise AssertionError(f"IVF: probed buckets are not the {m} nearest centroids'")
    log(f"IVF: the probed buckets are the {m} nearest centroids' on {len(probed)} queries")
    del eng
    torch.cuda.empty_cache()


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def phase_cli(dev, idx, run, k=10, n_epoch=6, n_ivf=100_000, nprobe_ivf=16, n_ls=200_000,
              n_bkt_ls=256):
    """The CLI path at full width, all files in a temp directory: the
    trained index written as artifacts and served back through
    `run_search` (f32, bf16, int8, capacity int8) at phase 6's threshold
    and margins; the corpus written as a dataset; `python -m
    lira_tpu_torch knn` (exact, K2), `build --calibrate_margin` (K2 from
    the cache, K1 in the calibration) and `search` at the measured margins;
    `knn` in IVF mode on a 100k cut; `largescale` on a 200k cut.  The
    commands run in this process through the module's `main`, so the
    kernels' launch counts are read."""
    from lira_tpu_torch.__main__ import main as cli
    from lira_tpu_torch.config import Config
    from lira_tpu_torch.engine.screen import union_groupmin
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.io.artifacts import load_index_artifacts, save_index_artifacts
    from lira_tpu_torch.io.cache import load_knn_cache
    from lira_tpu_torch.io.datasets import DatasetBundle, write_dataset
    from lira_tpu_torch.ops.groupmin import groupmin
    from lira_tpu_torch.ops.distance import l2_to_centroids
    from lira_tpu_torch.ops.knn import drop_self, exact_knn
    from lira_tpu_torch.partition.assign import build_bucket_layout
    from lira_tpu_torch.pipelines.search_cli import run_search

    x_d, x_q, km, scaler, mlp = (idx[key] for key in ("x_d", "x_q", "km", "scaler", "mlp"))
    thr, gt, res6 = run["thr"], run["gt"], run["results"]
    n, n_gt, n_q = len(x_d), len(gt), len(x_q)
    r6 = res6["float32"]["r"]
    log(f"phase 6 at the CLI's threshold {thr:.6g}: max nprobe {int(r6.nprobe.max())} "
        f"(probe_cap 128 there, none in run_search)")
    # ground truth for the first n_gt of the batch; -1 rows never count, so
    # run_search's avg_recall over the whole batch is n_gt/n_q of theirs
    gt_pad = np.full((n_q, gt.shape[1]), -1, np.int32)
    gt_pad[:n_gt] = gt
    batch = DatasetBundle(name="smoke", base=x_d, query=x_q, groundtruth=gt_pad)
    cwd = os.getcwd()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the CLIs write ./logs/<dataset>/...
        try:
            groupmin.launches = union_groupmin.launches = 0
            union_groupmin.launches_by_dtype.clear()
            groupmin.launches_by_dtype.clear()
            # 1. the phase-5 index as artifacts, served back through run_search
            margins = {dt: {"margin": int(res6[dt]["margin"]), "sel_rows": 32}
                       for dt in ("bfloat16", "int8")}
            # n_mul 2 (an empty replica column), as phase 6's engines serve it:
            # the fetch width k·n_mul, and so int8's selection, depends on it
            d2b = np.full((n, 2), -1, np.int32)
            d2b[:, 0] = idx["assign"]
            t0 = time.perf_counter()
            prefix = save_index_artifacts(
                tmp, "smoke1m", centroids=km.centroids, data_2_bkt=d2b, x_d=x_d,
                scaler=scaler, params=mlp, extra_meta={"calibrated_margins": margins})
            t_w = time.perf_counter() - t0
            t0 = time.perf_counter()
            art = load_index_artifacts(tmp, "smoke1m")
            t_r = time.perf_counter() - t0
            log(f"artifacts: {_dir_bytes(tmp) / 2**20:.1f} MiB written in {t_w:.2f}s, read "
                f"in {t_r:.2f}s ({prefix}_*)")
            ts = torch.jit.load(prefix + "_mlp_2_input.pt", map_location=dev)
            with torch.no_grad():
                q = torch.as_tensor(x_q[:4096], device=dev)
                feats = ((l2_to_centroids(q, torch.as_tensor(km.centroids, device=dev))
                          - torch.as_tensor(scaler.mean_, device=dev))
                         / torch.as_tensor(scaler.scale_, device=dev))
                m_dev = copy.deepcopy(mlp).to(dev)
                err_pt = float((ts(feats, q) - m_dev(feats, q)).abs().max())
            log(f"_mlp_2_input.pt (torch.jit.load) vs the MLP: max|diff| {err_pt:.3g}")
            if err_pt > 1e-5:
                raise AssertionError(f"TorchScript export differs from the MLP: {err_pt}")
            del m_dev, ts
            layout = build_bucket_layout(art["data_2_bkt"], art["manifest"]["n_bkt"])
            eng = QueryEngine(art["x_d"], layout, art["centroids"], art["scaler"],
                              art["params"], probe_cap=128, block_q=1024,
                              block_margin=res6["float32"]["margin"], device=dev)
            r = eng.search(x_q, thr, k)
            differ, a_near, b_near = set_diff(x_d, x_q, r.ids, r6.ids)
            log(f"served from the artifacts [float32]: {differ} of {n_q} queries with other "
                f"neighbour sets, {a_near} nearer / {b_near} farther beyond ties")
            if not (np.array_equal(r.nprobe, r6.nprobe) and np.array_equal(r.ndis, r6.ndis)):
                raise AssertionError("artifacts: nprobe/ndis differ from phase 6's f32 engine")
            if a_near or b_near:
                raise AssertionError("artifacts: f32 neighbour sets differ beyond exact ties")
            del eng, art
            torch.cuda.empty_cache()
            for dt, cap in (("float32", False), ("bfloat16", False), ("int8", False),
                            ("int8", True)):
                t0 = time.perf_counter()
                rows = run_search(tmp, "smoke1m", "smoke", k=k, t_min=thr, t_max=thr,
                                  t_step=1.0, bundle=batch, scan_dtype=dt, capacity=cap,
                                  device=dev)
                wall = time.perf_counter() - t0
                (row,) = rows
                if dt == "float32":
                    rows_f32 = rows
                r = res6[dt]["r"]
                # run_search's recall_against, on phase 6's ids
                hits = ((r.ids[:, :, None] == gt_pad[:, None, :k])
                        & (gt_pad[:, None, :k] >= 0)).any(axis=1)
                want = (float(r.nprobe.mean()), float(r.ndis.mean()),
                        float((hits.sum(axis=1) / float(k)).mean()))
                got = (row["avg_nprobe"], row["avg_cmp"], row["avg_recall"])
                tag = f"{dt}{' capacity' if cap else ''}"
                log(f"run_search[{tag}]: nprobe {got[0]:.4f} ndis {got[1]:.1f} recall@{k} "
                    f"{got[2] * n_q / n_gt:.4f} (phase 6: {want[0]:.4f} {want[1]:.1f} "
                    f"{want[2] * n_q / n_gt:.4f}); {row['qps']:.0f} QPS; {wall:.1f}s with "
                    f"the load and the engine build")
                if got[:2] != want[:2]:
                    raise AssertionError(f"run_search[{tag}]: nprobe/ndis != phase 6's")
                if not cap and got[2] != want[2]:
                    raise AssertionError(f"run_search[{tag}]: recall != phase 6's")
                if cap and got[2] < want[2] - CAPACITY_RECALL_DROP * n_gt / n_q:
                    raise AssertionError(f"run_search[{tag}]: recall more than "
                                         f"{CAPACITY_RECALL_DROP} below phase 6's")
            counts["serve_k1"] = dict(union_groupmin.launches_by_dtype)
            # the same artifacts from 2 gloo ranks sharing the card: f32's
            # row equal to --n_shards 1's (recall, nprobe and ndis)
            t0 = time.perf_counter()
            (row2,) = run_search(tmp, "smoke1m", "smoke", k=k, t_min=thr, t_max=thr,
                                 t_step=1.0, bundle=batch, scan_dtype="float32", device=dev,
                                 n_shards=2, backend="gloo")
            (row1,) = rows_f32
            log(f"run_search[float32, --n_shards 2 --backend gloo]: nprobe "
                f"{row2['avg_nprobe']:.4f} ndis {row2['avg_cmp']:.1f} recall@{k} "
                f"{row2['avg_recall'] * n_q / n_gt:.4f} (--n_shards 1: {row1['avg_nprobe']:.4f} "
                f"{row1['avg_cmp']:.1f} {row1['avg_recall'] * n_q / n_gt:.4f}); "
                f"{row2['qps']:.0f} QPS; {time.perf_counter() - t0:.1f}s with the spawn, the "
                f"load and the builds")
            if [row2[c] for c in ("avg_nprobe", "avg_cmp", "avg_recall")] != [
                    row1[c] for c in ("avg_nprobe", "avg_cmp", "avg_recall")]:
                raise AssertionError("run_search --n_shards 2: f32 row != --n_shards 1's")

            # 2. the corpus as a dataset, and `knn` (exact: K2 on the card)
            data = os.path.join(tmp, "data")
            t0 = time.perf_counter()
            write_dataset(DatasetBundle(name="smoke", base=x_d, query=x_q[:n_gt],
                                        groundtruth=gt.astype(np.int32)), data)
            log(f"dataset smoke ({n}x{x_d.shape[1]}, {n_gt} queries with exact ground "
                f"truth): {_dir_bytes(data) / 2**20:.1f} MiB in "
                f"{time.perf_counter() - t0:.1f}s")
            groupmin.launches = 0
            t0 = time.perf_counter()
            cli(["knn", "smoke", data, str(k), "--device", dev.type])
            t_knn = time.perf_counter() - t0
            counts["knn_k2"] = groupmin.launches
            knn = load_knn_cache(data, "smoke", k, n)
            differ, a_near, b_near = set_diff(x_d, x_d, knn, idx["knn"])
            log(f"knn CLI (exact, K2): {t_knn:.1f}s, {counts['knn_k2']} K2 launches; against "
                f"phase 5's self-kNN: {differ} rows differ, {a_near + b_near} beyond ties")
            if counts["knn_k2"] != -(-n // 8192) or a_near or b_near:
                raise AssertionError("knn CLI: wrong K2 launch count or kNN != phase 5's")

            # 3. build --calibrate_margin (the knn cache read back), then search
            union_groupmin.launches = groupmin.launches = 0
            union_groupmin.launches_by_dtype.clear()
            t0 = time.perf_counter()
            cli(["build", "--device", dev.type, "--dataset", "smoke", "--data_path", data,
                 "--k", str(k),
                 "--n_bkt", str(len(km.centroids)), "--n_epoch", str(n_epoch),
                 "--batch_size", "256", "--n_mul", "1", "--duplicate_type", "None",
                 "--calibrate_margin", "true"])
            t_build = time.perf_counter() - t0
            counts["build_k1"] = dict(union_groupmin.launches_by_dtype)
            counts["build_k2"] = groupmin.launches
            cfg = Config(dataset="smoke", k=k, n_bkt=len(km.centroids), n_mul=1,
                         duplicate_type="None").update()
            with open(os.path.join(cfg.pth_log, cfg.file_name + "_manifest.json")) as f:
                cal = json.load(f)["calibrated_margins"]
            with open(os.path.join(cfg.pth_log, cfg.log_name)) as f:
                stages = [line.strip() for line in f if "time:" in line or "Epoch" in line]
            log(f"build --calibrate_margin: {t_build:.1f}s, K1 launches {counts['build_k1']}, "
                f"K2 launches {counts['build_k2']} (the kNN came from the cache); stages: "
                + "; ".join(stages))
            log("calibrated margins: " + json.dumps(
                {dt: {key: c[key] for key in ("margin", "zero_miss_margin", "sel_rows")}
                 for dt, c in cal.items()}))
            if counts["build_k2"] or set(counts["build_k1"]) != {"bfloat16", "int8"}:
                raise AssertionError("build: K2 ran though the kNN was cached, or the "
                                     "calibration did not launch K1 in bf16 and int8 alone")
            union_groupmin.launches_by_dtype.clear()
            for dt in ("float32", "bfloat16", "int8"):
                (row,) = run_search(os.path.join(tmp, cfg.pth_log), cfg.file_name, "smoke",
                                    data_path=data, k=k, t_min=thr, t_max=thr, t_step=1.0,
                                    scan_dtype=dt, device=dev)
                base = res6[dt]["recall"]
                log(f"search[{dt}] on the built index: recall@{k} {row['avg_recall']:.4f} "
                    f"(phase 6 {base:.4f}), nprobe {row['avg_nprobe']:.2f}, ndis "
                    f"{row['avg_cmp']:.0f}, {row['qps']:.0f} QPS on {n_gt} queries")
                if abs(row["avg_recall"] - base) > 0.01:
                    raise AssertionError(f"search[{dt}]: recall {row['avg_recall']} not within "
                                         f"0.01 of phase 6's {base}")
            counts["search_k1"] = dict(union_groupmin.launches_by_dtype)
            if set(counts["search_k1"]) != {"float32", "bfloat16", "int8"}:
                raise AssertionError("search on the built index did not launch K1 in "
                                     "every dtype")

            # 4. knn, IVF mode, on a 100k cut (the plain-torch per-query scan)
            cut = x_d[:n_ivf]
            write_dataset(DatasetBundle(name="smoke100k", base=cut, query=x_q[:16],
                                        groundtruth=None), data)
            t0 = time.perf_counter()
            path = cli(["knn", "smoke100k", data, str(k), str(nprobe_ivf), "--device",
                        dev.type])
            t_ivf = time.perf_counter() - t0
            ivf = np.fromfile(path, dtype=np.int32).reshape(n_ivf, k)
            _, ex = exact_knn(cut, cut, k + 1, device=dev)
            ex = drop_self(ex, k)
            rec = float((ivf[:, :, None] == ex[:, None, :]).any(2).mean())
            log(f"knn CLI (IVF, {n_ivf}x{cut.shape[1]}, n_list auto, nprobe {nprobe_ivf}): "
                f"{t_ivf:.1f}s, recall@{k} {rec:.4f} against the exact kNN")
            if rec < 0.5:  # a floor that a broken probe or scan cannot reach
                raise AssertionError(f"IVF knn recall {rec} < 0.5")

            # 5. largescale on a 200k cut, to its sweep CSV
            cut = x_d[:n_ls]
            qs = x_q[:2000]
            _, gt_ls = exact_knn(cut, qs, k, device=dev)
            write_dataset(DatasetBundle(name="smoke200k", base=cut, query=qs,
                                        groundtruth=gt_ls.astype(np.int32)), data)
            groupmin.launches = union_groupmin.launches = 0
            t0 = time.perf_counter()
            cli(["largescale", "--device", dev.type, "--dataset", "smoke200k", "--data_path",
                 data, "--k", str(k),
                 "--n_bkt", str(n_bkt_ls), "--subset_fraction", "0.05", "--batch_size", "64",
                 "--n_epoch", "30"])
            t_ls = time.perf_counter() - t0
            counts["largescale_k2"] = groupmin.launches
            cfg = Config(dataset="smoke200k", k=k, n_bkt=n_bkt_ls).update()
            csvs = sorted(os.listdir(os.path.join(cfg.pth_log,
                                                  cfg.file_name + "_tuning_threshold")))
            with open(os.path.join(cfg.pth_log, cfg.file_name + "_tuning_threshold",
                                   "model_1.csv")) as f:
                sweep = f.read().strip().splitlines()
            log(f"largescale CLI ({n_ls}x{cut.shape[1]}, {n_bkt_ls} buckets, 5% subset, "
                f"30 epochs at batch 64): "
                f"{t_ls:.1f}s, K2 launches {counts['largescale_k2']}, {csvs}; part 1 "
                f"{sweep[0]} | {sweep[1]} | {sweep[-1]}")
            if csvs != ["model_0.csv", "model_1.csv"] or counts["largescale_k2"] <= 0:
                raise AssertionError("largescale: missing sweep CSVs or no K2 launch")
            check_largescale(dev, cfg, cut, k)
            counts["k2_by_dtype"] = dict(groupmin.launches_by_dtype)
        finally:
            os.chdir(cwd)
    log(f"CLI phase launches: {counts}")
    torch.cuda.empty_cache()
    return counts


def read_csv(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def plain_redundancy_row(scores, cur, sigma, n_mul):
    """The redundancy rule for one row, in numpy: the buckets by score,
    descending (lower index first among equal scores); n_act = min(#scores
    > sigma, n_mul − 1); a row whose native bucket ranks at or past n_act
    keeps it first and adds the n_act best, else it takes the n_keep best
    (n_act, or n_act + 1 when more buckets passed sigma)."""
    order = np.argsort(-scores, kind="stable")
    n_eff = int((scores > sigma).sum())
    n_act = min(n_eff, n_mul - 1)
    loc = int(np.nonzero(order == cur)[0][0])
    if loc >= n_act:
        row = [cur] + list(order[:n_act])
    else:
        row = list(order[: n_act if n_eff == n_act else n_act + 1])
    return np.array(row + [-1] * (n_mul - len(row)), np.int32)


def check_largescale(dev, cfg, x_d, k, n_check=4096, tie=1e-5):
    """`largescale`'s answer, from its files: the MLP was trained, part 1
    only adds to part 0, and the final assignment of `n_check` sampled rows
    equals a plain recomputation of the redundancy rule from the run's own
    checkpointed MLP, centroids, scaler and native assignment.  The MLP
    runs over the whole corpus in one batch, as the pipeline's 200k-row
    batch did; a row is compared only when no score lies within `tie` of
    sigma or of its neighbour in the first n_mul + 1 ranks (a near-tie's
    order is the arithmetic's, not the rule's), and those rows are counted."""
    from lira_tpu_torch.labels.scaler import StandardScaler
    from lira_tpu_torch.models.checkpoint import load_train_state
    from lira_tpu_torch.models.train import make_train_state
    from lira_tpu_torch.ops.distance import l2_to_centroids

    epochs = read_csv(os.path.join(cfg.pth_log, cfg.df_name))
    first, last = epochs[0], epochs[-1]
    log(f"largescale epochs: {first['Epoch']} kNN recall {first['KNN Recall']} at "
        f"{first['nprobe predict']} predicted buckets -> {last['Epoch']} "
        f"{last['KNN Recall']} at {last['nprobe predict']}")
    if not (float(last["KNN Recall"]) > float(first["KNN Recall"])
            and float(last["nprobe predict"]) < float(first["nprobe predict"])):
        raise AssertionError("largescale: the MLP did not learn (kNN recall did not rise "
                             "while the predicted buckets fell)")
    sweep_dir = os.path.join(cfg.pth_log, cfg.file_name + "_tuning_threshold")
    p0, p1 = (read_csv(os.path.join(sweep_dir, f"model_{i}.csv")) for i in (0, 1))
    for a, b in zip(p0, p1):
        if (float(b["Recall"]) < float(a["Recall"]) - 1e-12
                or float(b["Computations"]) < float(a["Computations"])):
            raise AssertionError(f"largescale: part 1 below part 0 at threshold "
                                 f"{a['threshold']}: {b} vs {a}")
    log(f"largescale sweep at threshold {p0[0]['threshold']}: part 0 nprobe "
        f"{p0[0]['nprobe']} recall {p0[0]['Recall']} cmp {p0[0]['Computations']}; part 1 "
        f"nprobe {p1[0]['nprobe']} recall {p1[0]['Recall']} cmp {p1[0]['Computations']}")
    if float(p1[0]["Recall"]) < 0.9:
        raise AssertionError(f"largescale: part 1 recall {p1[0]['Recall']} < 0.9 at the "
                             f"lowest threshold (an untrained MLP gives ~0.1)")

    ckpt = os.path.join(cfg.pth_log, cfg.file_name + "_ckpt")
    centroids = np.load(os.path.join(ckpt, "kmeans.npz"))["centroids"]
    native = np.load(os.path.join(ckpt, "assign_full.npz"))["assign"]
    final = np.load(os.path.join(ckpt, "d2b_final.npz"))["d2b"]
    scaler = StandardScaler.load(cfg.pth_log, cfg.file_name)
    state, _ = load_train_state(os.path.join(ckpt, "train_state.npz"),
                                make_train_state(cfg.seed, cfg.n_bkt, x_d.shape[1],
                                                 device=dev))
    with torch.no_grad():
        xb = torch.as_tensor(x_d, device=dev)
        feats = ((l2_to_centroids(xb, torch.as_tensor(centroids, device=dev))
                  - torch.as_tensor(scaler.mean_, device=dev))
                 / torch.as_tensor(scaler.scale_, device=dev))
        scores = state.params(feats, xb).cpu().numpy()
    del xb, feats, state
    rows = np.random.default_rng(5).choice(len(x_d), n_check, replace=False)
    check_redundancy_sample(final, native, scores[rows], rows, cfg.sigma, cfg.n_mul, tie)


def check_redundancy_sample(final, native, scores, rows, sigma, n_mul, tie=1e-5):
    """The final assignment of the sampled `rows` against the plain rule
    from their MLP `scores` (one row each) and native buckets; rows with a
    score within `tie` of sigma or of a neighbour in the first n_mul + 1
    ranks are counted, not compared."""
    compared = near = 0
    for sc, i in zip(scores, rows):
        top = np.sort(sc)[::-1][: n_mul + 1]
        if np.abs(sc - sigma).min() < tie or (np.diff(top) > -tie).any():
            near += 1
            continue
        want = plain_redundancy_row(sc, int(native[i]), sigma, n_mul)
        if not np.array_equal(final[i], want):
            raise AssertionError(f"largescale: row {i} assigned {final[i]}, the plain rule "
                                 f"gives {want}")
        compared += 1
    log(f"largescale redundancy: {compared} of {len(rows)} sampled rows equal to the plain "
        f"rule ({near} near-ties not compared); replicas per row "
        f"{float((final >= 0).sum(axis=1).mean()):.3f}")
    if compared < len(rows) // 2:
        raise AssertionError(f"largescale: only {compared} rows free of near-ties")


def load_script(name: str):
    """A script of the repo's scripts/ folder as a module (not run)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", name)
    spec = importlib.util.spec_from_file_location(name.removesuffix(".py"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_largescale_10m(dev, n=10_000_000, n_bkt=2048, n_q=2048, n_epoch=40, k=10,
                         thr=0.1, batch=65536, n_check=4096, n_cal=256) -> dict:
    """scripts/torch_10m_demo.py's stages at the JAX package's own scale:
    the hard-regime corpus, exact GT, `run_largescale` (1% subset, K2's
    self-kNN, 40 epochs, full-corpus assignment and redundancy, the two
    analytic sweeps), then the final layout served by the blocked engine in
    f32 over the demo's sweep and a 65536-query batch of distinct queries
    (`query_batch`) + stream at `thr`, then bf16 and int8 at `thr` on half
    that batch (margins calibrated on `n_cal` queries over
    calibrate_block_margin's whole ladder: on 2048 queries every int8 rung
    up to 8 groups missed a neighbour, and the fallback, every group of the
    corpus, makes a 65536-query search gather the table for each query),
    each engine freed before the next.  Gates: the MLP learned, part 1 >=
    part 0, the redundancy of `n_check` sampled rows equal to the plain rule; recall
    non-increasing in the threshold and >= MIN_10M_RECALL at some swept
    threshold with ndis <= MAX_10M_NDIS of the corpus; the 64-query oracle
    and stream == per-batch search in every dtype; K1 and K2 launched.
    Returns the launches {"k2": n, dtype: K1 launches}."""
    from lira_tpu_torch.engine.calibrate import calibrate_block_margin
    from lira_tpu_torch.engine.screen import union_groupmin
    from lira_tpu_torch.ops.distance import l2_to_centroids
    from lira_tpu_torch.ops.groupmin import groupmin

    demo = load_script("torch_10m_demo.py")
    st = demo.Stages(dev, lambda m: log(f"10M {m}"))
    x_d, x_q, _ = st.run("corpus", demo.make_corpus, n, n_q, n_bkt, "hard", None, log)
    gt = st.run("exact GT", demo.ground_truth, x_d, x_q, n_bkt, "hard", dev)
    cfg = demo.demo_config(n, n_bkt, n_epoch)
    groupmin.launches = 0
    res = st.run("run_largescale", demo.build_index, x_d, x_q, gt, cfg, dev, log)
    counts = {"k2": groupmin.launches}
    log(f"10M: K2 launches in run_largescale (the subset self-kNN): {counts['k2']}")
    if counts["k2"] <= 0:
        raise AssertionError("10M: the subset self-kNN did not launch K2")

    # the untrained MLP's outputs sit near 0.5, so it predicts about half
    # of the 2048 buckets (and finds half the kNN): learning shows as fewer
    # predicted buckets at a higher kNN recall per predicted bucket
    first, last = res["epoch_rows"][0], res["epoch_rows"][-1]
    per0, per1 = (row["KNN Recall"] / max(row["nprobe predict"], 1e-9) for row in (first, last))
    log(f"10M epochs: kNN recall {first['KNN Recall']} at {first['nprobe predict']} predicted "
        f"buckets -> {last['KNN Recall']} at {last['nprobe predict']} "
        f"({per1 / max(per0, 1e-12):.1f}x the recall per predicted bucket)")
    if not (last["nprobe predict"] < first["nprobe predict"] and per1 > per0):
        raise AssertionError("10M: the MLP did not learn")
    p0, p1 = res["sweep_parts"]
    for a, b in zip(p0, p1):
        if b.recall < a.recall - 1e-12 or b.computations < a.computations:
            raise AssertionError(f"10M: part 1 below part 0 at threshold {a.threshold}: "
                                 f"{b} vs {a}")
    if p1[0].recall < 0.9:
        raise AssertionError(f"10M: part 1 recall {p1[0].recall} < 0.9 at threshold "
                             f"{p1[0].threshold}")
    rows = np.random.default_rng(5).choice(n, n_check, replace=False)
    with torch.no_grad():
        xs = torch.as_tensor(x_d[rows], device=dev)
        feats = ((l2_to_centroids(xs, torch.as_tensor(res["kmeans"].centroids, device=dev))
                  - torch.as_tensor(res["scaler"].mean_, device=dev))
                 / torch.as_tensor(res["scaler"].scale_, device=dev))
        scores = res["state"].params(feats, xs).cpu().numpy()
    check_redundancy_sample(res["data_2_bkt"], res["assign_full"], scores, rows, cfg.sigma,
                            cfg.n_mul)
    layout = res["layout"]
    elements = layout.total * x_d.shape[1]
    why = ("" if elements > LARGE_MARK else
           f"; not past it: n_mul {cfg.n_mul}, redundancy x{layout.total / n:.3f} of "
           f"{n:,} rows gives {layout.total:,} rows")
    log(f"10M layout: {layout.total:,} rows (x{layout.total / n:.3f}; JAX record "
        f"19,208,731, x1.921), {elements:,} f32 elements = {elements / LARGE_MARK:.4f} x "
        f"2^31{why}")

    idx = dict(x_d=x_d, x_q=x_q, layout=layout)
    big = demo.query_batch(x_d, x_q, batch)  # x_q, then distinct perturbed corpus rows
    rng = np.random.default_rng(0)
    for mode in ("float32", "bfloat16", "int8"):
        torch.cuda.reset_peak_memory_stats()
        eng = st.run(f"engine {mode}", demo.make_engine, x_d, res, cfg, mode, dev)
        if mode != "float32":
            t0 = time.perf_counter()
            cal = calibrate_block_margin(eng, x_q[:n_cal], thr, k)
            eng.block_margin = cal.margin
            log(f"10M calibrate[{mode}] on {n_cal} queries: zero-miss at "
                f"{cal.zero_miss_margin}, margin {cal.margin} (miss rates {cal.miss_rates}): "
                f"{time.perf_counter() - t0:.1f}s")
            if cal.zero_miss_margin is None:
                raise AssertionError(f"10M calibrate[{mode}]: no rung of {cal.ladder} is "
                                     f"zero-miss")
        union_groupmin.launches = 0
        if mode == "float32":
            served = st.run("serve float32", demo.serve, eng, x_q, gt, n,
                            demo.HARD_THRESHOLDS, thr, big, lambda m: log(f"10M {m}"))
            r = served["batch"]
            sweep = served["rows"]
            for a, b in zip(sweep, sweep[1:]):
                if b["avg_recall"] > a["avg_recall"] + 1e-12:
                    raise AssertionError(f"10M: recall rose with the threshold: {a} -> {b}")
            best = [row for row in sweep if row["avg_cmp"] <= MAX_10M_NDIS * n]
            top = max(best, key=lambda row: row["avg_recall"], default=None)
            if top is None or top["avg_recall"] < MIN_10M_RECALL:
                raise AssertionError(f"10M: no swept threshold reaches recall@{k} "
                                     f"{MIN_10M_RECALL} within ndis {MAX_10M_NDIS:.1%}: {sweep}")
            log(f"10M recall gate: {top['avg_recall']:.4f} at thr {top['threshold']} with ndis "
                f"{top['avg_cmp'] / n:.2%} (>= {MIN_10M_RECALL} within {MAX_10M_NDIS:.1%}; "
                f"JAX record {TPU_10M_RECALL} at {TPU_10M_NDIS:.2%})")
        else:
            # half the batch: a cut for the time limit
            r, _ = st.run(f"serve {mode}", demo.serve_batch, eng, big[: batch // 2], thr,
                          lambda m: log(f"10M {m}"))
        counts[mode] = union_groupmin.launches
        peak = torch.cuda.max_memory_allocated()
        recall = recall_at(r.ids[:n_q], gt)
        log(f"10M serve[{mode}] thr {thr}: margin {eng.block_margin} nprobe "
            f"{r.nprobe.mean():.2f} ndis {r.ndis.mean():.0f} ({r.ndis.mean() / n:.3%}) "
            f"recall@{k} {recall:.4f} on the {n_q} queries, batch {len(r.ids)}: "
            f"{len(r.ids) / r.elapsed:.0f} QPS, "
            f"K1 launches {counts[mode]}, peak device memory {peak / 2**30:.2f} GiB")
        if counts[mode] <= 0:
            raise AssertionError(f"10M serve[{mode}]: K1 was not launched")
        if r.ids.shape[1] != k or not np.isfinite(r.scores[r.ids >= 0]).all():
            raise AssertionError(f"10M serve[{mode}]: wrong shape or non-finite scores")
        check_oracle(eng, r, idx, thr, k, f"10M {mode}", rng, n_chk=min(256, n_q),
                     n=min(64, n_q))
        del eng, r
        torch.cuda.empty_cache()
    log("10M stages: " + ", ".join(f"{name} {sec:.1f}s" for name, sec in st.seconds.items()))
    return counts


def phase_sel_rows_memory(dev, idx, run, k=10, sels=(1, 8, 16)):
    """The 1M×128 blocked search at sel_rows 1, 8 and 16 (bf16 screen),
    where K1's output is 32×, 4× and 2× the default's: the screen budget
    (`_GMIN_BUDGET`) chunks it, and the masked selection's kernel reads it
    once a block or U-slice.  The margin is phase 6's rescaled to the same
    rows.  nprobe and ndis must equal phase 6's; the peak device memory of
    the search beyond the engine's tables must stay within 2 × _GMIN_BUDGET."""
    from lira_tpu_torch.engine import block_scan
    from lira_tpu_torch.engine.group_select import masked_group_topk
    from lira_tpu_torch.engine.screen import union_groupmin
    from lira_tpu_torch.engine.serve import QueryEngine

    x_d, x_q, km, layout, scaler, mlp = (idx[key] for key in
                                         ("x_d", "x_q", "km", "layout", "scaler", "mlp"))
    thr, gt = run["thr"], run["gt"]
    r6 = run["results"]["bfloat16"]
    for sel in sels:
        margin = int(np.ceil(r6["margin"] * 32 / sel))
        eng = QueryEngine(x_d, layout, km.centroids, scaler, mlp, probe_cap=128,
                          scan_impl="blocked", block_q=1024, scan_dtype="bfloat16",
                          block_sel_rows=sel, block_margin=margin, device=dev)
        eng.search(x_q[:1024], thr, k)  # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        union_groupmin.launches = masked_group_topk.launches = 0
        r = eng.search(x_q, thr, k)
        peak = torch.cuda.max_memory_allocated() - base
        plan = block_scan._LAST_CHUNK_PLAN
        per_block = plan["U"] * plan["sg"] * plan["qb"] * 4
        log(f"serve[bfloat16 sel_rows={sel}]: margin {margin}, recall@{k} "
            f"{recall_at(r.ids, gt):.4f} (phase 6 sel_rows=32: {r6['recall']:.4f}), "
            f"{len(x_q) / r.elapsed:.0f} QPS ({r.elapsed:.3f}s), K1 launches "
            f"{union_groupmin.launches}, selection launches {masked_group_topk.launches}; "
            f"plan {plan}: screen output "
            f"{per_block / 2**30:.3f} GiB a block row, {plan['rows_per_call']} a call "
            f"({plan['rows_per_call'] * per_block / 2**30:.2f} GiB); peak device memory "
            f"of the search beyond the engine's {base / 2**30:.2f} GiB: {peak / 2**30:.2f} "
            f"GiB (_GMIN_BUDGET {block_scan._GMIN_BUDGET / 2**30:.0f} GiB)")
        if not (np.array_equal(r.nprobe, r6["r"].nprobe)
                and np.array_equal(r.ndis, r6["r"].ndis)):
            raise AssertionError(f"sel_rows={sel}: nprobe/ndis differ from phase 6's")
        if (union_groupmin.launches <= 0 or masked_group_topk.launches <= 0
                or peak > 2 * block_scan._GMIN_BUDGET):
            raise AssertionError(f"sel_rows={sel}: no K1 or selection launch, or the "
                                 f"search's peak memory {peak} exceeds 2 × _GMIN_BUDGET")
        del eng, r
        torch.cuda.empty_cache()


def phase_smallscale(dev, n=200_000, n_query=2000, d=128, n_bkt=256, k=10, n_epoch=3):
    """The small-scale pipeline's entry point on the card, on a hard-regime
    bundle with exact ground truth."""
    from lira_tpu_torch.config import Config
    from lira_tpu_torch.engine.screen import union_groupmin
    from lira_tpu_torch.io.datasets import HARD_REGIME, synthetic_dataset
    from lira_tpu_torch.ops.groupmin import groupmin
    from lira_tpu_torch.pipelines.smallscale import run_smallscale

    t0 = time.perf_counter()
    bundle = synthetic_dataset(**HARD_REGIME, n_base=n, n_query=n_query, dim=d, k_gt=k,
                               name="smoke")
    log(f"small-scale bundle {n}x{d}, {n_query} queries with exact ground truth: "
        f"{time.perf_counter() - t0:.1f}s")
    with tempfile.TemporaryDirectory() as logdir:
        cfg = Config(dataset="smoke", k=k, n_bkt=n_bkt, n_epoch=n_epoch, n_mul=2,
                     duplicate_type="model", data_path=logdir).update()
        cfg.pth_log = logdir + "/"
        groupmin.launches = union_groupmin.launches = 0
        t0 = time.perf_counter()
        res = run_smallscale(cfg, bundle=bundle, serve_sweep=True, use_cache=False,
                             device=dev)
        wall = time.perf_counter() - t0
        k2, k1 = groupmin.launches, union_groupmin.launches
        csvs = sorted(os.path.relpath(os.path.join(r, f), logdir)
                      for r, _, fs in os.walk(logdir) for f in fs if f.endswith(".csv"))
    log(f"run_smallscale on the card: {wall:.1f}s, K2 launches {k2}, K1 launches {k1}, "
        f"{len(csvs)} CSV files")
    if k2 != -(-n // 8192) or k1 <= 0:
        raise AssertionError(f"run_smallscale: K2 launched {k2} times, K1 {k1} times")
    if len(res["epoch_rows"]) != n_epoch + 1 or len(res["sweep_parts"]) != 2 or len(csvs) != 3:
        raise AssertionError("run_smallscale: missing epoch rows, sweep parts or CSV files")
    for part, rows in enumerate(res["sweep_parts"]):
        nprobe = [r.nprobe for r in rows]
        recall = [r.recall for r in rows]
        if (any(a < b for a, b in zip(nprobe, nprobe[1:]))
                or any(a < b - 1e-12 for a, b in zip(recall, recall[1:]))):
            raise AssertionError(f"sweep part {part}: nprobe/recall do not grow as the "
                                 f"threshold falls")
        log(f"sweep part {part}: threshold {rows[0].threshold:.2f} -> nprobe "
            f"{nprobe[0]:.2f} recall {recall[0]:.4f}; threshold {rows[-1].threshold:.2f} "
            f"-> nprobe {nprobe[-1]:.2f} recall {recall[-1]:.4f}")
    last = res["epoch_rows"][-1]
    log(f"epoch table: {len(res['epoch_rows'])} rows, last {last}")
    serve = res["serve_rows"]
    log(f"serving sweep: {len(serve)} thresholds, recall {serve[0]['avg_recall']:.4f} at "
        f"nprobe {serve[0]['avg_nprobe']:.2f} .. {serve[-1]['avg_recall']:.4f} at "
        f"{serve[-1]['avg_nprobe']:.2f}")
    del res
    torch.cuda.empty_cache()


def phase_native(dev, idx, run, k=10):
    """The native host runtime (lira_tpu_torch/native, g++ at first use) on
    the trained 1M index: built and loaded; the CSR build and the
    per-query tile lists equal to the numpy branches on the same inputs;
    `_probe_tiles` seconds on one 65536-query batch and the pallas f32
    `search` QPS, native against numpy (in turns, in this process)."""
    from lira_tpu_torch import native
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.partition.assign import build_bucket_layout

    t0 = time.perf_counter()
    native.build()  # raises with g++'s output if the library does not build
    if not native.available():
        raise AssertionError("the native library built but did not load on this machine")
    log(f"native: {native.lib_path().name} loaded ({time.perf_counter() - t0:.2f}s with "
        f"the g++ build)")
    x_d, x_q, km, scaler, mlp = (idx[key] for key in ("x_d", "x_q", "km", "scaler", "mlp"))
    n_bkt, thr = idx["layout"].n_bkt, run["thr"]
    d2b = np.full((len(x_d), 2), -1, np.int32)
    d2b[:, 0] = idx["assign"]
    d2b[::7, 1] = (idx["assign"][::7] + 1) % n_bkt  # a replica column, as redundancy adds
    times = {}
    for use_native in (True, False, True, False):
        t0 = time.perf_counter()
        lay = build_bucket_layout(d2b, n_bkt, use_native=use_native)
        times.setdefault(use_native, []).append(time.perf_counter() - t0)
        if use_native:
            lay_n = lay
        else:
            lay_p = lay
    for f in ("offsets", "ids", "padded_offsets", "padded_ids"):
        if not np.array_equal(getattr(lay_n, f), getattr(lay_p, f)):
            raise AssertionError(f"native build_csr: layout {f} != the numpy branch's")
    log(f"build_bucket_layout ({len(x_d)} rows, n_mul 2, {n_bkt} buckets): native "
        f"{min(times[True]):.3f}s, numpy {min(times[False]):.3f}s; layouts equal")

    eng = QueryEngine(x_d, idx["layout"], km.centroids, scaler, mlp, probe_cap=128,
                      scan_impl="pallas", device=dev)
    eng.search(x_q[:2048], thr, k)  # first touch
    probed = eng._select_probed(x_q, thr)
    real_available = native.available
    rows, qps = {}, {}
    for path in ("native", "numpy", "native", "numpy"):
        # the numpy turns: the engine's own numpy branch, native switched off
        native.available = real_available if path == "native" else (lambda: False)
        try:
            t0 = time.perf_counter()
            tiles = eng._probe_tiles(probed)
            rows.setdefault(path, []).append(time.perf_counter() - t0)
            r = eng.search(x_q, thr, k)
            qps.setdefault(path, []).append(len(x_q) / r.elapsed)
        finally:
            native.available = real_available
        if path == "native":
            tiles_n, r_n = tiles, r
        else:
            tiles_p, r_p = tiles, r
    if not np.array_equal(tiles_n, tiles_p):
        raise AssertionError("native probe_tiles != the numpy branch's lists")
    if not np.array_equal(r_n.ids, r_p.ids):
        raise AssertionError("pallas f32 search differs between the two tile-list paths")
    log(f"_probe_tiles on {len(x_q)} queries -> lists {tiles_n.shape}: native "
        f"{min(rows['native']):.3f}s, numpy {min(rows['numpy']):.3f}s (lists equal); "
        f"pallas f32 search: native {max(qps['native']):.0f} QPS, numpy "
        f"{max(qps['numpy']):.0f} QPS (best of 2 each; the engine takes native here)")
    del eng
    torch.cuda.empty_cache()


def phase_sharded(dev, idx, run, batch=65536, k=10):
    """The sharded engine (parallel/sharded_engine.py) on the trained 1M
    index at phase 6's threshold, margins, probe_cap and block_q: 2 gloo
    ranks sharing the card in f32, bf16, int8, capacity bf16 and capacity
    int8 (one spawn), then 1 nccl rank in f32.  Each against phase 6's
    single-chip result of its dtype: nprobe and ndis exactly equal; f32
    neighbour sets equal (exact f32 ties allowed, counted), bf16/int8 the
    64-query oracle, capacity recall within CAPACITY_RECALL_DROP;
    search_stream (2 batches) == search; K1 launched on every rank (a
    2048-query warm-up search first, then the timed batch).  Two
    ranks on one card show correctness, not scaling.  Returns
    {dtype: per-rank K1 launches} of the gloo store_f32 runs, and the nccl
    run's under "float32-nccl"."""
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.parallel import launch_many, serve_rank

    x_d, x_q, km, layout, scaler = (idx[key] for key in
                                    ("x_d", "x_q", "km", "layout", "scaler"))
    mlp = copy.deepcopy(idx["mlp"]).cpu()
    thr, gt, res6 = run["thr"], run["gt"], run["results"]
    two = np.tile(x_q, (2, 1))
    modes = [("float32", True), ("bfloat16", True), ("int8", True), ("bfloat16", False),
             ("int8", False)]

    def calls(ms):
        # a first 2048-query search warms each rank (its kernel library
        # load, first allocations) before the timed batch
        reqs = [("search", (x_q[:2048], thr, k), {}), ("search", (x_q, thr, k), {}),
                ("search_stream", (two, thr, k), dict(batch_size=batch))]
        return [(serve_rank, (x_d, layout, km.centroids, scaler, mlp, reqs),
                 dict(probe_cap=128, block_q=1024, scan_dtype=dt, store_f32=f32,
                      margin=res6[dt]["margin"], local_impl="pallas")) for dt, f32 in ms]

    t0 = time.perf_counter()
    outs = launch_many(2, calls(modes), backend="gloo", device=dev.type)
    wall_gloo = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs += launch_many(1, calls([("float32", True)]), backend="nccl", device=dev.type)
    wall_nccl = time.perf_counter() - t0
    log(f"sharded spawns: 2 gloo ranks x {len(modes)} engines {wall_gloo:.1f}s, "
        f"1 nccl rank x 1 engine {wall_nccl:.1f}s (wall, with the spawn and each build)")

    oracle_eng = QueryEngine(x_d, layout, km.centroids, scaler, idx["mlp"], probe_cap=128,
                             scan_impl="xla", device=dev)
    rng = np.random.default_rng(2)
    launches = {}
    for (dt, f32), out, backend in zip(modes + [("float32", True)], outs,
                                       ["gloo"] * len(modes) + ["nccl"]):
        tag = f"sharded {backend} x{len(out['ranks'])} {dt}{'' if f32 else ' capacity'}"
        _, r, r_s = out["results"]
        base = res6[dt]
        r6 = base["r"]
        ranks = out["ranks"]
        k1 = [rk["k1_launches"] for rk in ranks]
        peaks = [rk["peak_bytes"] / 2**30 if rk["peak_bytes"] is not None else float("nan")
                 for rk in ranks]
        if any(rk["local_impl"] != "pallas" for rk in ranks) or min(k1) <= 0:
            raise AssertionError(f"[{tag}] a rank did not serve through K1: {ranks}")
        if min(rk["rescore_launches"] for rk in ranks) <= 0:
            raise AssertionError(f"[{tag}] a rank did not rescore through its kernel: {ranks}")
        if not (np.array_equal(r.nprobe, r6.nprobe) and np.array_equal(r.ndis, r6.ndis)):
            raise AssertionError(f"[{tag}] nprobe/ndis differ from phase 6's")
        if r.ids.shape[1] != k or not np.isfinite(r.scores[r.ids >= 0]).all():
            raise AssertionError(f"[{tag}] wrong shape or non-finite scores")
        check_stream(r, r_s, batch, tag)
        recall = recall_at(r.ids, gt)
        differ, a_near, b_near = set_diff(x_d, x_q, r.ids, r6.ids)
        note = ""
        if dt == "float32":
            if a_near or b_near:
                raise AssertionError(f"[{tag}] f32 neighbour sets differ from phase 6's "
                                     f"beyond exact ties ({a_near} nearer, {b_near} farther)")
            note = (f"neighbour sets equal to phase 6's ({differ} queries differ only "
                    f"by exact f32 ties)")
        elif f32:
            check_oracle(oracle_eng, r, idx, thr, k, tag, rng)
            note = f"{differ} queries with other sets than phase 6's ({a_near} nearer here)"
        else:
            if recall < base["recall"] - CAPACITY_RECALL_DROP:
                raise AssertionError(f"[{tag}] recall {recall} more than "
                                     f"{CAPACITY_RECALL_DROP} below phase 6's {base['recall']}")
            note = f"{differ} queries with other sets than phase 6's store_f32"
        log(f"serve[{tag}]: nprobe={r.nprobe.mean():.2f} ndis={r.ndis.mean():.0f} (equal to "
            f"phase 6) recall@{k}={recall:.4f} (phase 6 {base['recall']:.4f}); {note}; search "
            f"{batch / r.elapsed:.0f} QPS ({r.elapsed:.3f}s), stream {len(two) / r_s.elapsed:.0f}"
            f" QPS; K1 launches per rank {k1}; peak device memory per rank "
            f"{', '.join(f'{p:.2f}' for p in peaks)} GiB; engine build {out['build_s']:.1f}s")
        if f32:
            launches[dt if backend == "gloo" else "float32-nccl"] = k1
    del oracle_eng
    torch.cuda.empty_cache()
    return launches


def phase_distributed(dev, n=200_000, n_query=2000, d=128, n_bkt=256, k=10, n_epoch=3):
    """`python -m lira_tpu_torch distributed --n_shards 2 --backend gloo`
    (through the module's main, in this process) on the small-scale
    phase's corpus written as a dataset: the sharded self-kNN equal to the
    single-device knn_fused ("highest") on 1024 sampled rows up to exact
    ties, the sharded K-Means assignment equal to kmeans_assign of its own
    centroids, the sweep CSV written, K2 and K1 launched on each rank.
    Returns the ranks' launch counts."""
    from lira_tpu_torch.__main__ import main as cli
    from lira_tpu_torch.config import Config
    from lira_tpu_torch.io.datasets import HARD_REGIME, synthetic_dataset, write_dataset
    from lira_tpu_torch.ops.knn import drop_self
    from lira_tpu_torch.ops.knn_pallas import knn_fused
    from lira_tpu_torch.partition.kmeans import kmeans_assign

    bundle = synthetic_dataset(**HARD_REGIME, n_base=n, n_query=n_query, dim=d, k_gt=k,
                               name="smoke")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        write_dataset(bundle, os.path.join(tmp, "data"))
        os.chdir(tmp)  # the pipeline writes ./logs/<dataset>/...
        try:
            t0 = time.perf_counter()
            res = cli(["distributed", "--n_shards", "2", "--backend", "gloo", "--device",
                       dev.type, "--dataset", "smoke", "--data_path", os.path.join(tmp, "data"),
                       "--k", str(k), "--n_bkt", str(n_bkt), "--n_epoch", str(n_epoch),
                       "--n_mul", "2", "--duplicate_type", "model"])
            wall = time.perf_counter() - t0
            cfg = Config(dataset="smoke", k=k, n_bkt=n_bkt, n_epoch=n_epoch, n_mul=2,
                         duplicate_type="model").update()
            csv = os.path.join(cfg.pth_log, cfg.file_name + "_tuning_threshold",
                               "model_sharded.csv")
            with open(csv) as f:
                csv_rows = f.read().splitlines()
        finally:
            os.chdir(cwd)
    ranks = res["ranks"]
    log(f"distributed x2 gloo on the card ({n}x{d}, {n_bkt} buckets, {n_epoch} epochs): "
        f"{wall:.1f}s; per rank K2 {[r['k2_launches'] for r in ranks]}, K1 "
        f"{[r['k1_launches'] for r in ranks]}; {len(csv_rows) - 1} sweep CSV rows")
    if min(r["k2_launches"] for r in ranks) <= 0 or min(r["k1_launches"] for r in ranks) <= 0:
        raise AssertionError(f"distributed: a rank launched no K2 or no K1: {ranks}")
    if len(csv_rows) < 2 or len(res["epoch_rows"]) != n_epoch + 1:
        raise AssertionError("distributed: sweep CSV or epoch rows missing")
    x_d = bundle.base
    rows = np.random.default_rng(3).choice(n, size=1024, replace=False)
    _, ids = knn_fused(x_d, x_d[rows], k + 1, precision="highest", device=dev)
    ref = drop_self(ids, k, row_ids=rows)
    differ, a_near, b_near = set_diff(x_d, x_d[rows], res["knn_data"][rows], ref)
    log(f"sharded self-kNN vs knn_fused (highest) on 1024 rows: {differ} differ, "
        f"{a_near + b_near} beyond ties")
    if a_near or b_near:
        raise AssertionError("distributed: sharded self-kNN differs from knn_fused")
    a = kmeans_assign(x_d, res["kmeans"].centroids, device=dev)
    if not np.array_equal(a, res["assign"]):
        raise AssertionError("distributed: sharded assignment != kmeans_assign")
    serve = res["serve_rows"]
    log(f"distributed sweep: recall {serve[0]['avg_recall']:.4f} at nprobe "
        f"{serve[0]['avg_nprobe']:.2f} .. {serve[-1]['avg_recall']:.4f} at "
        f"{serve[-1]['avg_nprobe']:.2f}; sharded assignment equal to kmeans_assign")
    return ranks


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
    # one nvcc each, in parallel
    built = build(["union_groupmin", "groupmin", "probed_scan", "group_select",
                   "group_rescore"])
    log(f"built K1, K2, K3, the group selection and the rescore in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, info in built.items():
        log(f"{name}: {info['seconds']:.1f}s -> {info['path']}")
        log(info["ptxas"])
    kernel_sass_check(built)

    # the script's own f32 products (the brute-force checks, the library
    # yardsticks, the tolerances) in true fp32, as the port's f32 paths are
    with true_fp32():
        timed(phase_k1_grid, dev)
        timed(phase_k1_engine_any_width, dev)
        timed(phase_k2_grid, dev)
        timed(phase_k3_grid, dev)
        timed(phase_large_tables, dev)
        idx = timed(phase_trained_index, dev)
        kernels, run = timed(phase_serving, dev, idx)
        kernels += timed(phase_group_select, dev)
        kernels += timed(phase_group_rescore, dev, idx, run)
        kernels += timed(phase_per_query, dev, idx, run)
        timed(phase_native, dev, idx, run)
        timed(phase_capacity, dev, idx, run)
        timed(phase_ivf, dev, idx, run)
        timed(phase_sel_rows_memory, dev, idx, run)
        sharded = timed(phase_sharded, dev, idx, run)
        cli_counts = timed(phase_cli, dev, idx, run)
        del run
        kernels += idx.pop("k2")
        del idx
        for rec in kernels:  # the CLI phase's launches beside the main path's
            if rec["name"].startswith("union_groupmin"):
                dt = rec["name"].split("[")[1].split(",")[0]  # the record's screen dtype
                rec["cli_launches"] = sum(cli_counts[step].get(dt, 0) for step in
                                          ("serve_k1", "build_k1", "search_k1"))
            elif rec["name"].startswith("groupmin"):
                dt = rec["name"].split("[")[1].split(",")[0]
                rec["cli_launches"] = cli_counts["k2_by_dtype"].get(dt, 0)
        # one epoch each (three before the 10M phase came): their checks
        # count epochs, they do not read the model's quality
        timed(phase_smallscale, dev, n_epoch=1)
        dist_ranks = timed(phase_distributed, dev, n_epoch=1)
        for rec in kernels:  # the sharded path's launches, per rank
            if rec["name"].startswith("union_groupmin"):
                dt = rec["name"].split("[")[1].split(",")[0]
                rec["sharded_launches"] = sharded[dt]
                if dt == "float32":
                    rec["sharded_nccl_launches"] = sharded["float32-nccl"]
                    rec["distributed_launches"] = [r["k1_launches"] for r in dist_ranks]
            elif rec["name"] == "groupmin[float32,L2]":
                rec["sharded_knn_launches"] = [r["k2_launches"] for r in dist_ranks]
        counts_10m = timed(phase_largescale_10m, dev)
        for rec in kernels:  # the 10M phase's launches (K1 by screen dtype, K2 f32)
            if rec["name"].startswith("union_groupmin"):
                rec["largescale_10m_launches"] = counts_10m[rec["name"].split("[")[1]
                                                            .split(",")[0]]
            elif rec["name"] == "groupmin[float32,L2]":
                rec["largescale_10m_launches"] = counts_10m["k2"]
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
