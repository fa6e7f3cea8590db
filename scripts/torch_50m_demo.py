"""50M×128 served from one H100 in int8 capacity mode (the counterpart of
scripts/tpu_50m_demo.py; imports torch and lira_tpu_torch only).

The reference's own scale ceiling is 10M rows (index_batch.sh).  This runs
a 50M×128 hard-regime corpus end to end on one card.  The int8 capacity
engine holds the corpus as one quantized table (a quarter of the f32 bytes,
~6.6 GB at 50M with 3% redundancy) that serves both scan rounds; exact
final ordering comes from a host f32 re-rank.

Stages, each timed with the device synchronised:
  1. the hard-regime corpus on the host (`synthetic_dataset`, byte-identical
     to lira_tpu's; its ambient noise drawn in row chunks);
  2. K-Means, the scaler and the probing MLP trained on a 1% subset
     (LIRA_largescale.py's regime: lr 1e-3, 40 epochs, batch 512; the
     subset's self-kNN through K2 at "highest");
  3. one streamed pass over f32 chunks, each uploaded once and used three
     times (`streamed_pass`): the exact-GT partial top-k of the queries
     (merged across chunks as `ops.knn.exact_knn_stream` merges them), the
     K-Means assignment, and the MLP's predicted-nprobe count
     (`chunk_assign_counts`, in sub-blocks that bound the (rows, n_bkt)
     workspace);
  4. learning-based redundancy on the top-3% boundary minority, scored on
     the device (`pipelines.largescale._fused_redundancy_batch`);
  5. the int8 capacity blocked engine (n_mul 2, probe_cap 256): the
     threshold sweep at nprobe ~8/16/32/64 against the exact GT (recall,
     nprobe, ndis, QPS over the query set), then `search_stream` over one
     batch of 65536 distinct queries (torch_10m_demo.query_batch: the query
     set, then perturbed corpus rows) in 4 batches.
It prints the host's memory (`free -g`) before the run, the process's peak
resident memory and the device's peak allocation.

Usage:
    python scripts/torch_50m_demo.py [n] [n_bkt] [n_q] [n_epoch] [--device cpu|cuda]
        [--cache_dir DIR] [--chunk ROWS] [--block ROWS] [--batch 65536]
defaults 50,000,000 / 4096 / 2048 / 40.

Where the TPU demo's sizes came from its 16 GB chip and its remote-compile
rig, this one takes the card's (80 GB):
  * CHUNK: 8,388,608 rows (4 GiB f32) a streamed chunk, not 2,097,152
    (1 GiB), and BLOCK 262,144 rows a sub-block, whose (rows, n_bkt) f32
    workspaces are 4 GiB each at 4096 buckets, not 65,536 (1 GiB);
  * the MLP trains on the whole 1% subset (500k rows: 8.2 GB of features
    and 2 GB of uint8 labels on the card), not on a 131,072-row sub-subset
    that the 16 GB chip could stage;
  * the tail chunk is passed as it is (torch has no compiled shapes to
    keep), so no zero padding and no pad-id mask;
  * no phase checkpoints (they survived the rig's compile-service failures
    and its 3 h ceiling) and no compilation cache; the corpus cache stays,
    opt-in through --cache_dir, with the TPU demo's file name and `.sig`
    sidecar;
  * the stream serves 65536 distinct queries in 4 batches of 16384 (the
    TPU demo: its 2048 queries tiled to 16384, in batches of 4096).
"""

from __future__ import annotations

import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lira_tpu_torch import resolve_device  # noqa: E402
from lira_tpu_torch.engine.serve import QueryEngine  # noqa: E402
from lira_tpu_torch.io.datasets import (  # noqa: E402
    HARD_REGIME,
    check_sig_sidecar,
    hard_regime_sig,
    synthetic_dataset,
    write_sig_sidecar,
)
from lira_tpu_torch.labels.distr import knn_bucket_labels  # noqa: E402
from lira_tpu_torch.labels.scaler import scaled_centroid_distances  # noqa: E402
from lira_tpu_torch.models.train import make_train_state, train_epoch  # noqa: E402
from lira_tpu_torch.ops.distance import l2_to_centroids  # noqa: E402
from lira_tpu_torch.ops.knn import exact_knn, merge_topk_host, self_knn  # noqa: E402
from lira_tpu_torch.ops.knn_pallas import self_knn_fused  # noqa: E402
from lira_tpu_torch.partition.assign import build_bucket_layout  # noqa: E402
from lira_tpu_torch.partition.kmeans import kmeans_assign, kmeans_fit  # noqa: E402
from lira_tpu_torch.pipelines.largescale import _fused_redundancy_batch  # noqa: E402
from lira_tpu_torch.redundancy.assign import select_top_ratio  # noqa: E402
from torch_10m_demo import query_batch  # noqa: E402

D, K = 128, 10
SUBSET_FRAC, RE_RATIO, SIGMA, N_MUL = 0.01, 0.03, 0.5, 2
CHUNK = 8_388_608  # rows a streamed f32 chunk (4 GiB)
BLOCK = 262_144  # rows a sub-block of the chunk program
BATCH = 65536  # the stream's queries; 4 batches


@torch.no_grad()
def chunk_assign_counts(chunk: torch.Tensor, centroids: torch.Tensor, mean: torch.Tensor,
                        scale: torch.Tensor, model, sigma: float = SIGMA,
                        block: int = BLOCK):
    """The per-chunk program: sqrt-L2 to the centroids → (argmin
    assignment, standardized features → MLP → predicted-nprobe count), in
    `block`-row sub-blocks so that the (rows, n_bkt) distance, feature and
    score matrices never exist for the whole chunk.  (m,) int32 each."""
    assign, counts = [], []
    for s in range(0, chunk.shape[0], block):
        xb = chunk[s : s + block]
        d = l2_to_centroids(xb, centroids)
        assign.append(torch.argmin(d, dim=1).to(torch.int32))
        out = model((d - mean) / scale, xb)
        counts.append((out > sigma).sum(dim=1, dtype=torch.int32))
        del d, out
    return torch.cat(assign), torch.cat(counts)


def streamed_pass(x_d: np.ndarray, x_q: np.ndarray, centroids, scaler, model, k: int = K,
                  chunk: int = CHUNK, block: int = BLOCK, device=None, log=None):
    """One pass over `chunk`-row f32 chunks of the host corpus, each
    uploaded once: (assign (n,) int32, counts (n,) int32, gt (n_q, k) int64
    global ids of the exact top-k)."""
    dev = resolve_device(device)
    n = len(x_d)
    cents = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    mean = torch.as_tensor(np.asarray(scaler.mean_, np.float32), device=dev)
    scale = torch.as_tensor(np.asarray(scaler.scale_, np.float32), device=dev)
    q_dev = torch.as_tensor(np.asarray(x_q, np.float32), device=dev)
    model = model.to(dev).eval()
    assign = np.empty(n, np.int32)
    counts = np.empty(n, np.int32)
    best_s = best_i = None
    t0 = time.perf_counter()
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        chunk_dev = torch.as_tensor(np.ascontiguousarray(x_d[s:e], np.float32), device=dev)
        a, c = chunk_assign_counts(chunk_dev, cents, mean, scale, model, block=block)
        sc, ids = exact_knn(chunk_dev, q_dev, min(k, e - s), device=dev)
        assign[s:e] = a.cpu().numpy()
        counts[s:e] = c.cpu().numpy()
        best_s, best_i = merge_topk_host(best_s, best_i, sc, ids.astype(np.int64) + s, k)
        del chunk_dev, a, c
        if log is not None:
            log(f"[pass] {e:,}/{n:,} rows ({time.perf_counter() - t0:.1f}s)")
    return assign, counts, best_i


def host_memory() -> str:
    """`free -g` of the host, or what stopped it."""
    try:
        return subprocess.run(["free", "-g"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as exc:
        return f"free -g: {exc}"


def peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, default in (("n", 50_000_000), ("n_bkt", 4096), ("n_q", 2048),
                          ("n_epoch", 40)):
        ap.add_argument(name, nargs="?", type=int, default=default)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--cache_dir", default=None,
                    help="corpus cache directory (default: no cache)")
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--block", type=int, default=BLOCK)
    ap.add_argument("--batch", type=int, default=BATCH)
    return ap.parse_args(argv)


def main(argv=None, log=print) -> dict:
    a = parse_args(sys.argv[1:] if argv is None else argv)
    n, n_bkt, n_q, n_epoch = a.n, a.n_bkt, a.n_q, a.n_epoch
    dev = resolve_device(a.device)
    sig = hard_regime_sig()
    rng = np.random.default_rng(43)
    seconds = {}

    def stage(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        log(f"[{name}] {seconds[name]:.1f}s; peak host RSS {peak_rss_gib():.1f} GiB")

    log(f"[demo] n={n:,} n_bkt={n_bkt} n_q={n_q} n_epoch={n_epoch} device={dev} "
        f"chunk={a.chunk:,} block={a.block:,}")
    log(f"[host] before the run:\n{host_memory()}")

    # ---- 1. corpus (host) ----
    t0 = time.perf_counter()
    cache = (None if a.cache_dir is None else
             os.path.join(a.cache_dir, f"syn50m_corpus_{n}_{D}_{n_q}.npz"))
    if cache and os.path.exists(cache) and check_sig_sidecar(cache, sig):
        f = np.load(cache)
        x_d, x_q = f["x_d"], f["x_q"]
        log(f"[gen] corpus from cache {cache}")
    else:
        b = synthetic_dataset(n_base=n, n_query=n_q, dim=D, k_gt=K, compute_gt=False,
                              name=f"syn{n // 1_000_000}m-hard", **HARD_REGIME)
        x_d, x_q = b.base, b.query
        del b
        if cache:
            os.makedirs(a.cache_dir, exist_ok=True)
            np.savez(cache + ".tmp.npz", x_d=x_d, x_q=x_q)
            os.replace(cache + ".tmp.npz", cache)
            write_sig_sidecar(cache, sig)
    stage("gen", t0)

    # ---- 2. subset training: K-Means, scaler, probing MLP ----
    t0 = time.perf_counter()
    n_sub = int(n * SUBSET_FRAC)
    sub_idx = np.sort(rng.choice(n, size=n_sub, replace=False))
    subset = np.ascontiguousarray(x_d[sub_idx])
    km = kmeans_fit(subset, n_bkt, niter=20, seed=43, device=dev)
    assign_sub = kmeans_assign(subset, km.centroids, device=dev)
    stage("kmeans", t0)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        knn_sub = self_knn_fused(subset, K, precision="highest", device=dev)  # K2
    else:
        knn_sub = self_knn(subset, K, device=dev)
    labels = knn_bucket_labels(knn_sub, assign_sub.reshape(-1, 1), n_bkt)
    dist_sub, _, scaler = scaled_centroid_distances(subset, None, km.centroids, device=dev)
    stage("self_knn_labels", t0)
    t0 = time.perf_counter()
    state = make_train_state(43, n_bkt, D, lr=1e-3, device=dev)
    vec_tr = torch.as_tensor(subset, device=dev)
    lab_tr = torch.as_tensor(labels, device=dev)
    del labels
    for ep in range(n_epoch):
        state, loss = train_epoch(state, dist_sub, vec_tr, lab_tr, batch_size=512)
        if ep % 10 == 0 or ep == n_epoch - 1:
            log(f"[train] epoch {ep} loss {loss:.5f}")
    del dist_sub, vec_tr, lab_tr, subset
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stage("train", t0)
    model = state.params

    # ---- 3. one streamed pass: GT partials + assignment + counts ----
    t0 = time.perf_counter()
    assign, counts, gt = streamed_pass(x_d, x_q, km.centroids, scaler, model, K,
                                       chunk=a.chunk, block=a.block, device=dev, log=log)
    stage("pass", t0)

    # ---- 4. redundancy on the top-3% boundary minority ----
    t0 = time.perf_counter()
    d2b = np.full((n, N_MUL), -1, np.int32)
    d2b[:, 0] = assign
    selected = np.sort(select_top_ratio(counts, RE_RATIO))
    cj = torch.as_tensor(np.asarray(km.centroids, np.float32), device=dev)
    mean = torch.as_tensor(np.asarray(scaler.mean_, np.float32), device=dev)
    scale = torch.as_tensor(np.asarray(scaler.scale_, np.float32), device=dev)
    budget_rows = max(1 << 14, (1 << 32) // (n_bkt * 8))
    for s in range(0, len(selected), budget_rows):
        sl = selected[s : s + budget_rows]
        d2b[sl] = _fused_redundancy_batch(
            model, cj, mean, scale, torch.as_tensor(x_d[sl], device=dev),
            torch.as_tensor(d2b[sl, 0], device=dev), SIGMA, N_MUL).cpu().numpy()
    layout = build_bucket_layout(d2b, n_bkt)
    stage("redundancy", t0)
    log(f"[redundancy] {len(selected):,} boundary rows scored; table {layout.total:,} rows "
        f"(x{layout.total / n:.3f}), {layout.total * D / 2**30:.2f} GiB int8")

    # ---- 5. int8-capacity engine + measured sweep ----
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    eng = QueryEngine(x_d, layout, km.centroids, scaler, model, n_mul=N_MUL,
                      scan_impl="blocked", probe_cap=256, scan_dtype="int8",
                      store_f32=False, device=dev)
    stage("engine", t0)
    table = eng._block_state.corpus_flat
    log(f"[engine] int8 capacity table {tuple(table.shape)}: "
        f"{table.numel() * table.element_size() / 2**30:.2f} GiB on the device")

    t0 = time.perf_counter()
    outputs = eng.probe(x_q[:512])
    sweep = []
    for target in [t for t in (8, 16, 32, 64) if t <= n_bkt]:
        thr = float(np.quantile(outputs, 1.0 - target / n_bkt))
        eng.search(x_q, thr, K)  # first-touch allocations out of the timing
        r = eng.search(x_q, thr, K)
        recall = float((r.ids[:, :, None] == gt[:, None, :K]).any(axis=1).mean())
        row = dict(target=target, threshold=thr, nprobe=float(r.nprobe.mean()),
                   ndis=float(r.ndis.mean()), recall=recall, qps=n_q / r.elapsed)
        sweep.append(row)
        log(f"[serve] nprobe~{row['nprobe']:.1f} ndis={row['ndis']:.0f} "
            f"({100 * row['ndis'] / n:.3f}% corpus) recall@{K}={recall:.4f} "
            f"QPS={row['qps']:.0f} ({1e6 / row['qps']:.0f} us/q)")
    big = query_batch(x_d, x_q, a.batch)
    thr = float(np.quantile(outputs, 1.0 - min(16, n_bkt) / n_bkt))
    sb = max(1, a.batch // 4)
    eng.search_stream(big[:sb], thr, K, batch_size=sb)
    r_s = eng.search_stream(big, thr, K, batch_size=sb)
    log(f"[serve-stream] batch={len(big)} in batches of {sb}: nprobe={r_s.nprobe.mean():.1f} "
        f"ndis={r_s.ndis.mean():.0f} QPS={len(big) / r_s.elapsed:.0f}")
    stage("serve", t0)
    peak_dev = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    log(f"[memory] peak host RSS {peak_rss_gib():.1f} GiB; peak device allocation of the "
        f"engine and serving {peak_dev:.2f} GiB")
    log("[stages] " + " ".join(f"{k}={v:.1f}s" for k, v in seconds.items()))
    return dict(x_d=x_d, x_q=x_q, gt=gt, layout=layout, engine=eng, sweep=sweep,
                stream=r_s, seconds=seconds)


if __name__ == "__main__":
    main()
