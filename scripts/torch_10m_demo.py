"""10M×128 on one H100: the port's large-scale pipeline end to end, then a
measured blocked serving sweep (the counterpart of scripts/tpu_10m_demo.py;
imports torch and lira_tpu_torch only).

The reference treats 10M-row datasets as routine (LIRA_largescale.py,
index_batch.sh).  Stages, each timed with the device synchronised:

  1. corpus: the hard regime through `synthetic_dataset(**HARD_REGIME,
     compute_gt=False)` (byte-identical to lira_tpu's), or the easy regime
     through `gen_clustered` (the same draws as the TPU demo's copy);
  2. exact ground truth of the queries (`ops.knn.exact_knn` on the device);
  3. `run_largescale`: a 1% training subset (self-kNN through K2 at
     "highest"), K-Means, 40 epochs of the probing MLP, the full-corpus
     assignment, full-corpus learning-based redundancy and the two
     analytic sweeps;
  4. serving: the final layout in `QueryEngine(scan_impl="blocked")` (K1)
     in `mode`, the measured threshold sweep on the query set, one
     65536-query batch of distinct queries (`query_batch`: the query set,
     then perturbed corpus rows) at one mid-sweep threshold, and
     `search_stream` over the same batch in 16384-query batches, which must
     equal the `search` of each of them.

Usage:
    python scripts/torch_10m_demo.py [n] [n_bkt] [n_q] [n_epoch] [regime] [mode]
        [--device cpu|cuda] [--cache_dir DIR] [--batch 65536]
defaults 10,000,000 / 2048 / 2048 / 40 / hard / float32; mode is float32,
bfloat16, int8 or capacity (int8 table only, host re-rank).

Where the TPU demo's choices came from its 16 GB chip and its remote-compile
rig, this one takes the card's:
  * the f32 engine needs no HBM squeeze: the 19.2M-row layout is ~10 GB of
    f32 table on an 80 GB card, so every mode builds its own tables;
  * no compilation cache and no pipeline-state cache: the TPU demo cached
    the trained pipeline so that a compile-service failure or its rig's 3 h
    ceiling did not cost the ~80-min build; here the build is minutes.  The
    corpus and ground-truth caches stay (host generation is the slow
    part), opt-in through --cache_dir, with the TPU demo's file names,
    formats and `<file>.sig` sidecars, so either package's demo reads the
    other's caches when both are pointed at one directory;
  * the throughput batch is 65536 distinct queries, streamed in 4 batches
    of 16384 (the TPU demo: its 2048 queries tiled to 16384, in batches of
    4096, sized for its chip; copies in one block share one union).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lira_tpu_torch import resolve_device  # noqa: E402
from lira_tpu_torch.config import Config  # noqa: E402
from lira_tpu_torch.engine.serve import QueryEngine  # noqa: E402
from lira_tpu_torch.io.datasets import (  # noqa: E402
    HARD_REGIME,
    DatasetBundle,
    check_sig_sidecar,
    hard_regime_sig,
    synthetic_dataset,
    write_sig_sidecar,
)
from lira_tpu_torch.ops.knn import exact_knn  # noqa: E402
from lira_tpu_torch.pipelines.largescale import run_largescale  # noqa: E402

D, K = 128, 10
# the hard regime needs low thresholds for its high-recall tail
HARD_THRESHOLDS = (0.01, 0.03, 0.05, 0.1, 0.2, 0.35, 0.5, 0.7)
BATCH = 65536  # the measured batch; the stream serves it in 4 batches


def gen_clustered(n, d, n_centers, rng, scale=30.0, noise=14.0, batch=2_000_000):
    """The easy regime: separable Gaussian clusters (the TPU demo's
    generator, drawn in the same order)."""
    centers = rng.standard_normal((n_centers, d), dtype=np.float32) * scale
    x = np.empty((n, d), np.float32)
    for s in range(0, n, batch):
        e = min(s + batch, n)
        x[s:e] = centers[rng.integers(0, n_centers, size=e - s)]
        x[s:e] += rng.standard_normal((e - s, d), dtype=np.float32) * noise
    return x


def gen_sig(regime: str, n_bkt: int) -> str:
    return hard_regime_sig() if regime == "hard" else f"easy_nbkt={n_bkt}"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Stages:
    """Wall seconds per stage, the device synchronised at each end."""

    def __init__(self, dev: torch.device, log=print):
        self.dev, self.log, self.seconds = dev, log, {}

    def run(self, name: str, fn, *args, **kw):
        sync(self.dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(self.dev)
        self.seconds[name] = time.perf_counter() - t0
        self.log(f"[{name}] {self.seconds[name]:.1f}s")
        return out


def make_corpus(n: int, n_q: int, n_bkt: int, regime: str = "hard", cache_dir=None,
                log=print):
    """(x_d, x_q, fresh): the corpus and queries, from `cache_dir` when it
    holds them for this generator (the TPU demo's cache file), else drawn
    and, with a cache_dir, saved (temp file + rename, then the sidecar)."""
    sig = gen_sig(regime, n_bkt)
    cache = (None if cache_dir is None else
             os.path.join(cache_dir, f"syn10m_corpus_{regime}_{n}_{D}_{n_q}.npz"))
    if cache and os.path.exists(cache) and check_sig_sidecar(cache, sig):
        f = np.load(cache)
        if "gen_sig" not in f or str(f["gen_sig"]) == sig:
            log(f"[gen] corpus from cache {cache}")
            return f["x_d"], f["x_q"], False
    if regime == "hard":
        b = synthetic_dataset(n_base=n, n_query=n_q, dim=D, k_gt=K, compute_gt=False,
                              name=f"syn{n // 1_000_000}m-hard", **HARD_REGIME)
        x_d, x_q = b.base, b.query
    else:
        rng = np.random.default_rng(43)
        x_d = gen_clustered(n, D, n_bkt, rng)
        x_q = x_d[rng.integers(0, n, size=n_q)] + rng.standard_normal(
            (n_q, D), dtype=np.float32) * 10.0
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(cache + ".tmp.npz", x_d=x_d, x_q=x_q, gen_sig=sig)
        os.replace(cache + ".tmp.npz", cache)
        write_sig_sidecar(cache, sig)
    return x_d, x_q, True


def ground_truth(x_d, x_q, n_bkt: int, regime: str = "hard", device=None, cache_dir=None,
                 fresh: bool = True) -> np.ndarray:
    """Exact top-K ids of every query (the device's exact_knn), from the
    cache when the corpus came from it and the sidecar matches."""
    sig = gen_sig(regime, n_bkt)
    cache = (None if cache_dir is None else os.path.join(
        cache_dir, f"syn10m_gt_{regime}_{len(x_d)}_{D}_{len(x_q)}_{K}.npy"))
    if cache and not fresh and os.path.exists(cache) and check_sig_sidecar(cache, sig):
        return np.load(cache)
    _, gt = exact_knn(x_d, x_q, K, device=device)
    if cache:
        np.save(cache + ".tmp.npy", gt)
        os.replace(cache + ".tmp.npy", cache)
        write_sig_sidecar(cache, sig)
    return gt


def demo_config(n: int, n_bkt: int, n_epoch: int, regime: str = "hard") -> Config:
    """The TPU demo's Config: batch 512, lr 1e-3 (in the 1%-subset /
    2048-bucket regime the reference's 1e-4 needs ~60 epochs to leave the
    all-negative basin), t_min 0.05 hard / 0.1 easy, t_max 0.9; no log
    directory (no checkpoints, no CSVs)."""
    cfg = Config(dataset=f"syn{n // 1_000_000}m", data_path="", k=K, n_bkt=n_bkt,
                 n_epoch=n_epoch, batch_size=512, lr=1e-3,
                 t_min=0.05 if regime == "hard" else 0.1, t_max=0.9, t_step=0.1).update()
    cfg.pth_log = None
    return cfg


def build_index(x_d, x_q, gt, cfg: Config, device=None, log=print) -> dict:
    """run_largescale on the in-memory bundle; logs its analytic sweeps."""
    bundle = DatasetBundle(name=cfg.dataset, base=x_d, query=x_q, groundtruth=gt)
    res = run_largescale(cfg, bundle=bundle, use_cache=False, device=device)
    for part, rows in enumerate(res["sweep_parts"]):
        for r in rows:
            log(f"[analytic part{part}] thr={r.threshold:.2f} recall={r.recall:.4f} "
                f"nprobe={r.nprobe:.1f} ndis={r.computations:.0f}")
    return res


def make_engine(x_d, res: dict, cfg: Config, mode: str = "float32", device=None,
                **kw) -> QueryEngine:
    """The blocked engine on the pipeline's final layout (probe_cap 256, as
    the TPU demo); capacity = the int8 table alone."""
    return QueryEngine(
        x_d, res["layout"], res["kmeans"].centroids, res["scaler"], res["state"].params,
        n_mul=cfg.n_mul, scan_impl="blocked", probe_cap=256,
        scan_dtype="int8" if mode == "capacity" else mode,
        store_f32=mode != "capacity", device=device, **kw)


def query_batch(x_d, x_q, batch: int = BATCH, seed: int = 1) -> np.ndarray:
    """`batch` distinct queries: x_q, then corpus rows drawn without
    replacement, each plus isotropic noise with the hard regime's expected
    query offset (0.35 a dim in its 16-dim latent space: a norm of 1.4).
    Distinct queries keep a block's union as wide as real traffic makes
    it: the TPU demo tiled x_q, and a 1024-query block of copies shares
    the union of a few dozen queries."""
    m = batch - len(x_q)
    if m <= 0:
        return np.ascontiguousarray(x_q[:batch])
    rng = np.random.default_rng(seed)
    extra = x_d[rng.choice(len(x_d), size=m, replace=False)] + rng.standard_normal(
        (m, x_d.shape[1]), dtype=np.float32) * np.float32(1.4 / np.sqrt(x_d.shape[1]))
    return np.concatenate([x_q, extra.astype(np.float32)])


def serve_batch(eng: QueryEngine, big, thr: float, log=print):
    """One batch at `thr`: the timed `search` of the whole batch and
    `search_stream` over it in quarters, which must equal per-batch
    `search` (the stream's contract).  An f32 or bf16 screen's results do
    not depend on the batch a query came in, so the stream must equal the
    whole batch's search; an int8 screen scales each batch's queries by
    that batch's own maximum, so there each quarter's own search (run
    first) is the reference.  Returns (search result, stream result)."""
    sb = max(1, -(-len(big) // 4))
    parts = ([eng.search(big[s : s + sb], thr, K) for s in range(0, len(big), sb)]
             if eng.scan_dtype == torch.int8 else None)
    r = eng.search(big, thr, K)
    r_s = eng.search_stream(big, thr, K, batch_size=sb)
    for name in ("ids", "scores", "nprobe", "ndis"):
        want = getattr(r, name) if parts is None else np.concatenate(
            [getattr(p, name) for p in parts])
        if not np.array_equal(getattr(r_s, name), want):
            raise AssertionError(f"search_stream {name} != per-batch search at thr {thr}")
    log(f"[serve-batch] thr={thr} batch={len(big)} nprobe={r.nprobe.mean():.1f} "
        f"ndis={r.ndis.mean():.0f} QPS={len(big) / r.elapsed:.0f} ({r.elapsed:.3f}s)")
    log(f"[serve-stream] thr={thr} {-(-len(big) // sb)} batches of {sb} QPS="
        f"{len(big) / r_s.elapsed:.0f} ({r_s.elapsed:.3f}s); equal to per-batch search")
    return r, r_s


def serve(eng: QueryEngine, x_q, gt, n: int, thresholds, thr_tp: float, big, log=print) -> dict:
    """The measured sweep over the query set, then `serve_batch` of `big`
    (`query_batch`) at thr_tp."""
    rows = eng.sweep(x_q, gt, K, np.asarray(thresholds, np.float64))
    for r in rows:
        log(f"[serve] thr={r['threshold']:.2f} recall={r['avg_recall']:.4f} "
            f"nprobe={r['avg_nprobe']:.1f} ndis={r['avg_cmp']:.0f} "
            f"({100 * r['avg_cmp'] / n:.2f}% corpus) QPS={r['qps']:.0f}")
    r, r_s = serve_batch(eng, big, thr_tp, log)
    return dict(rows=rows, batch=r, stream=r_s)


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, default in (("n", 10_000_000), ("n_bkt", 2048), ("n_q", 2048),
                          ("n_epoch", 40), ("regime", "hard"), ("mode", "float32")):
        ap.add_argument(name, nargs="?", type=type(default), default=default)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--cache_dir", default=None,
                    help="corpus and ground-truth cache directory (default: no cache)")
    ap.add_argument("--batch", type=int, default=BATCH,
                    help="queries in the measured batch; the stream takes a quarter a batch")
    return ap.parse_args(argv)


def main(argv=None, thresholds=None, log=print) -> dict:
    """Runs the demo; returns its stages' outputs (corpus, ground truth, the
    pipeline's result, the engine, the serving results, stage seconds)."""
    a = parse_args(sys.argv[1:] if argv is None else argv)
    n, n_bkt, n_q = a.n, a.n_bkt, a.n_q
    dev = resolve_device(a.device)
    st = Stages(dev, log)
    log(f"[demo] n={n:,} n_bkt={n_bkt} n_q={n_q} n_epoch={a.n_epoch} regime={a.regime} "
        f"mode={a.mode} device={dev}")
    x_d, x_q, fresh = st.run("gen", make_corpus, n, n_q, n_bkt, a.regime, a.cache_dir, log)
    gt = st.run("gt", ground_truth, x_d, x_q, n_bkt, a.regime, dev, a.cache_dir, fresh)
    cfg = demo_config(n, n_bkt, a.n_epoch, a.regime)
    res = st.run("pipeline", build_index, x_d, x_q, gt, cfg, dev, log)
    layout = res["layout"]
    log(f"[layout] total rows {layout.total:,} (redundancy x{layout.total / n:.3f}); "
        f"{layout.total * D:,} f32 elements ({layout.total * D / 2**31:.3f} x 2^31)")
    eng = st.run("engine", make_engine, x_d, res, cfg, a.mode, dev)
    if thresholds is None:
        thresholds = HARD_THRESHOLDS if a.regime == "hard" else np.arange(0.15, 0.9, 0.15)
    thr_tp = 0.1 if a.regime == "hard" else 0.45
    served = st.run("serve", serve, eng, x_q, gt, n, thresholds, thr_tp,
                    query_batch(x_d, x_q, a.batch), log)
    if dev.type == "cuda":
        log(f"[memory] peak device allocation {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
            f" GiB")
    log("[stages] " + " ".join(f"{k}={v:.1f}s" for k, v in st.seconds.items()))
    return dict(x_d=x_d, x_q=x_q, gt=gt, cfg=cfg, res=res, engine=eng,
                seconds=st.seconds, **served)


if __name__ == "__main__":
    main()
