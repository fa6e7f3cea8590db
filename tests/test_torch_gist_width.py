"""The port at GIST1M's width (d = 960) on the CPU, small and seeded: the
blocked engine in int8, bf16 and f32 against the benchmark's plain
reference (`annbench/reference/ann.py`, f64) within the
`gist1m.stream-int8` cell's check limits; `build_index` with the learned
redundancy (`duplicate_type "model"`, ratio 0.03) against a plain
recomputation of its rule from `infer`'s scores; and the plain round-2
rescore's steps (`group_rescore._round2_sub`) within its `_R2_BUDGET`,
counted by `rescore.steps` on the CPU (the card launches one a block)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from annbench.core import check
from annbench.data.hard_regime import HardRegime
from lira_tpu_torch import profiling
from lira_tpu_torch.engine import block_scan, group_rescore
from lira_tpu_torch.engine.serve import QueryEngine
from lira_tpu_torch.labels.scaler import scaled_centroid_distances
from lira_tpu_torch.models.train import infer, make_train_state, predict_counts
from lira_tpu_torch.partition.assign import build_bucket_layout
from lira_tpu_torch.partition.kmeans import kmeans_assign, kmeans_fit
from lira_tpu_torch.redundancy.assign import select_top_ratio

D, N, N_BKT, N_MUL, K = 960, 3000, 32, 2, 10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = os.path.join(ROOT, "annbench", "workloads", "gist1m.stream-int8.json")
CONFIG = os.path.join(ROOT, "annbench", "configs", "gist1m-lira.json")


def _data(n: int, n_q: int, seed: int):
    with open(CONFIG) as f:
        spec = dict(json.load(f)["data"], n_clusters=16, intrinsic_dim=8)
    gen = HardRegime(spec, seed, "cpu")
    return gen.corpus(n).numpy(), gen.queries(n_q).numpy()


@pytest.fixture(scope="module")
def index():
    """K-Means buckets, the nearest bucket of every row and, for 3% of the
    rows, its second nearest too (n_mul 2), a scaler and an untrained MLP
    from a seed."""
    x_d, x_q = _data(N, 256, 7)
    km = kmeans_fit(x_d, N_BKT, niter=5, seed=43, device="cpu")
    dist, _, scaler = scaled_centroid_distances(x_d, None, km.centroids, device="cpu")
    second = torch.topk(dist, 2, dim=1, largest=False).indices[:, 1].numpy()
    d2b = np.full((N, N_MUL), -1, np.int32)
    d2b[:, 0] = kmeans_assign(x_d, km.centroids, device="cpu")
    repl = np.random.default_rng(5).choice(N, N * 3 // 100, replace=False)
    d2b[repl, 1] = second[repl]
    mlp = make_train_state(11, N_BKT, D, device="cpu").model
    built = {"centroids": km.centroids, "scaler": scaler, "mlp": mlp, "data_2_bkt": d2b}
    ref = check.Reference(check.raw_index(built), x_d, "cpu")
    thr = float(np.quantile(ref.scores(x_q, "f64"), 1.0 - 4.0 / N_BKT))
    return dict(built, x_d=x_d, x_q=x_q, ref=ref, thr=thr)


def _engine(ix, dtype: str, **kw):
    return QueryEngine(ix["x_d"], build_bucket_layout(ix["data_2_bkt"], N_BKT),
                       ix["centroids"], ix["scaler"], ix["mlp"], n_mul=N_MUL,
                       scan_impl="blocked", scan_dtype=dtype, probe_cap=16, device="cpu", **kw)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_blocked_engine_against_the_reference(index, dtype):
    with open(CELL) as f:
        limits = json.load(f)["check"]["limits"]
    q = index["x_q"]
    res = _engine(index, dtype, block_q=64).search_stream(q, index["thr"], K, batch_size=128)
    want = index["ref"].answer(q, index["thr"], 16, K, "f64")
    assert want["nprobe"].mean() > 2  # the threshold probes several buckets a query
    got = {"ids": res.ids, "nprobe": res.nprobe, "ndis": res.ndis}
    numbers = check.judge(index["ref"], q, want, got, K)
    for name in ("probe_mismatch", "bad_ids", "dist_gap"):
        assert numbers[name] <= limits[name], (name, numbers)


@pytest.fixture(scope="module")
def built_with_redundancy(tmp_path_factory):
    from lira_tpu_torch.config import Config
    from lira_tpu_torch.io.artifacts import load_index_artifacts
    from lira_tpu_torch.io.datasets import DatasetBundle
    from lira_tpu_torch.pipelines.build_index import build_index

    out = str(tmp_path_factory.mktemp("gist_build"))
    x_d, _ = _data(N, 0, 3)
    cfg = Config(dataset="gistw", data_path=out, n_bkt=N_BKT, k=K, n_mul=N_MUL,
                 kmeans_niter=5, n_epoch=4, batch_size=256, lr=3e-3,
                 duplicate_type="model", redundancy_ratio=0.03, seed=43).update()
    prefix = build_index(cfg, DatasetBundle("gistw", x_d, None, None), out_dir=out,
                         use_cache=False, device="cpu")
    return cfg, x_d, load_index_artifacts(out, os.path.basename(prefix))


def _plain_rows(scores: np.ndarray, sigma: float, native: np.ndarray, n_mul: int):
    """The redundancy rule, one row at a time (`redundancy/assign.py`)."""
    out = np.full((len(scores), n_mul), -1, np.int64)
    for r, (sc, c) in enumerate(zip(scores, native)):
        ranking = np.argsort(-sc, kind="stable")
        n_eff = int((sc > sigma).sum())
        n_act = min(n_mul - 1, n_eff)
        loc = int(np.nonzero(ranking == c)[0][0])
        if loc >= n_act:
            row = [c, *ranking[:n_act]]
        elif n_eff == n_act:
            row = list(ranking[:n_act])
        else:
            row = list(ranking[: n_act + 1])
        out[r, : len(row)] = row
    return out


def test_learned_redundancy_layout(built_with_redundancy):
    cfg, x_d, art = built_with_redundancy
    d2b = art["data_2_bkt"]
    assert d2b.shape == (N, N_MUL)
    native = kmeans_assign(x_d, art["centroids"], device="cpu")
    assert ((d2b == native[:, None]).sum(1) == 1).all()  # the native bucket, once
    assert ((d2b >= 0).sum(1) <= N_MUL).all()
    dup = (d2b >= 0).sum(1) > 1
    assert 0 < dup.sum() <= int(N * cfg.redundancy_ratio)
    # the same layout from a plain recomputation of the rule on infer's scores
    dist, _, _ = scaled_centroid_distances(x_d, None, art["centroids"], scaler=art["scaler"],
                                           device="cpu")
    vec = torch.as_tensor(x_d)
    counts = predict_counts(art["params"], dist, vec, sigma=cfg.sigma)
    sel = np.sort(select_top_ratio(counts, cfg.redundancy_ratio))
    assert len(sel) == int(N * cfg.redundancy_ratio)
    _, scores = infer(art["params"], dist[torch.as_tensor(sel)], vec[sel], sigma=cfg.sigma)
    want = np.stack([native, np.full(N, -1)], 1)
    want[sel] = _plain_rows(scores, cfg.sigma, native[sel], N_MUL)
    np.testing.assert_array_equal(d2b, want)
    assert set(np.nonzero(dup)[0]) <= set(sel)


@pytest.mark.parametrize("kg,sel_rows,qb", [(52, 32, 1024), (42, 32, 1024), (26, 16, 1024),
                                            (52, 32, 64), (18, 64, 256), (4096, 128, 1024)])
def test_round2_steps_fit_the_budget(kg, sel_rows, qb):
    sub = group_rescore._round2_sub(kg, sel_rows, D, qb)
    assert sub & (sub - 1) == 0 and 1 <= sub <= qb
    staged = kg * sel_rows * D * 4
    assert sub * staged <= group_rescore._R2_BUDGET or sub == 1
    # the largest power of two that fits (or the whole block)
    assert sub == qb or 2 * sub * staged > group_rescore._R2_BUDGET


@pytest.mark.parametrize("steps_a_block", [1, 4])
def test_rescore_steps_counts_the_round2_steps(index, monkeypatch, steps_a_block):
    eng = _engine(index, "int8", block_q=64)
    q = index["x_q"][:200]  # 4 blocks of 64 (the last one part padding)
    kg = K * N_MUL + block_scan._resolve_margin(None, torch.int8, eng.block_sel_rows)
    # a budget that stages 64 / steps_a_block queries a step
    monkeypatch.setattr(group_rescore, "_R2_BUDGET",
                        kg * eng.block_sel_rows * D * 4 * 64 // steps_a_block)
    assert group_rescore._round2_sub(kg, eng.block_sel_rows, D, 64) == 64 // steps_a_block
    profiling.reset_counters()
    eng.search(q, index["thr"], K)  # no profiler records: nothing counted
    assert "rescore.steps" not in profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        res = eng.search(q, index["thr"], K)
    assert profiling.counters()["rescore.steps"] == 4 * steps_a_block
    assert (res.ids >= 0).all()
    profiling.reset_counters()


def test_query_upload_reuses_two_buffers_and_zeroes_the_pad(index):
    """`_upload_queries` writes each batch into a fresh host buffer (pinned
    on the card, where the caching host allocator reuses its blocks): a
    shorter batch leaves no row of a longer one in its pad, the host rows
    are what was uploaded, and an upload is not rewritten by later ones."""
    state = _engine(index, "int8", block_q=64)._block_state
    q = index["x_q"]
    rows1, up1 = block_scan._upload_queries(state, q[:128], 128)
    block_scan._upload_queries(state, q[128:256], 128)
    rows3, up3 = block_scan._upload_queries(state, q[200:244], 64)
    np.testing.assert_array_equal(up3[:44].numpy(), q[200:244])
    assert not bool(up3[44:].any())
    np.testing.assert_array_equal(rows3, up3.numpy())
    np.testing.assert_array_equal(up1.numpy(), q[:128])
    np.testing.assert_array_equal(rows1, q[:128])


def test_stream_with_a_shorter_last_batch_equals_search(index):
    """A stream whose last batch is shorter than the one before answers as
    each batch searched alone (the int8 scale sees no stale pad rows)."""
    eng = _engine(index, "int8", block_q=64)
    q = index["x_q"][:300]
    res = eng.search_stream(q, index["thr"], K, batch_size=128)
    parts = [eng.search(q[s : s + 128], index["thr"], K) for s in range(0, 300, 128)]
    np.testing.assert_array_equal(res.ids, np.concatenate([p.ids for p in parts]))
    assert res.scores.tobytes() == np.concatenate([p.scores for p in parts]).tobytes()
