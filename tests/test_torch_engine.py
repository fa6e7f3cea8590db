"""The blocked serving engine: lira_tpu_torch (device="cpu") against
lira_tpu (Pallas in interpret mode) on one layout, one set of centroids,
one scaler and one set of MLP parameters (carried across with
params_from_jax).

Held equal exactly: nprobe, ndis and each query's neighbour-id set.  Scores
are allclose with atol 1e-4 (rtol 1e-5): both rank by ‖x‖² − 2·x·q in f32
at d=16, summed in different orders, so they differ by a few ulps of
values ~10-100.  Thresholds sit at midpoints between sorted probe outputs
with a gap ≥ 1e-5, so a last-bit difference in the MLP cannot flip a
bucket.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lira_tpu.engine import block_scan as jbs
from lira_tpu.engine.calibrate import calibrate_block_margin as j_calibrate
from lira_tpu.engine.serve import QueryEngine as JaxEngine
from lira_tpu.labels.scaler import StandardScaler
from lira_tpu.models.probing_mlp import init_params
from lira_tpu.ops.distance import l2_to_centroids
from lira_tpu.partition.assign import build_bucket_layout as j_layout
from lira_tpu.partition.kmeans import kmeans_fit
from lira_tpu_torch.engine import block_scan as tbs
from lira_tpu_torch.engine import group_select as tgs
from lira_tpu_torch.engine.calibrate import autotune_block_q, calibrate_block_margin
from lira_tpu_torch.engine.serve import QueryEngine as TorchEngine
from lira_tpu_torch.models.probing_mlp import params_from_jax
from lira_tpu_torch.partition.assign import build_bucket_layout as t_layout

K = 5


@pytest.fixture(scope="module")
def index():
    """tests/test_block_scan.py's _build inputs: n_mul=2 with a replicated
    slice of points (exercises dedup to k distinct)."""
    return _build_index(16)


@pytest.fixture(scope="module")
def index37():
    """The same recipe at d = 37, which is not a multiple of 4 (the int8
    table is zero-padded to 40 columns)."""
    return _build_index(37)


def _build_index(dim):
    rng = np.random.default_rng(43)
    n, n_bkt, n_mul = 1600, 7, 2
    x_d = rng.normal(size=(n, dim)).astype(np.float32)
    x_q = rng.normal(size=(33, dim)).astype(np.float32)
    d2b = np.full((n, n_mul), -1, dtype=np.int32)
    d2b[:, 0] = rng.integers(0, n_bkt, size=n)
    repl = rng.integers(0, n, size=n // 10)
    d2b[repl, 1] = (d2b[repl, 0] + 1) % n_bkt
    km = kmeans_fit(x_d, n_bkt, niter=3, seed=0)
    raw = np.asarray(l2_to_centroids(jnp.asarray(x_d), jnp.asarray(km.centroids)))
    scaler = StandardScaler().fit(raw)
    params = init_params(jax.random.PRNGKey(0), n_bkt, dim)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    return dict(x_d=x_d, x_q=x_q, d2b=d2b, n_bkt=n_bkt, n_mul=n_mul,
                centroids=km.centroids, scaler=scaler, params=params,
                params_np=params_np)


def _engines(ix, metric="L2", **kw):
    common = dict(metric=metric, n_mul=ix["n_mul"], scan_impl="blocked", **kw)
    e_j = JaxEngine(ix["x_d"], j_layout(ix["d2b"], ix["n_bkt"], tile=128),
                    ix["centroids"], ix["scaler"], ix["params"], **common)
    e_t = TorchEngine(ix["x_d"], t_layout(ix["d2b"], ix["n_bkt"], tile=128),
                      ix["centroids"], ix["scaler"], params_from_jax(ix["params_np"]),
                      device="cpu", **common)
    return e_j, e_t


def _thresholds(outputs: np.ndarray) -> list[float]:
    """0 (every bucket), plus midpoints near the 50% and 80% quantiles of the
    probe outputs whose neighbours are ≥ 1e-5 apart."""
    v = np.unique(outputs.ravel())
    out = [0.0]
    for frac in (0.5, 0.8):
        j = int(frac * (len(v) - 1))
        while j + 1 < len(v) and v[j + 1] - v[j] < 1e-5:
            j += 1
        out.append(float((v[j] + v[j + 1]) / 2))
    return out


def _assert_same(r_j, r_t, tag):
    np.testing.assert_array_equal(r_j.nprobe, r_t.nprobe, err_msg=str(tag))
    np.testing.assert_array_equal(r_j.ndis, r_t.ndis, err_msg=str(tag))
    for i in range(len(r_j.ids)):
        a, b = r_j.ids[i], r_t.ids[i]
        assert set(a[a >= 0]) == set(b[b >= 0]), (tag, i)
    s_j, s_t = np.sort(r_j.scores, axis=1), np.sort(r_t.scores, axis=1)
    np.testing.assert_array_equal(np.isfinite(s_j), np.isfinite(s_t))
    fin = np.isfinite(s_j)
    np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=1e-5, atol=1e-4, err_msg=str(tag))


@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
def test_blocked_engine_matches_lira_tpu(index, metric, scan_dtype):
    e_j, e_t = _engines(index, metric, scan_dtype=scan_dtype)
    out_j, out_t = e_j.probe(index["x_q"]), e_t.probe(index["x_q"])
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)
    for thr in _thresholds(out_j):
        _assert_same(e_j.search(index["x_q"], thr, K), e_t.search(index["x_q"], thr, K),
                     (metric, scan_dtype, thr))


@pytest.mark.parametrize("dim,scan_dtype,sel_rows,store_f32", [
    (37, "int8", None, True), (37, "int8", None, False), (37, "int8", 16, True),
    (16, "float32", 8, True), (16, "float32", 16, True), (16, "bfloat16", 8, True),
    (16, "bfloat16", 16, True), (16, "int8", 8, True), (16, "int8", 16, True),
    (16, "float32", 1, True), (16, "bfloat16", 1, True), (16, "int8", 1, True),
])
def test_blocked_engine_any_width_and_group_size(index, index37, dim, scan_dtype, sel_rows,
                                                 store_f32):
    """Blocked int8 at d = 37 (store_f32 and capacity mode), and selection
    groups of 1, 8 and 16 rows in every dtype: what K1 took only at d % 4 ==
    0 and sel_rows 32/64/128 before."""
    ix = index37 if dim == 37 else index
    e_j, e_t = _engines(ix, scan_dtype=scan_dtype, block_sel_rows=sel_rows,
                        store_f32=store_f32)
    if scan_dtype == "int8":
        assert e_t._block_state.corpus_flat.shape[1] == (40 if dim == 37 else dim)
    out_j = e_j.probe(ix["x_q"])
    for thr in _thresholds(out_j):
        _assert_same(e_j.search(ix["x_q"], thr, K), e_t.search(ix["x_q"], thr, K),
                     (dim, scan_dtype, sel_rows, store_f32, thr))


def test_probe_cap_selection_matches(index):
    e_j, e_t = _engines(index, probe_cap=3, block_q=8)
    thr = _thresholds(e_j.probe(index["x_q"]))[1]
    np.testing.assert_array_equal(
        e_t._select_probed(index["x_q"], thr),
        e_j._select_probed(jnp.asarray(index["x_q"]), thr),
    )
    _assert_same(e_j.search(index["x_q"], thr, K), e_t.search(index["x_q"], thr, K), "cap")


def test_block_row_and_union_chunking_match(index, monkeypatch):
    """_GMIN_BUDGET forces both chunking branches of _screen_rescore: two
    block rows per screen call, then one-supertile union slices with the
    running top-kg merge.  Results stay those of lira_tpu unchunked."""
    e_j, e_t = _engines(index, block_q=8)  # 33 queries → 5 blocks
    thr = _thresholds(e_j.probe(index["x_q"]))[1]
    r_j = e_j.search(index["x_q"], thr, K)
    e_t.search(index["x_q"], thr, K)
    plan0 = tbs._LAST_CHUNK_PLAN
    assert plan0["u_chunk"] >= plan0["U"] and plan0["rows_per_call"] == plan0["n_blocks"]

    monkeypatch.setattr(tbs, "_GMIN_BUDGET", 2 * plan0["U"] * plan0["sg"] * plan0["qb"] * 4)
    _assert_same(r_j, e_t.search(index["x_q"], thr, K), "rows")
    plan = tbs._LAST_CHUNK_PLAN
    assert plan["u_chunk"] >= plan["U"] and plan["rows_per_call"] == 2

    monkeypatch.setattr(tbs, "_GMIN_BUDGET", 1)
    for t in (0.0, thr):
        _assert_same(e_j.search(index["x_q"], t, K), e_t.search(index["x_q"], t, K),
                     ("union", t))
        plan = tbs._LAST_CHUNK_PLAN
        assert plan["u_chunk"] == 1 and plan["U"] >= 2, plan


@pytest.mark.parametrize("sel_rows", [1, 32])
def test_selection_in_query_slices_matches(index, monkeypatch, sel_rows):
    """_SEL_BUDGET at one query's groups: the plain masked selection runs
    one query at a time, and the results stay those of lira_tpu."""
    e_j, e_t = _engines(index, scan_dtype="bfloat16", block_sel_rows=sel_rows, block_q=8)
    monkeypatch.setattr(tgs, "_SEL_BUDGET", 1)
    for thr in _thresholds(e_j.probe(index["x_q"]))[:2]:
        _assert_same(e_j.search(index["x_q"], thr, K), e_t.search(index["x_q"], thr, K),
                     (sel_rows, thr))


@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_search_stream_equals_per_batch_search(index, scan_dtype):
    _, e_t = _engines(index, scan_dtype=scan_dtype, block_q=8)
    x_q = np.concatenate([index["x_q"], index["x_q"][::-1]])  # 66 queries
    thr = _thresholds(e_t.probe(x_q))[1]
    r_s = e_t.search_stream(x_q, thr, K, batch_size=16)
    parts = [e_t.search(x_q[s : s + 16], thr, K) for s in range(0, len(x_q), 16)]
    for name in ("ids", "scores", "nprobe", "ndis"):
        np.testing.assert_array_equal(
            getattr(r_s, name), np.concatenate([getattr(p, name) for p in parts]),
            err_msg=name,
        )


def test_query_cache_needs_the_same_batch_length(index):
    """A re-searched batch reuses its upload only at the same length: a
    longer batch with the same prefix and padded size would leave its extra
    rows in the pad, where the int8 scale over the padded batch sees them.
    (lira_tpu's cache has that fault: ROADMAP.md section C.)"""
    _, e_t = _engines(index, scan_dtype="int8", block_q=8)
    x_q = index["x_q"]  # 33 queries: 40 rows padded at qb=8
    longer = np.concatenate([x_q, 50.0 * x_q[:5]])  # 38 rows: also 40 padded
    r0 = e_t.search(x_q, 0.0, K)
    e_t.search(longer, 0.0, K)
    h = tbs._probe_batch(e_t._block_state, e_t, x_q, 0.0, 8, use_cache=True)
    assert h["q"].shape == (40, x_q.shape[1]) and not bool(h["q"][33:].any())
    e_t.search(longer, 0.0, K)
    r1 = e_t.search(x_q, 0.0, K)
    assert r1.scores.tobytes() == r0.scores.tobytes()
    np.testing.assert_array_equal(r1.ids, r0.ids)


def test_wire_contracts(index):
    """pack32 and f32 return identical bits; bf16 rounds the scores only."""
    _, e_t = _engines(index, wire="pack32")
    _, e_f = _engines(index, wire="f32")
    _, e_b = _engines(index, wire="bf16")
    r_p, r_f, r_b = (e.search(index["x_q"], 0.0, K) for e in (e_t, e_f, e_b))
    assert r_p.scores.tobytes() == r_f.scores.tobytes()
    np.testing.assert_array_equal(r_p.ids, r_b.ids)
    import torch

    want = torch.from_numpy(r_p.scores).bfloat16().float().numpy()
    np.testing.assert_array_equal(r_b.scores, want)


def test_margin_calibration_matches(index):
    e_j, e_t = _engines(index, scan_dtype="bfloat16")
    thr = _thresholds(e_j.probe(index["x_q"]))[1]
    c_j = j_calibrate(e_j, index["x_q"], thr, K, ladder=(0, 2, 4))
    c_t = calibrate_block_margin(e_t, index["x_q"], thr, K, ladder=(0, 2, 4))
    assert (c_t.margin, c_t.zero_miss_margin, c_t.miss_rates) == (
        c_j.margin, c_j.zero_miss_margin, c_j.miss_rates)
    tune = autotune_block_q(e_t, index["x_q"], thr, K, candidates=(16, 8), reps=1)
    assert tune.block_q in (16, 8) and e_t.block_q == 1024


def test_unported_paths_raise(index):
    """Every path of lira_tpu's engine is ported; what is left to raise are
    lira_tpu's own ValueErrors for combinations neither package serves (int8
    on a per-query path, capacity mode in f32 or on a per-query path), and
    the port's for K3 on a tile other than 128 (its stacks are per row of a
    128-row tile; lira_tpu does not check) and an unknown scan_impl."""
    lay64 = t_layout(index["d2b"], index["n_bkt"], tile=64)
    lay128 = t_layout(index["d2b"], index["n_bkt"])
    for kw, match in ((dict(scan_impl="xla", scan_dtype="int8"), "blocked-scan screen mode"),
                      (dict(scan_impl="pallas", scan_dtype="int8"), "blocked-scan screen mode"),
                      (dict(store_f32=False), "capacity mode"),
                      (dict(store_f32=False, scan_dtype="bfloat16", scan_impl="xla"),
                       "capacity mode"),
                      (dict(scan_impl="pallas", layout=lay64), "128-row tile"),
                      (dict(scan_impl="nope"), "scan_impl")):
        kw = dict(kw)
        lay = kw.pop("layout", lay128)
        with pytest.raises(ValueError, match=match):
            TorchEngine(index["x_d"], lay, index["centroids"], index["scaler"],
                        index["params_np"], device="cpu", **kw)
        if match not in ("128-row tile", "scan_impl"):
            with pytest.raises(ValueError, match=match):
                JaxEngine(index["x_d"], j_layout(index["d2b"], index["n_bkt"],
                                                 tile=lay.tile),
                          index["centroids"], index["scaler"], index["params"], **kw)


def test_block_unions_and_plan_helpers_match():
    rng = np.random.default_rng(5)
    tiles_per_bucket = rng.integers(0, 4, size=9).astype(np.int64)
    tile_start = np.concatenate([[0], np.cumsum(tiles_per_bucket)[:-1]]).astype(np.int64)
    n_tiles = int(tiles_per_bucket.sum())
    tile_bucket = np.repeat(np.arange(9, dtype=np.int32), tiles_per_bucket)
    tile_bucket = np.concatenate([tile_bucket, np.full((-n_tiles) % 8, -1, np.int32)])
    union = rng.random((4, 9)) < 0.4
    for a, b in zip(jbs.build_block_unions(union, tile_start, tiles_per_bucket, tile_bucket),
                    tbs.build_block_unions(union, tile_start, tiles_per_bucket, tile_bucket)):
        np.testing.assert_array_equal(a, b)
    for sel in (32, 64, 128):
        for dt_j, dt_t in ((jnp.float32, "float32"), (jnp.bfloat16, "bfloat16"),
                           (jnp.int8, "int8")):
            import torch

            t_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                    "int8": torch.int8}[dt_t]
            assert jbs._resolve_margin(None, dt_j, sel) == tbs._resolve_margin(None, t_dt, sel)


@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_empty_and_tiny_buckets_match(scan_dtype):
    """Every point in bucket 0, buckets 1..5 empty, and k > n: both
    engines return each real point once and -1 after it."""
    rng = np.random.default_rng(8)
    n, dim, n_bkt = 40, 8, 6
    x_d = rng.normal(size=(n, dim)).astype(np.float32)
    x_q = rng.normal(size=(5, dim)).astype(np.float32)
    km = kmeans_fit(x_d, n_bkt, niter=2, seed=0)
    raw = np.asarray(l2_to_centroids(jnp.asarray(x_d), jnp.asarray(km.centroids)))
    params = init_params(jax.random.PRNGKey(0), n_bkt, dim)
    ix = dict(x_d=x_d, d2b=np.zeros((n, 1), np.int32), n_bkt=n_bkt, n_mul=2,
              centroids=km.centroids, scaler=StandardScaler().fit(raw), params=params,
              params_np=jax.tree_util.tree_map(np.asarray, params))
    e_j, e_t = _engines(ix, scan_dtype=scan_dtype)
    r_j, r_t = e_j.search(x_q, 0.0, 50), e_t.search(x_q, 0.0, 50)
    _assert_same(r_j, r_t, "tiny")
    assert r_t.ids.shape == (5, 50)
    for i in range(5):
        got = r_t.ids[i][r_t.ids[i] >= 0]
        assert sorted(got) == list(range(n))
        assert (r_t.ids[i][len(got):] == -1).all()


def test_sweep_matches(index):
    e_j, e_t = _engines(index, scan_dtype="int8")
    x_q = index["x_q"]
    gt = np.argsort(((index["x_d"][None] - x_q[:, None]) ** 2).sum(-1), axis=1)[:, :K]
    thrs = np.array(_thresholds(e_j.probe(x_q)))
    rows_j = e_j.sweep(x_q, gt, K, thrs, warmup=False)
    rows_t = e_t.sweep(x_q, gt, K, thrs, warmup=False)
    for a, b in zip(rows_j, rows_t):
        for key in ("threshold", "avg_recall", "avg_nprobe", "avg_cmp"):
            assert a[key] == b[key], key


def test_screen_only_matches_lira_tpu(index):
    """_scan_all(screen_only=True), the phase-profiling cut after the group
    selection: per query the selected groups' masked minima (as scores) and
    global group ids (as ids), deduplicated to k, in caller order.  The
    same group sets as lira_tpu's, minima allclose."""
    e_j, e_t = _engines(index, block_q=8)
    x_q = index["x_q"]
    thr = _thresholds(e_j.probe(x_q))[1]
    st_j, st_t = e_j._block_state, e_t._block_state
    h_j = jbs._probe_batch(st_j, e_j, x_q, thr, 8)
    h_t = tbs._probe_batch(st_t, e_t, x_q, thr, 8)
    union = np.asarray(h_j["union"])
    np.testing.assert_array_equal(union, h_t["union"].numpy())
    supers, tb, ulen = tbs.build_block_unions(union, e_t.tile_start, e_t.tiles_per_bucket,
                                              st_t.tile_bucket)
    sel_rows = e_t.block_sel_rows
    fetch_k = K * index["n_mul"]
    kg = fetch_k + tbs._resolve_margin(None, st_t.scan_dtype, sel_rows)
    common = dict(metric="L2", kg=kg, fetch_k=fetch_k, k=K, sel_rows=sel_rows)
    sc_j, id_j = jbs._scan_all(
        h_j["q"], h_j["probed"], h_j["perm"], jnp.asarray(supers), jnp.asarray(tb),
        jnp.asarray(ulen), st_j.corpus_flat, st_j.bsq, st_j.rescore_arg, st_j.tiles_ids,
        st_j.tile_pad_count, qb=h_j["qb"], precision="highest", interpret=True,
        screen_only=True, dim_scale=st_j.dim_scale, sub=8, **common)
    import torch

    sc_t, id_t = tbs._scan_all(
        h_t["q"], h_t["probed"], h_t["perm"], torch.as_tensor(supers), torch.as_tensor(tb),
        torch.as_tensor(ulen), st_t.corpus_flat, st_t.bsq, st_t.corpus_flat_f32,
        st_t.tiles_ids, st_t.tile_pad_count, qb=h_t["qb"], screen_only=True,
        dim_scale=st_t.dim_scale, screen_sq=st_t.screen_sq, **common)
    B = len(x_q)
    id_j, id_t = np.asarray(id_j)[:B], id_t.numpy()[:B]
    sc_j, sc_t = np.asarray(sc_j)[:B], sc_t.numpy()[:B]
    for i in range(B):
        assert set(id_j[i][id_j[i] >= 0]) == set(id_t[i][id_t[i] >= 0]), i
    fin = np.isfinite(sc_j)
    np.testing.assert_array_equal(fin, np.isfinite(sc_t))
    np.testing.assert_allclose(sc_t[fin], sc_j[fin], rtol=1e-5, atol=1e-4)
    # the rescore's answers differ: exact scores of rows, not group minima
    r = e_t.search(x_q, thr, K)
    assert not np.array_equal(r.ids, id_t)


def _traced(call, tmp_path, name):
    """call() under `profiling.device_trace` on the CPU, counters reset
    first: (its result, the trace's span events sorted by start)."""
    import json

    from lira_tpu_torch import profiling

    profiling.reset_counters()
    with profiling.device_trace(str(tmp_path / name), device="cpu"):
        out = call()
    with open(tmp_path / name / "trace.json") as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    return out, sorted(evs, key=lambda e: (e["ts"], -e["dur"]))


def _inside(e, outer):
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("root", ["search", "search_stream"])
def test_blocked_spans_nest_under_their_root(index, tmp_path, root):
    """Under a profiler on the CPU the blocked engine's call is one root
    span holding every phase's; `select` and `rescore` lie inside `scan`;
    `probe` and `unions` add their host seconds to counters, beside the
    screen's and the selection's pairs; the ids equal an untraced call's."""
    from lira_tpu_torch import profiling

    _, e_t = _engines(index, block_q=8, scan_dtype="int8")
    x_q = index["x_q"]
    kw = dict(batch_size=16) if root == "search_stream" else {}
    base = getattr(e_t, root)(x_q, 0.0, K, **kw)
    r, evs = _traced(lambda: getattr(e_t, root)(x_q, 0.0, K, **kw), tmp_path, root)
    np.testing.assert_array_equal(r.ids, base.ids)
    roots = [e for e in evs if e["name"] == root]
    assert len(roots) == 1
    leaves = ("probe", "probe_wait", "unions", "scan", "select", "rescore", "collect")
    assert {e["name"] for e in evs} == {root, *leaves}
    assert all(_inside(e, roots[0]) for e in evs)
    n_batches = 3 if root == "search_stream" else 1
    for name in ("probe", "probe_wait", "unions", "scan"):
        assert sum(e["name"] == name for e in evs) == n_batches, name
    scans = [e for e in evs if e["name"] == "scan"]
    for e in evs:
        if e["name"] in ("select", "rescore"):
            assert any(_inside(e, s) for s in scans)
    assert set(profiling.counters()) == {"screen.pairs", "select.pairs", "probe.host_s",
                                         "unions.host_s", "rescore.steps", "rescore.rows"}
    assert all(v > 0 for v in profiling.counters().values())
    # at d 16 one round-2 step holds a whole block: a step a `rescore` span
    assert profiling.counters()["rescore.steps"] == sum(e["name"] == "rescore" for e in evs)


def test_per_query_spans_nest_under_their_root(index, tmp_path):
    """The per-query path (`_search_unblocked`, here the xla scan in bf16,
    which re-ranks on the host): probe, tiles, scan, collect, rerank and
    dedup inside `search`."""
    e_t = TorchEngine(index["x_d"], t_layout(index["d2b"], index["n_bkt"], tile=128),
                      index["centroids"], index["scaler"],
                      params_from_jax(index["params_np"]), n_mul=index["n_mul"],
                      scan_impl="xla", scan_dtype="bfloat16", device="cpu")
    base = e_t.search(index["x_q"], 0.0, K)
    r, evs = _traced(lambda: e_t.search(index["x_q"], 0.0, K), tmp_path, "unblocked")
    np.testing.assert_array_equal(r.ids, base.ids)
    assert [e["name"] for e in evs] == ["search", "probe", "tiles", "scan", "collect",
                                        "rerank", "dedup"]
    assert all(_inside(e, evs[0]) for e in evs)


def test_spans_and_counts_are_free_without_a_profiler():
    """No profiler recording: `span` hands back one shared no-op context,
    and neither a span nor `count` records anything."""
    from lira_tpu_torch import profiling

    profiling.reset_counters()
    a, b = profiling.span("x"), profiling.span("y", timed=True)
    assert a is b
    with a:
        profiling.count("screen.pairs", 5)
    assert profiling.counters() == {}


@pytest.mark.parametrize("batch_size", [16, 64])
def test_screen_pairs_counts_each_block_union(index, tmp_path, batch_size):
    """`screen.pairs` is qb × Σ ulen × S_TILES × 128 summed over a call's
    batches, recomputed here from `build_block_unions` on each batch's
    union mask."""
    from lira_tpu_torch import profiling

    _, e_t = _engines(index, block_q=8, scan_dtype="int8")
    x_q, thr = index["x_q"], _thresholds(e_t.probe(index["x_q"]))[1]
    st = e_t._block_state
    want = 0
    for s in range(0, len(x_q), batch_size):
        h = tbs._probe_batch(st, e_t, x_q[s : s + batch_size], thr, 8)
        _, _, ulen = tbs.build_block_unions(h["union"].numpy(), e_t.tile_start,
                                            e_t.tiles_per_bucket, st.tile_bucket)
        want += h["qb"] * int(ulen.sum()) * tbs.S_TILES * 128
    _traced(lambda: e_t.search_stream(x_q, thr, K, batch_size=batch_size), tmp_path, "pairs")
    assert profiling.counters()["screen.pairs"] == want > 0
