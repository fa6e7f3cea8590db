"""The per-query serving paths: lira_tpu_torch (device="cpu") against
lira_tpu on the same numpy inputs — K3's plain version against the Pallas
kernel in interpret mode, the xla scan, the host helpers, and
QueryEngine(scan_impl="xla" / "pallas") end to end.

Tolerances: nprobe, ndis, tile lists, dedup and host re-rank outputs are
held exactly (the host helpers byte for byte).  Scores are allclose at
atol 1e-4, rtol 1e-5: both sides rank by ‖x‖² − 2·x·q (or −x·q) in f32 at
d = 16, summed in different orders, a few ulps of values ~10-100.  Neighbour
id sets are equal; on the scan level a difference is allowed only where the
k-th and (k+1)-th scores tie exactly (`_assert_topk_same`).  Interpreted
Pallas calls stay at B ≤ 16, T ≤ 16, k ≤ 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lira_tpu.engine import serve as jserve
from lira_tpu.engine.pallas_scan import pallas_probed_scan as j_probed_scan
from lira_tpu.engine.serve import QueryEngine as JaxEngine
from lira_tpu.labels.scaler import StandardScaler
from lira_tpu.models.probing_mlp import init_params
from lira_tpu.ops.distance import l2_to_centroids
from lira_tpu.partition.assign import build_bucket_layout as j_layout
from lira_tpu.partition.kmeans import kmeans_fit
from lira_tpu_torch.engine import pallas_scan as tps
from lira_tpu_torch.engine import serve as tserve
from lira_tpu_torch.engine.serve import QueryEngine as TorchEngine
from lira_tpu_torch.models.probing_mlp import params_from_jax
from lira_tpu_torch.partition.assign import build_bucket_layout as t_layout

K = 5


def _tiles_setup(seed, n_tiles=6, d=16, B=4, T=5, tile=128):
    """tests/test_pallas_scan.py::_setup's shapes: padding in the last
    tile, ragged lists of distinct tiles."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n_tiles, tile, d)).astype(np.float32)
    ids = np.arange(n_tiles * tile, dtype=np.int32).reshape(n_tiles, tile)
    ids[-1, tile - 28:] = -1
    sq = (corpus ** 2).sum(-1).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    tiles = np.full((B, T), -1, dtype=np.int32)
    for b in range(B):
        nt = rng.integers(1, T + 1)
        tiles[b, :nt] = rng.choice(n_tiles, size=nt, replace=False)
    return q, tiles, corpus, ids, sq


def _pallas_sq(sq, ids, metric):
    out = np.zeros_like(sq) if metric == "inner_product" else sq.copy()
    out[ids < 0] = 3e38
    return out


def _assert_topk_same(s_a, i_a, s_b, i_b, tag=""):
    """Scores allclose row by row; id sets equal unless the last kept score
    ties the next candidate (then only the ids above the tie must agree)."""
    s_a, i_a, s_b, i_b = (np.asarray(a) for a in (s_a, i_a, s_b, i_b))
    np.testing.assert_array_equal(s_a >= 1e37, s_b >= 1e37, err_msg=str(tag))
    live = s_a < 1e37
    np.testing.assert_allclose(s_b[live], s_a[live], rtol=1e-5, atol=1e-4, err_msg=str(tag))
    for r in range(len(i_a)):
        if set(i_a[r]) == set(i_b[r]):
            continue
        last = s_a[r][live[r]].max()
        inside = s_a[r] < last - 1e-4
        assert set(i_a[r][inside]) <= set(i_b[r]), (tag, r)


def _engine_same(r_j, r_t, tag):
    np.testing.assert_array_equal(r_j.nprobe, r_t.nprobe, err_msg=str(tag))
    np.testing.assert_array_equal(r_j.ndis, r_t.ndis, err_msg=str(tag))
    for i in range(len(r_j.ids)):
        a, b = r_j.ids[i], r_t.ids[i]
        assert set(a[a >= 0]) == set(b[b >= 0]), (tag, i)
    s_j, s_t = np.sort(r_j.scores, axis=1), np.sort(r_t.scores, axis=1)
    np.testing.assert_array_equal(np.isfinite(s_j), np.isfinite(s_t))
    fin = np.isfinite(s_j)
    np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=1e-5, atol=1e-4, err_msg=str(tag))


# ---------------------------------------------------------------------------
# K3: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_probed_scan_ref_matches_pallas_kernel(metric, k):
    q, tiles, corpus, ids, sq = _tiles_setup(11 + k)
    sq = _pallas_sq(sq, ids, metric)
    s_j, i_j = j_probed_scan(jnp.asarray(q), jnp.asarray(tiles), jnp.asarray(corpus),
                             jnp.asarray(ids), jnp.asarray(sq), k=k, metric=metric,
                             interpret=True)
    args = [torch.from_numpy(a) for a in (q, tiles, corpus, ids, sq)]
    s_t, i_t = tps.pallas_probed_scan(*args, k, metric)  # CPU tensors: the plain version
    s_r, i_r = tps.probed_scan_ref(*args, k, metric)
    assert torch.equal(s_t, s_r) and torch.equal(i_t, i_r)
    _assert_topk_same(s_j, i_j, s_t, i_t, (metric, k))


def test_probed_scan_ref_edges_match_pallas_kernel():
    """Every slot −1 (no candidate: −1 ids, 3e38 scores), and one tile
    listed in every slot (replicated candidates with equal ids)."""
    q, tiles, corpus, ids, sq = _tiles_setup(5, B=2, T=4)
    sq = _pallas_sq(sq, ids, "L2")
    for lists, k in ((np.full_like(tiles, -1), 2), (np.full_like(tiles, 2), 1)):
        s_j, i_j = j_probed_scan(jnp.asarray(q), jnp.asarray(lists), jnp.asarray(corpus),
                                 jnp.asarray(ids), jnp.asarray(sq), k=k, interpret=True)
        s_t, i_t = tps.probed_scan_ref(*(torch.from_numpy(a) for a in (q, lists, corpus, ids,
                                                                       sq)), k)
        np.testing.assert_array_equal(np.asarray(i_j), i_t.numpy())
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-4)
    assert (i_t.numpy()[:, 0] >= 0).all()


def test_probed_scan_k128_matches_numpy_oracle():
    """k = 128 (the deepest stack) on two tiles, against a numpy top-k."""
    q, tiles, corpus, ids, sq = _tiles_setup(7, n_tiles=3, B=3, T=2)
    tiles[:] = [[0, 2], [2, -1], [1, 0]]
    for metric in ("L2", "inner_product"):
        psq = _pallas_sq(sq, ids, metric)
        s_t, i_t = tps.pallas_probed_scan(
            *(torch.from_numpy(a) for a in (q, tiles, corpus, ids, psq)), 128, metric)
        for b in range(len(q)):
            rows = [(t, r) for t in tiles[b] if t >= 0 for r in range(128) if ids[t, r] >= 0]
            x = np.stack([corpus[t, r] for t, r in rows]).astype(np.float64)
            s = -(x @ q[b]) if metric == "inner_product" else (x * x).sum(1) - 2 * x @ q[b]
            order = np.argsort(s, kind="stable")[:128]
            want = np.array([ids[rows[j]] for j in order])
            got = i_t.numpy()[b]
            assert set(got[got >= 0]) == set(want), (metric, b)
            np.testing.assert_allclose(np.sort(s_t.numpy()[b][got >= 0]), s[order],
                                       rtol=1e-5, atol=1e-4)


def test_k_over_128_raises_in_both():
    q, tiles, corpus, ids, sq = _tiles_setup(3)
    with pytest.raises(ValueError, match="k <= 128"):
        j_probed_scan(jnp.asarray(q), jnp.asarray(tiles), jnp.asarray(corpus),
                      jnp.asarray(ids), jnp.asarray(sq), k=129, interpret=True)
    with pytest.raises(ValueError, match="k <= 128"):
        tps.pallas_probed_scan(*(torch.from_numpy(a) for a in (q, tiles, corpus, ids, sq)),
                               129)


# ---------------------------------------------------------------------------
# the xla scan and the host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("tile,k", [(64, 5), (64, 40), (128, 5), (128, 40)])
def test_scan_probed_tiles_matches(tile, k, metric):
    q, tiles, corpus, ids, sq = _tiles_setup(20 + k, n_tiles=7, B=6, T=6, tile=tile)
    tiles[1, 0] = -1  # a hole before a live slot
    sq = np.where(ids >= 0, sq, np.inf).astype(np.float32)
    s_j, i_j = jserve._scan_probed_tiles(jnp.asarray(q), jnp.asarray(tiles),
                                         jnp.asarray(corpus), jnp.asarray(ids),
                                         jnp.asarray(sq), k=k, metric=metric)
    s_t, i_t = tserve._scan_probed_tiles(*(torch.from_numpy(a) for a in (q, tiles, corpus,
                                                                         ids, sq)), k, metric)
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    np.testing.assert_array_equal(np.isinf(s_j), np.isinf(s_t))
    fin = np.isfinite(s_j)
    np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(i_j)[~fin], i_t.numpy()[~fin])
    for b in range(len(q)):
        assert set(np.asarray(i_j)[b][fin[b]]) == set(i_t.numpy()[b][fin[b]]), b


def test_scan_probed_tiles_step_merge_is_exact(monkeypatch):
    """Merging several tiles a step equals lira_tpu's one tile a step, ties
    included: equal rows in two tiles keep the earlier tile's id."""
    q, tiles, corpus, ids, sq = _tiles_setup(4, n_tiles=5, B=3, T=5)
    corpus[3] = corpus[1]
    tiles[:] = [[1, 3, 0, 2, 4], [3, 1, -1, -1, -1], [4, 3, 1, 0, -1]]
    sq = np.where(ids >= 0, (corpus ** 2).sum(-1), np.inf).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, tiles, corpus, ids, sq)]
    outs = []
    for budget in (1, 1 << 26):
        monkeypatch.setattr(tserve, "_XLA_STEP_BUDGET", budget)
        outs.append(tserve._scan_probed_tiles(*args, 12, "L2"))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_host_helpers_are_byte_equal():
    rng = np.random.default_rng(9)
    ids = rng.integers(-1, 30, size=(40, 24)).astype(np.int32)
    scores = np.sort(rng.normal(size=(40, 24)).astype(np.float32), axis=1)
    for k in (1, 5, 24):
        for a, b in zip(jserve._dedup_topk(ids, scores, k), tserve._dedup_topk(ids, scores, k)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    x_d = rng.normal(size=(30, 16)).astype(np.float32)
    queries = rng.normal(size=(40, 16)).astype(np.float32)
    x_sq = np.einsum("nd,nd->n", x_d, x_d).astype(np.float32)
    for metric in ("L2", "inner_product"):
        for xs in (None, x_sq):
            for a, b in zip(jserve.rerank_exact_host(x_d, metric, queries, ids, xs),
                            tserve.rerank_exact_host(x_d, metric, queries, ids, xs)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# QueryEngine(scan_impl="xla" / "pallas") end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def index():
    """tests/test_torch_engine.py's index: n_mul=2 with a replicated slice of
    points (dedup to k distinct), 7 buckets of ~2 tiles."""
    rng = np.random.default_rng(43)
    n, dim, n_bkt, n_mul = 1600, 16, 7, 2
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
    return dict(x_d=x_d, x_q=x_q, d2b=d2b, n_bkt=n_bkt, n_mul=n_mul,
                centroids=km.centroids, scaler=scaler, params=params,
                params_np=jax.tree_util.tree_map(np.asarray, params))


def _engines(ix, tile=128, **kw):
    kw.setdefault("n_mul", ix["n_mul"])
    e_j = JaxEngine(ix["x_d"], j_layout(ix["d2b"], ix["n_bkt"], tile=tile), ix["centroids"],
                    ix["scaler"], ix["params"], **kw)
    e_t = TorchEngine(ix["x_d"], t_layout(ix["d2b"], ix["n_bkt"], tile=tile),
                      ix["centroids"], ix["scaler"], params_from_jax(ix["params_np"]),
                      device="cpu", **kw)
    return e_j, e_t


def _thresholds(outputs: np.ndarray, fracs=(0.5, 0.8)) -> list[float]:
    """0 (every bucket), plus midpoints near the given quantiles of the probe
    outputs whose neighbours are ≥ 1e-5 apart (a last-bit difference in the
    MLP cannot flip a bucket)."""
    v = np.unique(outputs.ravel())
    out = [0.0]
    for frac in fracs:
        j = int(frac * (len(v) - 1))
        while j + 1 < len(v) and v[j + 1] - v[j] < 1e-5:
            j += 1
        out.append(float((v[j] + v[j + 1]) / 2))
    return out


@pytest.mark.parametrize("probe_cap", [None, 4])
@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_xla_engine_matches_lira_tpu(index, scan_dtype, metric, probe_cap):
    e_j, e_t = _engines(index, metric=metric, scan_impl="xla", scan_dtype=scan_dtype,
                        probe_cap=probe_cap)
    x_q = index["x_q"]
    for thr in _thresholds(e_j.probe(x_q)):
        np.testing.assert_array_equal(e_t._select_probed(x_q, thr),
                                      e_j._select_probed(jnp.asarray(x_q), thr))
        _engine_same(e_j.search(x_q, thr, K), e_t.search(x_q, thr, K),
                     (scan_dtype, metric, probe_cap, thr))


@pytest.mark.parametrize("metric,scan_dtype", [("L2", "float32"), ("inner_product", "float32"),
                                               ("L2", "bfloat16")])
def test_pallas_engine_matches_lira_tpu(index, metric, scan_dtype):
    """12 queries (one 16-query block), lira_tpu's kernel interpreted."""
    e_j, e_t = _engines(index, metric=metric, scan_impl="pallas", scan_dtype=scan_dtype)
    x_q = index["x_q"][:12]
    thr = _thresholds(e_j.probe(x_q), fracs=(0.5,))[1]
    tiles = e_t._probe_tiles(e_t._select_probed(x_q, thr))
    assert tiles.shape[1] <= 16
    before = tps.pallas_probed_scan.launches
    _engine_same(e_j.search(x_q, thr, K), e_t.search(x_q, thr, K), (metric, scan_dtype))
    assert tps.pallas_probed_scan.launches == before  # CPU tensors: the plain version


def test_pallas_wide_fetch_takes_the_xla_scan(index, monkeypatch):
    """n_mul = 40 → fetch_k = 200 > 128: the pallas engine scans with the
    xla scan (lira_tpu's routing contract), with lira_tpu's results."""
    e_j, e_t = _engines(index, scan_impl="pallas", n_mul=40)
    calls = {"pallas": 0, "xla": 0}
    real_xla = tserve._scan_probed_tiles

    def xla(*a, **kw):
        calls["xla"] += 1
        return real_xla(*a, **kw)

    def pallas(*a, **kw):
        calls["pallas"] += 1
        raise AssertionError("K3 was asked for fetch_k > 128")

    monkeypatch.setattr(tserve, "_scan_probed_tiles", xla)
    monkeypatch.setattr(tps, "pallas_probed_scan", pallas)
    x_q = index["x_q"][:12]
    _engine_same(e_j.search(x_q, 0.0, K), e_t.search(x_q, 0.0, K), "n_mul=40")
    assert calls == {"pallas": 0, "xla": 1}


def test_probe_tiles_match(index):
    e_j, e_t = _engines(index, scan_impl="xla")
    x_q = index["x_q"]
    for thr in _thresholds(e_j.probe(x_q)) + [2.0]:
        probed = e_t._select_probed(x_q, thr)
        a, b = e_j._probe_tiles(probed), e_t._probe_tiles(probed)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    probed = np.zeros((3, index["n_bkt"]), bool)  # nothing probed: one -1 column
    np.testing.assert_array_equal(e_t._probe_tiles(probed), np.full((3, 1), -1, np.int32))


def test_per_query_search_stream_equals_per_batch_search(index):
    _, e_t = _engines(index, scan_impl="xla", scan_dtype="bfloat16")
    x_q = np.concatenate([index["x_q"], index["x_q"][::-1]])  # 66 queries
    thr = _thresholds(e_t.probe(x_q))[1]
    r_s = e_t.search_stream(x_q, thr, K, batch_size=16)
    parts = [e_t.search(x_q[s : s + 16], thr, K) for s in range(0, len(x_q), 16)]
    for name in ("ids", "scores", "nprobe", "ndis"):
        np.testing.assert_array_equal(
            getattr(r_s, name), np.concatenate([getattr(p, name) for p in parts]),
            err_msg=name)
    assert e_t.search(x_q[:0], thr, K).ids.shape == (0, K)


def test_tile64_layout_serves_through_xla_and_pallas_raises(index):
    """tests/test_probe_cap.py's geometry: a 64-row tile layout."""
    e_j, e_t = _engines(index, tile=64, scan_impl="xla", probe_cap=3)
    assert e_t.corpus.shape[1] == 64
    x_q = index["x_q"]
    for thr in _thresholds(e_j.probe(x_q)):
        _engine_same(e_j.search(x_q, thr, K), e_t.search(x_q, thr, K), ("tile64", thr))
    with pytest.raises(ValueError, match="128-row tile"):
        TorchEngine(index["x_d"], t_layout(index["d2b"], index["n_bkt"], tile=64),
                    index["centroids"], index["scaler"], index["params_np"],
                    scan_impl="pallas", device="cpu")
