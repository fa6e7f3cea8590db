"""Capacity mode, the IVF prober and the tuning helpers: lira_tpu_torch
(device="cpu") against lira_tpu on the same numpy inputs.

Held exactly: nprobe, ndis, neighbour-id sets, the int8 capacity table
(byte for byte) and its per-dim scale, the IVF probe matrix and sweep, and
the operating points picked from sweep rows.  Scores are allclose at atol
1e-4, rtol 1e-5 (f32 sums in different orders at d ≤ 16, values ~10-100;
the capacity modes' final scores are the host re-rank's, computed the same
way by both).  Thresholds sit at midpoints between sorted probe outputs with
a gap ≥ 1e-5, so a last-bit difference in the MLP cannot flip a bucket.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lira_tpu.engine import ivf_baseline as jivf
from lira_tpu.engine import tuning as jtune
from lira_tpu.engine.serve import QueryEngine as JaxEngine
from lira_tpu.engine.sweep import threshold_sweep as j_threshold_sweep
from lira_tpu.labels.scaler import StandardScaler
from lira_tpu.models.probing_mlp import init_params
from lira_tpu.ops.distance import l2_to_centroids
from lira_tpu.partition.assign import build_bucket_layout as j_layout
from lira_tpu.partition.kmeans import kmeans_fit
from lira_tpu_torch.engine import ivf_baseline as tivf
from lira_tpu_torch.engine import tuning as ttune
from lira_tpu_torch.engine.serve import QueryEngine as TorchEngine
from lira_tpu_torch.engine.sweep import threshold_sweep as t_threshold_sweep
from lira_tpu_torch.models.probing_mlp import params_from_jax
from lira_tpu_torch.partition.assign import build_bucket_layout as t_layout

K = 5


def _index(seed, n, dim, n_bkt, n_q, n_mul):
    rng = np.random.default_rng(seed)
    x_d = rng.normal(size=(n, dim)).astype(np.float32)
    x_q = rng.normal(size=(n_q, dim)).astype(np.float32)
    d2b = np.full((n, n_mul), -1, dtype=np.int32)
    d2b[:, 0] = rng.integers(0, n_bkt, size=n)
    if n_mul > 1:
        repl = rng.integers(0, n, size=n // 10)
        d2b[repl, 1] = (d2b[repl, 0] + 1) % n_bkt
    km = kmeans_fit(x_d, n_bkt, niter=3, seed=0)
    raw = np.asarray(l2_to_centroids(jnp.asarray(x_d), jnp.asarray(km.centroids)))
    params = init_params(jax.random.PRNGKey(0), n_bkt, dim)
    return dict(x_d=x_d, x_q=x_q, d2b=d2b, n_bkt=n_bkt, n_mul=n_mul,
                centroids=np.asarray(km.centroids), scaler=StandardScaler().fit(raw),
                params=params, params_np=jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def index():
    """tests/test_torch_engine.py's index: 1600×16, 7 buckets, n_mul 2."""
    return _index(43, 1600, 16, 7, 33, 2)


@pytest.fixture(scope="module")
def ivf_index():
    """tests/test_lira_vs_ivf.py::test_measured_engine_with_ivf_prober's
    shapes: 1200×8, 10 buckets, 17 queries, n_mul 1."""
    return _index(44, 1200, 8, 10, 17, 1)


def _engines(ix, **kw):
    kw.setdefault("n_mul", ix["n_mul"])
    e_j = JaxEngine(ix["x_d"], j_layout(ix["d2b"], ix["n_bkt"], tile=128), ix["centroids"],
                    ix["scaler"], ix["params"], **kw)
    e_t = TorchEngine(ix["x_d"], t_layout(ix["d2b"], ix["n_bkt"], tile=128), ix["centroids"],
                      ix["scaler"], params_from_jax(ix["params_np"]), device="cpu", **kw)
    return e_j, e_t


def _threshold(outputs: np.ndarray, frac: float) -> float:
    """A midpoint near the `frac` quantile of the probe outputs whose
    neighbours are ≥ 1e-5 apart."""
    v = np.unique(outputs.ravel())
    j = int(frac * (len(v) - 1))
    while j + 1 < len(v) and v[j + 1] - v[j] < 1e-5:
        j += 1
    return float((v[j] + v[j + 1]) / 2)


def _same(r_j, r_t, tag):
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
# capacity mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_dtype,metric", [("bfloat16", "L2"), ("int8", "L2"),
                                               ("int8", "inner_product")])
def test_capacity_engine_matches_lira_tpu(index, scan_dtype, metric):
    e_j, e_t = _engines(index, metric=metric, scan_impl="blocked", scan_dtype=scan_dtype,
                        store_f32=False, block_q=16)
    st_j, st_t = e_j._block_state, e_t._block_state
    # one table serves both rounds: no f32 copy of the corpus on the device
    assert st_t.corpus_flat_f32 is st_t.corpus_flat and not st_t.store_f32
    assert st_t.corpus_flat.dtype == {"bfloat16": torch.bfloat16, "int8": torch.int8}[scan_dtype]
    if scan_dtype == "int8":
        t8 = st_t.corpus_flat.numpy()
        assert t8.dtype == np.int8 and t8.tobytes() == np.asarray(st_j.corpus_flat).tobytes()
        np.testing.assert_array_equal(st_t.dim_scale.numpy(), np.asarray(st_j.dim_scale))
    else:
        np.testing.assert_array_equal(st_t.corpus_flat.float().numpy(),
                                      np.asarray(st_j.corpus_flat, np.float32))
    np.testing.assert_array_equal(st_t.bsq.numpy(), np.asarray(st_j.bsq))
    x_q = index["x_q"]
    for thr in (0.0, _threshold(e_j.probe(x_q), 0.6)):
        _same(e_j.search(x_q, thr, K), e_t.search(x_q, thr, K), (scan_dtype, metric, thr))


def test_capacity_stream_equals_per_batch_search(index):
    _, e_t = _engines(index, scan_impl="blocked", scan_dtype="int8", store_f32=False,
                      block_q=8)
    x_q = np.concatenate([index["x_q"], index["x_q"][::-1]])
    thr = _threshold(e_t.probe(x_q), 0.5)
    r_s = e_t.search_stream(x_q, thr, K, batch_size=16)
    parts = [e_t.search(x_q[s : s + 16], thr, K) for s in range(0, len(x_q), 16)]
    for name in ("ids", "scores", "nprobe", "ndis"):
        np.testing.assert_array_equal(
            getattr(r_s, name), np.concatenate([getattr(p, name) for p in parts]),
            err_msg=name)


# ---------------------------------------------------------------------------
# the IVF baseline
# ---------------------------------------------------------------------------


def test_ivf_probe_matrix_and_sweep_match(ivf_index):
    ix = ivf_index
    x_q, c = ix["x_q"], ix["centroids"]
    np.testing.assert_array_equal(tivf.ivf_probe_matrix(x_q, c, device="cpu"),
                                  jivf.ivf_probe_matrix(x_q, c))
    if not torch.cuda.is_available():  # device=None is cuda, as everywhere
        with pytest.raises(RuntimeError, match="CUDA"):
            tivf.ivf_probe_matrix(x_q, c)
    rng = np.random.default_rng(3)
    n_q, n_bkt = len(x_q), ix["n_bkt"]
    gtb = rng.integers(-1, n_bkt, size=(n_q, K, 2)).astype(np.int32)
    hit = rng.random((n_q, K, 2)) < 0.5
    sizes = t_layout(ix["d2b"], n_bkt).sizes
    for nprobes in (None, [1, 3, 5, 20]):
        assert (tivf.ivf_sweep(x_q, c, gtb, hit, sizes, K, nprobes, device="cpu")
                == jivf.ivf_sweep(x_q, c, gtb, hit, sizes, K, nprobes))


@pytest.mark.parametrize("scan_impl", ["xla", "blocked"])
def test_ivf_prober_engine_matches(ivf_index, scan_impl):
    """QueryEngine(prober=ivf_probe_matrix) probes exactly the m nearest
    centroids at threshold 1 − (m − 0.5)/n_bkt, with lira_tpu's results and
    a brute-force scan of those buckets' neighbours."""
    ix = ivf_index
    c = ix["centroids"]
    e_j, e_t = _engines(ix, scan_impl=scan_impl, block_q=8,
                        prober=lambda q: jivf.ivf_probe_matrix(q, c))
    e_t.prober = lambda q: tivf.ivf_probe_matrix(q, c, device="cpu")
    layout = e_t.layout
    x_d, x_q = ix["x_d"], ix["x_q"]
    nearest_all = np.argsort(((x_q[:, None] - c[None]) ** 2).sum(-1), axis=1, kind="stable")
    for m in (1, 3, 5):
        thr = 1.0 - (m - 0.5) / ix["n_bkt"]
        r_j, r_t = e_j.search(x_q, thr, K), e_t.search(x_q, thr, K)
        assert (r_t.nprobe == m).all(), (scan_impl, m)
        _same(r_j, r_t, (scan_impl, m))
        for i in range(len(x_q)):
            members = np.concatenate([layout.bucket_members(b) for b in nearest_all[i, :m]])
            d = ((x_d[members] - x_q[i]) ** 2).sum(1)
            expect = set(members[np.argsort(d, kind="stable")][: min(K, len(members))])
            assert set(r_t.ids[i][r_t.ids[i] >= 0]) == expect, (scan_impl, m, i)


# ---------------------------------------------------------------------------
# tuning
# ---------------------------------------------------------------------------


def test_tuning_matches_on_both_packages_sweep_rows(index):
    e_j, e_t = _engines(index, scan_impl="xla")
    x_q, x_d = index["x_q"], index["x_d"]
    gt = np.argsort(((x_d[None] - x_q[:, None]) ** 2).sum(-1), axis=1)[:, :K]
    outs = e_j.probe(x_q)
    thrs = np.array([0.0] + [_threshold(outs, f) for f in (0.3, 0.6, 0.9)])
    rows_j = e_j.sweep(x_q, gt, K, thrs, warmup=False)
    rows_t = e_t.sweep(x_q, gt, K, thrs, warmup=False)
    # SweepRow inputs too: the one-pass analytic sweep of both packages
    rng = np.random.default_rng(1)
    n_bkt = index["n_bkt"]
    gtb = rng.integers(-1, n_bkt, size=(len(x_q), K, 2)).astype(np.int32)
    hit = rng.random((len(x_q), K, 2)) < 0.6
    sizes = e_t.sizes
    sw_j = j_threshold_sweep(outs, gtb, hit, sizes, K)
    sw_t = t_threshold_sweep(outs, gtb, hit, sizes, K)
    for target in (0.0, 0.3, 0.6, 0.9, 1.01):
        for a, b in ((rows_j, rows_t), (sw_j, sw_t)):
            op_j, op_t = jtune.pick_threshold(a, target), ttune.pick_threshold(b, target)
            assert (op_j is None) == (op_t is None), target
            if op_j is not None:
                assert vars(op_j) == vars(op_t), target
        c_j = jtune.compare_at_recall(rows_j, sw_j, target)
        c_t = ttune.compare_at_recall(rows_t, sw_t, target)
        assert (c_j is None) == (c_t is None), target
        if c_j is not None:
            assert {k: vars(v) if k in "ab" else v for k, v in c_j.items()} == {
                k: vars(v) if k in "ab" else v for k, v in c_t.items()}
