"""Training, labels, metrics, the evaluation scan, the sweep, redundancy
and the kNN cache: lira_tpu_torch against lira_tpu on the same numpy inputs.

Tolerances:
  * labels, bucket maps, recall and probing metrics: byte-equal (numpy in
    both packages);
  * training from the same parameters and Adam state over the same batch
    order: per-epoch losses rtol 1e-5, parameters atol 1e-5 (f32 products
    and sums in another order; optax and torch apply the same Adam step);
  * evaluate / infer outputs: atol 1e-6; predicted counts exact;
  * bucket_topk ids, threshold_sweep rows, redundancy rows: exact.
"""

import numpy as np
import pytest
import torch

from lira_tpu.engine import scan as jscan
from lira_tpu.engine import sweep as jsweep
from lira_tpu.io import cache as jcache
from lira_tpu.labels import distr as jdistr
from lira_tpu.models import metrics as jmetrics
from lira_tpu.models import train as jtrain
from lira_tpu.partition.assign import build_bucket_layout as j_build_layout
from lira_tpu.redundancy import assign as jred
from lira_tpu_torch.engine import scan as tscan
from lira_tpu_torch.engine import sweep as tsweep
from lira_tpu_torch.io import cache as tcache
from lira_tpu_torch.labels import distr as tdistr
from lira_tpu_torch.models import metrics as tmetrics
from lira_tpu_torch.models import train as ttrain
from lira_tpu_torch.partition.assign import build_bucket_layout
from lira_tpu_torch.redundancy import assign as tred

CPU = "cpu"
N_BKT, DIM = 16, 16


def _np_tree(tree):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}


def _assignments(rng, n, n_bkt, n_mul):
    d2b = np.full((n, n_mul), -1, np.int32)
    d2b[:, 0] = rng.integers(0, n_bkt, n)
    if n_mul > 1:
        extra = rng.random(n) < 0.4
        d2b[extra, 1] = rng.integers(0, n_bkt, int(extra.sum()))
    return d2b


@pytest.mark.parametrize("n_mul", [1, 2])
def test_labels_and_metrics_byte_equal(n_mul):
    rng = np.random.default_rng(3)
    n, k = 300, 6
    d2b = _assignments(rng, n, N_BKT, n_mul)
    knn = rng.integers(0, n, (n, k)).astype(np.int32)
    knn[rng.random((n, k)) < 0.1] = -1  # the -1 contract of knn_fused
    for fn in ("knn_bucket_labels", "knn_bucket_counts"):
        a = getattr(tdistr, fn)(knn, d2b, N_BKT)
        b = getattr(jdistr, fn)(knn, d2b, N_BKT)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    gb_t, gb_j = tdistr.gt_bucket_map(knn, d2b), jdistr.gt_bucket_map(knn, d2b)
    assert gb_t.dtype == gb_j.dtype and gb_t.tobytes() == gb_j.tobytes()
    predicts = rng.random((n, N_BKT)) < 0.3
    np.testing.assert_array_equal(tdistr.label_recall(predicts, gb_t, k),
                                  jdistr.label_recall(predicts, gb_j, k))
    targets = tdistr.knn_bucket_labels(knn, d2b, N_BKT)
    sizes = np.bincount(d2b[:, 0], minlength=N_BKT)
    assert (tmetrics.probing_metrics(predicts, targets, gb_t, sizes, k, epoch=1, loss=0.5)
            == jmetrics.probing_metrics(predicts, targets, gb_j, sizes, k, epoch=1, loss=0.5))


@pytest.fixture(scope="module")
def train_data():
    rng = np.random.default_rng(11)
    n = 2000
    dist = rng.normal(size=(n, N_BKT)).astype(np.float32)
    vec = rng.normal(size=(n, DIM)).astype(np.float32)
    tgt = (rng.random((n, N_BKT)) < 0.2).astype(np.float32)
    return dist, vec, tgt


@pytest.fixture(scope="module")
def jax_run(train_data):
    """lira_tpu: initial state, then 2 epochs at batch 64 with 640-row
    superbatches (the last one ragged: 80 rows padded to 128)."""
    dist, vec, tgt = train_data
    st0 = jtrain.make_train_state(43, N_BKT, DIM)
    st, losses = st0, []
    for _ in range(2):
        st, loss = jtrain.train_epoch(st, dist, vec, tgt, batch_size=64, super_rows=640)
        losses.append(loss)
    return st0, st, losses


def test_training_matches_lira(train_data, jax_run):
    dist, vec, tgt = train_data
    st0, st_j, losses_j = jax_run
    state = ttrain.train_state_from_jax(_np_tree(st0.params), st0.opt_state, device=CPU)
    losses = []
    for epoch in range(2):
        # epoch 0 from host arrays, epoch 1 from tensors: both feed paths
        if epoch == 0:
            args = (dist, vec, tgt)
        else:
            args = (torch.from_numpy(dist), torch.from_numpy(vec),
                    torch.from_numpy(tgt.astype(np.uint8)))
        state, loss = ttrain.train_epoch(state, *args, batch_size=64, super_rows=640)
        losses.append(loss)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    params, adam = ttrain.train_state_to_jax(state)
    want = _np_tree(st_j.params)
    for layer in want:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(params[layer][leaf], want[layer][leaf], atol=1e-5)
    assert int(adam["count"]) == int(st_j.opt_state[0].count) == 2 * 32


def test_train_state_round_trips(jax_run):
    _, st_j, _ = jax_run
    adam_j = st_j.opt_state[0]
    state = ttrain.train_state_from_jax(_np_tree(st_j.params), st_j.opt_state, device=CPU)
    params, adam = ttrain.train_state_to_jax(state)
    want = _np_tree(st_j.params)
    for layer in want:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(params[layer][leaf], want[layer][leaf])
            np.testing.assert_array_equal(adam["mu"][layer][leaf],
                                          np.asarray(adam_j.mu[layer][leaf]))
            np.testing.assert_array_equal(adam["nu"][layer][leaf],
                                          np.asarray(adam_j.nu[layer][leaf]))
    assert int(adam["count"]) == int(adam_j.count)


def test_evaluate_infer_counts_match_lira(train_data, jax_run):
    dist, vec, tgt = train_data
    _, st_j, _ = jax_run
    state = ttrain.train_state_from_jax(_np_tree(st_j.params), st_j.opt_state, device=CPU)
    t_t, p_t, loss_t, o_t = ttrain.evaluate(state, dist, vec, tgt, batch_size=64)
    t_j, p_j, loss_j, o_j = jtrain.evaluate(st_j, dist, vec, tgt, batch_size=64)
    np.testing.assert_array_equal(t_t, t_j)
    np.testing.assert_allclose(o_t, o_j, atol=1e-6)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert (p_t != p_j).sum() == 0
    pi_t, oi_t = ttrain.infer(state, dist, vec)
    pi_j, oi_j = jtrain.infer(st_j, dist, vec)
    np.testing.assert_array_equal(pi_t, pi_j)
    np.testing.assert_allclose(oi_t, oi_j, atol=1e-6)
    c_t = ttrain.predict_counts(state, torch.from_numpy(dist), vec, chunk=700)
    np.testing.assert_array_equal(c_t, jtrain.predict_counts(st_j, dist, vec))
    np.testing.assert_array_equal(c_t, pi_t.sum(axis=1))


def test_bucket_topk_and_sweep_match_lira():
    rng = np.random.default_rng(4)
    n, d, n_bkt, k = 900, 8, 12, 5
    x = rng.normal(size=(n, d)).astype(np.float32)
    xq = rng.normal(size=(40, d)).astype(np.float32)
    d2b = _assignments(rng, n, n_bkt - 2, 2)  # buckets 10, 11 empty
    d2b[:3, 0] = 9  # bucket 9 grows; bucket 8 is short below
    d2b[d2b == 8] = -1
    d2b[:2, 1] = 8
    d2b[d2b[:, 0] < 0, 0] = 0
    lay_t, lay_j = build_bucket_layout(d2b, n_bkt), j_build_layout(d2b, n_bkt)
    assert lay_t.sizes[8] == 2 and lay_t.sizes[10] == 0
    for metric in ("L2", "inner_product"):
        f_t = tscan.bucket_topk(xq, tscan.BucketCorpus.build(x, lay_t, device=CPU), k,
                                metric=metric, q_chunk=16)
        f_j = jscan.bucket_topk(xq, jscan.BucketCorpus.build(x, lay_j), k, metric=metric)
        np.testing.assert_array_equal(f_t, f_j)
    assert (f_t[:, 10] == -1).all() and (f_t[:, 8, 2:] == -1).all()

    gt = rng.integers(0, n, (40, k)).astype(np.int32)
    gb = tdistr.gt_bucket_map(gt, d2b)
    hit_t, hit_j = tsweep.gt_hit_tensor(f_t, gt, gb), jsweep.gt_hit_tensor(f_j, gt, gb)
    np.testing.assert_array_equal(hit_t, hit_j)
    outputs = rng.random((40, n_bkt)).astype(np.float32)
    thr = np.arange(0.1, 0.9, 0.1)
    rows_t = tsweep.threshold_sweep(outputs, gb, hit_t, lay_t.sizes, k, thr)
    rows_j = jsweep.threshold_sweep(outputs, gb, hit_j, lay_j.sizes, k, thr)
    assert [vars(r) for r in rows_t] == [vars(r) for r in rows_j]


@pytest.mark.parametrize("n_mul", [2, 3])
def test_redundancy_matches_lira(n_mul):
    rng = np.random.default_rng(6)
    n, n_bkt = 400, 10
    d2b = _assignments(rng, n, n_bkt, n_mul)
    scores = rng.random((n, n_bkt)).astype(np.float32)
    scores[:20] = np.round(scores[:20], 1)  # ties, broken to the lower index
    predicts = scores > 0.5
    selected = tred.select_top_ratio(predicts, 0.2)
    np.testing.assert_array_equal(selected, jred.select_top_ratio(predicts, 0.2))
    sel = np.sort(selected)
    np.testing.assert_array_equal(
        tred.apply_redundancy_subset(d2b, scores[sel], predicts[sel], sel, device=CPU),
        jred.apply_redundancy_subset(d2b, scores[sel], predicts[sel], sel))
    np.testing.assert_array_equal(
        tred.apply_redundancy(d2b, scores, predicts, sel, device=CPU),
        jred.apply_redundancy(d2b, scores, predicts, sel))


def test_knn_cache_is_shared_both_ways(tmp_path):
    rng = np.random.default_rng(8)
    knn = rng.integers(-1, 500, (500, 7)).astype(np.int32)
    for writer, reader in ((jcache, tcache), (tcache, jcache)):
        root = str(tmp_path / writer.__name__.split(".")[0])
        for metric in ("L2", "inner_product"):
            path = writer.save_knn_cache(root, "toy", knn, dim=16, method="flat",
                                         tag="sub", metric=metric)
            assert reader.find_knn_cache(root, "toy", 7, 500, tag="sub", metric=metric) == path
            np.testing.assert_array_equal(
                reader.load_knn_cache(root, "toy", 7, 500, tag="sub", metric=metric), knn)
            assert reader.read_knn_meta(path) == writer.read_knn_meta(path)
