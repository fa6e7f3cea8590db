"""The plain reference against brute-force numpy at tiny sizes, and the
probing model it writes down against the port's own."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from annbench.reference import ann


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    q = rng.standard_normal((40, 24)).astype(np.float32)
    d2b = np.stack([rng.integers(0, 12, 3000), rng.integers(-1, 12, 3000)], 1).astype(np.int32)
    return x, q, d2b


def np_dist(q, x):
    return ((q.astype(np.float64)[:, None, :] - x.astype(np.float64)[None]) ** 2).sum(-1)


def test_exact_knn_matches_numpy(data):
    x, q, _ = data
    got = ann.exact_knn(torch.as_tensor(q), torch.as_tensor(x), 10, chunk_q=16, chunk_x=700)
    want = np.argsort(np_dist(q, x), axis=1, kind="stable")[:, :10]
    assert np.array_equal(got, want)


def test_buckets_match_numpy(data):
    _, _, d2b = data
    b = ann.Buckets(d2b, 12)
    for k in range(12):
        want = np.unique(np.nonzero((d2b == k).any(1))[0])
        assert np.array_equal(b.members(k).numpy(), want)
    assert b.sizes.sum() == len(b.ids)


def test_topk_in_probed_matches_numpy(data):
    x, q, d2b = data
    rng = np.random.default_rng(1)
    probed = rng.random((len(q), 12)) < 0.3
    probed[:, 0] = True
    b = ann.Buckets(d2b, 12)
    ids, dist = ann.topk_in_probed(torch.as_tensor(q), torch.as_tensor(x), probed, b, 10, "f64")
    few = ann.topk_in_probed(torch.as_tensor(q), torch.as_tensor(x), probed, b, 10, "f64",
                             max_pairs=700)  # a query at a time, as for an outsized bucket
    assert np.array_equal(few[0], ids) and np.allclose(few[1], dist, rtol=1e-12)
    full = np_dist(q, x)
    for i in range(len(q)):
        rows = np.unique(np.concatenate([b.members(k).numpy() for k in np.nonzero(probed[i])[0]]))
        order = rows[np.argsort(full[i, rows], kind="stable")][:10]
        assert np.array_equal(ids[i], order)
        assert np.allclose(dist[i], full[i, order], rtol=1e-12)


def test_select_rule():
    s = torch.tensor([[0.9, 0.1, 0.6, 0.2], [0.1, 0.2, 0.3, 0.05]], dtype=torch.float64)
    p = ann.select(s, 0.5, probe_cap=None).numpy()
    assert p.tolist() == [[True, False, True, False], [False, False, True, False]]
    assert ann.select(s, 0.5, probe_cap=1).numpy().tolist()[0] == [True, False, False, False]


def test_probe_matches_numpy_and_the_port():
    from lira_tpu_torch.models.probing_mlp import ProbingMLP

    rng = np.random.default_rng(2)
    n_bkt, d = 16, 24
    mlp = ProbingMLP(n_bkt, d, generator=torch.Generator().manual_seed(3))
    cents = rng.standard_normal((n_bkt, d)).astype(np.float32)
    mean, scale = rng.random(n_bkt).astype(np.float32) + 4, rng.random(n_bkt).astype(np.float32) + 1
    q = rng.standard_normal((50, d)).astype(np.float32)
    index = {"centroids": torch.as_tensor(cents), "scaler_mean": torch.as_tensor(mean),
             "scaler_scale": torch.as_tensor(scale),
             "mlp": {k: v.detach().clone() for k, v in mlp.state_dict().items()}}
    got = ann.probe_scores(torch.as_tensor(q), index, "f64").numpy()
    w = {k: v.double().numpy() for k, v in index["mlp"].items()}
    feat = (np.sqrt(np_dist(q, cents)) - mean) / scale
    relu = lambda a: np.maximum(a, 0)
    lin = lambda h, n: h @ w[f"{n}.weight"].T + w[f"{n}.bias"]
    dd = relu(lin(relu(lin(feat, "dist1")), "dist2"))
    vv = relu(lin(relu(lin(q.astype(np.float64), "vec1")), "vec2"))
    want = 1 / (1 + np.exp(-lin(relu(lin(np.concatenate([dd, vv], 1), "head1")), "head2")))
    assert np.allclose(got, want, rtol=1e-10, atol=1e-12)
    with torch.no_grad():
        port = mlp(torch.as_tensor(feat, dtype=torch.float32), torch.as_tensor(q)).numpy()
    assert np.allclose(got, port, atol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, 3.0e38, float("inf")])
    r = ann.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie rounds to even
    assert r[2] == 1.0 + 2**-9 and torch.isinf(r[4])
    bits = ann.round_tf32(torch.randn(1000)).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


def _reference(x, cents, d2b):
    from annbench.core.check import Reference

    n_bkt = len(cents)
    raw = {"centroids": cents, "scaler_mean": np.zeros(n_bkt, np.float32),
           "scaler_scale": np.ones(n_bkt, np.float32), "mlp": {}, "data_2_bkt": d2b}
    return Reference(raw, x, "cpu")


def test_assign_gap_matches_numpy(data):
    x, _, _ = data
    rng = np.random.default_rng(4)
    cents = rng.standard_normal((12, 24)).astype(np.float32)
    full = np_dist(x, cents)
    nearest = full.argmin(1)
    second = np.argsort(full, 1)[:, 1]
    scale = (x.astype(np.float64) ** 2).sum(1) + (cents.astype(np.float64) ** 2).sum(1)[nearest]
    d2b = np.stack([nearest, np.full(len(x), -1)], 1).astype(np.int32)
    ref = _reference(x, cents, d2b)
    assert ref.assign_gap(chunk=700) == 0.0
    assert np.array_equal(ref.nearest("f64", chunk=700)[:, 0], nearest)
    # a replica in a farther bucket is fine while the nearest is listed too
    d2b[:, 1] = second
    assert ref.assign_gap(d2b, chunk=700) == 0.0
    # rows moved out of their nearest bucket read their excess over the scale
    moved = d2b.copy()
    moved[[3, 9], 0] = second[[3, 9]]
    moved[[3, 9], 1] = -1
    want = max((full[i, second[i]] - full[i, nearest[i]]) / scale[i] for i in (3, 9))
    assert np.isclose(ref.assign_gap(moved, chunk=700), want, rtol=1e-9)
    for bad in (-1, 12):  # a listed bucket that is no bucket
        broken = d2b.copy()
        broken[5, 0 if bad == -1 else 1] = bad
        assert ref.assign_gap(broken) == 1.0


def test_recall_counts_shared_ids():
    from annbench.core.check import recall, recall_miss

    knn = np.array([[1, 2, 3], [4, 5, 6]])
    got = np.array([[3, 2, 9], [-1, -1, -1]])
    assert recall(got, knn, 3) == (2 / 3 + 0) / 2
    assert recall(got[:0], knn[:0], 3) is None and recall_miss(None) == 1.0
