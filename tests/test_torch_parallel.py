"""The sharded path of lira_tpu_torch (parallel/) on 4 gloo ranks on the
CPU, against lira_tpu's on a mesh of the same 4 devices, on the same numpy
inputs.  Every port case runs in ONE spawn of the ranks (a module fixture);
the parent builds the inputs and runs lira_tpu.

Held:
  * ShardedQueryEngine (f32, bf16, int8, capacity bf16/int8; the 'pallas'
    (K1's plain version here) and 'gather' local scans; probe_cap; an IVF
    prober; a 16-row tile; a skewed layout): nprobe and ndis exactly equal,
    neighbour-id sets equal to lira_tpu's on every query, f32 scores
    allclose (rtol 1e-5, atol 1e-4: ‖x‖² − 2x·q at d=16 summed in another
    order), search_stream == search.  lira_tpu runs its 'gather' scan for
    f32/bf16 (its 'pallas' scan interprets Pallas here; the two agree,
    tests/test_parallel.py) and its f32 engine is the reference for the
    int8 screen, whose margin is exhaustive at this size.
  * sharded_exact_knn / sharded_self_knn: ids equal, except between
    candidates whose distances tie to 1e-5 (relative).
  * sharded_kmeans_fit / assign: centroids allclose (1e-5 after one step,
    1e-3 after five: the all-reduce sums in another order), the objective
    to 1e-4, assignments exact.
  * dp_train_epoch: from the same parameters and batch order, with a
    padded tail batch: SGD parameters and loss to rtol 1e-4 / atol 1e-6
    (the update is linear in the summed gradient), Adam's loss to 1e-5 and
    parameters to atol 1e-5 (a tenth of one step's lr of 1e-4).
  * stream_to_shards: rank 0's shard and the per-rank row count.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lira_tpu.engine.ivf_baseline import ivf_probe_matrix as j_ivf
from lira_tpu.io.streaming import stream_to_shards as j_stream_to_shards
from lira_tpu.io.xvecs import write_xvecs
from lira_tpu.labels.scaler import StandardScaler as JScaler
from lira_tpu.models.probing_mlp import init_params
from lira_tpu.models.train import TrainState as JTrainState
from lira_tpu.ops.distance import l2_to_centroids
from lira_tpu.parallel.mesh import make_mesh as j_make_mesh
from lira_tpu.parallel.sharded_engine import ShardedQueryEngine as JSharded
from lira_tpu.parallel.sharded_kmeans import sharded_kmeans_assign as j_km_assign
from lira_tpu.parallel.sharded_kmeans import sharded_kmeans_fit as j_km_fit
from lira_tpu.parallel.sharded_knn import sharded_exact_knn as j_knn
from lira_tpu.parallel.sharded_knn import sharded_self_knn as j_self_knn
from lira_tpu.parallel.train_dp import dp_train_epoch as j_dp_epoch
from lira_tpu.partition.assign import build_bucket_layout as j_layout
from lira_tpu.partition.kmeans import kmeans_fit as j_kmeans_fit
from lira_tpu_torch.engine.ivf_baseline import ivf_probe_matrix as t_ivf
from lira_tpu_torch.io.streaming import stream_to_shards
from lira_tpu_torch.labels.scaler import StandardScaler
from lira_tpu_torch.models.probing_mlp import ProbingMLP, params_from_jax
from lira_tpu_torch.models.train import TrainState, train_state_from_jax
from lira_tpu_torch.parallel import launch_many, serve_rank
from lira_tpu_torch.parallel.sharded_kmeans import sharded_kmeans_assign, sharded_kmeans_fit
from lira_tpu_torch.parallel.sharded_knn import sharded_exact_knn, sharded_self_knn
from lira_tpu_torch.parallel.train_dp import dp_train_epoch
from lira_tpu_torch.partition.assign import build_bucket_layout as t_layout
from lira_tpu_torch.partition.kmeans import kmeans_assign

N_RANKS = 4
K = 5
THRESHOLDS = (0.0, 0.5, 1.1)
IVF_THRESHOLDS = (1.0 - 0.5 / 10, 1.0 - 3.5 / 10)  # 1 and 4 of 10 buckets
KNN_BUDGET = 50 * 4 * 256  # two 256-row chunks a rank: chunking and padding

# (name, port engine kwargs, lira_tpu kwargs of the reference engine, tile, layout)
ENGINE_CASES = [
    ("f32-pallas", dict(local_impl="pallas"), dict(local_impl="gather"), 128, "index"),
    ("f32-gather", dict(local_impl="gather"), dict(local_impl="gather"), 128, "index"),
    ("bf16-pallas", dict(local_impl="pallas", scan_dtype="bfloat16"),
     dict(local_impl="gather", scan_dtype="bfloat16"), 128, "index"),
    ("bf16-gather", dict(local_impl="gather", scan_dtype="bfloat16"),
     dict(local_impl="gather", scan_dtype="bfloat16"), 128, "index"),
    ("int8-pallas", dict(local_impl="pallas", scan_dtype="int8"),
     dict(local_impl="gather"), 128, "index"),
    ("capacity-bf16-pallas", dict(local_impl="pallas", scan_dtype="bfloat16", store_f32=False),
     dict(local_impl="gather"), 128, "index"),
    ("capacity-bf16-gather", dict(local_impl="gather", scan_dtype="bfloat16", store_f32=False),
     dict(local_impl="gather"), 128, "index"),
    ("capacity-int8-pallas", dict(local_impl="pallas", scan_dtype="int8", store_f32=False),
     dict(local_impl="gather"), 128, "index"),
    ("probe-cap-pallas", dict(local_impl="pallas", probe_cap=4),
     dict(local_impl="gather", probe_cap=4), 128, "index"),
    ("ivf-prober-pallas", dict(local_impl="pallas"), dict(local_impl="gather"), 128, "index"),
    ("tile16-gather", dict(local_impl="gather"), dict(local_impl="gather"), 16, "index"),
    ("skewed-pallas", dict(local_impl="pallas"), dict(local_impl="gather"), 128, "skewed"),
    ("skewed-gather", dict(local_impl="gather"), dict(local_impl="gather"), 128, "skewed"),
]


def _scaler(raw):
    js = JScaler().fit(raw)
    ts = StandardScaler()
    ts.mean_, ts.scale_ = np.asarray(js.mean_, np.float32), np.asarray(js.scale_, np.float32)
    return js, ts


@pytest.fixture(scope="module")
def setup(tiny_dataset, tmp_path_factory):
    """Inputs for every case, the port's answers from one spawn of
    N_RANKS gloo ranks, and lira_tpu's on a mesh of N_RANKS devices."""
    rng = np.random.default_rng(3)
    x_d, x_q = tiny_dataset.base, tiny_dataset.query
    n, dim = x_d.shape
    n_bkt = 10
    d2b = np.full((n, 2), -1, dtype=np.int32)
    d2b[:, 0] = rng.integers(0, n_bkt, size=n)
    sel = rng.random(n) < 0.15
    d2b[sel, 1] = rng.integers(0, n_bkt, size=sel.sum())
    # one giant bucket and tiny ones: tiles of one bucket span ranks
    skew = np.minimum(rng.integers(0, 60, size=n), n_bkt - 1).astype(np.int32)[:, None]
    km = j_kmeans_fit(x_d, n_bkt, niter=3, seed=0)
    cents = np.asarray(km.centroids)
    raw = np.asarray(l2_to_centroids(jnp.asarray(x_d), jnp.asarray(cents)))
    j_sc, t_sc = _scaler(raw)
    params = init_params(jax.random.PRNGKey(0), n_bkt, dim)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assigns = {"index": d2b, "skewed": skew}

    reqs = [("search", (x_q, thr, K), {}) for thr in THRESHOLDS] + [
        ("search_stream", (x_q, 0.5, K), dict(batch_size=16))]
    ivf_reqs = [("search", (x_q, thr, K), {}) for thr in IVF_THRESHOLDS] + [
        ("search_stream", (x_q, IVF_THRESHOLDS[1], K), dict(batch_size=16))]
    calls = []
    for name, t_kw, _, tile, lay in ENGINE_CASES:
        kw = dict(t_kw)
        if name.startswith("ivf"):
            kw["prober"] = functools.partial(t_ivf, centroids=cents, device="cpu")
        calls.append((serve_rank, (x_d, t_layout(assigns[lay], n_bkt, tile=tile), cents, t_sc,
                                   model, ivf_reqs if name.startswith("ivf") else reqs), kw))

    # kNN: a query set and the corpus itself, in chunks
    calls.append((sharded_exact_knn, (x_d, x_q, 10), dict(score_budget=KNN_BUDGET)))
    calls.append((sharded_self_knn, (x_d[:1000], 7), dict(score_budget=KNN_BUDGET)))

    # K-Means: uneven n (shard padding weights), pinned init, and seeded draws
    xk = x_d[:1997]
    init, reseed = xk[:12].copy(), xk[100:112].copy()
    for niter in (1, 5):
        calls.append((sharded_kmeans_fit, (xk, 12), dict(niter=niter, init_centroids=init,
                                                         reseed_vectors=reseed)))
    calls.append((sharded_kmeans_fit, (xk, 12), dict(niter=2, seed=7)))
    calls.append((sharded_kmeans_assign, (xk, init), dict(chunk_rows=100)))

    # DP training: 100 rows at global batch 64, so the tail batch is padded
    n_dp, n_bkt_dp, dim_dp = 100, 4, 8
    dist = rng.normal(size=(n_dp, n_bkt_dp)).astype(np.float32)
    vec = rng.normal(size=(n_dp, dim_dp)).astype(np.float32)
    targets = (rng.random((n_dp, n_bkt_dp)) < 0.3).astype(np.float32)
    p_dp = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(1), n_bkt_dp,
                                                          dim_dp))
    adam = optax.adam(1e-4, eps=1e-8)
    sgd = optax.sgd(0.1)
    t_adam = train_state_from_jax(p_dp, adam.init(p_dp), device="cpu")
    sgd_model = params_from_jax(p_dp)
    t_sgd = TrainState(model=sgd_model, opt=torch.optim.SGD(sgd_model.parameters(), lr=0.1))
    for st in (t_adam, t_sgd):
        calls.append((dp_train_epoch, (st, ), dict(dist=dist, vec=vec, targets=targets,
                                                   global_batch=64)))

    # streaming: an fvecs file, row-sharded
    path = str(tmp_path_factory.mktemp("stream") / "s.fvecs")
    write_xvecs(path, x_d[:777])
    calls.append((stream_to_shards, (path,), dict(chunk_rows=50)))

    # the ranks run while this process computes lira_tpu's answers
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(launch_many, N_RANKS, calls, backend="gloo", device="cpu")

    mesh = j_make_mesh(N_RANKS)
    ref, by_key = {}, {}  # cases with one reference engine share its answers
    for name, _, j_kw, tile, lay in ENGINE_CASES:
        ivf = name.startswith("ivf")
        key = (repr(sorted(j_kw.items())), tile, lay, ivf)
        if key not in by_key:
            kw = dict(j_kw)
            if ivf:
                kw["prober"] = lambda q: j_ivf(q, cents)
            eng = JSharded(x_d, j_layout(assigns[lay], n_bkt, tile=tile), cents, j_sc, params,
                           mesh, **kw)
            by_key[key] = [eng.search(x_q, t, K) for t in (IVF_THRESHOLDS if ivf else THRESHOLDS)]
        ref[name] = by_key[key]
    out = fut.result(timeout=600)
    pool.shutdown()
    n_eng = len(ENGINE_CASES)
    return dict(out=out, ref=ref, n_eng=n_eng, mesh=mesh, x_d=x_d, x_q=x_q, xk=xk,
                init=init, reseed=reseed, dp=(dist, vec, targets, p_dp, adam, sgd),
                path=path, assigns=assigns, n_bkt=n_bkt)


def _sets(ids):
    return [set(int(v) for v in row if v >= 0) for row in ids]


@pytest.mark.parametrize("case", range(len(ENGINE_CASES)), ids=[c[0] for c in ENGINE_CASES])
def test_sharded_engine_matches_lira_tpu(setup, case):
    name = ENGINE_CASES[case][0]
    got = setup["out"][case]
    res, want = got["results"], setup["ref"][name]
    assert [r["rank"] for r in got["ranks"]] == list(range(N_RANKS))
    assert {r["local_impl"] for r in got["ranks"]} == {ENGINE_CASES[case][1]["local_impl"]}
    for r_t, r_j in zip(res, want):
        np.testing.assert_array_equal(r_t.nprobe, r_j.nprobe)
        np.testing.assert_array_equal(r_t.ndis, r_j.ndis)
        assert _sets(r_t.ids) == _sets(r_j.ids), name
        if "capacity" in name or not any(s in name for s in ("bf16", "int8")):
            valid = r_t.ids >= 0
            np.testing.assert_allclose(np.where(valid, r_t.scores, 0),
                                       np.where(valid, np.asarray(r_j.scores), 0),
                                       rtol=1e-5, atol=1e-4)
    # search_stream (batches of 16, an uneven tail) == search
    stream, same_thr = res[-1], res[1]
    np.testing.assert_array_equal(stream.ids, same_thr.ids)
    np.testing.assert_array_equal(stream.nprobe, same_thr.nprobe)
    np.testing.assert_array_equal(stream.ndis, same_thr.ndis)


def _assert_knn_equal_up_to_ties(base, query, ids_t, ids_j, k):
    d = ((query[:, None, :].astype(np.float64) - base[None, :, :]) ** 2).sum(-1)
    for i in range(len(query)):
        if np.array_equal(ids_t[i], ids_j[i]):
            continue
        a, b = d[i, ids_t[i]], d[i, ids_j[i]]
        np.testing.assert_allclose(np.sort(a), np.sort(b), rtol=1e-5)


def test_sharded_exact_knn_matches_lira_tpu(setup):
    x_d, x_q = setup["x_d"], setup["x_q"]
    sc_t, ids_t = setup["out"][setup["n_eng"]]
    sc_j, ids_j = j_knn(x_d, x_q, 10, setup["mesh"], score_budget=KNN_BUDGET)
    assert ids_t.shape == (len(x_q), 10) and ids_t.dtype == np.int32
    _assert_knn_equal_up_to_ties(x_d, x_q, ids_t, np.asarray(ids_j), 10)
    np.testing.assert_allclose(sc_t, sc_j, rtol=1e-5, atol=1e-4)


def test_sharded_self_knn_matches_lira_tpu(setup):
    x = setup["x_d"][:1000]
    ids_t = setup["out"][setup["n_eng"] + 1]
    ids_j = np.asarray(j_self_knn(x, 7, setup["mesh"], score_budget=KNN_BUDGET))
    assert ids_t.shape == (1000, 7)
    assert not (ids_t == np.arange(1000)[:, None]).any()  # self hit dropped
    _assert_knn_equal_up_to_ties(x, x, ids_t, ids_j, 7)


@pytest.mark.parametrize("which,niter,tol", [(0, 1, 1e-5), (1, 5, 1e-3)])
def test_sharded_kmeans_fit_matches_lira_tpu(setup, which, niter, tol):
    km_t = setup["out"][setup["n_eng"] + 2 + which]
    km_j = j_km_fit(setup["xk"], 12, setup["mesh"], niter=niter,
                    init_centroids=setup["init"], reseed_vectors=setup["reseed"])
    np.testing.assert_allclose(km_t.centroids, km_j.centroids, rtol=tol, atol=tol)
    np.testing.assert_allclose(km_t.objective, km_j.objective, rtol=1e-4)
    assert len(km_t.objective) == niter


def test_sharded_kmeans_seeded_draws_and_assign(setup):
    """The seeded init/reseed draws are lira_tpu's; the sharded assignment
    of one set of centroids (in 100-row chunks) is exact on every row,
    against lira_tpu's and against the single-device kmeans_assign."""
    xk = setup["xk"]
    km_t = setup["out"][setup["n_eng"] + 4]
    km_j = j_km_fit(xk, 12, setup["mesh"], niter=2, seed=7)
    np.testing.assert_allclose(km_t.centroids, km_j.centroids, rtol=1e-4, atol=1e-4)
    a_t = setup["out"][setup["n_eng"] + 5]
    assert a_t.shape == (len(xk),) and a_t.dtype == np.int32
    np.testing.assert_array_equal(a_t, np.asarray(j_km_assign(xk, setup["init"], setup["mesh"])))
    np.testing.assert_array_equal(a_t, kmeans_assign(xk, setup["init"], device="cpu"))


def _dp_ref(setup, which):
    dist, vec, targets, p_dp, adam, sgd = setup["dp"]
    tx = adam if which == 0 else sgd
    params = jax.tree_util.tree_map(jnp.asarray, p_dp)
    st = JTrainState(params=params, opt_state=tx.init(params), tx=tx)
    return j_dp_epoch(st, setup["mesh"], dist, vec, targets, global_batch=64)


@pytest.mark.parametrize("which,ltol,rtol,atol", [(0, 1e-5, 0.0, 1e-5), (1, 1e-4, 1e-4, 1e-6)],
                         ids=["adam", "sgd"])
def test_dp_train_epoch_matches_lira_tpu(setup, which, ltol, rtol, atol):
    from lira_tpu_torch.models.probing_mlp import params_to_jax

    st_t, loss_t = setup["out"][setup["n_eng"] + 6 + which]
    st_j, loss_j = _dp_ref(setup, which)
    assert loss_t == pytest.approx(float(loss_j), rel=ltol)
    p_t = params_to_jax(st_t.model)
    for layer, leaves in p_t.items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(v, np.asarray(st_j.params[layer][leaf]),
                                       rtol=rtol, atol=atol, err_msg=f"{layer}.{leaf}")


def test_stream_to_shards_matches_lira_tpu(setup):
    buf, per = setup["out"][setup["n_eng"] + 8]
    arr, per_j = j_stream_to_shards(setup["path"], setup["mesh"], chunk_rows=50)
    assert per == per_j == 256  # ceil(777 / 4) rounded up to 128 rows
    np.testing.assert_array_equal(buf.numpy(), np.asarray(arr)[0])


def test_a_failed_rank_fails_the_launch(setup):
    """A rank's exception is raised in the caller with the rank's
    traceback as a note; no rank carries on."""
    x_d = setup["x_d"]
    lay = t_layout(setup["assigns"]["index"], setup["n_bkt"])
    sc = StandardScaler()
    sc.mean_ = sc.scale_ = np.ones(setup["n_bkt"], np.float32)
    with pytest.raises(ValueError, match="request 'nope'") as info:
        launch_many(2, [(serve_rank, (x_d, lay, x_d[:10], sc,
                                      ProbingMLP(setup["n_bkt"], x_d.shape[1]),
                                      [("nope", (), {})]), dict(local_impl="gather"))],
                    backend="gloo", device="cpu")
    assert "in a spawned rank" in "".join(getattr(info.value, "__notes__", []))


def test_no_fallback_from_the_card_or_from_nccl():
    """A rank asks for the card unless told cpu, and raises without one;
    nccl takes one card a rank and refuses CPU ranks, before any spawn."""
    from lira_tpu_torch.parallel import launch, make_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(0, 1, backend="gloo")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch(2, sharded_kmeans_fit, None, 4, backend="gloo")
    with pytest.raises(ValueError, match="CPU ranks take backend='gloo'"):
        launch(2, sharded_kmeans_fit, None, 4, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend="):
        make_mesh(0, 1, backend="mpi", device="cpu")
