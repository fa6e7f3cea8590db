"""lira_tpu_torch's host layer, ops, K-Means, scaler and probing MLP against
lira_tpu on the same numpy inputs (device="cpu").

Exact: corpora (byte-identical), xvecs files, bucket layouts, the tour
rank, the top-k tie rule, grouped_topk's values and (without ties) its
indices, and K-Means assignments.  allclose (f32 sums in another order):
distances rtol 1e-5, centroids rtol 1e-4, scaler moments rtol 1e-5, MLP
outputs atol 1e-6.  Also profiling's device_trace and the stage timers'
spans on the CPU, and scripts/torch_trace_spans.py on a made trace.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lira_tpu.io import datasets as jds
from lira_tpu.io.xvecs import read_xvecs
from lira_tpu.labels.scaler import scaled_centroid_distances as j_scaled
from lira_tpu.models.probing_mlp import forward as j_forward
from lira_tpu.models.probing_mlp import init_params
from lira_tpu.ops import distance as jdist
from lira_tpu.ops.topk import grouped_topk as j_grouped_topk
from lira_tpu.partition import assign as jassign
from lira_tpu.partition import kmeans as jkm
from lira_tpu.partition.order import centroid_tour_rank as j_rank
from lira_tpu_torch import resolve_device, true_fp32
from lira_tpu_torch.io import datasets as tds
from lira_tpu_torch.labels.scaler import scaled_centroid_distances as t_scaled
from lira_tpu_torch.models.probing_mlp import ProbingMLP, params_from_jax, params_to_jax
from lira_tpu_torch.ops import distance as tdist
from lira_tpu_torch.ops.topk import grouped_topk, top_k
from lira_tpu_torch.logging_utils import stage_timer
from lira_tpu_torch.profiling import device_trace
from lira_tpu_torch.partition import assign as tassign
from lira_tpu_torch.partition import kmeans as tkm
from lira_tpu_torch.partition.order import centroid_tour_rank as t_rank


@pytest.mark.parametrize("hard", [False, True])
def test_synthetic_dataset_byte_identical(hard):
    kw = dict(n_base=2000, n_query=50, dim=32, k_gt=20)
    if hard:
        kw.update(jds.HARD_REGIME)
    a, b = jds.synthetic_dataset(**kw), tds.synthetic_dataset(**kw)
    assert a.base.tobytes() == b.base.tobytes()
    assert a.query.tobytes() == b.query.tobytes()
    np.testing.assert_array_equal(a.groundtruth, b.groundtruth)
    assert tds.HARD_REGIME == jds.HARD_REGIME
    assert tds.hard_regime_sig() == jds.hard_regime_sig()


def test_dataset_files_round_trip(tmp_path, tiny_dataset):
    d = tds.write_dataset(tds.DatasetBundle("toy", tiny_dataset.base, tiny_dataset.query,
                                            tiny_dataset.groundtruth), str(tmp_path))
    b = jds.load_data("toy", str(tmp_path))
    np.testing.assert_array_equal(b.base, tiny_dataset.base)
    np.testing.assert_array_equal(read_xvecs(os.path.join(d, "toy_groundtruth.ivecs")),
                                  tiny_dataset.groundtruth)
    t = tds.load_data("toy", str(tmp_path))
    np.testing.assert_array_equal(t.query, tiny_dataset.query)


def test_bucket_layout_and_tour_rank_identical():
    rng = np.random.default_rng(3)
    d2b = rng.integers(-1, 9, size=(500, 2)).astype(np.int32)
    a = jassign.build_bucket_layout(d2b, 9, tile=128, use_native=False)
    b = tassign.build_bucket_layout(d2b, 9, tile=128)
    for f in ("offsets", "ids", "padded_offsets", "padded_ids"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    c = rng.normal(size=(40, 8)).astype(np.float32)
    np.testing.assert_array_equal(j_rank(c), t_rank(c))


def test_distances_match():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    c = rng.normal(size=(11, 16)).astype(np.float32)
    for metric in ("L2", "inner_product"):
        np.testing.assert_allclose(
            tdist.pairwise_scores(torch.from_numpy(q), torch.from_numpy(c), metric).numpy(),
            np.asarray(jdist.pairwise_scores(jnp.asarray(q), jnp.asarray(c), metric)),
            rtol=1e-5, atol=1e-5,
        )
    np.testing.assert_allclose(
        tdist.l2_to_centroids(torch.from_numpy(q), torch.from_numpy(c)).numpy(),
        np.asarray(jdist.l2_to_centroids(jnp.asarray(q), jnp.asarray(c))),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_array_equal(tdist.row_sqnorms(q), jdist.row_sqnorms(q))


def test_top_k_follows_lax_tie_rule():
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, size=(64, 50)).astype(np.float32)  # many ties
    x[:, 7] = -np.inf
    x[3] = 1.0  # a row of one value
    for k in (1, 5, 50):
        v_j, i_j = jax.lax.top_k(jnp.asarray(x), k)
        v_t, i_t = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("c,k,group", [(64, 10, 128), (200, 1, 32), (1000, 10, 32),
                                       (5000, 100, 32), (4099, 7, 128)])
def test_grouped_topk_matches_lira_tpu(c, k, group):
    """Narrow rows (one top-k), strided groups with +inf padding (c % group
    != 0); values exact, indices exact where no two scores tie."""
    rng = np.random.default_rng(c)
    scores = rng.permutation(17 * c).astype(np.float32).reshape(17, c)  # no ties
    v_j, i_j = j_grouped_topk(jnp.asarray(scores), k, group=group)
    v_t, i_t = grouped_topk(torch.from_numpy(scores), k, group=group)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(i_t.numpy(), np.argsort(scores, axis=1)[:, :k])


def test_grouped_topk_with_ties_points_at_equal_values():
    rng = np.random.default_rng(9)
    scores = rng.integers(0, 50, size=(9, 3000)).astype(np.float32)
    v_t, i_t = grouped_topk(torch.from_numpy(scores), 20, group=64)
    v_j, _ = j_grouped_topk(jnp.asarray(scores), 20, group=64)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(np.take_along_axis(scores, i_t.numpy(), 1), v_t.numpy())
    assert all(len(set(r)) == 20 for r in i_t.numpy())


def test_stage_timer_prints_and_opens_a_span(tmp_path, capsys):
    """stage_timer prints its `>> <stage> time:` line, on a failing stage
    too, and under a profiler opens a span of the stage's name."""
    import io
    import json

    log = io.StringIO()
    with device_trace(str(tmp_path / "tr"), device="cpu"):
        with stage_timer("training", log), stage_timer("training epoch", log):
            torch.ones(8) + 1
    with pytest.raises(ValueError), stage_timer("failing", log):
        raise ValueError
    lines = log.getvalue().splitlines()
    assert [ln.split(" time: ")[0] for ln in lines] == [
        ">> training epoch", ">> training", ">> failing"]
    assert capsys.readouterr().out.splitlines() == lines
    with open(tmp_path / "tr" / "trace.json") as f:
        spans = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    outer, inner = sorted(spans, key=lambda e: e["ts"])
    assert (outer["name"], inner["name"]) == ("training", "training epoch")
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_trace_spans_script_splits_a_made_trace():
    """scripts/torch_trace_spans.py on a made trace: a root span `call`
    holding `a` and `b`; a kernel launched in `a`, one in `b`, one in the
    root between them; idle stretches whose middles fall in `a`, in the
    root, in `b`, and outside every span."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "torch_trace_spans.py"
    spec = importlib.util.spec_from_file_location("torch_trace_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def ev(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": args}

    events = [
        ev("user_annotation", "call", 0, 100),
        ev("user_annotation", "a", 10, 30), ev("user_annotation", "b", 60, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=3),
        ev("kernel", "k_a", 26, 19, tid=7, correlation=1),  # busy 26-45
        ev("kernel", "k_call", 52, 6, tid=7, correlation=2),  # busy 52-58
        ev("kernel", "k_b", 70, 10, tid=7, correlation=3),  # busy 70-80
        ev("cpu_op", "aten::x", 100, 40),  # the window runs to 140
    ]
    out = mod.summarize(events)
    sp = out["spans"]
    assert (out["window_s"], out["busy_s"]) == pytest.approx((140e-6, 35e-6))
    assert {n: sp[n]["n"] for n in sp if sp[n]["n"]} == {"call": 1, "a": 1, "b": 1}
    assert [sp[n]["host_self_s"] for n in ("call", "a", "b")] == pytest.approx(
        [40e-6, 30e-6, 30e-6])
    assert [sp[n]["device_s"] for n in ("call", "a", "b")] == pytest.approx(
        [6e-6, 19e-6, 10e-6])
    # idle 0-26 (middle in a), 45-52 (call), 58-70 (b), 80-140 (no span)
    assert [sp[n]["idle_s"] for n in ("call", "a", "b", mod.NO_SPAN)] == pytest.approx(
        [7e-6, 26e-6, 12e-6, 60e-6])


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with device_trace(str(tmp_path / "tr"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with device_trace(str(tmp_path / "tr2")):
                pass


@pytest.mark.parametrize("init", ["random", "kmeans++"])
def test_kmeans_matches(tiny_dataset, init):
    x = tiny_dataset.base
    a = jkm.kmeans_fit(x, 8, niter=5, seed=43, init=init, max_points_per_centroid=64,
                       chunk_rows=300)
    b = tkm.kmeans_fit(x, 8, niter=5, seed=43, init=init, max_points_per_centroid=64,
                       chunk_rows=300, device="cpu")
    np.testing.assert_allclose(b.centroids, a.centroids, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.objective, a.objective, rtol=1e-4)
    np.testing.assert_array_equal(tkm.kmeans_assign(x, a.centroids, device="cpu"),
                                  jkm.kmeans_assign(x, a.centroids))


def test_scaled_centroid_distances_match(tiny_dataset):
    x, q = tiny_dataset.base, tiny_dataset.query
    c = x[:9] + np.float32(0.5)  # no centroid sits on a data point (sqrt(0) cancellation)
    dist_j, dq_j, sc_j = j_scaled(x, q, c, chunk_rows=512)
    dist_t, dq_t, sc_t = t_scaled(x, q, c, chunk_rows=512, device="cpu")
    np.testing.assert_allclose(sc_t.mean_, sc_j.mean_, rtol=1e-5)
    np.testing.assert_allclose(sc_t.scale_, sc_j.scale_, rtol=1e-5)
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j), atol=1e-4)
    np.testing.assert_allclose(dq_t, dq_j, atol=1e-4)


def test_probing_mlp_carries_weights_across():
    n_bkt, dim = 12, 16
    params = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(1), n_bkt, dim))
    model = params_from_jax(params)
    back = params_to_jax(model)
    for layer in params:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back[layer][leaf], params[layer][leaf])
    rng = np.random.default_rng(6)
    xd = rng.normal(size=(10, n_bkt)).astype(np.float32)
    xv = rng.normal(size=(10, dim)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(xd), torch.from_numpy(xv)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_forward(params, xd, xv)), atol=1e-6)


def test_probing_mlp_init_is_seeded_and_bounded():
    a = ProbingMLP(12, 16, generator=torch.Generator().manual_seed(0))
    b = ProbingMLP(12, 16, generator=torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    assert float(a.dist1.weight.detach().abs().max()) <= 1 / np.sqrt(12)
    assert float(a.head2.bias.detach().abs().max()) <= 1 / np.sqrt(128)


def test_resolve_device():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)


def test_true_fp32_turns_tf32_off_and_restores():
    """The port's f32 products run in true fp32 (lira_tpu: precision=
    "highest"), and the caller's TF32 policy survives every call."""
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with true_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        inside = true_fp32()(lambda: torch.backends.cuda.matmul.allow_tf32)
        assert inside() is False
        resolve_device("cpu")
        tdist.pairwise_scores(torch.ones(2, 4), torch.ones(3, 4))
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv
