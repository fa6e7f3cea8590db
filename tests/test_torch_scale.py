"""The scale scripts and their pieces, at a tiny size on the CPU:
lira_tpu_torch against lira_tpu on the same numpy inputs.

  * Generator-signature sidecars: the same `<path>.sig` file and rules in
    both packages (a missing sidecar matches, a wrong one does not), so a
    cache either package's demo writes is read by the other's.
  * The port's `synthetic_dataset` draws its ambient noise in row chunks;
    the corpus stays byte-identical to lira_tpu's one draw.
  * scripts/torch_50m_demo.py's streamed pass against lira_tpu's chunk
    program (tpu_50m_demo.py's, rebuilt here from lira_tpu's own modules:
    l2_to_centroids, the scaler's moments, probing_mlp.forward) with the
    same chunk, centroids, scaler and parameters: assignments and
    predicted-nprobe counts exact; the chunked GT merge equal to lira_tpu's
    exact_knn over the whole set up to exact ties (distances within rtol
    1e-6).
  * scripts/torch_10m_demo.py end to end with --device cpu at 20,000 rows,
    16 buckets, 64 queries, 1 epoch: at threshold 0 (every bucket probed)
    the served neighbour sets equal a numpy brute force, up to ties.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lira_tpu.io import datasets as jds
from lira_tpu.models.probing_mlp import forward as j_forward
from lira_tpu.models.probing_mlp import init_params
from lira_tpu.ops.distance import l2_to_centroids as j_l2
from lira_tpu.ops.knn import exact_knn as j_exact_knn
from lira_tpu_torch.io import datasets as tds
from lira_tpu_torch.labels.scaler import StandardScaler
from lira_tpu_torch.models.probing_mlp import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"lira_tpu": jds, "lira_tpu_torch": tds}


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("reader", sorted(PACKAGES))
def test_sig_sidecar_read_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "cache.npy")
    sig = tds.hard_regime_sig()
    assert sig == jds.hard_regime_sig()
    assert PACKAGES[reader].check_sig_sidecar(path, sig)  # no sidecar: a match
    PACKAGES[writer].write_sig_sidecar(path, sig)
    assert not os.path.exists(path + ".sig.tmp")  # written through os.replace
    assert PACKAGES[reader].check_sig_sidecar(path, sig)
    assert not PACKAGES[reader].check_sig_sidecar(path, sig + "_retuned")
    with open(path + ".sig") as f:
        assert f.read() == sig + "\n"


@pytest.mark.parametrize("chunk", [7, 1000, 1 << 20])
def test_chunked_ambient_noise_is_byte_identical(monkeypatch, chunk):
    monkeypatch.setattr(tds, "_NOISE_CHUNK", chunk)
    kw = dict(n_base=1500, n_query=33, dim=32, compute_gt=False, **tds.HARD_REGIME)
    a, b = tds.synthetic_dataset(**kw), jds.synthetic_dataset(**kw)
    assert a.base.tobytes() == b.base.tobytes()
    assert a.query.tobytes() == b.query.tobytes()


def _lira_chunk_program(x, centroids, mean, scale, params, sigma=0.5):
    """tpu_50m_demo.py's `_chunk_assign_counts` body, from lira_tpu's modules."""
    d = j_l2(jnp.asarray(x), jnp.asarray(centroids))
    assign = jnp.argmin(d, axis=1).astype(jnp.int32)
    out = j_forward(params, (d - mean) / scale, jnp.asarray(x))
    return np.asarray(assign), np.asarray((out > sigma).sum(axis=1).astype(jnp.int32))


@pytest.fixture(scope="module")
def pass_inputs():
    rng = np.random.default_rng(3)
    n, n_q, d, n_bkt = 3000, 40, 16, 32
    x = (rng.standard_normal((n, d)) * 2.0).astype(np.float32)
    x_q = (x[rng.integers(0, n, n_q)] + 0.3 * rng.standard_normal((n_q, d))).astype(
        np.float32)
    centroids = x[rng.choice(n, n_bkt, replace=False)]
    dist = np.asarray(j_l2(jnp.asarray(x), jnp.asarray(centroids)))
    scaler = StandardScaler()
    scaler.mean_ = dist.mean(0).astype(np.float32)
    scaler.scale_ = dist.std(0).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(7), n_bkt, d))
    # a wide last bias: the untrained outputs spread to both sides of sigma
    params["head2"]["b"] = params["head2"]["b"] * 40.0
    return x, x_q, centroids, scaler, params


def test_50m_streamed_pass_matches_lira(pass_inputs):
    x, x_q, centroids, scaler, params = pass_inputs
    demo = _script("torch_50m_demo")
    assign, counts, gt = demo.streamed_pass(
        x, x_q, centroids, scaler, params_from_jax(params), k=10, chunk=700, block=256,
        device="cpu")
    a_j, c_j = _lira_chunk_program(x, centroids, scaler.mean_, scaler.scale_, params)
    np.testing.assert_array_equal(assign, a_j)
    np.testing.assert_array_equal(counts, c_j)
    assert 0 < counts.mean() < centroids.shape[0]  # the counts are not all one value

    _, gt_j = j_exact_knn(x, x_q, 10)
    assert gt.shape == gt_j.shape and gt.dtype == np.int64
    d64 = ((x_q.astype(np.float64)[:, None, :] - x.astype(np.float64)[None]) ** 2).sum(-1)
    for i in range(len(x_q)):
        if set(gt[i]) != set(gt_j[i]):  # only exact ties may differ
            np.testing.assert_allclose(np.sort(d64[i, gt[i]]), np.sort(d64[i, gt_j[i]]),
                                       rtol=1e-6)


def test_50m_chunk_program_any_block(pass_inputs):
    """Sub-blocks bound the workspace only: every block size gives the same
    assignment and counts."""
    import torch

    x, _, centroids, scaler, params = pass_inputs
    demo = _script("torch_50m_demo")
    model = params_from_jax(params)
    args = (torch.as_tensor(x), torch.as_tensor(centroids), torch.as_tensor(scaler.mean_),
            torch.as_tensor(scaler.scale_), model)
    whole = demo.chunk_assign_counts(*args, block=len(x))
    for block in (1, 333):
        part = demo.chunk_assign_counts(*args, block=block)
        assert torch.equal(part[0], whole[0]) and torch.equal(part[1], whole[1])


def test_10m_demo_cache_round_trip(tmp_path):
    demo = _script("torch_10m_demo")
    x_d, x_q, fresh = demo.make_corpus(3000, 20, 16, "hard", str(tmp_path))
    assert fresh
    cache = tmp_path / "syn10m_corpus_hard_3000_128_20.npz"
    assert jds.check_sig_sidecar(str(cache), jds.hard_regime_sig())  # lira_tpu reads it
    y_d, y_q, fresh = demo.make_corpus(3000, 20, 16, "hard", str(tmp_path))
    assert not fresh and np.array_equal(x_d, y_d) and np.array_equal(x_q, y_q)
    ref = jds.synthetic_dataset(n_base=3000, n_query=20, dim=128, compute_gt=False,
                                **jds.HARD_REGIME)
    assert ref.base.tobytes() == x_d.tobytes()
    tds.write_sig_sidecar(str(cache), "another generator")  # a retune: drawn again
    _, _, fresh = demo.make_corpus(3000, 20, 16, "hard", str(tmp_path))
    assert fresh


def test_10m_demo_end_to_end_cpu():
    demo = _script("torch_10m_demo")
    out = demo.main(["20000", "16", "64", "1", "--device", "cpu", "--batch", "128"],
                    thresholds=[0.0, 0.5], log=lambda m: None)
    x_d, x_q, eng = out["x_d"], out["x_q"], out["engine"]
    assert out["res"]["layout"].n_bkt == 16 and len(out["rows"]) == 2
    assert set(out["seconds"]) == {"gen", "gt", "pipeline", "engine", "serve"}
    r = eng.search(x_q, 0.0, 10)
    assert (r.nprobe == 16).all()  # threshold 0 probes every bucket
    d64 = ((x_q.astype(np.float64)[:, None, :] - x_d.astype(np.float64)[None]) ** 2).sum(-1)
    brute = np.argsort(d64, axis=1, kind="stable")[:, :10]
    for i in range(len(x_q)):
        got = r.ids[i]
        assert len(set(got)) == 10 and (got >= 0).all()
        if set(got) != set(brute[i]):  # only exact ties may differ
            np.testing.assert_allclose(np.sort(d64[i, got]), d64[i, brute[i]], rtol=1e-6)
    assert out["rows"][0]["avg_recall"] == pytest.approx(
        float((r.ids[:, :, None] == out["gt"][:, None, :]).any(axis=1).mean()))


def test_scale_scripts_load_no_jax():
    """Both demos import in a fresh interpreter without loading jax or
    lira_tpu (their own imports: torch and lira_tpu_torch only)."""
    import subprocess
    import sys

    code = f"""
import importlib.util, sys
for name in ("torch_10m_demo", "torch_50m_demo"):
    spec = importlib.util.spec_from_file_location(name, {os.path.join(REPO, "scripts")!r}
                                                  + "/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "lira_tpu."))
       or m == "lira_tpu"]
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)

