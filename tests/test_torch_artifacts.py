"""Index artifacts, the TorchScript export, checkpoints, build_index and
search_cli: lira_tpu_torch (device="cpu") against lira_tpu, in both
directions, on one tiny dataset.

Held exactly: the artifact files' names, dtypes, shapes and manifest keys;
nprobe and ndis of an index built by one package and served by the other;
f32 neighbour-id sets (the data has no exact ties); `run_search` rows'
avg_nprobe, avg_cmp and avg_recall (timing fields excluded); checkpoint
key sets and arrays.  bf16/int8 neighbour sets are held to the numpy
oracle over the probed buckets.  The two .pt exports agree to atol 1e-6
(f32 products in another order at widths ≤ 128).  One epoch after a
cross-package checkpoint load: losses rtol 1e-5, parameters atol 1e-5,
tests/test_torch_train.py's tolerances.  Thresholds are the midpoints of
gaps ≥ 1e-5 between sorted probe outputs, so a last-bit difference in the
MLP cannot flip a bucket.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from lira_tpu.config import Config as JConfig
from lira_tpu.engine.serve import QueryEngine as JaxEngine
from lira_tpu.io import artifacts as jart
from lira_tpu.io.datasets import synthetic_dataset, write_dataset
from lira_tpu.models import checkpoint as jckpt
from lira_tpu.models import train as jtrain
from lira_tpu.partition.assign import build_bucket_layout as j_layout
from lira_tpu.pipelines import build_index as jbuild
from lira_tpu.pipelines import search_cli as jsearch
from lira_tpu_torch.config import Config as TConfig
from lira_tpu_torch.engine.serve import QueryEngine as TorchEngine
from lira_tpu_torch.io import artifacts as tart
from lira_tpu_torch.io.torch_export import export_torchscript_mlp
from lira_tpu_torch.models import checkpoint as tckpt
from lira_tpu_torch.models import train as ttrain
from lira_tpu_torch.models.probing_mlp import params_to_jax
from lira_tpu_torch.partition.assign import build_bucket_layout as t_layout
from lira_tpu_torch.pipelines import build_index as tbuild
from lira_tpu_torch.pipelines import search_cli as tsearch

K = 5
_BUILT: dict = {}  # one build per package per test process


def _bundle():
    """tests/conftest.py's tiny_dataset recipe."""
    return synthetic_dataset(n_base=2000, n_query=50, dim=16, n_clusters=8, k_gt=20, seed=43)


def lira_built_index(tmp_path_factory) -> dict:
    """lira_tpu's build_index on the tiny dataset, built once per test
    process: {"dir", "prefix", "cfg", "bundle", "data_path"}."""
    if "lira" not in _BUILT:
        root = str(tmp_path_factory.mktemp("lira_index"))
        bundle = _bundle()
        write_dataset(bundle, root)
        cfg = JConfig(dataset="synthetic", k=K, n_bkt=8, n_epoch=2, batch_size=64,
                      data_path=root).update()
        out_dir = os.path.join(root, "artifacts")
        jbuild.build_index(cfg, bundle=bundle, out_dir=out_dir, use_cache=False)
        _BUILT["lira"] = dict(dir=out_dir, prefix=cfg.file_name, cfg=cfg, bundle=bundle,
                              data_path=root)
    return _BUILT["lira"]


@pytest.fixture(scope="session")
def lira_index(tmp_path_factory):
    return lira_built_index(tmp_path_factory)


@pytest.fixture(scope="session")
def port_index(tmp_path_factory):
    """The port's build_index (device="cpu") on the same dataset and
    configuration."""
    root = str(tmp_path_factory.mktemp("port_index"))
    bundle = _bundle()
    write_dataset(bundle, root)
    cfg = TConfig(dataset="synthetic", k=K, n_bkt=8, n_epoch=2, batch_size=64,
                  data_path=root).update()
    out_dir = os.path.join(root, "artifacts")
    prefix = tbuild.build_index(cfg, bundle=bundle, out_dir=out_dir, use_cache=False,
                                device="cpu")
    assert prefix == os.path.join(out_dir, cfg.file_name)
    return dict(dir=out_dir, prefix=cfg.file_name, cfg=cfg, bundle=bundle, data_path=root)


def _thresholds(outputs: np.ndarray) -> list[float]:
    v = np.unique(outputs.ravel())
    out = []
    for frac in (0.5, 0.75, 0.9):
        j = int(frac * (len(v) - 1))
        while j + 1 < len(v) and v[j + 1] - v[j] < 1e-5:
            j += 1
        out.append(float((v[j] + v[j + 1]) / 2))
    return out


def _oracle_sets(x_d, x_q, layout, probed, k):
    """Exact k nearest among the members of each query's probed buckets."""
    sets = []
    for i in range(len(x_q)):
        members = np.unique(np.concatenate(
            [layout.bucket_members(b) for b in np.nonzero(probed[i])[0]]))
        dd = ((x_d[members] - x_q[i]) ** 2).sum(axis=1)
        sets.append(set(members[np.argsort(dd, kind="stable")][: min(k, len(members))]))
    return sets


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
def test_lira_index_served_by_the_port(lira_index, scan_dtype):
    """lira_tpu's artifacts → the port's loader and engine, against
    lira_tpu's engine on its own load."""
    art_j = jart.load_index_artifacts(lira_index["dir"], lira_index["prefix"])
    art_t = tart.load_index_artifacts(lira_index["dir"], lira_index["prefix"])
    m = art_t["manifest"]
    assert m == art_j["manifest"]
    x_q = lira_index["bundle"].query
    kw = dict(metric=m["metric"], n_mul=m["n_mul"], scan_dtype=scan_dtype,
              block_margin=tsearch.manifest_margin(m, scan_dtype))
    e_j = JaxEngine(art_j["x_d"], j_layout(art_j["data_2_bkt"], m["n_bkt"]),
                    art_j["centroids"], art_j["scaler"], art_j["params"],
                    **dict(kw, scan_impl="blocked" if scan_dtype == "int8" else "auto"))
    layout = t_layout(art_t["data_2_bkt"], m["n_bkt"])
    e_t = TorchEngine(art_t["x_d"], layout, art_t["centroids"], art_t["scaler"],
                      art_t["params"], device="cpu", **kw)
    out_j, out_t = e_j.probe(x_q), e_t.probe(x_q)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)
    for thr in _thresholds(out_j):
        r_j, r_t = e_j.search(x_q, thr, K), e_t.search(x_q, thr, K)
        np.testing.assert_array_equal(r_t.nprobe, r_j.nprobe)
        np.testing.assert_array_equal(r_t.ndis, r_j.ndis)
        if scan_dtype == "float32":
            want = [set(r[r >= 0]) for r in r_j.ids]
        else:
            want = _oracle_sets(art_t["x_d"], x_q, layout, e_t._select_probed(x_q, thr), K)
        for i, row in enumerate(r_t.ids):
            assert set(row[row >= 0]) == want[i], (scan_dtype, thr, i)


@pytest.mark.parametrize("scan_dtype,capacity", [("float32", False), ("int8", False),
                                                 ("bfloat16", True)])
def test_port_index_served_by_both_run_search(port_index, scan_dtype, capacity):
    """The port's artifacts → lira_tpu's run_search and the port's: the
    same rows, timing aside."""
    kw = dict(data_path=port_index["data_path"], k=K, t_min=0.1, t_max=0.5, t_step=0.2,
              bundle=port_index["bundle"], scan_dtype=scan_dtype, capacity=capacity)
    rows_j = jsearch.run_search(port_index["dir"], port_index["prefix"], "synthetic", **kw)
    rows_t = tsearch.run_search(port_index["dir"], port_index["prefix"], "synthetic",
                                device="cpu", **kw)
    assert len(rows_t) == len(rows_j) == 3
    for a, b in zip(rows_j, rows_t):
        for key in ("threshold", "avg_nprobe", "avg_cmp", "avg_recall"):
            assert a[key] == b[key], (key, a, b)


def _files(d, prefix):
    return sorted(f[len(prefix):] for f in os.listdir(d) if f.startswith(prefix))


def test_artifact_files_match_across_packages(lira_index, port_index):
    """Same file names, dtypes, shapes and manifest keys; each package
    loads the other's files."""
    assert _files(lira_index["dir"], lira_index["prefix"]) == _files(
        port_index["dir"], port_index["prefix"])
    for suffix in ("_centroids.npy", "_data_2_bkt.npy", "_x_d.npy", "_redundant_flags.npy",
                   "_scaler_mean.npy", "_scaler_scale.npy"):
        a = np.load(os.path.join(lira_index["dir"], lira_index["prefix"] + suffix))
        b = np.load(os.path.join(port_index["dir"], port_index["prefix"] + suffix))
        assert (a.dtype, a.shape) == (b.dtype, b.shape), suffix
    with np.load(os.path.join(lira_index["dir"], lira_index["prefix"] + "_model.npz")) as a, \
            np.load(os.path.join(port_index["dir"], port_index["prefix"] + "_model.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert (a[key].dtype, a[key].shape) == (b[key].dtype, b[key].shape), key
    man = {}
    for name, ix in (("lira", lira_index), ("port", port_index)):
        with open(os.path.join(ix["dir"], ix["prefix"] + "_manifest.json")) as f:
            man[name] = json.load(f)
    assert set(man["lira"]) == set(man["port"])
    # the port's index loads in lira_tpu, and lira_tpu's in the port
    p_j = jart.load_index_artifacts(port_index["dir"], port_index["prefix"])["params"]
    p_t = tart.load_index_artifacts(port_index["dir"], port_index["prefix"])["params"]
    for layer, sub in params_to_jax(p_t).items():
        for leaf, v in sub.items():
            np.testing.assert_array_equal(v, np.asarray(p_j[layer][leaf]))


def test_torchscript_exports_agree(lira_index, tmp_path):
    """lira_tpu's `_mlp_2_input.pt` and the port's export of the same
    parameters give the same outputs, and those of the port's MLP."""
    model = tart.load_index_artifacts(lira_index["dir"], lira_index["prefix"])["params"]
    ours = export_torchscript_mlp(model, str(tmp_path / "port.pt"))
    m_j = torch.jit.load(os.path.join(lira_index["dir"],
                                      lira_index["prefix"] + "_mlp_2_input.pt"))
    m_t = torch.jit.load(ours)
    rng = np.random.default_rng(0)
    x_dist = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    x_vec = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    with torch.no_grad():
        o_j, o_t, o_m = m_j(x_dist, x_vec), m_t(x_dist, x_vec), model(x_dist, x_vec)
    assert o_t.shape == (64, 8)
    np.testing.assert_allclose(o_t.numpy(), o_j.numpy(), atol=1e-6)
    np.testing.assert_allclose(o_m.numpy(), o_j.numpy(), atol=1e-6)


def test_params_npz_round_trip_across_packages(tmp_path):
    params = jax.tree_util.tree_map(np.asarray, jtrain.make_train_state(3, 8, 16).params)
    jart.save_params(params, str(tmp_path / "j.npz"))
    model = tart.load_params(str(tmp_path / "j.npz"))
    tart.save_params(model, str(tmp_path / "t.npz"))
    back = jart.load_params(str(tmp_path / "t.npz"))
    for layer, sub in params.items():
        for leaf, v in sub.items():
            np.testing.assert_array_equal(np.asarray(back[layer][leaf]), v)


def _lira_state_after_one_epoch(dist, vec, tgt):
    st = jtrain.make_train_state(7, dist.shape[1], vec.shape[1])
    st, _ = jtrain.train_epoch(st, dist, vec, tgt, batch_size=32)
    return st


def _train_data():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(256, 8)).astype(np.float32),
            rng.normal(size=(256, 16)).astype(np.float32),
            (rng.random(size=(256, 8)) < 0.3).astype(np.uint8))


def _flat_j(state):
    leaves = jax.tree_util.tree_leaves(state.opt_state)
    out = {f"opt/{i}": np.asarray(v) for i, v in enumerate(leaves)}
    out.update({f"params/{l}/{n}": np.asarray(v) for l, sub in state.params.items()
                for n, v in sub.items()})
    return out


def test_checkpoints_cross_load_exactly(tmp_path):
    """Key sets are identical, and a file written by either package loads
    in the other back to equal arrays (extension-less paths, as save takes
    them)."""
    dist, vec, tgt = _train_data()
    st_j = _lira_state_after_one_epoch(dist, vec, tgt)
    jckpt.save_train_state(st_j, str(tmp_path / "j"), step=3)
    template = ttrain.make_train_state(0, 8, 16, device="cpu")
    st_t, step = tckpt.load_train_state(str(tmp_path / "j"), template)
    assert step == 3
    tckpt.save_train_state(st_t, str(tmp_path / "t"), step=3)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert set(a.files) == set(b.files)
        for key in a.files:
            assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    back, step = jckpt.load_train_state(str(tmp_path / "t"), jtrain.make_train_state(0, 8, 16))
    assert step == 3
    want = _flat_j(st_j)
    for key, v in _flat_j(back).items():
        np.testing.assert_array_equal(v, want[key], err_msg=key)


def test_checkpoint_resumes_across_packages(tmp_path):
    """One further epoch after a cross-package load, in both directions,
    equals that epoch in the package that wrote the checkpoint."""
    dist, vec, tgt = _train_data()
    st_j = _lira_state_after_one_epoch(dist, vec, tgt)
    jckpt.save_train_state(st_j, str(tmp_path / "j.npz"), step=1)
    st_t, _ = tckpt.load_train_state(str(tmp_path / "j.npz"),
                                     ttrain.make_train_state(0, 8, 16, device="cpu"))
    st_t, loss_t = ttrain.train_epoch(st_t, dist, vec, tgt, batch_size=32)
    st_j2, loss_j = jtrain.train_epoch(st_j, dist, vec, tgt, batch_size=32)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    got = params_to_jax(st_t.model)
    for layer, sub in st_j2.params.items():
        for leaf, v in sub.items():
            np.testing.assert_allclose(got[layer][leaf], np.asarray(v), atol=1e-5)

    # the port's checkpoint resumed by lira_tpu
    tckpt.save_train_state(st_t, str(tmp_path / "t"), step=2)
    st_jr, step = jckpt.load_train_state(str(tmp_path / "t"), jtrain.make_train_state(0, 8, 16))
    assert step == 2
    st_jr, loss_jr = jtrain.train_epoch(st_jr, dist, vec, tgt, batch_size=32)
    st_t, loss_t2 = ttrain.train_epoch(st_t, dist, vec, tgt, batch_size=32)
    np.testing.assert_allclose(loss_jr, loss_t2, rtol=1e-5)
    got = params_to_jax(st_t.model)
    for layer, sub in st_jr.params.items():
        for leaf, v in sub.items():
            np.testing.assert_allclose(got[layer][leaf], np.asarray(v), atol=1e-5)


def test_manifest_margin_rescales_and_reads_skipped(capsys):
    man = {"calibrated_margins": {
        "bfloat16": {"margin": 6, "sel_rows": 32},
        "int8": {"skipped": "MosaicError: lowering"},
    }}
    for sel in (None, 1, 8, 16, 32, 64, 128):
        assert tsearch.manifest_margin(man, "bfloat16", sel) == jsearch.manifest_margin(
            man, "bfloat16", sel)
    assert tsearch.manifest_margin(man, "bfloat16", 8) == 24
    assert tsearch.manifest_margin(man, "bfloat16", 128) == 2
    assert tsearch.manifest_margin(man, "int8") is None
    assert "skipped" in capsys.readouterr().out
    assert tsearch.manifest_margin(man, "float32") is None
    assert tsearch.manifest_margin({}, "int8") is None


def test_search_refuses_shards():
    """--n_shards > 1 is served by the sharded engine now; nccl (the
    default backend) refuses CPU ranks before any rank is spawned."""
    with pytest.raises(ValueError, match="backend='gloo'"):
        tsearch.run_search(".", "nope", "synthetic", n_shards=2, device="cpu")
