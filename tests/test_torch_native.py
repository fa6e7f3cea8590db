"""The port's native host runtime (lira_tpu_torch/native): built with g++
here, held equal — exactly — to the numpy branches it stands beside and
to lira_tpu's native library on the same inputs: the CSR build (n_mul 1
and 2, duplicate (id, bucket) pairs, empty buckets), the probed-tile
expander (empty rows, pow2 T), the fvecs/bvecs parsers, and
build_bucket_layout with and without it.  Also the engine's tile lists
and the bvecs dataset reader, which take the native path here."""

import numpy as np
import pytest

from lira_tpu import native as jnative
from lira_tpu.io.xvecs import write_xvecs
from lira_tpu_torch import native
from lira_tpu_torch.partition.assign import build_bucket_layout


def test_native_builds_in_the_port():
    assert native.available()
    assert native._load().lira_native_version() == 1
    path = native.lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert "lira_tpu_torch" in str(path) and "lira_tpu/native" not in str(path)


def _d2b(rng, n, n_bkt, n_mul, empty=()):
    d2b = np.full((n, n_mul), -1, dtype=np.int32)
    live = np.setdiff1d(np.arange(n_bkt), empty)
    d2b[:, 0] = rng.choice(live, size=n)
    if n_mul > 1:
        m = rng.random(n) < 0.4
        d2b[m, 1] = rng.choice(live, size=m.sum())
        dup = rng.random(n) < 0.1
        d2b[dup, 1] = d2b[dup, 0]  # duplicate (id, bucket) pairs: dedup
    return d2b


def _numpy_csr(d2b, n_bkt):
    lay = build_bucket_layout(d2b, n_bkt, tile=8, use_native=False)
    return lay.offsets, lay.ids


@pytest.mark.parametrize("n_mul", [1, 2])
def test_build_csr_matches_numpy_and_lira_tpu(n_mul):
    rng = np.random.default_rng(n_mul)
    n, n_bkt = 3000, 24
    d2b = _d2b(rng, n, n_bkt, n_mul, empty=(0, 5, 23))
    off, ids = native.build_csr(d2b, n_bkt)
    off_np, ids_np = _numpy_csr(d2b, n_bkt)
    np.testing.assert_array_equal(off, off_np)
    np.testing.assert_array_equal(ids, ids_np)
    assert (np.diff(off)[[0, 5, 23]] == 0).all()
    if jnative.available():
        off_j, ids_j = jnative.build_csr(d2b, n_bkt)
        np.testing.assert_array_equal(off, off_j)
        np.testing.assert_array_equal(ids, ids_j)


@pytest.mark.parametrize("n_mul", [1, 2])
def test_build_bucket_layout_native_equals_numpy(n_mul):
    rng = np.random.default_rng(10 + n_mul)
    d2b = _d2b(rng, 2500, 17, n_mul, empty=(3,))
    a = build_bucket_layout(d2b, 17, use_native=True)
    b = build_bucket_layout(d2b, 17, use_native=False)
    for f in ("offsets", "ids", "padded_offsets", "padded_ids"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _numpy_tiles(probed, tile_start, tiles_per_bucket):
    rows = []
    for q in range(probed.shape[0]):
        row = []
        for b in np.nonzero(probed[q])[0]:
            row.extend(range(tile_start[b], tile_start[b] + tiles_per_bucket[b]))
        rows.append(row)
    t_max = max([len(r) for r in rows] + [1])
    T = 1 << (t_max - 1).bit_length()
    out = np.full((len(rows), T), -1, np.int32)
    for q, r in enumerate(rows):
        out[q, : len(r)] = r
    return out


@pytest.mark.parametrize("B,n_bkt,p", [(33, 16, 0.3), (7, 5, 0.0), (64, 40, 0.05)])
def test_probe_tiles_matches_numpy_and_lira_tpu(B, n_bkt, p):
    rng = np.random.default_rng(B)
    probed = rng.random((B, n_bkt)) < p
    probed[0] = False  # an empty row
    tiles_per_bucket = rng.integers(0, 5, size=n_bkt).astype(np.int64)
    tile_start = np.concatenate([[0], np.cumsum(tiles_per_bucket)[:-1]]).astype(np.int64)
    got = native.probe_tiles(probed, tile_start, tiles_per_bucket)
    want = _numpy_tiles(probed, tile_start, tiles_per_bucket)
    np.testing.assert_array_equal(got, want)
    T = got.shape[1]
    assert T & (T - 1) == 0  # a power of two
    assert (got[0] == -1).all()
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.probe_tiles(probed, tile_start,
                                                               tiles_per_bucket))


def test_engine_tile_lists_native_equal_numpy(monkeypatch):
    """QueryEngine._probe_tiles takes the native expander here; with it
    switched off it takes lira_tpu's numpy branch: the same lists."""
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.labels.scaler import StandardScaler
    from lira_tpu_torch.models.probing_mlp import ProbingMLP
    import torch

    rng = np.random.default_rng(4)
    n, d, n_bkt = 900, 8, 9
    x = rng.normal(size=(n, d)).astype(np.float32)
    lay = build_bucket_layout(rng.integers(0, n_bkt, size=n).astype(np.int32), n_bkt)
    sc = StandardScaler()
    sc.mean_, sc.scale_ = np.zeros(n_bkt, np.float32), np.ones(n_bkt, np.float32)
    eng = QueryEngine(x, lay, x[:n_bkt], sc, ProbingMLP(n_bkt, d, generator=torch.Generator()
                                                        .manual_seed(0)),
                      scan_impl="xla", device="cpu")
    probed = rng.random((20, n_bkt)) < 0.4
    got = eng._probe_tiles(probed)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(got, eng._probe_tiles(probed))


def test_fvecs_rows_matches_and_checks_size(tmp_path):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(50, 12)).astype(np.float32)
    path = str(tmp_path / "t.fvecs")
    write_xvecs(path, x)
    raw = np.fromfile(path, dtype=np.float32)
    np.testing.assert_array_equal(native.fvecs_rows(raw, 50, 12), x)
    if jnative.available():
        np.testing.assert_array_equal(native.fvecs_rows(raw, 50, 12),
                                      jnative.fvecs_rows(raw, 50, 12))
    with pytest.raises(ValueError, match="records"):
        native.fvecs_rows(raw, 51, 12)


def test_bvecs_rows_and_dataset_reader(tmp_path):
    from lira_tpu_torch.io.datasets import load_data

    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, size=(20, 9)).astype(np.uint8)
    path = str(tmp_path / "t.bvecs")
    write_xvecs(path, x)
    raw = np.fromfile(path, dtype=np.uint8)
    out = native.bvecs_rows(raw, 20, 9)
    np.testing.assert_array_equal(out, x.astype(np.float32))
    if jnative.available():
        np.testing.assert_array_equal(out, jnative.bvecs_rows(raw, 20, 9))
    # the dataset reader widens bvecs through the native parser
    ddir = tmp_path / "bv"
    ddir.mkdir()
    write_xvecs(str(ddir / "bv_base.bvecs"), x)
    write_xvecs(str(ddir / "bv_query.bvecs"), x[:3])
    b = load_data("bv", data_path=str(tmp_path))
    np.testing.assert_array_equal(b.base, x.astype(np.float32))
    np.testing.assert_array_equal(b.query, x[:3].astype(np.float32))
    assert b.groundtruth is None
