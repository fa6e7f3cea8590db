"""K2 and the kNN ops: lira_tpu_torch against lira_tpu on the same numpy
inputs (lira_tpu's Pallas kernel in interpret mode).

Tolerances:
  * K2 group minima, "highest": the two sum the same exact f32 products in
    different orders, so |difference| ≤ 2·d·eps32·(max‖x‖² + 2·max‖x‖·max‖q‖).
    "default" the same, against lira_tpu's kernel at "highest" on
    bf16-rounded inputs (the TPU's default pass: bf16 products, f32 sums).
    int8: both take an exact integer dot and round it to f32.  IP is then
    bit-equal; for L2, XLA on the CPU contracts bsq − t·dot into one FMA
    where the port rounds t·dot first, so the two are one rounding apart:
    |difference| ≤ 2·eps32·(max‖x‖² + max|score|).
  * Neighbour ids, f32: equal, except between candidates whose exact
    distances agree to rtol 1e-6 (the rule of tests/test_knn_pallas.py).
  * int8 and "default" round 1: equal ids at a margin that covers every
    group (selection cannot miss, round 2 is exact f32).
  * Scores: rtol 1e-5 (f32 summation order).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from scipy.spatial.distance import cdist

from lira_tpu.ops import knn as jknn
from lira_tpu.ops import knn_pallas as jkp
from lira_tpu_torch.ops import knn as tknn
from lira_tpu_torch.ops import knn_pallas as tkp
from lira_tpu_torch.ops.groupmin import groupmin, groupmin_ref, pad_cols

import torch

EPS32 = float(np.finfo(np.float32).eps)
CPU = "cpu"


def _pallas_k2(q, base, bsq, metric, t=None, q_block=16, c_block=256):
    """lira_tpu's K2 pallas_call (as _round1_select builds it), interpreted:
    the (n_groups, Q) group minima before the top-kg."""
    Q, d = q.shape
    n_pad = base.shape[0]
    in_specs = [
        pl.BlockSpec((q_block, d), lambda i, j: (i, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec((c_block, d), lambda i, j: (j, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec((c_block // 128, 128), lambda i, j: (j, 0), memory_space=pltpu.VMEM),
    ]
    operands = [q, base, bsq]
    if t is not None:
        in_specs.append(pl.BlockSpec((1, 1), lambda i, j: (0, 0), memory_space=pltpu.SMEM))
        operands.append(t)
    return np.asarray(pl.pallas_call(
        partial(jkp._groupmin_kernel, precision="highest", metric=metric,
                quantized=t is not None),
        grid=(Q // q_block, n_pad // c_block),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((c_block // 128, q_block), lambda i, j: (j, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_pad // 128, Q), jnp.float32),
        interpret=True,
    )(*[jnp.asarray(o) for o in operands]))


def _k2_inputs(metric, int8):
    """16 queries, a 512-row corpus whose last 37 rows are padding."""
    rng = np.random.default_rng(5)
    n, n_pad, d = 475, 512, 16
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.normal(size=(n, d))
    q = rng.normal(size=(16, d)).astype(np.float32)
    bsq = np.full(n_pad, 1e30, np.float32)
    bsq[:n] = np.einsum("ij,ij->i", x[:n], x[:n]) if metric == "L2" else 0.0
    bsq = bsq.reshape(-1, 128)
    if not int8:
        return q, x, bsq, None
    s = np.maximum(np.abs(x).max(axis=0), 1e-30) / 127.0
    x8 = np.clip(np.round(x / s), -127, 127).astype(np.int8)
    qp = q * s
    t = np.float32(max(np.abs(qp).max() / 127.0, 1e-30))
    q8 = np.clip(np.round(qp / t), -127, 127).astype(np.int8)
    t_eff = np.array([[t if metric == "inner_product" else 2 * t]], np.float32)
    return q8, x8, bsq, t_eff


def _bf16(a):
    """f32 values rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("mode", ["highest", "default", "int8"])
def test_k2_plain_matches_pallas_interpret(metric, mode):
    q, x, bsq, t = _k2_inputs(metric, mode == "int8")
    if mode == "default":  # the TPU's default pass: bf16 inputs, f32 sums
        want = _pallas_k2(_bf16(q), _bf16(x), bsq, metric).T
        q_r, x_r = _bf16(q), _bf16(x)
    else:
        want = _pallas_k2(q, x, bsq, metric, t).T  # (Q, n_groups)
        q_r, x_r = q, x
    args = [torch.from_numpy(a) for a in (q, x, bsq)]
    kw = dict(metric=metric, t_eff=None if t is None else torch.from_numpy(t))
    if mode != "int8":
        kw["precision"] = mode
    got = groupmin(*args, **kw).numpy()  # CPU tensors: the plain version
    np.testing.assert_array_equal(got, groupmin_ref(*args, **kw).numpy())
    assert got.shape == (16, 4)
    assert (got[:, 3] < 1e29).all()  # the partly padded group: its real rows win
    if mode == "int8" and metric == "inner_product":
        np.testing.assert_array_equal(got, want)
    elif mode == "int8":
        tol = 2 * EPS32 * (float(bsq[bsq < 1e29].max()) + float(np.abs(want).max()))
        assert np.abs(got - want).max() <= tol
    else:
        d = x.shape[1]
        xn = float((x_r * x_r).sum(1).max())
        qn = float((q_r * q_r).sum(1).max())
        tol = 2 * d * EPS32 * (xn + 2 * (xn * qn) ** 0.5)
        assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("metric", ["L2", "inner_product"])
def test_k2_default_plain_same_on_bf16_and_padded_tables(metric):
    """groupmin's plain route at "default" gives bit for bit the same
    minima on f32 inputs, on their bf16 tables, and on those tables
    zero-padded to the kernel's row width (16 → 64 columns), with f32 and
    bf16 queries mixed."""
    q, x, bsq, _ = _k2_inputs(metric, False)
    q, x, bsq = (torch.from_numpy(a) for a in (q, x, bsq))
    kw = dict(metric=metric, precision="default")
    want = groupmin(q, x, bsq, **kw)
    qb, xb = q.to(torch.bfloat16), x.to(torch.bfloat16)
    qp, xp = pad_cols(qb), pad_cols(xb)
    assert qp.shape == (16, 64) and xp.shape == (512, 64)
    assert not qp[:, 16:].any() and torch.equal(xp[:, :16], xb)
    for qq, xx in ((qb, xb), (qp, xp), (q, xb)):
        np.testing.assert_array_equal(groupmin(qq, xx, bsq, **kw).numpy(), want.numpy())
    assert (want[:, 3] < 1e29).all()


def test_pad_cols_whole_128_byte_rows():
    x8 = torch.ones(3, 37, dtype=torch.int8)
    assert pad_cols(x8).shape == (3, 128) and int(pad_cols(x8).sum()) == 3 * 37
    xb = torch.ones(3, 960, dtype=torch.bfloat16)
    assert pad_cols(xb) is xb  # 15 steps of 64 already
    assert pad_cols(torch.ones(2, 65, dtype=torch.bfloat16)).shape == (2, 128)
    assert pad_cols(torch.ones(2, 128, dtype=torch.int8)).shape == (2, 128)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(43)
    return (rng.normal(size=(3000, 16)).astype(np.float32),
            rng.normal(size=(50, 16)).astype(np.float32))


def _same_neighbours(ids_a, ids_b, base, query, metric="L2"):
    """Equal ids, except between candidates whose exact distances tie."""
    if metric == "L2":
        dist = cdist(query.astype(np.float64), base.astype(np.float64), "sqeuclidean")
    else:
        dist = -(query.astype(np.float64) @ base.T.astype(np.float64))
    rows = np.arange(len(query))[:, None]
    da, db = dist[rows, ids_a], dist[rows, ids_b]
    np.testing.assert_allclose(da, db, rtol=1e-6, atol=1e-9)
    tied = np.isclose(da, db, rtol=1e-6) & (ids_a != ids_b)
    np.testing.assert_array_equal(np.where(tied, ids_b, ids_a), ids_b)


@pytest.mark.parametrize("metric", ["L2", "inner_product"])
def test_knn_fused_highest_matches_lira(data, metric):
    base, query = data
    s_j, i_j = jkp.knn_fused(base, query, k=5, metric=metric, precision="highest",
                             interpret=True)
    s_t, i_t = tkp.knn_fused(base, query, k=5, metric=metric, precision="highest",
                             device=CPU)
    assert i_t.dtype == np.int32 and i_t.shape == (50, 5)
    _same_neighbours(i_t, np.asarray(i_j), base, query, metric)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("precision", ["int8", "default"])
def test_knn_fused_reduced_round1_matches_lira(data, metric, precision):
    """3000 rows = 24 groups in the port, 32 (2048-row chunks) in lira_tpu:
    margin 32 covers every group in both."""
    base, query = data
    _, i_j = jkp.knn_fused(base, query, k=5, metric=metric, precision=precision,
                           margin=32, interpret=True)
    _, i_t = tkp.knn_fused(base, query, k=5, metric=metric, precision=precision,
                           margin=32, device=CPU)
    _same_neighbours(i_t, np.asarray(i_j), base, query, metric)


def test_exact_and_self_knn_match_lira(data):
    base, query = data
    for metric in ("L2", "inner_product"):
        s_j, i_j = jknn.exact_knn(base, query, 7, metric=metric, b_tile=1024)
        s_t, i_t = tknn.exact_knn(base, query, 7, metric=metric, b_tile=1024, device=CPU)
        assert i_t.dtype == np.int32
        _same_neighbours(i_t, np.asarray(i_j), base, query, metric)
        np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-5)
    sub = base[:700]
    k_j = jknn.self_knn(sub, 4)
    k_t = tknn.self_knn(sub, 4, device=CPU)
    _same_neighbours(k_t, k_j, sub, sub)
    assert not (k_t == np.arange(700)[:, None]).any()


def test_self_knn_fused_matches_lira():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(2048, 8)).astype(np.float32)
    k_j = np.asarray(jkp.self_knn_fused(base, k=4, precision="highest", interpret=True))
    k_t = tkp.self_knn_fused(base, k=4, precision="highest", device=CPU)
    _same_neighbours(k_t, k_j, base, base)
    assert not (k_t == np.arange(len(base))[:, None]).any()
    assert all(len(set(r)) == len(r) for r in k_t)


@pytest.mark.parametrize("precision", ["default", "int8"])
def test_self_knn_fused_reduced_round1_matches_lira(precision):
    """A self-kNN's round 1 at "default" takes its query tiles as slices of
    the corpus's bf16 table; margin 16 covers all 16 groups."""
    rng = np.random.default_rng(7)
    base = rng.normal(size=(2048, 8)).astype(np.float32)
    k_j = np.asarray(jkp.self_knn_fused(base, k=4, precision=precision, margin=16,
                                        q_tile=512, interpret=True))
    k_t = tkp.self_knn_fused(base, k=4, precision=precision, margin=16, q_tile=512,
                             device=CPU)
    _same_neighbours(k_t, k_j, base, base)
    assert not (k_t == np.arange(len(base))[:, None]).any()


def test_knn_fused_gist_dim_matches_lira():
    """d=960: lira_tpu's d-aware Pallas blocks; the port's kernel tile is
    the same at every d."""
    rng = np.random.default_rng(8)
    base = rng.normal(size=(300, 960)).astype(np.float32)
    query = rng.normal(size=(8, 960)).astype(np.float32)
    _, i_j = jkp.knn_fused(base, query, k=5, precision="highest", interpret=True)
    _, i_t = tkp.knn_fused(base, query, k=5, precision="highest", device=CPU)
    _same_neighbours(i_t, np.asarray(i_j), base, query)


def test_k_beyond_n_pads_minus_one_like_lira():
    rng = np.random.default_rng(9)
    base = rng.normal(size=(100, 16)).astype(np.float32)
    query = rng.normal(size=(6, 16)).astype(np.float32)
    _, i_j = jkp.knn_fused(base, query, k=150, precision="highest", interpret=True)
    _, i_t = tkp.knn_fused(base, query, k=150, precision="highest", device=CPU)
    assert i_t.shape == np.asarray(i_j).shape == (6, 100)
    _same_neighbours(i_t, np.asarray(i_j), base, query)
    k_j = np.asarray(jkp.self_knn_fused(base, k=120, precision="highest", interpret=True))
    k_t = tkp.self_knn_fused(base, k=120, precision="highest", device=CPU)
    assert k_t.shape == (100, 120)
    np.testing.assert_array_equal(k_t[:, 99:], -1)
    np.testing.assert_array_equal(k_t == -1, k_j == -1)
    assert not (k_t == np.arange(100)[:, None]).any()


def test_drop_self_matches_lira():
    ids = np.array([[0, 5, 6], [7, 8, 9], [2, 1, 3]], np.int32)
    for k in (2, 4):
        np.testing.assert_array_equal(tknn.drop_self(ids, k), jknn.drop_self(ids, k))
    np.testing.assert_array_equal(tknn.drop_self(ids, 2, row_ids=[5, 9, 3]),
                                  jknn.drop_self(ids, 2, row_ids=[5, 9, 3]))


def test_groupmin_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(256, 8)
    q = torch.zeros(4, 8)
    bsq = torch.zeros(2, 128)
    with pytest.raises(ValueError):
        groupmin(q, x[:200], bsq, metric="L2")  # not whole groups
    with pytest.raises(ValueError):
        groupmin(q, x, bsq, metric="L2", precision="int8")  # f32 takes highest/default
    with pytest.raises(ValueError):
        groupmin(q.to(torch.int8), x.to(torch.int8), bsq, metric="L2")  # no t_eff


def test_groupmin_bf16_takes_default_only():
    x = torch.zeros(256, 8, dtype=torch.bfloat16)
    q = torch.zeros(4, 8, dtype=torch.bfloat16)
    bsq = torch.zeros(2, 128)
    with pytest.raises(ValueError):
        groupmin(q, x, bsq, metric="L2")  # "highest" on bf16 values
    with pytest.raises(TypeError):
        groupmin(q.to(torch.int8), x, bsq, metric="L2", precision="default")
    assert groupmin(q, x, bsq, metric="L2", precision="default").shape == (4, 2)


def test_exact_knn_stream_matches_lira(data):
    base, query = data
    s_j, i_j = jknn.exact_knn_stream(base, query, 6, base_chunk=1100)
    s_t, i_t = tknn.exact_knn_stream(base, query, 6, base_chunk=1100, device=CPU)
    assert i_t.dtype == np.int64
    _same_neighbours(i_t, i_j, base, query)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-5)
    _, i_short = tknn.exact_knn_stream(base[:4], query, 6, base_chunk=3, device=CPU)
    np.testing.assert_array_equal(i_short[:, 4:], -1)  # fewer rows than k
