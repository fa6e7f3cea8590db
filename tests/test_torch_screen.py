"""K1 (the union group-min screen): lira_tpu_torch's plain version against
lira_tpu's Pallas kernel in interpret mode, on the same numpy inputs.

Tolerance: the two sum the same exact f32 products (bf16 and int8 values
widen exactly, int8 dots are exact integers) in different orders, so
|difference| ≤ 2·d·eps32·(max‖x‖² + 2·max‖x‖·max‖q‖); dead slots must be
exactly 3e38 in both.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lira_tpu.engine.block_scan import S_TILES, _union_groupmin_kernel
from lira_tpu_torch.engine.screen import screen_norms, union_groupmin, union_groupmin_ref

QB, D, U, ROWS, N_SUPER = 16, 16, 3, 2, 4
EPS32 = float(np.finfo(np.float32).eps)


def _pallas_k1(q, corpus, supers, ulen, t_eff, s2, metric, sel_rows):
    """lira_tpu's K1 pallas_call (as _screen_rescore builds it), interpreted."""
    quantized = corpus.dtype == jnp.int8
    SG = S_TILES * (128 // sel_rows)
    in_specs = [
        pl.BlockSpec((QB, D), lambda i, u, s, ul: (i, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec((S_TILES * 128, D), lambda i, u, s, ul: (s[i, u], 0),
                     memory_space=pltpu.VMEM),
    ]
    operands = [supers, ulen, q, corpus]
    if quantized:
        in_specs.append(pl.BlockSpec((1, 1), lambda i, u, s, ul: (0, 0),
                                     memory_space=pltpu.SMEM))
        in_specs.append(pl.BlockSpec((D, 1), lambda i, u, s, ul: (0, 0),
                                     memory_space=pltpu.VMEM))
        operands += [t_eff.reshape(1, 1), s2.reshape(D, 1)]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(ROWS, U), in_specs=in_specs,
        out_specs=pl.BlockSpec((1, SG, QB), lambda i, u, s, ul: (i, u, 0),
                               memory_space=pltpu.VMEM),
    )
    precision = "default" if corpus.dtype == jnp.bfloat16 else "highest"
    return np.asarray(pl.pallas_call(
        partial(_union_groupmin_kernel, metric=metric, precision=precision,
                sel_rows=sel_rows, quantized=quantized),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((ROWS, U * SG, QB), jnp.float32),
        interpret=True,
    )(*[jnp.asarray(o) for o in operands]))


def _inputs(dtype: str, metric: str):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N_SUPER * S_TILES * 128, D)).astype(np.float32)
    q = rng.normal(size=(ROWS * QB, D)).astype(np.float32)
    supers = rng.integers(0, N_SUPER, size=(ROWS, U)).astype(np.int32)
    ulen = np.array([U, 1], np.int32)  # block row 1: slots 1, 2 are dead
    t_eff = s2 = None
    if dtype == "int8":
        s = (np.maximum(np.abs(x).max(axis=0), 1e-30) / 127.0).astype(np.float32)
        x = np.clip(np.round(x / s), -127, 127).astype(np.int8)
        qp = q * s[None, :]
        t = np.float32(max(np.abs(qp).max() / 127.0, 1e-30))
        q = np.clip(np.round(qp / t), -127, 127).astype(np.int8)
        t_eff = np.array([t if metric == "inner_product" else 2 * t], np.float32)
        s2 = (s * s).astype(np.float32)
    return x, q, supers, ulen, t_eff, s2


@pytest.mark.parametrize("sel_rows", [32, 128])
@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k1_plain_matches_pallas_interpret(dtype, metric, sel_rows):
    x, q, supers, ulen, t_eff, s2 = _inputs(dtype, metric)
    if dtype == "bfloat16":
        xj, qj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16)
        xt, qt = torch.from_numpy(x).bfloat16(), torch.from_numpy(q).bfloat16()
    else:
        xj, qj, xt, qt = x, q, torch.from_numpy(x), torch.from_numpy(q)
    ref = _pallas_k1(qj, xj, supers, ulen, t_eff, s2, metric, sel_rows)
    got = union_groupmin(
        qt, xt, torch.from_numpy(supers), torch.from_numpy(ulen), qb=QB, metric=metric,
        sel_rows=sel_rows,
        t_eff=None if t_eff is None else torch.from_numpy(t_eff),
        s2=None if s2 is None else torch.from_numpy(s2),
    ).numpy()
    assert got.shape == ref.shape == (ROWS, U * S_TILES * 128 // sel_rows, QB)
    SG = S_TILES * 128 // sel_rows
    big = np.float32(3e38)
    assert (got[1, SG:] == big).all() and (ref[1, SG:] == big).all()
    live = np.isfinite(ref) & (ref != big)
    xf = np.asarray(xt.float())
    xn = (xf * xf).sum(1).max()
    qn = (np.asarray(qt.float()) ** 2).sum(1).max()
    tol = 2 * D * EPS32 * (xn + 2 * np.sqrt(xn * qn))
    if dtype == "int8":
        tol = 2 * D * EPS32 * float(((xf * xf) @ s2).max())
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k1_with_row_norms_matches_pallas_interpret(dtype):
    """The engine's path: ‖x‖² from `screen_norms` of the table (built once
    with the index) instead of from the loaded rows; same tolerance."""
    x, q, supers, ulen, t_eff, s2 = _inputs(dtype, "L2")
    if dtype == "bfloat16":
        xj, qj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16)
        xt, qt = torch.from_numpy(x).bfloat16(), torch.from_numpy(q).bfloat16()
    else:
        xj, qj, xt, qt = x, q, torch.from_numpy(x), torch.from_numpy(q)
    ref = _pallas_k1(qj, xj, supers, ulen, t_eff, s2, "L2", 32)
    s2_t = None if s2 is None else torch.from_numpy(s2)
    xsq = screen_norms(xt, s2_t)
    assert xsq.shape == (len(x),) and xsq.dtype == torch.float32
    kw = dict(qb=QB, metric="L2", sel_rows=32,
              t_eff=None if t_eff is None else torch.from_numpy(t_eff), s2=s2_t)
    args = (qt, xt, torch.from_numpy(supers), torch.from_numpy(ulen))
    got = union_groupmin(*args, xsq=xsq, **kw).numpy()
    big = np.float32(3e38)
    assert (got[1, 32:] == big).all()
    live = ref != big
    xf = np.asarray(xt.float())
    xn = (xf * xf).sum(1).max() if s2 is None else float(((xf * xf) @ s2).max())
    qn = (np.asarray(qt.float()) ** 2).sum(1).max()
    tol = 2 * D * EPS32 * (xn if dtype == "int8" else xn + 2 * np.sqrt(xn * qn))
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=tol)
    np.testing.assert_allclose(got, union_groupmin(*args, **kw).numpy(), rtol=0, atol=tol)


def test_k1_wrapper_rejects_what_the_kernel_does_not_take():
    x, q, supers, ulen, _, _ = _inputs("float32", "L2")
    args = (torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(supers),
            torch.from_numpy(ulen))
    kw = dict(qb=QB, metric="L2")
    for sel_rows in (3, 48):  # not divisors of 128 (every divisor is taken)
        with pytest.raises(ValueError, match="sel_rows"):
            union_groupmin(*args, sel_rows=sel_rows, **kw)
    with pytest.raises(TypeError, match="int32"):
        union_groupmin(args[0], args[1], args[2].long(), args[3], sel_rows=32, **kw)
    with pytest.raises(TypeError, match="dtype"):
        union_groupmin(args[0].double(), *args[1:], sel_rows=32, **kw)
    with pytest.raises(ValueError, match="queries"):
        union_groupmin(args[0][:-1], *args[1:], sel_rows=32, **kw)
    with pytest.raises(ValueError, match="t_eff"):
        union_groupmin(args[0].to(torch.int8), args[1].to(torch.int8), *args[2:],
                       sel_rows=32, **kw)


def test_k1_cpu_path_is_the_plain_version_and_counts_no_launch():
    x, q, supers, ulen, _, _ = _inputs("float32", "inner_product")
    args = [torch.from_numpy(a) for a in (q, x, supers, ulen)]
    before = union_groupmin.launches
    by_dtype = dict(union_groupmin.launches_by_dtype)
    got = union_groupmin(*args, qb=QB, metric="inner_product", sel_rows=32)
    want = union_groupmin_ref(*args, qb=QB, metric="inner_product", sel_rows=32)
    assert torch.equal(got, want)
    assert union_groupmin.launches == before
    assert dict(union_groupmin.launches_by_dtype) == by_dtype
