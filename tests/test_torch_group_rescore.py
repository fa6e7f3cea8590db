"""The blocked engine's exact round-2 rescore (engine/group_rescore.py) on
the CPU: the wrapper's plain version against an independent numpy rescore
on integer-valued blocks, where every dot is exact in f32 and scores tie
often (the tie rule), with invalid slots, −1 ids and queries with fewer live
rows than k_loc; and the wrapper's contract.  The CUDA kernel is held to
the plain version in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from lira_tpu_torch.engine.group_rescore import exact_group_rescore, exact_group_rescore_ref

_BIG = np.float32(3e38)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def int_block(d, sel_rows, kg, dtype, metric, qb=5, n_groups=12, seed=0):
    """One block's rescore inputs with small integers (exact in every
    dtype and in every f32 sum): a table with replicated rows (equal
    scores), −1 ids on some rows, a query whose slots are all invalid but
    one, invalid slots scattered, and the selection values (−inf or
    −3e38-ish where invalid).  kg "all": every group of the table, as the
    margin calibration's exhaustive reference selects them."""
    rng = np.random.default_rng(seed + d + sel_rows)
    kg = n_groups if kg == "all" else kg
    x = rng.integers(-2, 3, size=(n_groups, sel_rows, d)).astype(np.float32)
    x[1::3] = x[0]  # replicas: the same rows in other groups
    ids = rng.permutation(n_groups * sel_rows).astype(np.int32).reshape(n_groups, sel_rows)
    ids[rng.random(ids.shape) < 0.15] = -1
    sq = (x * x).sum(-1) if metric == "L2" else np.zeros(ids.shape, np.float32)
    bsq = np.where(ids >= 0, sq, _BIG).astype(np.float32)
    q = rng.integers(-3, 4, size=(qb, d)).astype(np.float32)
    ggrp = np.stack([rng.permutation(n_groups)[:kg] for _ in range(qb)]).astype(np.int64)
    vals = -rng.random((qb, kg)).astype(np.float32) * 100
    vals[rng.random((qb, kg)) < 0.2] = -np.inf
    vals[0, 1:] = np.float32(-2e38)  # one live slot: fewer live rows than k_loc
    table = torch.from_numpy(x).to(DTYPES[dtype])
    return (torch.from_numpy(q), torch.from_numpy(vals), torch.from_numpy(ggrp), table,
            torch.from_numpy(bsq), torch.from_numpy(ids))


def numpy_rescore(q, vals, ggrp, table, bsq, ids, metric, k_loc):
    """Every candidate scored exactly (f64 of integers), dead ones 3e38,
    sorted by (score, flat position): the top k_loc as (neg, id)."""
    q, vals, ggrp = q.numpy().astype(np.float64), vals.numpy(), ggrp.numpy()
    x, bsq, ids = table.float().numpy().astype(np.float64), bsq.numpy(), ids.numpy()
    qb, kg = ggrp.shape
    sel_rows = x.shape[1]
    negs = np.empty((qb, k_loc), np.float32)
    out = np.empty((qb, k_loc), np.int32)
    for i in range(qb):
        cand = []
        for j in range(kg):
            g = ggrp[i, j]
            for r in range(sel_rows):
                dot = x[g, r] @ q[i]
                s = bsq[g, r] - (dot if metric == "inner_product" else 2 * dot)
                dead = not vals[i, j] > -1.5e38 or ids[g, r] < 0
                cand.append((float(_BIG) if dead else s, j * sel_rows + r, ids[g, r]))
        cand.sort(key=lambda c: (c[0], c[1]))
        for t, (s, _, idx) in enumerate(cand[:k_loc]):
            negs[i, t] = -np.float32(s)
            out[i, t] = idx if -np.float32(s) > -1.5e38 else -1
    return negs, out


# every kg, sel_rows, d, table dtype and metric the engine passes: kg 1 and
# the exhaustive kg, sel_rows 1 / 32 / 128, d 37 (no multiple of 16 bytes),
# 128 and 960
@pytest.mark.parametrize("d,sel_rows,kg", [(37, 1, 1), (128, 32, "all"), (960, 128, 3),
                                           (128, 1, "all"), (37, 32, 5)])
@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_rescore_matches_numpy(dtype, metric, d, sel_rows, kg):
    args = int_block(d, sel_rows, kg, dtype, metric)
    k_loc = min(args[2].shape[1] * sel_rows, 24)
    neg, ids = exact_group_rescore(*args, metric=metric, k_loc=k_loc)
    want_neg, want_ids = numpy_rescore(*args, metric, k_loc)
    assert neg.dtype == torch.float32 and ids.dtype == torch.int32
    np.testing.assert_array_equal(neg.numpy(), want_neg)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    # query 0 has at most one live slot: past its rows the tail is dead
    if k_loc > sel_rows:
        assert (ids[0, sel_rows:] == -1).all() and (neg[0, sel_rows:] == -_BIG).all()
    # the plain version's steps change nothing
    neg1, ids1 = exact_group_rescore_ref(*args, metric=metric, k_loc=k_loc, sub=2)
    assert torch.equal(neg1, neg) and torch.equal(ids1, ids)


def _mutate(args, what):
    q, vals, ggrp, table, bsq, ids = args
    return {
        "q_dtype": (q.double(), vals, ggrp, table, bsq, ids),
        "q_width": (q[:, 1:].contiguous(), vals, ggrp, table, bsq, ids),
        "q_strided": (q.T.contiguous().T, vals, ggrp, table, bsq, ids),
        "vals_shape": (q, vals[:, :-1].contiguous(), ggrp, table, bsq, ids),
        "vals_dtype": (q, vals.double(), ggrp, table, bsq, ids),
        "ggrp_dtype": (q, vals, ggrp.int(), table, bsq, ids),
        "ggrp_strided": (q, vals, ggrp.T.contiguous().T, table, bsq, ids),
        "table_dtype": (q, vals, ggrp, table.half(), bsq, ids),
        "table_rank": (q, vals, ggrp, table.flatten(1), bsq, ids),
        "bsq_shape": (q, vals, ggrp, table, bsq[:-1], ids),
        "ids_dtype": (q, vals, ggrp, table, bsq, ids.long()),
    }[what]


@pytest.mark.parametrize("what", ["q_dtype", "q_width", "q_strided", "vals_shape",
                                  "vals_dtype", "ggrp_dtype", "ggrp_strided", "table_dtype",
                                  "table_rank", "bsq_shape", "ids_dtype", "metric", "k_loc",
                                  "k_zero"])
def test_wrapper_refuses_what_it_does_not_take(what):
    args = int_block(16, 8, 4, "float32", "L2")
    kw = dict(metric="L2", k_loc=10)
    if what == "metric":
        kw["metric"] = "cosine"
    elif what == "k_loc":
        kw["k_loc"] = 4 * 8 + 1  # above kg · sel_rows
    elif what == "k_zero":
        kw["k_loc"] = 0
    else:
        args = _mutate(args, what)
    with pytest.raises(ValueError, match="exact_group_rescore"):
        exact_group_rescore(*args, **kw)
