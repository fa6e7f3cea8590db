"""Tests that need the card (marker `gpu`): K1, K2 and K3 (with its list
inversion and merge), the blocked engine's masked group selection and its
exact rescore built with nvcc and held against their plain versions, and
the CUDA engines (blocked and per-query) and the fused kNN against the CPU
port.
They skip without a CUDA device; on an H100 run

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py configures jax, which the card's
machine does not have; this file imports only torch and the port.)

Tolerance for K1: |kernel − plain| ≤ 2·d·eps32·(max‖x‖² + 2·max‖x‖·‖q‖)
(the same exact products summed in another f32 order); int8 inner-product
scores are exact.  K2 the same for f32 and bf16-rounded inputs; its int8
minima are exact (both round the integer dot to f32 and apply the same
two f32 operations).  K3 the same bound on its scores, with equal id sets
(its inputs have no ties but replicated rows, whose ids are equal too).  The
rescore bit for bit on integer-valued blocks (every sum exact, scores tied
often), and on Gaussian ones within the K1 bound, its ids equal but at
near-ties.  The
engines must agree on nprobe, ndis and
neighbour sets exactly; the fused kNN on ids, except between candidates
whose f64 distances tie to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100: the kernels are built for sm_90a)")
    from lira_tpu_torch import resolve_device

    return resolve_device("cuda")


# (d, qb, live slots per block row): d = 100 is no multiple of 16 bytes a
# row in any dtype (the byte-wise copy), d = 37 no multiple of 4 floats
# (f32's 4-byte copies), d = 960 (GIST) exceeded shared memory before d
# was staged in chunks; qb 200 is no multiple of any query tile, qb 8 the
# engine's smallest block.  A full, a partial and a dead block row; every
# row dead (the persistent walk finds no live item); one live slot (fewer
# live items than the card has SMs)
@pytest.mark.parametrize("d,qb,ulen", [(32, 200, (5, 2, 0)), (100, 200, (5, 2, 0)),
                                       (960, 200, (5, 2, 0)), (128, 8, (5, 2, 0)),
                                       (37, 200, (0, 0, 0)), (128, 200, (0, 1, 0))])
@pytest.mark.parametrize("sel_rows", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_k1_kernel_matches_plain(cuda, dtype, metric, sel_rows, d, qb, ulen):
    from lira_tpu_torch.engine.block_scan import screen_queries
    from lira_tpu_torch.engine.screen import union_groupmin, union_groupmin_ref

    if dtype == torch.int8 and d % 4:
        d += 4 - d % 4  # the raw K1 int8 takes d in words of 4 values (the engine pads)
    g = torch.Generator().manual_seed(1)
    U, rows, n_super = 5, 3, 6
    x = torch.randn(n_super * 1024, d, generator=g)
    q = torch.randn(rows * qb, d, generator=g)
    supers = torch.randint(0, n_super, (rows, U), generator=g, dtype=torch.int32)
    ulen = torch.tensor(ulen, dtype=torch.int32)
    s = torch.clamp_min(x.abs().amax(0), 1e-30) / 127.0
    q, t_eff, s2 = screen_queries(q.to(cuda), dtype, s.to(cuda), metric)
    if dtype == torch.int8:
        x = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    else:
        x = x.to(dtype)
    args = [a.to(cuda) for a in (q, x, supers, ulen)]
    kw = dict(qb=qb, metric=metric, sel_rows=sel_rows, t_eff=t_eff, s2=s2)
    before = union_groupmin.launches
    before_dt = union_groupmin.launches_by_dtype[str(dtype).removeprefix("torch.")]
    got = union_groupmin(*args, **kw)
    torch.cuda.synchronize()
    assert union_groupmin.launches == before + 1
    assert union_groupmin.launches_by_dtype[str(dtype).removeprefix("torch.")] == before_dt + 1
    want = union_groupmin_ref(*args, **kw)
    SG = 1024 // sel_rows
    big = torch.tensor(3e38, dtype=torch.float32, device=cuda)
    for i, n_live in enumerate(ulen.tolist()):
        assert bool((got[i, n_live * SG:] == big).all()), i
    xf = args[1].float()
    if dtype == torch.int8:
        tol = 0.0 if metric == "inner_product" else 2 * d * EPS32 * float(((xf * xf) @ s2).max())
    else:
        xn = float((xf * xf).sum(1).max())
        qn = float((args[0].float() ** 2).sum(1).max())
        tol = 2 * d * EPS32 * (xn + 2 * (xn * qn) ** 0.5)
    assert float((got - want).abs().max()) <= tol


def _select_block(dev, n_g, qb, case, seed, n_bkt=12, live=None, p=0.3):
    """One block's K1 output as the engine hands it to the selection:
    minima (n_g, qb), buckets (n_g,) with all-pad groups at -1, and past
    `live` groups the union's padding slots (exactly 3e38, bucket -1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    live = n_g if live is None else live
    gmin = torch.randn(n_g, qb, generator=g, device=dev) * 100
    if case == "ties":
        gmin = torch.round(gmin / 40) * 40
    if case == "negzero":  # +-0 minima lead: the rest are positive
        gmin = gmin.abs() + 1
        z = torch.rand(n_g, qb, generator=g, device=dev) < 0.4
        gmin = torch.where(z, torch.where(torch.rand(n_g, qb, generator=g, device=dev) < 0.5,
                                          -0.0, 0.0), gmin)
    tb = torch.randint(0, n_bkt, (n_g,), generator=g, device=dev, dtype=torch.int32)
    tb[torch.rand(n_g, generator=g, device=dev) < 0.1] = -1
    probed = torch.rand(qb, n_bkt, generator=g, device=dev) < p
    if case == "all_masked":
        probed[::2] = False
    if case == "few_finite":
        probed[:] = False
        probed[:, 0] = True
    gmin[live:] = 3e38
    tb[live:] = -1
    return gmin.contiguous(), tb, probed


def _check_select(gmin, tb, probed, live_slots, unit, kg):
    from lira_tpu_torch.engine.group_select import masked_group_topk, masked_group_topk_ref

    live = torch.tensor([live_slots], dtype=torch.int32, device=gmin.device)
    before = masked_group_topk.launches
    v, i = masked_group_topk(gmin, tb, probed, live, kg, unit=unit)
    torch.cuda.synchronize()
    assert masked_group_topk.launches == before + 1
    v_r, i_r = masked_group_topk_ref(gmin, tb, probed, live, kg, unit=unit)
    assert torch.equal(v.view(torch.int32), v_r.view(torch.int32))
    assert torch.equal(i, i_r)


# every case of the CPU test of the plain version (ties, +-0 minima, queries
# that probe nothing, fewer finite groups than kg, padding slots), at qb 8
# (the engine's smallest block) and 1,024 (the cells')
@pytest.mark.parametrize("qb", [8, 1024])
@pytest.mark.parametrize("case", ["plain", "ties", "negzero", "all_masked", "few_finite",
                                  "short_live"])
@pytest.mark.parametrize("kg", [1, 42, 52, 256])
@pytest.mark.parametrize("sel_rows", [1, 8, 32, 64, 128])
def test_group_select_kernel_matches_plain(cuda, sel_rows, kg, case, qb):
    U, SG = 4, 1024 // sel_rows
    live = U - 1 if case == "short_live" else U
    gmin, tb, probed = _select_block(cuda, U * SG, qb, case, sel_rows + kg, live=live * SG)
    _check_select(gmin, tb, probed, live, SG, min(kg, U * SG))


# the cells' shapes (1M: 32,768 groups, ~75% live; 10M: 524,288, ~94% live;
# ~1.6% of the buckets probed), qb 200 (no multiple of a query tile), and kg
# beyond 32 queries a CTA: 900 at 16 queries a CTA, 1,224 at 8, and every
# group of the union (the margin calibration's exhaustive reference, in
# passes)
@pytest.mark.parametrize("n_g,qb,live,kg,n_bkt,p", [
    (32768, 1024, 24576, 42, 1024, 0.008), (524288, 1024, 491520, 52, 2048, 0.016),
    (4096, 200, 3000, 52, 64, 0.1), (32768, 1024, 24576, 900, 1024, 0.008),
    (32768, 256, 30000, 1224, 2048, 0.016), (8192, 256, 7000, 8192, 2048, 0.05)])
def test_group_select_kernel_at_the_cells_shapes(cuda, n_g, qb, live, kg, n_bkt, p):
    gmin, tb, probed = _select_block(cuda, n_g, qb, "plain", 5, n_bkt=n_bkt, live=live, p=p)
    _check_select(gmin, tb, probed, live, 1, kg)


def _rescore_block(dev, qb, kg, sel_rows, d, dtype, metric, seed, ints, p_dead=0.1):
    """One block's rescore inputs as the engine hands them over: a table
    (8·kg groups, at least 256) with replicated groups (equal scores) and
    −1 ids, each query's kg distinct groups drawn near its own place in the
    table (neighbouring queries share groups, as in a tour-grouped block),
    slots invalid at rate p_dead and all but one of query 0's.  `ints`:
    small integers, whose every f32 sum is exact in any order."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_groups = max(8 * kg, 256)
    shape = (n_groups, sel_rows, d)
    if ints:
        x = torch.randint(-2, 3, shape, generator=g, device=dev).float()
        q = torch.randint(-3, 4, (qb, d), generator=g, device=dev).float()
    else:
        x = torch.randn(shape, generator=g, device=dev)
        q = torch.randn((qb, d), generator=g, device=dev)
    x[1::7] = x[0]
    if dtype == torch.int8 and not ints:
        x = torch.round(x * 30).clamp(-127, 127)
    table = x.to(dtype)
    ids = torch.randperm(n_groups * sel_rows, generator=g, device=dev).int().view(n_groups,
                                                                                   sel_rows)
    ids[torch.rand(ids.shape, generator=g, device=dev) < 0.05] = -1
    x = table.float()
    sq = (x * x).sum(-1) if metric == "L2" else torch.zeros(ids.shape, device=dev)
    bsq = torch.where(ids >= 0, sq, 3e38)
    home = torch.arange(qb, device=dev)[:, None] * (n_groups - 4 * kg) // qb
    near = torch.argsort(torch.rand((qb, 4 * kg), generator=g, device=dev), dim=1)[:, :kg]
    ggrp = (home + near).contiguous()
    vals = -torch.rand((qb, kg), generator=g, device=dev) * 100
    vals[torch.rand((qb, kg), generator=g, device=dev) < p_dead] = -torch.inf
    vals[0, 1:] = -2e38
    return q, vals, ggrp, table, bsq, ids


def _check_rescore(args, metric, k_loc, exact):
    """The rescore kernel against its plain version: bit for bit on exact
    sums; else scores within the K1 bound (the same products summed in
    another f32 order) and ids equal except at slots whose plain scores lie
    within twice that of a neighbour's or at the list's cut (near-ties the
    two orders may rank apart)."""
    from lira_tpu_torch.engine.group_rescore import (_round2_sub, exact_group_rescore,
                                                     exact_group_rescore_ref)

    q, vals, ggrp, table = args[:4]
    before = exact_group_rescore.launches
    neg, ids = exact_group_rescore(*args, metric=metric, k_loc=k_loc)
    torch.cuda.synchronize()
    assert exact_group_rescore.launches == before + 1
    sub = _round2_sub(ggrp.shape[1], table.shape[1], table.shape[2], q.shape[0])
    neg_r, ids_r = exact_group_rescore_ref(*args, metric=metric, k_loc=k_loc, sub=sub)
    if exact:
        assert torch.equal(neg.view(torch.int32), neg_r.view(torch.int32))
        assert torch.equal(ids, ids_r)
        return
    x = table.float()
    xn = float((x * x).sum(-1).max())
    tol = 2 * table.shape[2] * EPS32 * (xn + 2 * (xn * (q * q).sum(1, keepdim=True)).sqrt())
    assert bool(((neg - neg_r).abs() <= tol).all())
    near = torch.zeros_like(ids, dtype=torch.bool)
    gap = (neg_r[:, 1:] - neg_r[:, :-1]).abs() <= 2 * tol
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    near[:, -1] = True
    assert not bool(((ids != ids_r) & ~near).any())


# on exact sums, every shape the engine passes: one candidate row; the 1M
# cell's block (kg 42, k 10) and GIST's (d 960, kg 52, k 20); every
# candidate kept; rows of 400 / 200 / 100 bytes (read an element at a time);
# 16K live rows a query (k 100 at n_mul 2: the buffer reduced in passes);
# the margin calibration's exhaustive kg (most slots invalid, skipped); the
# largest k_loc of the least buffer (4,096 keys); k_loc above it (buffers
# of 8,192 and 16,384 keys)
@pytest.mark.parametrize("d,sel_rows,kg,qb,k_loc,p_dead", [
    (37, 1, 1, 8, 1, 0.1), (128, 32, 42, 200, 10, 0.1), (960, 32, 52, 64, 20, 0.1),
    (960, 128, 3, 64, 384, 0.1), (100, 8, 52, 64, 20, 0.1), (128, 32, 512, 64, 200, 0.0),
    (128, 32, 1024, 16, 20, 0.97), (128, 4, 300, 32, 1024, 0.0),
    (128, 8, 300, 16, 2000, 0.0), (960, 32, 160, 8, 4096, 0.0)])
@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_group_rescore_kernel_matches_plain_exactly(cuda, dtype, metric, d, sel_rows, kg, qb,
                                                   k_loc, p_dead):
    args = _rescore_block(cuda, qb, kg, sel_rows, d, dtype, metric, d + kg, True, p_dead)
    _check_rescore(args, metric, k_loc, exact=True)


def test_group_rescore_refuses_a_list_above_shared_memory(cuda):
    """k_loc 8,192 needs a buffer of 32,768 keys (256 KB), more than a CTA's
    shared memory: the wrapper raises before any launch."""
    from lira_tpu_torch.engine.group_rescore import exact_group_rescore

    args = _rescore_block(cuda, 4, 300, 32, 128, torch.float32, "L2", 3, True)
    before = exact_group_rescore.launches
    with pytest.raises(ValueError, match="shared memory"):
        exact_group_rescore(*args, metric="L2", k_loc=8192)
    assert exact_group_rescore.launches == before


# the cells' blocks on Gaussian rows (1,024 queries: 1M kg 42 k 10, 10M kg
# 52 k 20, GIST d 960, k 100 at n_mul 2), the table in f32 and in capacity
# mode's bf16 and int8
@pytest.mark.parametrize("d,kg,k_loc,metric", [(128, 42, 10, "L2"), (128, 52, 20, "L2"),
                                               (960, 52, 20, "L2"), (128, 232, 200, "L2"),
                                               (128, 42, 10, "inner_product")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_group_rescore_kernel_at_the_cells_shapes(cuda, dtype, d, kg, k_loc, metric):
    args = _rescore_block(cuda, 1024, kg, 32, d, dtype, metric, 7, False)
    _check_rescore(args, metric, k_loc, exact=False)


# d = 37: the int8 table is zero-padded to 40 columns; sel_rows 1 and 8:
# groups below a wgmma quad's 8 columns and below the FMA tile's 16 lanes
@pytest.mark.parametrize("dim,sel_rows", [(32, None), (37, None), (32, 8), (32, 1)])
@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_engine_matches_cpu_engine(cuda, scan_dtype, dim, sel_rows):
    from lira_tpu_torch.engine.group_rescore import exact_group_rescore
    from lira_tpu_torch.engine.group_select import masked_group_topk
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.labels.scaler import scaled_centroid_distances
    from lira_tpu_torch.models.probing_mlp import ProbingMLP
    from lira_tpu_torch.partition import build_bucket_layout, kmeans_assign, kmeans_fit

    rng = np.random.default_rng(2)
    x = rng.normal(size=(6000, dim)).astype(np.float32)
    xq = rng.normal(size=(300, dim)).astype(np.float32)
    km = kmeans_fit(x, 16, niter=5, device="cpu")
    layout = build_bucket_layout(kmeans_assign(x, km.centroids, device="cpu"), 16)
    _, _, sc = scaled_centroid_distances(x, None, km.centroids, device="cpu")
    mlp = ProbingMLP(16, dim, generator=torch.Generator().manual_seed(0))
    kw = dict(scan_dtype=scan_dtype, probe_cap=8, block_q=64, block_sel_rows=sel_rows)
    e_cpu = QueryEngine(x, layout, km.centroids, sc, mlp, device="cpu", **kw)
    e_gpu = QueryEngine(x, layout, km.centroids, sc, mlp, device=cuda, **kw)
    v = np.unique(e_cpu.probe(xq))
    j = int(0.7 * (len(v) - 1))
    while v[j + 1] - v[j] < 1e-5:
        j += 1
    thr = float((v[j] + v[j + 1]) / 2)
    select_before = masked_group_topk.launches
    rescore_before = exact_group_rescore.launches
    r_c, r_g = e_cpu.search(xq, thr, 10), e_gpu.search(xq, thr, 10)
    assert masked_group_topk.launches > select_before  # the card's selection is the kernel
    assert exact_group_rescore.launches > rescore_before  # and so is its rescore
    np.testing.assert_array_equal(r_c.nprobe, r_g.nprobe)
    np.testing.assert_array_equal(r_c.ndis, r_g.ndis)
    for i in range(len(xq)):
        assert set(r_c.ids[i]) == set(r_g.ids[i]), i
    r_s = e_gpu.search_stream(np.concatenate([xq, xq]), thr, 10, batch_size=300)
    np.testing.assert_array_equal(r_s.ids, np.concatenate([r_g.ids, r_g.ids]))


def test_cuda_engine_union_slices_match_cpu_engine(cuda, monkeypatch):
    """_GMIN_BUDGET at one supertile: each block's union is screened and
    selected one slice at a time (the running top-kg merge), one kernel
    call a slice, and the card's answers stay the CPU engine's."""
    from lira_tpu_torch.engine import block_scan
    from lira_tpu_torch.engine.group_select import masked_group_topk
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.labels.scaler import scaled_centroid_distances
    from lira_tpu_torch.models.probing_mlp import ProbingMLP
    from lira_tpu_torch.partition import build_bucket_layout, kmeans_assign, kmeans_fit

    rng = np.random.default_rng(3)
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    xq = rng.normal(size=(100, 32)).astype(np.float32)
    km = kmeans_fit(x, 16, niter=5, device="cpu")
    layout = build_bucket_layout(kmeans_assign(x, km.centroids, device="cpu"), 16)
    _, _, sc = scaled_centroid_distances(x, None, km.centroids, device="cpu")
    mlp = ProbingMLP(16, 32, generator=torch.Generator().manual_seed(0))
    kw = dict(scan_dtype="int8", probe_cap=8, block_q=32)
    e_cpu = QueryEngine(x, layout, km.centroids, sc, mlp, device="cpu", **kw)
    e_gpu = QueryEngine(x, layout, km.centroids, sc, mlp, device=cuda, **kw)
    thr = float(np.quantile(e_cpu.probe(xq), 0.7))
    monkeypatch.setattr(block_scan, "_GMIN_BUDGET", 1)
    r_c = e_cpu.search(xq, thr, 10)
    before = masked_group_topk.launches
    r_g = e_gpu.search(xq, thr, 10)
    plan = block_scan._LAST_CHUNK_PLAN
    assert plan["u_chunk"] == 1 and plan["U"] >= 2, plan
    assert masked_group_topk.launches - before == plan["n_blocks"] * plan["U"]
    np.testing.assert_array_equal(r_c.nprobe, r_g.nprobe)
    for i in range(len(xq)):
        assert set(r_c.ids[i]) == set(r_g.ids[i]), i


# d = 37: no multiple of 4 floats (4-byte copies; the tensor cores' tables
# pad to 64 bf16 / 128 int8 columns), 960: 30 slices of d, 15 bf16 steps;
# 10 groups: no multiple of the 8 groups an item holds; 9: odd (the last
# 256-row tensor-core tile holds one group); Q = 1: one query row of 128
@pytest.mark.parametrize("Q,n_groups", [(300, 10), (300, 9), (1, 10)])
@pytest.mark.parametrize("d", [37, 128, 960])
@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("mode", ["highest", "default", "int8"])
def test_k2_kernel_matches_plain(cuda, mode, metric, d, Q, n_groups):
    from lira_tpu_torch.ops.groupmin import groupmin, groupmin_ref

    g = torch.Generator().manual_seed(3)
    n_pad = 128 * n_groups
    n = n_pad - 80  # ragged query tile, pad rows
    x = torch.zeros(n_pad, d)
    x[:n] = torch.randn(n, d, generator=g)
    q = torch.randn(Q, d, generator=g)
    bsq = torch.full((n_pad,), 1e30)
    bsq[:n] = (x[:n] * x[:n]).sum(1) if metric == "L2" else 0.0
    kw = dict(metric=metric)
    if mode == "int8":
        s = torch.clamp_min(x.abs().amax(0), 1e-30) / 127.0
        x = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        t = (q * s).abs().amax() / 127.0
        q = torch.clamp(torch.round(q * s / t), -127, 127).to(torch.int8)
        kw["t_eff"] = (t if metric == "inner_product" else 2 * t).reshape(1, 1).to(cuda)
    else:
        kw["precision"] = mode
    args = [a.to(cuda) for a in (q, x, bsq.view(-1, 128))]
    before = groupmin.launches
    got = groupmin(*args, **kw)
    torch.cuda.synchronize()
    assert groupmin.launches == before + 1 and got.shape == (Q, n_pad // 128)
    want = groupmin_ref(*args, **kw)
    assert bool((got[:, -1] < 1e29).all())  # the partly padded group
    if mode == "int8":
        tol = 0.0
    else:
        qf, xf = args[0].float(), args[1].float()
        xn = float((xf * xf).sum(1).max())
        qn = float((qf * qf).sum(1).max())
        tol = 2 * d * EPS32 * (xn + 2 * (xn * qn) ** 0.5)
    assert float((got - want).abs().max()) <= tol


def test_k2_bf16_table_same_as_f32_inputs(cuda):
    """"default" on f32 inputs (the wrapper rounds and pads them) and on
    their padded bf16 tables (as knn_fused passes them): the same launch,
    bit for bit."""
    from lira_tpu_torch.ops.groupmin import groupmin, pad_cols

    g = torch.Generator().manual_seed(5)
    x = torch.randn(9 * 128, 100, generator=g).to(cuda)
    q = torch.randn(257, 100, generator=g).to(cuda)
    bsq = (x * x).sum(1)
    kw = dict(metric="L2", precision="default")
    a = groupmin(q, x, bsq, **kw)
    b = groupmin(pad_cols(q.to(torch.bfloat16)), pad_cols(x.to(torch.bfloat16)), bsq, **kw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["highest", "default", "int8"])
def test_knn_fused_cuda_matches_cpu(cuda, precision):
    from lira_tpu_torch.ops.groupmin import groupmin
    from lira_tpu_torch.ops.knn_pallas import knn_fused, self_knn_fused

    rng = np.random.default_rng(4)
    base = rng.normal(size=(5000, 32)).astype(np.float32)
    query = rng.normal(size=(700, 32)).astype(np.float32)
    margin = None if precision == "highest" else 40  # 40 groups: exhaustive
    kw = dict(k=10, precision=precision, margin=margin, q_tile=512)
    before = groupmin.launches
    _, i_g = knn_fused(base, query, device=cuda, **kw)
    assert groupmin.launches == before + 2  # two 512-query tiles
    _, i_c = knn_fused(base, query, device="cpu", **kw)
    dist = ((query[:, None, :].astype(np.float64) - base[None].astype(np.float64)) ** 2).sum(-1)
    rows = np.arange(len(query))[:, None]
    np.testing.assert_allclose(dist[rows, i_g], dist[rows, i_c], rtol=1e-6)
    tied = np.isclose(dist[rows, i_g], dist[rows, i_c], rtol=1e-6) & (i_g != i_c)
    np.testing.assert_array_equal(np.where(tied, i_c, i_g), i_c)
    if precision == "highest":
        k_g = self_knn_fused(base, 5, precision="highest", device=cuda)
        assert not (k_g == np.arange(len(base))[:, None]).any()


@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("k", [1, 20, 36, 128])
@pytest.mark.parametrize("d", [37, 128, 960])
def test_k3_kernel_matches_plain(cuda, d, k, metric):
    """Ragged lists with −1 holes in the middle, a tile listed twice, a
    partly padded tile, one tile in every list but the empty one (its
    ≥ 298 entries span ≥ 19 work items of 16); d = 37 takes the kernel's 4-byte copies, d = 960
    30 chunks of d an item."""
    from lira_tpu_torch.engine.pallas_scan import pallas_probed_scan, probed_scan_ref

    g = torch.Generator().manual_seed(5)
    n_tiles, B, T = 12, 300, 9
    corpus = torch.randn(n_tiles, 128, d, generator=g)
    ids = torch.arange(n_tiles * 128, dtype=torch.int32).view(n_tiles, 128)
    ids[-1, 90:] = -1
    sq = (corpus * corpus).sum(-1) if metric == "L2" else torch.zeros(n_tiles, 128)
    sq[ids < 0] = 3e38
    tiles = torch.randint(0, n_tiles, (B, T), generator=g, dtype=torch.int32)
    tiles[torch.rand(B, T, generator=g) < 0.3] = -1
    tiles[0] = -1  # a query with no tile
    tiles[1, :2] = 4  # one tile twice
    tiles[2:, 5] = 7  # one tile in every list that has tiles
    q = torch.randn(B, d, generator=g)
    args = [a.to(cuda) for a in (q, tiles, corpus, ids, sq)]
    before = pallas_probed_scan.launches
    s_k, i_k = pallas_probed_scan(*args, k, metric)
    torch.cuda.synchronize()
    assert pallas_probed_scan.launches == before + 1
    s_r, i_r = probed_scan_ref(*args, k, metric)
    assert bool((i_k[0] == -1).all()) and bool((s_k[0] >= 1e37).all())
    assert torch.equal(s_k >= 1e37, s_r >= 1e37)
    live = s_r < 1e37
    xn = float((corpus * corpus).sum(-1).max())
    qn = float((q * q).sum(1).max())
    tol = 2 * d * EPS32 * (xn + 2 * (xn * qn) ** 0.5)
    assert float((s_k[live] - s_r[live]).abs().max()) <= tol
    i_k, i_r = i_k.cpu().numpy(), i_r.cpu().numpy()
    for b in range(B):
        assert sorted(i_k[b]) == sorted(i_r[b]), b


@pytest.mark.parametrize("B,T,n_tiles", [(300, 9, 12), (2048, 64, 4096), (5, 3, 100_000)])
def test_k3_inversion_kernel_matches_plain(cuda, B, T, n_tiles):
    """Holes, a tile listed twice, one tile in every list (hundreds of
    entries), and more tiles than the scan kernel's one-CTA prefix sum
    takes in one pass (100,000)."""
    from lira_tpu_torch.engine.pallas_scan import (invert_tile_lists, invert_tile_lists_ref,
                                                   items_canonical)

    g = torch.Generator().manual_seed(7)
    tiles = torch.randint(0, n_tiles, (B, T), generator=g, dtype=torch.int32)
    tiles[torch.rand(B, T, generator=g) < 0.3] = -1
    tiles[0] = -1
    tiles[1, :2] = 1
    tiles[:, -1] = 2
    before = invert_tile_lists.launches
    got = invert_tile_lists(tiles.to(cuda), n_tiles)
    torch.cuda.synchronize()
    assert invert_tile_lists.launches == before + 1
    want = invert_tile_lists_ref(tiles, n_tiles)
    for a, b in zip(items_canonical(*got), items_canonical(*want)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k", [1, 20, 128])
def test_k3_merge_kernel_matches_plain(cuda, k):
    """Sorted candidate lists with equal scores across and within slots,
    3e38 entries, holes holding garbage, and a query whose every slot is a
    hole (3e38 / −1 out)."""
    from lira_tpu_torch.engine.pallas_scan import merge_topk, merge_topk_ref

    g = torch.Generator().manual_seed(8)
    B, T, kp = 200, 16, min(k, 128)
    v = torch.randint(0, 50, (B * T, kp), generator=g).float().sort(dim=1).values
    v[torch.rand(B * T, kp, generator=g) < 0.1] = 3e38
    v = v.sort(dim=1).values
    i = torch.randint(0, 10_000, (B * T, kp), generator=g, dtype=torch.int32)
    tiles = torch.randint(0, 9, (B, T), generator=g, dtype=torch.int32)
    tiles[torch.rand(B, T, generator=g) < 0.3] = -1
    tiles[3] = -1
    v[(tiles < 0).view(-1)] = -1.0  # garbage the merge must not read
    before = merge_topk.launches
    s_k, i_k = merge_topk(v.to(cuda), i.to(cuda), tiles.to(cuda), k)
    torch.cuda.synchronize()
    assert merge_topk.launches == before + 1
    s_r, i_r = merge_topk_ref(v, i, tiles, k)
    assert torch.equal(s_k.cpu(), s_r) and torch.equal(i_k.cpu(), i_r)


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
def test_per_query_cuda_engine_matches_cpu_engine(cuda, scan_impl, scan_dtype):
    from lira_tpu_torch.engine.pallas_scan import pallas_probed_scan
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.labels.scaler import scaled_centroid_distances
    from lira_tpu_torch.models.probing_mlp import ProbingMLP
    from lira_tpu_torch.partition import build_bucket_layout, kmeans_assign, kmeans_fit

    rng = np.random.default_rng(6)
    x = rng.normal(size=(6000, 32)).astype(np.float32)
    xq = rng.normal(size=(300, 32)).astype(np.float32)
    km = kmeans_fit(x, 16, niter=5, device="cpu")
    layout = build_bucket_layout(kmeans_assign(x, km.centroids, device="cpu"), 16)
    _, _, sc = scaled_centroid_distances(x, None, km.centroids, device="cpu")
    mlp = ProbingMLP(16, 32, generator=torch.Generator().manual_seed(0))
    kw = dict(scan_impl=scan_impl, scan_dtype=scan_dtype, probe_cap=8)
    e_cpu = QueryEngine(x, layout, km.centroids, sc, mlp, device="cpu", **kw)
    e_gpu = QueryEngine(x, layout, km.centroids, sc, mlp, device=cuda, **kw)
    v = np.unique(e_cpu.probe(xq))
    j = int(0.7 * (len(v) - 1))
    while v[j + 1] - v[j] < 1e-5:
        j += 1
    thr = float((v[j] + v[j + 1]) / 2)
    before = pallas_probed_scan.launches
    r_c, r_g = e_cpu.search(xq, thr, 10), e_gpu.search(xq, thr, 10)
    assert pallas_probed_scan.launches - before == (1 if scan_impl == "pallas" else 0)
    np.testing.assert_array_equal(r_c.nprobe, r_g.nprobe)
    np.testing.assert_array_equal(r_c.ndis, r_g.ndis)
    for i in range(len(xq)):
        assert set(r_c.ids[i]) == set(r_g.ids[i]), i
    r_s = e_gpu.search_stream(np.concatenate([xq, xq]), thr, 10, batch_size=300)
    np.testing.assert_array_equal(r_s.ids, np.concatenate([r_g.ids, r_g.ids]))


def test_sharded_engine_on_the_card_matches_single_chip(cuda):
    """The sharded engine on 2 gloo ranks sharing the card (K1 on each
    rank, 'pallas' by default there) against the card's single-chip
    blocked engine: nprobe and ndis equal in f32, bf16, int8 and capacity
    int8, neighbour sets equal in f32 and exact against a numpy oracle over
    the probed buckets on 64 queries in the others; search_stream ==
    search."""
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.labels.scaler import scaled_centroid_distances
    from lira_tpu_torch.models.probing_mlp import ProbingMLP
    from lira_tpu_torch.parallel import launch_many, serve_rank
    from lira_tpu_torch.partition import build_bucket_layout, kmeans_assign, kmeans_fit

    rng = np.random.default_rng(4)
    x = rng.normal(size=(6000, 32)).astype(np.float32)
    xq = rng.normal(size=(300, 32)).astype(np.float32)
    km = kmeans_fit(x, 16, niter=5, device="cpu")
    layout = build_bucket_layout(kmeans_assign(x, km.centroids, device="cpu"), 16)
    _, _, sc = scaled_centroid_distances(x, None, km.centroids, device="cpu")
    mlp = ProbingMLP(16, 32, generator=torch.Generator().manual_seed(0))
    modes = [dict(scan_dtype=dt) for dt in ("float32", "bfloat16", "int8")]
    modes.append(dict(scan_dtype="int8", store_f32=False))
    e0 = QueryEngine(x, layout, km.centroids, sc, mlp, device=cuda)
    v = np.unique(e0.probe(xq))
    j = int(0.7 * (len(v) - 1))
    while v[j + 1] - v[j] < 1e-5:
        j += 1
    thr = float((v[j] + v[j + 1]) / 2)
    reqs = [("search", (xq, thr, 10), {}), ("search_stream", (xq, thr, 10),
                                             dict(batch_size=128))]
    calls = [(serve_rank, (x, layout, km.centroids, sc, mlp, reqs),
              dict(block_q=64, probe_cap=8, **kw)) for kw in modes]
    outs = launch_many(2, calls, backend="gloo", device="cuda")
    for kw, out in zip(modes, outs):
        single = QueryEngine(x, layout, km.centroids, sc, mlp, device=cuda, block_q=64,
                             probe_cap=8, **kw)
        r1 = single.search(xq, thr, 10)
        r2, r_s = out["results"]
        assert all(r["local_impl"] == "pallas" and r["k1_launches"] > 0
                   and r["select_launches"] > 0 and r["rescore_launches"] > 0
                   and r["device"] == "cuda:0"
                   for r in out["ranks"]), kw
        np.testing.assert_array_equal(r1.nprobe, r2.nprobe)
        np.testing.assert_array_equal(r1.ndis, r2.ndis)
        if kw["scan_dtype"] == "float32":
            for i in range(len(xq)):
                assert set(r1.ids[i]) == set(r2.ids[i]), (kw, i)
        else:  # each rank selects its own top groups: the oracle decides
            probed = single._select_probed(xq[:64], thr)
            for i in range(64):
                members = np.unique(np.concatenate(
                    [layout.bucket_members(b) for b in np.nonzero(probed[i])[0]]))
                dd = ((x[members] - xq[i]) ** 2).sum(axis=1)
                assert set(r2.ids[i]) == set(members[np.argsort(dd)[:10]]), (kw, i)
        np.testing.assert_array_equal(r_s.ids, r2.ids)


def test_nccl_refuses_ranks_that_share_a_card(cuda):
    from lira_tpu_torch.parallel import launch
    from lira_tpu_torch.parallel.sharded_kmeans import sharded_kmeans_fit

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
        launch(n, sharded_kmeans_fit, None, 4, backend="nccl")


def test_kernels_on_tables_past_2_31_elements(cuda):
    """chip_smoke.py's phase_large_tables at the smallest table that passes
    2^31 elements (16,385 supertiles × 128): K1 in three dtypes, K2 in
    three modes and K3 on the rows past the mark, each against its plain
    version within the grids' tolerances (the phase raises otherwise)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from lira_tpu_torch import true_fp32

    with true_fp32():
        errs = smoke.phase_large_tables(cuda, n_super=16_385, reps=1)
    assert set(errs) == {"K1 float32", "K1 bfloat16", "K1 int8", "K2 highest", "K2 default",
                         "K2 int8", "K3 float32"}
