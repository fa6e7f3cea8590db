"""Tests that need the card (marker `gpu`): K1 built with nvcc and held
against its plain version, and the CUDA engine against the CPU engine.
They skip without a CUDA device; on an H100 run

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py configures jax, which the card's
machine does not have; this file imports only torch and the port.)

Tolerance for K1: |kernel − plain| ≤ 2·d·eps32·(max‖x‖² + 2·max‖x‖·‖q‖)
(the same exact products summed in another f32 order); int8 inner-product
scores are exact.  The engines must agree on nprobe, ndis and neighbour
sets exactly.
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


@pytest.mark.parametrize("sel_rows", [32, 64, 128])
@pytest.mark.parametrize("metric", ["L2", "inner_product"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_k1_kernel_matches_plain(cuda, dtype, metric, sel_rows):
    from lira_tpu_torch.engine.block_scan import screen_queries
    from lira_tpu_torch.engine.screen import union_groupmin, union_groupmin_ref

    g = torch.Generator().manual_seed(1)
    qb, d, U, rows, n_super = 200, 32, 5, 3, 6  # qb not a multiple of the 64-query tile
    x = torch.randn(n_super * 1024, d, generator=g)
    q = torch.randn(rows * qb, d, generator=g)
    supers = torch.randint(0, n_super, (rows, U), generator=g, dtype=torch.int32)
    ulen = torch.tensor([U, 2, 0], dtype=torch.int32)
    s = torch.clamp_min(x.abs().amax(0), 1e-30) / 127.0
    q, t_eff, s2 = screen_queries(q.to(cuda), dtype, s.to(cuda), metric)
    if dtype == torch.int8:
        x = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    else:
        x = x.to(dtype)
    args = [a.to(cuda) for a in (q, x, supers, ulen)]
    kw = dict(qb=qb, metric=metric, sel_rows=sel_rows, t_eff=t_eff, s2=s2)
    before = union_groupmin.launches
    got = union_groupmin(*args, **kw)
    torch.cuda.synchronize()
    assert union_groupmin.launches == before + 1
    want = union_groupmin_ref(*args, **kw)
    SG = 1024 // sel_rows
    big = torch.tensor(3e38, dtype=torch.float32, device=cuda)
    assert bool((got[1, 2 * SG:] == big).all()) and bool((got[2] == big).all())
    xf = args[1].float()
    if dtype == torch.int8:
        tol = 0.0 if metric == "inner_product" else 2 * d * EPS32 * float(((xf * xf) @ s2).max())
    else:
        xn = float((xf * xf).sum(1).max())
        qn = float((args[0].float() ** 2).sum(1).max())
        tol = 2 * d * EPS32 * (xn + 2 * (xn * qn) ** 0.5)
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_engine_matches_cpu_engine(cuda, scan_dtype):
    from lira_tpu_torch.engine.serve import QueryEngine
    from lira_tpu_torch.labels.scaler import scaled_centroid_distances
    from lira_tpu_torch.models.probing_mlp import ProbingMLP
    from lira_tpu_torch.partition import build_bucket_layout, kmeans_assign, kmeans_fit

    rng = np.random.default_rng(2)
    x = rng.normal(size=(6000, 32)).astype(np.float32)
    xq = rng.normal(size=(300, 32)).astype(np.float32)
    km = kmeans_fit(x, 16, niter=5, device="cpu")
    layout = build_bucket_layout(kmeans_assign(x, km.centroids, device="cpu"), 16)
    _, _, sc = scaled_centroid_distances(x, None, km.centroids, device="cpu")
    mlp = ProbingMLP(16, 32, generator=torch.Generator().manual_seed(0))
    kw = dict(scan_dtype=scan_dtype, probe_cap=8, block_q=64)
    e_cpu = QueryEngine(x, layout, km.centroids, sc, mlp, device="cpu", **kw)
    e_gpu = QueryEngine(x, layout, km.centroids, sc, mlp, device=cuda, **kw)
    v = np.unique(e_cpu.probe(xq))
    j = int(0.7 * (len(v) - 1))
    while v[j + 1] - v[j] < 1e-5:
        j += 1
    thr = float((v[j] + v[j + 1]) / 2)
    r_c, r_g = e_cpu.search(xq, thr, 10), e_gpu.search(xq, thr, 10)
    np.testing.assert_array_equal(r_c.nprobe, r_g.nprobe)
    np.testing.assert_array_equal(r_c.ndis, r_g.ndis)
    for i in range(len(xq)):
        assert set(r_c.ids[i]) == set(r_g.ids[i]), i
    r_s = e_gpu.search_stream(np.concatenate([xq, xq]), thr, 10, batch_size=300)
    np.testing.assert_array_equal(r_s.ids, np.concatenate([r_g.ids, r_g.ids]))
