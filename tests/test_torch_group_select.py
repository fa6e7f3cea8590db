"""The blocked engine's masked group selection (engine/group_select.py) on
the CPU: its plain version against the chain of operations `select_slice`
ran inline before it, the padding slots' −inf tail, the kernel's plan for
every engine caller's kg, and the `select.pairs` counter.  The CUDA kernel
is held to the plain version bit for bit in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from lira_tpu_torch.engine.block_scan import _resolve_margin
from lira_tpu_torch.engine.group_select import (
    masked_group_topk,
    masked_group_topk_ref,
    select_plan,
)
from lira_tpu_torch.engine.screen import S_TILES
from lira_tpu_torch.ops.topk import top_k

_BIG = 3e38


def _inline_chain(gmin, probed, tb, kg):
    """`select_slice` as the blocked engine ran it before the kernel: the
    penalty table, its int64 gather, the masked add and top_k, all queries
    at once."""
    pen = torch.where(probed.T, 0.0, _BIG).float()
    pen = torch.cat([pen, pen.new_full((1, pen.shape[1]), _BIG)], dim=0)
    tbx = torch.where(tb >= 0, tb, pen.shape[0] - 1).long()
    return top_k(-(gmin + pen[tbx]).T, kg)


def block(sel_rows, case, seed=0, U=4, qb=16, n_bkt=12):
    """One block as K1 and the engine hand it over: minima (U·SG, qb) with
    the padding slots (u ≥ live) at exactly 3e38 and their buckets −1."""
    rng = np.random.default_rng(seed)
    SG = S_TILES * 128 // sel_rows
    n_g = U * SG
    live = U if case != "short_live" else U - 1
    gmin = (rng.normal(size=(n_g, qb)) * 100).astype(np.float32)
    if case == "ties":
        gmin = np.round(gmin / 40).astype(np.float32) * 40  # many equal minima
    if case == "negzero":  # ±0 minima lead: the rest are positive
        gmin = np.abs(gmin) + np.float32(1.0)
        z = rng.random(gmin.shape) < 0.4
        gmin[z] = np.where(rng.random(int(z.sum())) < 0.5, np.float32(-0.0), np.float32(0.0))
    tb = rng.integers(0, n_bkt, size=n_g).astype(np.int32)
    tb[rng.random(n_g) < 0.1] = -1  # all-pad groups
    probed = rng.random((qb, n_bkt)) < 0.3
    if case == "all_masked":
        probed[::2] = False  # pad rows of a batch probe nothing
    if case == "few_finite":
        probed[:] = False
        probed[:, 0] = True  # ~1/n_bkt of the groups finite
    gmin[live * SG :] = np.float32(_BIG)
    tb[live * SG :] = -1
    return (torch.from_numpy(gmin), torch.from_numpy(tb), torch.from_numpy(probed),
            torch.tensor([live], dtype=torch.int32), SG)


CASES = ("plain", "ties", "negzero", "all_masked", "few_finite", "short_live")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kg", [1, 42, 52, 256])
@pytest.mark.parametrize("sel_rows", [1, 8, 32, 64, 128])
def test_plain_version_matches_the_inline_chain(sel_rows, kg, case):
    gmin, tb, probed, live, SG = block(sel_rows, case, seed=sel_rows + kg)
    kk = min(kg, gmin.shape[0])
    v_c, i_c = _inline_chain(gmin, probed, tb, kk)
    v_r, i_r = masked_group_topk_ref(gmin, tb, probed, live, kk, unit=SG)
    v_w, i_w = masked_group_topk(gmin, tb, probed, live, kk, unit=SG)  # CPU: the plain one
    for v, i in ((v_r, i_r), (v_w, i_w)):
        np.testing.assert_array_equal(v.numpy().view(np.int32), v_c.numpy().view(np.int32))
        np.testing.assert_array_equal(i.numpy(), i_c.numpy())
    if case == "negzero":  # the masked add turns −0 minima into +0, negated to −0
        assert (v_r.numpy().view(np.int32) == np.float32(-0.0).view(np.int32)).any()


@pytest.mark.parametrize("sel_rows", [8, 128])
def test_padding_slots_rank_last_in_order(sel_rows):
    """Where a query has fewer live groups than kg, its tail is the padding
    slots at −inf, lowest position first: the kernel writes (−inf, j) at
    output position j ≥ n_live without reading them."""
    gmin, tb, probed, live, SG = block(sel_rows, "short_live", U=2)
    n_live = int(live) * SG
    kg = gmin.shape[0]
    v, i = masked_group_topk_ref(gmin, tb, probed, live, kg, unit=SG)
    assert torch.isinf(v[:, n_live:]).all() and (v[:, n_live:] < 0).all()
    assert torch.isfinite(v[:, :n_live]).all()
    np.testing.assert_array_equal(i[:, n_live:].numpy(),
                                  np.broadcast_to(np.arange(n_live, kg), (v.shape[0], kg - n_live)))


@pytest.mark.parametrize("bad", ["tb_int64", "kg_zero", "kg_past_groups", "live_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    gmin, tb, probed, live, SG = block(32, "plain")
    kg = 4
    if bad == "tb_int64":
        tb = tb.long()
    elif bad == "kg_zero":
        kg = 0
    elif bad == "kg_past_groups":
        kg = gmin.shape[0] + 1
    else:
        live = live.repeat(2)
    with pytest.raises(ValueError):
        masked_group_topk(gmin, tb, probed, live, kg, unit=SG)


def _engine_kgs():
    """kg = max(fetch_k, capacity's kk) + the default margin, for every
    screen dtype, selection group size, k and n_mul the engine takes."""
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for sel_rows in (1, 2, 4, 8, 16, 32, 64, 128):
            for k in (10, 100):
                for n_mul in (1, 2):
                    for store_f32 in (True, False):
                        fetch_k = k * n_mul
                        slack = 32 if dtype == torch.int8 else 16
                        kk = k if store_f32 else fetch_k + slack
                        yield max(fetch_k, kk) + _resolve_margin(None, dtype, sel_rows)


@pytest.mark.parametrize("n_bkt", [1024, 2048, 4096])
def test_every_engine_kg_fits_one_pass(n_bkt):
    """Every kg the engine asks for at its default margins is one pass of
    the kernel; the 1M and 10M cells' (42, 52) keep 32 queries a CTA.  Only
    the margin calibration's exhaustive reference (kg = every group of the
    union) runs in passes."""
    kgs = sorted(set(_engine_kgs()))
    assert max(kgs) == 200 + 32 + 8 * 128  # capacity int8, k 100, n_mul 2, sel_rows 1
    for kg in kgs:
        plan = select_plan(n_bkt, 1024, kg)
        assert plan["passes"] == 1 and plan["kk"] == kg, (kg, plan)
        assert plan["chunks"] * plan["warps"] <= 64
    for kg in (42, 52):
        plan = select_plan(n_bkt, 1024, kg)
        assert plan["qt"] == 32 and plan["warps"] >= 4 and plan["chunks"] == 132 // 32, plan
    plan = select_plan(n_bkt, 256, 524288)
    assert plan["qt"] == 8 and plan["passes"] == -(-524288 // plan["kk"]) > 1


def test_select_pairs_counts_the_live_groups(monkeypatch):
    """`select.pairs` adds qb × ulen·SG a block: the (query, group) minima
    the selection reads, K1's `screen.pairs` over sel_rows."""
    from lira_tpu_torch.engine import block_scan

    counted = {}
    monkeypatch.setattr(block_scan, "count",
                        lambda name, n: counted.__setitem__(name, counted.get(name, 0) + n))
    monkeypatch.setattr(block_scan, "_scan_all", lambda *a, **kw: (torch.zeros(1), torch.zeros(1)))
    monkeypatch.setattr(block_scan, "_to_host_async", lambda t: t)

    class Engine:
        tile_start = np.array([0, 8, 24])  # tiles per bucket 8, 16, 4
        tiles_per_bucket = np.array([8, 16, 4])
        metric = "L2"

    class State:
        device = torch.device("cpu")
        tile_bucket = np.repeat([0, 1, 2, -1], [8, 16, 4, 4]).astype(np.int32)
        corpus_flat = bsq = corpus_flat_f32 = tiles_ids = tile_pad_count = None
        dim_scale = screen_sq = None

    union = np.array([[True, False, False], [True, True, True]])
    h = dict(q=torch.zeros(16, 4), probed=None, perm=None, qb=8)
    sel_rows = 32
    block_scan._dispatch_scan(State(), Engine(), h, union, 10, 10, 42, sel_rows, "f32")
    ulen = np.array([1, 4])  # supertiles of 8 tiles: bucket 0; buckets 0-2 (28 tiles)
    sg = S_TILES * 128 // sel_rows
    assert counted["select.pairs"] == 8 * int(ulen.sum()) * sg
    assert counted["screen.pairs"] == counted["select.pairs"] * sel_rows
