"""K3 tile-major: the port's `pallas_probed_scan` on CPU tensors runs the
same list inversion, candidate layout and merge as on the card, with the
plain versions of the scan and merge kernels.  Held against lira_tpu's
`pallas_probed_scan` (the Pallas kernel in interpret mode) and against the
port's plain `probed_scan_ref`, on numpy inputs from a seed.

For k = 128 the reference is lira_tpu's XLA per-query scan
(`engine/serve.py::_scan_probed_tiles`, its engine's route for any k)
instead of the interpreted kernel: the kernel's 128-deep stack takes ~40 s
to compile for each metric in interpret mode.

Tolerance: scores within 2·d·eps32·(max‖x‖² + 2·max‖x‖·max‖q‖) (the same
exact products summed in another f32 order); id sets equal, except among
candidates whose scores lie within that tolerance of the row's k-th score
(ties).  Missing slots (3e38, −1) must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lira_tpu.engine.pallas_scan import pallas_probed_scan as j_probed_scan
from lira_tpu.engine.serve import _scan_probed_tiles as j_xla_scan
from lira_tpu_torch.engine import pallas_scan as tps

EPS32 = float(np.finfo(np.float32).eps)
N_TILES, B, T, D = 9, 40, 6, 37


def _inputs(seed=0):
    """d = 37; the last tile partly padded; −1 holes mid-list; a tile listed
    twice; a query with no tile; tile 4 in every list but that query's (39
    entries: three work items of 16)."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(N_TILES, 128, D)).astype(np.float32)
    ids = np.arange(N_TILES * 128, dtype=np.int32).reshape(N_TILES, 128)
    ids[-1, 100:] = -1
    norms = (corpus.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    tiles = rng.integers(0, N_TILES, size=(B, T)).astype(np.int32)
    tiles[rng.random((B, T)) < 0.3] = -1
    tiles[:, 2] = -1  # a hole between live slots in every list
    tiles[1, :2] = 5  # a tile listed twice
    tiles[:, 3] = 4  # one tile probed by every query ...
    tiles[0] = -1  # ... but this one, which has no tile
    return q, tiles, corpus, ids, norms


def _pallas_sq(norms, ids, metric):
    sq = np.zeros_like(norms) if metric == "inner_product" else norms.copy()
    sq[ids < 0] = 3e38
    return sq


def _tolerance(q, corpus):
    xn = float((corpus.astype(np.float64) ** 2).sum(-1).max())
    qn = float((q.astype(np.float64) ** 2).sum(-1).max())
    return 2 * D * EPS32 * (xn + 2 * (xn * qn) ** 0.5)


def _assert_same_topk(s_a, i_a, s_b, i_b, tol, tag):
    s_a, i_a, s_b, i_b = (np.asarray(a) for a in (s_a, i_a, s_b, i_b))
    miss_a, miss_b = s_a >= 1e37, s_b >= 1e37
    np.testing.assert_array_equal(miss_a, miss_b, err_msg=str(tag))
    assert (i_a[miss_a] == -1).all() and (i_b[miss_b] == -1).all(), tag
    live = ~miss_a
    assert np.abs(s_a[live] - s_b[live]).max(initial=0.0) <= tol, tag
    for r in range(len(s_a)):
        if not live[r].any():
            continue
        kth = s_a[r][live[r]].max()
        for s_x, i_x, i_y in ((s_a, i_a, i_b), (s_b, i_b, i_a)):
            inside = live[r] & (s_x[r] < kth - tol)
            assert set(i_x[r][inside]) <= set(i_y[r]), (tag, r)


@pytest.mark.parametrize("k", [1, 20, 36, 128])
@pytest.mark.parametrize("metric", ["L2", "inner_product"])
def test_tile_major_cpu_route_matches_lira_tpu(metric, k):
    q, tiles, corpus, ids, norms = _inputs()
    sq = _pallas_sq(norms, ids, metric)
    args = [torch.from_numpy(a) for a in (q, tiles, corpus, ids, sq)]
    s_t, i_t = tps.pallas_probed_scan(*args, k, metric)
    assert s_t.shape == (B, k) and i_t.shape == (B, k)
    assert (s_t[0] >= 1e37).all() and (i_t[0] == -1).all()  # the query with no tile
    tol = _tolerance(q, corpus)
    s_r, i_r = tps.probed_scan_ref(*args, k, metric)
    _assert_same_topk(s_r, i_r, s_t, i_t, tol, ("plain", metric, k))
    if k < 128:
        s_j, i_j = j_probed_scan(jnp.asarray(q), jnp.asarray(tiles), jnp.asarray(corpus),
                                 jnp.asarray(ids), jnp.asarray(sq), k=k, metric=metric,
                                 interpret=True)
    else:
        xla_sq = np.where(ids >= 0, norms, np.inf).astype(np.float32)
        s_j, i_j = j_xla_scan(jnp.asarray(q), jnp.asarray(tiles), jnp.asarray(corpus),
                              jnp.asarray(ids), jnp.asarray(xla_sq), k, metric)
        # a missing candidate comes out there as +inf with any id
        s_j, i_j = np.asarray(s_j), np.asarray(i_j)
        s_j, i_j = np.where(np.isfinite(s_j), s_j, 3e38), np.where(np.isfinite(s_j), i_j, -1)
    _assert_same_topk(s_j, i_j, s_t, i_t, tol, ("lira_tpu", metric, k))


@pytest.mark.parametrize("case", ["mixed", "one_tile_per_list", "one_tile_everywhere",
                                  "hole_every_other_slot", "tiles_in_reverse", "no_tile"])
def test_inversion_holds_every_live_entry_once(case):
    """Every live (query, slot) entry in exactly one item, with its own
    tile; the items of a tile consecutive, tiles ascending, all full but
    each tile's last; items past the last empty with tile −1."""
    q, tiles, corpus, ids, norms = _inputs(1)
    if case == "one_tile_per_list":  # 40 entries of tile 2 and nothing else
        tiles[:] = -1
        tiles[:, 4] = 2
    elif case == "one_tile_everywhere":  # 240 entries: 15 full items
        tiles[:] = 7
    elif case == "hole_every_other_slot":
        tiles[:, ::2] = -1
    elif case == "tiles_in_reverse":
        tiles = np.where(tiles >= 0, N_TILES - 1 - tiles, -1).astype(np.int32)
    elif case == "no_tile":
        tiles[:] = -1
    chunk = tps.QCHUNK
    item_tile, item_pair = tps.invert_tile_lists_ref(torch.from_numpy(tiles), N_TILES)
    item_tile, item_pair = item_tile.numpy(), item_pair.numpy()
    W = tps._item_bound(B * T, N_TILES)
    assert item_tile.shape == (W,) and item_pair.shape == (W, chunk)
    flat = tiles.reshape(-1)
    used = item_pair >= 0
    entries = item_pair[used]
    np.testing.assert_array_equal(np.sort(entries), np.flatnonzero(flat >= 0))
    np.testing.assert_array_equal(flat[entries], np.repeat(item_tile, used.sum(1)))
    n_items = int((item_tile >= 0).sum())
    assert (item_tile[n_items:] == -1).all() and not used[n_items:].any()
    assert (np.diff(item_tile[:n_items]) >= 0).all()
    counts = np.bincount(flat[flat >= 0], minlength=N_TILES)
    for t in range(N_TILES):
        sizes = used[:n_items][item_tile[:n_items] == t].sum(1)
        want = [chunk] * (counts[t] // chunk) + ([counts[t] % chunk] if counts[t] % chunk else [])
        assert list(sizes) == want, (t, sizes)
        # a used entry is never behind an unused one
        assert all(used[w, :s].all() for w, s in zip(np.flatnonzero(item_tile == t), sizes))
    # the CPU wrapper is the plain version
    got = tps.invert_tile_lists(torch.from_numpy(tiles), N_TILES)
    want = tps.invert_tile_lists_ref(torch.from_numpy(tiles), N_TILES)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_merge_plain_version_ignores_holes():
    """The candidate rows of holes are never read: garbage there changes
    nothing."""
    q, tiles, corpus, ids, norms = _inputs(2)
    sq = _pallas_sq(norms, ids, "L2")
    t = torch.from_numpy(tiles)
    item_tile, item_pair = tps.invert_tile_lists(t, N_TILES)
    out_v = torch.full((B * T, 20), -5.0)
    out_i = torch.full((B * T, 20), 7, dtype=torch.int32)
    tps.pair_topk_ref(torch.from_numpy(q), item_tile, item_pair, torch.from_numpy(corpus),
                      torch.from_numpy(ids), torch.from_numpy(sq), out_v, out_i, T)
    s_m, i_m = tps.merge_topk(out_v, out_i, t, 20)
    s_r, i_r = tps.probed_scan_ref(*(torch.from_numpy(a) for a in (q, tiles, corpus, ids, sq)),
                                   20)
    _assert_same_topk(s_r, i_r, s_m, i_m, _tolerance(q, corpus), "merge")
