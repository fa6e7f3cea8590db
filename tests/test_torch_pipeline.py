"""run_smallscale: lira_tpu_torch (device="cpu") against lira_tpu on the
same bundle, the port's training started from lira_tpu's initial
parameters and Adam state (`train_state_from_jax`; jax.random and torch's
generator never agree).

Tolerances: epoch-table rows allclose at atol 2e-4 (the table rounds to 4
decimals, and f32 sums in another order may move a value across a
rounding edge); `data_2_bkt`, the analytic sweep rows and the serving
sweep's recall / nprobe / ndis exact; the CSV files byte-equal apart from
the measured QPS column.
"""

import os

import numpy as np
import pytest

from lira_tpu.config import Config as JConfig
from lira_tpu.models import train as jtrain
from lira_tpu.pipelines.smallscale import run_smallscale as j_run
from lira_tpu_torch.config import Config as TConfig
from lira_tpu_torch.models import train as ttrain
from lira_tpu_torch.pipelines import smallscale as tsmall

# σ = 0.3: after two epochs at the default learning rate, redundancy
# already replicates ~10% of the corpus
KW = dict(dataset="tiny", k=5, n_bkt=8, n_epoch=2, batch_size=64, n_mul=2,
          redundancy_ratio=0.1, duplicate_type="model", t_step=0.2, sigma=0.3)


def _cfg(cls, logdir):
    cfg = cls(data_path=logdir, **KW).update()
    cfg.pth_log = logdir + "/"
    return cfg


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory):
    j_dir = str(tmp_path_factory.mktemp("jax"))
    t_dir = str(tmp_path_factory.mktemp("torch"))
    j_res = j_run(_cfg(JConfig, j_dir), bundle=tiny_dataset, serve_sweep=True, use_cache=False)
    init = jtrain.make_train_state(KW.get("seed", 43), KW["n_bkt"], tiny_dataset.base.shape[1])
    params = {k: {kk: np.asarray(v) for kk, v in d.items()} for k, d in init.params.items()}

    def from_lira(seed, n_bkt, dim, lr=1e-4, device=None):
        return ttrain.train_state_from_jax(params, init.opt_state, lr=lr, device=device)

    mp = pytest.MonkeyPatch()
    mp.setattr(tsmall, "make_train_state", from_lira)
    try:
        t_res = tsmall.run_smallscale(_cfg(TConfig, t_dir), bundle=tiny_dataset,
                                      serve_sweep=True, use_cache=False, device="cpu")
    finally:
        mp.undo()
    return j_res, t_res, j_dir, t_dir


def test_epoch_rows_match(runs):
    j_res, t_res, _, _ = runs
    assert len(t_res["epoch_rows"]) == KW["n_epoch"] + 1
    for a, b in zip(t_res["epoch_rows"], j_res["epoch_rows"]):
        assert a.keys() == b.keys() and a["Epoch"] == b["Epoch"]
        np.testing.assert_allclose([a[h] for h in a if h != "Epoch"],
                                   [b[h] for h in b if h != "Epoch"], atol=2e-4)


def test_layout_and_sweeps_match(runs):
    j_res, t_res, _, _ = runs
    np.testing.assert_array_equal(t_res["data_2_bkt"], j_res["data_2_bkt"])
    assert (t_res["data_2_bkt"][:, 1] >= 0).any()  # redundancy replicated some points
    assert len(t_res["sweep_parts"]) == 2
    for pt, pj in zip(t_res["sweep_parts"], j_res["sweep_parts"]):
        strip = lambda rows: [(r.threshold, r.nprobe, r.recall, r.computations) for r in rows]
        assert strip(pt) == strip(pj)
    keys = ("threshold", "avg_recall", "avg_nprobe", "avg_cmp")
    assert ([[r[k] for k in keys] for r in t_res["serve_rows"]]
            == [[r[k] for k in keys] for r in j_res["serve_rows"]])


def test_csv_files_match_apart_from_qps(runs):
    _, _, j_dir, t_dir = runs
    found = 0
    for root, _, files in os.walk(j_dir):
        for name in files:
            if not name.endswith(".csv"):
                continue
            rel = os.path.relpath(os.path.join(root, name), j_dir)
            with open(os.path.join(j_dir, rel)) as f:
                want = f.read().splitlines()
            with open(os.path.join(t_dir, rel)) as f:
                got = f.read().splitlines()
            if want[0].endswith(",QPS"):  # sweep schema: drop the measured column
                want = [ln.rsplit(",", 1)[0] for ln in want]
                got = [ln.rsplit(",", 1)[0] for ln in got]
            assert got == want, rel
            found += 1
    assert found == 3  # the epoch table and both sweep parts
