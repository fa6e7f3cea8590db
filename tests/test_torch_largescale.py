"""The port's large-scale pipeline on the CPU: checkpoint/resume within the
port (a run killed mid-training or mid-redundancy resumes to the
uninterrupted run's final state without redoing finished work, as
tests/test_largescale_resume.py holds lira_tpu), and the full-corpus
redundancy against lira_tpu's on lira_tpu's own trained index.

Held exactly: parameters, data_2_bkt and sweep rows after a resume; the
redundancy assignment given lira_tpu's parameters (carried across with
params_from_jax; the rule reads the MLP's outputs only through a top-n
order and `> sigma`, and no output of this index lies within f32
rounding of a tie or of sigma).
"""

import numpy as np
import pytest

from lira_tpu.config import Config as JConfig
from lira_tpu.io import artifacts as jart
from lira_tpu.io.datasets import synthetic_dataset
from lira_tpu.pipelines import largescale as jls
from lira_tpu_torch.config import Config as TConfig
from lira_tpu_torch.io import artifacts as tart
from lira_tpu_torch.models.probing_mlp import params_from_jax, params_to_jax
from lira_tpu_torch.pipelines import largescale
from test_torch_artifacts import lira_built_index


def _cfg(logdir, n_epoch=4, resume=False):
    cfg = TConfig(
        dataset="synthetic", k=5, n_bkt=10, n_epoch=n_epoch, batch_size=64,
        subset_fraction=0.25, redundancy_batch=1500, data_path=str(logdir),
        checkpoint=True, resume=resume,
    ).update()
    cfg.pth_log = str(logdir) + "/"
    return cfg


@pytest.fixture(scope="module")
def bundle():
    return synthetic_dataset(n_base=4000, n_query=30, dim=12, n_clusters=10, k_gt=20, seed=43)


@pytest.fixture(scope="module")
def reference(bundle, tmp_path_factory):
    """An uninterrupted port run."""
    return largescale.run_largescale(_cfg(tmp_path_factory.mktemp("ref")), bundle=bundle,
                                     use_cache=False, device="cpu")


def _assert_same_run(ref, res):
    pa, pb = params_to_jax(ref["state"].model), params_to_jax(res["state"].model)
    for layer in pa:
        for leaf in pa[layer]:
            np.testing.assert_array_equal(pa[layer][leaf], pb[layer][leaf])
    np.testing.assert_array_equal(ref["data_2_bkt"], res["data_2_bkt"])
    for part in range(2):
        assert ref["sweep_parts"][part] == res["sweep_parts"][part]


def _dying(real, n_ok, msg):
    calls = {"n": 0}

    def f(*args, **kwargs):
        if calls["n"] == n_ok:
            raise RuntimeError(msg)
        calls["n"] += 1
        return real(*args, **kwargs)

    return f


def _counting(real, calls):
    def f(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    return f


def test_resume_after_training_kill_matches_uninterrupted(bundle, reference, tmp_path,
                                                          monkeypatch):
    real = largescale.train_epoch
    monkeypatch.setattr(largescale, "train_epoch", _dying(real, 2, "killed mid-training"))
    with pytest.raises(RuntimeError, match="killed mid-training"):
        largescale.run_largescale(_cfg(tmp_path), bundle=bundle, use_cache=False,
                                  device="cpu")
    calls = {"n": 0}
    monkeypatch.setattr(largescale, "train_epoch", _counting(real, calls))
    res = largescale.run_largescale(_cfg(tmp_path, resume=True), bundle=bundle,
                                    use_cache=False, device="cpu")
    assert calls["n"] == 2, "resume must not retrain completed epochs"
    _assert_same_run(reference, res)


def test_resume_mid_redundancy_skips_completed_batches(bundle, reference, tmp_path,
                                                       monkeypatch):
    real = largescale._fused_redundancy_batch
    # 4000 rows / 1500 = 3 batches: die after the first
    monkeypatch.setattr(largescale, "_fused_redundancy_batch",
                        _dying(real, 1, "killed mid-redundancy"))
    with pytest.raises(RuntimeError, match="killed mid-redundancy"):
        largescale.run_largescale(_cfg(tmp_path), bundle=bundle, use_cache=False,
                                  device="cpu")
    calls = {"n": 0}
    monkeypatch.setattr(largescale, "_fused_redundancy_batch", _counting(real, calls))
    res = largescale.run_largescale(_cfg(tmp_path, resume=True), bundle=bundle,
                                    use_cache=False, device="cpu")
    assert calls["n"] == 2, "resume must skip the completed redundancy batch"
    _assert_same_run(reference, res)


def test_fresh_run_clears_stale_checkpoints(bundle, tmp_path):
    cfg = _cfg(tmp_path, n_epoch=1)
    largescale.run_largescale(cfg, bundle=bundle, use_cache=False, device="cpu")
    ckpt = largescale.PipelineCheckpoint(cfg.pth_log + cfg.file_name + "_ckpt")
    assert ckpt.has("train_state.npz") and ckpt.has("d2b_final.npz")
    ckpt.save("stale_marker.npz", x=np.zeros(1))
    largescale.run_largescale(cfg, bundle=bundle, use_cache=False, device="cpu")
    assert not ckpt.has("stale_marker.npz") and ckpt.has("d2b_final.npz")


def test_full_corpus_redundancy_matches_lira_tpu(tmp_path_factory, monkeypatch):
    """lira_tpu's trained index and parameters: the port's full-corpus
    redundancy (params_from_jax) assigns every row as lira_tpu's does, in
    3 batches, and resumes from lira_tpu's batch files."""
    ix = lira_built_index(tmp_path_factory)
    art = jart.load_index_artifacts(ix["dir"], ix["prefix"])
    d2b = np.full((len(art["x_d"]), 2), -1, np.int32)
    d2b[:, 0] = art["data_2_bkt"][:, 0]
    # sigma 0.3: this lightly trained MLP puts a second bucket above it for
    # part of the rows (at 0.5 none)
    kw = dict(k=5, n_bkt=8, n_mul=2, sigma=0.3, redundancy_batch=700)
    want = jls.full_corpus_redundancy(art["x_d"], d2b, art["centroids"], art["scaler"],
                                      art["params"], JConfig(**kw))
    model = params_from_jax(art["params"])
    got = largescale.full_corpus_redundancy(art["x_d"], d2b, art["centroids"], art["scaler"],
                                            model, TConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1] >= 0).any() and (got[:, 0] >= 0).all()
    # the same parameters read back from lira_tpu's artifact file
    again = largescale.full_corpus_redundancy(
        art["x_d"], d2b, art["centroids"], art["scaler"],
        tart.load_index_artifacts(ix["dir"], ix["prefix"])["params"], TConfig(**kw),
        device="cpu")
    np.testing.assert_array_equal(again, want)

    # a checkpoint directory written by lira_tpu after its first batch:
    # the port resumes at the second
    root = str(tmp_path_factory.mktemp("red_ckpt"))
    jck = jls.PipelineCheckpoint(root)
    jck.save("redundancy_rows_0.npz", rows=want[:700])
    jck.save("redundancy_cursor.npz", cursor=np.int64(700), batch_rows=np.int64(700))
    calls = {"n": 0}
    monkeypatch.setattr(largescale, "_fused_redundancy_batch",
                        _counting(largescale._fused_redundancy_batch, calls))
    resumed = largescale.full_corpus_redundancy(
        art["x_d"], d2b, art["centroids"], art["scaler"], model, TConfig(**kw),
        ckpt=largescale.PipelineCheckpoint(root), device="cpu")
    assert calls["n"] == 2
    np.testing.assert_array_equal(resumed, want)
