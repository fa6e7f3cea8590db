"""Index artifact contract: build once, serve many (port of
lira_tpu/io/artifacts.py).  The files, their dtypes and the manifest keys
are lira_tpu's, so either package serves the other's index:

    {prefix}_centroids.npy        (n_bkt, dim) float32
    {prefix}_data_2_bkt.npy       (n, n_mul) int32, −1 = empty slot
    {prefix}_x_d.npy              (n, dim) float32
    {prefix}_redundant_flags.npy  (n,) uint8
    {prefix}_scaler_mean.npy      (n_bkt,) float32   (StandardScaler.save)
    {prefix}_scaler_scale.npy     (n_bkt,) float32
    {prefix}_model.npz            probing-MLP parameters, keys layer/name in
                                  lira_tpu's (fan_in, fan_out) layout
    {prefix}_mlp_2_input.pt       the same MLP as TorchScript, for the
                                  reference's serving binary (torch_export)
    {prefix}_manifest.json        format_version, metric, n, dim, n_bkt,
                                  n_mul, plus build_index's extra keys
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..labels.scaler import StandardScaler
from ..models.probing_mlp import ProbingMLP, params_from_jax, params_to_jax
from .torch_export import export_torchscript_mlp


def _tree(params) -> dict:
    """lira_tpu's parameter tree (numpy) from a ProbingMLP or a tree."""
    if isinstance(params, ProbingMLP):
        return params_to_jax(params)
    return {layer: {name: np.asarray(v) for name, v in sub.items()}
            for layer, sub in params.items()}


def save_params(params, path: str) -> None:
    """The MLP's parameters as an .npz of `layer/name` arrays in lira_tpu's
    (fan_in, fan_out) layout; `params` is a ProbingMLP or lira_tpu's tree."""
    flat = {f"{layer}/{name}": v for layer, sub in _tree(params).items()
            for name, v in sub.items()}
    np.savez(path, **flat)


def load_params(path: str) -> ProbingMLP:
    """A ProbingMLP (on the CPU) from an .npz written by either package."""
    with np.load(path) as flat:
        tree: dict = {}
        for key in flat.files:
            layer, name = key.split("/")
            tree.setdefault(layer, {})[name] = flat[key]
    return params_from_jax(tree)


def save_index_artifacts(
    out_dir: str,
    prefix: str,
    *,
    centroids: np.ndarray,
    data_2_bkt: np.ndarray,
    x_d: np.ndarray,
    scaler: StandardScaler,
    params,
    metric: str = "L2",
    extra_meta: dict | None = None,
) -> str:
    """Write the contract above; returns the path prefix."""
    os.makedirs(out_dir, exist_ok=True)
    p = os.path.join(out_dir, prefix)
    d2b = np.asarray(data_2_bkt)
    np.save(p + "_centroids.npy", np.asarray(centroids, dtype=np.float32))
    np.save(p + "_data_2_bkt.npy", d2b.astype(np.int32, copy=False))
    np.save(p + "_x_d.npy", np.asarray(x_d, dtype=np.float32))
    if d2b.ndim == 2 and d2b.shape[1] > 1:
        redundant = (d2b[:, 1:] != -1).any(axis=1).astype(np.uint8)
    else:
        redundant = np.zeros(len(d2b), np.uint8)
    np.save(p + "_redundant_flags.npy", redundant)
    scaler.save(out_dir, prefix)
    tree = _tree(params)
    save_params(tree, p + "_model.npz")
    export_torchscript_mlp(tree, p + "_mlp_2_input.pt")
    manifest = {
        "format_version": 1,
        "metric": metric,
        "n": int(x_d.shape[0]),
        "dim": int(x_d.shape[1]),
        "n_bkt": int(centroids.shape[0]),
        "n_mul": int(d2b.shape[1]) if d2b.ndim == 2 else 1,
    }
    manifest.update(extra_meta or {})
    with open(p + "_manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    return p


def load_index_artifacts(out_dir: str, prefix: str) -> dict:
    """The arrays, the scaler, the MLP ("params": a ProbingMLP on the CPU)
    and the manifest of an index written by either package."""
    p = os.path.join(out_dir, prefix)
    with open(p + "_manifest.json") as f:
        manifest = json.load(f)
    return {
        "centroids": np.load(p + "_centroids.npy"),
        "data_2_bkt": np.load(p + "_data_2_bkt.npy"),
        "x_d": np.load(p + "_x_d.npy"),
        "redundant_flags": np.load(p + "_redundant_flags.npy"),
        "scaler": StandardScaler.load(out_dir, prefix),
        "params": load_params(p + "_model.npz"),
        "manifest": manifest,
    }
