"""Training-state checkpoint and resume (port of
lira_tpu/models/checkpoint.py).

The probing MLP's whole TrainState (parameters and Adam moments) as one
flat .npz with lira_tpu's keys, so either package resumes the other's run:

    step                  the caller's step (the epochs done)
    params/<layer>/<name> lira_tpu's (fan_in, fan_out) layout
    opt/<i>               optax.adam's state leaves in optax's order:
                          ScaleByAdamState's count (int32), then mu and nu,
                          each over sorted layer and leaf names
                          (the chain's EmptyState has no leaves)

Writes are atomic (tmp + rename), and a path without ".npz" gets it on
save and on load.
"""

from __future__ import annotations

import os

import numpy as np

from .train import TrainState, train_state_from_jax, train_state_to_jax


def _tree_leaves(tree: dict) -> list:
    """Leaves of a {layer: {name: array}} tree in jax's order (sorted keys)."""
    return [tree[layer][name] for layer in sorted(tree) for name in sorted(tree[layer])]


def save_train_state(state: TrainState, path: str, step: int = 0) -> None:
    params, adam = train_state_to_jax(state)
    flat = {"step": np.array(step)}
    flat.update({f"params/{layer}/{name}": v for layer, sub in params.items()
                 for name, v in sub.items()})
    leaves = [adam["count"]] + _tree_leaves(adam["mu"]) + _tree_leaves(adam["nu"])
    flat.update({f"opt/{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)})
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_train_state(path: str, template: TrainState) -> tuple[TrainState, int]:
    """Restore into a state like `template` (same model shape; its Adam
    learning rate and device).  Returns (state, step)."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as flat:
        step = int(flat["step"])
        params: dict = {}
        for key in flat.files:
            if key.startswith("params/"):
                _, layer, name = key.split("/")
                params.setdefault(layer, {})[name] = flat[key]
        names = [(layer, name) for layer in sorted(params) for name in sorted(params[layer])]
        count = flat["opt/0"]
        mu, nu = {}, {}
        for i, (layer, name) in enumerate(names):
            mu.setdefault(layer, {})[name] = flat[f"opt/{1 + i}"]
            nu.setdefault(layer, {})[name] = flat[f"opt/{1 + len(names) + i}"]
    lr = template.opt.param_groups[0]["lr"]
    state = train_state_from_jax(params, {"count": count, "mu": mu, "nu": nu}, lr=lr,
                                 device=template.device)
    return state, step
