"""TorchScript export of the probing MLP for the reference's serving binary
(port of lira_tpu/io/torch_export.py).

The reference loads the probing model as a TorchScript module
`{prefix}_mlp_2_input.pt` (reference: index.py:180-184 writes it,
search.cpp:333-338 loads it with inputs (dist, vec)).  The module rebuilt
here has the reference's architecture and attribute names (distance_net,
vector_net, fc), so an index built by either package is servable by the
reference engine.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class MLP2Input(nn.Module):
    """Distance branch (n_bkt→hidden→branch_out, ReLU), vector branch
    (dim→hidden→branch_out, ReLU), head (2·branch_out→hidden→n_bkt, ReLU
    then sigmoid); forward(x_dist, x_vec) with features concatenated
    (dist, vec)."""

    def __init__(self, n_bkt: int, dim: int, hidden: int, branch_out: int, out_dim: int):
        super().__init__()
        self.distance_net = nn.Sequential(
            nn.Linear(n_bkt, hidden), nn.ReLU(), nn.Linear(hidden, branch_out), nn.ReLU(),
        )
        self.vector_net = nn.Sequential(
            nn.Linear(dim, hidden), nn.ReLU(), nn.Linear(hidden, branch_out), nn.ReLU(),
        )
        self.fc = nn.Sequential(
            nn.Linear(2 * branch_out, hidden), nn.ReLU(), nn.Linear(hidden, out_dim), nn.Sigmoid(),
        )

    def forward(self, x_dist, x_vec):
        combined = torch.cat((self.distance_net(x_dist), self.vector_net(x_vec)), dim=1)
        return self.fc(combined)


# (module attribute, index in its Sequential) of each lira_tpu layer
_SLOTS = {"dist1": ("distance_net", 0), "dist2": ("distance_net", 2),
          "vec1": ("vector_net", 0), "vec2": ("vector_net", 2),
          "head1": ("fc", 0), "head2": ("fc", 2)}


def export_torchscript_mlp(params, path: str) -> str:
    """Write `path` (.pt) from lira_tpu's parameter tree {layer: {"w":
    (fan_in, fan_out), "b": (fan_out,)}} of array-likes, or from a
    ProbingMLP."""
    from ..models.probing_mlp import ProbingMLP, params_to_jax

    if isinstance(params, ProbingMLP):
        params = params_to_jax(params)
    n_bkt, hidden = np.asarray(params["dist1"]["w"]).shape
    model = MLP2Input(n_bkt, np.asarray(params["vec1"]["w"]).shape[0], hidden,
                      np.asarray(params["dist2"]["w"]).shape[1],
                      np.asarray(params["head2"]["w"]).shape[1])
    with torch.no_grad():
        for layer, (seq, i) in _SLOTS.items():
            lin = getattr(model, seq)[i]
            lin.weight.copy_(torch.from_numpy(np.asarray(params[layer]["w"], np.float32).T.copy()))
            lin.bias.copy_(torch.from_numpy(np.asarray(params[layer]["b"], np.float32).copy()))
    model.eval()
    torch.jit.script(model).save(path)
    return path
