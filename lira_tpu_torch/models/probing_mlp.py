"""The probing MLP ("meta index") as an nn.Module (port of
lira_tpu/models/probing_mlp.py).

Architecture: a distance branch (n_bkt→128→64, ReLU), a vector branch
(dim→128→64, ReLU), and a joint head (128→128→n_bkt, ReLU then sigmoid)
producing per-partition probing probabilities.  Layer names follow
lira_tpu's parameter tree (dist1, dist2, vec1, vec2, head1, head2), so
`params_from_jax` / `params_to_jax` carry weights across.  lira_tpu stores
each weight as (fan_in, fan_out); nn.Linear stores (out, in).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import true_fp32

_LAYERS = ("dist1", "dist2", "vec1", "vec2", "head1", "head2")


class ProbingMLP(nn.Module):
    def __init__(self, n_bkt: int, dim: int, hidden: int = 128, branch_out: int = 64,
                 generator: torch.Generator | None = None):
        """Initialised like torch.nn.Linear (and lira_tpu): uniform
        ±1/√fan_in for weight and bias, drawn from `generator`."""
        super().__init__()
        self.dist1 = nn.Linear(n_bkt, hidden)
        self.dist2 = nn.Linear(hidden, branch_out)
        self.vec1 = nn.Linear(dim, hidden)
        self.vec2 = nn.Linear(hidden, branch_out)
        self.head1 = nn.Linear(2 * branch_out, hidden)
        self.head2 = nn.Linear(hidden, n_bkt)
        with torch.no_grad():
            for name in _LAYERS:
                lin = getattr(self, name)
                bound = 1.0 / float(np.sqrt(lin.in_features))
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x_dist: torch.Tensor, x_vec: torch.Tensor) -> torch.Tensor:
        """(B, n_bkt) per-partition probing probabilities in (0, 1)."""
        return torch.sigmoid(self.forward_logits(x_dist, x_vec))

    @true_fp32()
    def forward_logits(self, x_dist: torch.Tensor, x_vec: torch.Tensor) -> torch.Tensor:
        d = torch.relu(self.dist1(x_dist))
        d = torch.relu(self.dist2(d))
        v = torch.relu(self.vec1(x_vec))
        v = torch.relu(self.vec2(v))
        h = torch.relu(self.head1(torch.cat([d, v], dim=-1)))
        return self.head2(h)


def params_from_jax(params) -> ProbingMLP:
    """ProbingMLP (on the CPU) from a lira_tpu parameter tree
    {layer: {"w": (fan_in, fan_out), "b": (fan_out,)}} of array-likes."""
    n_bkt, hidden = np.asarray(params["dist1"]["w"]).shape
    dim = np.asarray(params["vec1"]["w"]).shape[0]
    branch_out = np.asarray(params["dist2"]["w"]).shape[1]
    model = ProbingMLP(n_bkt, dim, hidden=hidden, branch_out=branch_out)
    with torch.no_grad():
        for name in _LAYERS:
            lin = getattr(model, name)
            lin.weight.copy_(torch.from_numpy(np.asarray(params[name]["w"], np.float32).T.copy()))
            lin.bias.copy_(torch.from_numpy(np.asarray(params[name]["b"], np.float32).copy()))
    return model


def params_to_jax(model: ProbingMLP) -> dict:
    """lira_tpu's parameter tree, as numpy arrays, from a ProbingMLP."""
    return {
        name: {
            "w": getattr(model, name).weight.detach().cpu().numpy().T.copy(),
            "b": getattr(model, name).bias.detach().cpu().numpy().copy(),
        }
        for name in _LAYERS
    }
