"""Top-k with `jax.lax.top_k`'s tie rule (port helper for lira_tpu's
`lax.top_k` call sites).

`lax.top_k` returns the k largest values in descending order and, among
equal values, the LOWER index first.  `torch.topk` promises no order among
ties on CUDA, and on the blocked path the winning index matters (which
bucket is probed at the `probe_cap` cut, which selection group is rescored
at the kg cut).  Instead of a full stable sort of every row, each value is
packed with its index into one int64 key, (order-preserving f32 bits) << 32
| (n − 1 − index), so no two keys are equal; `torch.topk` over the keys
then has no ties to break, and its order is exactly the stable-descending
order a `torch.sort(..., descending=True, stable=True)` would give.  The
two orders differ only between −0.0 and +0.0, which the key ranks as
−0.0 < +0.0.

`grouped_topk` is the twin of lira_tpu's exact two-stage smallest-k over
wide rows: per-group minima over strided groups, the k + 2 groups with the
smallest minima (they hold every top-k element), then a small exact top-k
over those groups' members.
"""

from __future__ import annotations

import torch


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort like the f32 values of `x` (monotone bit map)."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64)
    # negative floats: flip the magnitude bits so larger magnitude sorts lower
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last dim,
    descending, lower index first among equal values.  f32 in, int64
    indices out."""
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"top_k: k={k} outside [0, {n}]")
    tie = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    key = (_ordered_bits(x) << 32) | tie
    kv, _ = torch.topk(key, k, dim=-1, largest=True, sorted=True)
    idx = (n - 1) - (kv & 0xFFFFFFFF)
    return torch.gather(x, -1, idx), idx


def grouped_topk(scores: torch.Tensor, k: int, group: int = 128):
    """Exact smallest-k of each row: (values ascending, indices int64).

    scores: (Q, C) f32, smaller = better; k ≤ C.  C is padded with +inf to
    a group multiple.  Groups are strided, as in lira_tpu: group g holds
    elements {g, g+G, g+2G, …} of the (Q, group, G) view.  Any group holding
    a true top-k element has a minimum ≤ the k-th smallest value and at
    most k groups can, so the k + 2 groups with the smallest minima hold
    the answer.  Narrow rows (C ≤ max(2·group, 2k)) take one top-k.  The
    indices equal lira_tpu's up to exactly equal scores."""
    q, c = scores.shape
    if c <= max(2 * group, k * 2):
        neg, idx = top_k(-scores, min(k, c))
        return -neg, idx
    pad = (-c) % group
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("inf"))
    g = scores.shape[1] // group  # number of groups
    grouped = scores.reshape(q, group, g)  # element (i, j): index i*g + j
    gmin = grouped.amin(dim=1)  # (Q, G)
    k_groups = min(g, k + 2)
    _, gsel = top_k(-gmin, k_groups)  # (Q, k_groups) groups holding the top-k
    sub = torch.gather(grouped, 2, gsel[:, None, :].expand(q, group, k_groups))
    neg, sel = top_k(-sub.reshape(q, group * k_groups), k)
    # sub element (i, j) = grouped[:, i, gsel[j]] = original index i*g + gsel[j]
    base = torch.arange(group, device=scores.device)[None, :, None] * g + gsel[:, None, :]
    return -neg, torch.gather(base.reshape(q, -1), 1, sel)
