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
