"""Data-parallel probing-MLP training over the ranks (port of
lira_tpu/parallel/train_dp.py).

Every rank holds the same model and Adam state and walks the same global
batches; each takes its contiguous slice of every batch (the zero-padded
tail included), computes its masked loss over the GLOBAL count of real
rows, and the gradients (and loss) are summed over the ranks in one
all-reduce — so the sum is exactly the global-mean gradient — before each
rank takes the same Adam step (models/train.py's optimizer).  The summation
order differs from lira_tpu's psum tree, so parameters and losses agree to
float accumulation error (allclose).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import true_fp32
from ..models.train import TrainState, _rows_f32
from .mesh import Mesh


def make_dp_train_step(state: TrainState, mesh: Mesh):
    """The DP step on `state` (updated in place):
    step(dist, vec, targets, mask, denom) -> the global batch's loss, where
    dist/vec/targets/mask are THIS rank's slice of the global batch (f32
    tensors on its device) and denom the global batch's count of real
    rows.  `mask` zeroes padding rows out of the loss."""
    model, opt = state.model, state.opt
    params = list(model.parameters())

    def step(dist, vec, targets, mask, denom: float) -> float:
        with true_fp32():
            logits = model.forward_logits(dist, vec)
            per_row = F.binary_cross_entropy_with_logits(
                logits, targets, reduction="none").mean(dim=-1)
            # no collective inside the differentiated loss: the slice's masked
            # sum over the GLOBAL row count, so the summed grads are the mean's
            loss = (per_row * mask).sum() / denom
            opt.zero_grad(set_to_none=False)
            loss.backward()
            flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.detach().reshape(1)])
            flat = mesh.all_reduce(flat)  # one collective: every gradient and the loss
            off = 0
            for p in params:
                p.grad.copy_(flat[off : off + p.numel()].view_as(p))
                off += p.numel()
            opt.step()
        return float(flat[-1])

    return step


def dp_train_epoch(
    state: TrainState,
    mesh: Mesh,
    dist,
    vec,
    targets,
    global_batch: int = 512,
) -> tuple[TrainState, float]:
    """One DP epoch, in order, over host arrays or tensors (a tail batch
    is zero-padded to a multiple of the rank count): rank r trains on rows
    [s + r·per, s + (r+1)·per) of each global batch [s, s + bs).  Returns
    (state, mean per-batch loss); the state is updated in place."""
    step = make_dp_train_step(state, mesh)
    dev = state.device
    state.model.train()
    n = len(dist)
    size = mesh.size
    global_batch = max(size, (global_batch // size) * size)
    loss_sum, n_batches = 0.0, 0
    for s in range(0, n, global_batch):
        e = min(s + global_batch, n)
        per = -(-(e - s) // size)  # this batch's rows a rank
        lo = min(s + mesh.rank * per, e)
        hi = min(lo + per, e)
        mask = (torch.arange(per, device=dev) < hi - lo).float()
        loss_sum += step(_rows_f32(dist, lo, hi, per, dev), _rows_f32(vec, lo, hi, per, dev),
                         _rows_f32(targets, lo, hi, per, dev), mask, float(e - s))
        n_batches += 1
    state.model.eval()
    return state, loss_sum / max(n_batches, 1)
