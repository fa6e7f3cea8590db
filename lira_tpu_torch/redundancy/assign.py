"""Learning-based redundancy: duplicate boundary vectors into extra
model-chosen partitions (port of lira_tpu/redundancy/assign.py).

Per selected point with native partition c:

    ranking   = partitions sorted by probing score, descending
                (ties: lower index first)
    n_eff     = #{partitions with score > σ}
    n_act     = min(n_mul − 1, n_eff)
    loc       = rank of c in the ranking
    row       = [c, ranking[:n_act]]        if loc ≥ n_act      (native kept)
              = [ranking[:n_act]]           if n_eff == n_act   (native inside)
              = [ranking[:n_act + 1]]       otherwise           (native inside)
    remaining slots → −1

In every branch the native partition stays a member of the row, so the
bucket layout can always be rebuilt from the assignment matrix alone.  The
rule is evaluated on the device, a chunk of rows at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.topk import top_k


def _redundancy_rows_dev(scores: torch.Tensor, predicts: torch.Tensor, cur: torch.Tensor,
                         n_mul: int) -> torch.Tensor:
    n_bkt = scores.shape[1]
    m = min(n_mul, n_bkt)
    _, top = top_k(scores, m)  # ties -> lowest index first (stable desc)
    top = top.to(torch.int32)

    n_eff = predicts.to(torch.int32).sum(dim=1)
    n_act = torch.clamp(n_eff, max=n_mul - 1)

    cur64 = cur.long()
    score_cur = torch.gather(scores, 1, cur64[:, None])[:, 0]
    col = torch.arange(n_bkt, device=scores.device)[None, :]
    gt = (scores > score_cur[:, None]).sum(dim=1)
    ties_before = ((scores == score_cur[:, None]) & (col < cur64[:, None])).sum(dim=1)
    loc = gt + ties_before  # rank of the native partition in the descending order

    slot = torch.arange(n_mul, device=scores.device)[None, :]
    pad_top = torch.nn.functional.pad(top, (0, n_mul - m), value=-1)

    # branch 1: [cur, top[:n_act], -1...]
    row1 = torch.cat([cur[:, None].to(torch.int32), pad_top[:, : n_mul - 1]], dim=1)
    row1 = torch.where(slot <= n_act[:, None], row1, -1)

    # branches 2/3: [top[:n_keep], -1...] with n_keep = n_act or n_act+1
    n_keep = torch.where(n_eff == n_act, n_act, n_act + 1)
    row23 = torch.where(slot < n_keep[:, None], pad_top, -1)

    is_b1 = loc >= n_act
    return torch.where(is_b1[:, None], row1, row23)


def redundancy_rows(
    scores: np.ndarray,
    predicts: np.ndarray,
    cur: np.ndarray,
    n_mul: int,
    chunk: int = 262144,
    device=None,
) -> np.ndarray:
    """Vectorized replacement rows for the selected points. (n_sel, n_mul) int32."""
    dev = resolve_device(device)
    n = len(scores)
    out = np.empty((n, n_mul), dtype=np.int32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        out[s:e] = _redundancy_rows_dev(
            torch.as_tensor(np.asarray(scores[s:e], np.float32), device=dev),
            torch.as_tensor(np.asarray(predicts[s:e]), device=dev),
            torch.as_tensor(np.asarray(cur[s:e], np.int32), device=dev),
            n_mul,
        ).cpu().numpy()
    return out


def select_top_ratio(predicts: np.ndarray, ratio: float) -> np.ndarray:
    """Points ranked by predicted nprobe (descending, stable), top `ratio` share.

    Accepts either the (n, n_bkt) 0/1 predict matrix or a precomputed (n,)
    count vector (`models.train.predict_counts` — the device-reduced form).
    """
    p = np.asarray(predicts)
    nprobe = p.sum(axis=1) if p.ndim == 2 else p
    order = np.argsort(-nprobe, kind="stable")
    n_red = int(len(order) * ratio)
    return order[:n_red]


def apply_redundancy(
    data_2_bkt: np.ndarray,
    scores: np.ndarray,
    predicts: np.ndarray,
    selected: np.ndarray,
    device=None,
) -> np.ndarray:
    """Return a copy of the assignment matrix with the selected rows replaced.

    `scores`/`predicts` are indexed by the same global ids as `data_2_bkt`."""
    out = np.array(data_2_bkt, copy=True)
    if len(selected) == 0:
        return out
    cur = out[selected, 0]
    out[selected] = redundancy_rows(scores[selected], predicts[selected], cur, out.shape[1],
                                    device=device)
    return out


def apply_redundancy_subset(
    data_2_bkt: np.ndarray,
    sel_scores: np.ndarray,
    sel_predicts: np.ndarray,
    selected: np.ndarray,
    device=None,
) -> np.ndarray:
    """Like `apply_redundancy`, but `sel_scores`/`sel_predicts` carry ONLY the
    selected rows (row i describes point selected[i]), so the caller scores
    just the duplicated minority."""
    out = np.array(data_2_bkt, copy=True)
    if len(selected) == 0:
        return out
    cur = out[selected, 0]
    out[selected] = redundancy_rows(sel_scores, sel_predicts, cur, out.shape[1],
                                    device=device)
    return out
