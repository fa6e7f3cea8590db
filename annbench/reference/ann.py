"""Plain reference of a LIRA search: the probing model's forward pass, the
bucket selection, bucket membership, and exact nearest neighbours, in
plain PyTorch and NumPy.

It imports nothing of the program under test, and takes from it only the
index as raw arrays: centroids, the scaler's mean and scale, the probing
MLP's weights (a state dict of plain tensors) and the (n, n_mul)
row-to-bucket assignment.  Everything the serving engine derives from
them (padded tables, tile lists, norms, quantized copies) is worked out
again here.

Precisions: "f64" is the exact reference that judges; "f32" is true f32
(TF32 off), for the recall's exact kNN; "tf32" is the control, the f32
arithmetic with every matrix product's operands rounded to TF32 (10
explicit mantissa bits, as Hopper's TF32 tensor cores read f32 operands)
and accumulated in f32: the step below the true f32 that the program's
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("f64", "f32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (round to nearest, ties to even, on the
    13 dropped mantissa bits); inf and nan pass unchanged."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    keep = ((bits >> 13) & 1) + 0xFFF
    rounded = ((bits + keep) >> 13) << 13
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def _cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.double() if precision == "f64" else x.float()


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in the named precision (TF32 off for the f32 accumulation)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: expected one of {PRECISIONS}")
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _cast(a, precision) @ _cast(b, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sq_dist(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """(m, n) squared L2 distances ‖q‖² − 2 q·x + ‖x‖², the norms in the
    precision's accumulator type and the product by `matmul`."""
    qc, xc = _cast(q, precision), _cast(x, precision)
    return ((qc * qc).sum(1)[:, None] - 2.0 * matmul(q, x.T, precision)
            + (xc * xc).sum(1)[None, :])


def _linear(h, w, b, precision):
    return matmul(h, w.T, precision) + _cast(b, precision)


def probe_scores(q: torch.Tensor, index: dict, precision: str) -> torch.Tensor:
    """(m, n_bkt) probing probabilities: the standardized Euclidean
    distances to every centroid and the raw query through the two-branch
    MLP (distance branch n_bkt→128→64, vector branch d→128→64, joint head
    128→128→n_bkt; ReLU, then a sigmoid)."""
    w = index["mlp"]
    c = index["centroids"]
    feat = torch.sqrt(torch.clamp_min(sq_dist(q, c, precision), 0.0))
    feat = (feat - _cast(index["scaler_mean"], precision)) / _cast(index["scaler_scale"], precision)
    relu = torch.relu

    def lin(h, name):
        return _linear(h, w[f"{name}.weight"], w[f"{name}.bias"], precision)

    d = relu(lin(relu(lin(feat, "dist1")), "dist2"))
    v = relu(lin(relu(lin(_cast(q, precision), "vec1")), "vec2"))
    h = relu(lin(torch.cat([d, v], dim=1), "head1"))
    return torch.sigmoid(lin(h, "head2"))


def select(scores: torch.Tensor, threshold: float, probe_cap: int | None) -> torch.Tensor:
    """(m, n_bkt) bool probed mask: among the top `probe_cap` buckets (all
    when None), those scoring at least `threshold`; the best bucket always."""
    m, n_bkt = scores.shape
    cap = n_bkt if probe_cap is None else min(int(probe_cap), n_bkt)
    vals, idx = torch.topk(scores, cap, dim=1)
    keep = vals >= threshold
    keep[:, 0] = True
    probed = torch.zeros((m, n_bkt), dtype=torch.bool, device=scores.device)
    probed.scatter_(1, idx, keep)
    return probed


class Buckets:
    """Bucket membership from the raw (n, n_mul) assignment: each bucket's
    distinct row ids in ascending order (a row listed twice in one bucket
    counts once), as a CSR on `device`."""

    def __init__(self, data_2_bkt: np.ndarray, n_bkt: int, device="cpu"):
        d2b = np.asarray(data_2_bkt)
        if d2b.ndim == 1:
            d2b = d2b[:, None]
        self.d2b = d2b
        t = torch.as_tensor(d2b, device=device).long()
        keep = t >= 0
        for j in range(1, t.shape[1]):
            for i in range(j):
                keep[:, j] &= t[:, j] != t[:, i]
        rows = torch.arange(t.shape[0], device=t.device)[:, None].expand_as(t)
        bkt, row = t[keep], rows[keep]  # row-major: ascending rows
        self.ids = row[torch.sort(bkt, stable=True).indices]
        self.sizes = torch.bincount(bkt, minlength=n_bkt).cpu().numpy().astype(np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.n_bkt = n_bkt

    def members(self, b: int) -> torch.Tensor:
        return self.ids[int(self.offsets[b]) : int(self.offsets[b + 1])]

    def in_probed(self, probed: np.ndarray, qi: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """(len(qi), k) bool: is row ids[j, i] in a bucket that query qi[j] probed."""
        safe = np.maximum(ids, 0)
        b = self.d2b[safe]  # (m, k, n_mul)
        hit = np.zeros(ids.shape, bool)
        for j in range(b.shape[2]):
            col = b[:, :, j]
            hit |= (col >= 0) & probed[qi[:, None], np.maximum(col, 0)]
        return hit & (ids >= 0)


def topk_in_probed(q: torch.Tensor, x: torch.Tensor, probed: np.ndarray, buckets: Buckets,
                   k: int, precision: str, max_pairs: int = 1 << 27) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k distinct rows within each query's probed buckets.

    q (m, d) and the corpus x (n, d) on one device; probed (m, n_bkt) bool
    on the host.  Per bucket, the distances from the queries that probe it
    to its rows (at most `max_pairs` at a time), their best k, merged over
    buckets with replicas counted once.  Returns (ids (m, k) int64, -1 past
    the last row; squared distances (m, k) f64, inf there)."""
    m = q.shape[0]
    nprobe = probed.sum(1)
    slots = int(nprobe.max()) * k if m else 0
    cand_d = torch.full((m, max(slots, 1)), float("inf"), dtype=torch.float64, device=q.device)
    cand_i = torch.full((m, max(slots, 1)), -1, dtype=torch.int64, device=q.device)
    pos = np.zeros(m, np.int64)
    for b in np.nonzero(probed.any(0))[0]:
        rows_t = buckets.members(int(b)).to(q.device)
        if not len(rows_t):
            continue
        xb = x[rows_t]
        kk = min(k, len(rows_t))
        in_b = np.nonzero(probed[:, b])[0]
        step = max(1, max_pairs // len(rows_t))
        for a in range(0, len(in_b), step):
            qs = in_b[a : a + step]
            dist = sq_dist(q[torch.as_tensor(qs, device=q.device)], xb, precision)
            vals, idx = torch.topk(dist, kk, dim=1, largest=False)
            col = torch.as_tensor(pos[qs][:, None] + np.arange(kk)[None, :], device=q.device)
            qs_t = torch.as_tensor(qs, device=q.device)[:, None]
            cand_d[qs_t, col] = vals.double()
            cand_i[qs_t, col] = rows_t[idx]
            pos[qs] += kk
    d_h, i_h = cand_d.cpu().numpy(), cand_i.cpu().numpy()
    order = np.argsort(d_h, axis=1, kind="stable")
    d_h, i_h = np.take_along_axis(d_h, order, 1), np.take_along_axis(i_h, order, 1)
    ids = np.full((m, k), -1, np.int64)
    dist = np.full((m, k), np.inf)
    for r in range(m):
        _, first = np.unique(i_h[r], return_index=True)
        first = np.sort(first)
        first = first[i_h[r, first] >= 0][:k]
        ids[r, : len(first)] = i_h[r, first]
        dist[r, : len(first)] = d_h[r, first]
    return ids, dist


def exact_knn(q: torch.Tensor, x: torch.Tensor, k: int, chunk_q: int = 2048,
              chunk_x: int = 1 << 20) -> np.ndarray:
    """(m, k) int64 ids of each query's k nearest corpus rows, in true f32
    (TF32 off), the corpus taken in chunks; ties keep the lower id."""
    out = np.empty((q.shape[0], k), np.int64)
    x_sq = [(x[s : s + chunk_x] * x[s : s + chunk_x]).sum(1) for s in range(0, len(x), chunk_x)]
    for a in range(0, q.shape[0], chunk_q):
        qc = q[a : a + chunk_q].float()
        best_d = best_i = None
        for j, s in enumerate(range(0, len(x), chunk_x)):
            d = x_sq[j][None, :] - 2.0 * matmul(qc, x[s : s + chunk_x].T, "f32")
            vals, idx = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            idx = idx + s
            if best_d is None:
                best_d, best_i = vals, idx
            else:
                cd, ci = torch.cat([best_d, vals], 1), torch.cat([best_i, idx], 1)
                best_d, sel = torch.topk(cd, k, dim=1, largest=False)
                best_i = torch.gather(ci, 1, sel)
        out[a : a + chunk_q] = best_i.cpu().numpy()
    return out


def sq_dist_pairs(q: torch.Tensor, x: torch.Tensor, ids: np.ndarray) -> np.ndarray:
    """(m, k) exact f64 squared distances from each query to its listed
    rows (inf at -1), by the difference, not the expansion."""
    ids_t = torch.as_tensor(np.maximum(ids, 0), device=q.device)
    diff = x[ids_t].double() - q.double()[:, None, :]
    d = (diff * diff).sum(-1).cpu().numpy()
    return np.where(ids >= 0, d, np.inf)
