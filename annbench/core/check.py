"""Whether the timed path's answers are right, and whether the index they
come from was built right, judged by the plain reference
(`annbench/reference/ann.py`) in f64.

The reference cannot rebuild the index (K-Means, the self-kNN, the probing
MLP's training, the redundancy): it follows the program's own index, given
as raw arrays, and checks the build by itself in two ways.  Five numbers,
each beside its limit from the cell's file:

  probe_mismatch  the share of sampled queries whose nprobe or ndis
                  differs from the reference's (the probing MLP run from
                  its weights, the selection, the bucket sizes from the raw
                  assignment; a bucket whose score lies within rounding of
                  the threshold may fall either way);
  bad_ids         over the other queries, returned slots that are empty
                  where the probed buckets hold a row, repeat an id, or
                  name a row outside the probed buckets (exact: limit 0);
  dist_gap        over the same queries, the widest gap by which the
                  i-th returned row's exact squared distance exceeds the
                  reference's i-th, over the reference's k-th;
  assign_gap      over every corpus row, how far the nearest of the
                  buckets the row is listed in lies beyond its nearest
                  centroid: the excess squared distance over
                  ‖x‖² + ‖c‖² of the nearest (the scale of a rounding
                  error); 1.0 where a listed bucket is no bucket.  K-Means
                  puts each row in its nearest bucket and the redundancy
                  keeps that bucket among the row's, so only rounding
                  separates them;
  recall_miss     1 − recall@k of the served answers at the recall
                  sample's positions against their exact kNN over the
                  whole corpus: how far the probe's choice falls short,
                  which an index built from a wrong kNN, too little
                  training or the wrong rows shows.
"""

from __future__ import annotations

import numpy as np
import torch

from annbench.reference import ann

NUMBERS = ("probe_mismatch", "bad_ids", "dist_gap", "assign_gap", "recall_miss")


def raw_index(built: dict) -> dict:
    """The built index as plain host arrays: what the reference may take."""
    return {
        "centroids": np.asarray(built["centroids"], np.float32),
        "scaler_mean": np.asarray(built["scaler"].mean_, np.float32),
        "scaler_scale": np.asarray(built["scaler"].scale_, np.float32),
        "mlp": {name: t.detach().cpu().float().clone()
                for name, t in built["mlp"].state_dict().items()},
        "data_2_bkt": np.asarray(built["data_2_bkt"]),
    }


class Reference:
    """The index as the reference sees it (`raw_index`), on `device`, with
    the corpus there when given."""

    def __init__(self, raw: dict, x_d: np.ndarray | None, device):
        dev = torch.device(device)
        self.device = dev
        self.x = None if x_d is None else torch.as_tensor(x_d, device=dev)
        self.n_bkt = int(raw["centroids"].shape[0])
        self.index = {name: torch.as_tensor(raw[name], device=dev)
                      for name in ("centroids", "scaler_mean", "scaler_scale")}
        self.index["mlp"] = {name: t.to(dev) for name, t in raw["mlp"].items()}
        d2b = np.asarray(raw["data_2_bkt"])
        self._d2b = d2b[:, None] if d2b.ndim == 1 else d2b
        self._buckets = None

    @property
    def buckets(self) -> ann.Buckets:
        if self._buckets is None:
            self._buckets = ann.Buckets(self._d2b, self.n_bkt, self.device)
        return self._buckets

    def scores(self, q: np.ndarray, precision: str, chunk: int = 65536) -> np.ndarray:
        parts = [ann.probe_scores(torch.as_tensor(q[s : s + chunk], device=self.device),
                                  self.index, precision).float().cpu().numpy()
                 for s in range(0, len(q), chunk)]
        return np.concatenate(parts) if parts else np.zeros((0, self.n_bkt), np.float32)

    def probe(self, q: np.ndarray, threshold: float, probe_cap, precision: str,
              chunk: int = 65536) -> np.ndarray:
        """(m, n_bkt) bool probed mask, computed `chunk` queries at a time."""
        parts = []
        for s in range(0, len(q), chunk):
            qs = torch.as_tensor(q[s : s + chunk], device=self.device)
            sc = ann.probe_scores(qs, self.index, precision)
            parts.append(ann.select(sc, threshold, probe_cap).cpu().numpy())
        return np.concatenate(parts) if parts else np.zeros((0, self.n_bkt), bool)

    def answer(self, q: np.ndarray, threshold: float, probe_cap, k: int,
               precision: str) -> dict:
        """A search done by the reference: probed mask, nprobe, ndis, ids."""
        probed = self.probe(q, threshold, probe_cap, precision)
        ids, _ = ann.topk_in_probed(torch.as_tensor(q, device=self.device), self.x, probed,
                                    self.buckets, k, precision)
        return {"probed": probed, "nprobe": probed.sum(1),
                "ndis": probed.astype(np.int64) @ self.buckets.sizes, "ids": ids}

    def distinct_rows(self, probed: np.ndarray) -> int:
        """Rows in the union of the buckets any of these queries probe."""
        return int(self.buckets.sizes[probed.any(0)].sum())

    def exact_knn(self, q: np.ndarray, k: int) -> np.ndarray:
        """(m, k) ids of each query's k nearest corpus rows (`ann.exact_knn`)."""
        return ann.exact_knn(torch.as_tensor(q, device=self.device), self.x, k)

    def nearest(self, precision: str, chunk: int = 1 << 16) -> np.ndarray:
        """(n, 1) each corpus row's nearest centroid, its distances in
        `precision` (the control's assignment, in "tf32")."""
        c = self.index["centroids"]
        out = np.empty((len(self.x), 1), np.int64)
        for s in range(0, len(self.x), chunk):
            dist = ann.sq_dist(self.x[s : s + chunk], c, precision)
            out[s : s + chunk, 0] = dist.argmin(1).cpu().numpy()
        return out

    def assign_gap(self, listed: np.ndarray | None = None, chunk: int = 1 << 16) -> float:
        """`assign_gap` of the (n, n_mul) buckets each row is listed in (the
        index's own by default), distances in f64."""
        listed = self._d2b if listed is None else listed
        valid = (listed >= 0) & (listed < self.n_bkt)
        if not valid[:, 0].all() or ((listed != -1) & ~valid).any():
            return 1.0
        c = self.index["centroids"].double()
        c_sq = (c * c).sum(1)
        worst = 0.0
        for s in range(0, len(self.x), chunk):
            xs = self.x[s : s + chunk].double()
            x_sq = (xs * xs).sum(1)
            dist = x_sq[:, None] - 2.0 * (xs @ c.T) + c_sq[None, :]
            d_min, nearest = dist.min(1)
            cols = torch.as_tensor(listed[s : s + chunk], device=self.device).long()
            d_listed = torch.where(cols >= 0, dist.gather(1, cols.clamp_min(0)),
                                   torch.full_like(d_min[:, None], float("inf")))
            gap = (d_listed.min(1).values - d_min) / (x_sq + c_sq[nearest])
            worst = max(worst, float(gap.max()))
        return worst


def recall(ids: np.ndarray, knn: np.ndarray, k: int) -> float | None:
    """Mean recall@k of returned ids (m, >= k) against exact ids (m, >= k)."""
    if not len(ids):
        return None
    hits = (ids[:, :k, None] == knn[:, None, :k]).any(2).sum(1)
    return float(hits.mean() / k)


def judge(ref: Reference, q: np.ndarray, want: dict, got: dict, k: int) -> dict:
    """probe_mismatch, bad_ids and dist_gap for answers `got` (ids, nprobe,
    ndis) to queries q, against the reference's exact answers `want`
    (`Reference.answer` in f64)."""
    m = len(q)
    same = (np.asarray(got["nprobe"]) == want["nprobe"]) & (np.asarray(got["ndis"]) == want["ndis"])
    qi = np.nonzero(same)[0]
    ids = np.asarray(got["ids"], np.int64)[qi]
    ref_ids = want["ids"][qi]
    inside = ref.buckets.in_probed(want["probed"], qi, ids)
    srt = np.sort(np.where(ids >= 0, ids, -1 - np.arange(ids.shape[1])[None, :]), axis=1)
    dup_rows = (srt[:, 1:] == srt[:, :-1]).sum(1)
    n_ref = (ref_ids >= 0).sum(1)
    empty = (ids < 0) & (np.arange(k)[None, :] < n_ref[:, None])
    bad = int((~inside & (ids >= 0)).sum() + empty.sum() + dup_rows.sum())
    qt = torch.as_tensor(q[qi], device=ref.device)
    d_got = np.sort(ann.sq_dist_pairs(qt, ref.x, np.where(inside, ids, -1)), axis=1)
    d_ref = ann.sq_dist_pairs(qt, ref.x, ref_ids)
    kth = d_ref[np.arange(len(qi)), np.maximum(n_ref - 1, 0)] if len(qi) else np.zeros(0)
    live = np.isfinite(d_got) & np.isfinite(d_ref)
    gap = np.where(live, (d_got - d_ref) / np.maximum(kth, 1e-30)[:, None], 0.0)
    return {"probe_mismatch": float(1.0 - len(qi) / max(m, 1)), "bad_ids": bad,
            "dist_gap": float(max(gap.max(initial=0.0), 0.0))}


def recall_miss(rec: float | None) -> float:
    """1 − recall; 1.0 when no answer could be judged."""
    return 1.0 if rec is None else 1.0 - rec


def verdict(numbers: dict, limits: dict) -> bool:
    missing = [n for n in NUMBERS if n not in limits]
    if missing:
        raise KeyError(f"the cell's check has no limit for {missing}")
    return all(numbers[n] <= limits[n] for n in NUMBERS)
