"""Operating-point selection from sweep curves (own copy of
lira_tpu/engine/tuning.py: plain Python).

Given sweep rows (`sweep.threshold_sweep`'s SweepRows or
`QueryEngine.sweep`'s dicts), pick the cheapest threshold meeting a recall
target, or compare two sweeps at matched recall.
"""

from __future__ import annotations

from dataclasses import dataclass

from .sweep import SweepRow


@dataclass
class OperatingPoint:
    threshold: float
    recall: float
    nprobe: float
    computations: float


def _as_tuple(row) -> OperatingPoint:
    if isinstance(row, SweepRow):
        return OperatingPoint(row.threshold, row.recall, row.nprobe, row.computations)
    return OperatingPoint(
        row["threshold"],
        row.get("avg_recall", row.get("Recall", 0.0)),
        row.get("avg_nprobe", row.get("nprobe", 0.0)),
        row.get("avg_cmp", row.get("Computations", 0.0)),
    )


def pick_threshold(rows, recall_target: float) -> OperatingPoint | None:
    """Cheapest (fewest computations) operating point with recall ≥ target."""
    feasible = [c for c in map(_as_tuple, rows) if c.recall >= recall_target]
    if not feasible:
        return None
    return min(feasible, key=lambda c: (c.computations, -c.recall))


def compare_at_recall(rows_a, rows_b, recall_target: float) -> dict | None:
    """Cost ratio of two sweeps at the same recall target:
    {'a': OperatingPoint, 'b': OperatingPoint, 'ndis_ratio': b/a,
    'nprobe_ratio': b/a} — the LIRA-vs-IVF comparison in one call."""
    a = pick_threshold(rows_a, recall_target)
    b = pick_threshold(rows_b, recall_target)
    if a is None or b is None:
        return None
    return {
        "a": a,
        "b": b,
        "ndis_ratio": b.computations / a.computations if a.computations else float("inf"),
        "nprobe_ratio": b.nprobe / a.nprobe if a.nprobe else float("inf"),
    }
