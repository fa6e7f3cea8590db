"""Measured selection-margin calibration and block-size tuning (port of
lira_tpu/engine/calibrate.py).

The bf16/int8 screens are exact except for one failure mode: a
true-neighbour group whose approximate group-min rounds past the selection
margin.  The zero-miss margin is data-dependent, so serving on a new corpus
re-validates it: `calibrate_block_margin` runs the engine's own blocked
search across a margin ladder against the same engine at an exhaustive
margin, and returns the smallest zero-miss margin times a safety factor.

    margin = calibrate_block_margin(engine, queries[:4096], threshold, k)
    engine.block_margin = margin.margin
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class MarginCalibration:
    margin: int  # recommended: smallest zero-miss rung × safety
    zero_miss_margin: int | None  # smallest measured zero-miss rung
    miss_rates: dict  # margin -> fraction of reference neighbors missed
    ladder: tuple  # the margins measured


def _neighbor_miss_rate(ids_test: np.ndarray, ids_ref: np.ndarray) -> float:
    """Fraction of reference neighbours absent from the test result."""
    hit = (ids_ref[:, :, None] == ids_test[:, None, :]).any(axis=2)
    valid = ids_ref >= 0
    n = valid.sum()
    return float(((~hit) & valid).sum() / max(n, 1))


def calibrate_block_margin(
    engine,  # QueryEngine (blocked)
    queries: np.ndarray,
    threshold: float,
    k: int,
    ladder: tuple = (0, 2, 4, 8, 16, 32, 64),
    safety: float = 2.0,
) -> MarginCalibration:
    """Measure the zero-miss selection margin on `queries` at `threshold`.
    If no rung is zero-miss, `.margin` is the exhaustive bound and
    `.zero_miss_margin` is None."""
    if engine.scan_impl != "blocked":
        raise ValueError("margin calibration applies to scan_impl='blocked'")
    from .block_scan import S_TILES, blocked_search

    queries = np.asarray(queries, np.float32)
    state = engine._block_state
    sel_rows = engine.block_sel_rows
    n_groups = state.n_super * S_TILES * (128 // sel_rows)
    fetch_k = k * engine.n_mul

    def run(margin):
        _, ids, _, _ = blocked_search(
            state, engine, queries, threshold, fetch_k, k,
            block_q=engine.block_q, margin=int(margin), sel_rows=sel_rows,
        )
        return ids

    ids_ref = run(n_groups)  # kg caps at the corpus: structurally exact
    miss_rates: dict = {}
    zero = None
    for m in ladder:
        if m >= n_groups:
            break
        r = _neighbor_miss_rate(run(m), ids_ref)
        miss_rates[int(m)] = r
        if r == 0.0 and zero is None:
            zero = int(m)
    if zero is None:
        margin = n_groups
    else:
        margin = min(int(np.ceil(max(zero, 1) * safety)), n_groups)
    return MarginCalibration(
        margin=margin, zero_miss_margin=zero, miss_rates=miss_rates,
        ladder=tuple(int(m) for m in ladder),
    )


@dataclass
class BlockQTuning:
    block_q: int  # fastest measured candidate (median of interleaved reps)
    medians: dict  # candidate block_q -> median seconds per search call
    candidates: tuple  # the block sizes measured
    reps: int  # timed repetitions per candidate


def autotune_block_q(
    engine,  # QueryEngine (blocked)
    queries: np.ndarray,
    threshold: float,
    k: int,
    candidates: tuple = (1024, 512, 256),
    reps: int = 3,
) -> BlockQTuning:
    """Measure the fastest query-block size at one operating point: warm
    each candidate once, then time `reps` interleaved rotations and pick
    the median-fastest.  Results are block_q-invariant, so this tunes speed
    only.  Leaves `engine.block_q` unchanged."""
    if engine.scan_impl != "blocked":
        raise ValueError("block_q autotune applies to scan_impl='blocked'")
    if not candidates:
        raise ValueError("need at least one block_q candidate")
    queries = np.asarray(queries, np.float32)
    prev = engine.block_q
    times: dict = {int(qb): [] for qb in candidates}
    try:
        for qb in candidates:
            engine.block_q = int(qb)
            engine.search(queries, threshold, k)
        for _ in range(max(1, int(reps))):
            for qb in candidates:
                engine.block_q = int(qb)
                t0 = time.perf_counter()
                engine.search(queries, threshold, k)
                times[int(qb)].append(time.perf_counter() - t0)
    finally:
        engine.block_q = prev
    medians = {qb: float(np.median(v)) for qb, v in times.items()}
    best = min(medians, key=lambda qb: medians[qb])
    return BlockQTuning(
        block_q=int(best), medians=medians,
        candidates=tuple(int(c) for c in candidates),
        reps=max(1, int(reps)),
    )
