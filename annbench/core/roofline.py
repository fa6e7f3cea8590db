"""The yardstick of a kernel's roofline share: published peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit) and the
operations and bytes that a scan's inputs need.

The counts are of the work the queries need, not of what an implementation
chose to compute: W (query, row) pairs, where W sums each query's probed
rows (its `ndis`), and the distinct rows its queries probe, each read once.
So a share reads the same whatever implements the scan, and cannot pass
100% unless the time leaves out part of the work.
"""

from __future__ import annotations

# operations (or bytes) per second
PEAK_OPS = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TABLE_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}  # one element of the table
NORM_BYTES = 4  # one f32 norm a row
RESULT_BYTES = 8  # one id and one score a result slot


def scan_bound(pairs: float, distinct_rows: float, n_queries: int, d: int, k: int,
               dtype: str) -> dict:
    """The least time of a scan that scores `pairs` (query, row) pairs at
    width `d` in `dtype`: operations 2·d·pairs at the dtype's peak; bytes the
    distinct rows (d elements plus a norm each), the queries in (d elements
    each) and k results out a query.  Returns {"seconds", "by", "ops",
    "bytes"}, "by" naming the bound that sets it."""
    ops = 2.0 * d * pairs
    nbytes = (distinct_rows * (d * TABLE_BYTES[dtype] + NORM_BYTES)
              + n_queries * d * TABLE_BYTES[dtype] + n_queries * k * RESULT_BYTES)
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return {"seconds": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def roofline_pct(bound_s: float, device_s: float) -> float | None:
    """The bound over the device time, in %; None without device time."""
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
