"""The needed-work counts of `core/roofline.py` against hand counts."""

from __future__ import annotations

import pytest

from annbench.core.roofline import roofline_pct, scan_bound


def test_int8_screen_counts():
    # 1,000 queries x 8,000 probed rows each, 600,000 distinct rows, d 128, k 10
    b = scan_bound(8e6, 6e5, 1000, 128, 10, "int8")
    assert b["ops"] == 2 * 128 * 8e6
    assert b["bytes"] == 6e5 * (128 + 4) + 1000 * 128 + 1000 * 10 * 8
    assert b["seconds"] == pytest.approx(max(2.048e9 / 1979e12, b["bytes"] / 3.35e12))
    assert b["by"] == "bytes"


def test_f32_scan_counts():
    b = scan_bound(128 * 7850, 6e5, 128, 128, 10, "float32")
    assert b["bytes"] == 6e5 * (512 + 4) + 128 * 512 + 128 * 80
    assert b["seconds"] == pytest.approx(b["bytes"] / 3.35e12) and b["by"] == "bytes"
    ops_bound = scan_bound(1e9, 10, 1, 128, 10, "float32")
    assert ops_bound["by"] == "operations"
    assert ops_bound["seconds"] == pytest.approx(2 * 128 * 1e9 / 67e12)


def test_share():
    assert roofline_pct(1e-3, 4e-3) == pytest.approx(25.0)
    assert roofline_pct(1e-3, 0.0) is None
