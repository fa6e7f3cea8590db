from .calibrate import MarginCalibration, autotune_block_q, calibrate_block_margin
from .screen import union_groupmin, union_groupmin_ref
from .serve import QueryEngine, SearchResult

__all__ = [
    "QueryEngine",
    "SearchResult",
    "calibrate_block_margin",
    "autotune_block_q",
    "MarginCalibration",
    "union_groupmin",
    "union_groupmin_ref",
]
