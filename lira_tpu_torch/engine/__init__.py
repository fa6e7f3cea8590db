from .calibrate import MarginCalibration, autotune_block_q, calibrate_block_margin
from .scan import BucketCorpus, bucket_topk
from .screen import union_groupmin, union_groupmin_ref
from .serve import QueryEngine, SearchResult
from .sweep import SweepRow, gt_hit_tensor, threshold_sweep

__all__ = [
    "QueryEngine",
    "SearchResult",
    "calibrate_block_margin",
    "autotune_block_q",
    "MarginCalibration",
    "union_groupmin",
    "union_groupmin_ref",
    "BucketCorpus",
    "bucket_topk",
    "SweepRow",
    "gt_hit_tensor",
    "threshold_sweep",
]
