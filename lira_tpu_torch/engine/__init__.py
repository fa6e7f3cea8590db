from .calibrate import MarginCalibration, autotune_block_q, calibrate_block_margin
from .ivf_baseline import ivf_probe_matrix, ivf_sweep
from .pallas_scan import pallas_probed_scan, probed_scan_ref
from .scan import BucketCorpus, bucket_topk
from .screen import union_groupmin, union_groupmin_ref
from .serve import QueryEngine, SearchResult, rerank_exact_host
from .sweep import SweepRow, gt_hit_tensor, threshold_sweep
from .tuning import OperatingPoint, compare_at_recall, pick_threshold

__all__ = [
    "QueryEngine",
    "SearchResult",
    "rerank_exact_host",
    "calibrate_block_margin",
    "autotune_block_q",
    "MarginCalibration",
    "union_groupmin",
    "union_groupmin_ref",
    "pallas_probed_scan",
    "probed_scan_ref",
    "ivf_probe_matrix",
    "ivf_sweep",
    "OperatingPoint",
    "pick_threshold",
    "compare_at_recall",
    "BucketCorpus",
    "bucket_topk",
    "SweepRow",
    "gt_hit_tensor",
    "threshold_sweep",
]
