from .cache import knn_cache_dir, load_knn_cache, save_knn_cache
from .xvecs import read_xvecs, write_xvecs
from .datasets import (
    HARD_REGIME, DatasetBundle, check_sig_sidecar, hard_regime_sig, load_data,
    synthetic_dataset, write_dataset, write_sig_sidecar,
)

__all__ = [
    "read_xvecs",
    "write_xvecs",
    "HARD_REGIME",
    "DatasetBundle",
    "hard_regime_sig",
    "check_sig_sidecar",
    "write_sig_sidecar",
    "load_data",
    "synthetic_dataset",
    "write_dataset",
    "knn_cache_dir",
    "load_knn_cache",
    "save_knn_cache",
]
