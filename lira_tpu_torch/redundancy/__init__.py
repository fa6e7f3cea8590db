from .assign import apply_redundancy, apply_redundancy_subset, redundancy_rows, select_top_ratio

__all__ = ["redundancy_rows", "apply_redundancy", "apply_redundancy_subset", "select_top_ratio"]
