"""Configuration system: dataclass config + argparse CLI bridge.
(own copy of lira_tpu/config.py)

Capability parity with the reference Config dataclass / HfArgumentParser
combo (reference: LIRA_smallscale.py:27-75) — required-field validation,
metric-alias normalization, derived log paths and hyperparameter-encoding
file prefixes — without the transformers dependency.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


def _normalize_metric(metric: str | None) -> str:
    if not metric:
        return "L2"
    m = metric.lower()
    if m in ("l2", "euclidean", "euclidean_distance"):
        return "L2"
    if m in ("ip", "inner_product", "dot", "dot_product"):
        return "inner_product"
    return metric


@dataclass
class Config:
    """End-to-end pipeline configuration."""

    method_name: str = "LIRA_TPU_RE"
    dataset: str | None = None  # dataset name (required)
    data_path: str = "/data/vector_datasets"
    dis_metric: str = "L2"  # 'L2' | 'inner_product'
    k: int | None = None  # recall@k (required)
    n_bkt: int | None = None  # number of partitions (required)
    n_epoch: int = 10  # 10 small-scale / 30 large-scale
    batch_size: int = 64
    n_mul: int = 2  # max partitions per point (1 native + n_mul-1 replicas)

    redundancy_ratio: float = 0.03  # duplicate the top-x% boundary vectors
    duplicate_type: str = "model"  # 'None' | 'model'

    # model / training
    lr: float = 1e-4
    sigma: float = 0.5  # probing 0/1 threshold
    seed: int = 43
    kmeans_niter: int = 20
    kmeans_init: str = "random"  # 'random' (reference faiss parity) | 'kmeans++' (kmeans|| oversampling)

    # threshold sweep
    t_min: float = 0.02
    t_max: float = 0.80
    t_step: float = 0.02

    # large-scale
    subset_fraction: float = 0.01  # training-subset fraction
    redundancy_batch: int = 1_000_000  # full-corpus redundancy batch rows
    # checkpoint/resume (the reference restarts long pipelines from zero,
    # SURVEY.md §5; the large-scale pipeline checkpoints every stage under
    # {pth_log}/{file_name}_ckpt/ and --resume continues mid-phase)
    checkpoint: bool = True
    resume: bool = False

    # diagnostics (reference keeps these as commented-out call sites;
    # here they are a flag: per-query nprobe study + kNN-tail analysis)
    run_diagnostics: bool = False

    # index build: measure the zero-miss selection margin of the bf16/int8
    # screens on this dataset's queries (engine/calibrate.py) and persist it
    # in the artifact manifest; serving then defaults to the measured margin
    # instead of the shipped one (docs/bf16_screen.md: the zero-miss point
    # is data-dependent)
    calibrate_margin: bool = False

    # derived (filled by update())
    pth_log: str | None = None
    file_name: str | None = None
    log_name: str | None = None
    df_name: str | None = None

    def update(self) -> "Config":
        if self.dataset is None:
            raise ValueError("--dataset is required (e.g. --dataset sift)")
        if self.k is None:
            raise ValueError("--k is required (e.g. --k 10)")
        if self.n_bkt is None:
            raise ValueError("--n_bkt is required (e.g. --n_bkt 64)")

        self.dis_metric = _normalize_metric(self.dis_metric)

        self.pth_log = f"./logs/{self.dataset}/ML_kmeans_RE_FLAT/"
        self.file_name = (
            f"{self.dataset}-k={self.k}-ML_kmeans={self.n_bkt}_FLAT"
            f"_Metric={self.dis_metric}_ReType={self.duplicate_type}"
            f"_ReRatio={self.redundancy_ratio}"
        )
        self.log_name = f"{self.file_name}.txt"
        self.df_name = f"{self.file_name}.csv"
        return self


def _str2bool(s: str) -> bool:
    if s.lower() in ("1", "true", "yes", "y", "on"):
        return True
    if s.lower() in ("0", "false", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def add_config_args(parser: argparse.ArgumentParser, cls=Config) -> None:
    """Register every Config field as a CLI flag (types inferred)."""
    for f in dataclasses.fields(cls):
        if f.name in ("pth_log", "file_name", "log_name", "df_name"):
            continue
        default = f.default if f.default is not dataclasses.MISSING else None
        # Optional[int] etc.: infer the underlying type from the first non-None
        # (bool before int: isinstance(True, int) holds, and argparse's bare
        # `type=bool` would make `--flag False` truthy)
        if isinstance(default, bool) or f.type == "bool":
            ftype = _str2bool
        elif f.type in ("int | None", "int") or isinstance(default, int):
            ftype = int
        elif f.type in ("float | None", "float") or isinstance(default, float):
            ftype = float
        else:
            ftype = str
        # SUPPRESS: the namespace only carries flags the user actually
        # passed; dataclass defaults fill the rest.  parse_config records
        # the explicit set so entry points with different defaults (e.g.
        # largescale's n_epoch=30) can re-default WITHOUT clobbering an
        # explicitly passed value that happens to equal the base default.
        parser.add_argument(f"--{f.name}", type=ftype, default=argparse.SUPPRESS)


def parse_config(argv: list[str] | None = None, cls=Config) -> Config:
    parser = argparse.ArgumentParser(description=cls.__doc__)
    add_config_args(parser, cls)
    ns = parser.parse_args(argv)
    cfg = cls(**vars(ns))
    cfg._explicit = frozenset(vars(ns))  # flag names the user passed
    cfg.update()
    return cfg


def split_device(argv: list[str] | None = None) -> tuple[str, list[str]]:
    """(the `--device` flag, the other arguments) of a CLI of the port:
    'cuda' unless the caller passes `--device cpu` (lira_tpu picks its
    backend through JAX_PLATFORMS instead)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ns, rest = ap.parse_known_args(argv)
    return ns.device, rest
