"""lira_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of lira_tpu.

Module paths and public names follow `lira_tpu`, so each piece has an
obvious counterpart there.  The package imports torch and numpy only:
never jax, and never a module of `lira_tpu` (the JAX package is the
reference the port is tested against, not a dependency).

Layer map (every module of lira_tpu is ported; `python -m lira_tpu_torch
<command>` runs the pipelines and CLIs):

    pipelines/  run_smallscale (build → train → redundancy → sweeps),
                run_largescale (subset training, full-corpus redundancy,
                resumable), build_index / run_search (artifacts written
                once, served many times; --n_shards serves from several
                ranks), run_distributed (every heavy stage over the
                ranks), compute_knn_cli, extract_k1, batch, parity
    parallel/   the sharded path on torch.distributed: ranks spawned by
                `launch` (a Mesh each), data-parallel training, sharded
                kNN (K2) and K-Means, the sharded engine (K1 on every rank,
                one all-gather merge)
    io/         fvecs/ivecs/bvecs, synthetic corpora (byte-identical to
                lira_tpu's), the self-kNN cache, the index artifacts and
                TorchScript export (either package reads the other's), the
                chunked disk → device reader
    ops/        distances, a top-k with lax.top_k's tie rule, exact kNN,
                the fused two-round kNN with the K2 group-min kernel
    partition/  K-Means (Lloyd on the card), bucket layout, locality tour
    labels/     kNN → bucket labels, distance-feature standardizer
    models/     probing MLP as an nn.Module, its training loops, metrics,
                TrainState checkpoints with lira_tpu's keys
    redundancy/ model-chosen replicas of boundary points
    engine/     QueryEngine with three scan paths: 'blocked' (the K1
                screen; f32/bf16/int8, and capacity mode: one bf16/int8
                table, host re-rank), per-query 'xla' (plain torch) and
                per-query 'pallas' (the K3 probed-tile kernel); a
                pluggable prober and the IVF baseline; calibration,
                tuning, the per-bucket evaluation scan and sweep
    csrc/       hand-written CUDA kernels (K1, K2, K3), built with nvcc at
                first use
    native/     the host runtime (CSR build, tile lists, xvecs parsers),
                built with g++ at first use; profiling.py: spans and
                counters (free unless a torch.profiler records), traces

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import contextlib

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`None` → cuda.  Raises when cuda is asked for and no card is present:
    the port never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lira_tpu_torch: no CUDA device is available; pass device='cpu' "
                "to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def true_fp32():
    """Context (and decorator) for the port's f32 products: TF32 off for
    matmuls and convolutions inside it, the caller's settings restored on
    exit.  lira_tpu's f32 paths run at precision="highest" (true fp32), and
    TF32 keeps ~3 decimal digits, enough to reorder near-ties."""
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv
