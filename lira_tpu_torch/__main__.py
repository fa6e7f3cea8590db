"""Unified CLI: python -m lira_tpu_torch <command> [args...]
(port of lira_tpu/__main__.py; every command runs on the card unless it
is given --device cpu)

Commands (each forwards to the matching pipeline module):
    smallscale   build + train + evaluate + redundancy + threshold sweeps
    largescale   subset training + full-corpus redundancy
    build        build an index and export serving artifacts
    search       load artifacts and run the serving threshold sweep
    knn          offline self-kNN precompute (exact or IVF-approximate)
    extract-k1   derive a smaller-k cache from an existing one
    batch        run an experiment grid over datasets × n_bkt
    parity       run pipeline + sweeps on a real dataset, diff vs a
                 reference-produced threshold-sweep CSV
    distributed  the sharded pipeline over --n_shards ranks (torch.distributed;
                 --backend nccl: one card a rank, gloo: ranks sharing a card
                 or on the CPU)

`search --n_shards N` serves an index from N ranks (the same backends).
"""

import importlib
import sys

COMMANDS = {
    "smallscale": ("lira_tpu_torch.pipelines.smallscale", "main"),
    "largescale": ("lira_tpu_torch.pipelines.largescale", "main"),
    "build": ("lira_tpu_torch.pipelines.build_index", "main"),
    "search": ("lira_tpu_torch.pipelines.search_cli", "main"),
    "knn": ("lira_tpu_torch.pipelines.compute_knn_cli", "main"),
    "extract-k1": ("lira_tpu_torch.pipelines.extract_k1", "main"),
    "batch": ("lira_tpu_torch.pipelines.batch", "main"),
    "parity": ("lira_tpu_torch.pipelines.parity", "main"),
    "distributed": ("lira_tpu_torch.pipelines.distributed", "main"),
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        raise SystemExit(1)
    mod_name, fn_name = COMMANDS[argv[0]]
    return getattr(importlib.import_module(mod_name), fn_name)(argv[1:])


if __name__ == "__main__":
    main()
