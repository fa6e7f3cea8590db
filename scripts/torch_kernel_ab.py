"""Time the port's K1, K2 and K3 kernels at fixed shapes, for comparing
two checkouts on one card.

    python3 scripts/torch_kernel_ab.py [--tree DIR] [--tag NAME]

Imports `lira_tpu_torch` from DIR (default: this checkout), builds its
kernels, and prints one line `AB {...}`: ms per call (CUDA events, mean of
3 after a warm-up) of K2 in each mode (8192 queries × 1M rows, d 128, L2;
"default" on f32 inputs, which the wrapper rounds to bf16, and, where the
tree's K2 takes them, on the bf16 table as knn_fused passes it)
and of K1 in each dtype (8 query blocks of 1024 × U 256 with 1,498 live
slots, d 128, L2), plus K1 f32 at d 960 with 23 live slots, and of K3
(`pallas_probed_scan`, the whole call) at chip_smoke.py's K3 grid shape:
2048 queries × 64-slot lists over 4096 tiles, d 128, k 20, L2, with -1
holes, a tile listed twice and one tile in every list.  Inputs come from
fixed seeds.  To compare two commits, unpack the other one (`git
archive`) into a git-ignored directory and run the script once per tree,
in turns (A, B, B, A), in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def time_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose lira_tpu_torch is timed (default: this one)")
    ap.add_argument("--tag", default="this", help="name printed with the times")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from lira_tpu_torch import true_fp32
    from lira_tpu_torch.engine.block_scan import screen_queries
    from lira_tpu_torch.engine.pallas_scan import pallas_probed_scan
    from lira_tpu_torch.engine.screen import screen_norms, union_groupmin
    from lira_tpu_torch.kernels import build
    from lira_tpu_torch.ops.groupmin import groupmin
    from lira_tpu_torch.ops.knn_pallas import _pad_and_norms, _quantize_corpus

    build(["union_groupmin", "groupmin", "probed_scan"])
    dev = torch.device("cuda")
    res = {"tree": args.tag, "device": torch.cuda.get_device_name(0)}
    with true_fp32():
        g = torch.Generator().manual_seed(0)
        n = 1_000_000
        base_p, bsq = _pad_and_norms(torch.randn(n, 128, generator=g).to(dev),
                                     -(-n // 128) * 128, True)
        q = base_p[:8192].contiguous()
        for mode in ("highest", "default"):
            res[f"K2 {mode}"] = time_ms(lambda: groupmin(q, base_p, bsq, metric="L2",
                                                         precision=mode))
        # "default" on the bf16 table and its slice, as knn_fused passes them
        # since K2's tensor-core rebuild (earlier trees take f32 only)
        base_b = base_p.to(torch.bfloat16)
        q_b = base_b[:8192]
        try:
            groupmin(q_b, base_b, bsq, metric="L2", precision="default")
        except TypeError:
            pass
        else:
            res["K2 default bf16 table"] = time_ms(lambda: groupmin(
                q_b, base_b, bsq, metric="L2", precision="default"))
        del base_b, q_b
        dim_scale, base8 = _quantize_corpus(base_p)
        qp = q * dim_scale[None, :]
        t = torch.clamp_min(qp.abs().amax() / 127.0, 1e-30)
        q8 = torch.clamp(torch.round(qp / t), -127, 127).to(torch.int8)
        t_eff = (2 * t).reshape(1, 1)
        res["K2 int8"] = time_ms(lambda: groupmin(q8, base8, bsq, metric="L2", t_eff=t_eff))
        del base_p, bsq, base8

        rows, U, qb, d, n_super = 8, 256, 1024, 128, 900
        xc = torch.randn(n_super * 1024, d, generator=g).to(dev)
        qf = torch.randn(rows * qb, d, generator=g).to(dev)
        supers = torch.randint(0, n_super, (rows, U), generator=g, dtype=torch.int32).to(dev)
        ulen = torch.tensor([U, 200, 180, U, 100, 250, 0, U], dtype=torch.int32, device=dev)
        ds = torch.clamp_min(xc.abs().amax(0), 1e-30) / 127.0
        x8 = torch.clamp(torch.round(xc / ds), -127, 127).to(torch.int8)
        for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                            (torch.int8, "int8")):
            qq, t_k1, s2 = screen_queries(qf, dtype, ds, "L2")
            corpus = x8 if dtype == torch.int8 else xc.to(dtype)
            xsq = screen_norms(corpus, s2)
            for sel in ((32, 64) if dtype == torch.float32 else (32,)):
                res[f"K1 {name} sel{sel}"] = time_ms(lambda: union_groupmin(
                    qq, corpus, supers, ulen, qb=qb, metric="L2", sel_rows=sel, t_eff=t_k1,
                    s2=s2, xsq=xsq))

        g9 = torch.Generator().manual_seed(7)
        x9 = torch.randn(16 * 1024, 960, generator=g9).to(dev)
        q9 = torch.randn(2 * 256, 960, generator=g9).to(dev)
        s9 = torch.randint(0, 16, (2, 16), generator=g9, dtype=torch.int32).to(dev)
        u9 = torch.tensor([16, 7], dtype=torch.int32, device=dev)
        x9sq = (x9 * x9).sum(1)
        res["K1 float32 d960"] = time_ms(lambda: union_groupmin(
            q9, x9, s9, u9, qb=256, metric="L2", sel_rows=32, xsq=x9sq), 5)
        del x9

        g3 = torch.Generator().manual_seed(9)
        n_tiles, B, T = 4096, 2048, 64
        corpus = torch.randn(n_tiles, 128, d, generator=g3).to(dev)
        ids = torch.arange(n_tiles * 128, dtype=torch.int32).view(n_tiles, 128)
        ids[-1, 77:] = -1
        tiles = torch.randint(0, n_tiles, (B, T), generator=g3, dtype=torch.int32)
        tiles[torch.rand(B, T, generator=g3) < 0.25] = -1
        tiles[:, 1] = tiles[:, 0]
        tiles[::7, 2] = n_tiles - 1
        tiles[:, 4] = 5
        tiles[3] = -1
        q3 = torch.randn(B, d, generator=g3).to(dev)
        ids, tiles = ids.to(dev), tiles.to(dev)
        sq = torch.where(ids >= 0, (corpus * corpus).sum(-1), 3e38)
        res["K3 float32 k20"] = time_ms(lambda: pallas_probed_scan(q3, tiles, corpus, ids, sq,
                                                                   20, "L2"), 10)
    print("AB " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
