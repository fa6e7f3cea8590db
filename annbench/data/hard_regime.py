"""The repo's hard-regime corpus (`HARD_REGIME` of the port's
`io/datasets.py`), drawn with torch on the device from a seed.

A Gaussian mixture in a low-dimensional latent space, embedded in `dim`
dimensions through an orthonormal map, plus isotropic ambient noise;
queries are corpus rows' latent points plus query noise, embedded the same
way.  The kNN of a query straddle many K-Means cells, so recall needs many
probed buckets.

The dataset is fixed by the configuration's `data_seed`, as a public
dataset is: the mixture (cluster centres and the embedding, drawn on the
CPU), the corpus rows and the dataset's own queries (`dataset_queries`:
those that set the threshold or feed the build), so every run builds the
same index at the same operating point.  The traffic (`queries`) comes
from the run's seed.  Rows and queries are drawn with generators on the
run's device, in a few large calls, each stream of its own, so no set
depends on how many queries another takes.
"""

from __future__ import annotations

import torch

MIX_KEYS = ("dim", "n_clusters", "intrinsic_dim", "center_scale", "noise_scale",
            "query_noise", "ambient_noise", "data_seed")
_CHUNK = 1 << 21  # rows embedded at a time: bounds the latent-noise temporaries


class HardRegime:
    """Draws a corpus and query sets for one run.

    spec: the configuration's `data` block (`MIX_KEYS`); seed: the run's
    seed, for the traffic (any non-negative integer below 2**61)."""

    def __init__(self, spec: dict, seed: int, device):
        missing = [k for k in MIX_KEYS if k not in spec]
        if missing:
            raise ValueError(f"hard_regime: the data block lacks {missing}")
        self.spec = spec
        self.device = torch.device(device)
        mix = torch.Generator().manual_seed(int(spec["data_seed"]))
        d_lat, dim = int(spec["intrinsic_dim"]), int(spec["dim"])
        centers = torch.randn(int(spec["n_clusters"]), d_lat, generator=mix,
                              dtype=torch.float64) * float(spec["center_scale"])
        proj, _ = torch.linalg.qr(torch.randn(dim, d_lat, generator=mix, dtype=torch.float64))
        self.centers = centers.float().to(self.device)
        self.proj_t = proj.T.contiguous().float().to(self.device)  # (d_lat, dim)
        data_seed = int(spec["data_seed"])
        self.g_base = torch.Generator(self.device).manual_seed(4 * data_seed)
        self.g_fixed = torch.Generator(self.device).manual_seed(4 * data_seed + 1)
        self.reseed(seed)
        self.latent = None

    def _embed(self, latent: torch.Tensor, g: torch.Generator) -> torch.Tensor:
        out = torch.empty(latent.shape[0], self.proj_t.shape[1], device=self.device)
        amb = float(self.spec["ambient_noise"])
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for s in range(0, latent.shape[0], _CHUNK):
                blk = latent[s : s + _CHUNK] @ self.proj_t
                if amb > 0.0:
                    blk += torch.randn(blk.shape, generator=g, device=self.device) * amb
                out[s : s + _CHUNK] = blk
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return out

    def corpus(self, n: int) -> torch.Tensor:
        """(n, dim) f32 corpus rows on the device; call once, before queries."""
        if self.latent is not None:
            raise RuntimeError("hard_regime: the corpus is drawn once per run")
        g = self.g_base
        assign = torch.randint(0, self.centers.shape[0], (n,), generator=g, device=self.device)
        self.latent = self.centers[assign]
        self.latent += torch.randn(self.latent.shape, generator=g, device=self.device) * float(
            self.spec["noise_scale"])
        return self._embed(self.latent, g)

    def dataset_queries(self, m: int) -> torch.Tensor:
        """(m, dim) f32 queries of the dataset itself (fixed by data_seed)."""
        return self._queries(m, self.g_fixed)

    def queries(self, m: int) -> torch.Tensor:
        """(m, dim) f32 queries of the run's traffic (from the run's seed)."""
        return self._queries(m, self.g_query)

    def _queries(self, m: int, g: torch.Generator) -> torch.Tensor:
        """Latent points of uniformly drawn corpus rows plus query noise,
        embedded: every query is new."""
        if self.latent is None:
            raise RuntimeError("hard_regime: draw the corpus before its queries")
        src = torch.randint(0, self.latent.shape[0], (m,), generator=g, device=self.device)
        lat = self.latent[src]
        lat += torch.randn(lat.shape, generator=g, device=self.device) * float(
            self.spec["query_noise"])
        return self._embed(lat, g)

    def reseed(self, seed: int) -> None:
        """Restarts the traffic stream as a run with `seed` draws it, so one
        process can read several seeds' traffic on one corpus."""
        if not 0 <= int(seed) < 1 << 61:
            raise ValueError(f"seed {seed} outside [0, 2**61)")
        self.g_query = torch.Generator(self.device).manual_seed(4 * int(seed) + 2)

    def release(self) -> None:
        """Frees the latent corpus (queries can no longer be drawn)."""
        self.latent = None


make = HardRegime  # the generator the harness finds by name
