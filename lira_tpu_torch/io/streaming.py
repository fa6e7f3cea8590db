"""Streaming ingestion: disk → f32 chunks → device, without a host-resident
f32 corpus (port of lira_tpu/io/streaming.py).

The reference reads BIGANN-scale bvecs record by record in C++
(reference: compute_knn.cpp:113-140); a plain load widens the whole file to
float32 on the host first (51 GB for BIGANN-100M u8).  Here the file stays
a memmap, and fixed-size row chunks are widened one at a time into a
pinned staging buffer and copied into one preallocated device tensor, so
the host holds one chunk whatever the corpus size.

`stream_to_shards` does the same chunked pass for each rank of a
sharded run (parallel/mesh.py), over the rank's own row range and onto
the rank's own device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from .xvecs import read_xvecs


class XvecsStream:
    """Lazy row-chunk reader over an xvecs file (fvecs/bvecs/ivecs).

    The underlying array is a memmap view; `read(s, e)` materializes only
    rows [s, e) as float32."""

    def __init__(self, path: str):
        self.path = path
        self._view = read_xvecs(path)  # memmap-backed (n, d), raw dtype
        self.n, self.dim = self._view.shape

    def read(self, s: int, e: int) -> np.ndarray:
        return np.asarray(self._view[s:e], dtype=np.float32)

    def chunks(self, rows: int = 1 << 20):
        for s in range(0, self.n, rows):
            yield s, self.read(s, min(s + rows, self.n))


def _fill(buf: torch.Tensor, stream: XvecsStream, lo: int, hi: int, chunk_rows: int) -> None:
    """Rows [lo, hi) of the file into buf[: hi - lo], one chunk at a time.

    On the card each chunk is widened into a pinned staging buffer and
    copied asynchronously into its rows (the next chunk is widened on the
    host while the copy runs; a buffer is reused only after its copy has
    finished)."""
    dev = buf.device
    if dev.type != "cuda":
        for s in range(lo, hi, chunk_rows):
            chunk = stream.read(s, min(s + chunk_rows, hi))
            buf[s - lo : s - lo + len(chunk)] = torch.tensor(chunk)  # a copy: fvecs
            # chunks are read-only views of the memmap
        return
    rows = min(chunk_rows, max(hi - lo, 1))
    staging = [torch.empty((rows, stream.dim), dtype=torch.float32, pin_memory=True)
               for _ in range(2)]
    done = [None, None]
    cur = torch.cuda.current_stream(dev)
    for i, s in enumerate(range(lo, hi, chunk_rows)):
        chunk = stream.read(s, min(s + chunk_rows, hi))
        slot = i % 2
        if done[slot] is not None:
            done[slot].synchronize()  # the buffer's previous copy has finished
        host = staging[slot][: len(chunk)]
        host.numpy()[:] = chunk
        buf[s - lo : s - lo + len(chunk)].copy_(host, non_blocking=True)
        done[slot] = torch.cuda.Event()
        done[slot].record(cur)
    cur.synchronize()


def stream_to_device(
    src: str | XvecsStream,
    chunk_rows: int = 1 << 20,
    device=None,
) -> torch.Tensor:
    """Upload an xvecs file to one device as an (n, d) f32 tensor.

    Host memory holds one `chunk_rows` × d f32 chunk (`_fill`).  lira_tpu's
    `dtype` and `pad_rows_to` are not taken: the port's one caller,
    `knn --streaming`, uses neither."""
    dev = resolve_device(device)
    stream = src if isinstance(src, XvecsStream) else XvecsStream(src)
    buf = torch.empty((stream.n, stream.dim), dtype=torch.float32, device=dev)
    _fill(buf, stream, 0, stream.n, chunk_rows)
    return buf


def stream_to_shards(
    src: str | XvecsStream,
    mesh,
    chunk_rows: int = 1 << 20,
    rows_multiple: int = 128,
) -> tuple[torch.Tensor, int]:
    """This rank's row shard of an xvecs file on its own device: rank s
    holds rows [s·per, (s+1)·per), zero rows past n, `per` rounded up to
    `rows_multiple`.  Returns (its (per, d) f32 tensor, per); host memory
    holds one chunk whatever the corpus size (lira_tpu returns the global
    (n_dev, per, d) array of these shards)."""
    stream = src if isinstance(src, XvecsStream) else XvecsStream(src)
    per = -(-stream.n // mesh.size)
    per = -(-per // rows_multiple) * rows_multiple
    lo = min(mesh.rank * per, stream.n)
    hi = min(lo + per, stream.n)
    buf = torch.zeros((per, stream.dim), dtype=torch.float32, device=mesh.device)
    _fill(buf, stream, lo, hi, chunk_rows)
    return buf, per


def base_file_path(data_path: str, dataset: str) -> str | None:
    """Locate the base/learn vectors file for a dataset (fvecs or bvecs)."""
    ddir = os.path.join(data_path, dataset)
    for kind in ("base", "learn"):
        for ext in ("fvecs", "bvecs"):
            p = os.path.join(ddir, f"{dataset}_{kind}.{ext}")
            if os.path.exists(p):
                return p
    return None
