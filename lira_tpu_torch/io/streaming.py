"""Streaming ingestion: disk → f32 chunks → device, without a host-resident
f32 corpus (port of lira_tpu/io/streaming.py).

The reference reads BIGANN-scale bvecs record by record in C++
(reference: compute_knn.cpp:113-140); a plain load widens the whole file to
float32 on the host first (51 GB for BIGANN-100M u8).  Here the file stays
a memmap, and fixed-size row chunks are widened one at a time into a
pinned staging buffer and copied into one preallocated device tensor, so
the host holds one chunk whatever the corpus size.

`stream_to_shards` (a corpus row-sharded over several devices) waits for
the port's parallel/ (ROADMAP.md queue A item 6).
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


def stream_to_device(
    src: str | XvecsStream,
    chunk_rows: int = 1 << 20,
    device=None,
) -> torch.Tensor:
    """Upload an xvecs file to one device as an (n, d) f32 tensor.

    Host memory holds one `chunk_rows` × d f32 chunk: on the card it is a
    pinned staging buffer, each chunk copied asynchronously into its rows
    of the preallocated device tensor (the next chunk is widened on the
    host while the copy runs; the buffer is reused only after its copy has
    finished).  lira_tpu's `dtype` and `pad_rows_to` are not taken: the
    port's one caller, `knn --streaming`, uses neither."""
    dev = resolve_device(device)
    stream = src if isinstance(src, XvecsStream) else XvecsStream(src)
    buf = torch.empty((stream.n, stream.dim), dtype=torch.float32, device=dev)
    if dev.type != "cuda":
        for s, chunk in stream.chunks(chunk_rows):
            buf[s : s + len(chunk)] = torch.tensor(chunk)  # a copy: fvecs chunks
            # are read-only views of the memmap
        return buf
    rows = min(chunk_rows, max(stream.n, 1))
    staging = [torch.empty((rows, stream.dim), dtype=torch.float32, pin_memory=True)
               for _ in range(2)]
    done = [None, None]
    cur = torch.cuda.current_stream(dev)
    for i, (s, chunk) in enumerate(stream.chunks(chunk_rows)):
        slot = i % 2
        if done[slot] is not None:
            done[slot].synchronize()  # the buffer's previous copy has finished
        host = staging[slot][: len(chunk)]
        host.numpy()[:] = chunk
        buf[s : s + len(chunk)].copy_(host, non_blocking=True)
        done[slot] = torch.cuda.Event()
        done[slot].record(cur)
    cur.synchronize()
    return buf


def base_file_path(data_path: str, dataset: str) -> str | None:
    """Locate the base/learn vectors file for a dataset (fvecs or bvecs)."""
    ddir = os.path.join(data_path, dataset)
    for kind in ("base", "learn"):
        for ext in ("fvecs", "bvecs"):
            p = os.path.join(ddir, f"{dataset}_{kind}.{ext}")
            if os.path.exists(p):
                return p
    return None
