"""xvecs family (fvecs/ivecs/bvecs) readers and writers.

File format: each record is a little-endian int32 dimension header followed
by `dim` payload elements (float32 / int32 / uint8).  Capability parity with
the reference readers (reference: utils.py:23-39, search.cpp:86-166,
compute_knn.cpp:13-52); implementation here is a zero-copy memmap view.
"""

from __future__ import annotations

import os

import numpy as np

# payload dtype for each extension
_EXT_DTYPE = {
    "fvecs": np.float32,
    "ivecs": np.int32,
    "bvecs": np.uint8,
}


def _dtype_for(path: str, dtype: str | np.dtype | None) -> np.dtype:
    if dtype is not None:
        return np.dtype(dtype)
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    if ext in _EXT_DTYPE:
        return np.dtype(_EXT_DTYPE[ext])
    raise ValueError(f"Cannot infer xvecs dtype from extension: {path}")


def read_xvecs(file_path: str, dtype: str | np.dtype | None = None) -> np.ndarray:
    """Read an xvecs file as an (n, dim) array (memmap-backed view).

    The dtype is inferred from the file extension (.fvecs → float32,
    .ivecs → int32, .bvecs → uint8) unless given explicitly.
    """
    if not os.path.exists(file_path):
        raise FileNotFoundError(f"File not found: {file_path}")
    dt = _dtype_for(file_path, dtype)

    if dt == np.uint8:
        # bvecs: 4-byte dim header + dim bytes
        raw = np.memmap(file_path, dtype=np.uint8, mode="r")
        if raw.size < 4:
            raise ValueError(f"Truncated xvecs file: {file_path}")
        d = int(raw[:4].view(np.int32)[0])
        record = 4 + d
        if raw.size % record != 0:
            raise ValueError(f"Invalid bvecs file size: {file_path}")
        return raw.reshape(-1, record)[:, 4:]

    # 4-byte element payloads (fvecs/ivecs): header and element same width
    raw = np.memmap(file_path, dtype=np.int32, mode="r")
    if raw.size == 0:
        raise ValueError(f"Empty xvecs file: {file_path}")
    d = int(raw[0])
    if d <= 0 or raw.size % (d + 1) != 0:
        raise ValueError(f"Invalid xvecs file layout: {file_path}")
    return raw.view(dt).reshape(-1, d + 1)[:, 1:]


def write_xvecs(file_path: str, x: np.ndarray) -> None:
    """Write an (n, dim) array in the matching xvecs format.

    The payload dtype is taken from the file extension.
    """
    dt = _dtype_for(file_path, None)
    x = np.ascontiguousarray(x, dtype=dt)
    n, d = x.shape
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    if dt == np.uint8:
        out = np.empty((n, 4 + d), dtype=np.uint8)
        out[:, :4] = np.full((n, 1), d, dtype=np.int32).view(np.uint8)
        out[:, 4:] = x
    else:
        out = np.empty((n, d + 1), dtype=np.int32)
        out[:, 0] = d
        out[:, 1:] = x.view(np.int32)
    out.tofile(file_path)
