"""ctypes bindings for the native host runtime (port of lira_tpu/native/).

`lira_native.cpp` (a copy of lira_tpu's, the same C ABI) is compiled with
g++ at first use into `native/_build/` (git-ignored), the library named by
a hash of its source, so an edited source is rebuilt and a stale library
is never loaded.  The build writes a temporary file and renames it into
place, so several ranks may build at once.  Nothing here runs at import
time.

Every caller keeps lira_tpu's numpy branch as its other arm: `available()`
says whether the native path is active (false when g++ is missing or the
build fails), and the entry points raise when it is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "lira_native.cpp"
BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-Wall", "-shared"]

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> Path:
    """Where the library is built: named by a hash of the source."""
    h = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"liblira_native_{h}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises with g++'s output if the compile fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    # g++ from PATH, as lira_tpu's Makefile names it; not $CXX, which may
    # name a compiler whose OpenMP runtime is not installed
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None  # no compiler, or the build failed: callers take numpy

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.csr_count.argtypes = [i32p, i64, i32, i32, i64p]
        lib.csr_count.restype = None
        lib.csr_fill.argtypes = [i32p, i64, i32, i32, i64p, i32p]
        lib.csr_fill.restype = None
        lib.probe_tile_counts.argtypes = [u8p, i64, i32, i64p, i64p]
        lib.probe_tile_counts.restype = None
        lib.probe_tile_fill.argtypes = [u8p, i64, i32, i64p, i64p, i64, i32p]
        lib.probe_tile_fill.restype = None
        lib.xvecs_strip_headers_f32.argtypes = [f32p, i64, i32, f32p]
        lib.xvecs_strip_headers_f32.restype = None
        lib.bvecs_to_f32.argtypes = [u8p, i64, i32, f32p]
        lib.bvecs_to_f32.restype = None
        lib.lira_native_version.argtypes = []
        lib.lira_native_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it now if
    it is not yet)."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ missing or the build failed)")
    return lib


def build_csr(d2b: np.ndarray, n_bkt: int) -> tuple[np.ndarray, np.ndarray]:
    """(offsets (n_bkt+1) int64, ids (total) int32) — sorted+dedup per bucket."""
    lib = _require()
    d2b = np.ascontiguousarray(d2b, dtype=np.int32)
    if d2b.ndim == 1:
        d2b = d2b[:, None]
    n, n_mul = d2b.shape
    counts = np.zeros(n_bkt, dtype=np.int64)
    lib.csr_count(d2b, n, n_mul, n_bkt, counts)
    offsets = np.zeros(n_bkt + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    ids = np.empty(int(offsets[-1]), dtype=np.int32)
    lib.csr_fill(d2b, n, n_mul, n_bkt, np.ascontiguousarray(offsets[:-1]), ids)
    return offsets, ids


def probe_tiles(probed: np.ndarray, tile_start: np.ndarray,
                tiles_per_bucket: np.ndarray) -> np.ndarray:
    """(B, T) int32 probed-tile lists (−1 padded), T = pow2 ceil of the max count."""
    lib = _require()
    probed = np.ascontiguousarray(probed, dtype=np.uint8)
    B, n_bkt = probed.shape
    ts = np.ascontiguousarray(tile_start, dtype=np.int64)
    tpb = np.ascontiguousarray(tiles_per_bucket, dtype=np.int64)
    if ts.shape != (n_bkt,) or tpb.shape != (n_bkt,):
        raise ValueError(f"probe_tiles: tile tables must be ({n_bkt},)")
    counts = np.empty(B, dtype=np.int64)
    lib.probe_tile_counts(probed, B, n_bkt, tpb, counts)
    t_max = max(int(counts.max()) if B else 0, 1)
    T = 1 << (t_max - 1).bit_length()
    out = np.full((B, T), -1, dtype=np.int32)
    lib.probe_tile_fill(probed, B, n_bkt, ts, tpb, T, out)
    return out


def fvecs_rows(raw_f32: np.ndarray, n: int, dim: int) -> np.ndarray:
    """Strip per-record dim headers from an fvecs buffer into (n, dim) float32."""
    lib = _require()
    raw = np.ascontiguousarray(raw_f32, np.float32)
    if raw.size < n * (dim + 1):
        raise ValueError(f"fvecs_rows: buffer of {raw.size} words < {n} records of {dim}")
    out = np.empty((n, dim), dtype=np.float32)
    lib.xvecs_strip_headers_f32(raw, n, dim, out)
    return out


def bvecs_rows(raw_u8: np.ndarray, n: int, dim: int) -> np.ndarray:
    """Widen a bvecs buffer to (n, dim) float32."""
    lib = _require()
    raw = np.ascontiguousarray(raw_u8, np.uint8)
    if raw.size < n * (dim + 4):
        raise ValueError(f"bvecs_rows: buffer of {raw.size} bytes < {n} records of {dim}")
    out = np.empty((n, dim), dtype=np.float32)
    lib.bvecs_to_f32(raw, n, dim, out)
    return out
