"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
for Hopper (`sm_90a`) into a shared library loaded with ctypes — no
PyTorch headers, so a build takes seconds.  Libraries are built at first
use into `csrc/_build/` (git-ignored), named by a hash of their source and
of the shared headers (`csrc/*.cuh`), so an edited source or header is
rebuilt and a stale library is never loaded.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}  # one load per library per process


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` is built: named by a hash of
    the source and of every `csrc/*.cuh` (the headers it may include), so
    an edited header rebuilds it too."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: list[str]) -> dict[str, dict]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together.  Returns {name: {"path", "seconds",
    "ptxas"}} (nvcc's -Xptxas -v report).  Raises with nvcc's output if
    one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info, procs = {}, {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            info[name] = {"path": str(out), "seconds": 0.0, "ptxas": "(already built)"}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        info[name] = {"path": str(out), "seconds": time.perf_counter() - t0,
                      "ptxas": log.strip()}
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
        return lib
