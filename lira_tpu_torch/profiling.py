"""Tracing / profiling utilities (port of lira_tpu/profiling.py).

One recorder, on while a torch.profiler is recording and free otherwise:

  span(name)      a named stretch of host code.  Under a recording
                  profiler it is a `record_function`, so it lands in the
                  Chrome trace as a `user_annotation` event on the kernels'
                  clock, and the kernels launched inside it can be told
                  apart by their launches; otherwise it is one shared
                  no-op context.  `span(name, timed=True)` also adds the
                  span's host seconds to the counter `<name>.host_s`, for
                  a span that encloses no other.
  count(name, n)  adds n to an in-memory counter, under the same guard.
  counters()      the counters; `reset_counters()` clears them.

The guard is one `torch.autograd._profiler_enabled()` call (~0.1 µs); an
unguarded `record_function` costs ~10 µs even with no profiler.  Nothing
synchronises the device.  `device_trace` profiles a block and writes its
Chrome trace (spans included); `logging_utils.stage_timer` opens a span of
its stage.  The per-query ndis/nprobe counters are result fields of the
engines.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from . import resolve_device

_recording = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_counters: dict[str, float] = {}
_lock = threading.Lock()  # counters may be added to from several threads


def _add(name: str, n) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


class _Timed:
    """A `record_function` that adds its host seconds to `<name>.host_s`."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        took = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        _add(self.name + ".host_s", took)
        return False


def span(name: str, timed: bool = False):
    """A named span: see the module docstring."""
    if not _recording():
        return _NOOP
    return _Timed(name) if timed else torch.profiler.record_function(name)


def count(name: str, n) -> None:
    """Adds `n` to the counter `name` while a profiler is recording."""
    if _recording():
        _add(name, n)


def counters() -> dict[str, float]:
    """The counters recorded since the last `reset_counters()`."""
    return _counters


def reset_counters() -> None:
    with _lock:
        _counters.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Profile a block with torch.profiler and write a Chrome trace
    (`trace.json`, opened by chrome://tracing or Perfetto) into `log_dir`.
    CPU activity always, and CUDA activity when `device` is the card
    (`None`: the card, as every entry point of the port).  Yields the
    profiler, whose `key_averages()` sums time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the block's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
