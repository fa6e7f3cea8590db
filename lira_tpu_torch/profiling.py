"""Tracing / profiling utilities (port of lira_tpu/profiling.py).

Stage timers (logging_utils.stage_timer) are complemented by device
profiling through torch.profiler, and by the per-query ndis/nprobe
counters that the engines return as result fields.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from . import resolve_device


@contextmanager
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


@dataclass
class StageStats:
    """Accumulates named stage wall times across a pipeline run."""

    times: dict = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # record on exceptions too: otherwise report() silently
            # attributes 100% of wall time to the stages that succeeded
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [f"{name}: {t:.3f}s ({100 * t / total:.1f}%)" for name, t in sorted(self.times.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)
