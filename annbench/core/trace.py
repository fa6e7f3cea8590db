"""The traced stretch of a run: torch.profiler over CPU and CUDA activity
with Python stacks, read back from its Chrome trace.

Every device operation (kernel, copy, fill) is kept with its interval and,
for kernels, the Python frames around its launch: the launch is the CPU
event with the kernel's correlation id, and the frames are the profiler's
Python function events that enclose it on the launching thread.  From
these: the device's busy time (the union of the intervals), device time by
kernel name or by launching function, and the idle gaps of the device
labelled by what the host's Python was doing meanwhile.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_OWN_CODE = ("lira_tpu_torch/", "annbench/")


def base_name(name: str) -> str:
    """A kernel's function name without its return type, namespace,
    template arguments and parameter list: `void ns::f<4, T>(int)` -> `f`."""
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    out, depth = [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip().split("::")[-1]


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name for the breakdown: without its parameter
    list, at most `width` characters."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


@dataclass
class DeviceOp:
    name: str
    start: float  # µs on the trace's clock
    dur: float  # µs
    frames: tuple  # Python frames around the launch, outermost first


class Trace:
    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        py_by_tid: dict = {}
        for e in xs:
            if e.get("cat") == "python_function":
                py_by_tid.setdefault(e.get("tid"), []).append(e)
        launch = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = e
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
        # the launching frames, a sweep per thread over launch times
        queries: dict = {}
        for i, e in enumerate(dev):
            ln = launch.get(e.get("args", {}).get("correlation"))
            if ln is not None:
                queries.setdefault(ln.get("tid"), []).append((float(ln["ts"]), i))
        frames = [()] * len(dev)
        for tid, qs in queries.items():
            for (_, i), st in zip(sorted(qs), _stacks(py_by_tid.get(tid, []), sorted(qs))):
                frames[i] = st
        self.ops = [DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), frames[i])
                    for i, e in enumerate(dev)]
        self.start = min((float(e["ts"]) for e in xs), default=0.0)
        self.end = max((float(e["ts"]) + float(e.get("dur", 0.0)) for e in xs), default=0.0)
        main = max(py_by_tid, key=lambda t: len(py_by_tid[t]), default=None)
        self._main_py = py_by_tid.get(main, [])
        self.busy_us, self.gaps = self._busy_and_gaps()

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def _busy_and_gaps(self):
        busy, cur_end, gaps = 0.0, self.start, []
        for s, e in sorted((op.start, op.start + op.dur) for op in self.ops):
            if s > cur_end:
                gaps.append((cur_end, s))
            if e > cur_end:
                busy += e - max(s, cur_end)
                cur_end = e
        if self.end > cur_end:
            gaps.append((cur_end, self.end))
        return busy, gaps

    def device_s(self, kernels=None, within=None, exclude=()) -> float:
        """Device seconds of kernels whose base name is in `kernels` (all
        device operations when None), or, with `within`, of kernels launched
        inside a Python function whose frame name matches one of `within`'s
        regular expressions; base names in `exclude` never count."""
        pats = [re.compile(p) for p in (within or ())]
        total = 0.0
        for op in self.ops:
            b = base_name(op.name)
            if b in exclude:
                continue
            if kernels is not None and b not in kernels:
                continue
            if pats and not any(p.search(f) for f in op.frames for p in pats):
                continue
            total += op.dur
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """{"device_ops": [[name, s], ...], "idle_gaps": [[host activity, s],
        ...]}: the device operations that took most time, and the device's
        idle time summed by the innermost frame of this repository's code
        (else the innermost frame) that the host was in at each gap's middle."""
        by_op: dict = {}
        for op in self.ops:
            key = short_name(op.name)
            by_op[key] = by_op.get(key, 0.0) + op.dur / 1e6
        mids = sorted(((s + e) / 2, e - s) for s, e in self.gaps)
        by_gap: dict = {}
        for (_, width), st in zip(mids, _stacks(self._main_py, [(m, i) for i, (m, _) in
                                                                enumerate(mids)])):
            own = [f for f in st if any(c in f for c in _OWN_CODE)]
            label = (own or list(st) or ["(no Python frame)"])[-1]
            by_gap[label] = by_gap.get(label, 0.0) + width / 1e6
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(by_op), "idle_gaps": pick(by_gap)}


def _stacks(py: list[dict], times: list[tuple]) -> list[tuple]:
    """For each (time, _) of `times` (sorted), the names of the Python
    function events of `py` that enclose it, outermost first."""
    evs = sorted(py, key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
    out, stack, j = [], [], 0
    for t, _ in times:
        while j < len(evs) and float(evs[j]["ts"]) <= t:
            ev = evs[j]
            ts = float(ev["ts"])
            while stack and stack[-1][1] <= ts:
                stack.pop()
            stack.append((ev["name"], ts + float(ev.get("dur", 0.0))))
            j += 1
        out.append(tuple(name for name, end in stack if end >= t))
    return out


class Profiler:
    """Starts and stops torch.profiler around the traced stretch; `stop`
    returns the `Trace`, read from a Chrome trace file written to the
    temporary directory and deleted."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts, with_stack=True)

    def start(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.start()

    def stop(self) -> Trace:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="annbench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        return Trace(doc["traceEvents"] if isinstance(doc, dict) else doc)
