"""The closed loop that traffic drivers share: one caller, each call sent
when the last has returned, with no think time."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class Call:
    lo: int  # pool positions [lo, hi) that the call served
    hi: int
    start: float  # host clock (perf_counter) at the call
    end: float  # at its return, results on the host
    ids: np.ndarray  # (hi - lo, k) returned ids
    nprobe: np.ndarray
    ndis: np.ndarray


def closed_loop(fn, pool: np.ndarray, size: int, seconds: float, tracer=None,
                trace_from: int = 0, trace_calls: int = 0) -> tuple[list[Call], object]:
    """Calls fn(pool[lo:lo + size]) back to back over consecutive,
    never-repeated pool slices, until the first call that returns at least
    `seconds` after the first call began, or the pool is spent.  With a
    tracer, calls trace_from .. trace_from + trace_calls - 1 are traced
    (the loop runs on until they are).  Returns (calls, trace or None)."""
    calls: list[Call] = []
    trace = None
    t0 = None
    lo = 0
    while lo + size <= len(pool):
        i = len(calls)
        if tracer is not None and i == trace_from:
            tracer.start()
        start = time.perf_counter()
        if t0 is None:
            t0 = start
        res = fn(pool[lo : lo + size])
        end = time.perf_counter()
        calls.append(Call(lo, lo + size, start, end, res.ids, res.nprobe, res.ndis))
        lo += size
        if tracer is not None and i == trace_from + trace_calls - 1:
            trace = tracer.stop()
        traced = tracer is None or trace is not None
        if end - t0 >= seconds and traced:
            break
    if tracer is not None and trace is None and len(calls) > trace_from:
        trace = tracer.stop()  # the pool ran out inside the traced calls
    return calls, trace
