"""Bulk retrieval: one caller, closed loop, each call one
`QueryEngine.search_stream` over `call_queries` distinct queries in
batches of `batch_size`.

Parameters: call_queries, batch_size; max_qps, the fastest rate the pool
of distinct queries is sized for (a faster system spends the pool and its
window ends early); recall_sample, pool positions, spread evenly over the
pool, whose served queries the recall is read on; trace_from and trace_calls, the
calls a traced run profiles.
"""

from __future__ import annotations

import math

from annbench.core.loop import closed_loop


def plan(p: dict, seconds: float) -> dict:
    calls = math.ceil(p["max_qps"] * seconds / p["call_queries"]) + 1
    return {"pool": calls * p["call_queries"], "warmup": p["call_queries"]}


def call(engine, queries, threshold: float, k: int, p: dict):
    return engine.search_stream(queries, threshold, k, batch_size=p["batch_size"])


def run(engine, pool, threshold: float, k: int, p: dict, seconds: float, tracer=None):
    return closed_loop(lambda q: call(engine, q, threshold, k, p), pool, p["call_queries"],
                       seconds, tracer, p["trace_from"], p["trace_calls"])
