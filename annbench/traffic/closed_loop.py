"""Interactive retrieval: one client, closed loop, no think time; each
request is one `QueryEngine.search` of `request_queries` distinct queries.

Parameters: request_queries; max_qps, the fastest rate the pool of
distinct queries is sized for (a faster system spends the pool and its
window ends early); recall_sample, pool positions, spread evenly over the
pool, whose served queries the recall is read on; trace_from and trace_calls, the
requests a traced run profiles.
"""

from __future__ import annotations

import math

from annbench.core.loop import closed_loop


def plan(p: dict, seconds: float) -> dict:
    calls = math.ceil(p["max_qps"] * seconds / p["request_queries"]) + 1
    return {"pool": calls * p["request_queries"], "warmup": p["request_queries"]}


def call(engine, queries, threshold: float, k: int, p: dict):
    return engine.search(queries, threshold, k)


def run(engine, pool, threshold: float, k: int, p: dict, seconds: float, tracer=None):
    return closed_loop(lambda q: call(engine, q, threshold, k, p), pool,
                       p["request_queries"], seconds, tracer, p["trace_from"], p["trace_calls"])
