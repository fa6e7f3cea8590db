"""Dual console+file logging, ASCII tables, and stage timers.
(own copy of lira_tpu/logging_utils.py)

Capability parity with the reference's fprint dual logger (utils.py:217-220)
and PrettyTable epoch tables (LIRA_smallscale.py:126-129), dependency-free
but for the stage timers' spans (profiling.py).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import IO, Iterable, Sequence

from .profiling import span


def fprint(message, file: IO | None = None) -> None:
    """Print to stdout and, if given, append to an open log file."""
    print(message)
    if file:
        print(message, file=file)
        file.flush()


def ascii_table(headers: Sequence[str], rows: Iterable[Sequence], float_fmt: str = "{:.4f}") -> str:
    """Render a boxed ASCII table (PrettyTable-style) without dependencies."""

    def fmt(v):
        if isinstance(v, float):
            return float_fmt.format(v)
        return str(v)

    srows = [[fmt(v) for v in row] for row in rows]
    widths = [len(h) for h in headers]
    for row in srows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    out.append("|" + "|".join(f" {h:^{w}} " for h, w in zip(headers, widths)) + "|")
    out.append(sep)
    for row in srows:
        out.append("|" + "|".join(f" {c:>{w}} " for c, w in zip(row, widths)) + "|")
    out.append(sep)
    return "\n".join(out)


@contextmanager
def stage_timer(name: str, file: IO | None = None):
    """Wall-clock bracket around a pipeline stage, logged via fprint, and a
    `profiling.span` of the stage's name (so the stage shows in a trace).
    Logs on exceptions too — the failing stage's elapsed time is exactly
    the line needed to diagnose where a long run died."""
    start = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        fprint(f">> {name} time: {time.perf_counter() - start:.4f}s", file)
