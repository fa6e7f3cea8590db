"""Spans the program writes as text: the port's stage timers print
`>> <stage> time: <seconds>s` (`logging_utils.stage_timer`)."""

from __future__ import annotations

import re

_STAGE = re.compile(r"^>> (.+) time: ([0-9.eE+-]+)s$", re.M)


def stage_spans(text: str) -> dict[str, float]:
    """{stage: seconds}, summed over repeats of a stage."""
    out: dict[str, float] = {}
    for name, sec in _STAGE.findall(text):
        out[name] = out.get(name, 0.0) + float(sec)
    return out
