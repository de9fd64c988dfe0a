"""Per-step sums of the program's spans in a traced run (beside
`bench.program_trace`): spans that run inside a step's backward on
autograd's own thread are no descendants of the step's span, so they
are found by time, each in the step whose host interval holds its
start."""
from __future__ import annotations

import statistics
from typing import Optional

from bench.program_trace import descendants, device_s, named, spans


def median_step_device_s(run, *names: str) -> Optional[float]:
    """The median over the window's train steps (the program's "step"
    spans that hold a "step.forward") of the device seconds of the spans
    `names` that start inside each; None where the run has none."""
    sp = spans(run)
    if sp is None:
        return None
    got = [(s["start_ns"], device_s(s)) for s in sp if s["name"] in names]
    got = [(t, d) for t, d in got if d is not None]
    if not got:
        return None
    per = []
    for step in named(sp, "step"):
        if named(descendants(sp, step), "step.forward"):
            per.append(sum(d for t, d in got
                           if step["start_ns"] <= t < step["end_ns"]))
    return statistics.median(per) if per else None
