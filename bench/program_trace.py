"""The program's own spans in a traced run, for the per-layer metrics
that read them, and the device's idle time named by them.

The program (`repro_torch.trace`) records its spans while
`torch.profiler` traces the window: `MANARuntime.run` and `.restore`
turn recording on for their own duration when a profiler session is
active.  Its host times are on the wall clock of the profiler's events,
so the idle gaps of `run.trace` can be laid over them; a span opened
with `device=True` also carries its device interval (`dev_start_ns`,
`dev_end_ns`) on that clock.  A run that was not traced, or a program
without the recorder, has no spans: `spans(run)` gives None, and every
reader that uses it returns None.

A gap of the device's idle time is named by the innermost span open at
each of its instants: the latest-started span of the thread that runs
the training loop or the restore (whose spans have top-level ones)
where that thread has one open, else the latest-started span of
another thread (the image writer's), else "none"; of two that started
together, the one nested deeper.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional


def spans(run) -> Optional[List[dict]]:
    """The program's spans of the run (dicts as `repro_torch.trace.spans`
    gives them), or None where it has none."""
    got = getattr(run, "program_spans", None)
    if got is None:
        got = []
        if run.trace is not None:
            try:
                from repro_torch import trace
            except ImportError:         # a program without the recorder
                pass
            else:
                got = trace.spans()
        run.program_spans = got
    return got or None


def named(sp: List[dict], name: str) -> List[dict]:
    return [s for s in sp if s["name"] == name]


def descendants(sp: List[dict], root: dict) -> List[dict]:
    """Every span under `root`, by the parent links."""
    kids: Dict[int, List[dict]] = {}
    for s in sp:
        kids.setdefault(s["parent"], []).append(s)
    out, todo = [], [root["id"]]
    while todo:
        for s in kids.get(todo.pop(), []):
            out.append(s)
            todo.append(s["id"])
    return out


def host_s(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e9


def device_s(s: dict) -> Optional[float]:
    if s.get("dev_start_ns") is None:
        return None
    return (s["dev_end_ns"] - s["dev_start_ns"]) / 1e9


def median_device_s(run, name: str) -> Optional[float]:
    """The median over the run's spans `name` of their device seconds."""
    sp = spans(run)
    got = [device_s(s) for s in named(sp or [], name)]
    got = [t for t in got if t is not None]
    return statistics.median(got) if got else None


def window_image(run) -> Optional[dict]:
    """The span "image.write" of the window's image (the last one)."""
    writes = named(spans(run) or [], "image.write")
    return max(writes, key=lambda s: s["start_ns"]) if writes else None


def image_host_s(run, *names: str) -> Optional[float]:
    """Host seconds of the window's image's writer spans `names`."""
    write = window_image(run)
    if write is None:
        return None
    return sum(host_s(s) for s in descendants(spans(run), write)
               if s["name"] in names)


def restore_host_s(run, name: str) -> Optional[float]:
    """The mean over the run's restores of the host seconds of the spans
    `name` inside each."""
    sp = spans(run) or []
    per = [sum(host_s(s) for s in descendants(sp, r) if s["name"] == name)
           for r in named(sp, "restore")]
    return statistics.fmean(per) if per else None


# ---------------------------------------------------------------------------
# the device's idle time
# ---------------------------------------------------------------------------

class Idle:
    """The idle gaps of `run.trace` ((start ns, end ns), disjoint), with
    the idle nanoseconds of any interval."""

    def __init__(self, gaps):
        gaps = sorted(gaps)
        self.starts = [a for a, _ in gaps]
        self.ends = [b for _, b in gaps]
        self.cum = [0]
        for a, b in gaps:
            self.cum.append(self.cum[-1] + b - a)

    def ns(self, a: int, b: int) -> int:
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0
        return (self.cum[j] - self.cum[i] - max(0, a - self.starts[i])
                - max(0, self.ends[j - 1] - b))


def step_idle_ms(run) -> Optional[float]:
    """The mean over the window's steps (the "step" spans that ran a
    train step) of the device's idle ms inside each, less its
    "step.callback" spans (the caller's own functions)."""
    sp = spans(run)
    if sp is None or run.trace is None:
        return None
    idle = Idle(run.trace["gaps"])
    per = []
    for step in named(sp, "step"):
        inside = descendants(sp, step)
        if not named(inside, "step.forward"):
            continue
        ns = idle.ns(step["start_ns"], step["end_ns"])
        ns -= sum(idle.ns(c["start_ns"], c["end_ns"])
                  for c in named(inside, "step.callback"))
        per.append(ns / 1e6)
    return statistics.fmean(per) if per else None


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """The window's device idle seconds by the innermost program span
    open (see the module's doc), "none" outside every span."""
    sp = spans(run)
    if sp is None or run.trace is None:
        return None
    idle = Idle(run.trace["gaps"])
    loop = {s["thread"] for s in sp if s["parent"] is None}
    by_id = {s["id"]: s for s in sp}
    depth: Dict[int, int] = {}
    for s in sp:
        d, p = 0, s["parent"]
        while p in by_id:
            d, p = d + 1, by_id[p]["parent"]
        depth[s["id"]] = d
    marks = sorted({t for s in sp for t in (s["start_ns"], s["end_ns"])})
    by_start = sorted(sp, key=lambda s: s["start_ns"])
    ns: Dict[str, int] = {}
    open_, k = [], 0
    for a, b in zip(marks, marks[1:]):
        while k < len(by_start) and by_start[k]["start_ns"] <= a:
            open_.append(by_start[k])
            k += 1
        open_ = [s for s in open_ if s["end_ns"] > a]
        inner = max(open_, key=lambda s: (s["thread"] in loop,
                                          s["start_ns"], depth[s["id"]]),
                    default=None)
        name = inner["name"] if inner is not None else "none"
        ns[name] = ns.get(name, 0) + idle.ns(a, b)
    ns["none"] = ns.get("none", 0) + idle.cum[-1] - sum(ns.values())
    return {k: v / 1e9 for k, v in sorted(ns.items(), key=lambda kv: -kv[1])
            if v > 0}
