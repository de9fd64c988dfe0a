"""Spans of the program's own layers: the training step, the safe point,
the image writer and restore, and the Mamba-2 mixers, on the clock
`torch.profiler` stamps.

    from repro_torch import trace

    with trace.recording():
        rt.run(10)
    for s in trace.spans():
        print(s["name"], s["end_ns"] - s["start_ns"], s["dev_start_ns"])

The modules that do the work open the spans where it happens:

    with trace.span("image.file", bytes=n):
        f.write(host)

The Mamba-2 mixers of a `layer_types` hybrid (`repro_torch.models.mamba2`)
open four, each with its device interval and the attributes `layer`,
`seq` and `chunk`: "mixer.mamba" around each mixer's forward (its
recompute under remat too) and "mixer.mamba.ssd" around its SSD core
inside it; "mixer.mamba.backward" and "mixer.mamba.ssd.backward" around
their backward, opened where the gradient reaches the region's output
and closed where its inputs' gradients are made (on autograd's thread
on a card, children of the forward span).  The benchmark's layer "model
step" reads them (`ssm_mixer_s`, `ssd_core_s`).

Recording is off by default.  Then `span` is one flag test that returns
a shared no-op context: nothing is kept, no CUDA event is made, nothing
is synchronised.  `recording()` turns it on for the whole process (the
image writer's thread records too) for the duration of its block.
`MANARuntime.run` and `MANARuntime.restore` enter `when_profiled()`,
which records for their own duration when a `torch.profiler` session is
active, so a profiled job gets the program's spans beside the
profiler's events, on one clock.

Each span is a dict: `id`; `parent`, the id of the span that encloses
it on its thread or of the one passed in (None at the top); `name`;
`thread` (the thread's name); `start_ns` and `end_ns` from
`time.time_ns()`, the wall clock the profiler's events are stamped on;
`attrs` (such as `step`, `path`, `bytes`); and `dev_start_ns`,
`dev_end_ns`.  A span opened with `device=True` in a process that has
initialised CUDA records a pair of CUDA events on the current stream:
its device interval, from the moment the device reached the work queued
before the span to the moment it finished the work queued inside it.
The events are resolved in `spans()`, never where the span closes,
onto the wall clock through an anchor event recorded right after a
`torch.cuda.synchronize()` when recording starts: anchor wall ns +
the anchor's elapsed time to the event (the anchor's wall ns is the
middle of the few microseconds between its record and the poll that
found it done).  Elsewhere both are None.  One
anchor serves one device: spans of a process that drives one card.

At most `MAX_SPANS` spans are kept (the oldest dropped); `reset()`
clears them.  This module does not import torch.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import sys
import threading
import time
from typing import Dict, List

__all__ = ["MAX_SPANS", "current", "recording", "reset", "span", "spans",
           "when_profiled"]

MAX_SPANS = 10 ** 6

_on = False         # the flag every span tests
_depth = 0          # recording() blocks open in the process
_anchor = None      # (event, wall ns) of this recording's device clock
_lock = threading.Lock()
_ids = itertools.count(1)
_kept: collections.deque = collections.deque(maxlen=MAX_SPANS)
_local = threading.local()


class _Off:
    """What `span` returns while nothing records."""

    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda():
    """`torch.cuda` where this process has initialised CUDA, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda


def _take_anchor(cuda):
    """(an event, the wall ns at which the device reached it): of three
    events recorded on the idle device, the one whose window from its
    record to the first poll that found it done was the narrowest,
    stamped at that window's middle."""
    cuda.synchronize()
    best = None
    for _ in range(3):
        event = cuda.Event(enable_timing=True)
        t0 = time.time_ns()
        event.record()
        while not event.query():
            pass
        t1 = time.time_ns()
        if best is None or t1 - t0 < best[2] - best[1]:
            best = (event, t0, t1)
    event, t0, t1 = best
    return event, (t0 + t1) // 2


def _device_anchor():
    """This recording's anchor; taken here, once, where CUDA came up
    after recording started."""
    global _anchor
    if _anchor is None:
        cuda = _cuda()
        if cuda is not None:
            with _lock:
                if _anchor is None:
                    _anchor = _take_anchor(cuda)
    return _anchor


class _Span:
    __slots__ = ("id", "parent", "name", "thread", "start_ns", "end_ns",
                 "attrs", "_device", "_events", "_dev")

    def __init__(self, name: str, device: bool, parent, attrs: dict):
        self.id = next(_ids)
        self.name, self.attrs, self._device = name, attrs, device
        self.parent = getattr(parent, "id", parent)
        self.thread = threading.current_thread().name
        self._events = self._dev = None
        self.end_ns = None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1].id
        stack.append(self)
        if self._device:
            anchor = _device_anchor()
            if anchor is not None:
                cuda = sys.modules["torch"].cuda
                self._events = (anchor, cuda.Event(enable_timing=True),
                                cuda.Event(enable_timing=True))
        self.start_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[2].record()
        self.end_ns = time.time_ns()
        _stack().pop()
        _kept.append(self)
        return False

    def as_dict(self) -> Dict:
        if self._events is not None:
            (anchor, wall), start, end = self._events
            end.synchronize()
            dev_start = wall + round(anchor.elapsed_time(start) * 1e6)
            self._dev = (dev_start,
                         dev_start + round(start.elapsed_time(end) * 1e6))
            self._events = None
        dev = self._dev or (None, None)
        return {"id": self.id, "parent": self.parent, "name": self.name,
                "thread": self.thread, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "attrs": dict(self.attrs),
                "dev_start_ns": dev[0], "dev_end_ns": dev[1]}


def span(name: str, *, device: bool = False, parent=None, **attrs):
    """A context for one span of `name` (see the module's doc); `parent`
    is a span (or its id) on another thread that caused this one.  The
    context has `set(**attrs)` for attributes known only inside it."""
    if not _on:
        return _OFF
    return _Span(name, device, parent, attrs)


def current():
    """The innermost span open on this thread (None where nothing
    records), to hand to work that another thread does for it."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def recording():
    """Record every thread's spans for the duration of the block (blocks
    nest; the outermost one takes the device clock's anchor)."""
    global _on, _depth, _anchor
    with _lock:
        _depth += 1
        if _depth == 1:
            cuda = _cuda()
            _anchor = _take_anchor(cuda) if cuda is not None else None
            _on = True
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                _on = False


def when_profiled():
    """`recording()` where a `torch.profiler` session is active in this
    process (read once, here), else a context that does nothing."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is not None and profiler._is_profiler_enabled:
        return recording()
    return contextlib.nullcontext()


def spans() -> List[Dict]:
    """The kept spans, oldest first by their end, as dicts; device
    intervals resolved (which waits for their events)."""
    return [s.as_dict() for s in list(_kept)]


def reset() -> None:
    """Drop every kept span."""
    _kept.clear()
