"""The readers of the program's spans (`bench/program_trace.py` and the
metrics with source "program_span"), each on a synthetic run: given
program spans and idle gaps of `run.trace`, the number it returns; with
no spans, None."""
import os
import random
import sys

import pytest

from bench import harness
from bench import program_trace as P

MAN = harness.manifest()
MS = 1_000_000          # ns in a ms
READERS = [m["name"] for m in MAN["per_layer"]
           if m["source"] == "program_span"]


class _Spans:
    """Synthetic spans, times in ms."""

    def __init__(self):
        self.out = []

    def add(self, name, a, b, parent=None, thread="MainThread", dev=None,
            **attrs):
        s = {"id": len(self.out) + 1, "parent": parent and parent["id"],
             "name": name, "thread": thread, "start_ns": int(a * MS),
             "end_ns": int(b * MS), "attrs": attrs,
             "dev_start_ns": dev and int(dev[0] * MS),
             "dev_end_ns": dev and int(dev[1] * MS)}
        self.out.append(s)
        return s

    def step(self, i, t, fwd_ms):
        """A step from t ms to t + 100: stop flag at 5-6, forward,
        backward and optimizer on the device from t + 10, the caller's
        on_metrics at 90-95, the safe point at 95-100."""
        st = self.add("step", t, t + 100, step=i)
        self.add("step.batch", t, t + 5, st)
        self.add("step.callback", t + 5, t + 6, st)
        self.add("step.batch", t + 6, t + 8, st)
        self.add("step.forward", t + 8, t + 20, st, dev=(t + 10, t + 10 + fwd_ms))
        d = t + 10 + fwd_ms
        self.add("step.backward", t + 20, t + 30, st, dev=(d, d + 40))
        self.add("step.optimizer", t + 30, t + 35, st, dev=(d + 40, d + 45))
        self.add("step.metrics", t + 35, t + 90, st)
        self.add("step.callback", t + 90, t + 95, st)
        return st, self.add("safe_point", t + 95, t + 100, st)


def _run(cell, spans, gaps_ms=()):
    w = harness.find_cell(MAN, cell)
    run = harness.Run(w, harness.resolve(MAN, w), 1, 1.0, True, "cpu", ".")
    run.program_spans = spans
    run.trace = {"gaps": [(int(a * MS), int(b * MS)) for a, b in gaps_ms],
                 "busy_s": 0.0, "window_s": 1.0, "by_name": {}}
    run.logged = []
    run.log = lambda *a: run.logged.append(" ".join(map(str, a)))
    return run


def _train_ckpt():
    """Three steps (forward 30, 34, 32 ms on the device), the image taken
    at the second one's safe point and written on the writer thread, the
    loop's last stop (a step span without a train step)."""
    s = _Spans()
    s.step(0, 0, 30)
    _, sp = s.step(1, 100, 34)
    snap = s.add("safe_point.snapshot", 96, 99, sp, dev=(96.5, 99.0), step=2)
    w = "ckpt-writer_0"
    write = s.add("image.write", 99, 400, snap, thread=w, step=2)
    s.add("image.encode", 100, 110, write, thread=w, dev=(101, 104))
    s.add("image.digest", 110, 115, write, thread=w, dev=(112, 113))
    s.add("image.d2h", 115, 130, write, thread=w, dev=(120, 129))
    s.add("image.file", 130, 200, write, thread=w, bytes=64)
    s.add("image.digest", 200, 204, write, thread=w, dev=(200.5, 201))
    s.add("image.d2h", 204, 210, write, thread=w, dev=(203.0, 209))
    s.add("image.file", 210, 290, write, thread=w, bytes=32)
    s.add("image.commit", 290, 300, write, thread=w)
    s.step(2, 200, 32)
    last = s.add("step", 300, 302, step=3)
    s.add("step.callback", 300.5, 301, last)
    # idle: 2-8 (stop flag 5-6 inside), 92-104 (on_metrics 90-95 inside),
    # 300-302 (the last stop), 350-360 (outside every loop span)
    gaps = [(2, 8), (92, 104), (300, 302), (350, 360)]
    return _run("qwen2-0.5b.train-ckpt", s.out, gaps)


def _recover():
    """Two restores of two chunks and one array each."""
    s = _Spans()
    for t, read in ((0, 30), (1000, 50)):
        r = s.add("restore", t, t + 400, step=3)
        for c in (0, 1):
            o = t + 200 * c
            s.add("restore.read", o, o + read / 2, r, bytes=64)
            s.add("restore.upload", o + 60, o + 100, r, dev=(o + 60, o + 99))
            s.add("restore.verify", o + 100, o + 150, r, dev=(o + 100, o + 110))
        s.add("restore.decode", t + 350, t + 370, r, dev=(t + 350, t + 360),
              path="opt/m/w")
        s.add("restore.rebuild", t + 370, t + 371, r)
    s.step(0, 2000, 30)
    return _run("qwen2-0.5b.recover", s.out)


WANT = {
    "step_forward_s": 0.032,
    "step_backward_s": 0.040,
    "step_optimizer_s": 0.005,
    # step 0: 2-8 less 5-6, and 92-100 less 92-95: 5 + 5; step 1: 100-104
    "step_idle_ms": (10 + 4 + 0) / 3,
    "snapshot_ms": 2.5,
    "image_encode_s": 0.010,
    "image_digest_s": 0.009,
    "image_d2h_s": 0.021,
    "image_file_s": 0.160,
    # digests 2 + 0.5 ms, copies 5 + 0 ms (a device start before the host's
    # counts 0)
    "image_queue_wait_s": 0.0075,
    "restore_read_s": (30 + 50) / 2 / 1000,
    "restore_upload_s": 0.080,
    "restore_verify_s": 0.100,
    "restore_decode_s": 0.020,
}


def _reader(name):
    return harness.load_module(os.path.join(harness.BENCH, "metrics",
                                            name + ".py"),
                               "t_metric_" + name)


def _cell_run(name):
    m = next(m for m in MAN["per_layer"] if m["name"] == name)
    return _train_ckpt() if "qwen2-0.5b.train-ckpt" in m["workloads"] \
        else _recover()


def test_every_program_span_metric_is_read_here():
    assert sorted(READERS) == sorted(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_spans(name):
    got = _reader(name).read(_cell_run(name))
    assert got == pytest.approx(WANT[name], rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_spans_returns_none(name, monkeypatch):
    # a run whose program recorded nothing
    run = _cell_run(name)
    run.program_spans = []
    assert _reader(name).read(run) is None
    # a program without the recorder, traced
    import repro_torch

    del run.program_spans
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(repro_torch, "trace", raising=False)
    assert P.spans(run) is None
    assert _reader(name).read(run) is None
    # a run that was not traced
    run.trace = None
    del run.program_spans
    assert _reader(name).read(run) is None


def test_idle_is_named_by_the_innermost_loop_span():
    """2-8: batch 3 + stop flag 1 + batch 2; 92-104: on_metrics 3, the
    safe point 2 around its snapshot 3, the next batch 4; 300-302: the
    last stop's step 1.5 around its callback 0.5; 350-360: no loop span
    open, the writer's "image.write" (its children ended at 300)."""
    run = _train_ckpt()
    got = P.idle_by_span(run)
    assert got == pytest.approx({
        "step.batch": 0.009, "step.callback": 0.0045,
        "safe_point.snapshot": 0.003, "safe_point": 0.002, "step": 0.0015,
        "image.write": 0.010}, rel=1e-12)
    assert list(got)[0] == "image.write"        # largest first
    _reader("step_idle_ms").read(run)
    assert run.logged and run.logged[0].startswith(
        "device idle s by program span: image.write 0.010000")


@pytest.mark.parametrize("seed", range(4))
def test_idle_of_an_interval_against_a_count_by_ns(seed):
    rnd = random.Random(seed)
    marks = sorted(rnd.sample(range(2000), 40))
    gaps = list(zip(marks[::2], marks[1::2]))
    idle = P.Idle(gaps)
    for _ in range(200):
        a, b = sorted(rnd.sample(range(-50, 2050), 2))
        want = sum(max(0, min(b, e) - max(a, s)) for s, e in gaps)
        assert idle.ns(a, b) == want
