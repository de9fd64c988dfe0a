"""The hybrid cell's readers on synthetic runs: `ssm_mixer_s` and
`ssd_core_s` from the mixers' spans (forward, recompute and backward,
the backward ones on autograd's thread, found by time), `mfu.hybrid`
from the frozen FLOPs."""
import os

import pytest

from bench import harness
from bench.hybrid_flops import train_step_flops
from bench.tests.test_bench_trace_metrics import MAN, _run, _Spans

CELL = "granite-4.0-h-micro.train-ckpt-hybrid"


def _hybrid():
    """Three window steps and the loop's last stop: in each, two Mamba
    layers' mixer forward (with its SSD) on the loop's thread and, inside
    the backward, their recompute and backward spans on autograd's."""
    s = _Spans()
    for i, t in enumerate((0, 100, 200)):
        st, _ = s.step(i, t, 30)
        fwd = next(x for x in s.out if x["name"] == "step.forward"
                   and x["parent"] == st["id"])
        for layer, o in ((0, 10), (2, 15)):
            m = s.add("mixer.mamba", t + o, t + o + 2, fwd,
                      dev=(t + o, t + o + 3 + i), layer=layer)
            s.add("mixer.mamba.ssd", t + o, t + o + 1, m,
                  dev=(t + o, t + o + 1), layer=layer)
            for name, dt in (("mixer.mamba", 5), ("mixer.mamba.ssd", 2),
                             ("mixer.mamba.backward", 7),
                             ("mixer.mamba.ssd.backward", 4)):
                s.add(name, t + 40 + o, t + 41 + o, m, thread="autograd",
                      dev=(t + 40 + o, t + 40 + o + dt), layer=layer)
    s.add("step", 300, 305)           # the last stop: no train step
    return _run(CELL, s.out)


def _reader(name):
    return harness.load_module(os.path.join(harness.BENCH, "metrics",
                                            name + ".py"), "t_" + name)


def test_mixer_seconds_a_step():
    # a step's mixers: 2 layers x (forward 3 + i, recompute 5, backward 7)
    got = _reader("ssm_mixer_s").read(_hybrid())
    assert got == pytest.approx(2 * (4 + 5 + 7) / 1000, rel=1e-9)


def test_ssd_seconds_a_step():
    got = _reader("ssd_core_s").read(_hybrid())
    assert got == pytest.approx(2 * (1 + 2 + 4) / 1000, rel=1e-9)


def test_no_spans_read_none():
    run = _run(CELL, [])
    assert _reader("ssm_mixer_s").read(run) is None
    assert _reader("ssd_core_s").read(run) is None


def test_mfu_hybrid():
    run = _hybrid()
    run.steps, run.window_s = 4, 10.0
    t = run.traffic
    want = 100 * 4 * train_step_flops(run.config, t["batch"], t["seq"]) / (
        10.0 * 989e12)
    assert _reader("mfu.hybrid").read(run) == pytest.approx(want)
    assert 10 < want < 20


def test_the_cells_metrics_list_it():
    names = {m["name"] for m in MAN["per_layer"]
             if CELL in m.get("workloads", [])}
    assert {"ssm_mixer_s", "ssd_core_s", "mfu.hybrid",
            "device_idle_share.hybrid"} <= names
