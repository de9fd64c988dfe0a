"""The port's spans (`repro_torch.trace`) on a reduced qwen2-0.5b
`MANARuntime` with an int8-moment image, then a restore: with recording
off nothing is kept and nothing changes; under `recording()` every span
of the step, the safe point, the image writer and restore appears under
its parent, on the thread that does the work, one a chunk where the
work is a chunk's; under `torch.profiler` the runtime records by itself
and the profiler's events fall inside the program's spans on one clock.
The `cuda` case holds a device span's interval against the profiler's
interval of the kernel inside it (skips without a card; run on the card
with `python -m pytest -q -m cuda tests/test_torch_trace.py`).
"""
import os
import threading

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core import checkpoint as ckpt_mod
from repro_torch.core.runtime import MANARuntime

CHUNK = 4096            # chunks of the tests' images: several a leaf
STEPS = 3               # the image is taken at step 2's safe point


def _runtime(d):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = RunConfig(model=cfg, shape=ShapeConfig("smoke", 64, 2, "train"),
                   loss_chunk=32, attn_chunk=16)
    return MANARuntime(cfg, rc, ckpt_dir=str(d), ckpt_every_steps=2,
                       quantize_moments=True, device="cpu")


def _job(d):
    """Train STEPS steps with one image, restore it in a fresh runtime:
    (losses, the image's stats and manifest, its chunk files' bytes)."""
    rt = _runtime(d)
    rt.initialize()
    hist = rt.run(STEPS, on_metrics=lambda s, m: None,
                  stop_flag=lambda: False)
    stats = rt.ckpt.stats[-1]
    man = rt.ckpt._manifest(rt.ckpt.step_dir(stats["step"]))
    rt.close()
    rt2 = _runtime(d)
    assert rt2.restore() == stats["step"]
    rt2.close()
    files = {}
    for e in man["arrays"].values():
        for f in e["files"]:
            with open(os.path.join(d, f"ckpt_{stats['step']:010d}",
                                   f["file"]), "rb") as fh:
                files[f["file"]] = fh.read()
    return [h["loss"] for h in hist], stats, man, files


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ckpt_mod, "CHUNK_BYTES", CHUNK)
        trace.reset()
        with trace.recording():
            job = _job(tmp_path_factory.mktemp("recorded"))
        spans = trace.spans()
        trace.reset()
    return job, spans


@pytest.fixture(scope="module")
def unrecorded(tmp_path_factory):
    """The same job with recording off and `torch.cuda.Event` made to
    count its calls."""
    built = []

    def event(*a, **k):
        built.append(1)
        raise AssertionError("a CUDA event was built with recording off")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ckpt_mod, "CHUNK_BYTES", CHUNK)
        mp.setattr(torch.cuda, "Event", event)
        trace.reset()
        job = _job(tmp_path_factory.mktemp("unrecorded"))
        spans = trace.spans()
    return job, spans, built


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _descendants(spans, root):
    ids, out = {root["id"]}, []
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        if s["parent"] in ids:
            ids.add(s["id"])
            out.append(s)
    return out


# ---- (a) recording off ---------------------------------------------------------

def test_off_keeps_no_span_and_builds_no_event(unrecorded):
    _, spans, built = unrecorded
    assert spans == [] and built == []
    assert trace.span("step") is trace.span("image.file", bytes=1)
    assert trace.current() is None


def test_off_trains_and_writes_as_a_recorded_run(recorded, unrecorded):
    (losses, stats, _, files), _ = recorded
    (losses_off, stats_off, _, files_off), _, _ = unrecorded
    assert losses_off == losses
    assert stats_off["bytes"] == stats["bytes"]
    assert files_off == files


# ---- (b) under recording() ------------------------------------------------------

PARENTS = [
    ("step", None), ("step.batch", "step"), ("step.callback", "step"),
    ("step.forward", "step"), ("step.backward", "step"),
    ("step.optimizer", "step"), ("step.metrics", "step"),
    ("safe_point", "step"), ("safe_point.snapshot", "safe_point"),
    ("image.write", "safe_point.snapshot"), ("image.encode", "image.write"),
    ("image.digest", "image.write"), ("image.d2h", "image.write"),
    ("image.file", "image.write"), ("image.commit", "image.write"),
    ("restore", None), ("restore.read", "restore"),
    ("restore.upload", "restore"), ("restore.verify", "restore"),
    ("restore.decode", "restore"), ("restore.rebuild", "restore"),
]


@pytest.mark.parametrize("name,parent", PARENTS, ids=[p[0] for p in PARENTS])
def test_every_span_appears_under_its_parent(recorded, name, parent):
    _, spans = recorded
    ids = _by_id(spans)
    got = _named(spans, name)
    assert got, name
    for s in got:
        assert s["start_ns"] <= s["end_ns"]
        assert (ids[s["parent"]]["name"] if s["parent"] else None) == parent
        # CPU: no device interval
        assert s["dev_start_ns"] is None and s["dev_end_ns"] is None
    if name == "step":
        assert [s["attrs"]["step"] for s in got] == list(range(STEPS))
        assert all(len(_named(_descendants(spans, s), "step.callback")) == 2
                   for s in got)


def test_writer_spans_on_the_writer_thread(recorded):
    (_, stats, _, _), spans = recorded
    main = threading.current_thread().name
    (write,) = _named(spans, "image.write")
    assert write["attrs"]["step"] == stats["step"] == 2
    snap = _by_id(spans)[write["parent"]]
    assert snap["name"] == "safe_point.snapshot" and snap["thread"] == main
    assert snap["attrs"]["step"] == 2
    assert write["thread"] != main
    assert write["thread"].startswith("ckpt-writer")
    kids = _descendants(spans, write)
    assert kids and {s["thread"] for s in kids} == {write["thread"]}
    assert {s["name"] for s in spans if s["thread"] == write["thread"]} == {
        "image.write", "image.encode", "image.digest", "image.d2h",
        "image.file", "image.commit"}


def test_one_file_span_a_chunk_written_and_one_read_span_a_chunk_read(
        recorded):
    (_, _, man, _), spans = recorded
    chunks = [f["nbytes"] for e in man["arrays"].values() for f in e["files"]]
    assert len(chunks) > len(man["arrays"])     # leaves of several chunks
    files = _named(spans, "image.file")
    assert sorted(s["attrs"]["bytes"] for s in files) == sorted(chunks)
    assert len(_named(spans, "image.digest")) == len(chunks)
    assert len(_named(spans, "image.d2h")) == len(chunks)
    assert len(_named(spans, "image.encode")) == len(man["arrays"])
    (restore,) = _named(spans, "restore")
    inside = _descendants(spans, restore)
    reads = _named(inside, "restore.read")
    assert sorted(s["attrs"]["bytes"] for s in reads) == sorted(chunks)
    assert len(_named(inside, "restore.upload")) == len(chunks)
    assert len(_named(inside, "restore.verify")) == len(chunks)
    assert (sorted(s["attrs"]["path"]
                   for s in _named(inside, "restore.decode"))
            == sorted(man["arrays"]))


def test_writer_phases_add_up_to_no_more_than_write_s(recorded):
    (_, stats, _, _), spans = recorded
    (write,) = _named(spans, "image.write")
    phases = [s for s in _descendants(spans, write)
              if s["name"] in ("image.encode", "image.digest", "image.d2h",
                               "image.file", "image.commit")]
    total = sum(s["end_ns"] - s["start_ns"] for s in phases) / 1e9
    # write_s is kept rounded to 1e-4 s
    assert 0 < total <= stats["write_s"] + 5e-5
    assert total <= (write["end_ns"] - write["start_ns"]) / 1e9


def test_restore_children_lie_inside_restore(recorded):
    _, spans = recorded
    (restore,) = _named(spans, "restore")
    assert restore["attrs"]["step"] == 2
    inside = _descendants(spans, restore)
    assert {s["name"] for s in inside} == {
        "restore.read", "restore.upload", "restore.verify",
        "restore.decode", "restore.rebuild"}
    for s in inside:
        assert restore["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= restore["end_ns"]
        assert s["thread"] == restore["thread"]


# ---- (c) under torch.profiler -----------------------------------------------------

def _profiled(fn):
    """fn() under torch.profiler, CPU activity only, with no recording()
    of the caller's: (the profiler's aten events as (name, start ns,
    end ns), the program's spans)."""
    from torch.profiler import ProfilerActivity, profile

    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = trace.spans()
    trace.reset()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    return events, spans


PRODUCTS = ("aten::mm", "aten::bmm", "aten::matmul", "aten::einsum",
            "aten::addmm", "aten::linear")


def _inside(event, spans):
    _, a, b = event
    return any(s["start_ns"] <= a and b <= s["end_ns"] for s in spans)


def test_profiled_run_records_on_the_profilers_clock(tmp_path):
    rt = _runtime(tmp_path)
    rt.initialize()
    rt.ckpt_every_steps = None
    events, spans = _profiled(lambda: rt.run(2))
    rt.close()
    assert len(_named(spans, "step")) == 2
    # every matrix product (on the CPU the model's einsums run as bmm)
    mm = [e for e in events if e[0] in PRODUCTS]
    assert mm and events
    phases = [s for s in spans if s["name"] in ("step.forward",
                                                "step.backward")]
    assert all(_inside(e, phases) for e in mm)
    outside = [e for e in events if not _inside(e, _named(spans, "step"))]
    assert not outside, outside[:5]
    # nothing records once the profiler has stopped
    rt2 = _runtime(tmp_path)
    rt2.initialize()
    trace.reset()
    rt2.run(1)
    rt2.close()
    assert trace.spans() == []


def test_profiled_restore_records_on_the_profilers_clock(tmp_path):
    rt = _runtime(tmp_path)
    rt.initialize()
    rt.run(2)
    rt.close()
    rt2 = _runtime(tmp_path)
    events, spans = _profiled(rt2.restore)
    rt2.close()
    (restore,) = _named(spans, "restore")
    assert events and all(_inside(e, [restore]) for e in events)
    assert _named(spans, "restore.decode")


# ---- the recorder ----------------------------------------------------------------

def test_recorder_parents_threads_nesting_and_bound(monkeypatch):
    trace.reset()
    with trace.recording():
        with trace.recording():             # nested: one recording
            with trace.span("outer", step=1) as outer:
                outer.set(extra=2)
                with trace.span("inner"):
                    assert trace.current().name == "inner"
                caller = trace.current()
        t = threading.Thread(target=lambda: trace.span(
            "other", parent=caller).__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert trace.span("after") is trace.span("after")
    got = {s["name"]: s for s in trace.spans()}
    assert set(got) == {"outer", "inner", "other"}
    assert got["outer"]["attrs"] == {"step": 1, "extra": 2}
    assert got["outer"]["parent"] is None
    assert got["inner"]["parent"] == got["outer"]["id"]
    assert got["other"]["parent"] == got["outer"]["id"]
    assert got["other"]["thread"] != got["outer"]["thread"]
    # bounded: the oldest are dropped
    import collections
    monkeypatch.setattr(trace, "_kept", collections.deque(maxlen=3))
    with trace.recording():
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [s["name"] for s in trace.spans()] == ["s2", "s3", "s4"]
    trace.reset()
    assert trace.spans() == []


# ---- (d) on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel(prof, word):
    """The one device interval of the profile whose kernel's name holds
    `word`, on the profiler's clock."""
    got = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if "CUDA" in str(e.device_type()) and word in e.name()]
    assert len(got) == 1, (word, got)
    return got[0]


@pytest.mark.cuda
def test_device_span_holds_its_kernel_on_the_profilers_clock(card):
    """Device spans around two kernels, each queued behind tens of ms of
    other work: each span's device interval is its kernel's profiler
    interval to 50 us at either end, once the profiler session's own
    offset is taken out.  That offset (the profiler's conversion of the
    card's timestamps to the wall clock, taken on the first kernel) is
    not the recorder's: the recorder's clock kept a fixed chain of
    products at the same length in every session while the profiler's
    moved by up to 3.8 ms between sessions (H100 80GB HBM3, torch 2.11);
    it is held under 10 ms."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(8192, 8192, device=card)
    x = torch.randn(1 << 26, device=card)
    y = torch.randn(1 << 25, device=card)
    for _ in range(2):              # every kernel loaded before the profile
        a = a @ a / 8192.0
        x.sin_()
        y.cos_()
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.recording():
            for _ in range(4):      # keep the card busy: each span's events
                a = a @ a / 8192.0  # and its kernel run back to back
            with trace.span("first", device=True):
                x.sin_()
            for _ in range(2):
                a = a @ a / 8192.0
            with trace.span("probe", device=True):
                y.cos_()
            torch.cuda.synchronize()
    got = {s["name"]: s for s in trace.spans()}
    trace.reset()
    first, probe = got["first"], got["probe"]
    fs, fe = _kernel(prof, "sin")
    ks, ke = _kernel(prof, "cos")
    off = first["dev_start_ns"] - fs
    gaps = (first["dev_end_ns"] - fe - off, probe["dev_start_ns"] - ks - off,
            probe["dev_end_ns"] - ke - off)
    assert all(abs(g) <= 50_000 for g in gaps), (off, gaps)
    assert abs(off) <= 10_000_000, off
