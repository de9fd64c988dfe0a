"""The benchmark's engine: finds a cell's pieces by name, times the
window, reads the trace, runs the comparison that decides `correct`,
and prints the result line.

A cell of `BENCHMARK.json` names a configuration and a traffic mix.
`configs/<config>.json` holds the configuration as it is run (with the
program's run settings under "run"), `limits/<cell>.json` the limits of
the cell's comparison, `traffic/<traffic>.json` the mix's parameters
with the name of its driver, `drivers/<driver>.py` the code that drives
the program (`setup`, `window`, `check`, and `end_to_end`, which gives
the window's end-to-end numbers by quantity), and `metrics/<metric>.py`
each per-layer metric's reader (`read(run)` -> a number, or None where
the run has nothing to read).  A metric split by the cells it is reported
in, `<quantity>.<part>`, is the quantity `<quantity>`: an end-to-end
one is taken as that quantity, and a per-layer one reads through
`metrics/<quantity>.py` unless it has a reader of its own.  Adding a
cell, a configuration or a metric adds files and entries; no file here
changes.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# finding the pieces
# ---------------------------------------------------------------------------

def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[c['name'] for c in man['workloads']]}")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(man: dict, cell: dict, root: str = ROOT) -> dict:
    """A cell's configuration, limits, traffic and driver, found by name
    under the checkout `root`."""
    bench = os.path.join(root, "bench")
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(bench, "traffic",
                                     cell["traffic"] + ".json"))
    driver = os.path.join(bench, "drivers", traffic["driver"] + ".py")
    limits = load_json(os.path.join(bench, "limits", cell["name"] + ".json"))
    return {"config": config, "traffic": traffic, "driver": driver,
            "limits": limits}


def cell_metrics(man: dict, cell_name: str, kind: str) -> List[dict]:
    """The `end_to_end` or `per_layer` metrics that a cell reports: those
    listing it under "workloads"; a per-layer metric without the list
    goes to every cell that reports the end-to-end metric it moves."""
    e2e = {m["name"]: m for m in man["end_to_end"]}

    def in_cell(m):
        if "workloads" in m:
            return cell_name in m["workloads"]
        if "moves" in m:
            return in_cell(e2e[m["moves"]])
        return True

    return [m for m in man[kind] if in_cell(m)]


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

class Run:
    """Everything one run gathers; drivers and metric readers read it."""

    def __init__(self, cell: dict, pieces: dict, seed: int, seconds: float,
                 trace: bool, device, workdir: str):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace_on = trace
        self.device = device
        self.workdir = workdir
        self.config = pieces["config"]
        self.traffic = pieces["traffic"]
        self.limits = pieces["limits"]
        self.spans: List[tuple] = []     # (name, start ns, end ns) wall
        self.counters: Dict[str, float] = {}
        self.step_intervals: List[float] = []
        self.steps = 0                   # steps completed in the window
        self.tokens = 0
        self.recoveries: List[float] = []
        self.window_s = math.nan
        self.checks: List[dict] = []
        self.trace = None                # reduced device trace
        self.state: dict = {}            # the drivers' own
        self.attempted = self.failed = 0
        self.log = lambda *a: print(*a, file=sys.stderr, flush=True)

    # spans: host intervals, on the clock the profiler stamps
    def span_start(self, name: str) -> None:
        self._open = (name, time.time_ns())

    def span_end(self) -> None:
        if getattr(self, "_open", None) is not None:
            name, t0 = self._open
            self.spans.append((name, t0, time.time_ns()))
            self._open = None

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with its limit: correct while value <= limit
        (a NaN is never correct)."""
        self.checks.append({"name": name, "value": float(value),
                            "limit": float(limit),
                            "ok": bool(value <= limit)})

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["ok"] for c in self.checks)


def end_to_end(run: Run, driver) -> Dict[str, float]:
    """The end-to-end numbers a window gives, by quantity: the driver's
    and the set-up time."""
    return dict(driver.end_to_end(run), setup_s=run.setup_s)


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

def reduce_trace(events, t0_ns: int, t1_ns: int) -> dict:
    """Device activity of the window [t0, t1] (wall ns): events as
    (name, start ns, duration ns) of every operation on the device
    (kernels, copies, sets).  Gives the busy seconds (the union of their
    intervals), each name's total seconds, and the idle gaps."""
    ivs, by_name = [], {}
    for name, s, d in events:
        e = s + d
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        ivs.append((s, e))
        by_name[name] = by_name.get(name, 0) + (e - s)
    ivs.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, t0_ns
    for s, e in ivs:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, t1_ns))
    return {"busy_s": busy / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "by_name": {k: v / 1e9 for k, v in by_name.items()},
            "gaps": [(a, b) for a, b in gaps if b > a]}


def kernel_name(name: str) -> str:
    """A kernel's function name without its arguments, return type,
    namespaces and template arguments: "void (anonymous
    namespace)::quantize_kernel(float const*, ...)" -> "quantize_kernel"."""
    depth, head = 0, []
    for ch in name.replace("(anonymous namespace)::", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            head.append(ch)
    words = "".join(head).split()
    return words[-1].split("::")[-1] if words else name


def kernel_seconds(run: Run, *names: str) -> float:
    """Device seconds of the kernels whose function name is one of
    `names`, in the traced window (0 where none ran)."""
    if run.trace is None:
        return 0.0
    return sum(s for k, s in run.trace["by_name"].items()
               if kernel_name(k) in names)


def name_gaps(spans: List[tuple], gaps: List[tuple], top: int = 10):
    """The longest idle gaps, each named by the host span that holds its
    middle ("none" outside every span)."""
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) // 2
        name = next((n for n, s, e in spans if s <= mid <= e), "none")
        out.append([name, (b - a) / 1e9])
    return out


def traced(fn) -> list:
    """fn() under torch.profiler, device activity only: (name, start ns,
    duration ns) of every operation on the device, on the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if "CUDA" in str(e.device_type())]


# ---------------------------------------------------------------------------
# result
# ---------------------------------------------------------------------------

def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`repro_torch` is not `repro`)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def result_line(run: Run, man: dict, device: dict, driver=None) -> dict:
    kind = "per_layer" if run.trace_on else "end_to_end"
    metrics = {}
    if run.trace_on:
        for m in cell_metrics(man, run.cell["name"], "per_layer"):
            path = os.path.join(BENCH, "metrics", m["name"] + ".py")
            if not os.path.exists(path):
                path = os.path.join(BENCH, "metrics",
                                    m["name"].split(".")[0] + ".py")
            reader = load_module(path, "bench_metric_"
                                 + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None and not math.isnan(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        got = end_to_end(run, driver)
        for m in cell_metrics(man, run.cell["name"], kind):
            quantity = m["name"].split(".")[0]
            if quantity in got:
                metrics[m["name"]] = {"value": got[quantity],
                                      "unit": m["unit"]}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace_on and run.trace is not None:
        ops = sorted(run.trace["by_name"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in ops[:10]],
            "idle_gaps": name_gaps(run.spans, run.trace["gaps"])}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in run.checks}
    return out


def execute(man: dict, cell_name: str, seed: int, seconds: float,
            trace: bool, *, device="cuda", t_start: Optional[float] = None,
            pieces: Optional[dict] = None, log=None) -> dict:
    """Run one cell and return its result line (the caller prints it).
    `pieces` overrides what `resolve` finds (the tests' tiny cells)."""
    import shutil
    import tempfile

    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(man, cell_name)
    pieces = pieces or resolve(man, cell)
    driver = load_module(pieces["driver"], "bench_driver_"
                         + pieces["traffic"]["driver"])
    tmp = tempfile.mkdtemp(prefix="bench-run-")
    run = Run(cell, pieces, seed, seconds, trace, torch.device(device), tmp)
    run.log = log or run.log
    run.log(f"set-up: {time.perf_counter() - t_start:.3f} s to the driver "
        f"(imports, CUDA)")
    try:
        driver.setup(run)
        if trace and run.device.type == "cuda":
            # the profiler's first start takes seconds: not in the window
            traced(lambda: torch.zeros(1, device=run.device).add_(1))
        if run.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        run.setup_s = time.perf_counter() - t_start
        if trace and run.device.type == "cuda":
            bounds = []

            def window():
                bounds.append(time.time_ns())
                driver.window(run)
                torch.cuda.synchronize()
                bounds.append(time.time_ns())

            run.trace = reduce_trace(traced(window), *bounds)
        else:
            driver.window(run)
        peak = (torch.cuda.max_memory_allocated()
                if run.device.type == "cuda" else 0)
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f"forbidden modules loaded: {bad}")
        driver.check(run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if run.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    for c in run.checks:
        run.log(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAIL'}")
    return result_line(run, man, dev, driver)
