"""BENCHMARK.json against the benchmark's contract, and every cell's
pieces found by name; a new cell is picked up by adding files."""
import json
import os
import re
import shutil

import pytest

from bench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_metric_fields():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        reader = [os.path.join(ROOT, "bench", "metrics", n + ".py")
                  for n in (m["name"], m["name"].split(".")[0])]
        assert any(os.path.exists(r) for r in reader), m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_resolves_and_reports(cell):
    w = harness.find_cell(MAN, cell)
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    pieces = harness.resolve(MAN, w)
    assert os.path.exists(pieces["driver"])
    driver = harness.load_module(pieces["driver"], "d_" + cell)
    assert all(hasattr(driver, f) for f in ("setup", "window", "check",
                                             "end_to_end"))
    e2e = [m["name"] for m in harness.cell_metrics(MAN, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.cell_metrics(MAN, cell, "per_layer")
    assert per
    for m in per:   # what a per-layer metric moves, its cell reports
        assert m["moves"] in e2e
    # the cell's own limits, each a number above 0
    assert os.path.exists(os.path.join(ROOT, "bench", "limits", cell + ".json"))
    assert pieces["limits"] and all(v > 0 for v in pieces["limits"].values())


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/") and c["file"] not in files
        files.add(c["file"])
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not re.search(r"(hidden|intermediate|head|_dim|_rank|"
                                 r"experts_per_tok)", k), k


def test_a_new_cell_is_picked_up_by_adding_files(tmp_path):
    """A later cell with a configuration, a traffic mix, a driver with an
    end-to-end quantity of its own, limits and a per-layer metric, all
    new files: found by name, reported, and no existing file edited."""
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {}
    for dirpath, _, files in os.walk(tmp_path / "bench"):
        for f in files:
            before[os.path.join(dirpath, f)] = open(os.path.join(dirpath, f),
                                                    "rb").read()
    bench = tmp_path / "bench"
    config = harness.load_json(os.path.join(ROOT, "bench", "configs",
                                            "qwen2-0.5b.json"))
    config["source"] = "https://example.org/a-later-model"
    (bench / "configs" / "later.json").write_text(json.dumps(config))
    (bench / "traffic" / "echo-b4.json").write_text(json.dumps(
        {"driver": "echo", "name": "echo-b4", "batch": 4, "seq": 64}))
    (bench / "drivers" / "echo.py").write_text(
        "def setup(run): pass\n"
        "def window(run): run.window_s = 1.0\n"
        "def check(run): run.check('echo_gap', 0.0, run.limits['echo_gap'])\n"
        "def end_to_end(run): return {'echo_ms': 2.5}\n")
    (bench / "limits" / "later.echo-b4.json").write_text(
        json.dumps({"echo_gap": 1e-3}))
    (bench / "metrics" / "echo_share.py").write_text(
        "def read(run): return 42.0\n")
    man = json.loads(json.dumps(MAN))
    man["configs"].append({"name": "later", "source": config["source"],
                           "file": "bench/configs/later.json", "reduced": [],
                           "why": "a later model"})
    man["workloads"].append({"name": "later.echo-b4", "config": "later",
                             "traffic": "echo-b4", "chips": 1,
                             "why": "a later cell"})
    man["end_to_end"].insert(0, {"name": "echo_ms", "unit": "ms",
                                 "better": "lower", "bound": 0.05,
                                 "source": "host_clock",
                                 "workloads": ["later.echo-b4"]})
    man["per_layer"].append({"name": "echo_share", "unit": "%",
                             "better": "higher", "source": "program_counter",
                             "layer": "model step", "moves": "echo_ms"})
    cell = harness.find_cell(man, "later.echo-b4")
    pieces = harness.resolve(man, cell, root=str(tmp_path))
    assert pieces["traffic"]["batch"] == 4
    assert pieces["config"]["source"] == "https://example.org/a-later-model"
    assert pieces["driver"] == str(bench / "drivers" / "echo.py")
    assert pieces["limits"] == {"echo_gap": 1e-3}
    assert [m["name"] for m in harness.cell_metrics(
        man, "later.echo-b4", "end_to_end")] == ["echo_ms", "setup_s"]
    assert [m["name"] for m in harness.cell_metrics(
        man, "later.echo-b4", "per_layer")] == ["echo_share"]
    driver = harness.load_module(pieces["driver"], "d_echo")
    run = harness.Run(cell, pieces, 1, 1.0, False, "cpu", str(tmp_path))
    driver.window(run)
    driver.check(run)
    run.setup_s = 3.0
    line = harness.result_line(run, man, {}, driver)
    assert line["correct"] and line["metrics"] == {
        "echo_ms": {"value": 2.5, "unit": "ms"},
        "setup_s": {"value": 3.0, "unit": "s"}}
    for path, data in before.items():
        assert open(path, "rb").read() == data
