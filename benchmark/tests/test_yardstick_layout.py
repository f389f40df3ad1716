"""BENCHMARK.json against its contract, and cells, mixes and metrics
found as files by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.harness.spec import Spec, read_metrics

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture
def spec(repo_root):
    return Spec(repo_root)


def test_top_level_keys(spec):
    b = spec.data
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_keys(spec):
    b = spec.data
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))


def test_every_cell_finds_its_files(spec):
    e2e = {m["name"] for m in spec.data["end_to_end"]}
    for cell in spec.data["workloads"]:
        cfg = spec.config(cell)
        assert cfg["name"] == cell["config"]
        entry = next(c for c in spec.data["configs"] if c["name"] == cell["config"])
        assert set(entry["reduced"]) <= set(cfg) and set(entry["reduced"]) <= set(cfg["reduced"])
        spec.traffic(cell)
        reported = {m["name"] for m in spec.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.per_layer(cell)
        assert layer
        for m in layer:
            assert m["moves"] in e2e and m["moves"] in reported


def test_every_metric_reader_declares_what_the_json_says(spec):
    for m in spec.data["per_layer"]:
        r = spec.reader(m["name"])
        assert (r.LAYER, r.UNIT, r.MOVES, r.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"])
        assert r.read({}) is None  # nothing to read: left out, never 0


def test_each_config_is_used(spec):
    used = {w["config"] for w in spec.data["workloads"]}
    assert used == {c["name"] for c in spec.data["configs"]}


def test_new_files_are_found_without_editing_any(tmp_path, repo_root):
    """A later change adds a configuration, a mix and a metric as files
    of their own and entries in BENCHMARK.json; no file of the benchmark
    changes."""
    root = tmp_path / "checkout"
    shutil.copytree(repo_root / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(repo_root / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}

    (root / "benchmark" / "configs" / "r3-4kib.json").write_text(json.dumps(
        {"name": "r3-4kib", "nodes": 3, "garage": {"block_size": 4096},
         "reduced": {}}))
    (root / "benchmark" / "traffic" / "tiny-mix.json").write_text(json.dumps(
        {"driver": "s3", "rate_per_s": 1.0}))
    (root / "benchmark" / "metrics" / "tiny.counter.py").write_text(
        'LAYER = "x"\nUNIT = "ops"\nMOVES = "setup_s"\nSOURCE = "program_counter"\n'
        'def read(obs):\n    return obs.get("tiny")\n')
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "r3-4kib", "source": "x",
                         "file": "benchmark/configs/r3-4kib.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "r3.tiny", "config": "r3-4kib",
                           "traffic": "tiny-mix", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "tiny.counter", "unit": "ops",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "setup_s",
                           "workloads": ["r3.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    spec = Spec(root)
    cell = spec.cell("r3.tiny")
    assert spec.config(cell)["garage"]["block_size"] == 4096
    assert spec.traffic(cell)["rate_per_s"] == 1.0
    assert read_metrics(spec, cell, {"tiny": 7}) == {
        "tiny.counter": {"value": 7, "unit": "ops"}}
    assert read_metrics(spec, cell, {}) == {}
    for p, data in before.items():
        assert p.read_bytes() == data, p
