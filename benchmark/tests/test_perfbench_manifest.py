"""``BENCHMARK.json`` and the files it names: every cell, configuration and
metric has its file, and the files agree with the manifest (which alone
holds a metric's name, unit, direction, source, layer and ``moves``)."""

import json
import re

import pytest

from harness import manifest

BENCH = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(manifest.MANIFEST.read_bytes()) <= 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS])
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    config = manifest.config(entry["name"])
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] == []
    assert (manifest.BENCH_DIR / "models" / f"{entry['name']}.py").exists()
    assert (manifest.BENCH_DIR / "reference" / f"{entry['name']}.py").exists()


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    cell = manifest.workload(entry["name"])
    assert cell["config"] == entry["config"]
    assert cell["traffic"] == entry["traffic"]
    assert cell["chips"] == entry["chips"]
    assert (manifest.BENCH_DIR / "drivers" / f"{cell['driver']}.py").exists()
    reported = [m["name"] for m in manifest.metrics_for(entry["name"],
                                                        "end_to_end", BENCH)]
    assert "setup_s" in reported and len(reported) >= 2
    layers = manifest.metrics_for(entry["name"], "per_layer", BENCH)
    assert layers
    for m in layers:
        assert m["moves"] in reported


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_metric_file(entry):
    module = manifest.module("metrics", entry["name"])
    assert callable(module.read)
    assert UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    if entry in BENCH["end_to_end"]:
        assert set(entry) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        assert set(entry) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
        assert entry["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for cell in entry.get("workloads", []):
        manifest.cell_entry(cell, BENCH)


def test_workload_files_are_all_named():
    """Every cell of the manifest has its file, and every cell file (also
    of a cell the manifest leaves out) names a configuration and a driver
    that have theirs."""
    files = sorted(p.stem for p in (manifest.BENCH_DIR / "workloads")
                   .glob("*.json"))
    assert set(w["name"] for w in BENCH["workloads"]) <= set(files)
    for name in files:
        cell = json.loads((manifest.BENCH_DIR / "workloads" / f"{name}.json")
                          .read_text())
        assert (manifest.BENCH_DIR / "configs"
                / f"{cell['config']}.json").exists()
        assert (manifest.BENCH_DIR / "drivers"
                / f"{cell['driver']}.py").exists()
