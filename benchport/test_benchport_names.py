"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is
found by its name, and the file keeps to the benchmark's contract."""
import json
import re

import pytest

from benchport import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (harness.ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    assert BENCH["command"][1] == "benchport/run.py"
    assert (harness.ROOT / BENCH["command"][1]).is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    _, entry, config, traffic = harness.resolve(cell, BENCH)
    assert entry["chips"] == 1
    assert config["name"] == entry["config"]
    assert (harness.HERE / "kinds" / f"{traffic['kind']}.py").is_file()
    assert (harness.HERE / "problems" / f"{config['generator']}.py").is_file()
    assert NAME.match(entry["name"]) and len(entry["why"]) <= 200
    assert {"start_err", "forward_err", "norm_err"} <= set(config["limits"])
    if "transpose" in traffic["directions"]:
        assert "transpose_err" in config["limits"]
    assert traffic["sample_requests"] <= traffic["sample_within"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    config = harness.load_json(harness.ROOT / entry["file"])
    assert entry["file"].startswith("benchport/")
    assert config["reduced"] == entry["reduced"]
    # every departure from the source is named, with its reason
    assert set(config["reduced"]) == set(config.get("reduced_why", {}))
    assert config["precision"] == "float32" != config["source_precision"]
    assert "precision" in config["reduced"]
    assert config["source"] == entry["source"] and len(entry["source"]) <= 200
    assert any(c["config"] == entry["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader(metric):
    reader = harness.load_module("metrics", metric["name"])
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (
        metric["unit"], metric["better"], metric["source"])
    assert metric["source"] in SOURCES
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert (reader.LAYER, reader.MOVES) == (metric["layer"], metric["moves"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert set(metric["workloads"]) <= set(CELLS)


def test_every_cell_reports_enough():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for cell in BENCH["workloads"]:
        assert harness.metrics_of(BENCH, cell, trace=True)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        harness.resolve("no-such-cell", BENCH)
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")
