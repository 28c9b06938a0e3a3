"""The loader finds every file BENCHMARK.json names, by name, and refuses
bad names and units."""

import copy
import json
import os

import pytest
from conftest import ROOT

from yardstick import loader


def bench():
    return loader.load_benchmark(ROOT)


def test_every_cell_finds_its_config_and_traffic():
    b = bench()
    for name in b.workloads:
        cfg, tr = b.config(name), b.traffic(name)
        assert cfg["name"] == b.workload(name)["config"]
        assert tr["kind"] in ("t2a_closed",)
        assert b.metrics_of(name, False) and b.metrics_of(name, True)


@pytest.mark.parametrize("trace", [False, True])
def test_every_metric_has_a_reader(trace):
    b = bench()
    for name in b.workloads:
        for m in b.metrics_of(name, trace):
            assert callable(loader.reader(m["name"]))


def test_every_cell_reports_setup_and_another_end_to_end_metric():
    b = bench()
    for name in b.workloads:
        names = {m["name"] for m in b.metrics_of(name, False)}
        assert "setup_s" in names and len(names) >= 2
        moved = {m["moves"] for m in b.metrics_of(name, True)}
        assert moved <= names


def test_paths_hold_the_files_the_benchmark_names():
    data = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in data["configs"]:
        assert c["file"].startswith(data["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == json.load(open(os.path.join(ROOT, c["file"])))["reduced"]
    assert os.path.exists(os.path.join(ROOT, data["command"][1]))


@pytest.mark.parametrize("field,value", [
    ("name", "has space"), ("name", "slash/name"), ("name", "x" * 65), ("unit", "tokens per s"),
    ("unit", "µs"), ("better", "up"), ("source", "guess"), ("bound", 0.3)])
def test_bad_metric_is_refused(field, value):
    data = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bad = copy.deepcopy(data)
    bad["end_to_end"][0][field] = value
    with pytest.raises(loader.BenchmarkError):
        loader.Benchmark(bad, ROOT)


def test_bad_workload_name_is_refused():
    data = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bad = copy.deepcopy(data)
    bad["workloads"][0]["name"] = "two words"
    with pytest.raises(loader.BenchmarkError):
        loader.Benchmark(bad, ROOT)
    with pytest.raises(loader.BenchmarkError):
        bench().workload("no_such_cell")


def test_reader_of_unknown_metric_fails():
    with pytest.raises(FileNotFoundError):
        loader.reader("no_such_metric")
    with pytest.raises(loader.BenchmarkError):
        loader.reader("../run")
