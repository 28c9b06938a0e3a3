"""``BENCHMARK.json`` and the files it names: a configuration file under
``configs/``, a traffic file under ``traffic/`` and a reader under
``metrics/`` for each metric, all found by name."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class BenchmarkError(ValueError):
    pass


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise BenchmarkError(f"{what} {name!r} is not a valid name")
    return name


def check_metric(m: dict, end_to_end: bool) -> dict:
    check_name(m["name"], "metric")
    if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
        raise BenchmarkError(f"metric {m['name']}: unit {m.get('unit')!r} is not valid")
    if m.get("better") not in ("lower", "higher"):
        raise BenchmarkError(f"metric {m['name']}: better must be lower or higher")
    if m.get("source") not in (SOURCES_E2E if end_to_end else SOURCES):
        raise BenchmarkError(f"metric {m['name']}: source {m.get('source')!r}")
    if end_to_end and not 0 < float(m["bound"]) <= 0.25:
        raise BenchmarkError(f"metric {m['name']}: bound {m['bound']} not in (0, 0.25]")
    return m


class Benchmark:
    """The parsed ``BENCHMARK.json`` of ``root``."""

    def __init__(self, data: dict, root: str):
        self.data, self.root = data, root
        self.configs = {check_name(c["name"], "config"): c for c in data["configs"]}
        self.workloads = {check_name(w["name"], "workload"): w for w in data["workloads"]}
        for w in data["workloads"]:
            check_name(w["traffic"], "traffic")
            if w["config"] not in self.configs:
                raise BenchmarkError(f"workload {w['name']}: unknown config {w['config']!r}")
        self.end_to_end = [check_metric(m, True) for m in data["end_to_end"]]
        self.per_layer = [check_metric(m, False) for m in data["per_layer"]]
        names = [m["name"] for m in self.end_to_end + self.per_layer]
        if len(set(names)) != len(names):
            raise BenchmarkError("two metrics share a name")

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise BenchmarkError(f"unknown workload {name!r}: one of {sorted(self.workloads)}")
        return self.workloads[name]

    def metrics_of(self, workload: str, trace: bool) -> List[dict]:
        """The cell's metrics: end-to-end ones untraced, per-layer ones traced."""
        group = self.per_layer if trace else self.end_to_end
        return [m for m in group if workload in m.get("workloads", [workload])]

    def config(self, workload: str) -> dict:
        w = self.workload(workload)
        return read_json(os.path.join(self.root, self.configs[w["config"]]["file"]))

    def traffic(self, workload: str) -> dict:
        return read_json(os.path.join(HERE, "traffic", self.workload(workload)["traffic"] + ".json"))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str) -> Benchmark:
    return Benchmark(read_json(os.path.join(root, "BENCHMARK.json")), root)


def reader(name: str, metrics_dir: Optional[str] = None) -> Callable:
    """The ``read(run) -> value or None`` of metric ``name``
    (``metrics/<name>.py``)."""
    path = os.path.join(metrics_dir or os.path.join(HERE, "metrics"), check_name(name, "metric")
                        + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of the metrics whose reader finds a
    finite number (a tail over a failed request reads infinite: left out)."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
