"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<config>.json``; a metric
``<name>`` is read by ``metrics/<name>.py``'s ``read(run)``; a
configuration's ``system`` is driven by ``systems/<system>.py``. A later
cell, mix, metric or system is a new file and a new entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import re
from functools import lru_cache
from pathlib import Path

from bench.env import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def config_file(man: dict, name: str) -> dict:
    return load_json(ROOT / config_entry(man, name)["file"])


def traffic_file(traffic: str) -> dict:
    return load_json(BENCH / "traffic" / f"{traffic}.json")


def limits_file(config: str) -> dict:
    return load_json(BENCH / "limits" / f"{config}.json")


def metrics_of(man: dict, cell_name: str, trace: bool) -> list:
    """The cell's metrics: end-to-end with ``trace`` off, per-layer with
    it on, each kept where its ``workloads`` (if any) lists the cell."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in man[key]
            if "workloads" not in m or cell_name in m["workloads"]]


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(maxsize=None)
def reader(metric: str):
    """``metrics/<metric>.py``'s ``read`` (names may hold dots)."""
    path = BENCH / "metrics" / f"{metric}.py"
    return _load_file(path, "bench_metric_" + metric.replace(".", "_")
                      .replace("-", "_")).read


def system(name: str):
    """``systems/<name>.py`` as a module."""
    return importlib.import_module(f"bench.systems.{name}")
