"""BENCHMARK.json against the benchmark's contract, and every file it
names present under ``bench/``."""
import json
import re

import pytest

from bench import manifest as mf
from bench.env import BENCH, ROOT

MAN = mf.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def names():
    out = [c["name"] for c in MAN["configs"]]
    out += [w["name"] for w in MAN["workloads"]]
    out += [w[k] for w in MAN["workloads"] for k in ("config", "traffic")]
    out += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    out += [k for c in MAN["configs"] for k in c["reduced"]]
    return out


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("name", names())
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    e2e = {x["name"] for x in MAN["end_to_end"]}
    if m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for w in m.get("workloads", []):
            e = next(x for x in MAN["end_to_end"] if x["name"] == m["moves"])
            assert w in e.get("workloads", [w])


def test_names_unique():
    for key in ("configs", "workloads"):
        ns = [x["name"] for x in MAN[key]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(ms) == len(set(ms))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
    assert LINE.match(c["source"]) and LINE.match(c["why"])
    assert len(c["reduced"]) <= 16
    assert (BENCH / "limits" / f"{c['name']}.json").is_file()
    assert any(w["config"] == c["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and LINE.match(w["why"])
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = [m["name"] for m in mf.metrics_of(MAN, w["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert mf.metrics_of(MAN, w["name"], True)
    cfg = json.loads((ROOT / mf.config_entry(MAN, w["config"])["file"])
                     .read_text())
    assert (BENCH / "systems" / f"{cfg['system']}.py").is_file()


def test_command_and_time():
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= 1
