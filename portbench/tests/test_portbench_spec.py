"""BENCHMARK.json against the benchmark's contract, and every file a cell
or a metric names found by its name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32
    assert all(LINE.fullmatch(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24
    # a full check with 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and LINE.fullmatch(c["why"])
        assert LINE.fullmatch(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.fullmatch(w[k]) for k in ("name", "config",
                                                  "traffic"))
        assert LINE.fullmatch(w["why"]) and w["chips"] in (1, 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert LINE.fullmatch(m["layer"])
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in bench[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(ms) == len(set(ms))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(names) == len({c["file"] for c in bench["configs"]})


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reporting
    for cell in cells:
        mine = [n for n, m in e2e.items() if cell in m.get("workloads",
                                                            cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_files_found_by_name(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert (ROOT / "portbench" / "inputs" / f"{cfg['input']}.py").is_file()
    from portbench import entries
    for w in bench["workloads"]:
        with open(ROOT / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
            entry = json.load(f)["entry"]
        assert issubclass(entries.find(entry, "Control"), entries.find(entry))
    from portbench.harness import metric_reader
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric_reader(m["name"]))


def test_layers_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, layer

