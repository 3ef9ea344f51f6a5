"""BENCHMARK.json keeps to the contract's shape, and every name in it finds
its file."""

import importlib
import inspect
import json
import os
import re

import pytest

from benchmark import run as R

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and os.path.isdir(os.path.join(ROOT, p))
    assert len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_fields(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", []):  # each listed cell reports what it moves
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one
        bench_cell = next(w for w in bench["workloads"] if w["name"] == cell)
        assert len(R.cell_metrics(bench, bench_cell, False)) >= 2
        assert R.cell_metrics(bench, bench_cell, True)


@pytest.mark.parametrize("cell", [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]])
def test_cell_finds_its_files(bench, cell):
    _, c, config, traffic = R.load_cell(cell)
    entry = next(e for e in bench["configs"] if e["name"] == c["config"])
    assert entry["file"].startswith("benchmark/") and config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    for key in ("frame", "batch", "in_flight", "pair_gap", "clip_frames", "sample_frames"):
        assert key in traffic
    for m in R.cell_metrics(bench, c, True):
        assert callable(R.reader(m["name"]))
    for mod in ("reference", "counts"):
        assert os.path.isfile(os.path.join(ROOT, "benchmark", mod, f"{config[mod]}.py"))
    assert all(v is not None for v in config["compare"].values())


@pytest.mark.parametrize("name", [c["name"] for c in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["configs"]])
def test_config_call_and_its_reference_take_the_same_inputs(bench, name):
    entry = next(c for c in bench["configs"] if c["name"] == name)
    config = R.load_json(os.path.join(ROOT, entry["file"]))
    assert os.path.isfile(os.path.join(ROOT, "benchmark", "calls", f"{config['call']}.py"))
    call = importlib.import_module(f"benchmark.calls.{config['call']}")
    assert isinstance(call.INPUTS, int) and call.INPUTS >= 1 and callable(call.rectified)
    forward = importlib.import_module(f"benchmark.reference.{config['reference']}").forward
    params = list(inspect.signature(forward).parameters.values())[1:]  # after the weights
    if any(p.kind is p.VAR_POSITIONAL for p in params):
        return
    assert len(params) == call.INPUTS, f"{config['reference']}.forward takes {len(params)}"


def test_every_file_under_paths_is_named_from_name_characters(bench):
    for p in bench["paths"]:
        for dirpath, dirnames, files in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert all(NAME.match(part) for part in rel.split("/")), rel
