"""BENCHMARK.json against the benchmark's contract, and every file that
it names found by name."""
import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    m = load()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(m["command"]) <= 32
    assert all(one_line(w) for w in m["command"])
    for word in m["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs each, run_seconds + 60 s a
    # run, 180 s a cell to compile, 1,200 s spare) fits in 43,200 seconds
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_entries():
    m = load()
    for key, fields in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        names = [e["name"] for e in m[key]]
        assert len(set(names)) == len(names)
        for e in m[key]:
            assert set(e) - {"workloads"} == fields, e
            assert NAME.match(e["name"])
    metric_names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in [e["name"] for e in m["end_to_end"]]
    e2e = {e["name"] for e in m["end_to_end"]}
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert e["moves"] in e2e and one_line(e["layer"])
    for c in m["configs"]:
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(m["workloads"]) // 4)


@pytest.mark.parametrize("workload", [w["name"] for w in load()["workloads"]])
def test_cell_files_found_by_name(workload):
    m = load()
    cell, cfg, traffic = harness.cell_files(m, workload)
    configs = {c["name"]: c for c in m["configs"]}
    entry = configs[cell["config"]]
    assert entry["file"].startswith(m["paths"][0] + "/")
    assert cfg["name"] == cell["config"]
    assert cfg["reduced"] == entry["reduced"]
    for rel in ("apps/%s.py" % cfg["application"],
                "reference/%s.py" % cfg["reference"],
                "counts/%s.py" % cfg["reference"]):
        assert os.path.exists(os.path.join(harness.HERE, rel)), rel
    assert int(traffic["episodes_per_call"]) >= 1
    assert int(traffic["followed_steps"]) >= 3
    assert m["end_to_end"] and m["per_layer"]
    for metric in m["per_layer"]:
        assert callable(harness.metric_reader(metric["name"]))
    # every number compared has a limit of its own
    assert set(cfg["limits"]) >= {"loss_gap", "grad_gap", "change_gap",
                                  "window_loss_gap", "window_grad_gap",
                                  "tables_nonfinite", "first_batch_diff",
                                  "reference_imports_program"}


@pytest.mark.parametrize("config", [c["name"] for c in load()["configs"]])
def test_tiny_copy_found_by_name(config):
    """tiny/<config>.json, the configuration's copy for the CPU tests
    (conftest.py), changes only groups and tables that the configuration
    has."""
    path = os.path.join(harness.HERE, "tiny", config + ".json")
    assert os.path.exists(path), "no tiny copy " + path
    with open(path) as f:
        tiny = json.load(f)
    entry = {c["name"]: c for c in load()["configs"]}[config]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    for group, values in tiny.items():
        assert isinstance(cfg.get(group), (dict, list)), group
        if group == "init":
            assert all(0 <= int(i) < len(cfg["init"]) for i in values)
        else:
            assert set(values) <= set(cfg[group]), group


def test_every_configuration_is_used():
    m = load()
    assert {c["name"] for c in m["configs"]} == {
        w["config"] for w in m["workloads"]}
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
