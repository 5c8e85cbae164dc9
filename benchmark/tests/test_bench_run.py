"""Whole runs of the cells at a tiny size on the CPU: the harness's look
for a card skipped, everything else as on the chip. A sound run is
correct; each fault a training cell can have, planted in the program
underneath (faults.py), and the control (the reference in bfloat16 in
the program's place) come out not correct."""
import importlib
import json
import subprocess
import sys

import pytest
import torch

from benchmark import control, harness

# every cell of BENCHMARK.json, and each fault its job can have, read
# when the tests are collected
MANIFEST = harness.load_json(harness.ROOT + "/BENCHMARK.json")
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
WORKLOADS = tuple(CELLS)


def job_faults(workload):
    _, cfg, _ = harness.cell_files(MANIFEST, workload)
    app = importlib.import_module("benchmark.apps." + cfg["application"])
    return app.Job.FAULTS


CELL_FAULTS = [(w, f) for w in WORKLOADS for f in job_faults(w)]
SEED = 3_000_000_017          # past 32 signed bits


def over(numbers, cfg):
    """The numbers over their limits."""
    return sorted(k for k, lim in cfg["limits"].items() if numbers[k] > lim)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_run_is_correct_and_prints_the_contract(workload, tiny_root,
                                                     one_thread):
    out = harness.run(workload, SEED, 0.2, False, device="cpu",
                      root=tiny_root)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_same_seed_same_inputs(workload, tiny_root, one_thread):
    a = control.readings(workload, SEED, "cpu", root=tiny_root)
    b = control.readings(workload, SEED, "cpu", root=tiny_root)
    assert a["program"] == b["program"]


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_planted_fault_is_not_correct(workload, fault, tiny_root,
                                      one_thread):
    man = harness.load_json(tiny_root + "/BENCHMARK.json")
    _, cfg, _ = harness.cell_files(man, workload, tiny_root)
    r = control.readings(workload, SEED, "cpu", fault=fault, root=tiny_root)
    assert over(r["program"], cfg), r


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_bfloat16_is_not_correct(workload, tiny_root,
                                            one_thread):
    man = harness.load_json(tiny_root + "/BENCHMARK.json")
    _, cfg, _ = harness.cell_files(man, workload, tiny_root)
    r = control.readings(workload, SEED, "cpu", control=True,
                         root=tiny_root)
    assert not over(r["program"], cfg), r
    assert over(r["control"], cfg), r


def test_no_card_no_result():
    r = subprocess.run([sys.executable, harness.ROOT + "/benchmark/run.py",
                        "--workload", WORKLOADS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout == ""


def test_alone_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero with no result."""
    import shutil

    shutil.copy(harness.ROOT + "/BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(workload, card):
    """One short run of each cell on the card (python -m pytest
    benchmark/tests -m cuda on a machine with NVIDIA GPUs)."""
    chips = CELLS[workload]["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip("%s needs %d cards; %d visible" % (
            workload, chips, torch.cuda.device_count()))
    r = subprocess.run([sys.executable, harness.ROOT + "/benchmark/run.py",
                        "--workload", workload, "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == chips
    assert len(out["detail"]["memory_peaks_bytes"]) == chips
