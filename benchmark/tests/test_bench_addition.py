"""That a configuration, an application (with a fault of its own) and a
cell come in through new files and entries in BENCHMARK.json alone, and
the per-card arithmetic of the trace."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, trace

NAME = "deepwalk_added"
APP = """\"\"\"DeepWalk on the walk route, as apps/graph.py drives it, under an
application name of its own, with a fault of its own.\"\"\"
from benchmark import faults
from benchmark.apps import graph


class Job(graph.Job):
    FAULTS = graph.Job.FAULTS + ("half_batch_again",)

    def plant(self, fault):
        # planted by the job, not by faults.py: the half batch again
        return faults.planted("half_batch", self)
"""


def hashes(root):
    """{path: sha256} of BENCHMARK.json and every file under benchmark/."""
    out = {}
    for d, dirs, files in os.walk(os.path.join(root, "benchmark")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            out[os.path.join(d, f)] = None
    out[os.path.join(root, "BENCHMARK.json")] = None
    for p in out:
        with open(p, "rb") as f:
            out[p] = hashlib.sha256(f.read()).hexdigest()
    return out


def add_cell(root):
    """A renamed copy of deepwalk_youtube with its tiny copy, a new
    application module, and entries under `configs` and `workloads`."""
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "deepwalk_youtube.json")) as f:
        cfg = json.load(f)
    cfg.update(name=NAME, application="graph_added")
    with open(os.path.join(bench, "configs", NAME + ".json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(bench, "tiny", "deepwalk_youtube.json"),
                os.path.join(bench, "tiny", NAME + ".json"))
    with open(os.path.join(bench, "apps", "graph_added.py"), "w") as f:
        f.write(APP)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    entry = dict({c["name"]: c for c in man["configs"]}["deepwalk_youtube"],
                 name=NAME, file="benchmark/configs/%s.json" % NAME)
    man["configs"].append(entry)
    man["workloads"].append({"name": NAME + ".train", "config": NAME,
                             "traffic": "train", "chips": 1,
                             "why": "the added cell"})
    with open(path, "w") as f:
        json.dump(man, f, indent=1)


def test_a_cell_added_by_new_files_alone(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(harness.HERE, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = hashes(root)
    add_cell(root)
    # the copy's benchmark package (first on the path), the checkout's
    # program
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "benchmark/tests/test_bench_manifest.py",
         "benchmark/tests/test_bench_run.py", "-k", "manifest or " + NAME],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-6000:] + r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if " PASSED" in ln]
    for test in ("test_cell_files_found_by_name[%s.train]" % NAME,
                 "test_tiny_copy_found_by_name[%s]" % NAME,
                 "test_tiny_run_is_correct_and_prints_the_contract[%s.train]"
                 % NAME,
                 "test_same_seed_same_inputs[%s.train]" % NAME,
                 "test_control_in_bfloat16_is_not_correct[%s.train]" % NAME):
        assert any(test in ln for ln in lines), (test, r.stdout[-6000:])
    faults = [ln for ln in lines if "test_planted_fault_is_not_correct" in ln
              and NAME in ln]
    assert len(faults) == 5, r.stdout[-6000:]
    after = hashes(root)
    changed = sorted(p for p, h in before.items() if after.get(p) != h)
    assert changed == [os.path.join(root, "BENCHMARK.json")]


@pytest.mark.parametrize("cards", [1, 2])
def test_busy_time_is_the_mean_of_each_cards_union(cards):
    # card 0: [0, 10) and [5, 20) overlap, [30, 40): busy 30; card 1:
    # [0, 5), [10, 20): busy 15, overlapping card 0's in time
    spans = [(0, 0, 10, 0), (0, 5, 20, 1), (0, 30, 40, 2)]
    if cards == 2:
        spans += [(1, 10, 20, 3), (1, 0, 5, 4)]
    unions, busy = trace.card_unions(spans, cards)
    assert unions[0] == [[0, 20, 0], [30, 40, 2]]
    if cards == 1:
        assert busy == 30
        # one card: the union the trace took before it kept cards apart
        assert unions[0] == trace._union([s[1:] for s in spans])
    else:
        assert unions[1] == [[0, 5, 4], [10, 20, 3]]
        assert busy == (30 + 15) / 2
    with pytest.raises(ValueError):
        trace.card_unions(spans + [(cards, 0, 1, 9)], cards)
