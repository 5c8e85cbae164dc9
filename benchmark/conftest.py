"""pytest settings of the benchmark's own tests (python -m pytest
benchmark/tests): the `cuda` marker, the checkout on sys.path, and tiny
copies of the cells for the CPU."""
import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at sizes a CPU test holds: the same jobs, widths and limits,
# fewer vertices, relations, triplets and batches; dimension and batch
# cut for time
TINY = {
    "deepwalk_youtube": {"dataset": {"num_vertex": 5000, "num_edge": 25000},
                         "resource": {"dim": 32},
                         "build": {"episode_size": 4}},
    "rotate_wikidata5m": {"dataset": {"num_vertex": 2000,
                                      "num_relation": 20,
                                      "num_edge": 20000},
                          "resource": {"dim": 32},
                          "build": {"episode_size": 4, "batch_size": 1024},
                          "init": {1: {"cols_drawn": 16}}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        cfg = json.load(f)
    for group, values in TINY[name].items():
        if group == "init":
            for i, v in values.items():
                cfg["init"][i].update(v)
        else:
            cfg[group].update(values)
    return cfg


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A directory holding BENCHMARK.json and the tiny configurations, and
    the program set to take the card's routes on the CPU: the fused arena
    (taken for tables above DENSE_UPDATE_ELEMS) and the pooled KG step
    (taken where the classic step's batch would be capped)."""
    from graphvite_tpu_torch import optim

    monkeypatch.setattr(optim, "DENSE_UPDATE_ELEMS", 1)
    monkeypatch.setenv("GRAPHVITE_KG_NEG_SHARING", "1")
    man = copy.deepcopy(manifest())
    os.makedirs(tmp_path / "benchmark" / "configs")
    for c in man["configs"]:
        with open(tmp_path / c["file"], "w") as f:
            json.dump(tiny_config(c["name"]), f)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(man, f)
    return str(tmp_path)


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
