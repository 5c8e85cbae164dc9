"""pytest settings of the benchmark's own tests (python -m pytest
benchmark/tests): the `cuda` marker, the checkout on sys.path, and tiny
copies of the cells for the CPU.

A configuration's tiny copy is `tiny/<config>.json`: its file under
`configs/` with each group of the tiny file laid over the group of the
same name (the same jobs, widths and limits; fewer vertices, relations,
triplets and batches, and dimension and batch cut for time). `init` maps
a table's position in the configuration's `init` list to the keys that
change in it."""
import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_path(name):
    return os.path.join(ROOT, "benchmark", "tiny", name + ".json")


def tiny_config(entry):
    """The tiny copy of the configuration of a BENCHMARK.json entry."""
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    with open(tiny_path(entry["name"])) as f:
        tiny = json.load(f)
    for group, values in tiny.items():
        if group == "init":
            for i, v in values.items():
                cfg["init"][int(i)].update(v)
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
    for c in man["configs"]:
        # a configuration without a tiny copy fails its own cells (its file
        # is missing here) and test_bench_manifest's case for it, no other
        if os.path.exists(tiny_path(c["name"])):
            path = tmp_path / c["file"]
            os.makedirs(path.parent, exist_ok=True)
            with open(path, "w") as f:
                json.dump(tiny_config(c), f)
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
