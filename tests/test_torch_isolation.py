"""graphvite_tpu_torch stands alone: it imports no JAX, nothing of the JAX
package, and none of the packages the card's host lacks (ml_dtypes, yaml,
pandas); its entry points run on CUDA unless asked for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import graphvite_tpu_torch
from graphvite_tpu_torch import (GraphApplication, GraphSolver, KNNGraph,
                                 KnowledgeGraphApplication,
                                 KnowledgeGraphSolver,
                                 VisualizationApplication,
                                 VisualizationSolver)

PACKAGE_DIR = os.path.dirname(graphvite_tpu_torch.__file__)
REPO = os.path.dirname(PACKAGE_DIR)
FORBIDDEN = ("jax", "jaxlib", "graphvite_tpu", "ml_dtypes", "yaml", "pandas")


def _modules():
    names = ["graphvite_tpu_torch"]
    for info in pkgutil.walk_packages([PACKAGE_DIR], "graphvite_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_with_jax_blocked():
    """Import every module of the port in a fresh interpreter in which the
    forbidden packages cannot be imported at all."""
    code = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %r:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for name in %r:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not loaded, loaded
print("ok", len(%r))
""" % (FORBIDDEN, _modules(), FORBIDDEN, _modules())
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_cli_modules_are_walked_and_run_with_yaml_blocked(tmp_path):
    """The command line's modules are in the walk above, and its runtime
    paths (the YAML reader, the registry, `list`) run in an interpreter
    where the forbidden packages cannot be imported."""
    for name in ("cmd", "dataset", "word_graph", "utils.yaml_lite"):
        assert "graphvite_tpu_torch." + name in _modules()
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %r:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
from graphvite_tpu_torch import cmd
cfg = cmd.load_config("config/demo/math.yaml")
assert cfg["build"]["optimizer"].type == "Adam", cfg
assert cfg["build"]["num_partition"] == 0, cfg
with open(cfg["graph"]["file_name"]) as f:
    assert len(f.read().splitlines()) == 20000
cmd.main(["list"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not loaded, loaded
""" % (FORBIDDEN, FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=REPO,
               GRAPHVITE_DATASET_PATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "total: 47 baselines" in out.stdout
    assert os.path.isfile(tmp_path / "math" / "math_test.txt")


def test_run_config_defaults_to_cuda(tmp_path):
    """A config whose resource section names no device runs on CUDA, and
    raises where there is none; `device: cpu` runs on the CPU."""
    from graphvite_tpu_torch import cmd

    edges = tmp_path / "edges.txt"
    edges.write_text("a\tb\nb\tc\nc\ta\n")
    config = tmp_path / "c.yaml"
    text = """application: graph
resource:
  dim: 4
%sgraph:
  file_name: %s
build:
  batch_size: 8
train:
  model: LINE
  num_epoch: 1
  augmentation_step: 1
"""
    config.write_text(text % ("", edges))
    cfg = cmd.load_config(str(config))
    if torch.cuda.is_available():
        app, _ = cmd.run_config(cfg)
        assert app.solver.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cmd.run_config(cfg)
    config.write_text(text % ("  device: cpu\n", edges))
    app, _ = cmd.run_config(cmd.load_config(str(config)))
    assert app.solver.device.type == "cpu"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    files = []
    for root, _, names in os.walk(PACKAGE_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_kg_engines_and_host_samplers_are_walked():
    """The knowledge-graph engines and the host samplers are among the
    modules imported above with the forbidden packages blocked, and their
    sources import none of them."""
    names = _modules()
    for name in ("graphvite_tpu_torch.parallel.kg",
                 "graphvite_tpu_torch.sampler"):
        assert name in names
        path = os.path.join(REPO, *name.split(".")) + ".py"
        imports = list(_imports(path))
        assert imports
        assert not [n for n in imports if n.split(".")[0] in FORBIDDEN]


def test_entry_points_default_to_cuda():
    """With no `device`, the solver and the application ask for CUDA, and
    raise where there is none (here, a CPU-only torch)."""
    entries = (GraphSolver, GraphApplication, KnowledgeGraphSolver,
               KnowledgeGraphApplication, VisualizationSolver,
               VisualizationApplication)
    if torch.cuda.is_available():
        assert GraphSolver(dim=4).device.type == "cuda"
        assert KnowledgeGraphSolver(dim=4).device.type == "cuda"
        assert VisualizationSolver(dim=2).device.type == "cuda"
        assert KNNGraph().device.type == "cuda"
        return
    for entry in entries:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(dim=4)
    assert GraphSolver(dim=4, device="cpu").device.type == "cpu"
    assert KnowledgeGraphSolver(dim=4, device="cpu").device.type == "cpu"
    assert VisualizationSolver(dim=2, device="cpu").device.type == "cpu"


def test_knn_graph_defaults_to_cuda():
    """KNNGraph builds on CUDA unless asked for the CPU, and so do the
    search functions given numpy vectors."""
    import numpy as np

    from graphvite_tpu_torch import knn

    if torch.cuda.is_available():
        assert KNNGraph().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KNNGraph()
    x = np.zeros((10, 3), np.float32)
    for fn in (knn.exact_knn, knn.ivf_knn):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(x, 3)
    assert KNNGraph(device="cpu").device.type == "cpu"


def test_knn_casts_with_torch():
    """The IVF search's bfloat16 rows come from torch's own cast (the
    reference casts with ml_dtypes on the host): round to nearest even."""
    from graphvite_tpu_torch import knn

    x = torch.tensor([[1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8]])
    got = knn._upload(x.numpy(), torch.device("cpu"), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert got.float().tolist() == [[1.0, 1.0 + 2 ** -6]]


def test_child_scripts_import_nothing_forbidden():
    """The scripts that run as processes of a multi-process group (the
    multi-host test's processes, and chip_smoke.py's multihost children)
    import none of the forbidden packages at their top level: only
    functions the parent alone calls import JAX. The processes also
    assert, before they exit, that none of them was loaded."""
    for path in (os.path.join(REPO, "tests", "test_torch_multihost.py"),
                 os.path.join(REPO, "chip_smoke.py")):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        top = []
        for node in tree.body:
            if isinstance(node, ast.Import):
                top += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                top.append(node.module)
        assert top, path
        assert not [n for n in top if n.split(".")[0] in FORBIDDEN], path
        with open(path) as f:
            assert "FORBIDDEN" in f.read(), path
