"""The port's command line (graphvite_tpu_torch/cmd.py) against the
reference's (graphvite_tpu/cmd.py).

Deterministic parts must be equal: `load_config` on every shipped config
(the registry stubbed) and on the real registry (Math's splits, `auto`,
the optimizer field by field, `.npy` vectors), `find_baselines`, the
`list` output, the `new` templates byte for byte, and the global config
file. The slice as a whole runs on the CPU through `resource: device:
cpu`: a two-block edge-list config through both packages' `run_config`
(LINE on the edge route, aug 1, and on the walk route, aug 2): AUC > 0.9
each and the port within 0.03 of the reference (the random streams
differ, threefry against Philox, so the comparison is statistical); a
small math config, its MRR within 0.03 of the reference's; a tiny
word-graph config; and the `visualize` subcommand on two Gaussian blobs,
1-NN blob agreement within 0.05 of the reference's. Dataset directories are
per test, under `tmp_path`; no test reaches the network."""
import dataclasses
import os
import urllib.request

import numpy as np
import pytest
import torch

from graphvite_tpu import base as ref_base
from graphvite_tpu import cmd as ref_cmd
from graphvite_tpu import dataset as ref_ds
from graphvite_tpu.optim import Optimizer as RefOptimizer
from graphvite_tpu.word_graph import WordGraph as RefWordGraph
from graphvite_tpu_torch import application as port_app
from graphvite_tpu_torch import base as port_base
from graphvite_tpu_torch import cmd as port_cmd
from graphvite_tpu_torch import dataset as port_ds
from graphvite_tpu_torch.optim import Optimizer as PortOptimizer
from graphvite_tpu_torch.word_graph import WordGraph

CONFIG_DIR = port_cmd.get_config_path()
CONFIGS = sorted(os.path.relpath(os.path.join(p, f), CONFIG_DIR)
                 for p, _, files in os.walk(CONFIG_DIR) for f in files)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: with one thread per core in each test worker,
    the many tiny ops of these runs wait on the other workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(url, *args, **kwargs):
        raise OSError("no network in tests: %s" % url)
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


@pytest.fixture
def math_dirs(tmp_path, monkeypatch):
    """The registry's Math datasets of both packages, under tmp_path."""
    for ds, name in ((ref_ds, "ref"), (port_ds, "port")):
        monkeypatch.setattr(ds.math, "path", str(tmp_path / name / "math"))


def _plain(cfg):
    """A loaded config with each Optimizer as a tagged field dict."""
    if isinstance(cfg, dict):
        return {k: _plain(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [_plain(v) for v in cfg]
    if isinstance(cfg, (RefOptimizer, PortOptimizer)):
        return ("Optimizer", dataclasses.asdict(cfg))
    if isinstance(cfg, np.ndarray):
        return ("array", cfg.dtype.str, cfg.shape, cfg.tobytes())
    return (type(cfg).__name__, cfg)


class _Split:
    def __init__(self, name):
        self.name = name

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        return "/datasets/%s/%s_%s.txt" % (self.name, self.name, key)


class _Registry(dict):
    """Any dataset name resolves to a stub whose splits are paths."""

    def get(self, name, default=None):
        return _Split(name)


def test_every_shipped_config_is_listed():
    assert len(CONFIGS) == 51
    assert sum(not c.startswith("template") for c in CONFIGS) == 47


@pytest.mark.parametrize("config", CONFIGS)
def test_load_config_matches_reference(config, monkeypatch):
    for ds in (ref_ds, port_ds):
        monkeypatch.setattr(ds, "DATASETS", _Registry())
    path = os.path.join(CONFIG_DIR, config)
    ref = ref_cmd.load_config(path)
    port = port_cmd.load_config(path)
    assert _plain(port) == _plain(ref)
    if isinstance(ref.get("build", {}).get("optimizer"), RefOptimizer):
        assert isinstance(port["build"]["optimizer"], PortOptimizer)


def test_load_config_resolves_the_registry(tmp_path, math_dirs):
    vectors = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.save(tmp_path / "vectors.npy", vectors)
    config = tmp_path / "c.yaml"
    config.write_text("""application: knowledge graph
resource:
  dim: 32
graph:
  file_name: <math.train>
  vectors: %s
build:
  optimizer:
    type: Adam
    lr: 1.0e-3
    weight_decay: 5e-06
  num_negative: auto
  num_partition: 'auto'
evaluate:
  - task: link prediction
    file_name: <math.test>
    filter_files: [<math.train>, <math.valid>, <math.test>]
""" % (tmp_path / "vectors.npy"))
    ref = ref_cmd.load_config(str(config))
    port = port_cmd.load_config(str(config))
    assert port["build"]["num_negative"] == 0       # auto
    assert port["build"]["num_partition"] == 0      # quoted, still auto
    opt = port["build"]["optimizer"]
    assert dataclasses.asdict(opt) == dataclasses.asdict(
        ref["build"]["optimizer"])
    np.testing.assert_array_equal(port["graph"]["vectors"], vectors)
    # the splits are the registries' own files, byte for byte
    files = [port["graph"]["file_name"], port["evaluate"][0]["file_name"]]
    files += port["evaluate"][0]["filter_files"]
    ref_files = [ref["graph"]["file_name"], ref["evaluate"][0]["file_name"]]
    ref_files += ref["evaluate"][0]["filter_files"]
    for a, b in zip(ref_files, files):
        assert b.startswith(str(tmp_path / "port"))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_unknown_datasets_and_splits_raise(tmp_path):
    config = tmp_path / "c.yaml"
    config.write_text("graph:\n  file_name: <nope.train>\n")
    for cmd in (ref_cmd, port_cmd):
        with pytest.raises(ValueError, match="unknown dataset `nope`"):
            cmd.load_config(str(config))
    # largevis_imagenet.yaml names a split ImageNet does not have (the
    # reference's lookup recurses there)
    config.write_text("graph:\n  file_name: <imagenet.hierarchical_label>\n")
    with pytest.raises(AttributeError, match="no split `hierarchical_label`"):
        port_cmd.load_config(str(config))
    template = port_cmd.load_config(os.path.join(CONFIG_DIR, "template",
                                                 "graph.yaml"))
    assert template["graph"]["file_name"] is None       # "# FILL ME"


@pytest.mark.parametrize("keywords", [["quick", "start"], ["rotate"],
                                      ["line"], ["wikipedia"], ["fb15k"],
                                      ["graph"], ["nothing"]])
def test_find_baselines_matches_reference(keywords):
    assert port_cmd.find_baselines(keywords) == ref_cmd.find_baselines(
        keywords)


def test_list_output_matches_reference(capsys):
    ref_cmd.main(["list"])
    ref = capsys.readouterr().out
    port_cmd.main(["list"])
    port = capsys.readouterr().out
    assert port == ref
    assert port.strip().endswith("total: 47 baselines")


@pytest.mark.parametrize("application", [["graph"], ["word", "graph"],
                                         ["knowledge", "graph"],
                                         ["visualization"]])
def test_new_templates_are_byte_identical(tmp_path, application):
    written = []
    for cmd, name in ((ref_cmd, "ref.yaml"), (port_cmd, "port.yaml")):
        out = str(tmp_path / name)
        cmd.main(["new"] + application + ["--file", out])
        with pytest.raises(IOError, match="--force"):
            cmd.main(["new"] + application + ["--file", out])
        cmd.main(["new"] + application + ["--file", out, "--force"])
        with open(out, "rb") as f:
            written.append(f.read())
    assert written[0] == written[1]
    assert port_cmd.load_config(str(tmp_path / "port.yaml"))[
        "application"] == " ".join(application)


def test_new_unknown_template_raises_like_reference(tmp_path):
    messages = []
    for cmd in (ref_cmd, port_cmd):
        with pytest.raises(ValueError) as err:
            cmd.main(["new", "nothing", "--file", str(tmp_path / "x.yaml")])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_global_config_matches_reference(tmp_path, monkeypatch):
    config = tmp_path / "config.yaml"
    config.write_text("dataset_path: ~/my_datasets\nfloat_type: bfloat16\n"
                      "index_type: uint64\nbackend: torch  # comment\n")
    for base in (ref_base, port_base):
        monkeypatch.setattr(base, "CONFIG_FILE", str(config))
        for name in ("dataset_path", "float_type", "index_type", "backend"):
            monkeypatch.setattr(base, name, getattr(base, name))
        base.load_global_config()
    assert port_base.dataset_path == ref_base.dataset_path == \
        os.path.expanduser("~/my_datasets")
    assert np.dtype(ref_base.float_type).name == "bfloat16"
    assert port_base.float_type is torch.bfloat16
    assert ref_base.index_type is np.int64
    assert port_base.index_type is torch.int64
    assert port_base.backend == ref_base.backend == "torch"
    # a missing file leaves the defaults
    monkeypatch.setattr(port_base, "CONFIG_FILE", str(tmp_path / "none"))
    monkeypatch.setattr(port_base, "float_type", torch.float32)
    port_base.load_global_config()
    assert port_base.float_type is torch.float32


# -- the slice as a whole, on the CPU --------------------------------------

def _two_blocks(tmp_path, n=60, seed=0):
    """Two dense communities with sparse cross links (tests/test_solver.py),
    as an edge-list file, and a link-prediction file: 300 of its edges
    against 300 cross-block pairs."""
    rng = np.random.default_rng(seed)
    half = n // 2
    edges = []
    for _ in range(n * 6):
        c = rng.integers(2)
        u, v = rng.integers(half, size=2) + c * half
        if u != v:
            edges.append((u, v))
    edges += [(rng.integers(half), rng.integers(half) + half)
              for _ in range(n // 10)]
    graph = tmp_path / "graph.txt"
    graph.write_text("".join("%d\t%d\n" % e for e in edges))
    picks = rng.choice(len(edges), 300, replace=False)
    links = ["%d\t%d\t1\n" % edges[i] for i in picks]
    links += ["%d\t%d\t0\n" % (rng.integers(half), rng.integers(half) + half)
              for _ in range(300)]
    (tmp_path / "links.txt").write_text("".join(links))
    return graph, tmp_path / "links.txt"


TWO_BLOCKS = {
    # LINE on the edge route, the smoke's quality settings
    1: """build:
  num_negative: 2
  batch_size: 512
  episode_size: 8
train:
  model: LINE
  num_epoch: 1000
  augmentation_step: 1
  negative_weight: 1
  log_frequency: 1000000000
""",
    # LINE on the walk route, tests/test_torch_solver.py's settings
    2: """build:
  optimizer:
    type: SGD
    lr: 0.1
    weight_decay: 5.0e-3
  num_negative: 1
  batch_size: 2048
  episode_size: 8
train:
  model: LINE
  num_epoch: 2000
  augmentation_step: 2
  random_walk_length: 8
  negative_weight: 1
  log_frequency: 1000000000
"""}


@pytest.mark.parametrize("aug", [1, 2])
def test_run_config_two_blocks_like_the_reference(tmp_path, aug):
    graph, links = _two_blocks(tmp_path)
    config = tmp_path / "two_blocks.yaml"
    config.write_text("""application: graph
resource:
  dim: 16
  device: cpu
graph:
  file_name: %s
  as_undirected: true
%sevaluate:
  task: link prediction
  file_name: %s
save:
  file_name: %s
""" % (graph, TWO_BLOCKS[aug], links, tmp_path / "model.pkl"))
    aucs = []
    for cmd in (ref_cmd, port_cmd):
        app, results = cmd.run_config(cmd.load_config(str(config)))
        aucs.append(results[0]["AUC"])
        assert os.path.isfile(tmp_path / "model.pkl")
        os.remove(tmp_path / "model.pkl")
    assert app.solver.device.type == "cpu"
    assert app.solver.augmentation_step == aug
    ref_auc, port_auc = aucs
    assert port_auc > 0.9 and ref_auc > 0.9, aucs
    assert abs(port_auc - ref_auc) < 0.03, aucs


def test_run_config_math(tmp_path, math_dirs):
    """A small math config through both packages' `run_config`: the math
    fixture's splits from each registry, RotatE at the settings of
    tests/test_torch_kg_solver.py's math test at dim 16, the filtered
    tail MRR on all 1,000 test triplets above a floor well over chance
    (~0.0075; both packages reach 0.03-0.055 over four seeds) and the
    port's within 0.03 of the reference's; the model pickled."""
    config = tmp_path / "small.yaml"
    config.write_text("""application: knowledge graph
resource:
  dim: 16
  device: cpu
graph:
  file_name: <math.train>
build:
  optimizer:
    type: Adam
    lr: 1.0e-2
    weight_decay: 0
  num_negative: 8
  batch_size: 2000
  episode_size: 100
train:
  model: RotatE
  num_epoch: 40
  margin: 9
  adversarial_temperature: 2
  log_frequency: 1000000
evaluate:
  task: link prediction
  file_name: <math.test>
  filter_files:
    - <math.train>
    - <math.valid>
    - <math.test>
  target: tail
save:
  file_name: %s
""" % (tmp_path / "m.pkl"))
    mrr = {}
    for name, cmd in (("ref", ref_cmd), ("port", port_cmd)):
        app, results = cmd.run_config(cmd.load_config(str(config)))
        mrr[name] = results[0]["MRR"]
        assert os.path.isfile(tmp_path / "m.pkl")
        os.remove(tmp_path / "m.pkl")
    assert app.solver.device.type == "cpu"
    assert mrr["port"] > 0.02, mrr
    assert abs(mrr["port"] - mrr["ref"]) < 0.03, mrr


def test_run_config_word_graph(tmp_path):
    """A tiny word-graph config: the corpus -> graph -> LINE pipeline, the
    model saved and reloaded with the same scores."""
    rng = np.random.default_rng(0)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("".join(
        " ".join("w%d" % w for w in rng.zipf(1.6, 12) % 80) + "\n"
        for _ in range(400)))
    config = tmp_path / "words.yaml"
    config.write_text("""application: word graph
resource:
  dim: 16
  device: cpu
graph:
  file_name: %s
  window: 3
  min_count: 2
build:
  optimizer:
    type: SGD
    lr: 0.025
    weight_decay: 0.005
  num_negative: 1
  batch_size: 4096
  episode_size: auto
train:
  model: LINE
  num_epoch: 20
  negative_weight: 5
  augmentation_step: 1
  log_frequency: 1000
save:
  file_name: %s
""" % (corpus, tmp_path / "words.pkl"))
    cfg = port_cmd.load_config(str(config))
    app, results = port_cmd.run_config(cfg)
    assert results == []
    g = app.graph
    ref = RefWordGraph().load_file(str(corpus), window=3, min_count=2)
    assert isinstance(g, WordGraph) and g.id2name == ref.id2name
    np.testing.assert_array_equal(g.edge_weights, ref.edge_weights)
    s = app.solver
    assert s.batch_id > 0 and bool(torch.isfinite(s.batch_losses).all())
    again = port_app.Application("word graph", dim=16, device="cpu")
    again.graph = g
    again.solver.build(g)
    again.load_model(cfg["save"]["file_name"])
    pairs = rng.integers(g.num_vertex, size=(64, 2))
    np.testing.assert_array_equal(again.solver.predict(pairs),
                                  s.predict(pairs))


def _blob_agreement(coords):
    """The share of points whose nearest neighbour in the layout lies in
    their own blob (two blobs of 40)."""
    d = ((coords[:, None] - coords[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return (d.argmin(1) // 40 == np.arange(80) // 40).mean()


def test_visualize_subcommand(tmp_path, monkeypatch):
    """`visualize <vectors> --label <labels> --save out.png` through both
    packages' `main`: the KNN graph, LargeVis and the scatter, on two
    Gaussian blobs (the port's visualization application pinned to the
    CPU, as the subcommand has no device flag). Each layout keeps the
    blobs apart, 1-NN blob agreement > 0.95, and the port's agreement is
    within 0.05 of the reference's."""
    from graphvite_tpu import application as ref_app

    rng = np.random.default_rng(0)
    vectors = np.concatenate([rng.normal(0, 1, (40, 8)),
                              rng.normal(5, 1, (40, 8))]).astype(np.float32)
    np.save(tmp_path / "vec.npy", vectors)
    np.savetxt(tmp_path / "lab.txt", np.array([0] * 40 + [1] * 40))
    made = {}
    for name, mod, kwargs in (("ref", ref_app, {}),
                              ("port", port_app, {"device": "cpu"})):
        def record(dim, cls=mod.VisualizationApplication, name=name,
                   kwargs=kwargs):
            made[name] = cls(dim, **kwargs)
            return made[name]
        monkeypatch.setattr(mod, "VisualizationApplication", record)
    agree = {}
    for name, cmd in (("ref", ref_cmd), ("port", port_cmd)):
        out = tmp_path / ("%s.png" % name)
        cmd.main(["visualize", str(tmp_path / "vec.npy"), "--label",
                  str(tmp_path / "lab.txt"), "--save", str(out),
                  "--perplexity", "10"])
        assert out.exists() and out.stat().st_size > 0
        coords = np.asarray(made[name].solver.coordinates)
        assert coords.shape == (80, 2) and np.isfinite(coords).all()
        agree[name] = _blob_agreement(coords)
    assert made["port"].solver.device.type == "cpu"
    assert agree["port"] > 0.95 and agree["ref"] > 0.95, agree
    assert abs(agree["port"] - agree["ref"]) <= 0.05, agree
