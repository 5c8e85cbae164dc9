"""The port's dataset registry (graphvite_tpu_torch/dataset.py) against the
reference's (graphvite_tpu/dataset.py) on the same inputs: the registry's
tables, the split helpers, Math's generated splits, and every preprocess
hook that runs offline on small raw files placed in the dataset
directory (the archives' own layouts: zip and tar members, gzip files,
MNIST's idx, CIFAR10's batches). Files must be byte-identical. ImageNet's
feature extraction runs with torchvision stubbed: on CUDA by default,
its weights from a file under the dataset path. Each test
has dataset directories of its own under `tmp_path`, and no test reaches
the network: a download raises."""
import gzip
import io
import os
import struct
import sys
import tarfile
import types
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from graphvite_tpu import dataset as ref_ds
from graphvite_tpu_torch import dataset as port_ds


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(url, *args, **kwargs):
        raise OSError("no network in tests: %s" % url)
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


@pytest.fixture
def make(tmp_path, monkeypatch):
    """make(cls_name) -> (reference instance, port instance), each under a
    dataset directory of its own."""
    for mod, name in ((ref_ds, "ref"), (port_ds, "port")):
        monkeypatch.setattr(mod, "DATASET_PATH", str(tmp_path / name))

    def build(cls_name):
        return getattr(ref_ds, cls_name)(), getattr(port_ds, cls_name)()
    return build


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same_files(ref, port, key):
    a, b = getattr(ref, key), getattr(port, key)
    assert os.path.basename(a) == os.path.basename(b)
    assert os.path.dirname(a) == ref.path and os.path.dirname(b) == port.path
    assert _read(a) == _read(b), key
    return a, b


def _place(datasets, name, data):
    """Put raw file `name` with bytes `data` into each dataset's dir."""
    for d in datasets:
        os.makedirs(d.path, exist_ok=True)
        with open(os.path.join(d.path, name), "wb") as f:
            f.write(data)


def _gz(text):
    return gzip.compress(text.encode(), mtime=0)


def _zip(members):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, text in members.items():
            z.writestr(name, text)
    return buf.getvalue()


def _tgz(members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as t:
        for name, data in members.items():
            data = data.encode() if isinstance(data, str) else data
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _edges(rng, n, v, sep="\t"):
    return "".join("%d%s%d\n" % (a, sep, b)
                   for a, b in rng.integers(v, size=(n, 2)))


def test_registry_matches_reference():
    assert set(port_ds.DATASETS) == set(ref_ds.DATASETS)
    for key, ref in ref_ds.DATASETS.items():
        port = port_ds.DATASETS[key]
        assert type(port).__name__ == type(ref).__name__
        assert port.name == ref.name
        assert port.urls == ref.urls and port.members == ref.members
        hooks = {n for n in dir(ref) if n.endswith("_preprocess")}
        assert hooks == {n for n in dir(port) if n.endswith("_preprocess")}
    assert port_ds.fb15k237 is port_ds.DATASETS["fb15k-237"]


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_math_splits_are_byte_identical(make, split):
    ref, port = make("Math")
    a, _ = _same_files(ref, port, split)
    assert len(_read(a).splitlines()) == (20000 if split == "train"
                                          else 1000)


def _helper_inputs(tmp_path):
    rng = np.random.default_rng(3)
    graph = tmp_path / "graph.txt"
    graph.write_text(_edges(rng, 700, 80) + "\n" + _edges(rng, 20, 80))
    node_label = tmp_path / "node_label.txt"
    node_label.write_text("".join(
        "n%d\tc%d\n" % (rng.integers(60), rng.zipf(1.6) % 12)
        for _ in range(300)))
    communities = tmp_path / "communities.txt"
    communities.write_text("".join(
        " ".join("n%d" % x for x in rng.integers(500, size=rng.integers(
            1, 30))) + "\n" for _ in range(25)))
    table = tmp_path / "table.csv"
    table.write_text('1,2\n3,"4,5"\n6,7\n')
    return graph, node_label, communities, table


@pytest.mark.parametrize("helper", ["csv2txt", "top_k_label",
                                    "top_k_label_communities",
                                    "link_prediction_split", "edge_split"])
def test_split_helpers_are_byte_identical(tmp_path, helper):
    graph, node_label, communities, table = _helper_inputs(tmp_path)
    outs = []
    for mod in (ref_ds, port_ds):
        d = tmp_path / mod.__name__
        d.mkdir()
        files = [str(d / ("%d.txt" % i)) for i in range(3)]
        if helper == "csv2txt":
            mod.csv2txt(str(table), files[0])
            files = files[:1]
        elif helper == "top_k_label":
            mod.top_k_label(str(node_label), files[0], k=5)
            files = files[:1]
        elif helper == "top_k_label_communities":
            mod.top_k_label(str(communities), files[0], k=7,
                            format="(label)-nodes")
            files = files[:1]
        elif helper == "link_prediction_split":
            mod.link_prediction_split(str(graph), files, portions=[20, 1, 1])
        else:
            mod.edge_split(str(graph), files, portions=[8, 1, 1])
        outs.append([_read(f) for f in files])
    assert outs[0] == outs[1]
    assert all(outs[1])


def test_split_helpers_reseed_numpy_as_the_reference_does(tmp_path):
    """Both re-seed numpy's global generator (np.random.seed(1024)), so
    whatever draws next follows the same stream."""
    graph = _helper_inputs(tmp_path)[0]
    files = [str(tmp_path / ("%d.txt" % i)) for i in range(3)]
    draws = []
    for mod in (ref_ds, port_ds):
        np.random.seed(7)
        mod.edge_split(str(graph), files, portions=[1, 1, 1])
        draws.append(np.random.random(4))
    np.testing.assert_array_equal(draws[0], draws[1])


def test_blogcatalog_preprocess_offline(make):
    ref, port = make("BlogCatalog")
    rng = np.random.default_rng(0)
    raw = _zip({"BlogCatalog-dataset/data/edges.csv": _edges(rng, 400, 60,
                                                             sep=","),
                "BlogCatalog-dataset/data/group-edges.csv":
                    _edges(rng, 90, 60, sep=",")})
    _place((ref, port), "BlogCatalog-dataset.zip", raw)
    for key in ("graph", "label", "train", "valid", "test"):
        _same_files(ref, port, key)
    assert b"," not in _read(port.graph)


def _hookless(ref, port, key, raw):
    """A split with no preprocess hook: the port copies the extracted raw
    file; the reference's lookup of the missing hook recurses (a
    divergence the port records), unless the split's file is local."""
    with pytest.raises(RecursionError):
        ref.get_file(key)
    assert _read(getattr(port, key)) == raw
    os.makedirs(ref.path, exist_ok=True)
    with open(os.path.join(ref.path, os.path.basename(getattr(port, key))),
              "wb") as f:
        f.write(raw)
    _same_files(ref, port, key)


def test_friendster_preprocess_offline(make):
    ref, port = make("Friendster")
    rng = np.random.default_rng(1)
    graph = "# comment line\n" + _edges(rng, 600, 200)
    cmty = "".join(" ".join(str(x) for x in rng.integers(
        120, size=rng.integers(2, 40))) + "\n" for _ in range(130))
    _place((ref, port), "com-friendster.ungraph.txt.gz", _gz(graph))
    _place((ref, port), "com-friendster.top5000.cmty.txt.gz", _gz(cmty))
    for key in ("small_graph", "label"):
        _same_files(ref, port, key)
    assert _read(port.small_graph).count(b"\n") < 600
    _hookless(ref, port, "graph", graph.encode())


@pytest.mark.parametrize("cls_name,raw_name,k", [
    ("Youtube", "youtube-groupmemberships.txt.gz", 47),
    ("Flickr", "flickr-groupmemberships.txt.gz", 195)])
def test_top_k_label_preprocess_offline(make, cls_name, raw_name, k):
    ref, port = make(cls_name)
    rng = np.random.default_rng(2)
    labels = "".join("%d\t%d\n" % (rng.integers(300), rng.zipf(1.4) % 400)
                     for _ in range(2000))
    _place((ref, port), raw_name, _gz(labels))
    _same_files(ref, port, "label")


def test_hyperlink_split_offline(make):
    ref, port = make("Hyperlink2012")
    rng = np.random.default_rng(4)
    _place((ref, port), "pld-arc.gz", _gz(_edges(rng, 9000, 400)))
    for key in ("pld_train", "pld_valid", "pld_test"):
        _same_files(ref, port, key)


@pytest.mark.parametrize("cls_name,archive", [("FB15k", "fb15k.tgz"),
                                              ("WN18RR", "wn18rr.zip")])
def test_triplet_archive_members_offline(make, cls_name, archive):
    """A tar member (FB15k) and a zip member (WN18RR) extracted by name."""
    ref, port = make(cls_name)
    rng = np.random.default_rng(5)
    members = {ref.members[k]: "".join(
        "e%d\tr%d\te%d\n" % tuple(rng.integers(50, size=3))
        for _ in range(40)) for k in ("train", "valid", "test")}
    _place((ref, port), archive,
           _tgz(members) if archive.endswith(".tgz") else _zip(members))
    for key in ("train", "valid", "test"):
        _hookless(ref, port, key, members[ref.members[key]].encode())


def _idx(array):
    header = struct.pack(">HBB", 0, 8, array.ndim)
    header += struct.pack(">" + "I" * array.ndim, *array.shape)
    return gzip.compress(header + array.astype(np.uint8).tobytes(), mtime=0)


def test_mnist_idx_offline(make):
    ref, port = make("MNIST")
    rng = np.random.default_rng(6)
    for split, n in (("train", 12), ("t10k", 5)):
        _place((ref, port), "%s-images-idx3-ubyte.gz" % split,
               _idx(rng.integers(256, size=(n, 28, 28))))
        _place((ref, port), "%s-labels-idx1-ubyte.gz" % split,
               _idx(rng.integers(10, size=n)))
    for key in ("image_data", "label_data"):
        # the reference reaches these only through get_file: its attribute
        # lookup recurses for a split with no url and no hook
        with pytest.raises(RecursionError):
            getattr(ref, key)
        a, b = ref.get_file(key), getattr(port, key)
        assert _read(a) == _read(b)
        assert np.load(b).shape[0] == 17
    raw = os.path.join(port.path, "t10k-images-idx3-ubyte")
    np.testing.assert_array_equal(port_ds.MNIST._read_idx(raw),
                                  ref_ds.MNIST._read_idx(raw))


def test_cifar10_batches_offline(make):
    ref, port = make("CIFAR10")
    rng = np.random.default_rng(7)
    names = ["data_batch_%d.bin" % i for i in range(1, 6)] + ["test_batch.bin"]
    raw = _tgz({"cifar-10-batches-bin/" + name:
                rng.integers(256, size=(3, 3073)).astype(np.uint8).tobytes()
                for name in names})
    _place((ref, port), "cifar-10-binary.tar.gz", raw)
    for key in ("image_data", "label_data"):
        _same_files(ref, port, key)
    assert np.load(port.image_data).shape == (18, 32, 32, 3)


def test_missing_files_raise_naming_the_local_path(make):
    """Without the network a download fails as the reference's does: a
    RuntimeError that says where to place the file."""
    ref, port = make("Wikipedia")
    for d in (ref, port):
        with pytest.raises(RuntimeError, match="place the file at %s"
                           % os.path.join(d.path, "enwiki-")):
            d.graph
    with pytest.raises(AttributeError, match="has no split `nope`"):
        port.nope
    with pytest.raises(RecursionError):
        ref.nope
    ref, port = make("ImageNet")
    for d in (ref, port):
        with pytest.raises(RuntimeError, match="imagenet_image_data.npy"):
            d.feature_data


class _MovedToCuda(Exception):
    pass


class _TinyNet(torch.nn.Module):
    """Stands in for a torchvision model: a seeded conv and a head `fc`.
    Built with weights="IMAGENET1K_V1" (as the reference asks) it holds
    the "pretrained" parameters; with weights=None, others. It records
    where it is moved, and refuses to move to CUDA, which this test's
    torch lacks."""
    moved_to = []

    def __init__(self, weights=None):
        assert weights in (None, "IMAGENET1K_V1")
        super().__init__()
        torch.manual_seed(1 if weights else 2)
        self.body = torch.nn.Conv2d(3, 5, 3)
        self.fc = torch.nn.Linear(5, 7)

    def forward(self, x):
        return self.fc(self.body(x).mean(dim=(2, 3)))

    def to(self, device):
        _TinyNet.moved_to.append(torch.device(device))
        if torch.device(device).type == "cuda":
            raise _MovedToCuda
        return super().to(device)


@pytest.fixture
def torchvision_stub(monkeypatch, tmp_path):
    """torchvision with `resnet50` as _TinyNet, and its pretrained state
    dict saved where ImageNet looks for it; returns that file."""
    models = types.ModuleType("torchvision.models")
    models.resnet50 = _TinyNet
    tv = types.ModuleType("torchvision")
    tv.models = models
    monkeypatch.setitem(sys.modules, "torchvision", tv)
    monkeypatch.setitem(sys.modules, "torchvision.models", models)
    monkeypatch.setattr(port_ds, "DATASET_PATH", str(tmp_path))
    _TinyNet.moved_to = []
    weights = tmp_path / "imagenet" / "resnet50.pth"
    weights.parent.mkdir()
    torch.save(_TinyNet(weights="IMAGENET1K_V1").state_dict(), weights)
    return weights


def test_image_features_default_to_cuda(torchvision_stub, monkeypatch):
    """With no `device` the features are computed on CUDA: where there is
    none it raises as every entry point does, and where there is one the
    net goes there."""
    images = np.zeros((2, 8, 8, 3), np.uint8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_ds.image_feature_data(images)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(_MovedToCuda):
        port_ds.image_feature_data(images)
    assert _TinyNet.moved_to == [torch.device("cuda")]


def test_image_features_read_local_weights(torchvision_stub, tmp_path):
    """On the CPU, with the weights read from the file under the dataset
    path, the features equal the reference's, whose torchvision call
    fetches the same weights; without the file it raises naming the path
    and reaches for nothing."""
    rng = np.random.default_rng(0)
    for shape in ((5, 8, 8, 3), (3, 8, 8)):
        images = rng.integers(256, size=shape).astype(np.uint8)
        got = port_ds.image_feature_data(images, batch_size=2, device="cpu")
        assert got.shape == (shape[0], 5)
        np.testing.assert_allclose(
            got, ref_ds.image_feature_data(images, batch_size=2),
            rtol=1e-6, atol=1e-6)
    os.remove(torchvision_stub)
    with pytest.raises(RuntimeError, match="place torchvision's pretrained "
                       "resnet50 state dict at %s" % torchvision_stub):
        port_ds.image_feature_data(images, device="cpu")
