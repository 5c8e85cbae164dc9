"""Dataset registry with lazy download / extract / preprocess (the port's
copy of graphvite_tpu/dataset.py, host numpy code with no JAX).

The same dataset names, split keys and download sources as the reference
(python/graphvite/dataset.py:62-1095), around a declarative table of urls
and archive members. Accessing `dataset.<split>` returns a local file
path, materializing it on first use (download -> extract -> preprocess).
Files already under the data path are used as they are, so a split
placed there by hand (or generated offline, as Math's) needs no network;
a download that fails raises a RuntimeError naming the local path.
`image_feature_data` needs torchvision and a file of pretrained weights
under the data path, and runs on CUDA unless asked for the CPU.

Datasets (ref dataset.py line refs): BlogCatalog :400, Youtube :448,
Flickr :468, Hyperlink2012 :488, Friendster :521, Wikipedia :546, Math :562,
FB15k :612, FB15k237 :630, WN18 :648, WN18RR :666, Wikidata5m :684,
Freebase :742, MNIST :758, CIFAR10 :796, ImageNet :864.
"""
from __future__ import annotations

import csv
import glob
import gzip
import os
import shutil
import struct
import zipfile
import tarfile
from collections import defaultdict

import numpy as np

from graphvite_tpu_torch import base as _base
from graphvite_tpu_torch.utils.common import logger

DATASET_PATH = _base.dataset_path


# ---------------------------------------------------------------------------
# shared preprocessing utilities (ref dataset.py:225-398)
# ---------------------------------------------------------------------------

def csv2txt(csv_file, txt_file):
    """CSV -> whitespace-delimited text (ref dataset.py:225-236)."""
    with open(csv_file) as fin, open(txt_file, "w") as fout:
        for row in csv.reader(fin):
            fout.write("\t".join(row) + "\n")


def top_k_label(label_file, save_file, k, format="node-label"):
    """Keep only the k most frequent labels (ref dataset.py:238-270)."""
    label2nodes = defaultdict(list)
    with open(label_file) as f:
        for line_id, line in enumerate(f):
            tokens = line.split()
            if not tokens:
                continue
            if format == "node-label":
                node, label = tokens
                label2nodes[label].append(node)
            else:
                # "(label)-nodes": each line is the full node list of one
                # community; the label is the line index (ref dataset.py:258-262)
                label2nodes[str(line_id)].extend(tokens)
    top = sorted(label2nodes, key=lambda l: len(label2nodes[l]),
                 reverse=True)[:k]
    with open(save_file, "w") as f:
        for label in top:
            for node in label2nodes[label]:
                f.write("%s\t%s\n" % (node, label))


def link_prediction_split(graph_file, files, portions):
    """Split an edge list into train/valid/test with negative samples added
    to valid/test (label column 1/0), mirroring ref dataset.py:318-361."""
    np.random.seed(1024)
    edges = []
    nodes = set()
    with open(graph_file) as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            u, v = tokens[0], tokens[1]
            edges.append((u, v))
            nodes.add(u)
            nodes.add(v)
    nodes = sorted(nodes)
    edge_set = set(edges)
    np.random.shuffle(edges)
    total = sum(portions)
    offsets = np.cumsum([int(len(edges) * p / total) for p in portions])
    offsets[-1] = len(edges)
    start = 0
    for i, (file_name, end) in enumerate(zip(files, offsets)):
        split = edges[start:end]
        start = end
        with open(file_name, "w") as f:
            if i == 0:  # train: positive edges only, no label column
                for u, v in split:
                    f.write("%s\t%s\n" % (u, v))
                continue
            for u, v in split:
                f.write("%s\t%s\t1\n" % (u, v))
            num_neg = 0
            while num_neg < len(split):
                u = nodes[np.random.randint(len(nodes))]
                v = nodes[np.random.randint(len(nodes))]
                if u == v or (u, v) in edge_set:
                    continue
                f.write("%s\t%s\t0\n" % (u, v))
                num_neg += 1


def edge_split(graph_file, files, portions):
    """Plain edge split without negatives (ref dataset.py:295-316)."""
    np.random.seed(1024)
    with open(graph_file) as f:
        lines = [l for l in f if l.split()]
    np.random.shuffle(lines)
    total = sum(portions)
    offsets = np.cumsum([int(len(lines) * p / total) for p in portions])
    offsets[-1] = len(lines)
    start = 0
    for file_name, end in zip(files, offsets):
        with open(file_name, "w") as f:
            f.writelines(lines[start:end])
        start = end


# ---------------------------------------------------------------------------
# base class
# ---------------------------------------------------------------------------

class Dataset:
    """A named dataset with lazily-materialized splits.

    Subclasses declare `urls` (split -> url or [urls]) and `members`
    (split -> archive member) and may define `<split>_preprocess(...)`
    hooks taking the downloaded/extracted inputs plus the output path.
    """

    urls: dict = {}
    members: dict = {}
    # splits that get_file makes from other splits, with no url of their own
    combined: tuple = ()

    def __init__(self, name):
        self.name = name
        self.path = os.path.join(DATASET_PATH, name)

    # -- plumbing ----------------------------------------------------------
    def relpath(self, file_name):
        return os.path.join(self.path, file_name)

    def local_files(self):
        if not os.path.isdir(self.path):
            return set()
        return {os.path.basename(p)
                for p in glob.glob(os.path.join(self.path, "*"))}

    def download(self, url):
        save_file = os.path.basename(url)
        if "?" in save_file:
            save_file = save_file[: save_file.find("?")]
        if save_file in self.local_files():
            return self.relpath(save_file)
        os.makedirs(self.path, exist_ok=True)
        logger.info("downloading %s to %s", url, self.relpath(save_file))
        try:
            from urllib.request import urlretrieve
            urlretrieve(url, self.relpath(save_file))
        except Exception as e:
            raise RuntimeError(
                "cannot download %s (%s). This environment may have no "
                "network access; place the file at %s manually."
                % (url, e, self.relpath(save_file))) from None
        return self.relpath(save_file)

    def extract(self, archive, member=None):
        """Extract an archive (or a single member); returns the local path
        of the extracted file (ref dataset.py:140-180)."""
        base = os.path.basename(archive)
        if base.endswith(".gz") and not base.endswith(".tar.gz"):
            save_file = base[: -len(".gz")]
            if save_file not in self.local_files():
                with gzip.open(archive, "rb") as fin, \
                        open(self.relpath(save_file), "wb") as fout:
                    shutil.copyfileobj(fin, fout)
            return self.relpath(save_file)
        if base.endswith(".zip"):
            if member is None:
                name = base[: -len(".zip")]
                if name not in self.local_files():
                    with zipfile.ZipFile(archive) as z:
                        z.extractall(self.path)
                return self.relpath(name)
            save_file = os.path.basename(member)
            if save_file not in self.local_files():
                with zipfile.ZipFile(archive) as z, \
                        z.open(member) as fin, \
                        open(self.relpath(save_file), "wb") as fout:
                    shutil.copyfileobj(fin, fout)
            return self.relpath(save_file)
        if base.endswith((".tar.gz", ".tgz", ".tar")):
            if member is None:
                name = base[: base.find(".tar")]
                if name not in self.local_files():
                    with tarfile.open(archive) as t:
                        t.extractall(self.path)
                return self.relpath(name)
            save_file = os.path.basename(member)
            if save_file not in self.local_files():
                with tarfile.open(archive) as t, \
                        t.extractfile(member) as fin, \
                        open(self.relpath(save_file), "wb") as fout:
                    shutil.copyfileobj(fin, fout)
            return self.relpath(save_file)
        return archive

    def get_file(self, key):
        file_name = "%s_%s.txt" % (self.name, key)
        if file_name in self.local_files():
            return self.relpath(file_name)
        os.makedirs(self.path, exist_ok=True)
        urls = self.urls.get(key, [])
        if isinstance(urls, str):
            urls = [urls]
        members = self.members.get(key)
        if members is None:
            members = [None] * len(urls)
        elif isinstance(members, str):
            members = [members]
        extracted = []
        for url, member in zip(urls, members):
            f = self.download(url)
            extracted.append(self.extract(f, member))
        preprocess = getattr(self, key + "_preprocess", None)
        out = self.relpath(file_name)
        if preprocess is not None:
            preprocess(*(extracted + [out]))
        elif len(extracted) == 1:
            if extracted[0] != out:
                shutil.copyfile(extracted[0], out)
        else:
            raise AttributeError(
                "split `%s` of dataset `%s` needs a %s_preprocess hook"
                % (key, self.name, key))
        return out

    def __getattr__(self, key):
        # hooks and splits are looked up on the class: on the instance, a
        # split without a hook would recurse through `key_preprocess`,
        # `key_preprocess_preprocess`, ... (the reference's RecursionError)
        if key.startswith("_") or key.endswith("_preprocess"):
            raise AttributeError(key)
        cls = type(self)
        if (key in cls.urls or key in cls.combined
                or hasattr(cls, key + "_preprocess")):
            return self.get_file(key)
        raise AttributeError("dataset `%s` has no split `%s`"
                             % (self.name, key))


# ---------------------------------------------------------------------------
# node-embedding datasets
# ---------------------------------------------------------------------------

class BlogCatalog(Dataset):
    """BlogCatalog social network (ref dataset.py:400-445).
    Splits: graph, label, train, valid, test."""

    urls = {
        "graph": "https://www.dropbox.com/s/cf21ouuzd563cqx/BlogCatalog-dataset.zip?dl=1",
        "label": "https://www.dropbox.com/s/cf21ouuzd563cqx/BlogCatalog-dataset.zip?dl=1",
        "train": [], "valid": [], "test": [],
    }
    members = {
        "graph": "BlogCatalog-dataset/data/edges.csv",
        "label": "BlogCatalog-dataset/data/group-edges.csv",
    }

    def __init__(self):
        super().__init__("blogcatalog")

    def graph_preprocess(self, raw_file, save_file):
        csv2txt(raw_file, save_file)

    def label_preprocess(self, raw_file, save_file):
        csv2txt(raw_file, save_file)

    def _lp_split(self):
        files = [self.relpath("%s_%s.txt" % (self.name, k))
                 for k in ("train", "valid", "test")]
        link_prediction_split(self.graph, files, portions=[100, 1, 1])

    def train_preprocess(self, save_file):
        self._lp_split()

    def valid_preprocess(self, save_file):
        self._lp_split()

    def test_preprocess(self, save_file):
        self._lp_split()


class Youtube(Dataset):
    """Youtube social network (ref dataset.py:448-466). Splits: graph, label."""

    urls = {
        "graph": "http://socialnetworks.mpi-sws.mpg.de/data/youtube-links.txt.gz",
        "label": "http://socialnetworks.mpi-sws.mpg.de/data/youtube-groupmemberships.txt.gz",
    }

    def __init__(self):
        super().__init__("youtube")

    def label_preprocess(self, raw_file, save_file):
        top_k_label(raw_file, save_file, k=47)


class Flickr(Dataset):
    """Flickr social network (ref dataset.py:468-486). Splits: graph, label."""

    urls = {
        "graph": "http://socialnetworks.mpi-sws.mpg.de/data/flickr-links.txt.gz",
        "label": "http://socialnetworks.mpi-sws.mpg.de/data/flickr-groupmemberships.txt.gz",
    }

    def __init__(self):
        super().__init__("flickr")

    def label_preprocess(self, raw_file, save_file):
        top_k_label(raw_file, save_file, k=195)


class Hyperlink2012(Dataset):
    """Hyperlink 2012 web graph (ref dataset.py:488-519).
    Splits: pld_train, pld_test."""

    urls = {
        "pld_train": "http://data.dws.informatik.uni-mannheim.de/hyperlinkgraph/2012-08/split/pld-arc.gz",
        "pld_valid": "http://data.dws.informatik.uni-mannheim.de/hyperlinkgraph/2012-08/split/pld-arc.gz",
        "pld_test": "http://data.dws.informatik.uni-mannheim.de/hyperlinkgraph/2012-08/split/pld-arc.gz",
    }

    def __init__(self):
        super().__init__("hyperlink2012")

    def _split(self, graph_file):
        files = [self.relpath("%s_%s.txt" % (self.name, k))
                 for k in ("pld_train", "pld_valid", "pld_test")]
        link_prediction_split(graph_file, files, portions=[4000, 1, 1])

    def pld_train_preprocess(self, graph_file, save_file):
        self._split(graph_file)

    def pld_valid_preprocess(self, graph_file, save_file):
        self._split(graph_file)

    def pld_test_preprocess(self, graph_file, save_file):
        self._split(graph_file)


class Friendster(Dataset):
    """Friendster social network (ref dataset.py:521-544).
    Splits: graph, small_graph, label."""

    urls = {
        "graph": "https://snap.stanford.edu/data/bigdata/communities/com-friendster.ungraph.txt.gz",
        "small_graph": ["https://snap.stanford.edu/data/bigdata/communities/com-friendster.ungraph.txt.gz",
                        "https://snap.stanford.edu/data/bigdata/communities/com-friendster.top5000.cmty.txt.gz"],
        "label": "https://snap.stanford.edu/data/bigdata/communities/com-friendster.top5000.cmty.txt.gz",
    }

    def __init__(self):
        super().__init__("friendster")

    def small_graph_preprocess(self, graph_file, label_file, save_file):
        # induced subgraph over labeled nodes (ref dataset.py:272-293)
        labeled = set()
        with open(label_file) as f:
            for line in f:
                labeled.update(line.split())
        with open(graph_file) as fin, open(save_file, "w") as fout:
            for line in fin:
                if line.startswith("#"):
                    continue
                tokens = line.split()
                if len(tokens) >= 2 and tokens[0] in labeled \
                        and tokens[1] in labeled:
                    fout.write(line)

    def label_preprocess(self, label_file, save_file):
        top_k_label(label_file, save_file, k=100, format="(label)-nodes")


class Wikipedia(Dataset):
    """Wikipedia dump corpus for word graphs (ref dataset.py:546-559).
    Splits: graph (the corpus file)."""

    urls = {
        "graph": "https://dumps.wikimedia.org/enwiki/latest/enwiki-latest-pages-articles.xml.bz2",
    }

    def __init__(self):
        super().__init__("wikipedia")


# ---------------------------------------------------------------------------
# knowledge-graph datasets
# ---------------------------------------------------------------------------

class Math(Dataset):
    """Synthetic arithmetic knowledge graph (ref dataset.py:562-610):
    triplets (x, op c, y) with y = x op c — fully offline, the unit-test
    fixture. Splits: train, valid, test."""

    NUM_ENTITY = 1000
    NUM_RELATION = 30
    urls = {"train": [], "valid": [], "test": []}

    def __init__(self):
        super().__init__("math")

    OPERATORS = [
        ("+", lambda x, y: (x + y) % 1000),
        ("-", lambda x, y: (x - y) % 1000),
        ("*", lambda x, y: (x * y) % 1000),
        ("/", lambda x, y: x // y),
        ("%", lambda x, y: x % y),
    ]

    def _generate(self, save_file, num_triplet, seed):
        rng = np.random.RandomState(seed)
        with open(save_file, "w") as f:
            for _ in range(num_triplet):
                i = int(rng.rand() * len(self.OPERATORS))
                op, fn = self.OPERATORS[i]
                x = int(rng.rand() * self.NUM_ENTITY)
                y = int(rng.rand() * self.NUM_RELATION) + 1
                f.write("%d\t%s%d\t%d\n" % (x, op, y, fn(x, y)))

    def train_preprocess(self, save_file):
        self._generate(save_file, 20000, seed=1023)

    def valid_preprocess(self, save_file):
        self._generate(save_file, 1000, seed=1024)

    def test_preprocess(self, save_file):
        self._generate(save_file, 1000, seed=1025)


class FB15k(Dataset):
    """(ref dataset.py:612-628)"""

    urls = {k: "https://dl.fbaipublicfiles.com/starspace/fb15k.tgz"
            for k in ("train", "valid", "test")}
    members = {
        "train": "FB15k/freebase_mtr100_mte100-train.txt",
        "valid": "FB15k/freebase_mtr100_mte100-valid.txt",
        "test": "FB15k/freebase_mtr100_mte100-test.txt",
    }

    def __init__(self):
        super().__init__("fb15k")


class FB15k237(Dataset):
    """(ref dataset.py:630-646)"""

    urls = {k: "https://data.deepai.org/FB15K-237.2.zip"
            for k in ("train", "valid", "test")}
    members = {
        "train": "Release/train.txt",
        "valid": "Release/valid.txt",
        "test": "Release/test.txt",
    }

    def __init__(self):
        super().__init__("fb15k-237")


class WN18(Dataset):
    """(ref dataset.py:648-664)"""

    urls = {k: "https://dl.fbaipublicfiles.com/starspace/wn18.tgz"
            for k in ("train", "valid", "test")}
    members = {
        "train": "wn18/wordnet-mlj12-train.txt",
        "valid": "wn18/wordnet-mlj12-valid.txt",
        "test": "wn18/wordnet-mlj12-test.txt",
    }

    def __init__(self):
        super().__init__("wn18")


class WN18RR(Dataset):
    """(ref dataset.py:666-682)"""

    urls = {k: "https://data.dgl.ai/dataset/wn18rr.zip"
            for k in ("train", "valid", "test")}
    members = {
        "train": "wn18rr/train.txt",
        "valid": "wn18rr/valid.txt",
        "test": "wn18rr/test.txt",
    }

    def __init__(self):
        super().__init__("wn18rr")


class Wikidata5m(Dataset):
    """Wikidata5m (ref dataset.py:684-740).
    Splits: train, valid, test, entity aliases, relation aliases."""

    urls = {
        "train": "https://www.dropbox.com/s/563omb11cxaqr83/wikidata5m_transductive.tar.gz?dl=1",
        "valid": "https://www.dropbox.com/s/563omb11cxaqr83/wikidata5m_transductive.tar.gz?dl=1",
        "test": "https://www.dropbox.com/s/563omb11cxaqr83/wikidata5m_transductive.tar.gz?dl=1",
    }
    members = {
        "train": "wikidata5m_transductive_train.txt",
        "valid": "wikidata5m_transductive_valid.txt",
        "test": "wikidata5m_transductive_test.txt",
    }

    def __init__(self):
        super().__init__("wikidata5m")


class Freebase(Dataset):
    """Full Freebase triplet dump (ref dataset.py:742-756). Splits: train."""

    urls = {
        "train": "http://commondatastorage.googleapis.com/freebase-public/rdf/freebase-rdf-latest.gz",
    }

    def __init__(self):
        super().__init__("freebase")


# ---------------------------------------------------------------------------
# visualization datasets
# ---------------------------------------------------------------------------

class MNIST(Dataset):
    """MNIST raw pixels for LargeVis (ref dataset.py:758-794).
    Splits: image_data, label_data (numpy arrays via np.load on .npy)."""

    combined = ("image_data", "label_data")
    urls = {
        "train_image_data": "http://yann.lecun.com/exdb/mnist/train-images-idx3-ubyte.gz",
        "train_label_data": "http://yann.lecun.com/exdb/mnist/train-labels-idx1-ubyte.gz",
        "test_image_data": "http://yann.lecun.com/exdb/mnist/t10k-images-idx3-ubyte.gz",
        "test_label_data": "http://yann.lecun.com/exdb/mnist/t10k-labels-idx1-ubyte.gz",
    }

    def __init__(self):
        super().__init__("mnist")

    @staticmethod
    def _read_idx(path):
        with open(path, "rb") as f:
            zero, dtype, ndim = struct.unpack(">HBB", f.read(4))
            shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)

    def _npy(self, key, raw):
        out = self.relpath("%s_%s.npy" % (self.name, key))
        np.save(out, self._read_idx(raw))
        return out

    def get_file(self, key):
        if not key.endswith("_data"):
            return super().get_file(key)
        npy = self.relpath("%s_%s.npy" % (self.name, key))
        if os.path.basename(npy) in self.local_files():
            return npy
        if key in ("image_data", "label_data"):
            # train + test concatenated (ref dataset.py:789-794)
            parts = [np.load(self.get_file("train_" + key)),
                     np.load(self.get_file("test_" + key))]
            np.save(npy, np.concatenate(parts))
            return npy
        raw = self.extract(self.download(self.urls[key]))
        return self._npy(key, raw)


class CIFAR10(Dataset):
    """CIFAR10 raw pixels (ref dataset.py:796-862). Splits: image_data,
    label_data (train + test concatenated, .npy)."""

    URL = "https://www.cs.toronto.edu/~kriz/cifar-10-binary.tar.gz"
    urls = {"image_data": URL, "label_data": URL}

    def __init__(self):
        super().__init__("cifar10")

    def _load_batches(self):
        root = self.extract(self.download(self.URL))
        batch_dir = os.path.join(self.path, "cifar-10-batches-bin")
        names = ["data_batch_%d.bin" % i for i in range(1, 6)] + \
                ["test_batch.bin"]
        images, labels = [], []
        for name in names:
            raw = np.fromfile(os.path.join(batch_dir, name), dtype=np.uint8)
            raw = raw.reshape(-1, 3073)
            labels.append(raw[:, 0])
            images.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                          .transpose(0, 2, 3, 1))
        return np.concatenate(images), np.concatenate(labels)

    def get_file(self, key):
        if key not in ("image_data", "label_data"):
            return super().get_file(key)
        npy = self.relpath("%s_%s.npy" % (self.name, key))
        if os.path.basename(npy) in self.local_files():
            return npy
        os.makedirs(self.path, exist_ok=True)
        images, labels = self._load_batches()
        np.save(self.relpath("%s_image_data.npy" % self.name), images)
        np.save(self.relpath("%s_label_data.npy" % self.name), labels)
        return npy


def image_feature_data(images, model="resnet50", batch_size=128,
                       weights_file=None, device=None):
    """Extract penultimate-layer CNN features for LargeVis input
    (ref dataset.py:634-658): torchvision's `model` over [N, H, W, 3] (or
    [N, H, W] grayscale) uint8 images, ImageNet-normalized, on CUDA unless
    `device="cpu"` is asked for. The weights are read from `weights_file`
    (the model's torchvision state dict, by default
    `<dataset path>/imagenet/<model>.pth`) and never fetched: without the
    file this raises naming it. Needs torchvision (imported here)."""
    import torch
    import torchvision.models as tvm

    from graphvite_tpu_torch.solver import resolve_device

    dev = resolve_device(device)
    if weights_file is None:
        weights_file = os.path.join(DATASET_PATH, "imagenet", "%s.pth" % model)
    if not os.path.isfile(weights_file):
        raise RuntimeError(
            "no weights for %s. This environment may have no network "
            "access; place torchvision's pretrained %s state dict at %s "
            "manually." % (model, model, weights_file))
    net = getattr(tvm, model)(weights=None)
    net.load_state_dict(torch.load(weights_file, map_location="cpu",
                                   weights_only=True))
    net.fc = torch.nn.Identity()
    net = net.eval().to(dev)
    mean = torch.tensor([0.485, 0.456, 0.406], device=dev).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=dev).view(1, 3, 1, 1)
    feats = []
    with torch.no_grad():
        for i in range(0, len(images), batch_size):
            x = torch.as_tensor(np.asarray(images[i:i + batch_size],
                                           dtype=np.float32) / 255.0).to(dev)
            if x.ndim == 3:  # grayscale -> RGB
                x = x[:, None].repeat(1, 3, 1, 1)
            else:
                x = x.permute(0, 3, 1, 2)
            x = (x - mean) / std
            feats.append(net(x).cpu().numpy())
    return np.concatenate(feats)


class ImageNet(Dataset):
    """ImageNet ILSVRC2012 (ref dataset.py:864-1063). The raw archives need
    image-net.org credentials; `feature_data` expects the extracted images
    and resnet50's weights (`resnet50.pth`) under the dataset path and runs
    the feature extraction on CUDA."""

    urls = {}

    def __init__(self):
        super().__init__("imagenet")

    def feature_data_preprocess(self, save_file):
        image_file = self.relpath("imagenet_image_data.npy")
        if not os.path.isfile(image_file):
            raise RuntimeError(
                "place preprocessed images at %s (ImageNet needs manual "
                "download credentials)" % image_file)
        np.save(save_file, image_feature_data(
            np.load(image_file), weights_file=self.relpath("resnet50.pth")))

    def get_file(self, key):
        if key == "feature_data":
            npy = self.relpath("imagenet_feature_data.npy")
            if os.path.basename(npy) not in self.local_files():
                os.makedirs(self.path, exist_ok=True)
                self.feature_data_preprocess(npy)
            return npy
        return super().get_file(key)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

blogcatalog = BlogCatalog()
youtube = Youtube()
flickr = Flickr()
hyperlink2012 = Hyperlink2012()
friendster = Friendster()
wikipedia = Wikipedia()
math = Math()
fb15k = FB15k()
fb15k237 = FB15k237()
wn18 = WN18()
wn18rr = WN18RR()
wikidata5m = Wikidata5m()
freebase = Freebase()
mnist = MNIST()
cifar10 = CIFAR10()
imagenet = ImageNet()

DATASETS = {
    "blogcatalog": blogcatalog, "youtube": youtube, "flickr": flickr,
    "hyperlink2012": hyperlink2012, "friendster": friendster,
    "wikipedia": wikipedia, "math": math, "fb15k": fb15k,
    "fb15k-237": fb15k237, "fb15k237": fb15k237, "wn18": wn18,
    "wn18rr": wn18rr, "wikidata5m": wikidata5m, "freebase": freebase,
    "mnist": mnist, "cifar10": cifar10, "imagenet": imagenet,
}
