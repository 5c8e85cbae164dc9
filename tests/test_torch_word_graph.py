"""The port's WordGraph (graphvite_tpu_torch/word_graph.py) against the
reference's (graphvite_tpu/word_graph.py) on the same corpus files: the
vocabulary in first-seen order, the name map, and the edge, CSR and
vertex-weight arrays must be exactly equal (values and dtypes), on both
tokenizer paths (whitespace, and a delimiter set), with comments, blank
lines, two windows, two min_counts, normalization, and the chunked
aggregation that merges partial counts."""
import numpy as np
import pytest

from graphvite_tpu import word_graph as ref_wg
from graphvite_tpu_torch import word_graph as port_wg
from graphvite_tpu_torch.application import (Application,
                                             WordGraphApplication)

ARRAYS = ("edge_heads", "edge_tails", "edge_weights", "indptr", "indices",
          "csr_weights", "csr_edge_ids", "vertex_weights")


def _corpus(path, delimiters=None, seed=0, lines=300):
    """Zipf words in sentences of 1-15 tokens, with comment lines, trailing
    comments and blank lines; separators from `delimiters` (else blanks
    and tabs)."""
    rng = np.random.default_rng(seed)
    seps = list(delimiters) if delimiters else [" ", "  ", "\t"]
    out = []
    for i in range(lines):
        if i % 37 == 0:
            out.append("# a comment line w1 w2 w3")
            continue
        if i % 23 == 0:
            out.append("")
            continue
        words = ["w%d" % w for w in rng.zipf(1.5, rng.integers(1, 16)) % 60]
        line = "".join(w + seps[rng.integers(len(seps))] for w in words)
        if i % 11 == 0:
            line += " # trailing w59 w58"
        out.append(line)
    path.write_text("\n".join(out) + "\n")
    return str(path)


def _assert_same(ref, port):
    assert port.id2name == ref.id2name
    assert port.name2id == ref.name2id
    assert (port.num_vertex, port.num_edge) == (ref.num_vertex, ref.num_edge)
    assert (port.as_undirected, port.normalization) == (ref.as_undirected,
                                                        ref.normalization)
    for name in ARRAYS:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert port.info() == ref.info()


@pytest.mark.parametrize("delimiters", [None, " ,;\t"])
@pytest.mark.parametrize("window", [2, 5])
@pytest.mark.parametrize("min_count", [1, 3])
def test_word_graph_matches_reference(tmp_path, delimiters, window,
                                      min_count):
    corpus = _corpus(tmp_path / "corpus.txt", delimiters)
    kw = dict(window=window, min_count=min_count, delimiters=delimiters)
    ref = ref_wg.WordGraph().load_file(corpus, **kw)
    port = port_wg.WordGraph().load_file(corpus, **kw)
    assert port.num_vertex > 10 and port.num_edge > 100
    _assert_same(ref, port)


@pytest.mark.parametrize("delimiters", [None, " ,;\t"])
def test_normalization_and_compact_alias(tmp_path, delimiters):
    corpus = _corpus(tmp_path / "corpus.txt", delimiters, seed=1)
    kw = dict(window=3, min_count=2, normalization=True,
              delimiters=delimiters)
    ref = ref_wg.WordGraph().load_file_compact(corpus, **kw)
    port = port_wg.WordGraph().load_file_compact(corpus, **kw)
    _assert_same(ref, port)
    assert port.normalization and port.edge_weights.max() < 1


@pytest.mark.parametrize("delimiters", [None, " ,;\t"])
def test_chunked_aggregation_matches(tmp_path, monkeypatch, delimiters):
    """With _CHUNK_KEYS small in both modules, every window offset flushes
    a chunk and the partial counts merge: the same graph as one chunk."""
    corpus = _corpus(tmp_path / "corpus.txt", delimiters, seed=2, lines=500)
    kw = dict(window=4, min_count=2, delimiters=delimiters)
    whole = port_wg.WordGraph().load_file(corpus, **kw)
    monkeypatch.setattr(ref_wg, "_CHUNK_KEYS", 50)
    monkeypatch.setattr(port_wg, "_CHUNK_KEYS", 50)
    ref = ref_wg.WordGraph().load_file(corpus, **kw)
    port = port_wg.WordGraph().load_file(corpus, **kw)
    _assert_same(ref, port)
    _assert_same(whole, port)


@pytest.mark.parametrize("text,has_words", [("", False),
                                            ("# only comments\n\n", False),
                                            ("a b c\nd e f\n", True)])
@pytest.mark.parametrize("delimiters", [None, " "])
def test_empty_vocabulary(tmp_path, text, has_words, delimiters):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(text)
    kw = dict(window=2, min_count=5, delimiters=delimiters)
    port = port_wg.WordGraph().load_file(str(corpus), **kw)
    assert port.num_vertex == 0 and port.num_edge == 0
    if has_words and delimiters is None:
        # words, none kept: the reference's whitespace path indexes an
        # empty vocabulary and raises (a divergence the port records)
        with pytest.raises(IndexError):
            ref_wg.WordGraph().load_file(str(corpus), **kw)
        return
    _assert_same(ref_wg.WordGraph().load_file(str(corpus), **kw), port)


def test_word_graph_application():
    app = Application("word graph", dim=8, device="cpu")
    assert type(app) is WordGraphApplication
    assert isinstance(app.graph, port_wg.WordGraph)
    assert type(Application("word_graph", dim=8, device="cpu")
                ) is WordGraphApplication
