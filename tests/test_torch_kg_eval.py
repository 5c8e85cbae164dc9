"""The port's knowledge-graph evaluation (application/evaluate.py) against
the JAX package's on the same trained-looking random tables, all six
models.

Tolerances: one-vs-all scores and top-k values rtol 1e-5, atol 1e-5 (the
same formulas; each framework's own sum order over D, and a matrix product
for the bilinear models). Top-k ids and filtered ranks are discrete and
must be equal: the random tables leave no two scores within rounding of
each other. The reference counts the positive by comparing its score with
itself (and clips at 1); the port counts it by rule, which is the same
number whenever that comparison holds. For the bilinear models the
reference compares an einsum with a row of a matrix product, which differ
in the last bit about one time in ten, and its rank is then 1 too small: a
recorded divergence. There the port is held to the reference within that
one count, and to the dense definition exactly."""
from collections import defaultdict

import numpy as np
import pytest
import torch

from graphvite_tpu.application import evaluate as ref
from graphvite_tpu_torch.application import evaluate as port

NAMES = ["TransE", "DistMult", "ComplEx", "SimplE", "RotatE", "QuatE"]
V, R, D, N = 300, 7, 16, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hyper(name):
    return 6.0 if name in ("TransE", "RotatE") else 2e-3


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(V, D)) * 0.5).astype(np.float32),
            (rng.normal(size=(R, D)) * 0.5).astype(np.float32))


def _queries(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, N), rng.integers(0, R, N),
            rng.integers(0, V, N))


def _excludes(H, Rr, T, seed=2):
    """Known triplets: the queries themselves plus random others sharing
    their (entity, relation) keys."""
    rng = np.random.default_rng(seed)
    ex_h, ex_t = defaultdict(set), defaultdict(set)
    for h, r, t in zip(H.tolist(), Rr.tolist(), T.tolist()):
        ex_h[(t, r)].add(h)
        ex_t[(h, r)].add(t)
        for e in rng.integers(0, V, 5).tolist():
            ex_h[(t, r)].add(e)
            ex_t[(h, r)].add(e)
    return ex_h, ex_t


def test_bilinear_models_match_reference():
    assert port.BILINEAR_MODELS == ref.BILINEAR_MODELS


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("target", ["head", "tail"])
def test_kg_score_all_matches_reference(name, target):
    ent, rel = _tables()
    H, Rr, T = _queries()
    want = ref.kg_score_all(name, ent, rel, H, Rr, T, target, _hyper(name))
    got = port.kg_score_all(name, ent, rel, H, Rr, T, target, _hyper(name))
    assert got.shape == want.shape == (N, V) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # chunked like the reference, and from tensors
    again = port.kg_score_all(name, torch.as_tensor(ent),
                              torch.as_tensor(rel), H, Rr, T, target,
                              _hyper(name), chunk=7)
    np.testing.assert_allclose(again, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("target", ["head", "tail"])
def test_kg_topk_matches_reference(name, target, monkeypatch):
    ent, rel = _tables()
    H, Rr, T = _queries()
    want_v, want_i = ref.kg_topk(name, ent, rel, H, Rr, T, target,
                                 _hyper(name), k=5)
    # several candidate blocks and query batches at this small size
    monkeypatch.setattr(port, "_batch_shape", lambda name, dim: (64, 16))
    got_v, got_i = port.kg_topk(name, ent, rel, H, Rr, T, target,
                                _hyper(name), k=5)
    assert got_i.dtype == np.int32 and got_v.dtype == np.float32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=1e-5)
    # best first, and the values are the one-vs-all scores at those ids
    assert (np.diff(got_v, axis=1) <= 0).all()
    full = port.kg_score_all(name, ent, rel, H, Rr, T, target, _hyper(name))
    np.testing.assert_allclose(np.take_along_axis(full, got_i, axis=1),
                               got_v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("target", ["head", "tail", "both"])
def test_filtered_rankings_match_reference(name, target, monkeypatch):
    ent, rel = _tables()
    H, Rr, T = _queries()
    ex_h, ex_t = _excludes(H, Rr, T)
    want = ref.filtered_rankings(name, ent, rel, H, Rr, T, ex_h, ex_t,
                                 _hyper(name), target)
    monkeypatch.setattr(port, "_batch_shape", lambda name, dim: (64, 16))
    got = port.filtered_rankings(name, ent, rel, H, Rr, T, ex_h, ex_t,
                                 _hyper(name), target)
    assert got.dtype == np.float64
    assert got.shape == want.shape == (N * (2 if target == "both" else 1),)
    if name in port.BILINEAR_MODELS:
        # the reference may have dropped the positive's own count
        assert ((got == want) | ((got == want + 1) & (want >= 1))).all()
        assert (got == want).mean() >= 0.7
    else:
        np.testing.assert_array_equal(got, want)
        assert port.ranking_metrics(got) == ref.ranking_metrics(want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("target", ["head", "tail"])
def test_filtered_rankings_against_dense_definition(name, target):
    """rank = 1 + #(other candidates, not known true, scoring >= truth), from
    the whole score matrix (the scores' gaps dwarf float32 rounding)."""
    ent, rel = _tables(3)
    H, Rr, T = _queries(4)
    ex_h, ex_t = _excludes(H, Rr, T, 5)
    got = port.filtered_rankings(name, ent, rel, H, Rr, T, ex_h, ex_t,
                                 _hyper(name), target)
    scores = port.kg_score_all(name, ent, rel, H, Rr, T, target,
                               _hyper(name))
    for j, (h, r, t) in enumerate(zip(H.tolist(), Rr.tolist(), T.tolist())):
        pos, known = ((h, ex_h[(t, r)]) if target == "head"
                      else (t, ex_t[(h, r)]))
        keep = np.ones(V, bool)
        keep[list(known)] = False
        keep[pos] = False
        assert got[j] == 1 + int((scores[j][keep] >= scores[j][pos]).sum())


def test_ranking_metrics():
    m = port.ranking_metrics([1, 2, 4, 20])
    assert m == ref.ranking_metrics([1, 2, 4, 20])
    assert m["MR"] == 6.75 and m["HITS@1"] == 0.25 and m["HITS@10"] == 0.75
    np.testing.assert_allclose(m["MRR"], (1 + 0.5 + 0.25 + 0.05) / 4)


def test_empty_inputs():
    ent, rel = _tables()
    e = np.zeros(0, np.int64)
    assert port.filtered_rankings("TransE", ent, rel, e, e, e, {}, {},
                                  6.0).shape == (0,)
    v, i = port.kg_topk("TransE", ent, rel, e, e, e, "tail", 6.0, k=3)
    assert v.shape == (0, 3) and i.shape == (0, 3)
