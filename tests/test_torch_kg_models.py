"""The port's knowledge-graph models (models/knowledge_graph.py) and its
KnowledgeGraph container against the JAX package's, on the same
numpy-seeded inputs.

Tolerances: score and backward against the reference in float32, rtol
1e-5, atol 1e-6 (the same formulas, each framework's own elementwise
rounding and sum order over D). backward against torch.autograd of score
in float64, rtol 1e-9 (only the hand derivation can differ): QuatE with
the relation's norm detached (its backward treats it as a constant),
RotatE away from zero distance, TransE away from |x| = 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphvite_tpu.graph import KnowledgeGraph as RefKnowledgeGraph
from graphvite_tpu.models import KG_MODELS as REF_MODELS
from graphvite_tpu_torch.graph import KnowledgeGraph
from graphvite_tpu_torch.models import KG_MODELS
from graphvite_tpu_torch.models import knowledge_graph as port_kg

NAMES = ["TransE", "DistMult", "ComplEx", "SimplE", "RotatE", "QuatE"]
TOL = dict(rtol=1e-5, atol=1e-6)


def _hyper(name):
    return 6.0 if REF_MODELS[name].uses_margin else 2e-3


def _rows(seed, shape, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s + (d,)).astype(np.float32) for s in shape]


def test_registry_matches_reference():
    assert sorted(KG_MODELS) == sorted(REF_MODELS) == sorted(NAMES)
    for name in NAMES:
        assert KG_MODELS[name].name == name
        assert KG_MODELS[name].uses_margin == REF_MODELS[name].uses_margin


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shapes", [
    ((5,), (5,), (5,)),                      # one row each
    ((4, 1), (1, 3), (4, 1)),                # the pooled step's broadcast
], ids=["flat", "broadcast"])
def test_score_and_backward_match_reference(name, shapes):
    d = 16
    h, t, r = _rows(3, shapes, d)
    hyper = _hyper(name)
    ref, port = REF_MODELS[name], KG_MODELS[name]
    want = np.asarray(ref.score(jnp.asarray(h), jnp.asarray(t),
                                jnp.asarray(r), hyper))
    got = port.score(torch.as_tensor(h), torch.as_tensor(t),
                     torch.as_tensor(r), hyper)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    g = np.random.default_rng(4).normal(size=want.shape).astype(np.float32)
    want_g = ref.backward(jnp.asarray(h), jnp.asarray(t), jnp.asarray(r),
                          jnp.asarray(g), hyper)
    got_g = port.backward(torch.as_tensor(h), torch.as_tensor(t),
                          torch.as_tensor(r), torch.as_tensor(g), hyper)
    for a, b in zip(got_g, want_g):
        b = np.asarray(b)
        np.testing.assert_allclose(np.broadcast_to(a.numpy(), b.shape), b,
                                   **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_backward_matches_autograd(name, monkeypatch):
    d, n = 8, 6
    rng = np.random.default_rng(7)
    h, t, r = (torch.tensor(rng.normal(size=(n, d)), requires_grad=True)
               for _ in range(3))
    g = torch.tensor(rng.normal(size=n))
    model = KG_MODELS[name]
    hyper = _hyper(name)
    if name == "QuatE":
        # the hand-written backward holds the normalizer constant: give
        # autograd the same function
        sqrt = torch.sqrt
        monkeypatch.setattr(port_kg.torch, "sqrt",
                            lambda x: sqrt(x).detach())
    score = model.score(h, t, r, hyper)
    if not model.uses_margin:
        # the l3 term of backward is the gradient of l3 * sum |p|^3, scaled
        # by nothing: add it to the scalar autograd differentiates
        reg = sum((p.abs() ** 3).sum() for p in (h, t, r))
        total = (score * g).sum() + hyper * reg
    else:
        total = (score * g).sum()
    want = torch.autograd.grad(total, (h, t, r))
    monkeypatch.undo()
    with torch.no_grad():
        got = model.backward(h, t, r, g, hyper)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_transe_zero_maps_to_minus_one():
    """h + r - t == 0 takes the -1 branch of the reference's ternary (not
    torch.sign's 0)."""
    h = torch.tensor([[1.0, 2.0]])
    t = torch.tensor([[1.5, 1.0]])
    r = torch.tensor([[0.5, 0.0]])              # x = [0, 1]
    gh, gt, gr = KG_MODELS["TransE"].backward(h, t, r, torch.ones(1), 6.0)
    want = REF_MODELS["TransE"].backward(jnp.asarray(h.numpy()),
                                         jnp.asarray(t.numpy()),
                                         jnp.asarray(r.numpy()),
                                         jnp.ones(1), 6.0)
    np.testing.assert_array_equal(gh.numpy(), [[1.0, -1.0]])
    for a, b in zip((gh, gt, gr), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rotate_relation_second_half_gets_no_gradient():
    h, t, r = (torch.as_tensor(x) for x in _rows(5, ((4,),) * 3, 12))
    _, _, gr = KG_MODELS["RotatE"].backward(h, t, r, torch.ones(4), 6.0)
    assert gr.shape == (4, 12)
    assert bool((gr[:, 6:] == 0).all()) and bool((gr[:, :6] != 0).all())
    # the score reads only the first half of the relation row
    r2 = r.clone()
    r2[:, 6:] = 7.0
    np.testing.assert_array_equal(
        KG_MODELS["RotatE"].score(h, t, r, 6.0).numpy(),
        KG_MODELS["RotatE"].score(h, t, r2, 6.0).numpy())


def _triplets(seed=0, n=60):
    rng = np.random.default_rng(seed)
    return [("e%d" % rng.integers(25), "r%d" % rng.integers(4),
             "e%d" % rng.integers(25), float(rng.integers(1, 4)))
            for _ in range(n)]


@pytest.mark.parametrize("normalization", [False, True])
def test_knowledge_graph_matches_reference(normalization, tmp_path):
    trips = _triplets()
    ref = RefKnowledgeGraph().load_triplet_list(trips,
                                                normalization=normalization)
    port = KnowledgeGraph().load_triplet_list(trips,
                                              normalization=normalization)
    path = tmp_path / "kg.txt"
    path.write_text("# a comment\n" + "".join(
        "%s\t%s\t%s\t%g\n" % t for t in trips))
    from_file = KnowledgeGraph().load_file(str(path),
                                           normalization=normalization)
    for g in (port, from_file):
        assert (g.num_vertex, g.num_relation, g.num_edge) == (
            ref.num_vertex, ref.num_relation, ref.num_edge)
        assert g.num_entity == ref.num_entity
        assert g.id2entity == ref.id2entity
        assert g.id2relation == ref.id2relation
        assert g.entity2id == ref.entity2id
        assert g.relation2id == ref.relation2id
        for name in ("edge_heads", "edge_tails", "edge_relations"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(ref, name))
            assert getattr(g, name).dtype == getattr(ref, name).dtype
        np.testing.assert_allclose(g.edge_weights, ref.edge_weights,
                                   rtol=1e-6)
        np.testing.assert_array_equal(g.degrees, ref.degrees)
        assert g.info() == ref.info()
        assert repr(g) == repr(ref)
    out_a, out_b = tmp_path / "a.txt", tmp_path / "b.txt"
    port.save(str(out_a))
    ref.save(str(out_b))
    assert out_a.read_text() == out_b.read_text()
    port.save(str(out_a), anonymous=True)
    ref.save(str(out_b), anonymous=True)
    assert out_a.read_text() == out_b.read_text()
