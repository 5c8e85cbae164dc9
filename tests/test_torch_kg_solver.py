"""The port's KnowledgeGraphSolver and KnowledgeGraphApplication against the
JAX package's: the batch plan, the negative-sharing auto rule and the pool
groups at the shipped shapes, the init schemes, predict and the state
bridge from the same numbers, the gaps that raise, and the application end
to end on a cut of the offline math fixture (device="cpu").

Tolerances: predict rtol 1e-5, atol 1e-6 (the models' own tolerance); the
end-to-end runs start from different random draws (threefry and Philox), so
quality is held statistically: filtered tail MRR above a floor well over
chance (0.007 for 1,000 entities) and within 0.05 of the reference's at the
same cut."""
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.steps as ref_steps
import graphvite_tpu.solver as ref_solver
import graphvite_tpu_torch.ops.steps as port_steps
import graphvite_tpu_torch.solver as port_solver
from graphvite_tpu.application import Application as RefApplication
from graphvite_tpu_torch import (Application, KnowledgeGraph,
                                 KnowledgeGraphApplication,
                                 KnowledgeGraphSolver, state_from_numpy,
                                 state_to_numpy)

NAMES = ["TransE", "DistMult", "ComplEx", "SimplE", "RotatE", "QuatE"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MATH_OPERATORS = [
    ("+", lambda x, y: (x + y) % 1000),
    ("-", lambda x, y: (x - y) % 1000),
    ("*", lambda x, y: (x * y) % 1000),
    ("/", lambda x, y: x // y),
    ("%", lambda x, y: x % y),
]


def _math(num_triplet, seed):
    """The math fixture's generator (graphvite_tpu/dataset.py:Math)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(num_triplet):
        op, fn = MATH_OPERATORS[int(rng.rand() * len(MATH_OPERATORS))]
        x = int(rng.rand() * 1000)
        y = int(rng.rand() * 30) + 1
        out.append((str(x), "%s%d" % (op, y), str(fn(x, y))))
    return out


def _small_kg(n=60, nr=5, e=600, seed=0):
    rng = np.random.default_rng(seed)
    return [("e%d" % h, "r%d" % r, "e%d" % t)
            for h, r, t in zip(rng.integers(0, n, e), rng.integers(0, nr, e),
                               rng.integers(0, n, e))]


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

SHAPES = {
    # name: (entities, triplets, dim, K, batch) and the plan the reference
    # trains: (pooled, effective batch, micro batch, micro steps, groups)
    "rotate_fb15k": ((14951, 483142, 2048, 64, 100000),
                     (True, 14848, 7424, 2, 16)),
    "rotate_wikidata5m": ((4594485, 20614279, 512, 64, 100000),
                          (True, 60928, 60928, 1, 128)),
    "demo_math": ((1000, 20000, 512, 8, 100000),
                  (False, 11776, 5888, 2, None)),
    "demo_math_dim128": ((1000, 20000, 128, 8, 100000),
                         (False, 47104, 5888, 8, None)),
}


def _planned(module, shape, pooled):
    v, e, dim, k, batch = shape
    s = module.KnowledgeGraphSolver.__new__(module.KnowledgeGraphSolver)
    s.graph = types.SimpleNamespace(num_vertex=v, num_edge=e)
    s.dim, s.num_negative, s.batch_size = dim, k, batch
    s._pooled_step = pooled
    return s._batch_plan()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_batch_plan_and_groups_match_reference(name, monkeypatch):
    for var in ("GRAPHVITE_STEP_BYTES", "GRAPHVITE_MAX_TOUCH"):
        monkeypatch.delenv(var, raising=False)
    shape, (pooled, eff, micro, num_micro, groups) = SHAPES[name]
    for p in (False, True):
        assert (_planned(port_solver, shape, p)
                == _planned(ref_solver, shape, p))
    assert _planned(port_solver, shape, pooled) == (eff, micro, num_micro)
    # the auto rule, as both packages state it
    budget = 2e9
    assert (budget / ((shape[3] + 2) * shape[2] * 32) < 4096) == pooled
    if pooled:
        assert (port_steps.kg_pool_groups(micro)
                == ref_steps.kg_pool_groups(micro) == groups)


def _train_both(trips, dim, k, monkeypatch=None, **train_kw):
    out = []
    for make in (lambda: RefApplication("knowledge graph", dim=dim),
                 lambda: Application("knowledge graph", dim=dim,
                                     device="cpu")):
        app = make()
        app.load(triplet_list=trips)
        app.build(optimizer={"type": "SGD", "lr": 0.01}, num_negative=k,
                  batch_size=128, episode_size=2)
        app.train(num_epoch=0.5, log_frequency=10**9, **train_kw)
        out.append(app.solver)
    return out


@pytest.mark.parametrize("step_bytes,pooled", [("2e9", False), ("1e6", True)])
def test_negative_sharing_auto_rule_matches_reference(step_bytes, pooled,
                                                      monkeypatch):
    """Shrinking GRAPHVITE_STEP_BYTES flips both packages' rule to the
    pooled step at the same point, with the same plan."""
    monkeypatch.setenv("GRAPHVITE_STEP_BYTES", step_bytes)
    monkeypatch.delenv("GRAPHVITE_KG_NEG_SHARING", raising=False)
    ref, port = _train_both(_small_kg(), 16, 4, model="TransE")
    assert ref._pooled_step == port._pooled_step == pooled
    assert ref._batch_plan() == port._batch_plan()
    assert ref.effective_batch == port.effective_batch
    assert ref.num_batch == port.num_batch


def test_negative_sharing_argument_and_env(monkeypatch):
    trips = _small_kg()
    app = KnowledgeGraphApplication(dim=16, device="cpu")
    app.load(triplet_list=trips)
    app.build(num_negative=4, batch_size=128, episode_size=2)
    kw = dict(model="RotatE", num_epoch=0.5, log_frequency=10**9)
    app.train(negative_sharing=True, **kw)
    step = app.solver._active_step_fn
    assert app.solver._pooled_step and step.pool_shape == (2, 64)
    assert step.fast_rotate               # RotatE, the default wd 0
    monkeypatch.setenv("GRAPHVITE_KG_POOL_SIZE", "10")
    monkeypatch.setenv("GRAPHVITE_KG_POOL_TARGET", "16")
    monkeypatch.setenv("GRAPHVITE_KG_NEG_SHARING", "1")
    app.train(**kw)
    assert app.solver._active_step_fn.pool_shape == (8, 10)
    monkeypatch.setenv("GRAPHVITE_KG_NEG_SHARING", "0")
    app.train(**kw)
    assert not app.solver._pooled_step
    assert not hasattr(app.solver._active_step_fn, "pool_shape")
    with pytest.raises(ValueError, match="unknown model"):
        app.train(model="LINE")


# ---------------------------------------------------------------------------
# the solver's parts
# ---------------------------------------------------------------------------

def _built(model, dim=16, float_type=None, optimizer=None, **kw):
    g = KnowledgeGraph().load_triplet_list(_small_kg(**kw))
    s = KnowledgeGraphSolver(dim=dim, float_type=float_type, device="cpu",
                             seed=3)
    s.build(g, optimizer=optimizer if optimizer is not None else 0,
            num_negative=4, batch_size=64)
    s.model = model
    return s


def test_default_optimizer_and_shapes():
    s = _built("RotatE")
    ref = ref_solver.KnowledgeGraphSolver(dim=16).get_default_optimizer()
    opt = s.optimizer
    assert (opt.type, opt.lr, opt.weight_decay, opt.schedule) == (
        ref.type, ref.lr, ref.weight_decay, ref.schedule) == (
        "Adam", 5e-5, 0.0, "linear")
    assert s._table_shapes() == ((60, 16), (5, 16))
    assert s.get_available_models() == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("float_type", ["float32", "bfloat16"])
def test_init_schemes(name, float_type):
    """Ranges and layouts of knowledge_graph.cuh:567-621, as the reference
    draws them."""
    d, margin = 16, 8.0
    s = _built(name, dim=d, float_type=float_type, n=400, e=4000)
    s.init_embeddings(margin=margin)
    ent, rel = (t.float().numpy() for t in s.state["tables"])
    assert ent.shape == (400, d) and rel.shape == (5, d)
    assert s.state["tables"][0].dtype == getattr(torch, float_type)
    assert all(m.dtype == torch.float32 and not m.any()
               for g in s.state["moments"] for m in g)
    assert len(s.state["moments"][0]) == len(s.state["moments"][1]) == 2
    slack = 1.01 if float_type == "bfloat16" else 1.0
    if name == "TransE":
        assert np.abs(ent).max() <= margin / d * slack
        assert np.abs(rel).max() <= margin / d * slack
        assert np.abs(ent).max() > 0.9 * margin / d
    elif name in ("DistMult", "ComplEx", "SimplE"):
        assert np.abs(ent).max() <= 0.5 * slack and np.abs(ent).max() > 0.45
        assert np.abs(rel).max() <= 0.5 * slack
    elif name == "RotatE":
        assert np.abs(ent).max() <= margin * 2 / d * slack
        assert np.abs(ent).max() > 0.9 * margin * 2 / d
        assert np.abs(rel[:, : d // 2]).max() <= math.pi * slack
        assert np.abs(rel[:, : d // 2]).max() > 2.0
        assert not rel[:, d // 2:].any()        # phases in the first half
    else:
        # quaternions of modulus |m| <= 1 / sqrt(d / 2), every part used
        q = ent.reshape(400, d // 4, 4)
        norm = np.sqrt((q * q).sum(-1))
        assert norm.max() <= 1 / math.sqrt(d / 2) * slack
        assert norm.max() > 0.8 / math.sqrt(d / 2)
        assert (np.abs(q).reshape(-1, 4).max(0) > 0).all()
        assert (q[..., 1:] * np.sign(q[..., 1:2]) >= 0).all()
    assert abs(float(ent.mean())) < 0.1 * np.abs(ent).max()


def test_init_depends_on_seed_only():
    a, b = _built("RotatE"), _built("RotatE")
    a.init_embeddings()
    b.init_embeddings()
    assert torch.equal(a.state["tables"][0], b.state["tables"][0])
    b.init_embeddings()                     # the solver's rng moved on
    assert not torch.equal(a.state["tables"][0], b.state["tables"][0])


@pytest.mark.parametrize("float_type", ["float32", "bfloat16"])
def test_state_bridge_and_predict_match_reference(float_type):
    """The reference's KG state (tables entity, relation; moments per
    table) goes through state_from_numpy / state_to_numpy unchanged, and
    both solvers score the same triplets from it."""
    trips = _small_kg()
    rng = np.random.default_rng(5)
    ref = ref_solver.KnowledgeGraphSolver(dim=16, float_type=float_type)
    from graphvite_tpu.graph import KnowledgeGraph as RefKG
    ref.build(RefKG().load_triplet_list(trips), num_negative=4,
              batch_size=64)
    samples = np.stack([rng.integers(0, 60, 50), rng.integers(0, 60, 50),
                        rng.integers(0, 5, 50)], axis=1)
    for name in NAMES:
        ref.model = name
        ref.margin, ref.l3_regularization = 7.0, 1e-3
        ref.init_embeddings(margin=7.0)
        state_np = {"tables": tuple(np.asarray(t)
                                    for t in ref.state["tables"]),
                    "moments": tuple(tuple(np.asarray(m) + 0.5 for m in g)
                                     for g in ref.state["moments"])}
        port = _built(name, float_type=float_type)
        port.margin, port.l3_regularization = 7.0, 1e-3
        port.state = state_from_numpy(state_np, "cpu", float_type)
        assert port.state["tables"][0].dtype == getattr(torch, float_type)
        back = state_to_numpy(port.state)
        for a, b in zip(back["tables"], state_np["tables"]):
            np.testing.assert_array_equal(a, np.asarray(b).view(a.dtype))
        for ga, gb in zip(back["moments"], state_np["moments"]):
            for a, b in zip(ga, gb):
                np.testing.assert_array_equal(a, b)
        got = port.predict(samples)
        want = np.asarray(ref.predict(samples))
        assert got.dtype == np.float32 and got.shape == (50,)
        # bf16 tables are scored in bf16 by both packages, each rounding
        # its own intermediates: 16 terms of ~1 at 2^-8 each
        tol = (dict(rtol=2e-2, atol=0.1) if float_type == "bfloat16"
               else dict(rtol=1e-5, atol=1e-6))
        np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_array_equal(port.entity_embeddings,
                                      np.asarray(ref.entity_embeddings))
        np.testing.assert_array_equal(port.relation_embeddings,
                                      np.asarray(ref.relation_embeddings))


def test_predict_in_chunks():
    s = _built("TransE")
    s.margin, s.l3_regularization = 6.0, 1e-3
    s.init_embeddings()
    rng = np.random.default_rng(2)
    n = (1 << 20) + 7
    samples = np.stack([rng.integers(0, 60, n), rng.integers(0, 60, n),
                        rng.integers(0, 5, n)], axis=1)
    got = s.predict(samples)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got[-7:], s.predict(samples[-7:]))
    assert s.predict(samples[:0]).shape == (0,)


def test_gaps_raise_naming_their_items():
    """The gaps that raised are ported: num_worker > 1 (and the
    application's `gpus`) trains on the sharded engine with CPU workers
    (tests/test_torch_kg_mesh.py), sampler_backend="host" on the host edge
    sampler (tests/test_torch_host_sampler.py)."""
    g = KnowledgeGraph().load_triplet_list(_small_kg())
    for kw in (dict(num_worker=2), dict(sampler_backend="host")):
        s = KnowledgeGraphSolver(dim=8, device="cpu", **kw)
        s.build(g, num_negative=4, batch_size=64)
        s.train(model="RotatE", num_epoch=4, margin=6.0,
                log_frequency=10**9)
        assert np.isfinite(s.entity_embeddings).all()
        stats = s.mesh_stats if "num_worker" in kw else s.host_stats
        assert stats["loop_s"] > 0
    app = KnowledgeGraphApplication(dim=8, gpus=[0, 1], device="cpu")
    assert app.solver.num_worker == 2
    assert app.solver.worker_devices == [torch.device("cpu")] * 2
    # host-resident tables (ROADMAP item 15) are ported: predict scores
    # them in chunks of touched rows, as the device tables score
    s = _built("TransE")
    s.margin, s.l3_regularization = 6.0, 1e-3
    s.init_embeddings()
    samples = np.array([[0, 1, 0], [5, 3, 2], [59, 7, 4]])
    device_scores = s.predict(samples)
    s.state = {"tables": tuple(t.numpy() for t in s.state["tables"]),
               "moments": s.state["moments"]}
    np.testing.assert_allclose(s.predict(samples), device_scores,
                               rtol=1e-6, atol=1e-6)
    # visualization is ported (ROADMAP item 13)
    assert type(Application("visualization", dim=2, device="cpu")
                ).__name__ == "VisualizationApplication"
    # the word graph is ported (ROADMAP item 14)
    assert type(Application("word graph", dim=2, device="cpu")
                ).__name__ == "WordGraphApplication"
    with pytest.raises(ValueError, match="application type"):
        Application("nonsense", dim=2)
    assert isinstance(Application("knowledge_graph", dim=2, device="cpu"),
                      KnowledgeGraphApplication)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert KnowledgeGraphSolver(dim=4).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KnowledgeGraphSolver(dim=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KnowledgeGraphApplication(dim=4)


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("pooled", [False, True])
def test_train_runs_every_route(rule, pooled):
    """Loss falls, tables finite, positive_reuse and resume keep the batch
    count, relation_lr_multiplier 0 freezes the relation table."""
    opt = ({"type": "SGD", "lr": 0.05} if rule == "SGD"
           else {"type": "Adam", "lr": 5e-3})
    s = _built("RotatE", optimizer=opt)
    s.batch_size = 64
    kw = dict(model="RotatE", margin=6.0, negative_sharing=pooled,
              log_frequency=10**9)
    s.train(num_epoch=20, positive_reuse=2, **kw)
    assert s.batch_id >= s.num_batch == 20 * 600 // 64
    losses = s.batch_losses.numpy()
    assert np.isfinite(losses).all()
    assert losses[-20:].mean() < losses[:20].mean()
    assert all(np.isfinite(t).all() for t in (s.entity_embeddings,
                                              s.relation_embeddings))
    assert s._pooled_step == pooled
    before = s.relation_embeddings.copy()
    ent_before = s.entity_embeddings.copy()
    s.batch_id = s.num_batch // 2
    s.train(num_epoch=20, resume=True, relation_lr_multiplier=0.0, **kw)
    np.testing.assert_array_equal(s.relation_embeddings, before)
    assert not np.array_equal(s.entity_embeddings, ent_before)


def test_adam_sort_route_in_solver_matches_dense(monkeypatch):
    """Above DENSE_UPDATE_ELEMS the moment update takes the moment kernel's
    route (its plain version on the CPU), in place: the same run as the
    dense route from the same seed (rtol 1e-5, atol 1e-7: one sum per row
    in another order)."""
    import graphvite_tpu_torch.optim as port_optim

    outs = []
    for limit in (1 << 26, 8):
        monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", limit)
        s = _built("RotatE", optimizer={"type": "Adam", "lr": 5e-3})
        s.train(model="RotatE", num_epoch=2, margin=6.0,
                negative_sharing=True, log_frequency=10**9)
        outs.append((s.entity_embeddings, s.relation_embeddings,
                     s.state["moments"][0][1].numpy()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the application
# ---------------------------------------------------------------------------

def test_application_files_and_model_state(tmp_path):
    trips = _small_kg()
    train = tmp_path / "train.txt"
    train.write_text("".join("%s\t%s\t%s\n" % t for t in trips))
    test = tmp_path / "test.txt"
    test.write_text("# header\n" + "".join(
        "%s\t%s\t%s\n" % t for t in trips[:30]) + "unknown\tr0\te1\n")
    app = KnowledgeGraphApplication(dim=16, device="cpu")
    app.load(file_name=str(train))
    app.build(optimizer=5e-3, num_negative=4, batch_size=64)
    app.train(model="DistMult", num_epoch=3, l3_regularization=1e-3,
              log_frequency=10**9)
    assert app._margin_or_l3() == 1e-3
    m = app.evaluate("link prediction", file_name=str(test),
                     filter_files=[str(train), str(test)], target="head")
    assert set(m) == {"MR", "MRR", "HITS@1", "HITS@3", "HITS@10"}
    assert 1 <= m["MR"] <= 60
    fast = app.evaluate("link prediction", file_name=str(test), fast_mode=5,
                        seed=1)
    assert 0 < fast["MRR"] <= 1
    top = app.evaluate("entity prediction", file_name=str(test), k=3)
    assert len(top) == 30 and len(top[0]) == 3
    assert top[0][0][1] >= top[0][1][1] and top[0][0][0] in app.graph.entity2id
    heads = app.evaluate("entity prediction", R=["r1"], T=["e2"],
                         target="head", k=2)
    assert len(heads) == 1 and len(heads[0]) == 2
    out = tmp_path / "top.txt"
    assert app.entity_prediction(file_name=str(test), k=2,
                                 save_file=str(out)) is None
    assert len(out.read_text().splitlines()) == 30
    with pytest.raises(ValueError, match="extension"):
        app.entity_prediction(file_name=str(test), save_file="x.csv")
    bad = tmp_path / "bad.txt"
    bad.write_text("a b\n")
    with pytest.raises(ValueError, match="Invalid line 1"):
        app._read_triplet_file(str(bad))
    with pytest.raises(ValueError, match="provide file_name"):
        app.load()
    with pytest.raises(ValueError, match="unknown evaluation task"):
        app.evaluate("nonsense")

    path = tmp_path / "model.pkl"
    app.save_model(str(path), save_hyperparameter=True)
    other = KnowledgeGraphApplication(dim=16, device="cpu")
    # another entity order: the saved rows follow the names
    other.load(triplet_list=trips[::-1])
    other.build(num_negative=4, batch_size=64)
    other.load_model(str(path))
    assert other.solver.model == "DistMult"
    assert other.solver.l3_regularization == 1e-3
    for name in list(app.graph.entity2id)[:10]:
        np.testing.assert_array_equal(
            other.solver.entity_embeddings[other.graph.entity2id[name]],
            app.solver.entity_embeddings[app.graph.entity2id[name]])
    again = other.evaluate("link prediction", file_name=str(test),
                           filter_files=[str(train), str(test)],
                           target="head")
    assert again == m


def test_math_fixture_end_to_end_against_reference():
    """config/demo/math.yaml cut to dim 32, 40 epochs, batch 2000, lr 1e-2:
    the loss falls, and the filtered tail MRR on 300 test triplets clears
    a floor and lies within 0.05 of the reference's."""
    train, valid, test = _math(20000, 1023), _math(1000, 1024), _math(1000,
                                                                      1025)
    fH, fR, fT = (list(x) for x in zip(*(train + valid + test)))
    H, R, T = (list(x) for x in zip(*test[:300]))
    mrr = {}
    for name, make in (
            ("ref", lambda: RefApplication("knowledge graph", dim=32)),
            ("port", lambda: Application("knowledge graph", dim=32,
                                         device="cpu"))):
        app = make()
        app.load(triplet_list=train)
        app.build(optimizer={"type": "Adam", "lr": 1e-2, "weight_decay": 0},
                  num_negative=8, batch_size=2000, episode_size=100)
        app.train(model="RotatE", num_epoch=40, margin=9,
                  adversarial_temperature=2, log_frequency=10**9)
        assert app.solver._batch_plan() == (1792, 1792, 1)
        mrr[name] = app.evaluate("link prediction", H=H, R=R, T=T,
                                 filter_H=fH, filter_R=fR, filter_T=fT,
                                 target="tail")["MRR"]
        if name == "port":
            losses = app.solver.batch_losses.numpy()
            assert losses[-40:].mean() < 0.5 * losses[:40].mean()
    assert mrr["port"] > 0.06, mrr
    assert abs(mrr["port"] - mrr["ref"]) < 0.05, mrr
