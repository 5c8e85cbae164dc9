"""The port's walk route as a whole (solver.py, application/), on the CPU:
bridged reference weights score identically, DeepWalk and LINE learn the
two-block graph as well as the reference does, checkpoints and embeddings
round-trip, the application pipeline runs, and the paths that earlier
slices left to later ones now train."""
import numpy as np
import pytest
import torch

import graphvite_tpu.solver as ref_solver
from graphvite_tpu_torch import GraphApplication, state_from_numpy, state_to_numpy
from graphvite_tpu_torch.application.evaluate import rank_sum_auc
from graphvite_tpu_torch.graph import Graph
from graphvite_tpu_torch.solver import GraphSolver
from test_solver import two_blocks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores: with torch's default of one thread
    per core, each of the many tiny ops these tests run waits on the other
    workers' threads (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_graph(ref_graph):
    """The same input edge list through the port's Graph."""
    n = ref_graph.num_edge
    edges = [(ref_graph.id2name[u], ref_graph.id2name[v])
             for u, v in zip(ref_graph.edge_heads[:n], ref_graph.edge_tails[:n])]
    g = Graph().load_edge_list(edges)
    np.testing.assert_array_equal(g.edge_heads, ref_graph.edge_heads)
    return g


def _link_auc(solver, g):
    """AUC of real edges against random cross-block pairs (the protocol of
    tests/test_solver.py)."""
    rng = np.random.default_rng(1)
    half = g.num_vertex // 2
    k = min(300, g.num_directed_edge)
    sel = rng.choice(g.num_directed_edge, size=k, replace=False)
    pos = np.stack([g.edge_heads[sel], g.edge_tails[sel]], axis=1)
    neg = np.stack([rng.integers(half, size=k),
                    rng.integers(half, size=k) + half], axis=1)
    scores = solver.predict(np.concatenate([pos, neg]))
    return rank_sum_auc(scores, np.array([1] * k + [0] * k))


def _train_small(solver, g, model="DeepWalk", num_epoch=40, **kw):
    solver.build(g, num_negative=1, batch_size=512, episode_size=4)
    solver.train(model=model, num_epoch=num_epoch, augmentation_step=2,
                 random_walk_length=6, log_frequency=10**9, **kw)
    return solver


@pytest.mark.parametrize("float_type", ["float32", "bfloat16"])
def test_bridged_reference_weights_score_identically(float_type):
    g = two_blocks(40)
    ref = _train_small(ref_solver.GraphSolver(dim=8, float_type=float_type),
                       g)
    import jax
    state_np = jax.tree_util.tree_map(np.asarray, ref.state)
    port = GraphSolver(dim=8, float_type=float_type, device="cpu")
    port.build(_port_graph(g), num_negative=1, batch_size=512)
    port.state = state_from_numpy(state_np, "cpu", float_type)
    port.model = ref.model
    np.testing.assert_array_equal(port.vertex_embeddings,
                                  ref.vertex_embeddings)
    np.testing.assert_array_equal(port.context_embeddings,
                                  ref.context_embeddings)
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, g.num_vertex, (200, 2))
    np.testing.assert_allclose(port.predict(pairs), ref.predict(pairs),
                               rtol=1e-6, atol=1e-7 if float_type ==
                               "float32" else 1e-2)
    back = state_to_numpy(port.state)
    for a, b in zip(back["tables"], state_np["tables"]):
        np.testing.assert_array_equal(a, b.view(a.dtype))


@pytest.mark.parametrize("float_type", ["float32", "bfloat16"])
def test_bridged_reference_moments_roundtrip(float_type):
    """A moment optimizer's state (Adam: two moment tables on each side,
    float32 whatever the tables' type) crosses from the reference into
    the port and back unchanged, so parity runs can start both from it."""
    import jax

    g = two_blocks(40)
    ref = ref_solver.GraphSolver(dim=8, float_type=float_type)
    ref.build(g, optimizer={"type": "Adam", "lr": 1e-3}, num_negative=1,
              batch_size=512, episode_size=2)
    ref.train(model="LINE", num_epoch=20, augmentation_step=1,
              log_frequency=10**9)
    state_np = jax.tree_util.tree_map(np.asarray, ref.state)
    state = state_from_numpy(state_np, "cpu", float_type)
    assert [t.dtype for t in state["tables"]] == [getattr(torch,
                                                          float_type)] * 2
    assert [len(group) for group in state["moments"]] == [2, 2]
    for group, ref_group in zip(state["moments"], state_np["moments"]):
        for m, r in zip(group, ref_group):
            assert m.dtype == torch.float32 and bool((m != 0).any())
            np.testing.assert_array_equal(m.numpy(), r)
    back = state_to_numpy(state)
    for a, b in zip(back["tables"], state_np["tables"]):
        np.testing.assert_array_equal(a, b.view(a.dtype))
    for group, ref_group in zip(back["moments"], state_np["moments"]):
        for a, b in zip(group, ref_group):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", ["DeepWalk", "LINE"])
def test_learns_two_blocks_like_the_reference(model):
    """Statistical: the random streams differ, so the AUCs differ a little;
    both must clear 0.9 and stay within 0.03 of each other."""
    g = two_blocks()
    kw = dict(model=model, num_epoch=2000, augmentation_step=2,
              random_walk_length=8, negative_weight=1.0,
              log_frequency=10**9)
    opt = {"type": "SGD", "lr": 0.1, "weight_decay": 5e-3}
    aucs = []
    for solver, graph in ((ref_solver.GraphSolver(dim=16), g),
                          (GraphSolver(dim=16, device="cpu"),
                           _port_graph(g))):
        solver.build(graph, optimizer=opt, num_negative=1, batch_size=2048,
                     episode_size=8)
        solver.train(**kw)
        aucs.append(_link_auc(solver, graph))
    ref_auc, port_auc = aucs
    assert port_auc > 0.9, aucs
    assert abs(port_auc - ref_auc) < 0.03, aucs


def test_losses_stay_on_device_and_fall():
    g = _port_graph(two_blocks(40))
    s = _train_small(GraphSolver(dim=8, device="cpu"), g, num_epoch=200)
    losses = s.batch_losses
    assert torch.is_tensor(losses) and losses.shape[0] >= s.num_batch
    assert torch.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()


@pytest.mark.parametrize("float_type", ["float32", "bfloat16"])
def test_checkpoint_roundtrip_and_resume(tmp_path, float_type):
    g = _port_graph(two_blocks(40))
    s = _train_small(GraphSolver(dim=8, float_type=float_type, device="cpu"),
                     g, model="DeepWalk")
    path = str(tmp_path / "ckpt.pkl")
    s.save_checkpoint(path)
    t = GraphSolver(dim=8, float_type=float_type, device="cpu")
    t.build(g, num_negative=1, batch_size=512, episode_size=4)
    t.load_checkpoint(path)
    assert (t.batch_id, t.num_batch, t.model) == (s.batch_id, s.num_batch,
                                                  s.model)
    assert t.optimizer == s.optimizer
    for a, b in zip(t.state["tables"], s.state["tables"]):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    t.train(model="DeepWalk", num_epoch=80, resume=True,
            augmentation_step=2, random_walk_length=6, log_frequency=10**9)
    assert np.isfinite(t.vertex_embeddings).all()


def test_save_embeddings_roundtrip(tmp_path):
    g = _port_graph(two_blocks(40))
    s = _train_small(GraphSolver(dim=8, device="cpu"), g)
    path = tmp_path / "emb.bin"
    s.save_embeddings(str(path))
    data = path.read_bytes()
    header, rest = data.split(b"\n", 1)
    assert header == b"%d 8" % g.num_vertex
    emb = s.vertex_embeddings
    for i in range(g.num_vertex):
        name, rest = rest.split(b" ", 1)
        assert name.decode() == g.id2name[i]
        row = np.frombuffer(rest[:32], np.float32)
        np.testing.assert_array_equal(row, emb[i])
        assert rest[32:33] == b"\n"
        rest = rest[33:]
    assert rest == b""


def test_graph_application_pipeline(tmp_path):
    rng = np.random.default_rng(0)
    g = two_blocks()
    half = g.num_vertex // 2
    edge_file = tmp_path / "edges.txt"
    n = g.num_edge
    edge_file.write_text("".join(
        "%s\t%s\n" % (g.id2name[u], g.id2name[v])
        for u, v in zip(g.edge_heads[:n], g.edge_tails[:n])))
    link_file = tmp_path / "links.txt"
    lines = ["%s\t%s\t1\n" % (g.id2name[u], g.id2name[v])
             for u, v in zip(g.edge_heads[:100], g.edge_tails[:100])]
    lines += ["%d\t%d\t0\n" % (rng.integers(half), rng.integers(half) + half)
              for _ in range(100)]
    link_file.write_text("".join(lines))
    label_file = tmp_path / "labels.txt"
    label_file.write_text("".join("%d\t%s\n" % (i, "a" if i < half else "b")
                                  for i in range(g.num_vertex)))

    app = GraphApplication(dim=16, device="cpu")
    app.load(file_name=str(edge_file))
    app.build(optimizer={"type": "SGD", "lr": 0.1, "weight_decay": 5e-3},
              num_negative=1, batch_size=2048, episode_size=8)
    app.train(model="DeepWalk", num_epoch=1000, augmentation_step=2,
              random_walk_length=8, negative_weight=1.0, log_frequency=10**9)
    link = app.evaluate("link prediction", file_name=str(link_file))
    assert link["AUC"] > 0.8
    nc = app.evaluate("node classification", file_name=str(label_file),
                      portions=(0.5,), patience=20)
    assert nc["micro-F1@50%"] > 0.8

    model_file = str(tmp_path / "model.pkl")
    app.save_model(model_file, save_hyperparameter=True)
    other = GraphApplication(dim=16, device="cpu")
    other.load(file_name=str(edge_file))
    other.build(num_negative=1, batch_size=2048)
    other.load_model(model_file)
    np.testing.assert_array_equal(other.solver.vertex_embeddings,
                                  app.solver.vertex_embeddings)
    assert other.evaluate("link prediction",
                          file_name=str(link_file)) == link


def test_linear_classification_matches_reference():
    """The torch probe follows the reference's protocol: same split, same
    updates; F1 agrees on a separable problem."""
    from graphvite_tpu.application import evaluate as ref_ev
    from graphvite_tpu_torch.application import evaluate as port_ev

    rng = np.random.default_rng(3)
    emb = rng.normal(size=(120, 6)).astype(np.float32)
    labels = np.zeros((120, 3), np.int32)
    labels[np.arange(120), np.argmax(emb[:, :3], axis=1)] = 1
    a = ref_ev.linear_classification(emb, labels, 0.5, patience=10)
    b = port_ev.linear_classification(emb, labels, 0.5, patience=10)
    assert a.keys() == b.keys()
    for key in a:
        assert abs(a[key] - b[key]) < 0.02, (a, b)


@pytest.mark.parametrize("kwargs,env,match", [
    # blocked episodes are ported: this case now trains
    (dict(augmentation_step=1, num_partition=2), {}, None),
    # the reference's experimental walk opt-ins are ported: these cases
    # now train (tests/test_torch_opt_ins.py)
    (dict(model="node2vec"), {"GRAPHVITE_BULK_WALKS": "1"}, None),
    (dict(), {"GRAPHVITE_BF16_BAND": "1"}, None),
    (dict(), {"GRAPHVITE_SWEEP_BANDED": "1"}, None),
    # bf16 operands for the pool step's products: they take effect on
    # bf16 tables only, so a float32 run with the switch set trains too
    (dict(augmentation_step=1, float_type="bfloat16"),
     {"GRAPHVITE_BF16_COMPUTE": "1"}, None),
    (dict(augmentation_step=1), {"GRAPHVITE_BF16_COMPUTE": "1"}, None),
])
def test_unported_training_paths_raise(kwargs, env, match, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    g = _port_graph(two_blocks(40))
    kw = dict(model="DeepWalk", num_epoch=1, augmentation_step=2,
              random_walk_length=6, num_partition=0)
    kw.update(kwargs)
    s = GraphSolver(dim=8, device="cpu", float_type=kw.pop("float_type",
                                                            "float32"))
    s.build(g, batch_size=512, num_partition=kw.pop("num_partition"))
    if match is None:
        s.train(**kw)
        if "num_partition" in kwargs:
            assert s.blocked_stats["num_partition"] == 2
        assert np.isfinite(s.vertex_embeddings).all()
        return
    with pytest.raises(NotImplementedError, match=match):
        s.train(**kw)


@pytest.mark.parametrize("kwargs,match", [
    # more workers than visible cards, without device_ids (the multi-device
    # engines are ported: tests/test_torch_mesh.py)
    (dict(num_worker=2, device=None), "devices visible"),
    # the host sampler backend is ported: this case now trains
    # (tests/test_torch_host_sampler.py)
    (dict(sampler_backend="host"), None),
])
def test_unported_solver_options_raise(kwargs, match, monkeypatch):
    kwargs = dict(dict(device="cpu"), **kwargs)
    if kwargs["device"] is None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if match is None:
        s = GraphSolver(dim=8, **kwargs)
        s.build(_port_graph(two_blocks(40)), batch_size=512)
        s.train(model="DeepWalk", num_epoch=1, augmentation_step=2,
                random_walk_length=6, log_frequency=10**9)
        assert s.host_stats["pools"] >= 1
        assert np.isfinite(s.vertex_embeddings).all()
        return
    with pytest.raises(ValueError, match=match):
        GraphSolver(dim=8, **kwargs)


@pytest.mark.parametrize("v,batch,dim,k,slot,max_touch,step_bytes", [
    (60, 2048, 16, 1, 36, None, None),
    (1_138_499, 100000, 128, 1, 410, None, None),
    (1_138_499, 250000, 128, 1, 410, None, None),
    (5000, 100000, 64, 1, 410, "4", None),      # micro-steps engage
    (20000, 100000, 128, 3, 246, None, "1e8"),  # memory cap binds
])
def test_batch_plan_matches_reference(v, batch, dim, k, slot, max_touch,
                                      step_bytes, monkeypatch):
    """The batch plan (effective batch, micro batch, micro-step count) of
    the banded route matches the reference's, env knobs included."""
    import types

    for name, value in (("GRAPHVITE_MAX_TOUCH", max_touch),
                        ("GRAPHVITE_STEP_BYTES", step_bytes)):
        if value is not None:
            monkeypatch.setenv(name, value)
    plans = []
    for solver in (ref_solver.GraphSolver(dim=dim),
                   GraphSolver(dim=dim, device="cpu")):
        solver.graph = types.SimpleNamespace(num_vertex=v)
        solver.batch_size, solver.num_negative = batch, k
        solver._pooled_step, solver._walk_slot_unit = True, slot
        plans.append(solver._batch_plan())
    assert plans[0] == plans[1]
    if max_touch:
        assert plans[1][2] > 1


def test_micro_steps_train_through_the_solver(monkeypatch):
    monkeypatch.setenv("GRAPHVITE_MAX_TOUCH", "2")
    g = _port_graph(two_blocks(40))
    s = GraphSolver(dim=8, device="cpu")
    s.build(g, num_negative=1, batch_size=2048, episode_size=2)
    s._pooled_step, s._walk_slot_unit = True, 28
    assert s._batch_plan()[2] > 1
    s.train(model="DeepWalk", num_epoch=20, augmentation_step=2,
            random_walk_length=6, log_frequency=10**9)
    assert np.isfinite(s.vertex_embeddings).all()
    assert s.batch_losses.shape[0] >= s.num_batch


class _Planned(Exception):
    """Raised by a recording engine: the loop has planned its run."""


def _mesh_plan(route, V, E, dim, K, batch, W, num_epoch, monkeypatch):
    """What the mesh loop of `route` plans for a graph of V vertices and E
    edges on W workers: (batch per worker, batches, episode batches); for
    "kg" `_mesh_kg_plan`'s (negative pool, batch, batches, episode
    batches). The engines are replaced by recorders that stop the loop
    once they are built, so no edge is sampled."""
    import types

    import graphvite_tpu_torch.solver as port_solver
    from graphvite_tpu_torch.solver import (KnowledgeGraphSolver,
                                            VisualizationSolver)

    seen = {}

    def recorder(group, *args, **kwargs):
        seen.update(kwargs)
        if args and "batch_size" not in kwargs:    # the replicated engine
            seen["batch_size"], seen["ep_batches"] = args[2], args[3]
        raise _Planned()

    graph = types.SimpleNamespace(
        num_vertex=V, num_edge=E, as_undirected=True,
        degrees=np.arange(V, dtype=np.int64) % 50 + 1,
        vertex_weights=np.arange(V, dtype=np.float64) % 50 + 1)
    if route == "kg":
        s = KnowledgeGraphSolver(dim=dim, num_worker=W, device="cpu")
        s.graph, s.batch_size, s.num_negative = graph, batch, K
        return s._mesh_kg_plan(num_epoch)
    if route == "vis":
        monkeypatch.setattr(port_solver, "ReplicatedEdgeTrainer", recorder)
        s = VisualizationSolver(dim=dim, num_worker=W, device="cpu")
        s.build(graph, num_negative=K, batch_size=batch)
        train = dict(num_epoch=num_epoch, positive_reuse=5)
    else:
        monkeypatch.setattr(port_solver, "ShardedGraphTrainer", recorder)
        s = GraphSolver(dim=dim, num_worker=W, device="cpu")
        s.build(graph, num_negative=K, batch_size=batch)
        walks = route == "walks"
        train = dict(model="DeepWalk" if walks else "LINE",
                     num_epoch=num_epoch,
                     augmentation_step=5 if walks else 1,
                     random_walk_length=40)
    with pytest.raises(_Planned):
        s.train(log_frequency=10**9, **train)
    assert s.effective_batch == seen["batch_size"]
    return seen["batch_size"], s.num_batch, seen["ep_batches"]


_EDGES = ("edges", 20000, 600000, 32, 1, 100000, 4, 4000)
_WALKS = ("walks", 20000, 600000, 32, 1, 100000, 4, 200)
_KG_POOLED = ("kg", 20000, 500000, 512, 64, 100000, 2, 2000)
_KG_GLOBAL = ("kg", 20000, 500000, 32, 4, 100000, 2, 2000)
_VIS = ("vis", 70000, 14_000_000, 2, 5, 100000, 2, 1)


@pytest.mark.parametrize("shape,env,plan", [
    (_EDGES, {}, (99840, 24038, 35)),
    (_EDGES, {"GRAPHVITE_STEP_BYTES": "2e7"}, (9728, 246710, 35)),
    (_EDGES, {"GRAPHVITE_MAX_TOUCH": "4"}, (6656, 360576, 35)),
    (_EDGES, {"GRAPHVITE_MIN_SWEEPS": "64"}, (99840, 24038, 23)),
    (_EDGES, {"GRAPHVITE_NEG_SHARING": "0",
              "GRAPHVITE_STEP_BYTES": "1e8"}, (32512, 73818, 35)),
    (_WALKS, {}, (78720, 1524, 35)),
    (_WALKS, {"GRAPHVITE_STEP_BYTES": "5e7"}, (13120, 9146, 35)),
    (_WALKS, {"GRAPHVITE_MAX_TOUCH": "2"}, (3280, 36585, 35)),
    (_WALKS, {"GRAPHVITE_MIN_SWEEPS": "64"}, (78720, 1524, 35)),
    (_WALKS, {"GRAPHVITE_WALK_BIDIR": "0"}, (91840, 1306, 35)),
    (_KG_POOLED, {}, ("pooled", 9472, 105574, 35)),
    (_KG_POOLED, {"GRAPHVITE_STEP_BYTES": "2e8"},
     ("pooled", 5888, 169836, 35)),
    (_KG_POOLED, {"GRAPHVITE_MIN_SWEEPS": "1000"},
     ("pooled", 9472, 105574, 17)),
    (_KG_GLOBAL, {}, ("global", 99840, 10016, 35)),
    (_KG_GLOBAL, {"GRAPHVITE_MAX_TOUCH": "4"},
     ("global", 6656, 150240, 35)),
    (_KG_GLOBAL, {"GRAPHVITE_MIN_SWEEPS": "64"},
     ("global", 99840, 10016, 26)),
    (_VIS, {}, (99840, 140, 4)),
    (_VIS, {"GRAPHVITE_STEP_BYTES": "1e6"}, (7680, 1822, 4)),
    (_VIS, {"GRAPHVITE_MAX_TOUCH": "0.1"}, (76800, 182, 4)),
    (_VIS, {"GRAPHVITE_VIS_MESH_EP": "64"}, (99840, 140, 64)),
])
def test_mesh_plans_are_pinned(shape, env, plan, monkeypatch):
    """The mesh loops' plans, which no reference test holds: the graph
    engine's for edges and for walks, `_mesh_kg_plan` for pooled and for
    global negatives, and the replicated LargeVis engine's, each with a
    binding GRAPHVITE_STEP_BYTES, GRAPHVITE_MAX_TOUCH and
    GRAPHVITE_MIN_SWEEPS among its cases. The values are the plans the
    solver made before its loops shared one batch plan."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert _mesh_plan(*shape, monkeypatch=monkeypatch) == plan


def test_solver_reads_knobs_and_loops_once():
    """solver.py reads the environment only in its knob reader
    (`Knobs.read`, once a train call) and writes the episode loop once
    (`SolverBase._run_episodes`), whatever the route."""
    import ast
    import inspect

    import graphvite_tpu_torch.solver as port_solver

    tree = ast.parse(inspect.getsource(port_solver))

    def environment_reads(node, scope):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            scope = scope + (node.name,)
        if (isinstance(node, ast.Attribute)
                and node.attr in ("environ", "getenv")
                and isinstance(node.value, ast.Name)
                and node.value.id == "os"):
            yield ".".join(scope)
        for child in ast.iter_child_nodes(node):
            yield from environment_reads(child, scope)

    assert set(environment_reads(tree, ())) == {"Knobs.read"}
    assert not [n for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.module == "os"]
    loops = [ast.unparse(n.test) for n in ast.walk(tree)
             if isinstance(n, ast.While)]
    assert loops.count("self.batch_id < self.num_batch") == 1
