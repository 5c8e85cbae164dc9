"""The port's VisualizationSolver and VisualizationApplication against the
JAX package's, on the CPU.

What is held: the batch plan at the shipped configs' shapes (equal); a
LargeVis run of both packages on a 1,500-point, 5-cluster set with the
config's optimizer (10-NN label agreement of each layout >= 0.9, the two
within 0.05); the pad columns stay exactly zero; the application's
frames equal the reference's on the same coordinates (moved across with
set_model_state); the save/load round trip; the factory."""
import numpy as np
import pytest
import torch

import graphvite_tpu.application as ref_app
import graphvite_tpu.solver as ref_solver
from graphvite_tpu import knn as ref_knn
from graphvite_tpu_torch import (Application, KNNGraph,
                                 VisualizationApplication,
                                 VisualizationSolver)
from graphvite_tpu_torch.ops import steps as port_steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores (see tests/test_torch_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clusters(n=1500, d=10, c=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)) * 8
    labels = np.repeat(np.arange(c), n // c)
    x = centers[labels] + rng.standard_normal((n, d))
    return x.astype(np.float32), labels


def _agreement(coords, labels, k=10):
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1)[:, :k]
    return float((labels[nn] == labels[:, None]).mean())


class _Shape:
    """A graph of a config's size, for the batch plan only."""

    def __init__(self, num_vertex, num_neighbor):
        self.num_vertex = num_vertex
        self.num_edge = num_vertex * num_neighbor


@pytest.mark.parametrize("num_vertex", [70_000, 1_331_167])
def test_batch_plan_matches_reference(num_vertex):
    """largevis_mnist_2d.yaml / largevis_imagenet.yaml: the plan uses the
    layout's dim 2, not the pad width: B 99,840 in one micro-step, 64
    groups of 1,560."""
    plans = []
    for solver in (VisualizationSolver(dim=2, device="cpu"),
                   ref_solver.VisualizationSolver(dim=2)):
        solver.graph = _Shape(num_vertex, 200)
        solver.batch_size = 100000
        solver.num_negative = 5
        solver._pooled_step = True
        plans.append(solver._batch_plan())
    assert plans[0] == plans[1] == (99840, 99840, 1)
    assert port_steps.graph_pool_groups(99840) == 64


def _train_port(x, epochs, **train_kw):
    app = VisualizationApplication(dim=2, device="cpu")
    app.load(vectors=x, num_neighbor=15, perplexity=10)
    app.build(optimizer=dict(type="Adam", lr=0.5, weight_decay=1e-5),
              num_negative=5, batch_size=2000, episode_size=50)
    app.train(num_epoch=epochs, negative_weight=3, log_frequency=10**9,
              **train_kw)
    return app


def test_layout_quality_matches_reference():
    # the configs' 50 epochs: after 30 the clusters are still forming here,
    # and either package's agreement ranges over 0.7-0.93 by seed
    x, labels = _clusters()
    port = _train_port(x, 50)
    ref = ref_app.VisualizationApplication(dim=2)
    ref.load(vectors=x, num_neighbor=15, perplexity=10)
    ref.build(optimizer=dict(type="Adam", lr=0.5, weight_decay=1e-5),
              num_negative=5, batch_size=2000, episode_size=50)
    ref.train(num_epoch=50, negative_weight=3, log_frequency=10**9)
    assert port.solver.num_batch == ref.solver.num_batch
    assert port.solver.effective_batch == ref.solver.effective_batch
    got = _agreement(port.solver.coordinates, labels)
    want = _agreement(np.asarray(ref.solver.coordinates), labels)
    assert got >= 0.9 and want >= 0.9 and abs(got - want) <= 0.05, \
        (got, want)
    losses = port.solver.batch_losses
    assert bool(torch.isfinite(losses).all())
    assert float(losses[-20:].mean()) < float(losses[:20].mean())


@pytest.mark.parametrize("optimizer,float_type", [
    ({"type": "Adam", "lr": 0.5, "weight_decay": 1e-5}, "float32"),
    ({"type": "Adam", "lr": 0.5, "weight_decay": 1e-5}, "bfloat16"),
    ({"type": "SGD", "lr": 0.5, "weight_decay": 1e-5}, "float32")])
def test_pad_columns_stay_zero(optimizer, float_type):
    x, labels = _clusters(n=300, c=3, seed=1)
    g = KNNGraph(device="cpu").load_numpy(x, num_neighbor=10, perplexity=5)
    solver = VisualizationSolver(dim=2, float_type=float_type,
                                 device="cpu")
    solver.build(g, optimizer=optimizer, num_negative=5, batch_size=512,
                 episode_size=10)
    solver.train(num_epoch=20, negative_weight=3, log_frequency=10**9)
    table = solver.state["tables"][0]
    assert table.shape == (300, 8) and table.dtype == getattr(torch,
                                                              float_type)
    assert bool((table[:, 2:] == 0).all())
    for m in solver.state["moments"][0]:
        assert bool((m[:, 2:] == 0).all())
    coords = solver.coordinates
    assert coords.shape == (300, 2) and np.isfinite(coords).all()
    assert np.abs(coords).max() > 1e-3


def test_classic_step_route(monkeypatch):
    """GRAPHVITE_NEG_SHARING=0 trains the classic K-draw step. As in the
    reference, `negative_sharing=False` equals `auto` (0) and reads the
    variable. The classic step needs more epochs than the pooled one here
    (10-NN agreement 0.41 at 40 epochs on both packages; 0.89-0.97 at
    200, by seed)."""
    x, labels = _clusters(n=600, c=3, seed=2)
    app = VisualizationApplication(dim=2, device="cpu")
    app.load(vectors=x, num_neighbor=10, perplexity=5)
    app.build(num_negative=5, batch_size=512, episode_size=10)
    calls = []
    real = port_steps.make_vis_train_step
    monkeypatch.setattr(port_steps, "make_vis_train_step",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    app.train(num_epoch=2, negative_sharing=False, log_frequency=10**9)
    assert not calls
    monkeypatch.setenv("GRAPHVITE_NEG_SHARING", "0")
    app.train(num_epoch=200, negative_weight=3, negative_sharing=False,
              log_frequency=10**9)
    assert len(calls) == 1
    assert _agreement(app.solver.coordinates, labels) >= 0.85


def test_resume_continues_without_reinit():
    x, _ = _clusters(n=300, c=3, seed=3)
    g = KNNGraph(device="cpu").load_numpy(x, num_neighbor=10, perplexity=5)
    solver = VisualizationSolver(dim=2, device="cpu")
    solver.build(g, num_negative=5, batch_size=512, episode_size=4)
    solver.train(num_epoch=4, log_frequency=10**9)
    before = solver.coordinates.copy()
    solver.batch_id = solver.num_batch // 2
    solver.train(num_epoch=4, resume=True, log_frequency=10**9)
    assert not np.array_equal(before, solver.coordinates)
    assert np.abs(solver.coordinates - before).max() < np.abs(before).max()


def test_parts_left_out_raise():
    """No part of the solver is left out now: the host sampler backend
    trains (tests/test_torch_host_sampler.py), and the multi-device engine
    (tests/test_torch_mesh.py) takes the application's `gpus` as two CPU
    workers and trains on the replicated engine."""
    x, _ = _clusters(n=200, c=2, seed=4)
    host = VisualizationSolver(dim=2, sampler_backend="host", device="cpu")
    host.build(KNNGraph(device="cpu").load_numpy(x, num_neighbor=10,
                                                 perplexity=5),
               num_negative=5, batch_size=512, episode_size=4)
    host.train(num_epoch=4, log_frequency=10**9)
    assert host.host_stats["pools"] >= 1
    assert np.isfinite(host.coordinates).all()
    s = VisualizationSolver(dim=2, num_worker=2, device="cpu")
    assert s.worker_devices == [torch.device("cpu")] * 2
    app = VisualizationApplication(dim=2, gpus=[0, 1], device="cpu")
    app.load(vectors=x, num_neighbor=10, perplexity=5)
    app.build(num_negative=5, batch_size=512, episode_size=4)
    app.train(num_epoch=20, log_frequency=10**9)
    assert app.solver.mesh_stats["workers"] == 2
    coords = app.solver.coordinates
    assert coords.shape == (200, 2) and np.isfinite(coords).all()
    assert not np.allclose(coords, 0)


def _both_apps(dim, coords):
    x, _ = _clusters(n=coords.shape[0], c=2, seed=4)
    port = VisualizationApplication(dim=dim, device="cpu")
    port.load(vectors=x, num_neighbor=10, perplexity=5)
    port.build(batch_size=256, episode_size=2)
    ref = ref_app.VisualizationApplication(dim=dim)
    ref.load(vectors=x, num_neighbor=10, perplexity=5)
    ref.build(batch_size=256, episode_size=2)
    for app in (port, ref):
        app.set_model_state({"coordinates": coords})
    return port, ref


def test_application_frames_match_reference():
    rng = np.random.default_rng(5)
    n = 60
    coords = rng.normal(size=(n, 2)).astype(np.float32)
    coords[3] = [40.0, -40.0]                       # an outlier
    port, ref = _both_apps(2, coords)
    np.testing.assert_array_equal(port.solver.coordinates, coords)
    np.testing.assert_array_equal(port.visualization(),
                                  np.asarray(ref.visualization()))
    HY = [["A" if i < n // 2 else "B",
           ("a1" if i % 2 else "a2") if i < n // 2
           else ("b1" if i % 2 else "b2")] for i in range(n)]
    for target in (None, "a1", "B"):
        got = port.hierarchy(HY=HY, target=target)
        want = ref.hierarchy(HY=HY, target=target)
        assert len(got) == len(want)
        for (gc, gy, gf), (wc, wy, wf) in zip(got, want):
            np.testing.assert_array_equal(gc, np.asarray(wc))
            np.testing.assert_array_equal(gy, wy)
            assert gf == wf
    frames = port.hierarchy(HY=HY, target="a1")
    assert len(frames) == 2 and set(frames[1][1]) == {"a1", "a2", "else"}
    assert frames[0][0].shape[0] == n - 1           # the outlier is out
    with pytest.raises(ValueError, match="can't find target"):
        port.hierarchy(HY=HY, target="zz")


def test_hierarchy_from_file(tmp_path):
    rng = np.random.default_rng(6)
    coords = rng.normal(size=(40, 2)).astype(np.float32)
    port, ref = _both_apps(2, coords)
    f = tmp_path / "hierarchy.txt"
    f.write_text("".join("root c%d\n" % (i % 3) if i % 5 else "root\n"
                         for i in range(40)))
    got = port.hierarchy(file_name=str(f), target="c1")
    want = ref.hierarchy(file_name=str(f), target="c1")
    for (gc, gy, gf), (wc, wy, wf) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        assert gf == wf


def test_animation_and_plots():
    rng = np.random.default_rng(7)
    port, ref = _both_apps(2, rng.normal(size=(30, 2)).astype(np.float32))
    for app in (port, ref):
        with pytest.raises(ValueError, match="dim=3"):
            app.animation()
    coords3 = rng.normal(size=(30, 3)).astype(np.float32)
    port3, ref3 = _both_apps(3, coords3)
    np.testing.assert_array_equal(port3.animation(), coords3)
    np.testing.assert_array_equal(port3.visualization(),
                                  np.asarray(ref3.visualization()))


def test_visualization_with_a_save_file(tmp_path):
    """With matplotlib a plot is written; without it the plot is skipped
    with a warning, as in the reference. The clipped coordinates come
    back either way."""
    rng = np.random.default_rng(8)
    coords = rng.normal(size=(30, 2)).astype(np.float32)
    port, _ = _both_apps(2, coords)
    f = tmp_path / "layout.png"
    out = port.visualization(Y=np.arange(30) % 3, save_file=str(f))
    np.testing.assert_array_equal(out, port.visualization())
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert not f.exists()
    else:
        assert f.exists()


def test_save_and_load_model(tmp_path):
    x, labels = _clusters(n=300, c=3, seed=9)
    app = _train_port(x, 5)
    f = str(tmp_path / "vis.pkl")
    app.save_model(f, save_hyperparameter=True)
    app2 = VisualizationApplication(dim=2, device="cpu")
    app2.load(vectors=x, num_neighbor=15, perplexity=10)
    app2.build(batch_size=2000)
    app2.load_model(f)
    np.testing.assert_array_equal(app2.solver.coordinates,
                                  app.solver.coordinates)
    assert bool((app2.solver.state["tables"][0][:, 2:] == 0).all())
    # the reference reads the port's file
    ref = ref_app.VisualizationApplication(dim=2)
    ref.load(vectors=x, num_neighbor=15, perplexity=10)
    ref.build(batch_size=2000)
    ref.load_model(f)
    np.testing.assert_array_equal(np.asarray(ref.solver.coordinates),
                                  app.solver.coordinates)


def test_application_factory():
    app = Application("visualization", dim=2, device="cpu")
    assert isinstance(app, VisualizationApplication)
    assert isinstance(app.graph, KNNGraph) and app.graph.device.type == "cpu"
    assert isinstance(app.solver, VisualizationSolver)
    assert app.solver.get_default_optimizer() == \
        type(app.solver.get_default_optimizer())(
            type="Adam", lr=0.5, weight_decay=1e-5, schedule="linear")
    with pytest.raises(ValueError, match="vectors or file_name"):
        app.load()
    assert ref_knn.KNNGraph.IVF_THRESHOLD == KNNGraph.IVF_THRESHOLD
