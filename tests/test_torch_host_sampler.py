"""The port's host sampler backend (graphvite_tpu_torch/sampler.py, the
host sampling of ops/alias.py, ops/steps.py:make_pool_runner and
SolverBase._train_loop with each solver's routing) against the JAX
package's (graphvite_tpu/sampler.py, ops/alias.py, ops/steps.py,
solver.py).

The samplers are host numpy driven by the same default_rng streams, so
their pools must equal the reference's bit for bit from the same seed.
The pool runner is fed the reference's negative draws (its per-batch
fold_in of the pool key, split as each step splits it): losses rtol
2e-5, tables rtol 3e-4, atol 3e-6 (tests/test_torch_steps.py's
tolerances, over several batches). The solvers' random streams differ
(threefry against Philox), so quality is held statistically:
two-block AUC > 0.9 and within 0.03 of the reference's host run; the
math fixture's MRR within 0.05; LargeVis 10-NN label agreement >= 0.9
and within 0.05 (tests/test_torch_vis_solver.py's bar)."""
import threading
import time
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.alias as ref_alias
import graphvite_tpu.ops.steps as ref_steps
import graphvite_tpu.optim as ref_optim
import graphvite_tpu.sampler as ref_sampler
import graphvite_tpu_torch.ops.alias as port_alias
import graphvite_tpu_torch.ops.steps as port_steps
import graphvite_tpu_torch.optim as port_optim
import graphvite_tpu_torch.sampler as port_sampler
from graphvite_tpu.graph import Graph as RefGraph
from graphvite_tpu.graph import KnowledgeGraph as RefKG
from graphvite_tpu.models import KG_MODELS as REF_KG_MODELS
from graphvite_tpu_torch.graph import Graph, KnowledgeGraph
from graphvite_tpu_torch.models import KG_MODELS
from graphvite_tpu_torch.solver import state_from_numpy, state_to_numpy

LOSS_TOL = dict(rtol=2e-5)
TABLE_TOL = dict(rtol=3e-4, atol=3e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores (see tests/test_torch_mesh.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _edges(n=200, seed=0, weighted=False, dead_ends=False):
    rng = np.random.default_rng(seed)
    edges = [(str(rng.integers(n)), str(rng.integers(n)))
             for _ in range(n * 6)]
    if dead_ends:
        # sinks: walks that reach them stop
        edges += [(str(rng.integers(n)), "sink%d" % i) for i in range(20)]
    if weighted:
        w = rng.random(len(edges)) * 3 + 0.1
        edges = [e + (float(x),) for e, x in zip(edges, w)]
    return edges


def _graphs(undirected=True, **kw):
    e = _edges(**kw)
    return (RefGraph().load_edge_list(e, as_undirected=undirected),
            Graph().load_edge_list(e, as_undirected=undirected))


# ---------------------------------------------------------------------------
# host alias sampling and the samplers, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base", [1, 3, 7, 64])
def test_pseudo_shuffle_matches_reference(base):
    rng = np.random.default_rng(base)
    arrays = [rng.integers(0, 100, 1000).astype(np.int32) for _ in range(2)]
    got = port_sampler.pseudo_shuffle(arrays, base)
    want = ref_sampler.pseudo_shuffle(arrays, base)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_host_alias_sampling_matches_reference():
    """AliasTable.sample / sample_with and PackedAliasTables.sample
    (weighted and uniform tables) equal the reference's from the same
    generator state."""
    rng = np.random.default_rng(0)
    w = rng.random(300) ** 3 + 1e-3
    got = port_alias.AliasTable(w).sample(np.random.default_rng(5), 5000)
    want = ref_alias.AliasTable(w).sample(np.random.default_rng(5), 5000)
    np.testing.assert_array_equal(got, want)
    offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 6, 80))])
    flat = rng.random(int(offsets[-1])) + 0.1
    ids = rng.integers(0, 80, 4000)
    u1, u2 = rng.random(4000), rng.random(4000)
    for port_t, ref_t in (
            (port_alias.PackedAliasTables(flat, offsets),
             ref_alias.PackedAliasTables(flat, offsets)),
            (port_alias.PackedAliasTables.uniform_tables(offsets),
             ref_alias.PackedAliasTables.uniform_tables(offsets))):
        np.testing.assert_array_equal(port_t.sample(ids, u1, u2),
                                      ref_t.sample(ids, u1, u2))


@pytest.mark.parametrize("relations", [False, True])
def test_edge_sampler_pools_match_reference(relations):
    if relations:
        rng = np.random.default_rng(1)
        trips = [(str(rng.integers(50)), "r%d" % rng.integers(5),
                  str(rng.integers(50))) for _ in range(600)]
        rg = RefKG().load_triplet_list(trips)
        pg = KnowledgeGraph().load_triplet_list(trips)
    else:
        rg, pg = _graphs(weighted=True)
    ref = ref_sampler.EdgeSampler(rg, seed=11, with_relation=relations)
    port = port_sampler.EdgeSampler(pg, seed=11, with_relation=relations)
    for size in (1000, 777, 4096):
        got, want = port.pool(size), ref.pool(size)
        assert len(got) == len(want) == (3 if relations else 2)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["uniform", "weighted", "biased"])
@pytest.mark.parametrize("aug,base", [(1, 1), (3, 3)])
def test_random_walk_sampler_pools_match_reference(kind, aug, base):
    """Uniform, weighted and node2vec's biased walks (p 4, q 0.5), with
    dead ends on a directed graph: pools equal the reference's."""
    rg, pg = _graphs(undirected=kind != "weighted",
                     weighted=kind == "weighted", dead_ends=True)
    kw = dict(random_walk_length=8, random_walk_batch_size=100,
              shuffle_base=base, seed=3, biased=kind == "biased", p=4.0,
              q=0.5)
    ref = ref_sampler.RandomWalkSampler(rg, aug, **kw)
    port = port_sampler.RandomWalkSampler(pg, aug, **kw)
    if kind == "biased":
        np.testing.assert_array_equal(port.edge_tables.prob,
                                      ref.edge_tables.prob)
        assert (port_sampler.second_order_entries(pg)
                == int(port.edge_tables.offsets[-1])
                == int(ref.edge_tables.offsets[-1]))
    for size in (2000, 3333):
        for a, b in zip(port.pool(size), ref.pool(size)):
            np.testing.assert_array_equal(a, b)


class _Counter:
    """A sampler whose pools count up, slowly."""

    def __init__(self):
        self.n = 0

    def pool(self, size):
        time.sleep(0.002)
        self.n += 1
        return (np.full(size, self.n, np.int32),)


def test_prefetching_pool_keeps_order_and_closes():
    before = threading.active_count()
    prefetch = port_sampler.PrefetchingPool(_Counter(), 4, depth=2)
    got = [int(prefetch.next()[0][0]) for _ in range(20)]
    assert got == list(range(1, 21))
    prefetch.close()
    assert not prefetch.thread.is_alive()
    assert threading.active_count() == before
    assert prefetch.pools >= 20 and prefetch.produce_s > 0


class _Failing:
    def pool(self, size):
        raise RuntimeError("sampler broke")


def test_prefetching_pool_raises_the_thread_error():
    prefetch = port_sampler.PrefetchingPool(_Failing(), 4)
    with pytest.raises(RuntimeError, match="sampler broke"):
        prefetch.next()
    prefetch.close()
    assert not prefetch.thread.is_alive()


# ---------------------------------------------------------------------------
# the pool runner on the reference's draws
# ---------------------------------------------------------------------------

def _graph_pool_draws(key, shape):
    k1, k2 = jax.random.split(key)
    return tuple(_t(jax.random.uniform(k, shape)) for k in (k1, k2))


@pytest.mark.parametrize("kind", ["graph", "kg_classic", "kg_pooled"])
def test_pool_runner_matches_reference(kind):
    """make_pool_runner over a [N, B] pool: each batch at lr =
    schedule(batch_id0 + i), no mask, the step's negatives from the
    reference's fold_in(base_key, i)."""
    rng = np.random.default_rng(4)
    N, B, V, R, D, K = 5, 32, 50, 4, 16, 4
    heads = rng.integers(0, V, (N, B)).astype(np.int32)
    tails = rng.integers(0, V, (N, B)).astype(np.int32)
    rels = rng.integers(0, R, (N, B)).astype(np.int32)
    kw = dict(type="Adam", lr=1e-2, weight_decay=1e-3)
    ropt, popt = ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw)
    base = jax.random.PRNGKey(7)
    keys = [jax.random.fold_in(base, i) for i in range(N)]
    ent = (rng.normal(size=(V, D)) * 0.5).astype(np.float32)
    if kind == "graph":
        G, M = 4, 8
        w = np.maximum(rng.random(V), 1e-3)
        neg = port_alias.device_alias_arrays(port_alias.AliasTable(w))
        rstep = ref_steps.make_graph_pool_step(ropt, K, 5.0, pool_size=M,
                                               pool_groups=G, trust=0.25)
        pstep = port_steps.make_graph_pool_step(popt, K, 5.0, pool_size=M,
                                                pool_groups=G, trust=0.25)
        second = (rng.normal(size=(V, D)) * 0.1).astype(np.float32)
        pool = (heads, tails)
        draws = [_graph_pool_draws(k, (G, M)) for k in keys]
        rneg, pneg = tuple(jnp.asarray(a) for a in neg), tuple(
            torch.from_numpy(a) for a in neg)
    else:
        mdl, rmdl = KG_MODELS["RotatE"], REF_KG_MODELS["RotatE"]
        if kind == "kg_pooled":
            G, M = 4, 8
            rstep = ref_steps.make_kg_pool_step(rmdl, ropt, K, 6.0, 2.0, 1.0,
                                                pool_size=M, pool_groups=G)
            pstep = port_steps.make_kg_pool_step(mdl, popt, K, 6.0, 2.0, 1.0,
                                                 pool_size=M, pool_groups=G)
            draws = [_t(jax.random.randint(k, (G, M), 0, V)) for k in keys]
        else:
            rstep = ref_steps.make_kg_train_step(rmdl, ropt, K, 6.0, 2.0,
                                                 1.0)
            pstep = port_steps.make_kg_train_step(mdl, popt, K, 6.0, 2.0,
                                                  1.0)
            draws = []
            for k in keys:
                nid = _t(jax.random.randint(k, (B, K), 0, 2 * V))
                ch = nid < V
                draws.append((torch.where(ch, nid, nid - V), ch))
        second = (rng.normal(size=(R, D)) * 0.5).astype(np.float32)
        pool = (heads, tails, rels)
        rneg = pneg = ()
    state_np = {"tables": (ent, second),
                "moments": tuple(tuple(np.zeros_like(t) for _ in range(2))
                                 for t in (ent, second))}
    has_rel = kind != "graph"
    rrun = ref_steps.make_pool_runner(rstep, 100, ropt, has_rel)
    prun = port_steps.make_pool_runner(pstep, 100, popt, has_rel)
    rstate, rl = rrun(jax.tree_util.tree_map(jnp.asarray, state_np),
                      tuple(jnp.asarray(a) for a in pool), jnp.int32(3),
                      base, *rneg)
    pstate, pl = prun(state_from_numpy(state_np, "cpu"),
                      tuple(torch.from_numpy(a) for a in pool), 3, None,
                      *pneg, draws=draws)
    assert pl.shape == (N,)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **LOSS_TOL)
    got = state_to_numpy(pstate)
    for a, b in zip(got["tables"], rstate["tables"]):
        np.testing.assert_allclose(a, np.asarray(b), **TABLE_TOL)
    for ga, gb in zip(got["moments"], rstate["moments"]):
        for a, b in zip(ga, gb):
            np.testing.assert_allclose(a, np.asarray(b), **TABLE_TOL)


# ---------------------------------------------------------------------------
# the solvers on the host backend
# ---------------------------------------------------------------------------

def _two_block_edges(seed=0):
    """tests/test_torch_mesh.py's two communities of 40 vertices."""
    rng = np.random.default_rng(seed)
    edges = []
    for blk in range(2):
        nodes = np.arange(blk * 40, blk * 40 + 40)
        for _ in range(500):
            u, v = rng.choice(nodes, 2, replace=False)
            edges.append((str(u), str(v)))
    for _ in range(25):
        edges.append((str(rng.integers(0, 40)),
                      str(40 + rng.integers(0, 40))))
    return edges


def _two_block_auc(solver):
    from graphvite_tpu_torch.application.evaluate import rank_sum_auc
    n2i = solver.graph.name2id
    intra = np.asarray([(n2i[str(a)], n2i[str(b)])
                        for a in range(0, 20) for b in range(20, 40)])
    cross = np.asarray([(n2i[str(a)], n2i[str(b)])
                        for a in range(0, 20) for b in range(60, 80)])
    si = np.asarray(solver.predict(intra))
    sc = np.asarray(solver.predict(cross))
    return rank_sum_auc(np.r_[si, sc], np.r_[np.ones(len(si)),
                                            np.zeros(len(sc))])


HOST_RUNS = {"LINE": dict(num_epoch=200, augmentation_step=1),
             "DeepWalk": dict(num_epoch=60, augmentation_step=2,
                              random_walk_length=6),
             "node2vec": dict(num_epoch=60, augmentation_step=2,
                              random_walk_length=6, p=4.0, q=2.0)}


@pytest.mark.parametrize("model", ["LINE", "DeepWalk", "node2vec"])
def test_graph_solver_host_backend_matches_reference(model):
    """GraphSolver(sampler_backend="host"): EdgeSampler for LINE,
    RandomWalkSampler for DeepWalk and (biased) node2vec, the pair pool
    step over batch_size: AUC > 0.9, within 0.03 of the reference's."""
    import graphvite_tpu.solver as ref_solver
    import graphvite_tpu_torch.solver as port_solver

    edges = _two_block_edges()
    aucs = {}
    for name, pkg, G, kw in (("port", port_solver, Graph, {"device": "cpu"}),
                             ("ref", ref_solver, RefGraph, {})):
        s = pkg.GraphSolver(dim=16, seed=1024, sampler_backend="host", **kw)
        s.build(G().load_edge_list(edges), num_negative=2, batch_size=256,
                episode_size=4)
        s.train(model=model, negative_weight=1.0, log_frequency=10**9,
                **HOST_RUNS[model])
        aucs[name] = _two_block_auc(s)
        if name == "port":
            port = s
    assert port.effective_batch == 256 and port.batch_id >= port.num_batch
    assert not (port._sweep_scatter or port._banded_fused
                or port._multitail_T)
    assert port.host_stats["pools"] >= port.batch_id // 4
    assert aucs["port"] > 0.9 and abs(aucs["port"] - aucs["ref"]) <= 0.03, \
        aucs


def test_kg_solver_host_backend_matches_reference():
    """KnowledgeGraphSolver(sampler_backend="host") on
    tests/test_parallel.py's math fixture: filtered tail MRR within 0.05
    of the reference's host run, and > 0.85."""
    import graphvite_tpu.solver as ref_solver
    from graphvite_tpu_torch.application import evaluate as ev
    from graphvite_tpu_torch.solver import KnowledgeGraphSolver

    rng = np.random.default_rng(0)
    trips = []
    for _ in range(2000):
        x = int(rng.integers(50))
        c = int(rng.integers(1, 6))
        trips.append((str(x), "+%d" % c, str((x + c) % 50)))
    test = [(str(x), "+%d" % c, str((x + c) % 50))
            for x, c in zip(rng.integers(50, size=100),
                            rng.integers(1, 6, size=100))]
    mrr = {}
    for name, cls, kg_cls, kw in (
            ("ref", ref_solver.KnowledgeGraphSolver, RefKG, {}),
            ("port", KnowledgeGraphSolver, KnowledgeGraph,
             {"device": "cpu"})):
        kg = kg_cls().load_triplet_list(trips)
        s = cls(dim=32, seed=0, sampler_backend="host", **kw)
        s.build(kg, optimizer=dict(type="Adam", lr=5e-3), num_negative=8,
                batch_size=256, episode_size=8)
        s.train(model="RotatE", num_epoch=150, margin=6.0,
                log_frequency=10**9)
        e2i, r2i = kg.entity2id, kg.relation2id
        rows = [(e2i[h], r2i[r], e2i[t]) for h, r, t in test]
        H, R, T = (np.asarray(x) for x in zip(*rows))
        rk = ev.filtered_rankings(
            "RotatE", np.asarray(s.entity_embeddings),
            np.asarray(s.relation_embeddings), H, R, T, defaultdict(set),
            defaultdict(set), 6.0, "tail")
        mrr[name] = ev.ranking_metrics(rk)["MRR"]
    assert mrr["port"] > 0.85 and abs(mrr["port"] - mrr["ref"]) < 0.05, mrr


def test_visualization_solver_host_backend_matches_reference():
    """VisualizationSolver(sampler_backend="host") on
    tests/test_torch_vis_solver.py's clusters: 10-NN label agreement
    >= 0.9 and within 0.05 of the reference's host run."""
    import graphvite_tpu.application as ref_app
    from graphvite_tpu_torch import VisualizationApplication

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((5, 10)) * 8
    labels = np.repeat(np.arange(5), 300)
    x = (centers[labels] + rng.standard_normal((1500, 10))).astype(np.float32)

    def agreement(coords, k=10):
        d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nn = np.argsort(d2, axis=1)[:, :k]
        return float((labels[nn] == labels[:, None]).mean())

    got = {}
    for name, cls, kw in (("port", VisualizationApplication,
                           {"device": "cpu"}),
                          ("ref", ref_app.VisualizationApplication, {})):
        app = cls(dim=2, **kw)
        app.solver.sampler_backend = "host"
        app.load(vectors=x, num_neighbor=15, perplexity=10)
        app.build(optimizer=dict(type="Adam", lr=0.5, weight_decay=1e-5),
                  num_negative=5, batch_size=2000, episode_size=50)
        app.train(num_epoch=50, negative_weight=3, log_frequency=10**9)
        got[name] = agreement(np.asarray(app.solver.coordinates))
        if name == "port":
            assert app.solver.host_stats["pools"] >= 1
    assert got["port"] >= 0.9 and abs(got["port"] - got["ref"]) <= 0.05, got
