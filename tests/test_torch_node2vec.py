"""node2vec in the port (ops/device_sampler.py, native/, solver.py) against
the JAX package: the cuckoo hash and table bit for bit, the biased walk
chain fed the reference's own draws identical to the reference's under
both membership routes, the proposal-count rule, the reference's
statistical checks of the biased walks, and node2vec end to end through
GraphSolver and GraphApplication.

Tolerances: hashes, tables and chains are compared for equality. Learning:
two-block link-prediction AUC > 0.9 and within 0.03 of the reference's
(the random streams differ)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import graphvite_tpu.ops.device_sampler as ref
import graphvite_tpu.solver as ref_solver
import graphvite_tpu_torch.ops.device_sampler as port
from graphvite_tpu import native as ref_native
from graphvite_tpu.graph import Graph as RefGraph
from graphvite_tpu_torch import GraphApplication, native as port_native
from graphvite_tpu_torch.graph import Graph
from graphvite_tpu_torch.solver import GraphSolver
from test_solver import two_blocks
from test_torch_solver import _link_auc, _port_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores: with torch's default of one thread
    per core, each of the many tiny ops these tests run waits on the other
    workers' threads (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the cuckoo hash and table
# ---------------------------------------------------------------------------

def test_cuckoo_mix_and_buckets_are_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    x[:6] = [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    assert (x >= 2**31).sum() > 9000
    got = port._cuckoo_mix(torch.as_tensor(x.astype(np.int64)))
    want = np.asarray(ref._cuckoo_mix(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # vertex ids as the chain holds them (int32 in the reference)
    u = rng.integers(0, 2**31, 20000).astype(np.int32)
    v = rng.integers(0, 2**31, 20000).astype(np.int32)
    u[:3], v[:3] = [0, 2**31 - 1, 7], [2**31 - 1, 0, 7]
    for log_m in (1, 10, 23, 31):
        mask = (1 << log_m) - 1
        r1, r2 = ref._cuckoo_buckets(jnp.asarray(u), jnp.asarray(v),
                                     np.uint32(mask))
        p1, p2 = port._cuckoo_buckets(torch.as_tensor(u).long(),
                                      torch.as_tensor(v).long(), mask)
        np.testing.assert_array_equal(p1.numpy(), np.asarray(r1))
        np.testing.assert_array_equal(p2.numpy(), np.asarray(r2))


def _power_law_edges(v, e, seed, weighted=False):
    rng = np.random.default_rng(seed)
    a = (rng.random(e) ** 2 * v).astype(np.int64)
    b = (rng.random(e) ** 2 * v).astype(np.int64)
    keep = a != b
    edges = [(str(x), str(y)) for x, y in zip(a[keep], b[keep])]
    if weighted:
        w = rng.random(len(edges)) * 3 + 0.1
        edges = [e + (float(x),) for e, x in zip(edges, w)]
    return edges


def test_cuckoo_table_matches_reference():
    if ref_native.lib is None or port_native.load() is None:
        pytest.skip("no g++ for the native table build")
    edges = _power_law_edges(3000, 20000, 1)
    rg = RefGraph().load_edge_list(edges)
    pg = Graph().load_edge_list(edges)
    want = ref.DeviceWalkSampler._build_cuckoo(rg)
    got = port.DeviceWalkSampler._build_cuckoo(pg)
    assert got is not None and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the byte cap falls back to the search route, as in the reference
    assert port.DeviceWalkSampler._build_cuckoo(pg, max_bytes=1e3) is None
    assert ref.DeviceWalkSampler._build_cuckoo(rg, max_bytes=1e3) is None
    # every directed edge hits its buckets; the port's probe agrees
    us = np.repeat(np.arange(pg.num_vertex), np.diff(pg.indptr))
    b1, b2 = port._cuckoo_buckets(torch.as_tensor(us),
                                  torch.as_tensor(pg.indices),
                                  got.shape[0] - 1)
    hit = np.zeros(us.size, bool)
    for b in (b1.numpy(), b2.numpy()):
        r = got[b]
        hit |= (((r[:, 0] == us) & (r[:, 1] == pg.indices))
                | ((r[:, 2] == us) & (r[:, 3] == pg.indices)))
    assert hit.all()


# ---------------------------------------------------------------------------
# the biased chain, fed the reference's draws
# ---------------------------------------------------------------------------

def _reference_biased_draws(key, W, L, R):
    """The uniforms the reference's biased chain draws from `key`
    (device_sampler.py:248-251, :371-373, :407): start-edge draws, then
    per step and round the (3, R, W) proposal draws of fold_in(step key,
    round)."""
    kk = jax.random.split(key, 3)
    u1 = jax.random.uniform(kk[0], (W,))
    u2 = jax.random.uniform(kk[1], (W,))
    step_keys = jax.random.split(kk[2], L - 1)
    rounds = jax.vmap(lambda k: jax.vmap(
        lambda r: jax.random.uniform(jax.random.fold_in(k, r), (3, R, W)))(
            jnp.arange(64 // R)))(step_keys)
    return tuple(torch.as_tensor(np.array(x)) for x in (u1, u2, rounds))


def _graph_edges(kind):
    if kind == "unweighted":
        return _power_law_edges(300, 2500, 2), True
    if kind == "weighted":
        return _power_law_edges(300, 2500, 3, weighted=True), True
    if kind == "dead_ends":
        # directed edges and sinks: walks reach vertices with no out-edge
        edges = _power_law_edges(120, 900, 4)
        edges += [(str(i), "sink%d" % i) for i in range(0, 120, 3)]
        return edges, False
    # a ring: every step from v has one return and one "else" neighbor,
    # so at p = q = 1e9 no lane accepts and every lane hits the cap
    return [(str(i), str((i + 1) % 30)) for i in range(30)], True


def _samplers(edges, undirected, p, q, membership, monkeypatch, L=10):
    monkeypatch.setenv("GRAPHVITE_N2V_CUCKOO",
                       "1" if membership == "cuckoo" else "0")
    out = []
    for mod, G in ((ref, RefGraph), (port, Graph)):
        g = G().load_edge_list(edges, as_undirected=undirected)
        out.append(mod.DeviceWalkSampler.build(
            g, 2, L, 9 * 44, biased=True, p=p, q=q, banded=True,
            bidir=True))
    return out


@pytest.mark.parametrize("membership", ["cuckoo", "search"])
@pytest.mark.parametrize("kind,pq", [
    ("unweighted", (4.0, 2.0)), ("unweighted", (0.25, 0.25)),
    ("unweighted", (1.0, 1.0)), ("weighted", (4.0, 2.0)),
    ("weighted", (0.25, 0.25)), ("weighted", (1.0, 1.0)),
    ("dead_ends", (4.0, 2.0)), ("dead_ends", (0.25, 0.25)),
    ("ring_cap", (1e9, 1e9)),
])
def test_biased_chain_matches_reference(membership, kind, pq, monkeypatch):
    if membership == "cuckoo" and port_native.load() is None:
        pytest.skip("no g++ for the native table build")
    edges, undirected = _graph_edges(kind)
    p, q = pq
    L = 10
    s_ref, s_port = _samplers(edges, undirected, p, q, membership,
                              monkeypatch, L)
    assert s_ref.membership == s_port.membership == membership
    assert s_ref.uniform == s_port.uniform == (kind != "weighted")
    assert s_ref.bs_iters == s_port.bs_iters
    W = s_ref.num_walk
    ref_fn = jax.jit(ref.make_walk_chain_fn(
        s_ref.uniform, L, W, biased=True, p=p, q=q, bs_iters=s_ref.bs_iters,
        membership=membership))
    port_fn = s_port.make_chain_fn()
    R, C = port_fn.proposals, port_fn.rounds_cap
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        chain_r, valid_r = ref_fn(key, *s_ref.arrays())
        draws = _reference_biased_draws(key, W, L, R)
        chain_p, valid_p, rounds = port_fn(*s_port.arrays(), draws=draws,
                                           with_rounds=True)
        np.testing.assert_array_equal(chain_p.numpy(), np.asarray(chain_r))
        np.testing.assert_array_equal(valid_p.numpy(), np.asarray(valid_r))
        assert int(rounds.max()) <= C
    if kind == "dead_ends":
        assert not valid_p.all()
    if kind == "ring_cap":
        # from (prev, v) no proposal accepts: after C rounds each lane
        # stays at v, alive; its next step (prev = v, so every proposal
        # is a common neighbor) accepts at once
        capped = rounds == C
        assert bool(capped[::2].all()) and bool((rounds[1::2] == 1).all())
        assert bool((chain_p[2:][capped] == chain_p[1:-1][capped]).all())
        assert bool(valid_p.all())


@pytest.mark.parametrize("p,q,membership,env", [
    (4.0, 2.0, "cuckoo", ""), (4.0, 2.0, "search", ""),
    (0.25, 0.25, "cuckoo", ""), (1.0, 1.0, "search", ""),
    (1.0, 3.0, "search", ""), (1.0, 5.0, "search", ""),
    (2.0, 100.0, "search", ""), (4.0, 2.0, "cuckoo", "3"),
    (1.0, 1.0, "search", "0"),
])
def test_proposal_rule_matches_reference(p, q, membership, env,
                                         monkeypatch):
    """R as the reference's chain draws it: the (3, R, W) shape of its
    proposal draws, read by a spy on jax.random.uniform."""
    if env:
        monkeypatch.setenv("GRAPHVITE_N2V_PROPOSALS", env)
    monkeypatch.setenv("GRAPHVITE_N2V_CUCKOO", "0")
    shapes = []
    uniform = jax.random.uniform

    def spy(key, shape=(), *a, **kw):
        shapes.append(tuple(shape))
        return uniform(key, shape, *a, **kw)

    s = ref.DeviceWalkSampler.build(
        RefGraph().load_edge_list([(str(i), str((i + 1) % 12))
                                   for i in range(12)]),
        1, 3, 24, biased=True, p=p, q=q)
    fn = ref.make_walk_chain_fn(s.uniform, 3, 5, biased=True, p=p, q=q,
                                membership=membership)
    memb = s.sorted_indices
    if membership == "cuckoo":
        memb = jnp.full((16, 4), -1, jnp.int32)
    arrays = s.arrays()[:-1] + (memb,)
    monkeypatch.setattr(jax.random, "uniform", spy)
    fn(jax.random.PRNGKey(0), *arrays)
    (R,) = {sh[1] for sh in shapes if len(sh) == 3 and sh[0] == 3}
    assert port.n2v_proposals(p, q, membership) == R
    chain_fn = port.make_walk_chain_fn(True, 3, 5, biased=True, p=p, q=q,
                                       membership=membership)
    assert (chain_fn.proposals, chain_fn.rounds_cap) == (R, 64 // R)


# ---------------------------------------------------------------------------
# the reference's statistical checks (tests/test_device_sampler.py:81-146)
# ---------------------------------------------------------------------------

def _ring(n=20, extra=()):
    edges = [(str(i), str((i + 1) % n)) for i in range(n)]
    edges += [(str(a), str(b)) for a, b in extra]
    return Graph().load_edge_list(edges)


def _pairs(sampler, rounds=5, seed=0):
    """(heads, tails) of the valid pairs of `rounds` pair-layout batches."""
    fn = sampler.make_sample_fn(sampler.batch_size)
    gen = torch.Generator().manual_seed(seed)
    hs, ts = [], []
    for _ in range(rounds):
        h, t, m = fn(*sampler.arrays(), generator=gen)
        hs.append(h[m > 0].numpy())
        ts.append(t[m > 0].numpy())
    return np.concatenate(hs), np.concatenate(ts)


def test_node2vec_uniform_pq_matches_first_order():
    """p = q = 1 reduces to the unbiased walk distribution."""
    g = _ring(10, extra=[(0, 5)])
    a = port.DeviceWalkSampler.build(g, 2, 6, 1024)
    b = port.DeviceWalkSampler.build(g, 2, 6, 1024, biased=True, p=1.0,
                                     q=1.0)
    ha, ta = _pairs(a, 10, seed=0)
    hb, tb = _pairs(b, 10, seed=100)
    n = g.num_vertex
    pa = np.bincount(ha * n + ta, minlength=n * n)
    pb = np.bincount(hb * n + tb, minlength=n * n)
    assert np.abs(pa / pa.sum() - pb / pb.sum()).max() < 0.015


def test_node2vec_large_p_suppresses_returns():
    """p -> inf: never step back to the previous vertex when another
    neighbor exists; on a ring a 2-hop pair then never returns to its
    start."""
    g = _ring(10)
    s = port.DeviceWalkSampler.build(g, 2, 6, 2048, biased=True, p=1e9,
                                     q=1.0)
    h, t = _pairs(s, 5, seed=7)
    ids = np.array([int(x) for x in g.id2name])
    d = (ids[t] - ids[h]) % 10
    k2 = int(np.isin(d, [2, 8]).sum())
    k0 = int((d == 0).sum())
    assert k2 > 0 and k0 < 0.02 * (k0 + k2)


def test_node2vec_large_q_stays_local():
    """q -> inf suppresses steps to vertices that are not common
    neighbors: walks on two triangles joined by a bridge rarely cross."""
    edges = [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3), (0, 3)]
    g = Graph().load_edge_list([(str(a), str(b)) for a, b in edges])
    s = port.DeviceWalkSampler.build(g, 3, 8, 2048, biased=True, p=1.0,
                                     q=1e6)
    h, t = _pairs(s, 5, seed=3)
    left = np.array([int(g.id2name[i]) < 3 for i in range(g.num_vertex)])
    assert np.mean(left[h] != left[t]) < 0.25


# ---------------------------------------------------------------------------
# node2vec through the solver and the application
# ---------------------------------------------------------------------------

def test_node2vec_learns_two_blocks_like_the_reference():
    """Statistical: the random streams differ, so the AUCs differ a little;
    both must clear 0.9 and stay within 0.03 of each other."""
    g = two_blocks()
    kw = dict(model="node2vec", num_epoch=2000, augmentation_step=2,
              random_walk_length=8, p=4.0, q=2.0, negative_weight=1.0,
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
    sampler = solver._active_sampler
    assert sampler.biased and (sampler.p, sampler.q) == (4.0, 2.0)


def test_graph_application_runs_the_node2vec_config(tmp_path):
    """config/graph/node2vec_youtube.yaml's `train:` section (node2vec, p
    4, q 2, aug 5, walk 40) through GraphApplication, with its build
    section, on a small graph and cut to a few batches: the same route,
    layout and batch plan as the reference's GraphApplication, and a
    biased sampler with the config's p and q."""
    from graphvite_tpu.application import GraphApplication as RefApp

    with open(os.path.join(REPO, "config", "graph",
                           "node2vec_youtube.yaml")) as f:
        cfg = yaml.safe_load(f)
    train = dict(cfg["train"], num_epoch=3, log_frequency=10**9)
    # the CLI reads `auto` as the solver's auto (0)
    build = dict(cfg["build"], num_partition=0, batch_size=8200,
                 episode_size=2)
    edge_file = tmp_path / "edges.txt"
    edge_file.write_text("".join(
        "%s\t%s\n" % e for e in _power_law_edges(2000, 12000, 5)))
    apps = []
    for app in (RefApp(dim=16), GraphApplication(dim=16, device="cpu")):
        app.load(file_name=str(edge_file), as_undirected=True)
        app.build(**build)
        app.train(**train)
        apps.append(app)
    ref_app, port_app = apps
    s_ref, s_port = ref_app.solver, port_app.solver
    assert s_port.model == "node2vec"
    assert s_port._batch_plan() == s_ref._batch_plan()
    assert s_port.effective_batch == s_ref.effective_batch
    assert s_port._banded_fused == s_ref._banded_fused
    a, b = s_ref._active_sampler, s_port._active_sampler
    for name in ("biased", "p", "q", "banded", "position_major", "bidir",
                 "num_walk", "membership", "bs_iters"):
        assert getattr(b, name) == getattr(a, name), name
    assert (b.p, b.q) == (4.0, 2.0)
    losses = s_port.batch_losses
    assert losses.shape[0] >= s_port.num_batch   # whole episodes
    assert torch.isfinite(losses).all()
    assert np.isfinite(s_port.vertex_embeddings).all()
