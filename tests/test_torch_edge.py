"""The port's edge route (augmentation_step 1) against the JAX package's:
the edge sampler in its four modes fed the reference's own draws, one
shared-pool step with its sweep switches on (the reference's Pallas sweeps
in interpret mode) and off, the sorted entry of the scatter-add, and
GraphSolver / GraphApplication end to end on the CPU.

Tolerances: sampler ids bit-identical. The pool step as the port's walk
steps are held (tests/test_torch_steps.py): loss rtol 2e-5; float32 tables
and moments rtol 3e-4, atol 3e-6. bfloat16 tables (both packages round
float32 results to bf16, in different places): the port's bf16 step lies
within 2 bf16 ulps of its float32 step from the same table (each of at
most two roundings moves a value by at most 1 ulp of the largest
magnitude involved), and within n + 2 ulps of the reference's bf16 step
for a row touched n times (the reference also rounds each context delta
to bf16 before summing). Learning: AUC > 0.9 and within 0.03 of the
reference's (different random streams)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.device_sampler as ref_sampler
import graphvite_tpu.ops.steps as ref_steps
import graphvite_tpu.optim as ref_optim
import graphvite_tpu.solver as ref_solver
import graphvite_tpu_torch.ops.device_sampler as port_sampler
import graphvite_tpu_torch.ops.steps as port_steps
import graphvite_tpu_torch.optim as port_optim
from graphvite_tpu.graph import Graph as RefGraph
from graphvite_tpu.ops.alias import AliasTable, device_alias_arrays
from graphvite_tpu.ops.pallas_scatter import sweep_scatter_add
from graphvite_tpu_torch import GraphApplication, state_from_numpy
from graphvite_tpu_torch.graph import Graph
from graphvite_tpu_torch.ops import gather, scatter
from graphvite_tpu_torch.solver import GraphSolver
from test_solver import two_blocks
from test_torch_solver import _link_auc, _port_graph

LOSS_TOL = dict(rtol=2e-5)
TABLE_TOL = dict(rtol=3e-4, atol=3e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores: with torch's default of one thread
    per core, each of the many tiny ops these tests run waits on the other
    workers' threads (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_edges(v, e, seed, weighted=False):
    rng = np.random.default_rng(seed)
    u, w = rng.integers(0, v, e), rng.integers(0, v, e)
    if weighted:
        return [(str(a), str(b), float(x)) for a, b, x
                in zip(u, w, rng.random(e) * 3 + 0.1)]
    return [(str(a), str(b)) for a, b in zip(u, w)]


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# the edge sampler
# ---------------------------------------------------------------------------

def _reference_draws(mode, key, batch, n_blocks, n_edge):
    """The random numbers the reference's sample function draws from `key`
    (graphvite_tpu/ops/device_sampler.py:149-177)."""
    if mode in ("stream", "sorted"):
        C = port_sampler.DeviceEdgeSampler.STREAM_CHUNK
        nb = -(-batch // C)
        bid = jax.random.randint(key, (nb,), 0, n_blocks)
        shift = jax.random.randint(jax.random.fold_in(key, 1), (), 0, nb * C)
        return _t(bid), (_t(shift) if mode == "sorted" and batch % C
                         else None)
    if mode == "uniform":
        return _t(jax.random.randint(key, (batch,), 0, n_edge))
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.uniform(k1, (batch,))),
            _t(jax.random.uniform(k2, (batch,))))


@pytest.mark.parametrize("mode,batch", [
    ("stream", 2048), ("stream", 1500), ("sorted", 2048), ("sorted", 1500),
    ("uniform", 300), ("alias", 300)])
def test_edge_sampler_matches_reference(mode, batch, monkeypatch):
    if mode in ("stream", "sorted"):
        # stream a small graph: 8 blocks of 1024 edges
        for cls in (ref_sampler.DeviceEdgeSampler,
                    port_sampler.DeviceEdgeSampler):
            monkeypatch.setattr(cls, "MIN_STREAM_BLOCKS", 1)
    edges = _random_edges(500, 4000, 1, weighted=(mode == "alias"))
    sort = mode == "sorted"
    ref = ref_sampler.DeviceEdgeSampler.build(
        RefGraph().load_edge_list(edges), sort_stream=sort)
    port = port_sampler.DeviceEdgeSampler.build(
        Graph().load_edge_list(edges), sort_stream=sort)
    assert (port.streamed, port.sorted_stream, port.uniform) == (
        ref.streamed, ref.sorted_stream, ref.uniform)
    assert port.streamed == (mode in ("stream", "sorted"))
    assert port.uniform == (mode != "alias")
    np.testing.assert_array_equal(port.edges.numpy(), np.asarray(ref.edges))
    for a, b in zip(port.alias_arrays, ref.alias_arrays):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref_fn = ref.make_sample_fn(batch)
    port_fn = port.make_sample_fn(batch)
    repeats = 0
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        h_r, t_r, m_r = ref_fn(key, *ref.arrays())
        draws = _reference_draws(mode, key, batch, port.edges.shape[0],
                                 port.num_edge)
        h_p, t_p, m_p = port_fn(*port.arrays(), draws=draws)
        np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_r))
        if sort and draws[0].unique().numel() < draws[0].numel():
            # a repeated block: the port interleaves its copies (the same
            # edges, ascending heads) where the reference concatenates
            # them; a rolled batch then keeps other rows of the same blocks
            repeats += 1
            got = np.stack([h_p.numpy(), t_p.numpy()], axis=1)
            want = np.stack([np.asarray(h_r), np.asarray(t_r)], axis=1)
            if batch % 1024 == 0:
                np.testing.assert_array_equal(got[np.lexsort(got.T)],
                                              want[np.lexsort(want.T)])
                assert bool((h_p[1:] >= h_p[:-1]).all())
            else:
                drawn = port.edges[draws[0]].reshape(-1, 2).numpy()
                assert {tuple(r) for r in got} <= {tuple(r) for r in drawn}
            continue
        np.testing.assert_array_equal(h_p.numpy(), np.asarray(h_r))
        np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_r))
        if sort and batch % 1024 == 0:
            assert bool((h_p[1:] >= h_p[:-1]).all())
    if sort:
        assert repeats < 6
    # the port's own draws: the same shapes, in range, sorted where sorted
    h, t, m = port_fn(*port.arrays(), generator=torch.Generator().manual_seed(0))
    assert h.shape == t.shape == m.shape == (batch,)
    assert h.dtype == t.dtype == torch.int32 and h.is_contiguous()
    if sort and batch % 1024 == 0:
        assert bool((h[1:] >= h[:-1]).all())


# ---------------------------------------------------------------------------
# one shared-pool step
# ---------------------------------------------------------------------------

V, D, B, G, M, K, NW = 1024, 32, 512, 4, 16, 1, 5.0


def _step_inputs(seed, rule):
    rng = np.random.default_rng(seed)
    heads = np.sort((rng.random(B) ** 2 * V).astype(np.int32))
    tails = (rng.random(B) ** 2 * V).astype(np.int32)
    tails[:4] = V - 1                  # live tails on the parking row
    mask = (rng.random(B) > 0.1).astype(np.float32)
    n_mom = port_optim.OPTIMIZER_MOMENTS[rule]
    state = {"tables": tuple(_bf16_values(rng.normal(0, 0.1, (V, D)))
                             for _ in range(2)),
             "moments": tuple(tuple(np.abs(rng.normal(0, 1e-3, (V, D)))
                                    .astype(np.float32)
                                    for _ in range(n_mom))
                              for _ in range(2))}
    w = rng.random(V) + 0.1
    return heads, tails, mask, state, device_alias_arrays(AliasTable(w))


def _bf16_values(x):
    """float32 values that bfloat16 holds exactly (so both packages start
    bf16 runs from the same numbers)."""
    return torch.as_tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _opts(rule):
    kw = dict(type=rule, lr=0.025 if rule == "SGD" else 1e-3,
              weight_decay=5e-3)
    return ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw), kw["lr"]


def _run_pair(rule, sweep, dtype, seed=7):
    """One step of each package from the same state and batch; returns
    ((port tables, port moments, port loss), (the same for the
    reference)), all as float32 numpy."""
    r_opt, p_opt, lr = _opts(rule)
    heads, tails, mask, state, neg = _step_inputs(seed, rule)
    key = jax.random.PRNGKey(seed)
    r_step = ref_steps.make_graph_pool_step(
        r_opt, K, NW, pool_size=M, pool_groups=G, trust=0.25,
        sweep_vertex=sweep, sweep_context=sweep, sweep_gather=sweep,
        sweep_tile=512, sweep_chunk=256, sweep_gather_tile=256)
    r_state = {"tables": tuple(jnp.asarray(t).astype(dtype)
                               for t in state["tables"]),
               "moments": tuple(tuple(jnp.asarray(m) for m in g)
                                for g in state["moments"])}
    r_new, r_loss = r_step(r_state, jnp.asarray(heads), jnp.asarray(tails),
                           key, jnp.float32(lr),
                           *(jnp.asarray(a) for a in neg),
                           mask=jnp.asarray(mask))
    p_step = port_steps.make_graph_pool_step(
        p_opt, K, NW, pool_size=M, pool_groups=G, trust=0.25,
        sweep_vertex=sweep, sweep_context=sweep, sweep_gather=sweep)
    assert p_step.pool_shape == (G, M)
    k1, k2 = jax.random.split(key)
    draws = tuple(_t(jax.random.uniform(k, (G, M))) for k in (k1, k2))
    p_state = state_from_numpy(state, "cpu",
                               "bfloat16" if dtype == jnp.bfloat16
                               else "float32")
    p_new, p_loss = p_step(p_state, _t(heads), _t(tails), lr,
                           *(_t(a) for a in neg), mask=_t(mask), draws=draws)

    def unpack(st, loss):
        return ([np.asarray(t, np.float32) if not torch.is_tensor(t)
                 else t.float().numpy() for t in st["tables"]],
                [np.asarray(m) if not torch.is_tensor(m) else m.numpy()
                 for g in st["moments"] for m in g], float(loss))

    return unpack(p_new, p_loss), unpack(r_new, r_loss)


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("sweep", [True, False])
def test_pool_step_matches_reference(rule, sweep):
    (p_tab, p_mom, p_loss), (r_tab, r_mom, r_loss) = _run_pair(
        rule, sweep, jnp.float32)
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    assert len(p_mom) == len(r_mom) == (4 if rule == "Adam" else 0)
    for a, b in zip(p_tab + p_mom, r_tab + r_mom):
        np.testing.assert_allclose(a, b, **TABLE_TOL)


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_pool_step_dedup_route_matches_reference(rule, monkeypatch):
    """Switches off on a table above the dense-update size: SGD without
    the per-row clip, moment rules through dedup_rows."""
    monkeypatch.setattr(ref_optim, "DENSE_UPDATE_ELEMS", 1000)
    monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", 1000)
    (p_tab, p_mom, p_loss), (r_tab, r_mom, r_loss) = _run_pair(
        rule, False, jnp.float32, seed=8)
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    for a, b in zip(p_tab + p_mom, r_tab + r_mom):
        np.testing.assert_allclose(a, b, **TABLE_TOL)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("sweep", [True, False])
def test_pool_step_bf16(rule, sweep):
    (p16, _, p16_loss), (r16, _, r16_loss) = _run_pair(rule, sweep,
                                                       jnp.bfloat16)
    (p32, _, _), _ = _run_pair(rule, sweep, jnp.float32)
    # the losses are computed in float32 from the same bf16 values
    np.testing.assert_allclose(p16_loss, r16_loss, **LOSS_TOL)
    heads, tails, _, state, neg = _step_inputs(7, rule)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    pool = np.asarray(ref_steps.device_sample(
        *(jnp.asarray(a) for a in neg), jax.random.uniform(k1, (G, M)),
        jax.random.uniform(k2, (G, M))))
    touches = [np.bincount(heads, minlength=V)[:, None],
               np.bincount(np.concatenate([tails, pool.reshape(-1)]),
                           minlength=V)[:, None]]
    for a, b32, b16, t0, n in zip(p16, p32, r16, state["tables"], touches):
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b32)), np.abs(t0))
        assert np.all(np.abs(a - b32) <= 2 * _bf16_ulp(mag))
        mag = np.maximum(mag, np.abs(b16))
        assert np.all(np.abs(a - b16) <= (n + 2) * _bf16_ulp(mag))
    if sweep and rule == "SGD":
        # one float32 sum per row, rounded once: exactly the float32 step
        for a, b32 in zip(p16, p32):
            np.testing.assert_array_equal(a, _bf16_values(b32))


# ---------------------------------------------------------------------------
# the sorted entry of the scatter-add
# ---------------------------------------------------------------------------

def test_scatter_add_sorted_entry_contract():
    """Ascending ids: the result of sweep_scatter_add (float32 sums in
    other orders, rtol 1e-6 of the summed magnitude); ids outside [0, V)
    drop; ids that are not ascending are refused (on the card they would
    lose updates)."""
    rng = np.random.default_rng(4)
    v, w, n = 1024, 16, 2048
    ids = np.sort((rng.random(n) ** 3 * v).astype(np.int32))
    upd = rng.normal(size=(n, w)).astype(np.float32)
    table = rng.normal(size=(v, w)).astype(np.float32)
    want = np.asarray(sweep_scatter_add(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd),
        tile_rows=256, chunk=128, interpret=True))
    t = _t(table)
    assert scatter.scatter_add_sorted_(t, _t(ids), _t(upd)) is t
    mag = np.abs(table).astype(np.float64)
    np.add.at(mag, ids, np.abs(upd))
    assert np.all(np.abs(t.numpy() - want) <= 1e-6 * mag)

    dropped = np.concatenate([[-3, -1], ids[:100], [v, v + 5]]).astype(
        np.int64)
    t = _t(table)
    scatter.scatter_add_sorted_(t, _t(dropped), _t(upd[:104]))
    want = table.astype(np.float64)
    np.add.at(want, ids[:100], upd[2:102])
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-6)

    with pytest.raises(ValueError, match="ascending"):
        scatter.scatter_add_sorted_(_t(table), _t(ids[::-1].copy()),
                                    _t(upd))
    before = (scatter.scatter_add_sorted_.launches,
              scatter.scatter_add_.launches)
    scatter.scatter_add_sorted_(_t(table), _t(ids), _t(upd))
    assert before == (scatter.scatter_add_sorted_.launches,
                      scatter.scatter_add_.launches)


# ---------------------------------------------------------------------------
# the solver and the application
# ---------------------------------------------------------------------------

def test_line_learns_two_blocks_like_the_reference():
    """The protocol of tests/test_solver.py::test_line_learns_edges."""
    g = two_blocks()
    aucs = []
    for solver, graph in ((ref_solver.GraphSolver(dim=16), g),
                          (GraphSolver(dim=16, device="cpu"),
                           _port_graph(g))):
        solver.build(graph, num_negative=2, batch_size=512, episode_size=8)
        solver.train(model="LINE", num_epoch=1000, augmentation_step=1,
                     negative_weight=1.0, log_frequency=10**9)
        aucs.append(_link_auc(solver, graph))
    ref_auc, port_auc = aucs
    assert port_auc > 0.9, aucs
    assert abs(port_auc - ref_auc) < 0.03, aucs


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_forced_sweep_gate(rule, monkeypatch):
    """GRAPHVITE_SWEEP_SCATTER=1 takes the sorted stream and the sweep
    routes on the CPU (thresholds shrunk to test scale, read at call
    time), as tests/test_pallas_scatter.py:286-319 drives the reference:
    the flags are set, batches are whole 1024-edge chunks with ascending
    heads, and a moment optimizer's moments move on both sides."""
    monkeypatch.setenv("GRAPHVITE_SWEEP_SCATTER", "1")
    monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", 1000)
    monkeypatch.setattr(port_sampler.DeviceEdgeSampler, "MIN_STREAM_BLOCKS",
                        1)
    g = Graph().load_edge_list(_random_edges(512, 4096, 3))
    solver = GraphSolver(dim=16, device="cpu")
    opt = {"type": rule, "lr": 0.025 if rule == "SGD" else 1e-3}
    solver.build(g, optimizer=opt, num_negative=1, batch_size=2500,
                 episode_size=2)
    solver.train(model="LINE", num_epoch=4, augmentation_step=1,
                 log_frequency=10**9)
    assert (solver._sweep_scatter, solver._sweep_context,
            solver._sweep_gather) == (True, True, True)
    assert solver.effective_batch == 2048
    heads, _, _ = solver._active_sample_fn(
        *solver._active_sampler.arrays(),
        generator=torch.Generator().manual_seed(0))
    assert heads.shape == (2048,) and bool((heads[1:] >= heads[:-1]).all())
    assert np.isfinite(solver.vertex_embeddings).all()
    assert np.isfinite(solver.context_embeddings).all()
    for group in solver.state["moments"]:
        assert len(group) == (2 if rule == "Adam" else 0)
        for m in group:
            assert bool((m != 0).any())
    # "0" turns the sweeps off
    monkeypatch.setenv("GRAPHVITE_SWEEP_SCATTER", "0")
    solver.train(model="LINE", num_epoch=1, augmentation_step=1,
                 log_frequency=10**9)
    assert (solver._sweep_scatter, solver._sweep_context,
            solver._sweep_gather) == (False, False, False)


def test_edge_route_default_gate_on_cpu():
    """Without the override the sweeps stay off on the CPU: the plain
    routes, no kernel counted. A solver that trained walks first plans
    its edge batches as a fresh one does."""
    g = _port_graph(two_blocks(40))
    s = GraphSolver(dim=8, device="cpu")
    s.build(g, num_negative=1, batch_size=1000, episode_size=2)
    s.train(model="DeepWalk", num_epoch=5, augmentation_step=2,
            random_walk_length=6, log_frequency=10**9)
    walk_batch = s.effective_batch
    counts = (gather.gather_sorted.launches, scatter.scatter_add_.launches)
    s.train(model="LINE", num_epoch=20, augmentation_step=1,
            log_frequency=10**9)
    assert not (s._sweep_scatter or s._sweep_context or s._sweep_gather)
    assert counts == (gather.gather_sorted.launches,
                      scatter.scatter_add_.launches)
    assert s.effective_batch == 768 != walk_batch
    assert s.batch_losses.shape[0] >= s.num_batch
    assert bool(torch.isfinite(s.batch_losses).all())


@pytest.mark.parametrize("build_kw,init_kw", [
    (dict(num_partition=2), {}),
    ({}, dict(gpu_memory_limit=1000)),     # the auto overflow rule
])
def test_blocked_episodes_raise(build_kw, init_kw):
    """The two cases that raised before blocked episodes were ported now
    train them (tests/test_torch_blocked.py holds them to the reference):
    an explicit num_partition, and the auto rule's overflow, which also
    engages the host master."""
    g = _port_graph(two_blocks(40))
    s = GraphSolver(dim=8, device="cpu", **init_kw)
    s.build(g, batch_size=512, **build_kw)
    s.train(model="LINE", num_epoch=1, augmentation_step=1)
    stats = s.blocked_stats
    # the auto rule's P (at least 4) is held to the reference's in
    # tests/test_torch_blocked.py
    assert (stats["num_partition"] == 2 if build_kw
            else stats["num_partition"] >= 4)
    assert stats["host_master"] == (not build_kw)
    assert stats["episodes"] >= 1 and s.batch_id >= s.num_batch
    assert np.isfinite(s.vertex_embeddings).all()
    assert bool(torch.isfinite(s.batch_losses).all())


@pytest.mark.parametrize("v,batch,sweep", [
    (1_715_256, 100000, True),     # line_flickr.yaml: 97 chunks of 1024
    (1_715_256, 100000, False),
    (512, 2500, True),
    (5000, 900, True),             # below one chunk: the 256 unit
])
def test_batch_plan_matches_reference(v, batch, sweep):
    import types

    plans = []
    for solver in (ref_solver.GraphSolver(dim=128),
                   GraphSolver(dim=128, device="cpu")):
        solver.graph = types.SimpleNamespace(num_vertex=v)
        solver.batch_size, solver.num_negative = batch, 1
        solver._pooled_step, solver._walk_slot_unit = True, 0
        solver._sweep_scatter = sweep
        plans.append(solver._batch_plan())
    assert plans[0] == plans[1]
    if v == 1_715_256 and sweep:
        assert plans[1] == (99328, 99328, 1)
        assert port_steps.graph_pool_groups(99328) == 64


def test_graph_application_edge_route():
    """GraphApplication passes augmentation_step 1 through to the solver."""
    g = two_blocks()
    half = g.num_vertex // 2
    n = g.num_edge
    edges = [(g.id2name[u], g.id2name[v])
             for u, v in zip(g.edge_heads[:n], g.edge_tails[:n])]
    app = GraphApplication(dim=16, device="cpu")
    app.load(edge_list=edges)
    app.build(num_negative=2, batch_size=512, episode_size=8)
    app.train(model="LINE", num_epoch=1000, augmentation_step=1,
              negative_weight=1.0, log_frequency=10**9)
    assert app.solver.augmentation_step == 1
    rng = np.random.default_rng(1)
    k = 300
    sel = rng.choice(g.num_directed_edge, size=k, replace=False)
    H = [g.id2name[i] for i in g.edge_heads[sel]]
    T = [g.id2name[i] for i in g.edge_tails[sel]]
    # negatives: random cross-block pairs, by name ("0".."29" | "30"..)
    H += [str(x) for x in rng.integers(half, size=k)]
    T += [str(x) for x in rng.integers(half, size=k) + half]
    auc = app.evaluate("link prediction", H=H, T=T,
                       Y=[1] * k + [0] * k)["AUC"]
    assert auc > 0.9
