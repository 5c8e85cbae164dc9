"""The walk layouts and the classic step of the port (ops/device_sampler.py,
ops/steps.py, solver.py) against the JAX package: the position-major and
pair emitters and samplers exactly, the multitail, pair and classic steps
on the same batch, state and draws, the multitail batch plan, the step
switches of GraphSolver.train, the host-class API the reference has, and
the classic step end to end.

Tolerances (those of tests/test_torch_steps.py and tests/test_torch_edge.py):
loss rtol 2e-5; float32 tables and moments rtol 3e-4, atol 3e-6. bfloat16
tables: the port's bf16 step lies within 2 bf16 ulps of its float32 step
from the same table, and within n + 2 ulps of the reference's bf16 step
for a row touched n times (the reference rounds each delta to bf16
before its scatter sums them; the port sums in float32 and rounds once).
Learning: two-block AUC > 0.9 and within 0.03 of the reference's."""
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
import graphvite_tpu_torch.solver as port_solver
from graphvite_tpu.graph import Graph as RefGraph
from graphvite_tpu.models import GRAPH_MODELS as REF_MODELS
from graphvite_tpu.ops.alias import (AliasTable, device_alias_arrays,
                                     device_sample)
from graphvite_tpu_torch import state_from_numpy
from graphvite_tpu_torch.graph import Graph
from graphvite_tpu_torch.models import GRAPH_MODELS as PORT_MODELS
from graphvite_tpu_torch.solver import GraphSolver
from test_solver import two_blocks
from test_torch_sampler import _reference_draws
from test_torch_solver import _link_auc, _port_graph

LOSS_TOL = dict(rtol=2e-5)
TABLE_TOL = dict(rtol=3e-4, atol=3e-6)
V, D, K, M, G, NW, AUG, L, W = 200, 16, 2, 8, 4, 5.0, 2, 9, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores: with torch's default of one thread
    per core, each of the many tiny ops these tests run waits on the other
    workers' threads (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _chain(seed):
    rng = np.random.default_rng(seed)
    chain = rng.integers(0, V, (L + 1, W)).astype(np.int32)
    alive = rng.random((L + 1, W)) > 0.15   # some walks die early
    alive[:2] = True
    return chain, np.cumprod(alive, axis=0) > 0


# ---------------------------------------------------------------------------
# emitters and samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aug", [1, 3])
@pytest.mark.parametrize("bidir", [False, True])
def test_emit_walk_positions_matches_reference(aug, bidir):
    chain, valid = _chain(aug)
    want = ref_sampler.emit_walk_positions(jnp.asarray(chain),
                                           jnp.asarray(valid), aug,
                                           bidir=bidir)
    got = port_sampler.emit_walk_positions(_t(chain).long(), _t(valid), aug,
                                           bidir=bidir)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].dtype == torch.bool


@pytest.mark.parametrize("aug", [1, 3])
def test_emit_walk_pairs_matches_reference(aug):
    chain, valid = _chain(aug + 10)
    want = ref_sampler.emit_walk_pairs(jnp.asarray(chain),
                                       jnp.asarray(valid), aug)
    got = port_sampler.emit_walk_pairs(_t(chain).long(), _t(valid), aug)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _edges(seed=0):
    rng = np.random.default_rng(seed)
    e = (rng.random((900, 2)) ** 2 * 150).astype(np.int64)
    e = e[e[:, 0] != e[:, 1]]
    edges = [tuple(map(str, x)) for x in e]
    # sinks: directed edges into vertices with no out-edges
    return edges + [(str(i), "sink%d" % i) for i in range(0, 150, 7)]


@pytest.mark.parametrize("layout,batch,bidir", [
    ("multitail", 4 * 70, True), ("multitail", 2 * 33, False),
    ("pair", 500, False), ("pair", 17 * 6, False),
])
def test_layout_samplers_match_reference(layout, batch, bidir):
    """The position-major and pair samplers, their chains fed the
    reference's draws, give the reference's batch exactly (truncated to
    the batch, masks as float32)."""
    edges = _edges()
    kw = dict(position_major=layout == "multitail", bidir=bidir)
    s_ref = ref_sampler.DeviceWalkSampler.build(
        RefGraph().load_edge_list(edges, as_undirected=False), AUG, L,
        batch, **kw)
    s_port = port_sampler.DeviceWalkSampler.build(
        Graph().load_edge_list(edges, as_undirected=False), AUG, L, batch,
        **kw)
    for name in ("num_walk", "num_tail", "position_major", "banded"):
        assert getattr(s_port, name) == getattr(s_ref, name), name
    ref_fn = s_ref.make_sample_fn(batch)
    port_fn = s_port.make_sample_fn(batch)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = ref_fn(key, *s_ref.arrays())
        got = port_fn(*s_port.arrays(),
                      draws=_reference_draws(key, s_ref.num_walk, L))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got[2].dtype == torch.float32
    assert (got[2] == 0).any()      # dead walks and walk ends


# ---------------------------------------------------------------------------
# the multitail, pair and classic steps
# ---------------------------------------------------------------------------

def _opts(rule):
    kw = dict(type=rule, lr=0.05 if rule == "SGD" else 1e-3,
              weight_decay=1e-3)
    return ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw), kw["lr"]


def _neg_state():
    w = np.random.default_rng(9).random(V) + 0.1
    return device_alias_arrays(AliasTable(w))


def _batch(kind, seed):
    """A walk batch in the step's layout (emitted by the reference) and
    the step factories of both packages."""
    chain, valid = _chain(seed)
    if kind == "multitail":
        h, t, m = ref_sampler.emit_walk_positions(
            jnp.asarray(chain), jnp.asarray(valid), AUG, bidir=True)
    else:
        h, t, m = ref_sampler.emit_walk_pairs(jnp.asarray(chain),
                                              jnp.asarray(valid), AUG)
    h, t = np.asarray(h), np.asarray(t)
    m = np.asarray(m).astype(np.float32)
    if kind == "classic":
        # the classic step takes any batch size: drop a few slots
        h, t, m = h[:-5], t[:-5], m[:-5]
    return h, t, m


def _step_pair(kind, r_opt, p_opt, trust):
    if kind == "multitail":
        T = 2 * AUG
        return (ref_steps.make_graph_pool_multitail_step(
                    r_opt, K, NW, T, pool_size=M, pool_groups=G, trust=trust),
                port_steps.make_graph_pool_multitail_step(
                    p_opt, K, NW, T, pool_size=M, pool_groups=G,
                    trust=trust))
    if kind == "pair":
        return (ref_steps.make_graph_pool_step(
                    r_opt, K, NW, pool_size=M, pool_groups=G, trust=trust),
                port_steps.make_graph_pool_step(
                    p_opt, K, NW, pool_size=M, pool_groups=G, trust=trust))
    return (ref_steps.make_graph_train_step(REF_MODELS["node2vec"], r_opt,
                                            K, NW, trust=trust),
            port_steps.make_graph_train_step(PORT_MODELS["node2vec"], p_opt,
                                             K, NW, trust=trust))


def _state_np(rule, seed):
    rng = np.random.default_rng(seed)
    n_mom = port_optim.OPTIMIZER_MOMENTS[rule]
    # bf16-exact values, so both packages' bf16 runs start from them
    tables = tuple(torch.as_tensor(rng.normal(0, 0.3, (V, D)).astype(
        np.float32)).bfloat16().float().numpy() for _ in range(2))
    moms = tuple(tuple(np.abs(rng.normal(0, 1e-2, (V, D))).astype(np.float32)
                       for _ in range(n_mom)) for _ in range(2))
    return {"tables": tables, "moments": moms}


def _run_pair(kind, rule, trust, dtype, seed=3):
    """One step of each package from the same state, batch and draws;
    returns ((port tables, moments, loss), (the reference's)) as float32
    numpy, and the rows each table's update touched."""
    r_opt, p_opt, lr = _opts(rule)
    h, t, m = _batch(kind, seed)
    state = _state_np(rule, seed)
    neg = _neg_state()
    key = jax.random.PRNGKey(seed)
    r_step, p_step = _step_pair(kind, r_opt, p_opt, trust)
    r_state = {"tables": tuple(jnp.asarray(x).astype(dtype)
                               for x in state["tables"]),
               "moments": tuple(tuple(jnp.asarray(x) for x in g)
                                for g in state["moments"])}
    r_new, r_loss = r_step(r_state, jnp.asarray(h), jnp.asarray(t), key,
                           jnp.float32(lr), *(jnp.asarray(a) for a in neg),
                           mask=jnp.asarray(m))
    k1, k2 = jax.random.split(key)
    shape = (p_step.draw_shape(h.shape[0]) if kind == "classic"
             else p_step.pool_shape)
    draws = tuple(_t(jax.random.uniform(k, shape)) for k in (k1, k2))
    p_state = state_from_numpy(state, "cpu",
                               "bfloat16" if dtype == jnp.bfloat16
                               else "float32")
    p_new, p_loss = p_step(p_state, _t(h).long(), _t(t).long(), lr,
                           *(_t(a) for a in neg), mask=_t(m), draws=draws)
    negs = np.asarray(device_sample(*(jnp.asarray(a) for a in neg),
                                    *(jnp.asarray(d.numpy())
                                      for d in draws)))
    touched = (np.bincount(h.reshape(-1), minlength=V),
               np.bincount(np.concatenate([t.reshape(-1), negs.reshape(-1)]),
                           minlength=V))

    def unpack(st, loss):
        return ([np.asarray(x.float() if torch.is_tensor(x)
                            else x.astype(jnp.float32)) for x in st["tables"]],
                [np.asarray(x) for g in st["moments"] for x in g],
                float(loss))

    return unpack(p_new, p_loss), unpack(r_new, r_loss), touched


KINDS = ["multitail", "pair", "classic"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("trust", [None, 0.25])
def test_step_matches_reference(kind, rule, trust):
    (p_tab, p_mom, p_loss), (r_tab, r_mom, r_loss), _ = _run_pair(
        kind, rule, trust, jnp.float32)
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    assert len(p_mom) == len(r_mom) == (4 if rule == "Adam" else 0)
    for a, b in zip(p_tab + p_mom, r_tab + r_mom):
        np.testing.assert_allclose(a, b, **TABLE_TOL)
    # the update moved the tables
    assert not np.array_equal(p_tab[1], _state_np(rule, 3)["tables"][1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_step_big_table_route_matches_reference(kind, rule, monkeypatch):
    """Tables above the dense-update size: SGD without the per-row clip
    (kernel 1 on the card), moment rules through the deduplicated route
    (kernel 2 on the card)."""
    monkeypatch.setattr(ref_optim, "DENSE_UPDATE_ELEMS", 1000)
    monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", 1000)
    (p_tab, p_mom, p_loss), (r_tab, r_mom, r_loss), _ = _run_pair(
        kind, rule, 0.25, jnp.float32, seed=4)
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    for a, b in zip(p_tab + p_mom, r_tab + r_mom):
        np.testing.assert_allclose(a, b, **TABLE_TOL)


def _bf16_ulp(x):
    # bf16 keeps 8 significant bits: one ulp is 2^(e-7) for |x| in [2^e, 2^(e+1))
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_step_bf16(kind, rule, monkeypatch):
    """The port rounds each row's float32 result once: within 2 ulps of
    its float32 step and 1 ulp (plus the float32 tolerance) of the
    reference's float32 step. The reference's bf16 SGD scatter rounds
    every delta and partial sum, each by up to half an ulp of the terms
    summed (|table| + the row's summed |delta|, which exceeds the result
    where a row's deltas cancel); its moment rules compute one float32
    update per row and round it once."""
    terms = []
    apply = port_steps.apply_row_updates

    def recording(table, moments, ids, grads, opt, lr, **kw):
        terms.append((table.shape, ids.clone(), (lr * grads).abs()))
        return apply(table, moments, ids, grads, opt, lr, **kw)

    (p16, _, p16_loss), (r16, _, r16_loss), touched = _run_pair(
        kind, rule, None, jnp.bfloat16)
    monkeypatch.setattr(port_steps, "apply_row_updates", recording)
    (p32, _, _), (r32, _, _), _ = _run_pair(kind, rule, None, jnp.float32)
    # the losses are computed in float32 from the same bf16 values
    np.testing.assert_allclose(p16_loss, r16_loss, **LOSS_TOL)
    start = _state_np(rule, 3)["tables"]
    for a, b32, c32, b16, t0, n, (shape, ids, d) in zip(
            p16, p32, r32, r16, start, touched, terms):
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b32)), np.abs(t0))
        assert np.all(np.abs(a - b32) <= 2 * _bf16_ulp(mag))
        assert np.all(np.abs(a - c32) <= _bf16_ulp(mag) + 3e-6
                      + 3e-4 * np.abs(c32))
        if rule == "SGD":
            summed = torch.zeros(shape).index_add_(
                0, ids[ids < shape[0]], d[ids < shape[0]]).numpy()
            mag = np.maximum(mag, np.abs(t0) + summed)
        mag = np.maximum(mag, np.abs(b16))
        assert np.all(np.abs(a - b16) <= (n[:, None] + 2) * _bf16_ulp(mag))


def test_classic_step_draws_and_micro_steps():
    """Without draws the classic step draws [B, K] uniforms from its
    generator; make_micro_step runs it chunk by chunk on that stream."""
    _, p_opt, lr = _opts("SGD")
    h, t, m = _batch("classic", 5)
    neg = tuple(_t(a) for a in _neg_state())
    step = port_steps.make_graph_train_step(PORT_MODELS["DeepWalk"], p_opt,
                                            K, NW)
    assert step.draw_shape(7) == (7, K)
    state = state_from_numpy(_state_np("SGD", 5), "cpu")
    gen = torch.Generator().manual_seed(1)
    draws = tuple(torch.rand((h.size, K), generator=gen) for _ in range(2))
    a, la = step(state_from_numpy(_state_np("SGD", 5), "cpu"), _t(h).long(),
                 _t(t).long(), lr, *neg, mask=_t(m), draws=draws)
    b, lb = step(state, _t(h).long(), _t(t).long(), lr, *neg, mask=_t(m),
                 generator=torch.Generator().manual_seed(1))
    assert float(la) == float(lb)
    for x, y in zip(a["tables"], b["tables"]):
        assert torch.equal(x, y)
    n = h.size // 2 * 2
    micro = port_steps.make_micro_step(step, 2)
    s1, _ = micro(state_from_numpy(_state_np("SGD", 5), "cpu"),
                  _t(h[:n]).long(), _t(t[:n]).long(), lr, *neg,
                  mask=_t(m[:n]), generator=torch.Generator().manual_seed(2))
    s2 = state_from_numpy(_state_np("SGD", 5), "cpu")
    gen = torch.Generator().manual_seed(2)
    for sl in (slice(0, n // 2), slice(n // 2, n)):
        s2, _ = step(s2, _t(h[sl]).long(), _t(t[sl]).long(), lr, *neg,
                     mask=_t(m[sl]), generator=gen)
    for x, y in zip(s1["tables"], s2["tables"]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the solver: batch plan and step switches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,batch,dim,T", [
    (60, 2048, 16, 4), (1_138_499, 100000, 128, 10),
    (1_138_499, 100000, 128, 5), (5000, 100000, 64, 6),
    (20000, 3000, 32, 10),
])
def test_multitail_batch_plan_matches_reference(v, batch, dim, T,
                                                monkeypatch):
    import types

    if v == 5000:
        monkeypatch.setenv("GRAPHVITE_MAX_TOUCH", "4")
    plans = []
    for solver in (ref_solver.GraphSolver(dim=dim),
                   GraphSolver(dim=dim, device="cpu")):
        solver.graph = types.SimpleNamespace(num_vertex=v)
        solver.batch_size, solver.num_negative = batch, 1
        solver._pooled_step, solver._multitail_T = True, T
        solver._walk_slot_unit = 0
        plans.append(solver._batch_plan())
    assert plans[0] == plans[1]
    assert plans[1][1] % T == 0


STEP_FACTORIES = ("make_graph_train_step", "make_graph_pool_step",
            "make_graph_pool_multitail_step", "make_graph_banded_fused_step",
            "make_graph_banded_walk_step")


def _spy(monkeypatch, module, calls):
    for name in STEP_FACTORIES:
        def wrapper(*a, _orig=getattr(module, name), _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)


@pytest.mark.parametrize("env,aug,model,want", [
    ({}, 2, "DeepWalk", "make_graph_banded_walk_step"),
    ({"GRAPHVITE_NEG_SHARING": "0"}, 2, "DeepWalk", "make_graph_train_step"),
    ({"GRAPHVITE_NEG_SHARING": "0"}, 2, "node2vec", "make_graph_train_step"),
    ({"GRAPHVITE_NEG_SHARING": "0"}, 1, "LINE", "make_graph_train_step"),
    ({"GRAPHVITE_WALK_STEP": "pair"}, 2, "DeepWalk", "make_graph_pool_step"),
    ({"GRAPHVITE_WALK_STEP": "multitail"}, 2, "node2vec",
     "make_graph_pool_multitail_step"),
    ({"GRAPHVITE_MULTITAIL": "0"}, 2, "DeepWalk", "make_graph_pool_step"),
])
def test_step_switches_match_reference(env, aug, model, want, monkeypatch):
    """Each switch picks the reference's step family, walk layout, batch
    plan and pool shape for the same graph and arguments."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    g = two_blocks(40)
    calls = {"ref": [], "port": []}
    _spy(monkeypatch, ref_solver._steps, calls["ref"])
    _spy(monkeypatch, port_solver._steps, calls["port"])
    solvers = []
    for name, solver, graph in (
            ("ref", ref_solver.GraphSolver(dim=8), g),
            ("port", GraphSolver(dim=8, device="cpu"), _port_graph(g))):
        solver.build(graph, num_negative=1, batch_size=1024, episode_size=2)
        solver.train(model=model, num_epoch=5, augmentation_step=aug,
                     random_walk_length=6, negative_sharing=False,
                     log_frequency=10**9)
        solvers.append(solver)
    assert calls["port"] == calls["ref"] == [want]
    s_ref, s_port = solvers
    assert s_port._pooled_step == s_ref._pooled_step
    assert s_port._batch_plan() == s_ref._batch_plan()
    assert s_port._multitail_T == s_ref._multitail_T
    assert s_port._walk_slot_unit == s_ref._walk_slot_unit
    assert s_port._banded_fused == getattr(s_ref, "_banded_fused", False)
    a, b = s_ref._active_sampler, s_port._active_sampler
    for name in ("banded", "position_major", "bidir", "num_walk", "biased",
                 "num_tail"):
        if hasattr(a, name):
            assert getattr(b, name) == getattr(a, name), name
    assert torch.isfinite(s_port.batch_losses).all()


def test_classic_step_learns_two_blocks_like_the_reference(monkeypatch):
    """GRAPHVITE_NEG_SHARING=0 (the classic K-draw step on walk pairs):
    AUC > 0.9 and within 0.03 of the reference's."""
    monkeypatch.setenv("GRAPHVITE_NEG_SHARING", "0")
    g = two_blocks()
    kw = dict(model="DeepWalk", num_epoch=2000, augmentation_step=2,
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
    assert not solver._pooled_step
    assert port_auc > 0.9, aucs
    assert abs(port_auc - ref_auc) < 0.03, aucs


# ---------------------------------------------------------------------------
# the host classes' API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("undirected,weighted", [(True, False),
                                                 (False, True)])
def test_graph_api_matches_reference(undirected, weighted, tmp_path):
    rng = np.random.default_rng(6)
    edges = [(str(a), str(b)) + ((float(w),) if weighted else ())
             for a, b, w in zip(rng.integers(0, 30, 120),
                                rng.integers(0, 30, 120),
                                rng.random(120) + 0.5) if a != b]
    r = RefGraph().load_edge_list(edges, as_undirected=undirected,
                                  normalization=weighted)
    p = Graph().load_edge_list(edges, as_undirected=undirected,
                               normalization=weighted)
    np.testing.assert_array_equal(p.degrees, r.degrees)
    for u in range(r.num_vertex):
        for a, b in zip(p.neighbors(u), r.neighbors(u)):
            np.testing.assert_array_equal(a, b)
    assert p.info() == r.info()
    for kw in (dict(), dict(weighted=False), dict(anonymous=True)):
        r.save(str(tmp_path / "r.txt"), **kw)
        p.save(str(tmp_path / "p.txt"), **kw)
        assert ((tmp_path / "p.txt").read_text()
                == (tmp_path / "r.txt").read_text())


def test_solver_clear_matches_reference():
    g = two_blocks(40)
    for solver, graph in ((ref_solver.GraphSolver(dim=8), g),
                          (GraphSolver(dim=8, device="cpu"),
                           _port_graph(g))):
        solver.build(graph, num_negative=1, batch_size=512)
        assert solver.state is not None
        solver.clear()
        assert solver.state is None
