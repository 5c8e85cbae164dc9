"""The port's blocked episodes, host master and host-row predicts
(graphvite_tpu_torch/parallel/mesh.py, ops/blocked.py, GraphSolver's
blocked loop, both solvers' `_predict_host_rows`) against the JAX
package's, on the CPU.

Tolerances: VertexPartition, FlatBlockTables, the auto rule's P, the block
schedule and ep_batches bit-equal. The sharded step and both runners on
the reference's own draws (the in-block edge index the reference computes
from its float32 uniform, fed in): float32 tables and moments rtol 1e-5,
atol 1e-6, losses rtol 1e-5. bfloat16 shards (SGD): the port's bf16 step
equals its float32 step from the same bf16-valued shards rounded once,
lies within 1 bf16 ulp of the reference's float32 step and within n + 1
ulps of the reference's bf16 step for a row touched n times (ROADMAP
queue 3, bf16 rounding order). Host master on and off: bit-equal tables
and moments. Host-row predicts against the reference's on the same numpy
tables: rtol 1e-5, atol 1e-5 (float32 dot products of unit-scale rows,
summed in another order). Learning, as tests/test_blocked.py:
two-block AUC > 0.9, flat against blocked positive loss within 0.35."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.blocked as ref_blocked
import graphvite_tpu.optim as ref_optim
import graphvite_tpu.parallel.mesh as ref_mesh
import graphvite_tpu.solver as ref_solver
import graphvite_tpu_torch.ops.blocked as port_blocked
import graphvite_tpu_torch.optim as port_optim
import graphvite_tpu_torch.parallel.mesh as port_mesh
import graphvite_tpu_torch.solver as port_solver
from graphvite_tpu.graph import Graph as RefGraph
from graphvite_tpu.models import GRAPH_MODELS as REF_GRAPH_MODELS
from graphvite_tpu.models import KG_MODELS as REF_KG_MODELS
from graphvite_tpu_torch.application.evaluate import rank_sum_auc
from graphvite_tpu_torch.graph import Graph, KnowledgeGraph
from graphvite_tpu_torch.models import GRAPH_MODELS, KG_MODELS

F32_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5)
D, B, K = 16, 64, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores: with torch's default of one thread
    per core, each of the many tiny ops these tests run waits on the other
    workers' threads (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(v=200, e=2000, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    u = (rng.random(e) ** 2 * v).astype(np.int64)
    w = rng.integers(0, v, e)
    if weighted:
        return [(str(a), str(b), float(x)) for a, b, x
                in zip(u, w, rng.random(e) * 3 + 0.1)]
    return [(str(a), str(b)) for a, b in zip(u, w)]


def _graphs(**kw):
    edges = _edges(**kw)
    return RefGraph().load_edge_list(edges), Graph().load_edge_list(edges)


def _two_block_edges(seed=0):
    """tests/test_blocked.py's two communities of 40 vertices."""
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


def _t(x):
    return torch.as_tensor(np.array(x))


def _bf16(x):
    return torch.as_tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _opts(rule):
    kw = dict(type=rule, lr=0.025 if rule == "SGD" else 1e-3,
              weight_decay=5e-3)
    return ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw), kw["lr"]


# ---------------------------------------------------------------------------
# host structures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_partition", [1, 2, 4, 7])
@pytest.mark.parametrize("padded_uniform", [False, True])
def test_vertex_partition_matches_reference(num_partition, padded_uniform):
    ref_g, g = _graphs()
    ref = ref_mesh.VertexPartition(np.asarray(ref_g.degrees), num_partition)
    port = port_mesh.VertexPartition(np.asarray(g.degrees), num_partition)
    assert port.capacity == ref.capacity
    for name in ("part_of", "local_of", "members", "valid"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    rng = np.random.default_rng(1)
    table = rng.normal(size=(g.num_vertex, 5)).astype(np.float32)
    sharded = port.shard_rows(table)
    np.testing.assert_array_equal(sharded, ref.shard_rows(table))
    np.testing.assert_array_equal(port.unshard_rows(sharded), table)
    # the tensor forms the solver's shards use
    parts = [port.shard_tensor(torch.from_numpy(table), p)
             for p in range(num_partition)]
    np.testing.assert_array_equal(torch.stack(parts).numpy(), sharded)
    back = port.unshard_tensors(parts, torch.empty(table.shape))
    np.testing.assert_array_equal(back.numpy(), table)
    for a, b in zip(port.negative_alias_arrays(g.vertex_weights, 0.75,
                                               padded_uniform),
                    ref.negative_alias_arrays(ref_g.vertex_weights, 0.75,
                                              padded_uniform)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_partition", [1, 2, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_flat_block_tables_match_reference(num_partition, weighted):
    ref_g, g = _graphs(weighted=weighted)
    ref_part = ref_mesh.VertexPartition(np.asarray(ref_g.degrees),
                                        num_partition)
    part = port_mesh.VertexPartition(np.asarray(g.degrees), num_partition)
    ref = ref_blocked.FlatBlockTables(ref_g, ref_part)
    port = port_blocked.FlatBlockTables(g, part)
    for name in ("prob", "alias", "heads", "tails", "offsets", "block_prob",
                 "block_alias"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.device_arrays("cpu"), ref.device_arrays()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_choose_num_partition_matches_reference():
    for v in (1, 1000, 262_143, 1_000_000, 7_944_949, 65_608_366):
        for dim in (2, 32, 128, 512):
            for target in (1 << 20, 32 << 20):
                assert port_blocked.choose_num_partition(
                    v, dim, target) == ref_blocked.choose_num_partition(
                        v, dim, target)


# ---------------------------------------------------------------------------
# the sharded step and the runners on the reference's draws
# ---------------------------------------------------------------------------

def _shard_state(rule, cap, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    vertex = rng.uniform(-0.5, 0.5, (cap, D)).astype(np.float32) / D * 8
    context = rng.normal(size=(cap, D)).astype(np.float32) * 0.1
    if dtype != np.float32:
        vertex, context = _bf16(vertex), _bf16(context)
    n_mom = {"SGD": 0, "Adam": 2}[rule]
    moms = tuple(tuple(rng.uniform(0, 1e-4, (cap, D)).astype(np.float32)
                       for _ in range(n_mom)) for _ in range(2))
    return {"tables": (vertex, context), "moments": moms}


def _ref_state(state, dtype):
    return {"tables": tuple(jnp.asarray(t).astype(dtype)
                            for t in state["tables"]),
            "moments": tuple(tuple(jnp.asarray(m) for m in g)
                             for g in state["moments"])}


def _port_state(state, dtype):
    return {"tables": tuple(torch.tensor(t).to(dtype)
                            for t in state["tables"]),
            "moments": tuple(tuple(torch.tensor(m) for m in g)
                             for g in state["moments"])}


def _np_state(state):
    to = (lambda x: x.float().numpy() if torch.is_tensor(x)
          else np.asarray(x, np.float32))
    return ([to(t) for t in state["tables"]]
            + [to(m) for g in state["moments"] for m in g])


def _step_draws(key, b):
    """The negative uniforms the reference's sharded step draws from `key`
    (parallel/mesh.py:226-229)."""
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.uniform(k1, (b, K))),
            _t(jax.random.uniform(k2, (b, K))))


def _neg_arrays(cap, size, seed):
    rng = np.random.default_rng(seed)
    w = np.zeros(cap)
    w[:size] = rng.random(size) + 0.1
    t = port_mesh.AliasTable(w[:size])
    prob = np.zeros(cap, np.float32)
    alias = np.zeros(cap, np.int32)
    prob[:size], alias[:size] = t.prob, t.alias
    return prob, alias


def _run_step(rule, dtype, seed=3, cap=90, size=77, bf16_values=None):
    """One sharded step of each package on the same shards and batch:
    ((port state, loss), (reference state, loss), touches per vertex row)
    as float32 numpy. `bf16_values`: start from shards that bf16 holds
    exactly (default: for bf16 shards)."""
    r_opt, p_opt, lr = _opts(rule)
    if bf16_values is None:
        bf16_values = dtype == "bfloat16"
    state = _shard_state(rule, cap, seed,
                         "bf16" if bf16_values else np.float32)
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, size, B).astype(np.int32)
    tails = rng.integers(0, size, B).astype(np.int32)
    mask = (rng.random(B) > 0.1).astype(np.float32)
    nprob, nalias = _neg_arrays(cap, size, seed)
    key = jax.random.PRNGKey(seed)
    r_step = ref_mesh.make_sharded_graph_step(REF_GRAPH_MODELS["LINE"], r_opt,
                                              K, 5.0)
    r_new, r_loss = r_step(
        _ref_state(state, jnp.bfloat16 if dtype == "bfloat16"
                   else jnp.float32),
        (jnp.asarray(heads), jnp.asarray(tails), jnp.asarray(mask)), key,
        jnp.float32(lr), jnp.asarray(nprob), jnp.asarray(nalias),
        jnp.int32(size))
    p_step = port_mesh.make_sharded_graph_step(GRAPH_MODELS["LINE"], p_opt,
                                               K, 5.0)
    p_new, p_loss = p_step(
        _port_state(state, getattr(torch, dtype)),
        (_t(heads), _t(tails), _t(mask)), lr, _t(nprob), _t(nalias), size,
        draws=_step_draws(key, B))
    touches = np.bincount(heads, minlength=cap)
    return ((_np_state(p_new), float(p_loss)),
            (_np_state(r_new), float(r_loss)), touches, _np_state(state))


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
@pytest.mark.parametrize("kernel_route", [False, True])
def test_sharded_step_matches_reference(rule, kernel_route, monkeypatch):
    if kernel_route:
        # shards above the dense-update size: the moment kernel's route in
        # the port (its plain version here), the sort-based route in the
        # reference; SGD takes the scatter-add either way
        monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", 64)
        monkeypatch.setattr(ref_optim, "DENSE_UPDATE_ELEMS", 64)
    (p, p_loss), (r, r_loss), _, _ = _run_step(rule, "float32")
    np.testing.assert_allclose(p_loss, r_loss, **LOSS_TOL)
    assert len(p) == len(r) == 2 + (4 if rule == "Adam" else 0)
    for a, b in zip(p, r):
        np.testing.assert_allclose(a, b, **F32_TOL)


def test_sharded_step_draws_over_members_only():
    """Negatives are drawn over [0, neg_size), never the padded slots."""
    p_opt = port_optim.Optimizer(type="SGD", lr=0.025)
    step = port_mesh.make_sharded_graph_step(GRAPH_MODELS["LINE"], p_opt, K,
                                             5.0)
    cap, size = 50, 10
    nprob, nalias = _neg_arrays(cap, size, 0)
    state = _port_state(_shard_state("SGD", cap, 0), torch.float32)
    ctx0 = state["tables"][1].clone()
    heads = torch.zeros(B, dtype=torch.int32)
    u1 = torch.full((B, K), 0.9999999)
    new, _ = step(state, (heads, heads, torch.ones(B)), 0.025, _t(nprob),
                  _t(nalias), size, draws=(u1, torch.zeros(B, K)))
    moved = (new["tables"][1] != ctx0).any(dim=1).nonzero().flatten()
    assert moved.max() < size


def test_sharded_step_bf16():
    (p16, p16_loss), (r16, r16_loss), touches, before = _run_step(
        "SGD", "bfloat16")
    np.testing.assert_allclose(p16_loss, r16_loss, **LOSS_TOL)
    # the port's float32 step from the same bf16-valued shards, rounded
    # once, is its bf16 step; the reference's float32 step from them lies
    # within 1 ulp
    (p32, _), (r32, _), _, _ = _run_step("SGD", "float32",
                                         bf16_values=True)
    for a, b in zip(p16, p32):
        np.testing.assert_array_equal(a, _bf16(b))
    for a, b in zip(p16, r32):
        assert np.all(np.abs(a - b) <= _bf16_ulp(b) + 1e-6 * np.abs(b))
    # the reference rounds each delta and each partial sum: per row, one
    # ulp per touch of the largest magnitude involved (heads on the vertex
    # shard; every context row is touched at most B (K + 1) times)
    n_v = touches[:, None]
    for i, (a, b, c) in enumerate(zip(p16, r16, before)):
        n = n_v if i == 0 else B * (K + 1)
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(c))
        assert np.all(np.abs(a - b) <= (n + 1) * _bf16_ulp(mag))


def _block_setup(num_partition=2, seed=0):
    ref_g, g = _graphs(seed=seed)
    ref_part = ref_mesh.VertexPartition(np.asarray(ref_g.degrees),
                                        num_partition)
    part = port_mesh.VertexPartition(np.asarray(g.degrees), num_partition)
    tables = port_blocked.FlatBlockTables(g, part)
    neg = part.negative_alias_arrays(g.vertex_weights, 0.75)
    ref_neg = ref_part.negative_alias_arrays(ref_g.vertex_weights, 0.75)
    return ref_part, part, tables, neg, ref_neg


def _episode_draws(base_key, ep, n_blk):
    """Per batch, what the reference's episode runner draws from
    fold_in(base_key, it) (ops/blocked.py:117-127), with the in-block edge
    index computed from its float32 uniform as it computes it."""
    safe_n = max(n_blk, 1)
    out = []
    for it in range(ep):
        key = jax.random.fold_in(base_key, it)
        ks, kt = jax.random.split(key)
        ue = jax.random.uniform(ks, (2, B))
        idx = jnp.minimum((ue[0] * safe_n).astype(jnp.int32), safe_n - 1)
        out.append((_t(idx).long(), _t(ue[1])) + _step_draws(kt, B))
    return out


@pytest.mark.parametrize("rule,dtype,kernel_route", [
    ("SGD", "float32", False), ("Adam", "float32", False),
    ("Adam", "float32", True), ("SGD", "bfloat16", False)])
def test_block_episode_runner_matches_reference(rule, dtype, kernel_route,
                                                monkeypatch):
    if kernel_route:
        monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", 64)
        monkeypatch.setattr(ref_optim, "DENSE_UPDATE_ELEMS", 64)
    r_opt, p_opt, _ = _opts(rule)
    ref_part, part, tables, neg, _ = _block_setup()
    cap, ep, blk = part.capacity, 5, 1          # block (0, 1)
    i, j = blk // 2, blk % 2
    lo, hi = int(tables.offsets[blk]), int(tables.offsets[blk + 1])
    shard = _shard_state(rule, cap, 5)
    shard = {"tables": tuple(_bf16(t) if dtype == "bfloat16" else t
                             for t in shard["tables"]),
             "moments": shard["moments"]}
    base_key = jax.random.PRNGKey(11)
    r_step = ref_mesh.make_sharded_graph_step(REF_GRAPH_MODELS["LINE"], r_opt,
                                              K, 5.0)
    r_run = ref_blocked.make_block_episode_runner(r_step, r_opt, B, ep)
    nprob, nalias, nsizes = neg
    r_local, r_losses = r_run(
        _ref_state(shard, jnp.float32), jnp.int32(lo), jnp.int32(hi - lo),
        jnp.int32(3), jnp.int32(40), base_key,
        *(jnp.asarray(a) for a in (tables.prob, tables.alias, tables.heads,
                                   tables.tails)),
        jnp.asarray(nprob[j]), jnp.asarray(nalias[j]), jnp.int32(nsizes[j]))
    p_step = port_mesh.make_sharded_graph_step(GRAPH_MODELS["LINE"], p_opt,
                                               K, 5.0)
    p_run = port_blocked.make_block_episode_runner(p_step, p_opt, B, ep)
    p_local, p_losses = p_run(
        _port_state(shard, getattr(torch, dtype)), lo, hi - lo, 3, 40, None,
        *tables.edge_tensors("cpu"), _t(nprob[j]), _t(nalias[j]),
        int(nsizes[j]), draws=_episode_draws(base_key, ep, hi - lo))
    assert p_losses.shape == (ep,)
    if dtype == "float32":
        np.testing.assert_allclose(p_losses.numpy(), np.asarray(r_losses),
                                   **LOSS_TOL)
        for a, b in zip(_np_state(p_local), _np_state(r_local)):
            np.testing.assert_allclose(a, b, **F32_TOL)
        return
    # bf16 shards against the reference's float32 run from the same
    # values: the port rounds each row once per batch, so after ep batches
    # a row lies within ep ulps of the largest magnitude involved (plus
    # the float32 tolerance)
    np.testing.assert_allclose(p_losses[0].item(), float(r_losses[0]),
                               **LOSS_TOL)
    for a, b, c in zip(_np_state(p_local), _np_state(r_local),
                       _np_state(shard)):
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(c))
        assert np.all(np.abs(a - b) <= ep * _bf16_ulp(mag)
                      + F32_TOL["rtol"] * np.abs(b) + F32_TOL["atol"])


def test_blocked_runner_matches_reference():
    """The [P, cap, D] arena runner (not the solver's) with the two-level
    draw: the block from the reference's uniforms on the device, the
    in-block index fed in."""
    rule, P_, ep = "Adam", 2, 4
    r_opt, p_opt, _ = _opts(rule)
    ref_part, part, tables, neg, _ = _block_setup(P_)
    cap = part.capacity
    rng = np.random.default_rng(2)
    arena = {"tables": tuple(rng.normal(size=(P_, cap, D)).astype(np.float32)
                             * 0.1 for _ in range(2)),
             "moments": tuple(tuple(rng.uniform(0, 1e-4, (P_, cap, D))
                                    .astype(np.float32) for _ in range(2))
                              for _ in range(2))}
    base_key = jax.random.PRNGKey(5)
    r_step = ref_mesh.make_sharded_graph_step(REF_GRAPH_MODELS["LINE"], r_opt,
                                              K, 5.0)
    r_run = ref_blocked.make_blocked_runner(r_step, r_opt, P_, B, ep)
    nprob, nalias, nsizes = neg
    r_arena, r_losses = r_run(
        _ref_state(arena, jnp.float32), jnp.int32(0), jnp.int32(20),
        base_key, tuple(jnp.asarray(a) for a in (
            tables.prob, tables.alias, tables.heads, tables.tails,
            tables.offsets, tables.block_prob, tables.block_alias)),
        (jnp.asarray(nprob), jnp.asarray(nalias), jnp.asarray(nsizes)))
    draws = []
    for it in range(ep):
        kb, ks, kt = jax.random.split(jax.random.fold_in(base_key, it), 3)
        u = np.asarray(jax.random.uniform(kb, (2,)))
        bidx = min(int(u[0] * np.float32(P_ * P_)), P_ * P_ - 1)
        blk = bidx if u[1] < tables.block_prob[bidx] else int(
            tables.block_alias[bidx])
        n_blk = int(tables.offsets[blk + 1] - tables.offsets[blk])
        (idx, ue1, u1, u2), = _episode_draws_from(ks, kt, n_blk)
        draws.append((_t(u), idx, ue1, u1, u2))
    p_step = port_mesh.make_sharded_graph_step(GRAPH_MODELS["LINE"], p_opt,
                                               K, 5.0)
    p_run = port_blocked.make_blocked_runner(p_step, p_opt, P_, B, ep)
    p_arena, p_losses = p_run(
        _port_state(arena, torch.float32), 0, 20, None,
        tables.device_arrays("cpu"), (_t(nprob), _t(nalias), _t(nsizes)),
        draws=draws)
    np.testing.assert_allclose(p_losses.numpy(), np.asarray(r_losses),
                               **LOSS_TOL)
    for a, b in zip(_np_state(p_arena), _np_state(r_arena)):
        np.testing.assert_allclose(a, b, **F32_TOL)


def _episode_draws_from(ks, kt, n_blk):
    safe_n = max(n_blk, 1)
    ue = jax.random.uniform(ks, (2, B))
    idx = jnp.minimum((ue[0] * safe_n).astype(jnp.int32), safe_n - 1)
    return [(_t(idx).long(), _t(ue[1])) + _step_draws(kt, B)]


def test_blocked_runner_draws_its_own():
    """Without draws the arena runner draws blocks, in-block indices and
    negatives on the device from its generator: two runs from one seed
    agree, and the losses are finite."""
    p_opt = port_optim.Optimizer(type="SGD", lr=0.025)
    _, part, tables, neg, _ = _block_setup(2)
    step = port_mesh.make_sharded_graph_step(GRAPH_MODELS["LINE"], p_opt, K,
                                             5.0)
    run = port_blocked.make_blocked_runner(step, p_opt, 2, B, 6)
    outs = []
    for _ in range(2):
        arena = {"tables": (torch.rand(2, part.capacity, D) * 0.1,
                            torch.zeros(2, part.capacity, D)),
                 "moments": ((), ())}
        gen = torch.Generator().manual_seed(0)
        arena["tables"][0].copy_(torch.rand(2, part.capacity, D,
                                            generator=gen))
        arena, losses = run(arena, 0, 6, gen, tables.device_arrays("cpu"),
                            tuple(_t(a) for a in neg))
        outs.append((arena["tables"][1].clone(), losses))
    assert torch.equal(outs[0][0], outs[1][0])
    assert bool(torch.isfinite(outs[0][1]).all())
    assert bool((outs[0][0] != 0).any())


# ---------------------------------------------------------------------------
# the in-block draw: the reference's float32 grid against integer indices
# ---------------------------------------------------------------------------

def test_in_block_index_covers_every_edge():
    """The reference picks an edge of a block as min(int(u n), n - 1) from
    a float32 uniform with 23 random bits (jax.random.uniform: k 2^-23 for
    k in [0, 2^23)). Over that whole grid its formula reaches at most 2^23
    of a block's n edges: a quarter of a block of 2^25 edges (the multiples
    of 4) and 15% of a 56M-edge block; on an unweighted graph the others
    are never trained. The port draws the index as an integer over [0, n)
    (ROADMAP queue 3)."""
    grid = np.arange(1 << 23, dtype=np.float32) * np.float32(2.0 ** -23)
    for n, share in ((1 << 25, 0.25), (56_000_000, 0.1498)):
        idx = np.minimum((grid * np.float32(n)).astype(np.int64), n - 1)
        reached = np.unique(idx).size
        assert reached <= 1 << 23
        assert abs(reached / n - share) < 1e-3
        if n == 1 << 25:
            assert np.all(idx % 4 == 0)
    # the port's runner: the edge it trains is lo + torch.randint(n)
    n = 1 << 25
    gen = torch.Generator().manual_seed(0)
    picks = torch.randint(0, n, (1 << 20,), generator=gen)
    assert int((picks % 4 != 0).sum()) > (1 << 20) // 2
    assert int(picks.max()) > n - 256
    # ... as make_block_episode_runner draws it (identity alias, ids =
    # edge positions): the heads a step sees are those indices
    seen = []

    def step(state, xs, lr, *neg, generator=None, draws=None):
        seen.append(xs[0].clone())
        return state, torch.zeros(())

    m, lo = 1000, 37
    ids = torch.arange(lo + m + 5, dtype=torch.int32)
    run = port_blocked.make_block_episode_runner(
        step, port_optim.Optimizer(), 300, 2)
    gen = torch.Generator().manual_seed(4)
    run({}, lo, m, 0, 10, gen, torch.ones(ids.numel()),
        torch.zeros(ids.numel(), dtype=torch.int32), ids, ids, None, None, 1)
    gen = torch.Generator().manual_seed(4)
    want = torch.randint(0, m, (300,), generator=gen) + lo
    np.testing.assert_array_equal(seen[0].numpy(), want.numpy())


# ---------------------------------------------------------------------------
# the solver: routing, schedule, host master
# ---------------------------------------------------------------------------

def _record_runner(module, calls):
    """A make_block_episode_runner that records (lo, n_blk, batch_id0,
    ep_batches) and trains nothing."""
    def make(step_fn, opt, batch_size, ep_batches):
        def run(local, lo, n_blk, batch_id0, *args, **kw):
            calls.append((int(lo), int(n_blk), int(batch_id0), ep_batches))
            if module is ref_blocked:
                return local, jnp.zeros((ep_batches,))
            return local, torch.zeros(ep_batches)
        return run
    return make


@pytest.mark.parametrize("num_partition,num_epoch,episode,sweeps", [
    (2, 40, 8, None), (4, 60, 5, "1"), (3, 25, 200, "2"), (4, 3, 8, None)])
def test_block_schedule_matches_reference(num_partition, num_epoch, episode,
                                          sweeps, monkeypatch):
    if sweeps is not None:
        monkeypatch.setenv("GRAPHVITE_MIN_SWEEPS", sweeps)
    edges = _edges(seed=4)
    calls = {"ref": [], "port": []}
    monkeypatch.setattr(ref_blocked, "make_block_episode_runner",
                        _record_runner(ref_blocked, calls["ref"]))
    monkeypatch.setattr(port_blocked, "make_block_episode_runner",
                        _record_runner(port_blocked, calls["port"]))
    for name, solver, graph in (
            ("ref", ref_solver.GraphSolver(dim=8, seed=3),
             RefGraph().load_edge_list(edges)),
            ("port", port_solver.GraphSolver(dim=8, seed=3, device="cpu"),
             Graph().load_edge_list(edges))):
        solver.build(graph, num_partition=num_partition, num_negative=1,
                     batch_size=128, episode_size=episode)
        solver.train(model="LINE", num_epoch=num_epoch, augmentation_step=1,
                     log_frequency=10**9)
        assert solver.batch_id >= solver.num_batch
    assert calls["port"] == calls["ref"]
    assert len(calls["port"]) > 1


def _ref_chosen_partition(graph, dim, budget, monkeypatch, float_type,
                          optimizer):
    chosen = []
    monkeypatch.setenv("GRAPHVITE_HBM_BYTES", repr(budget))
    monkeypatch.setattr(
        ref_solver.GraphSolver, "_train_loop_blocked",
        lambda self, model_cls, num_epoch, P_, *a: chosen.append(P_))
    monkeypatch.setattr(ref_solver.GraphSolver, "_train_loop_device",
                        lambda self, *a, **kw: chosen.append(1))
    s = ref_solver.GraphSolver(dim=dim, float_type=float_type)
    s.build(graph, optimizer=optimizer, num_negative=1, batch_size=128)
    s.train(model="LINE", num_epoch=1, augmentation_step=1,
            log_frequency=10**9)
    return chosen[0]


@pytest.mark.parametrize("float_type,optimizer", [("float32", "SGD"),
                                                  ("bfloat16", "Adam")])
def test_auto_partition_matches_reference(float_type, optimizer,
                                          monkeypatch):
    """The P the auto rule picks, for a sweep of budgets against one
    demand, equals the reference's (1: flat)."""
    edges = _edges(seed=2)
    ref_g, g = RefGraph().load_edge_list(edges), Graph().load_edge_list(edges)
    s = port_solver.GraphSolver(dim=32, float_type=float_type, device="cpu")
    s.build(g, optimizer=optimizer, num_negative=1, batch_size=128)
    monkeypatch.setenv("GRAPHVITE_HBM_BYTES", "1e15")
    demand, _ = s._memory_demand()
    seen = set()
    for frac in (2.0, 1.0, 0.99, 0.6, 0.5, 0.3, 0.2, 0.11, 0.04, 0.02,
                 0.01, 1e-4):
        budget = demand * frac
        monkeypatch.setenv("GRAPHVITE_HBM_BYTES", repr(budget))
        plan = s._blocked_plan()
        port_p = plan[0] if plan else 1
        assert port_p == _ref_chosen_partition(ref_g, 32, budget,
                                               monkeypatch, float_type,
                                               optimizer), frac
        seen.add(port_p)
    # the rule starts at 2 and doubles while 2 demand / P exceeds the
    # budget, which it does at P = 2 whenever the demand does: 4 at least
    assert seen == {1, 4, 8, 16, 32, 64}


def _trained(edges, hm, num_partition=4, rule="SGD", float_type="float32",
             num_epoch=60, monkeypatch=None, dim=16):
    if hm is not None:
        monkeypatch.setenv("GRAPHVITE_HOST_MASTER", hm)
    opt = {"type": rule, "lr": 0.025 if rule == "SGD" else 1e-3,
           "weight_decay": 5e-3 if rule == "SGD" else 0.0}
    s = port_solver.GraphSolver(dim=dim, seed=0, float_type=float_type,
                                device="cpu")
    s.build(Graph().load_edge_list(edges), optimizer=opt,
            num_partition=num_partition, num_negative=1, batch_size=256,
            episode_size=4)
    s.train(model="LINE", num_epoch=num_epoch, augmentation_step=1,
            negative_weight=1.0, log_frequency=10**9)
    return s


@pytest.mark.parametrize("rule,float_type", [("SGD", "float32"),
                                             ("Adam", "float32"),
                                             ("SGD", "bfloat16")])
def test_host_master_on_and_off_bit_equal(rule, float_type, monkeypatch):
    edges = _two_block_edges()
    on = _trained(edges, "1", rule=rule, float_type=float_type,
                  monkeypatch=monkeypatch)
    off = _trained(edges, "0", rule=rule, float_type=float_type,
                   monkeypatch=monkeypatch)
    assert on.blocked_stats["host_master"]
    assert not off.blocked_stats["host_master"]
    st = on.blocked_stats
    assert st["hits"] + st["misses"] == 2 * st["episodes"]
    assert st["misses"] > 0 and st["h2d_bytes"] > 0 and st["d2h_bytes"] > 0
    for a, b in zip(_np_state(on.state), _np_state(off.state)):
        np.testing.assert_array_equal(a, b)
    assert on.state["tables"][0].dtype == getattr(torch, float_type)
    np.testing.assert_array_equal(on.batch_losses.numpy(),
                                  off.batch_losses.numpy())


def _intra_cross(g):
    n2i = g.name2id
    intra = np.asarray([(n2i[str(a)], n2i[str(b)])
                        for a in range(0, 20) for b in range(20, 40)])
    cross = np.asarray([(n2i[str(a)], n2i[str(b)])
                        for a in range(0, 20) for b in range(60, 80)])
    return intra, cross


@pytest.mark.parametrize("hm", ["0", "1"])
def test_blocked_episodes_train_and_separate(hm, monkeypatch):
    """tests/test_blocked.py's learning check, with and without the host
    master: P = 4, 400 epochs, two-block AUC > 0.9; predict on the host
    master's tables equals manual scoring."""
    edges = _two_block_edges()
    s = _trained(edges, hm, num_epoch=400, monkeypatch=monkeypatch, dim=32)
    assert s.blocked_stats["num_partition"] == 4
    emb, ctx = s.vertex_embeddings, s.context_embeddings
    assert np.isfinite(emb).all() and np.isfinite(ctx).all()
    intra, cross = _intra_cross(s.graph)
    si, sc = s.predict(intra), s.predict(cross)
    auc = rank_sum_auc(np.r_[si, sc], np.r_[np.ones(len(si)),
                                            np.zeros(len(sc))])
    assert auc > 0.9, auc
    manual = (emb[intra[:, 0]] * ctx[intra[:, 1]]).sum(-1)
    np.testing.assert_allclose(si, manual, rtol=1e-4, atol=1e-4)


def test_blocked_matches_flat_statistics(monkeypatch):
    """Blocked and flat training on the same graph land comparable positive
    losses (tests/test_blocked.py)."""
    edges = _two_block_edges(seed=3)

    def run(num_partition):
        s = _trained(edges, None, num_partition=num_partition,
                     num_epoch=300, dim=16)
        v, c = s.vertex_embeddings, s.context_embeddings
        h = np.asarray(s.graph.edge_heads)[:500]
        t = np.asarray(s.graph.edge_tails)[:500]
        logits = np.sum(v[h] * c[t], axis=1)
        return float(np.log1p(np.exp(-logits)).mean())

    flat, blocked = run(1), run(4)
    assert np.isfinite(flat) and np.isfinite(blocked)
    assert blocked < 0.9, (flat, blocked)
    assert abs(flat - blocked) < 0.35, (flat, blocked)


@pytest.mark.parametrize("budget,blocked", [("1000", True), ("1e12", False)])
def test_overflow_auto_rule_selects_blocked(budget, blocked, monkeypatch):
    monkeypatch.setenv("GRAPHVITE_HBM_BYTES", budget)
    s = port_solver.GraphSolver(dim=32, seed=0, device="cpu")
    s.build(Graph().load_edge_list(_two_block_edges()), num_negative=1,
            batch_size=512, episode_size=4)
    s.train(model="LINE", num_epoch=5, augmentation_step=1,
            negative_weight=1.0, log_frequency=10**9)
    assert np.isfinite(s.vertex_embeddings).all()
    assert (getattr(s, "_blocked_key", None) is not None) == blocked
    if blocked:
        # demand far above the budget: P at its cap, host master on
        assert s.blocked_stats["num_partition"] == 64
        assert s.blocked_stats["host_master"]


def test_gpu_memory_limit_drives_auto_partition(monkeypatch):
    monkeypatch.delenv("GRAPHVITE_HBM_BYTES", raising=False)
    s = port_solver.GraphSolver(dim=32, seed=0, gpu_memory_limit=1000,
                                device="cpu")
    s.build(Graph().load_edge_list(_two_block_edges()), num_negative=1,
            batch_size=512, episode_size=4)
    s.train(model="LINE", num_epoch=5, augmentation_step=1,
            negative_weight=1.0, log_frequency=10**9)
    assert getattr(s, "_blocked_key", None) is not None
    assert np.isfinite(s.vertex_embeddings).all()
    # the walk route trains flat, resuming from nothing
    s.train(model="DeepWalk", num_epoch=5, augmentation_step=2,
            random_walk_length=6, log_frequency=10**9)
    assert np.isfinite(s.vertex_embeddings).all()


def test_host_state_serves_checkpoint_and_resume(tmp_path, monkeypatch):
    """After host-master training the tables stay in host memory; a
    checkpoint round-trips them and a flat run resumed from them trains."""
    edges = _two_block_edges()
    s = _trained(edges, "1", rule="Adam", monkeypatch=monkeypatch)
    assert all(t.device.type == "cpu" for t in s.state["tables"])
    path = str(tmp_path / "ckpt.pkl")
    s.save_checkpoint(path)
    other = port_solver.GraphSolver(dim=16, device="cpu")
    other.build(s.graph, optimizer=s.optimizer, num_negative=1)
    other.load_checkpoint(path)
    for a, b in zip(_np_state(other.state), _np_state(s.state)):
        np.testing.assert_array_equal(a, b)
    s.num_partition = 1
    s.train(model="LINE", num_epoch=120, resume=True, augmentation_step=1,
            negative_weight=1.0, log_frequency=10**9)
    assert np.isfinite(s.vertex_embeddings).all()


# ---------------------------------------------------------------------------
# host-row predicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 1 << 18])
def test_graph_predict_host_rows_matches_reference(chunk):
    rng = np.random.default_rng(0)
    vertex = rng.normal(size=(300, 24)).astype(np.float32)
    context = rng.normal(size=(300, 24)).astype(np.float32)
    pairs = rng.integers(0, 300, (1000, 2))
    ref = ref_solver.GraphSolver(dim=24)._predict_host_rows(
        REF_GRAPH_MODELS["LINE"], vertex, context, pairs[:, 0], pairs[:, 1],
        chunk=chunk)
    s = port_solver.GraphSolver(dim=24, device="cpu")
    got = s._predict_host_rows(GRAPH_MODELS["LINE"], vertex, context,
                               pairs[:, 0], pairs[:, 1], chunk=chunk)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # predict dispatches numpy tables there
    s.graph = Graph().load_edge_list(_edges())
    s.model = "LINE"
    s.state = {"tables": (vertex, context), "moments": ((), ())}
    np.testing.assert_array_equal(s.predict(pairs), s._predict_host_rows(
        GRAPH_MODELS["LINE"], vertex, context, pairs[:, 0], pairs[:, 1]))


@pytest.mark.parametrize("model", ["TransE", "RotatE", "DistMult",
                                   "ComplEx", "SimplE", "QuatE"])
def test_kg_predict_host_rows_matches_reference(model):
    rng = np.random.default_rng(1)
    ne, nr, d = 120, 7, 32
    entity = rng.normal(size=(ne, d)).astype(np.float32) * 0.3
    relation = rng.normal(size=(nr, d)).astype(np.float32) * 0.3
    arr = np.stack([rng.integers(0, ne, 700), rng.integers(0, ne, 700),
                    rng.integers(0, nr, 700)], axis=1)
    margin_or_l3 = 9.0 if KG_MODELS[model].uses_margin else 1e-3
    ref = ref_solver.KnowledgeGraphSolver(dim=d)._predict_host_rows(
        REF_KG_MODELS[model], margin_or_l3, entity, relation, arr, chunk=64)
    s = port_solver.KnowledgeGraphSolver(dim=d, device="cpu")
    got = s._predict_host_rows(KG_MODELS[model], margin_or_l3, entity,
                               relation, arr, chunk=64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # predict dispatches numpy tables there, in the default chunks
    s.model, s.margin, s.l3_regularization = model, 9.0, 1e-3
    s.state = {"tables": (entity, relation), "moments": ((), ())}
    np.testing.assert_array_equal(s.predict(arr), s._predict_host_rows(
        KG_MODELS[model], margin_or_l3, entity, relation, arr))


def test_kg_host_rows_match_device_predict():
    triplets = [(str(h), str(r), str(t)) for h, r, t in zip(
        range(0, 60), [0, 1, 2] * 20, range(1, 61))]
    g = KnowledgeGraph().load_triplet_list(triplets)
    s = port_solver.KnowledgeGraphSolver(dim=16, device="cpu")
    s.build(g, num_negative=4, batch_size=64)
    s.model, s.margin, s.l3_regularization = "RotatE", 6.0, 1e-3
    s.init_embeddings()
    arr = np.stack([np.arange(60), np.arange(1, 61), np.arange(60) % 3],
                   axis=1)
    device = s.predict(arr)
    s.state = {"tables": tuple(t.numpy() for t in s.state["tables"]),
               "moments": s.state["moments"]}
    np.testing.assert_allclose(s.predict(arr), device, rtol=1e-6, atol=1e-6)
