"""The port's knowledge-graph engines for several workers
(graphvite_tpu_torch/parallel/kg.py: ShardedKGTrainer with pooled, global
and resident negatives, ReplicatedKGTrainer; the new collectives of
DeviceGroup; KnowledgeGraphSolver._train_loop_mesh_kg) against the JAX
package's (graphvite_tpu/parallel/kg.py, solver.py) on the CPU: the
reference on the virtual 8-device mesh of tests/conftest.py, the port
with W CPU workers.

The engines are fed the reference's own draws: the round's keys are
split(fold_in(PRNGKey(seed), round), W), each batch's fold_in(key0, i)
split three ways (positives, negatives, step), and the same uniforms and
integers are drawn here from those keys.

Tolerances: collectives rtol 1e-6; the schedule equal. Three episodes of
float32 tables, moments and losses: rtol 1e-4, atol 2e-6 (each
framework's own sum order over D, over a row's touches and, in global
mode, over the pool's candidate gradients; the errors compound over the
rounds). The lr = 0 round trip bit for bit. Solvers, as
tests/test_parallel.py holds the reference: math-fixture MRR > 0.85 and
within 0.05 of the reference's; two MRRs from run_config within 0.05."""
import itertools
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.optim as ref_optim
import graphvite_tpu.ops.steps as ref_steps
import graphvite_tpu.parallel.kg as ref_kg
import graphvite_tpu.parallel.mesh as ref_mesh
import graphvite_tpu_torch.optim as port_optim
import graphvite_tpu_torch.ops.steps as port_steps
import graphvite_tpu_torch.parallel.kg as port_kg
import graphvite_tpu_torch.parallel.mesh as port_mesh
from graphvite_tpu.graph import KnowledgeGraph as RefKG
from graphvite_tpu.models import KG_MODELS as REF_KG_MODELS
from graphvite_tpu_torch.graph import KnowledgeGraph
from graphvite_tpu_torch.models import KG_MODELS

ENGINE_TOL = dict(rtol=1e-4, atol=2e-6)
LOSS_TOL = dict(rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores (see tests/test_torch_mesh.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _triplets(n, seed=0, num_entity=40, num_relation=4):
    """tests/test_parallel.py's math_kg: random triplets over a few
    entities and relations."""
    rng = np.random.default_rng(seed)
    return [(str(rng.integers(num_entity)), "r%d" % rng.integers(num_relation),
             str(rng.integers(num_entity))) for _ in range(n)]


def _kgs(n=400, seed=0, **kw):
    trips = _triplets(n, seed, **kw)
    return (RefKG().load_triplet_list(trips),
            KnowledgeGraph().load_triplet_list(trips))


def _opts(rule, lr=None):
    lr = lr if lr is not None else (0.05 if rule == "SGD" else 5e-3)
    kw = dict(type=rule, lr=lr, weight_decay=0.0)
    return ref_optim.Optimizer(**kw), port_optim.Optimizer(**kw)


def _group(W):
    return port_mesh.DeviceGroup(["cpu"] * W)


# ---------------------------------------------------------------------------
# the new collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_permute_all_gather_reduce_scatter(W):
    """permute is ppermute (a worker that receives nothing gets zeros),
    all_gather is all_gather(tiled=True), reduce_scatter is
    psum_scatter(tiled=True) (jax.lax on the mesh)."""
    g = _group(W)
    rng = np.random.default_rng(W)
    xs = rng.normal(size=(W, 2 * W, 3)).astype(np.float32)
    fwd = [(d, d + 1) for d in range(W - 1)]
    bwd = [(d, d - 1) for d in range(1, W)]
    spec = jax.sharding.PartitionSpec("p")

    def ref_fn(x):
        x = x[0]
        outs = (jax.lax.ppermute(x, "p", fwd), jax.lax.ppermute(x, "p", bwd),
                jax.lax.all_gather(x, "p", tiled=True),
                jax.lax.psum_scatter(x, "p", scatter_dimension=0,
                                     tiled=True))
        return tuple(o[None] for o in outs)

    want = jax.jit(jax.shard_map(ref_fn, mesh=ref_mesh.make_mesh(W),
                                 in_specs=spec, out_specs=(spec,) * 4,
                                 check_vma=False))(jnp.asarray(xs))
    parts = [torch.from_numpy(xs[i]) for i in range(W)]
    got = (g.permute(parts, fwd), g.permute(parts, bwd),
           g.all_gather(parts), g.reduce_scatter(parts))
    for a, b in zip(got, want):
        np.testing.assert_allclose(torch.stack(a).numpy(), np.asarray(b),
                                   rtol=1e-6)


def test_reduce_scatter_adds_in_worker_order():
    """Worker j's chunk is ((x0 + x1) + x2) + x3 in float32, whatever the
    device: the order a card and the CPU both keep."""
    g = _group(4)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy((rng.normal(size=(8, 5)) * 10.0 ** rng.integers(
        -4, 4, (8, 5))).astype(np.float32)) for _ in range(4)]
    got = g.reduce_scatter(xs)
    for j in range(4):
        want = xs[0][2 * j:2 * j + 2].clone()
        for x in xs[1:]:
            want += x[2 * j:2 * j + 2]
        assert torch.equal(got[j], want)


# ---------------------------------------------------------------------------
# the tournament schedule
# ---------------------------------------------------------------------------

class _RefSchedule(ref_kg.ShardedKGTrainer):
    def __init__(self, W):
        self.num_worker = W
        self.M = 2 * W - 1
        self.reset_schedule()


class _PortSchedule(port_kg.ShardedKGTrainer):
    def __init__(self, W):
        self.num_worker = W
        self.M = 2 * W - 1
        self.reset_schedule()


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_tournament_schedule(W):
    """Every partition pair co-resides exactly once per sweep of 2W - 1
    rounds, and the port's assignments are the reference's, round by
    round over two sweeps."""
    ref, port = _RefSchedule(W), _PortSchedule(W)
    seen = set()
    for r in range(2 * port.M):
        assert port.assignments() == ref.assignments()
        assert port.round == ref.round == r
        if r < port.M:
            for a, b in port.assignments():
                assert frozenset((a, b)) not in seen
                seen.add(frozenset((a, b)))
        port.advance_schedule()
        ref.advance_schedule()
    assert seen == {frozenset(p) for p in
                    itertools.combinations(range(2 * W), 2)}


# ---------------------------------------------------------------------------
# ShardedKGTrainer on the reference's draws
# ---------------------------------------------------------------------------

def _sharded_pair(W, mode, rule, B=64, EP=2, dim=16, K=4, lr=None, n=400,
                  seed=0):
    rg, pg = _kgs(n, seed)
    ropt, popt = _opts(rule, lr)
    rpart = ref_mesh.VertexPartition(np.asarray(rg.degrees), 2 * W)
    ppart = port_mesh.VertexPartition(np.asarray(pg.degrees), 2 * W)
    kw = dict(num_negative=K, margin_or_l3=6.0, adversarial_temperature=2.0,
              relation_lr_multiplier=1.0, batch_size=B, ep_batches=EP,
              negative_pool=mode, trust=0.25)
    rtr = ref_kg.ShardedKGTrainer(ref_mesh.make_mesh(W), rpart, dim,
                                  REF_KG_MODELS["RotatE"], ropt, **kw)
    ptr = port_kg.ShardedKGTrainer(_group(W), ppart, dim,
                                   KG_MODELS["RotatE"], popt, **kw)
    return rg, pg, rtr, ptr


def _kg_tables(num_entity, num_relation, dim, seed=0):
    rng = np.random.default_rng(seed)
    ent = rng.uniform(-0.5, 0.5, (num_entity, dim)).astype(np.float32)
    phases = rng.uniform(-np.pi, np.pi, (num_relation, dim // 2))
    rel = np.concatenate([phases, np.zeros((num_relation, dim - dim // 2))],
                         axis=1).astype(np.float32)
    return ent, rel


def _kg_moments(rule, num_entity, num_relation, dim, seed=1):
    if rule == "SGD":
        return None
    rng = np.random.default_rng(seed)
    return tuple(tuple(rng.uniform(1e-4, 1e-2, (n, dim)).astype(np.float32)
                       for _ in range(2))
                 for n in (num_entity, num_relation))


def _sharded_draws(ptr, seed):
    """The reference's draws of one round (kg.py:263-342), in the port
    trainer's layout."""
    W, EP, B, K = ptr.num_worker, ptr.ep_batches, ptr.batch_size, \
        ptr.num_negative
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), ptr.round), W)
    out = []
    for w in range(W):
        batches = []
        for i in range(EP):
            ks, kn, _ = jax.random.split(jax.random.fold_in(keys[w], i), 3)
            u = _t(jax.random.uniform(ks, (B,)))
            if ptr.negative_pool == "pooled":
                neg = _t(jax.random.uniform(kn, ptr.step.pool_shape))
            elif ptr.negative_pool == "global":
                Q = ptr.pool_size
                kp, kn2 = jax.random.split(kn)
                neg = (_t(jax.random.uniform(kp, (Q,))),
                       _t(jax.random.randint(kn2, (B, K), 0,
                                             2 * W * Q)).long())
            else:
                neg = _t(jax.random.uniform(kn, (B, K)))
            batches.append((u, neg))
        out.append(batches)
    return out


def _run_sharded(W, mode, rule, episodes=3, lr=None, moments=True, **kw):
    rg, pg, rtr, ptr = _sharded_pair(W, mode, rule, lr=lr, **kw)
    ent, rel = _kg_tables(pg.num_vertex, pg.num_relation, ptr.dim)
    moms = (_kg_moments(rule, pg.num_vertex, pg.num_relation, ptr.dim)
            if moments else None)
    rstate = rtr.init_state(ent, rel, moments_np=moms)
    pstate = ptr.init_state(ent, rel, moments=moms)
    rtrip = rtr.init_triplets(rg)
    ptrip = ptr.init_triplets(pg)
    np.testing.assert_array_equal(ptrip.block_off, np.asarray(rtrip[3]))
    losses = []
    for e in range(episodes):
        draws = _sharded_draws(ptr, 5)
        rstate, rl = rtr.run_episode(rstate, rtrip, 4 * e, 100, 5)
        pstate, pl = ptr.run_episode(pstate, ptrip, 4 * e, 100, 5,
                                     draws=draws)
        losses.append((torch.stack(pl).numpy(), np.asarray(rl)))
    return rtr, ptr, rstate, pstate, losses, (ent, rel)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("mode", ["pooled", "global", "resident"])
@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_sharded_kg_matches_reference(W, mode, rule):
    """Three rounds (the rotation runs): losses, the gathered entity table
    and moments, the relations and each worker's relation moments."""
    rtr, ptr, rstate, pstate, losses, (ent, _) = _run_sharded(W, mode, rule)
    for pl, rl in losses:
        assert pl.shape == rl.shape == (W, ptr.ep_batches)
        np.testing.assert_allclose(pl, rl, **LOSS_TOL)
    assert ptr.round == rtr.round == 3
    assert ptr.assignments() == rtr.assignments()
    got = ptr.gather_entities(pstate).numpy()
    np.testing.assert_allclose(got, rtr.gather_entities(rstate),
                               **ENGINE_TOL)
    assert not np.allclose(got, ent)
    for a, b in zip(ptr.gather_entity_moments(pstate),
                    rtr.gather_entity_moments(rstate)):
        np.testing.assert_allclose(a.numpy(), b, **ENGINE_TOL)
    for w in range(W):
        np.testing.assert_allclose(pstate["rel"][w].numpy(),
                                   np.asarray(rstate["rel"]), **ENGINE_TOL)
        for m, rm in zip(pstate["rel_moms"][w], rstate["rel_moms"]):
            np.testing.assert_allclose(m.numpy(), np.asarray(rm)[w],
                                       **ENGINE_TOL)
    for a, b in zip(ptr.gather_relation_moments(pstate), rstate["rel_moms"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).mean(axis=0),
                                   **ENGINE_TOL)


def test_sharded_kg_relation_merge_mean(monkeypatch):
    """GRAPHVITE_REL_MERGE=mean scales the summed relation deltas by 1/W,
    in both packages."""
    monkeypatch.setenv("GRAPHVITE_REL_MERGE", "mean")
    rtr, ptr, rstate, pstate, losses, _ = _run_sharded(4, "pooled", "SGD",
                                                       episodes=2)
    np.testing.assert_allclose(pstate["rel"][0].numpy(),
                               np.asarray(rstate["rel"]), **ENGINE_TOL)
    monkeypatch.setenv("GRAPHVITE_REL_MERGE", "sum")
    _, _, _, summed, _, _ = _run_sharded(4, "pooled", "SGD", episodes=2)
    assert not np.allclose(summed["rel"][0].numpy(),
                           pstate["rel"][0].numpy())


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("mode", ["pooled", "global", "resident"])
def test_sharded_kg_lr0_roundtrip_bit_equal(W, mode):
    """lr = 0: five rounds (not a multiple of the sweep) give back the
    starting entity and relation tables and moments bit for bit, through
    the seat rotation (tests/test_parallel.py::
    test_sharded_kg_transition_roundtrip)."""
    _, ptr = _sharded_pair(W, mode, "SGD", lr=0.0)[2:]
    pg = _kgs()[1]
    ent, rel = _kg_tables(pg.num_vertex, pg.num_relation, ptr.dim)
    state = ptr.init_state(ent, rel)
    trip = ptr.init_triplets(pg)
    for e in range(5):
        state, _ = ptr.run_episode(state, trip, 2 * e, 100, seed=e)
    assert ptr.round == 5
    assert np.array_equal(ptr.gather_entities(state).numpy(), ent)
    for w in range(W):
        assert np.array_equal(state["rel"][w].numpy(), rel)


def test_sharded_kg_neg_pool_reading():
    """Any value other than "pooled" and "global" trains the resident
    step, as the reference reads GRAPHVITE_KG_NEG_POOL (kg.py:203, 281,
    296): the classic step without an external pool."""
    for mode, pooled, external in (("pooled", True, False),
                                   ("global", False, True),
                                   ("resident", False, False),
                                   ("anything", False, False)):
        _, _, _, ptr = _sharded_pair(2, mode, "SGD")
        assert hasattr(ptr.step, "pool_shape") == pooled
        draws = ptr.episode_draws(torch.Generator().manual_seed(0))
        neg = draws[0][0][1]
        assert isinstance(neg, tuple) == external
        if not pooled and not external:
            assert neg.shape == (ptr.batch_size, ptr.num_negative)


# ---------------------------------------------------------------------------
# ReplicatedKGTrainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("pooled", [False, True])
def test_replicated_kg_trainer_matches_reference(W, pooled):
    """Replicas with summed deltas (reference kg.py:39-131), fed the
    reference's edge uniforms and negatives; Adam, two episodes."""
    rg, pg = _kgs(300)
    ropt, popt = _opts("Adam", 1e-3)
    B, EP, dim, K = 64, 3, 16, 4
    if pooled:
        args = dict(pool_size=16, pool_groups=4)
        rstep = ref_steps.make_kg_pool_step(REF_KG_MODELS["RotatE"], ropt,
                                            K, 6.0, 2.0, 1.0, **args)
        pstep = port_steps.make_kg_pool_step(KG_MODELS["RotatE"], popt, K,
                                             6.0, 2.0, 1.0, **args)
    else:
        rstep = ref_steps.make_kg_train_step(REF_KG_MODELS["RotatE"], ropt,
                                             K, 6.0, 2.0, 1.0)
        pstep = port_steps.make_kg_train_step(KG_MODELS["RotatE"], popt, K,
                                              6.0, 2.0, 1.0)
    rtr = ref_kg.ReplicatedKGTrainer(ref_mesh.make_mesh(W), dim, rstep, ropt,
                                     batch_size=B, ep_batches=EP)
    ptr = port_kg.ReplicatedKGTrainer(_group(W), dim, pstep, popt,
                                      batch_size=B, ep_batches=EP)
    ent, rel = _kg_tables(pg.num_vertex, pg.num_relation, dim)
    rtab, rmom = rtr.init_state((ent, rel))
    ptab, pmom = ptr.init_state((ent, rel))
    redges, pedges = rtr.init_edges(rg), ptr.init_edges(pg)
    V = pg.num_vertex
    for e in range(2):
        keys = jax.random.split(jax.random.PRNGKey(e), W)
        draws = []
        for w in range(W):
            batches = []
            for i in range(EP):
                ks, kt = jax.random.split(jax.random.fold_in(keys[w], i))
                u = _t(jax.random.uniform(ks, (2, B)))
                if pooled:
                    neg = _t(jax.random.randint(kt, pstep.pool_shape, 0, V))
                else:
                    nid = _t(jax.random.randint(kt, (B, K), 0, 2 * V))
                    ch = nid < V
                    neg = (torch.where(ch, nid, nid - V), ch)
                batches.append((u, neg))
            draws.append(batches)
        rtab, rmom, rl = rtr.run_episode(rtab, rmom, redges, e * EP, 100, e)
        ptab, pmom, pl = ptr.run_episode(ptab, pmom, pedges, e * EP, 100, e,
                                         draws=draws)
        np.testing.assert_allclose(torch.stack(pl).numpy(), np.asarray(rl),
                                   **LOSS_TOL)
    for w in range(W):
        for a, b in zip(ptab[w], rtab):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **ENGINE_TOL)
        for side, rside in zip(pmom[w], rmom):
            for a, b in zip(side, rside):
                np.testing.assert_allclose(a.numpy(), np.asarray(b)[w],
                                           **ENGINE_TOL)
    assert not np.allclose(ptab[0][0].numpy(), ent)


def test_sharded_kg_kernel_route(monkeypatch):
    """Arenas above the dense-update size: Adam takes kernel 2's route
    (its plain version here) against the reference's sort-based route,
    in pooled and global mode."""
    monkeypatch.setattr(port_optim, "DENSE_UPDATE_ELEMS", 64)
    monkeypatch.setattr(ref_optim, "DENSE_UPDATE_ELEMS", 64)
    for mode in ("pooled", "global"):
        rtr, ptr, rstate, pstate, losses, _ = _run_sharded(2, mode, "Adam",
                                                           episodes=2)
        for pl, rl in losses:
            np.testing.assert_allclose(pl, rl, **LOSS_TOL)
        np.testing.assert_allclose(ptr.gather_entities(pstate).numpy(),
                                   rtr.gather_entities(rstate), **ENGINE_TOL)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

class _Planned(Exception):
    pass


def _ref_plan(monkeypatch, solver, num_epoch):
    """What the reference's _train_loop_mesh_kg plans: its trainer
    replaced by one that records its arguments and stops the loop."""
    seen = {}

    class Recorder:
        def __init__(self, mesh, part, dim, model, opt, **kw):
            seen.update(kw)
            raise _Planned()

    monkeypatch.setattr(ref_kg, "ShardedKGTrainer", Recorder)
    solver._kgmesh_key = None
    with pytest.raises(_Planned):
        solver._train_loop_mesh_kg("RotatE", num_epoch, 6.0, 1.0, 10**9)
    return (seen["negative_pool"], solver.effective_batch, solver.num_batch,
            seen["ep_batches"])


@pytest.mark.parametrize("V,dim,K,batch,W,env", [
    (400, 16, 4, 256, 2, {}),
    (400, 512, 64, 100000, 2, {}),
    (3000, 128, 32, 100000, 4, {"GRAPHVITE_STEP_BYTES": "4e8"}),
    (400, 16, 4, 256, 4, {"GRAPHVITE_KG_NEG_POOL": "resident",
                          "GRAPHVITE_MIN_SWEEPS": "2"}),
    (200, 64, 8, 5000, 2, {"GRAPHVITE_KG_NEG_POOL": "pooled",
                           "GRAPHVITE_MAX_TOUCH": "8"}),
    (400, 32, 8, 1000, 3, {"GRAPHVITE_KG_NEG_POOL": "global",
                           "GRAPHVITE_MIN_SWEEPS": "1"}),
])
def test_mesh_plan_matches_reference(monkeypatch, V, dim, K, batch, W, env):
    """The negative pool (GRAPHVITE_KG_NEG_POOL or the auto rule on
    GRAPHVITE_STEP_BYTES), the batch per worker, the batch count and the
    episode length equal the reference's."""
    import graphvite_tpu.solver as ref_solver
    import graphvite_tpu_torch.solver as port_solver

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rg, pg = _kgs(2000, num_entity=V)
    plans = []
    for mod, g, kw in ((ref_solver, rg, {}), (port_solver, pg,
                                              {"device": "cpu"})):
        s = mod.KnowledgeGraphSolver(dim=dim, num_worker=W, **kw)
        s.build(g, optimizer=dict(type="SGD", lr=0.01), num_negative=K,
                batch_size=batch, episode_size=64)
        s.adversarial_temperature = 2.0
        if mod is ref_solver:
            plans.append(_ref_plan(monkeypatch, s, 300))
        else:
            plans.append(s._mesh_kg_plan(300))
    assert plans[0] == plans[1]


def _math_fixture(seed=0):
    """tests/test_parallel.py::test_solver_mesh_kg_quality's fixture: x +
    c mod 50 for c in 1..5, and 100 test triplets."""
    rng = np.random.default_rng(seed)
    trips = []
    for _ in range(2000):
        x = int(rng.integers(50))
        c = int(rng.integers(1, 6))
        trips.append((str(x), "+%d" % c, str((x + c) % 50)))
    test = []
    for _ in range(100):
        x = int(rng.integers(50))
        c = int(rng.integers(1, 6))
        test.append((str(x), "+%d" % c, str((x + c) % 50)))
    return trips, test


def _mrr(kg, ent, rel, test):
    from graphvite_tpu_torch.application import evaluate as ev

    e2i, r2i = kg.entity2id, kg.relation2id
    rows = [(e2i[h], r2i[r], e2i[t]) for h, r, t in test]
    H, R, T = (np.asarray(x) for x in zip(*rows))
    rk = ev.filtered_rankings("RotatE", ent, rel, H, R, T,
                              defaultdict(set), defaultdict(set), 6.0,
                              "tail")
    return ev.ranking_metrics(rk)["MRR"]


def test_solver_mesh_kg_quality_matches_reference():
    """KnowledgeGraphSolver(num_worker=4) routes through the sharded
    engine in both packages (global negatives by the auto rule at dim
    32): MRR > 0.85, the port within 0.05 of the reference's."""
    import graphvite_tpu.solver as ref_solver
    from graphvite_tpu.graph import KnowledgeGraph as RefKnowledgeGraph
    from graphvite_tpu_torch.solver import KnowledgeGraphSolver

    trips, test = _math_fixture()
    mrr = {}
    for name, cls, kg_cls, kw in (
            ("ref", ref_solver.KnowledgeGraphSolver, RefKnowledgeGraph, {}),
            ("port", KnowledgeGraphSolver, KnowledgeGraph,
             {"device": "cpu"})):
        kg = kg_cls().load_triplet_list(trips)
        s = cls(dim=32, seed=0, num_worker=4, **kw)
        s.build(kg, optimizer=dict(type="Adam", lr=5e-3), num_negative=8,
                batch_size=256, episode_size=4)
        s.train(model="RotatE", num_epoch=600, margin=6.0,
                log_frequency=10**9)
        mrr[name] = _mrr(kg, np.asarray(s.entity_embeddings),
                         np.asarray(s.relation_embeddings), test)
        if name == "port":
            assert s._kgmesh_trainer.negative_pool == "global"
            assert s.mesh_stats["workers"] == 4
            assert set(s.mesh_stats["setup_s"]) >= {"partition_s",
                                                    "triplet_sort_s"}
            assert s.batch_losses.numel() == s.batch_id
    assert mrr["port"] > 0.85, mrr
    assert abs(mrr["port"] - mrr["ref"]) < 0.05, mrr


def test_solver_mesh_kg_resume_continues_moments(monkeypatch):
    """train, then train(resume=True): the second call starts from the
    gathered entity moments exactly and from the workers' mean relation
    moments, as the reference's init_state takes them."""
    from graphvite_tpu_torch.solver import KnowledgeGraphSolver

    trips, _ = _math_fixture()
    kg = KnowledgeGraph().load_triplet_list(trips)
    s = KnowledgeGraphSolver(dim=16, seed=0, num_worker=2, device="cpu")
    s.build(kg, optimizer=dict(type="Adam", lr=5e-3), num_negative=4,
            batch_size=256, episode_size=4)
    s.train(model="RotatE", num_epoch=20, margin=6.0, log_frequency=10**9)
    first = s.batch_id
    e_moms, r_moms = (tuple(m.clone() for m in side)
                      for side in s.state["moments"])
    assert all(bool((m != 0).any()) for m in e_moms + r_moms)
    seen = {}
    init = port_kg.ShardedKGTrainer.init_state

    def spy(self, entity, relation, moments=None):
        seen["moments"] = moments
        seen["state"] = state = init(self, entity, relation, moments=moments)
        seen["rel_moms"] = [tuple(m.clone() for m in rm)
                            for rm in state["rel_moms"]]
        seen["arena_moms"] = [tuple(m.clone() for m in am)
                              for am in state["arena_moms"]]
        seen["trainer"] = self
        seen["asg"] = self.assignments()
        return state

    monkeypatch.setattr(port_kg.ShardedKGTrainer, "init_state", spy)
    s.train(model="RotatE", num_epoch=40, margin=6.0, resume=True,
            log_frequency=10**9)
    assert s.batch_id > first
    for got, want in zip(seen["moments"], (e_moms, r_moms)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    tr = seen["trainer"]
    for w in range(2):
        # every worker restarts from the mean relation moments, and its
        # arena moments are the canonical moments' rows of its partitions
        for m, want in zip(seen["rel_moms"][w], r_moms):
            assert torch.equal(m, want)
        for m, want in zip(seen["arena_moms"][w], e_moms):
            for slot, p in enumerate(seen["asg"][w]):
                n = int(tr.partition.sizes[p])
                ids = tr.partition.member_ids(p)
                assert torch.equal(m[slot, :n], want[ids])


def test_run_config_math_on_two_workers(tmp_path, monkeypatch):
    """A small math config with `gpus: [0, 1]` and `device: cpu` through
    both packages' run_config (two workers each; the port's on the CPU):
    the filtered tail MRRs within 0.05 of each other."""
    import urllib.request

    from graphvite_tpu import cmd as ref_cmd
    from graphvite_tpu import dataset as ref_ds
    from graphvite_tpu_torch import cmd as port_cmd
    from graphvite_tpu_torch import dataset as port_ds

    def refuse(url, *args, **kwargs):
        raise OSError("no network in tests: %s" % url)

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    for ds, name in ((ref_ds, "ref"), (port_ds, "port")):
        monkeypatch.setattr(ds.math, "path", str(tmp_path / name / "math"))
    config = tmp_path / "small.yaml"
    config.write_text("""application: knowledge graph
resource:
  gpus: [0, 1]
  dim: 16
  device: cpu
graph:
  file_name: <math.train>
build:
  optimizer:
    type: Adam
    lr: 1.0e-2
    weight_decay: 0
  num_negative: 8
  batch_size: 2000
  episode_size: 100
train:
  model: RotatE
  num_epoch: 40
  margin: 9
  adversarial_temperature: 2
  log_frequency: 1000000
evaluate:
  task: link prediction
  file_name: <math.test>
  filter_files:
    - <math.train>
    - <math.valid>
    - <math.test>
  target: tail
""")
    mrr = {}
    for name, cmd in (("ref", ref_cmd), ("port", port_cmd)):
        app, results = cmd.run_config(cmd.load_config(str(config)))
        mrr[name] = results[0]["MRR"]
    assert app.solver.num_worker == 2 and app.solver.mesh_stats["workers"] == 2
    assert app.solver.worker_devices == [torch.device("cpu")] * 2
    assert abs(mrr["port"] - mrr["ref"]) < 0.05, mrr
